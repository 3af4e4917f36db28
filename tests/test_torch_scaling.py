"""The port's scaling tools against the JAX package's (``tools/
scaling_bench.py``, ``scaling_projection.py``, ``overlap_evidence.py``),
on the CPU: ``tools.scaling_bench``'s four schemes over a gloo group of 2
processes (``tests/torch_mp_worker.py``, suite ``scaling``) at d = 1 and 2,
the SpMM schemes' outputs bitwise the one-device call and the pipeline's
and the MoE layer's their unsharded forwards', with the JAX tool's record
keys; ``tools.scaling_projection``'s rows from a fixed table of chunk
times against the JAX tool's formulas (``tools/scaling_projection.py:
99-128``, transcribed here: its ``main`` measures on the chip and writes
into ``bench_artifacts/``) at the port's link assumptions;
``tools.overlap_evidence``'s ``analyze_trace`` on synthetic events and
the tool over 2 gloo ranks: one transfer window a rank, with the step's
SpMM issued inside."""

import contextlib
import io
import json

import numpy as np
import pytest

import torch_mp_worker as mpw
from ternary_spgemm_tpu_torch.tools import (
    overlap_evidence,
    scaling_bench,
    scaling_projection,
)

SCHEMES = ("column", "overlapped", "pipeline", "moe")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return mpw.spawn("scaling", 2, tmp_path_factory.mktemp("scaling"))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scaling_bench_over_two_ranks(port, scheme):
    arrays, record = port
    rec = record[scheme]
    assert "raised" not in rec, rec.get("trace")
    rows = rec["records"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    for r in rows:
        assert r["seconds"] > 0
        assert r["weak_scaling_efficiency"] == pytest.approx(
            rows[0]["seconds"] / r["seconds"])
    if scheme in ("column", "overlapped"):
        assert [r["N"] for r in rows] == [256, 512]
        assert rows[1]["host_normalized_efficiency"] == pytest.approx(
            2 * rows[0]["seconds"] / rows[1]["seconds"])
    else:
        bound = 4 / 5 if scheme == "pipeline" else 1.0
        assert rows[1]["schedule_bound"] == pytest.approx(bound)
        assert rows[1]["shared_host_efficiency"] == pytest.approx(
            (2 * rows[0]["seconds"] / bound) / rows[1]["seconds"])
    for d in (1, 2):
        got, want = arrays[f"{scheme}/{d}"], arrays[f"{scheme}/{d}/single"]
        if scheme == "pipeline":   # microbatched: the JAX test's tolerance
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        else:
            np.testing.assert_array_equal(got, want)


def jax_projection(t_chunk, ici_GBps, dcn_sweep, K=1024):
    """``tools/scaling_projection.py:91-128``, transcribed: its ICI and
    DCN figures are the arguments."""
    chunk_rows = sorted(t_chunk)
    ici = ici_GBps * 1e9
    rows = []

    def tc_for(m_chunk):
        m_eff = max(m_chunk, min(chunk_rows))
        return t_chunk[min(c for c in chunk_rows if c >= m_eff)] / 1e6

    for d, hosts in [(8, 1), (8, 2), (8, 4)]:
        for M in (64, 256, 1024):
            for dcn_gbps in dcn_sweep:
                if hosts == 1 and dcn_gbps != dcn_sweep[0]:
                    continue
                dcn = dcn_gbps * 1e9
                m_chunk = M // d
                tc = tc_for(m_chunk)
                chunk_bytes = m_chunk * K * 4
                t_ici = chunk_bytes / ici
                t_dcn = chunk_bytes / dcn if hosts > 1 else t_ici
                ideal = d * tc
                flat = d * max(tc, t_dcn) + (d - 1) * t_dcn
                phase_c = (d // hosts) * max(tc, t_ici)
                t_dcn_block = (M // hosts) * K * 4 / dcn if hosts > 1 else 0
                hier = hosts * max(phase_c, t_dcn_block) + t_dcn_block
                for scheme, proj in (("flat_ring", flat),
                                     ("hierarchical", hier)):
                    rows.append((scheme, d, hosts, M, dcn_gbps, m_chunk,
                                 tc * 1e6, proj * 1e6,
                                 round(ideal / proj, 4)))
    return rows


def test_scaling_projection_against_jax_formulas():
    t_chunk = {4: 9.1, 8: 9.4, 16: 10.2, 32: 12.8, 64: 17.5, 128: 26.0,
               256: 44.0}
    a = scaling_projection.ASSUMPTIONS
    rows = scaling_projection.project(t_chunk)
    want = jax_projection(t_chunk, a["nvlink_GBps"],
                          a["inter_host_sweep_GBps"])
    got = [(r["scheme"], r["devices"], r["hosts"], r["M"],
            r["inter_host_GBps"], r["rows_per_chunk"], r["compute_chunk_us"],
            r["projected_total_us"], r["projected_weak_scaling_efficiency"])
           for r in rows]
    assert len(got) == len(want) == 42
    for g, w in zip(got, want):
        assert g[:6] == w[:6]
        assert g[6:8] == pytest.approx(w[6:8], rel=1e-12)
        assert g[8] == w[8]
    for r in rows:
        assert r["meets_baseline_80pct"] == (
            r["projected_weak_scaling_efficiency"] >= 0.80)
    head = scaling_projection.headline(rows)
    assert (head["scheme"], head["hosts"], head["M"],
            head["inter_host_GBps"]) == ("hierarchical", 2, 256, 25.0)
    # the named H100 links, each with its source
    assert a["nvlink_GBps"] == 450.0 and a["inter_host_GBps"] == 50.0
    assert "900 GB/s" in a["nvlink_source"]
    assert "400 Gb/s" in a["inter_host_source"]


WAIT = "overlapped_gather/wait"


def _ev(name, ts, cat="cpu_op", dur=1.0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_analyze_trace_synthetic():
    events = [
        _ev("aten::mm", 0),                      # before any post
        _ev("c10d::send", 10), _ev("c10d::recv_", 11),
        _ev("aten::empty", 12),                  # an allocation: no compute
        _ev("aten::index_add_", 13),
        _ev("cudaLaunchKernel", 14, cat="cuda_runtime"),
        _ev("cudaMemcpyAsync", 15, cat="cuda_runtime"),
        _ev(WAIT, 20, cat="user_annotation", dur=5),
        _ev("c10d::send", 30), _ev("c10d::recv_", 31),
        _ev(WAIT, 32, cat="user_annotation"),    # a window with nothing in it
        _ev("gemv_kernel", 33, cat="kernel"),    # a device record: ignored
        _ev(WAIT, 40, cat="user_annotation"),    # no post before it
        _ev("c10d::send", 50),                   # never closed
        {"ph": "i", "name": "marker", "ts": 1},
    ]
    got = overlap_evidence.analyze_trace(events)
    assert got["async_pairs"] == 2
    assert got["pairs_with_compute_inside"] == 1
    assert [p["compute_ops_in_window"] for p in got["pairs"]] == [2, 0]
    assert got["pairs"][0]["ops"] == ["aten::index_add_", "cudaLaunchKernel"]
    assert got["pairs"][0]["start_us"] == 10 and got["pairs"][0][
        "done_us"] == 20
    assert got["waits_without_post"] == 1 and got["unclosed_windows"] == 1
    from ternary_spgemm_tpu_torch.parallel.spgemm import WAIT_RANGE
    assert WAIT_RANGE == WAIT


def test_overlap_evidence_over_two_ranks(tmp_path):
    out = tmp_path / "overlap.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = overlap_evidence.main(["--device", "cpu", "--devices", "2",
                                    "--out", str(out)])
    assert rc == 0, buf.getvalue()
    rec = json.loads(out.read_text())
    assert rec["backend"] == "gloo" and rec["devices"] == 2
    assert rec["verdict"].startswith("OVERLAPPED")
    for r in rec["ranks"]:
        assert r["async_pairs"] == 1
        assert r["pairs_with_compute_inside"] == 1
        assert r["pairs"][0]["compute_ops_in_window"] > 0
