"""The port's study tools (``ternary_spgemm_tpu_torch/tools``) on the CPU.

Each probe's plain version is held against an independent numpy formula at
a tiny size (the CUDA kernels are held against the plain versions on the
card, ``tests/test_torch_cuda.py``); the deposit study's bytes audit must
equal the JAX tool's rows (the containers are byte-identical); the
roofline arithmetic is checked on injected times; and each tool's ``main``
runs with ``--device cpu`` at a tiny size, its records carrying the keys of
the JAX tool's records in ``bench_artifacts/`` (read, never written). The
numbers of a CPU run are host-clock numbers and are checked only for being
positive.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch import tools
from ternary_spgemm_tpu_torch.bench import timing
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.tools import decode_roofline as dr
from ternary_spgemm_tpu_torch.tools import deposit_study as ds
from ternary_spgemm_tpu_torch.tools import ffn_bench, membench
from ternary_spgemm_tpu_torch.tools import serve_trace as st
from ternary_spgemm_tpu_torch.tools import swiglu_bench as sb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _jax_record(name):
    with open(os.path.join(ROOT, "bench_artifacts", name)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the stream probe
# ---------------------------------------------------------------------------


def _np_checksum(arr: np.ndarray, x: np.ndarray) -> np.ndarray:
    words = np.frombuffer(arr.tobytes(), dtype="<i4").astype(np.int64)
    s = words.reshape(-1, 1024).sum(axis=0) + x.reshape(-1).astype(np.int64)
    return s.astype(np.uint32).view(np.int32).reshape(8, 128)


@pytest.mark.parametrize("layout,tk,tn,gk,gn", [
    ("tiled4d", 2, 4096, 2, 3), ("tiled4d", 16, 256, 3, 1),
    ("rowmajor", 3, 4096, 2, 2), ("rowmajor", 1, 8192, 1, 3)])
def test_stream_plain_matches_numpy(layout, tk, tn, gk, gn):
    arr = membench.make_array(gk, gn, tk, tn, layout, CPU, seed=tk)
    x = torch.arange(-512, 512, dtype=torch.int32).reshape(8, 128)
    got = membench.stream_checksum(arr, tk, tn, layout, x)
    np.testing.assert_array_equal(got.numpy(),
                                  _np_checksum(arr.numpy(), x.numpy()))
    # the checksum is the bytes': the other layout of the same bytes agrees
    other = arr.reshape(gk * tk, gn * tn) if layout == "tiled4d" else None
    if other is not None and tn % 4096 == 0:
        np.testing.assert_array_equal(
            membench.stream_checksum(other, tk, tn, "rowmajor", x).numpy(),
            got.numpy())


def test_stream_checks_tile_and_layout():
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="4096"):
        membench.stream_checksum(torch.zeros((4, 2048), dtype=torch.int8), 4,
                                 2048, "rowmajor", x)
    with pytest.raises(ValueError, match="layout"):
        membench.stream_checksum(torch.zeros((4, 4096), dtype=torch.int8), 4,
                                 4096, "colmajor", x)
    with pytest.raises(ValueError, match="CUDA"):
        membench.stream_launch(torch.zeros((1, 4096), dtype=torch.int8), 1,
                               4096, "rowmajor", x)


def test_stream_grid_is_jax_cut():
    # JAX: ntiles = bytes // tile; gk = int(sqrt(ntiles)); gn = ntiles // gk
    assert membench.grid_for(16 * 2**20, 256, 4096) == (4, 4)
    assert membench.grid_for(121 * 2**20, 256, 4096) == (11, 11)
    assert membench.grid_for(100, 256, 4096) == (1, 1)


# ---------------------------------------------------------------------------
# the decode-rate probe
# ---------------------------------------------------------------------------


def _np_decode_rate(plane: np.ndarray, x: np.ndarray, reps: int):
    tkb, tns = plane.shape[0] // 2, plane.shape[1]
    out = np.zeros((8, tns), np.int64)
    for r in range(reps):
        q = (plane.astype(np.int64) + r) & 0xFF
        for t in range(tkb):
            for b in range(8):
                row = (b // 4) * 4 * tkb + 4 * t + b % 4
                w = ((q[t] >> b) & 1) - ((q[tkb + t] >> b) & 1)
                out += np.outer(x[:, row], w)
    return out.astype(np.int32)


@pytest.mark.parametrize("tkb,tns,reps", [(16, 32, 3), (4, 40, 2)])
def test_decode_rate_plain_matches_numpy(tkb, tns, reps):
    plane, ones = dr.probe_inputs(tkb, tns, CPU, seed=reps)
    x = torch.from_numpy(np.random.default_rng(tkb).integers(
        -127, 128, ones.shape).astype(np.int32))
    for xx in (x, ones):
        got = dr.decode_rate(plane, xx, reps)
        np.testing.assert_array_equal(
            got.numpy(), _np_decode_rate(plane.numpy(), xx.numpy(), reps))


def test_roofline_arithmetic_on_injected_times():
    row = dr.roofline_row("32x1024x4096x4", 40e-6, 3.35e6, 3.35e12, 1e12)
    assert row["byte_ideal_s"] == pytest.approx(1e-6)
    assert row["decode_ideal_s"] == pytest.approx(1024 * 4096 / 1e12)
    assert row["dot_ideal_s"] == pytest.approx(2 * 32 * 1024 * 4096 / 1979e12)
    dec = 1024 * 4096 / 1e12
    assert row["own_bytes_fraction"] == pytest.approx(1e-6 / 40e-6)
    assert row["augmented_roofline_fraction"] == pytest.approx(
        (dec + row["dot_ideal_s"]) / 40e-6)
    assert row["overlapped_roofline_fraction"] == pytest.approx(dec / 40e-6)
    cpu = dr.roofline_row("32x1024x4096x4", 40e-6, 3.35e6, None, 1e12)
    assert cpu["byte_ideal_s"] is None and cpu["own_bytes_fraction"] is None
    assert set(cpu) == set(row)


def test_roofline_of_the_mma_branch():
    """The tensor-core branch decodes into its mma fragments (no decode-rate
    term) and issues two int8 mma a k-step (hi and lo): 4*M*K*N operations."""
    row = dr.roofline_row("32x1024x4096x4", 40e-6, 3.35e6, 3.35e12, 1e12,
                          "mma")
    dot = 4 * 32 * 1024 * 4096 / 1979e12
    assert row["branch"] == "mma" and row["decode_ideal_s"] is None
    assert row["dot_ideal_s"] == pytest.approx(dot)
    assert row["augmented_roofline_fraction"] == pytest.approx(
        (1e-6 + dot) / 40e-6)
    assert row["overlapped_roofline_fraction"] == pytest.approx(
        max(1e-6, dot) / 40e-6)
    assert set(row) == set(dr.roofline_row("32x1024x4096x4", 40e-6, 3.35e6,
                                           3.35e12, 1e12))
    assert set(dr.BRANCHES) == {"decode", "mma"}


# ---------------------------------------------------------------------------
# the deposit study
# ---------------------------------------------------------------------------


def test_bytes_audit_equals_jax(monkeypatch):
    from ternary_spgemm_tpu import native
    from tools import deposit_study as jds

    monkeypatch.setattr(native, "native_available", lambda: False)
    configs = [(300, 256), (500, 130)]
    want = jds.bytes_audit(configs)
    got = ds.bytes_audit(configs, device="cpu")
    assert got == want


def _np_variant(X, fmt, bias, mode):
    """The ladder's attribution modes, slot by slot as the kernel walks
    them (lane-contiguous entries; nogather adds the walked slot bytes)."""
    Xi = np.floor(X + 512.0) - 512.0
    M, K = Xi.shape
    plane = fmt.plane.numpy().astype(np.int64)
    nsb, gn, R, tn = plane.shape
    cp, cn = fmt.cap_pos.numpy(), fmt.cap_neg.numpy()
    split = 8 * fmt.cap_p_max
    Y = np.zeros((M, fmt.N), np.float64)
    for c in range(fmt.N):
        g, n, lane = c // tn, c % tn, c % 32
        for sb in range(nsb):
            for sign, lo, rows in ((1, 0, 8 * cp[sb, g]),
                                   (-1, split, 8 * cn[sb, g])):
                for r in range(rows):
                    k = sb * 248 + (r % 8) * 31 + lane
                    if lane < 31 and k < K:
                        Y[:, c] += sign * Xi[:, k]
                    if mode == "nogather":
                        Y[:, c] += plane[sb, g, lo + r, n]
    return (Y.astype(np.float32) + bias).astype(np.float32)


@pytest.mark.parametrize("mode", list(ds.MODES))
def test_ladder_plain_matches_numpy(mode):
    W = tf.generate_ternary(600, 300, 4, seed=3)
    fmt = tf.TiledEllDeposit.from_dense(W, tile_n=128)
    X = tf.generate_x(5, 600, seed=4)
    b = tf.generate_bias(300)
    got = ds.deposit_variant(torch.from_numpy(X), fmt, torch.from_numpy(b),
                             mode=mode).numpy()
    if mode in ("full", "staticcap"):
        want = X @ W.astype(np.float32) + b
    else:
        want = _np_variant(X, fmt, b, mode)
    np.testing.assert_array_equal(got, want)


def test_ladder_modes_name_jax_modes():
    jmodes = set(_jax_record("deposit_study.json")["ladder"][0]["times_us"])
    assert set(ds.MODES.values()) | {"flagship"} == jmodes
    with pytest.raises(ValueError, match="mode"):
        ds.deposit_variant(torch.zeros((1, 248)),
                           tf.TiledEllDeposit.from_dense(
                               np.eye(248, 128, dtype=np.int8)),
                           torch.zeros(128), mode="nodeposit")


# ---------------------------------------------------------------------------
# each tool's entry point on the CPU, against the JAX records' keys
# ---------------------------------------------------------------------------


def _run(main, argv, capsys):
    ck.reset_counts()
    assert main(argv) == 0
    assert not ck.launches and not ck.plain_on_cuda   # CPU: plain versions
    out = capsys.readouterr().out.splitlines()
    return json.loads(out[-1])


def test_ffn_bench_main(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(ffn_bench, "PRELU_SHAPES", [(128, 256, 128)])
    monkeypatch.setattr(ffn_bench, "SWIGLU_SHAPES", [(128, 256)])
    # one short host-clock loop a time: 2 blocks x 2 x 3 times x 3 repeats
    monkeypatch.setattr(ffn_bench, "timer", lambda dev, **kw: functools.partial(
        timing.time_wall, min_seconds=0.0))
    path = tmp_path / "ffn.json"
    got = _run(ffn_bench.main, ["--device", "cpu", "--out", str(path)],
               capsys)
    assert json.loads(path.read_text()) == got
    assert got["device"] == "cpu"
    jrows = {r["block"]: r for r in _jax_record("ffn_bench.json")["blocks"]}
    assert [r["block"] for r in got["blocks"]] == ["prelu_ffn", "swiglu"]
    for row in got["blocks"]:
        want = jrows[row["block"]]
        assert set(row) == set(want)
        assert set(row["fused"]) == set(want["fused"])
        assert row["correct"] and row["max_abs_err"] == 0.0
        assert row["fused"]["single_us"] > 0


def test_ffn_bench_times_fused_and_unfused_alike(capsys, monkeypatch):
    """Every time ffn_bench takes, fused and unfused, single and stacked,
    is taken by the one timer the card would use for it: events around a
    replayed CUDA graph (``timing.time_cuda_graph``), which keeps the host's
    gaps between the unfused block's ops out of its time."""
    monkeypatch.setattr(ffn_bench, "PRELU_SHAPES", [(128, 256, 128)])
    monkeypatch.setattr(ffn_bench, "SWIGLU_SHAPES", [(128, 256)])
    card_timers = []

    def spy(dev, **kw):
        card_timers.append(tools.timer(torch.device("cuda"), **kw))
        return functools.partial(timing.time_wall, min_seconds=0.0)

    monkeypatch.setattr(ffn_bench, "timer", spy)
    got = _run(ffn_bench.main, ["--device", "cpu"], capsys)
    # 2 blocks x (fused, unfused) x (L = 1, 2, 8)
    assert len(card_timers) == 12 and len(got["blocks"]) == 2
    assert all(t is timing.time_cuda_graph for t in card_timers)
    assert tools.timer(torch.device("cuda")) is timing.time_cuda_events
    assert tools.timer(CPU, graph=True) is timing.time_wall
    with pytest.raises(ValueError, match="CUDA tensors"):
        timing.time_cuda_graph(lambda a: a, torch.ones(2))


def test_membench_main(capsys):
    got = _run(membench.main, ["--device", "cpu", "--sizes-mb", "0.0625",
                               "--tiles", "4,4096", "--layouts",
                               "tiled4d,rowmajor"], capsys)
    jkeys = set(_jax_record("membench.json")[0])
    assert [r["layout"] for r in got["records"]] == ["tiled4d", "rowmajor"]
    for rec in got["records"]:
        assert set(rec) == jkeys | {"device"}
        assert rec["grid"] == [2, 2] and rec["mb"] == 0.0625
        assert rec["gbps"] > 0


def test_membench_records_a_failing_config(capsys):
    """A config the stream probe refuses (tk*tn not a multiple of 4096) is
    recorded as JAX's ``{"mb", "tile", "layout", "error"}`` row (with the
    device), and the sweep goes on (``tools/membench.py:149-153``)."""
    got = _run(membench.main, ["--device", "cpu", "--sizes-mb", "0.0625",
                               "--tiles", "4,1000;4,4096", "--layouts",
                               "tiled4d"], capsys)
    bad, ok = got["records"]
    assert set(bad) == {"mb", "tile", "layout", "error", "device"}
    assert bad["tile"] == [4, 1000] and bad["mb"] == 0.0625
    assert "ValueError" in bad["error"] and "4096" in bad["error"]
    assert "error" not in ok and ok["tile"] == [4, 4096] and ok["gbps"] > 0


def test_decode_roofline_main(capsys):
    got = _run(dr.main, ["--device", "cpu", "--configs", "4x128x256x4"],
               capsys)
    want = _jax_record("decode_roofline.json")
    assert set(got) == set(want) | {"device"}
    assert set(got["decode_rate"]) >= set(want["decode_rate"])
    # one row, the plain version's (each branch has a row on the card)
    assert [r["branch"] for r in got["configs"]] == ["plain"]
    assert set(got["configs"][0]) == set(want["configs"][0]) | {"branch"}
    assert got["beta_measured_GBps"] is None        # no device rate on a CPU
    assert got["configs"][0]["own_bytes"] == 4 * (4 * 128 + 4 * 256 + 256) \
        + tf.TiledBitplane.from_dense(np.zeros((128, 256), np.int8)
                                      ).size_bytes()


def test_deposit_study_main(capsys, monkeypatch):
    monkeypatch.setattr(ds, "AUDIT_CONFIGS", [(300, 256)])
    monkeypatch.setattr(ds, "LADDER_CONFIGS", [(3, 300, 256, 4)])
    got = _run(ds.main, ["--device", "cpu", "--repeats", "1"], capsys)
    want = _jax_record("deposit_study.json")
    assert set(got["bytes_audit"][0]) == set(want["bytes_audit"][0])
    row, jrow = got["ladder"][0], want["ladder"][0]
    assert set(row) == set(jrow) | {"stands_in_for", "flagship_branch"}
    assert row["flagship_branch"] == "plain"
    assert {row["stands_in_for"][m] for m in ds.MODES} | {"flagship"} == \
        set(jrow["times_us"])
    assert row["correct"] == {"full": True, "staticcap": True}


@pytest.mark.parametrize("main", [ffn_bench.main, membench.main, dr.main,
                                  ds.main, st.main, sb.main],
                         ids=["ffn_bench", "membench", "decode_roofline",
                              "deposit_study", "serve_trace", "swiglu_bench"])
def test_tools_default_to_the_card(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_swiglu_bench_main(capsys, tmp_path):
    """The SwiGLU bench on the CPU times the plain version (host clock) at
    each shape and row count, beside the bound of the three planes."""
    path = tmp_path / "sb.json"
    assert sb.main(["--device", "cpu", "--rows", "1", "4", "--shapes",
                    "128x256", "--repeats", "1", "--out", str(path)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == json.loads(path.read_text())
    assert got["device"] == "cpu" and got["card"] is None
    assert [(r["d"], r["ff"], r["M"]) for r in got["rows"]] == [
        (128, 256, 1), (128, 256, 4)]
    for r in got["rows"]:
        assert r["plain_ms"] > 0 and r["bound_by"] == "bytes"
        # gate and up 128 x 256, down 256 x 128: 2 bits a weight
        want = (3 * 2 * 128 * 256 // 8 + 4 * (2 * r["M"] * 128 + r["M"]))
        assert r["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)


def test_no_tool_writes_the_tpu_records(tmp_path):
    with pytest.raises(ValueError, match="bench_artifacts"):
        tools.write_json(os.path.join(tools.TPU_RECORDS, "ffn_bench.json"),
                         {})
    tools.write_json(str(tmp_path / "x.json"), {"a": 1})
    assert json.loads((tmp_path / "x.json").read_text()) == {"a": 1}


# ---------------------------------------------------------------------------
# the serve trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0), ([(0, 2)], 2.0), ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 2), (1, 1.5)], 3.0), ([(0, 4), (1, 2), (3, 5)], 5.0)])
def test_busy_union(intervals, want):
    assert st.busy_union(intervals) == want


def test_trace_summary_on_injected_events():
    """Busy time is the union of the device intervals (kernels, memsets,
    memcpys), kernel time their sum; the port's kernels are those in the
    ``ternary::`` namespace; host ops are the cpu_op events."""
    ev = [{"ph": "X", "cat": "kernel", "name": "void ternary::mma8::k<1>()",
           "ts": 0.0, "dur": 400.0},
          {"ph": "X", "cat": "kernel", "name": "ampere_sgemm", "ts": 200.0,
           "dur": 400.0},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 900.0,
           "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
           "dur": 5.0},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0.0}]
    got = st.summarize(ev, 2e-3, True)
    assert got["wall_ms"] == pytest.approx(2.0)
    assert got["device_busy_ms"] == pytest.approx(0.7)
    assert got["device_busy_share"] == pytest.approx(0.35)
    assert got["kernel_ms"] == pytest.approx(0.8)
    assert got["ternary_ms"] == pytest.approx(0.4)
    assert got["kernels"] == 2 and got["host_ops"] == 1
    assert [t["name"] for t in got["top"]] == ["void ternary::mma8::k<1>()",
                                               "ampere_sgemm"]
    cpu = st.summarize(ev, 2e-3, False)
    assert cpu["device_busy_ms"] is None and cpu["device_busy_share"] is None


def test_serve_trace_main(capsys, monkeypatch):
    """A traced prefill and decode step of a tiny preset on the CPU: the
    plain versions, host ops counted, no device figures."""
    monkeypatch.setitem(st.serving.PRESETS, "tiny", dict(
        d_model=64, n_heads=4, d_ff=128, n_layers=2, vocab=64))
    got = _run(st.main, ["--device", "cpu", "--preset", "tiny"], capsys)
    assert got["device"] == "cpu" and got["layers"] == 2
    assert (got["batch"], got["prompt"]) == (st.BATCH, st.PROMPT)
    for call in ("prefill", "decode_step"):
        r = got[call]
        assert r["wall_ms"] > 0 and r["host_ops"] > 0
        assert r["device_busy_ms"] is None and r["kernels"] == 0


def test_serve_trace_graph_needs_the_card(monkeypatch):
    """``--graph`` traces replays of CUDA graphs: on the CPU it raises
    rather than trace the eager calls under its name."""
    monkeypatch.setitem(st.serving.PRESETS, "tiny", dict(
        d_model=64, n_heads=4, d_ff=128, n_layers=1, vocab=64))
    with pytest.raises(ValueError, match="CUDA graphs"):
        st.main(["--device", "cpu", "--preset", "tiny", "--graph"])
