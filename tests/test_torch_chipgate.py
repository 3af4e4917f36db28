"""The port's gate and pipeline tools against the JAX package's
(``tools/chipgate.py``, ``tools/bytes_validation.py``,
``tools/run_all.sh``), on the CPU: ``tools.chipgate``'s record at a small
shape of two N tiles and two K-blocks (every kernel correct, the JAX
tool's ``gate`` keys, the f32 reference bitwise the f64 one) and its exit
1, naming the kernel, when a wrong kernel is registered; the own-bytes
model of ``tools.bytes_validation``'s five kernels at its three shapes
against JAX's ``instrument(...).own_bytes`` for their Pallas counterparts
(the containers' bytes equal; X counted at 4 bytes here, at the Pallas
kernel's ``x_bytes`` there: the CUDA kernels read the f32 X themselves);
``tools.run_all`` through every step at tiny sizes, the plots skipped and
said so where matplotlib is hidden, and stopped by a failing gate."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu.bench.instrument import instrument as jinstrument
from ternary_spgemm_tpu.ops import all_kernels as jax_kernels
from ternary_spgemm_tpu_torch.bench.instrument import instrument
from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS, all_kernels, api
from ternary_spgemm_tpu_torch.tools import (
    bytes_validation,
    chipgate,
    run_all,
    sweep,
)

#: two 4096-column tiles and two 1024-row K-blocks of the bit planes
GATE = ["--M", "8", "--K", "2048", "--N", "4224", "--s", "16", "--prelu",
        "--min-seconds", "0.001", "--repeats", "1", "--device", "cpu"]
TINY_GATE = ["--M", "5", "--K", "1024", "--N", "200", "--s", "8", "--prelu",
             "--min-seconds", "0.0005", "--repeats", "1"]
#: the JAX tool's gate keys (``tools/chipgate.py:60-71``)
JAX_GATE_KEYS = {"device", "backend", "when", "purpose", "failed", "errors"}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture
def broken(monkeypatch):
    """A registered kernel one off the dense product in every cell."""
    spec = all_kernels()["CudaDense"]
    name = "BrokenDense"
    monkeypatch.setitem(api._KERNEL_REGISTRY, name, dataclasses.replace(
        spec, name=name, fn=lambda x, f, b, a=None: spec.fn(x, f, b, a) + 1))
    return name


def test_chipgate_record_at_a_multi_tile_shape(tmp_path):
    out = tmp_path / "gate.json"
    rc, text = _run(chipgate.main, GATE + ["--output", str(out)])
    assert rc == 0, text
    (record,) = json.loads(out.read_text())
    assert record["test_case"] == {"M": 8, "K": 2048, "N": 4224, "s": 16}
    assert set(record["results"]) == set(all_kernels())
    assert all(r["correct"] is True for r in record["results"].values())
    gate = record["gate"]
    assert JAX_GATE_KEYS <= set(gate)
    assert gate["card"] is None and gate["backend"] == "cpu"
    assert gate["failed"] == [] and gate["errors"] == {}
    ref = gate["reference"]
    assert ref["f32_equals_f64"] is True
    # the unclipped domain and the x8 (127) and bf16 (256) kernels' ones
    assert set(ref["max_abs_diff_by_domain"]) == {"all", "127", "256"}
    assert "31/31 correct" in text


def test_chipgate_exits_1_on_a_wrong_kernel(tmp_path, broken):
    out = tmp_path / "gate.json"
    rc, text = _run(chipgate.main, TINY_GATE + ["--output", str(out),
                                                "--device", "cpu"])
    assert rc == 1
    assert f"FAILED: {broken}" in text
    gate = json.loads(out.read_text())[0]["gate"]
    assert gate["failed"] == [broken]


def test_chipgate_reference_check_sees_a_non_integer_product(monkeypatch):
    """On non-integer X the f32 product is not the f64 one: the check
    reports it, rather than passing whatever it is given."""
    from ternary_spgemm_tpu_torch import formats
    from ternary_spgemm_tpu_torch.bench import BenchConfig

    cfg = BenchConfig(M=4, K=4096, N=64, s=1, device="cpu")
    cpu = torch.device("cpu")
    assert chipgate.f64_reference_check(cfg, cpu, [None])["f32_equals_f64"]
    real = formats.generate_x
    monkeypatch.setattr(formats, "generate_x",
                        lambda M, K, seed=0: real(M, K, seed=seed) / 3)
    ref = chipgate.f64_reference_check(cfg, cpu, [None])
    assert ref["f32_equals_f64"] is False
    assert ref["max_abs_diff_by_domain"]["all"] > 0


@pytest.fixture(scope="module")
def containers():
    """The five kernels' containers in both packages at each shape, over a
    fixed sparse pattern (the containers' bytes do not depend on it)."""
    out = {}
    for M, K, N, s in bytes_validation.SHAPES:
        W = np.zeros((K, N), np.int8)
        W[::7, ::5] = 1
        W[3::11, 1::3] = -1
        for name in bytes_validation.KERNELS:
            spec = all_kernels()[name]
            jspec = jax_kernels()[jax_name(name)]
            key = (K, N, spec.format_cls.__name__)
            if key not in out:
                out[key] = (spec.format_cls.from_dense(W),
                            jspec.format_cls.from_dense(W))
    return out


def jax_name(name):
    (jname,) = [j for j, p in REFERENCE_KERNELS.items() if p == name]
    return jname


@pytest.mark.parametrize("shape", bytes_validation.SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3])))
@pytest.mark.parametrize("name", bytes_validation.KERNELS)
def test_own_bytes_against_jax(containers, name, shape):
    M, K, N, s = shape
    spec, jspec = all_kernels()[name], jax_kernels()[jax_name(name)]
    fmt, jfmt = containers[(K, N, spec.format_cls.__name__)]
    mine = instrument(M, fmt, x_bytes=spec.x_bytes)
    theirs = jinstrument(M, jfmt, x_bytes=jspec.x_bytes)
    assert mine.container_bytes == theirs.container_bytes
    # by design: each CUDA kernel reads the f32 X (4 bytes an element),
    # where the Pallas kernel takes X staged at its x_bytes
    assert spec.x_bytes == 4.0
    assert mine.own_bytes - theirs.own_bytes == int(
        (4 - jspec.x_bytes) * M * K)


def test_bytes_validation_rows_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(bytes_validation, "SHAPES", [(8, 1024, 512, 4)])
    out = tmp_path / "bv.json"
    rc, text = _run(bytes_validation.main, ["--device", "cpu", "--output",
                                            str(out)])
    assert rc == 0, text
    rec = json.loads(out.read_text())
    assert rec["hlo_bytes_accessed"].startswith("no counterpart")
    assert [r["kernel"] for r in rec["rows"]] == bytes_validation.KERNELS
    for r in rec["rows"]:
        assert r["verdict"] == "ok", r
        assert r["hlo_bytes_accessed"] is None
        assert r["compiled_temp_bytes"] is None     # no allocator to read
    assert '"bytes_validation": "5/5 rows within 10%"' in text


@pytest.fixture
def tiny_pipeline(monkeypatch):
    monkeypatch.setattr(run_all, "CHIPGATE", [
        TINY_GATE, ["--M", "7", "--K", "1024", "--N", "136", "--s", "8",
                    "--prelu", "--min-seconds", "0.0005", "--repeats", "1"]])
    monkeypatch.setattr(bytes_validation, "SHAPES", [(4, 512, 256, 4)])
    monkeypatch.setattr(sweep, "BITNET_KN", [(512, 512)])
    monkeypatch.setattr(run_all, "HEADLINE", [
        "--M", "4", "--K", "512", "--N", "256", "--repeats", "1"])


@pytest.mark.parametrize("plots", [True, False], ids=["plots", "no_mpl"])
def test_run_all_on_the_cpu(tmp_path, tiny_pipeline, monkeypatch, plots):
    if not plots:
        real = run_all.importlib.util.find_spec
        monkeypatch.setattr(run_all.importlib.util, "find_spec",
                            lambda n, *a: None if n == "matplotlib"
                            else real(n, *a))
    rc, text = _run(run_all.main, ["--out", str(tmp_path), "--device",
                                   "cpu", "--limit", "1"])
    assert rc == 0, text
    made = set(os.listdir(tmp_path))
    assert {"chipgate.json", "chipgate_hostile.json", "bytes_validation.json",
            "bitnet_sweep.json", "headline.json"} <= made
    (rec,) = json.loads((tmp_path / "bitnet_sweep.json").read_text())
    assert set(rec["results"]) == set(run_all.SWEEP_KERNELS.split(","))
    pngs = {"performance.png", "roofline.png", "speedup.png"}
    if plots:
        assert pngs <= made
    else:
        assert not pngs & made
        assert text.count("skipped: matplotlib is not installed") == 3
    assert '"metric": "ternary_spgemm_useful_gflops"' in text


def test_run_all_stops_at_a_failing_gate(tmp_path, tiny_pipeline, broken):
    rc, text = _run(run_all.main, ["--out", str(tmp_path), "--device",
                                   "cpu"])
    assert rc == 1
    assert "run_all: chipgate exited 1; stopping" in text
    assert sorted(os.listdir(tmp_path)) == ["chipgate.json"]
