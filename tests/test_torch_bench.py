"""Port parity: the benchmark harness, its CLI and its headline against the
JAX package's, on the CPU (``device="cpu"`` runs the kernels' plain
versions; JAX's Pallas kernels run in interpret mode).

Timings here are host-clock times of CPU code and are checked only for
being positive; the records must match JAX's key for key, with the same
correctness flags.
"""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from ternary_spgemm_tpu import bench as jbench
from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu_torch import __main__ as cli
from ternary_spgemm_tpu_torch import bench as tbench
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.bench import headline
from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS, all_kernels, unported

#: port kernel -> the JAX kernel it replaces
PAIRS = {
    "BaseTCSC": "BaseTCSC",
    "CudaTiledBitplane_x8": "PallasTiledBitplane_x8",
    "CudaTiledBitplane_i8": "PallasTiledBitplane_i8",
    "CudaTiledBitplane_bf16": "PallasTiledBitplane_bf16",
    "CudaTiledNibblePair_i8": "PallasTiledNibblePair_i8",
    "CudaTiledDense_i8": "PallasTiledDense_i8",
    "CudaTiledDense_x8": "PallasTiledDense_x8",
}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")


def test_registry_mirrors_jax():
    from ternary_spgemm_tpu.ops import all_kernels as jall

    port, jax_reg = all_kernels(), jall()
    assert list(port) == list(PAIRS)
    for name, jname in PAIRS.items():
        t, j = port[name], jax_reg[jname]
        assert (t.format_cls.__name__, t.approximate, t.x_absmax) \
            == (j.format_cls.__name__, j.approximate, j.x_absmax)
        # every kernel of the port reads f32 X (the TPU wrappers narrow X
        # to 2 or 1 bytes before their call)
        assert t.x_bytes == 4.0


def test_reference_kernels_cover_jax_registry():
    """``REFERENCE_KERNELS`` lists the whole JAX registry, in its order,
    and each port kernel is the counterpart of exactly one JAX kernel,
    whose ``def`` line its ``reference`` names."""
    from ternary_spgemm_tpu.ops import all_kernels as jall

    jax_reg = jall()
    assert list(REFERENCE_KERNELS) == list(jax_reg)
    assert {v: k for k, v in REFERENCE_KERNELS.items() if v} == PAIRS
    assert unported() == [n for n in jax_reg if n not in PAIRS.values()]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, jname in PAIRS.items():
        path, line = all_kernels()[name].reference.split(":")
        with open(os.path.join(root, path)) as f:
            src = f.read().splitlines()[int(line) - 1]
        assert src.startswith(f"def {jax_reg[jname].fn.__name__}("), \
            (name, src)


def test_headline_default_follows_bench_py():
    """The headline's default set is ``bench.py``'s, limited to the
    kernels the port has."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_py", os.path.join(root, "bench.py"))
    bench_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_py)
    assert headline.BENCH_PY_DEFAULT_KERNELS == bench_py.DEFAULT_KERNELS
    assert headline.DEFAULT_KERNELS == [
        "CudaTiledDense_i8", "CudaTiledBitplane_i8", "CudaTiledBitplane_x8",
        "CudaTiledDense_x8"]


@pytest.mark.parametrize("name, says", [
    ("PallasDense", "not ported yet"),
    ("PallasTiledBitplane_i8", "'CudaTiledBitplane_i8'"),
    ("NoSuchKernel", "registered: "),
])
def test_run_config_rejects_unknown_kernels(name, says):
    cfg = tbench.BenchConfig(M=2, K=32, N=64, s=2, device="cpu",
                             kernels=["BaseTCSC", name])
    with pytest.raises(ValueError, match=says):
        tbench.run_config(cfg)


@pytest.mark.parametrize("cls", ["TCSC", "TiledBitplane", "TiledNibblePair",
                                 "TiledDenseTernary"])
@pytest.mark.parametrize("prelu", [False, True])
@pytest.mark.parametrize("x_bytes", [4.0, 2.0, 1.0])
def test_instrument_matches_jax(cls, prelu, x_bytes):
    W = jf.generate_ternary(96, 200, 3, seed=2)
    j = jbench.instrument(5, getattr(jf, cls).from_dense(W), prelu=prelu,
                          x_bytes=x_bytes)
    t = tbench.instrument(5, getattr(tf, cls).from_dense(W), prelu=prelu,
                          x_bytes=x_bytes)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.dense_equiv_flops == j.dense_equiv_flops
    from ternary_spgemm_tpu.bench.instrument import own_roofline_fraction
    from ternary_spgemm_tpu_torch.bench.instrument import (
        own_roofline_fraction as t_own)
    assert tbench.roofline_fraction(t, 1e-5, 3.35e12) == \
        jbench.roofline_fraction(j, 1e-5, 3.35e12)
    assert t_own(t, 1e-5, 3.35e12) == own_roofline_fraction(j, 1e-5, 3.35e12)


def test_run_config_matches_jax_schema():
    kw = dict(M=4, K=64, N=256, s=4, prelu=True, min_seconds=0.001,
              correctness=True, timer="wall")
    tcfg = tbench.BenchConfig(kernels=list(PAIRS), device="cpu", **kw)
    jcfg = jbench.BenchConfig(kernels=list(PAIRS.values()), **kw)
    trec = tbench.to_reference_json(tcfg, tbench.run_config(tcfg))
    jrec = jbench.to_reference_json(jcfg, jbench.run_config(jcfg))
    assert trec["test_case"] == jrec["test_case"]
    assert set(trec) == set(jrec)
    for name, jname in PAIRS.items():
        t, j = trec["results"][name], jrec["results"][jname]
        assert set(t) == set(j), name
        assert t["correct"] is True and j["correct"] is True, (name, t, j)
        for key in ("total_input_size", "operational_intensity"):
            assert t[key] == j[key], (name, key)
        assert t["seconds"] > 0 and t["speedup"] > 0
        assert t["roofline_fraction"] is None       # no device bandwidth
    json.dumps(trec)


def test_run_config_clips_restricted_domains():
    """Restricted-domain kernels gate on X clipped into their domain: the
    x8 kernels would fail the gate on the full +-512 X otherwise."""
    cfg = tbench.BenchConfig(M=3, K=40, N=130, s=2, min_seconds=0.001,
                             timer="wall", device="cpu",
                             kernels=["CudaTiledDense_x8",
                                      "CudaTiledBitplane_bf16"])
    results = tbench.run_config(cfg)
    assert [r.correct for r in results] == [True, True]
    assert all(r.error is None and r.max_abs_err == 0.0 for r in results)


def test_cli_runs_on_cpu(capsys):
    rc = cli.main(["-M", "3", "-K", "48", "-N", "140", "-s", "3",
                   "-correctness", "-prelu", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.splitlines()
    assert lines[0].endswith("device=cpu")
    # the JAX kernels this sweep leaves out are named, not skipped quietly
    assert lines[1] == (f"# {len(all_kernels())} kernels, the port's "
                        "registry; not ported yet, so not swept: "
                        + ", ".join(unported()))
    for name in all_kernels():
        mine = [ln for ln in lines if ln.split()[:1] == [name]]
        assert len(mine) == 1 and mine[0].endswith("correct=True"), mine
    assert "ERROR" not in out


def test_cli_exits_1_on_a_kernel_error(monkeypatch, capsys):
    """A kernel that raises is recorded (the sweep goes on) and fails the
    run."""
    from ternary_spgemm_tpu_torch.ops import api

    def broken(X, fmt, bias, alpha=None):
        raise RuntimeError("launch failed")

    spec = api.get_kernel("CudaTiledDense_i8")
    monkeypatch.setitem(api._KERNEL_REGISTRY, spec.name,
                        dataclasses.replace(spec, fn=broken))
    rc = cli.main(["-M", "2", "-K", "32", "-N", "64", "--device", "cpu",
                   "--kernels", "CudaTiledDense_i8,CudaTiledDense_x8"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "CudaTiledDense_i8            ERROR RuntimeError: launch failed" \
        in out
    assert [ln.split()[0] for ln in out.splitlines()[1:]] == [
        "CudaTiledDense_i8", "CudaTiledDense_x8"]


def test_headline_json_on_cpu(capsys):
    rc = headline.main(["--M", "3", "--K", "64", "--N", "128", "--repeats",
                        "2", "--device", "cpu", "--correctness", "--all"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.splitlines()[0] == "# device: cpu"
    rec = json.loads(out.strip().splitlines()[-1])
    # bench.py's keys, without the stacked-marginal ones (bench/stacked.py
    # is not ported yet)
    assert set(rec) == {
        "metric", "value", "unit", "vs_baseline", "best_kernel", "seconds",
        "seconds_spread", "n_estimates", "effective_gflops", "nnz_per_s",
        "roofline_fraction", "own_roofline_fraction", "best_any_kernel",
        "best_any_gflops", "config"}
    # the best exact kernel is exact on the full +-512 domain
    spec = all_kernels()[rec["best_kernel"]]
    assert spec.x_absmax is None or spec.x_absmax >= 512
    assert rec["value"] > 0 and rec["n_estimates"] == 2
    assert rec["vs_baseline"] == round(rec["value"] / headline.REFERENCE_GFLOPS,
                                       3)


def test_headline_default_set_on_cpu(capsys):
    rc = headline.main(["--M", "2", "--K", "64", "--N", "128", "--repeats",
                        "1", "--device", "cpu", "--correctness"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.strip().splitlines()
    assert lines[1] == ("# bench.py's default kernels not ported yet, so not "
                        "swept: " + ", ".join(
                            unported(headline.BENCH_PY_DEFAULT_KERNELS)))
    rec = json.loads(lines[-1])
    assert rec["best_kernel"] in ("CudaTiledDense_i8", "CudaTiledBitplane_i8")
    assert rec["best_any_kernel"] in headline.DEFAULT_KERNELS


def test_cuda_device_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run_config(tbench.BenchConfig(M=2, K=32, N=64, s=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-M", "2", "-K", "32", "-N", "64", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="bandwidth="):
        tbench.advertised_hbm_bandwidth("cpu")


def test_timers():
    x = torch.ones(16, 16)
    r = tbench.time_wall(lambda a: a * 2.0, x, min_seconds=0.001, repeats=3)
    assert r.seconds > 0 and r.runs >= 1 and r.n_estimates == 3
    assert r.seconds_spread >= 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbench.time_cuda_events(lambda a: a, x)
    assert set(tbench.TIMERS) == {"cuda_events", "wall"}
    assert tbench.BenchConfig(M=1, K=1, N=1, s=1).timer == "cuda_events"
    assert tbench.BenchConfig(M=1, K=1, N=1, s=1).device == "cuda"
