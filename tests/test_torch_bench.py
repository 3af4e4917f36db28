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
    "BaseTCSR": "BaseTCSR",
    "BlockedTCSC": "BlockedTCSC",
    "InterleavedTCSC": "InterleavedTCSC",
    "InterleavedBlockedTCSC": "InterleavedBlockedTCSC",
    "EllTCSC": "EllTCSC",
    "BlockedEllTCSC": "BlockedEllTCSC",
    "DenseMXU": "DenseMXU",
    "DenseMXU_bf16": "DenseMXU_bf16",
    "DenseMXU_x8": "DenseMXU_x8",
    "PackedMXU_2bit": "PackedMXU_2bit",
    "PackedMXU_base3": "PackedMXU_base3",
    "PackedCSC": "PackedCSC",
    "CudaTiledBitplane_x8": "PallasTiledBitplane_x8",
    "CudaTiledBitplane_i8": "PallasTiledBitplane_i8",
    "CudaTiledBitplane_bf16": "PallasTiledBitplane_bf16",
    "CudaTiledNibblePair_i8": "PallasTiledNibblePair_i8",
    "CudaTiledDense_i8": "PallasTiledDense_i8",
    "CudaTiledDense_x8": "PallasTiledDense_x8",
    "CudaDense": "PallasDense",
    "CudaDense_bf16": "PallasDense_bf16",
    "CudaDense_i8": "PallasDense_i8",
    "CudaBlockPacked_i8": "PallasBlockPacked_i8",
    "CudaTiledBlockPacked_i8": "PallasTiledBlockPacked_i8",
    "CudaPacked2Bit": "PallasPacked2Bit",
    "CudaPacked53": "PallasPacked53",
    "CudaPacked2Bit_i8": "PallasPacked2Bit_i8",
    "CudaPacked53_i8": "PallasPacked53_i8",
    "CudaEllDeposit_i8": "PallasEllDeposit_i8",
    "CudaTiledEllGather": "PallasTiledEllGather",
    "CudaEllGather": "PallasEllGather",
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
        # a hand-written kernel names its CUDA source and its plain version;
        # the torch-op formulations of JAX's XLA kernels have neither
        assert bool(t.source) == bool(t.plain) == name.startswith("Cuda")
        if t.source:
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert os.path.isfile(os.path.join(root, t.source)), t.source


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
    """The headline's default set is ``bench.py``'s, every kernel by its
    counterpart here."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_py", os.path.join(root, "bench.py"))
    bench_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_py)
    assert headline.BENCH_PY_DEFAULT_KERNELS == bench_py.DEFAULT_KERNELS
    assert headline.DEFAULT_KERNELS == [
        "CudaDense", "CudaDense_bf16", "CudaDense_i8",
        "CudaPacked2Bit", "CudaPacked2Bit_i8",
        "CudaPacked53", "CudaPacked53_i8",
        "CudaBlockPacked_i8",
        "CudaTiledDense_i8", "CudaTiledBlockPacked_i8",
        "CudaTiledBitplane_i8", "CudaEllDeposit_i8",
        "CudaTiledBitplane_x8", "CudaTiledDense_x8", "DenseMXU_x8",
        "CudaEllGather", "CudaTiledEllGather", "DenseMXU", "DenseMXU_bf16"]
    assert unported(headline.BENCH_PY_DEFAULT_KERNELS) == []


#: the torch-op formulations of the containers that need K a multiple of
#: their 512-row block (the harness builds them at their default block)
BLOCKED_KERNELS = ("BlockedTCSC", "InterleavedBlockedTCSC")


@pytest.mark.parametrize("name, says", [
    ("PallasEllGather", "'CudaEllGather'"),
    ("PallasDense", "'CudaDense'"),
    ("PallasTiledBitplane_i8", "'CudaTiledBitplane_i8'"),
    ("NoSuchKernel", "registered: "),
])
def test_run_config_rejects_unknown_kernels(name, says):
    cfg = tbench.BenchConfig(M=2, K=32, N=64, s=2, device="cpu",
                             kernels=["BaseTCSC", name])
    with pytest.raises(ValueError, match=says):
        tbench.run_config(cfg)


@pytest.mark.parametrize("cls", ["TCSC", "TiledBitplane", "TiledNibblePair",
                                 "TiledDenseTernary", "TiledBlockPacked",
                                 "BlockPackedTernary", "DenseTernary",
                                 "PackedTernary2Bit", "PackedTernary53",
                                 "TiledEllTCSC", "BlockedEllTCSC",
                                 "TiledEllDeposit"])
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
    _schema_matches_jax({n: j for n, j in PAIRS.items()
                         if n not in BLOCKED_KERNELS}, kw)


def test_run_config_blocked_kernels_match_jax_schema():
    """The blocked containers at K = 512, one block of the harness's
    default, and a K they cannot take recorded as the kernels' error in
    both harnesses."""
    kw = dict(M=3, K=512, N=130, s=3, prelu=True, min_seconds=0.001,
              correctness=True, timer="wall")
    _schema_matches_jax({n: n for n in ("BaseTCSC", *BLOCKED_KERNELS)}, kw)
    kw["K"] = 100
    tcfg = tbench.BenchConfig(kernels=list(BLOCKED_KERNELS), device="cpu",
                              **kw)
    jcfg = jbench.BenchConfig(kernels=list(BLOCKED_KERNELS), **kw)
    for results in (tbench.run_config(tcfg), jbench.run_config(jcfg)):
        assert [r.name for r in results] == list(BLOCKED_KERNELS)
        assert all("divisible by block_size" in r.error for r in results)


def _schema_matches_jax(pairs: dict, kw: dict):
    tcfg = tbench.BenchConfig(kernels=list(pairs), device="cpu", **kw)
    jcfg = jbench.BenchConfig(kernels=list(pairs.values()), **kw)
    trec = tbench.to_reference_json(tcfg, tbench.run_config(tcfg))
    jrec = jbench.to_reference_json(jcfg, jbench.run_config(jcfg))
    assert trec["test_case"] == jrec["test_case"]
    assert set(trec) == set(jrec)
    for name, jname in pairs.items():
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


BLOCKED = ("BlockedTCSC", "InterleavedBlockedTCSC")


def _cli_sweep(capsys, K):
    rc = cli.main(["-M", "3", "-K", str(K), "-N", "140", "-s", "3",
                   "-correctness", "-prelu", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.splitlines()
    assert lines[0].endswith("device=cpu")
    # the sweep is the whole JAX registry, each kernel by its counterpart
    assert unported() == [] and len(all_kernels()) == 31
    assert lines[1] == ("# 31 kernels, the port's registry: a counterpart "
                        "of every kernel of the JAX registry")
    return out, {name: [ln for ln in lines if ln.split()[:1] == [name]]
                 for name in all_kernels()}


def test_cli_runs_on_cpu(capsys):
    # K = 48, off the blocked containers' 512-row block: they print ERROR,
    # as the JAX CLI prints it, and the run does not fail for it
    out, mine = _cli_sweep(capsys, 48)
    for name, got in mine.items():
        if name in BLOCKED:
            assert got == [f"{name:28s} ERROR ValueError: K=48 must be "
                           "divisible by block_size=512 (reference asserts "
                           "the same, BlockedTCSC.h:5)"], got
        else:
            assert len(got) == 1 and got[0].endswith("correct=True"), got
    assert out.count("ERROR") == len(BLOCKED)


def test_cli_runs_on_cpu_at_the_blocked_block(capsys):
    # K = 512: the blocked containers' default block, every kernel runs
    out, mine = _cli_sweep(capsys, 512)
    for got in mine.values():
        assert len(got) == 1 and got[0].endswith("correct=True"), got
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
    # value and vs_baseline are each rounded to 3 decimals from the same
    # unrounded GFLOP/s, so they agree to within those two roundings
    ref = headline.REFERENCE_GFLOPS
    assert abs(rec["vs_baseline"] - rec["value"] / ref) <= 5e-4 + 5e-4 / ref


def test_headline_default_set_on_cpu(capsys):
    rc = headline.main(["--M", "2", "--K", "64", "--N", "128", "--repeats",
                        "1", "--device", "cpu", "--correctness"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.strip().splitlines()
    assert lines[1] == ("# bench.py's 19 default kernels, each by its "
                        "counterpart here")
    assert len(headline.DEFAULT_KERNELS) == \
        len(headline.BENCH_PY_DEFAULT_KERNELS) == 19
    rec = json.loads(lines[-1])
    # the best kernel of the default set that is exact on +-512
    spec = all_kernels()[rec["best_kernel"]]
    assert rec["best_kernel"] in headline.DEFAULT_KERNELS
    assert not spec.approximate
    assert spec.x_absmax is None or spec.x_absmax >= 512
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
