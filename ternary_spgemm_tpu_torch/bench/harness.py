"""Benchmark harness: correctness gate + timing per registered kernel —
counterpart of ``ternary_spgemm_tpu/bench/harness.py``.

Builds one seeded W and X (``main.cpp:60-74``), every container once per
class outside the timed region, optionally gates every kernel against the
dense reference (``-correctness``, ``main.cpp:206-249``), times each kernel
on the card (CUDA events, :mod:`.timing`) and reports speedup vs
``BaseTCSC`` (``main.cpp:257-263``) with the instrumented flops/bytes/OI
quantities (``main.cpp:264-271``). Results serialize to the same sweep-JSON
schema as the JAX package's (``plots/run_benchmark.py:44-47,103-107``), so
the records of the two packages compare key for key, kernel by counterpart.

The sweep covers this port's registry only: the kernels of the JAX
registry that have a counterpart here (``ops.REFERENCE_KERNELS``). A
default run of the JAX harness also times the kernels that are not ported
yet (``ops.unported()``); the port's records have no entry for them.

``BenchConfig.device`` is ``"cuda"`` by default and the harness raises if
there is no card; ``"cpu"`` runs the kernels' plain versions, for tests,
and reports no roofline fractions (there is no device bandwidth to hold
them to).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import torch

from ternary_spgemm_tpu_torch import reference
from ternary_spgemm_tpu_torch.bench.instrument import (
    advertised_hbm_bandwidth,
    instrument,
    own_roofline_fraction,
    roofline_fraction,
)
from ternary_spgemm_tpu_torch.bench.timing import TIMERS, TimingResult
from ternary_spgemm_tpu_torch.formats import (
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.ops import (
    BASELINE_KERNEL_NAME,
    REFERENCE_KERNELS,
    all_kernels,
)
from ternary_spgemm_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class KernelResult:
    name: str
    seconds: float
    runs: int
    flops: int
    gflops: float                 # useful-adds throughput (reference convention)
    effective_gflops: float       # dense-equivalent 2MNK/t
    nnz_per_s: float
    total_input_bytes: int
    operational_intensity: float
    #: of the card's memory bandwidth, reference byte formula (None on the
    #: CPU)
    roofline_fraction: Optional[float]
    own_roofline_fraction: Optional[float] = None  # kernel-own bytes
    correct: Optional[bool] = None
    max_abs_err: Optional[float] = None
    speedup: Optional[float] = None
    error: Optional[str] = None   # recorded per kernel; the sweep goes on
    seconds_spread: float = 0.0   # relative spread of the independent estimates
    n_estimates: int = 1
    low_confidence: bool = False
    #: the container's bytes (``Instrumentation.container_bytes``) and its
    #: nonzeros, counted from the container (None after an error)
    container_bytes: Optional[int] = None
    nnz: Optional[int] = None


@dataclasses.dataclass
class BenchConfig:
    M: int
    K: int
    N: int
    s: int
    prelu: bool = False
    seed: int = 0
    timer: str = "cuda_events"
    min_seconds: float = 0.2
    correctness: bool = True
    kernels: Optional[Sequence[str]] = None  # None = whole registry
    #: independent timing estimates per kernel (median reported)
    repeats: int = 1
    device: str = "cuda"


def device_name(device: str) -> str:
    """The name a result line gives its device."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _counterpart_hint(name: str) -> str:
    if name not in REFERENCE_KERNELS:
        return f"; registered: {sorted(all_kernels())}"
    if REFERENCE_KERNELS[name] is None:
        return " (a JAX kernel not ported yet)"
    return f" (the JAX kernel's counterpart here is {REFERENCE_KERNELS[name]!r})"


def run_config(cfg: BenchConfig, *, bandwidth: Optional[float] = None,
               verbose: bool = False) -> List[KernelResult]:
    dev = resolve_device(cfg.device)
    registry = all_kernels()
    if cfg.kernels is not None:
        for n in cfg.kernels:
            if n not in registry:
                raise ValueError(f"no kernel {n!r} in the port's registry"
                                 f"{_counterpart_hint(n)}")
        registry = {n: registry[n] for n in cfg.kernels}
    beta = bandwidth
    if beta is None and dev.type == "cuda":
        beta = advertised_hbm_bandwidth(dev)
    timer = TIMERS[cfg.timer]
    W = generate_ternary(cfg.K, cfg.N, cfg.s, seed=cfg.seed)
    X = torch.from_numpy(generate_x(cfg.M, cfg.K, seed=cfg.seed + 1)).to(dev)
    b = torch.from_numpy(generate_bias(cfg.N)).to(dev)
    alpha = (torch.from_numpy(generate_alpha(cfg.N)).to(dev)
             if cfg.prelu else None)
    W_dev = torch.from_numpy(W).to(dev)
    formats: Dict[type, object] = {}

    # Restricted-domain kernels (x_absmax) run and gate on X clipped INTO
    # their domain — the same X otherwise, so timings stay comparable while
    # correctness is checked against a reference on the clipped activations.
    domain: Dict[Optional[int], tuple] = {}

    def domain_inputs(absmax):
        if absmax is not None and absmax >= 512:
            absmax = None
        if absmax not in domain:
            Xc = X if absmax is None else torch.clamp(X, -absmax, absmax)
            want = None
            if cfg.correctness:
                want = (reference.dense_gemm_prelu(Xc, W_dev, b, alpha)
                        if cfg.prelu else reference.dense_gemm(Xc, W_dev, b))
            domain[absmax] = (Xc, want)
        return domain[absmax]

    results: List[KernelResult] = []
    for name, spec in registry.items():
        inst = None
        try:
            if spec.format_cls not in formats:
                formats[spec.format_cls] = spec.format_cls.from_dense(W_dev)
            # M-dependent derived views (TCSC's gather tables) are built
            # here, outside the timed region, like every container array
            fmt = formats[spec.format_cls].prepare(cfg.M)
            inst = instrument(cfg.M, fmt, prelu=cfg.prelu,
                              x_bytes=spec.x_bytes)

            def fn(x, f, _spec=spec):
                return _spec.fn(x, f, b, alpha)

            X_k, want_k = domain_inputs(spec.x_absmax)
            correct = max_err = None
            if want_k is not None:
                cmp = reference.compare_results(fn(X_k, fmt), want_k)
                max_err = cmp.max_abs_err
                if spec.approximate:
                    correct = max_err <= 4.0 * (cfg.K / cfg.s + 1)
                else:
                    correct = bool(cmp)
            t: TimingResult = timer(fn, X_k, aux=(fmt,),
                                    min_seconds=cfg.min_seconds,
                                    repeats=cfg.repeats)
            results.append(KernelResult(
                name=name, seconds=t.seconds, runs=t.runs, flops=inst.flops,
                gflops=inst.flops / t.seconds / 1e9,
                effective_gflops=inst.dense_equiv_flops / t.seconds / 1e9,
                nnz_per_s=inst.nnz * cfg.M / t.seconds,
                total_input_bytes=inst.total_input_bytes,
                operational_intensity=inst.operational_intensity,
                roofline_fraction=(None if beta is None else
                                   roofline_fraction(inst, t.seconds, beta)),
                own_roofline_fraction=(
                    None if beta is None else
                    own_roofline_fraction(inst, t.seconds, beta)),
                correct=correct, max_abs_err=max_err,
                seconds_spread=t.seconds_spread, n_estimates=t.n_estimates,
                low_confidence=t.low_confidence,
                container_bytes=inst.container_bytes, nnz=inst.nnz))
        except Exception as e:  # record, keep sweeping
            results.append(KernelResult(
                name=name, seconds=float("nan"), runs=0,
                flops=inst.flops if inst else 0,
                gflops=0.0, effective_gflops=0.0, nnz_per_s=0.0,
                total_input_bytes=inst.total_input_bytes if inst else 0,
                operational_intensity=inst.operational_intensity if inst else 0.0,
                roofline_fraction=None, error=f"{type(e).__name__}: {e}"))
        if verbose:
            print(f"  {results[-1].name:28s} {status(results[-1])}",
                  flush=True)

    base = next((r for r in results if r.name == BASELINE_KERNEL_NAME
                 and not r.error), None)
    if base is not None:
        for r in results:
            if not r.error:
                r.speedup = base.seconds / r.seconds
    return results


def fmt_fraction(v: Optional[float]) -> str:
    """A roofline fraction as a percentage; ``n/a`` where none was taken."""
    return "   n/a" if v is None else f"{v:6.1%}"


def status(r: KernelResult) -> str:
    return r.error or (f"{r.seconds*1e6:9.2f} us  {r.gflops:8.2f} GF/s "
                       f"(eff {r.effective_gflops:9.2f})  "
                       f"roofline {fmt_fraction(r.roofline_fraction)}  "
                       f"correct={r.correct}")


def to_reference_json(cfg: BenchConfig, results: List[KernelResult]) -> dict:
    """Serialize to the reference sweep schema
    (``plots/run_benchmark.py:44-47,103-107``); ``performance`` is GFLOP/s of
    useful adds."""
    test_case = {"M": cfg.M, "K": cfg.K, "N": cfg.N, "s": cfg.s}
    out = {}
    for r in results:
        if r.error:
            out[r.name] = {"error": r.error}
        else:
            out[r.name] = {
                "performance": r.gflops,
                "total_input_size": r.total_input_bytes,
                "operational_intensity": r.operational_intensity,
                "effective_gflops": r.effective_gflops,
                "nnz_per_s": r.nnz_per_s,
                "roofline_fraction": r.roofline_fraction,
                "own_roofline_fraction": r.own_roofline_fraction,
                "seconds": r.seconds,
                "seconds_spread": r.seconds_spread,
                "n_estimates": r.n_estimates,
                "low_confidence": r.low_confidence,
                "speedup": r.speedup,
                "correct": r.correct,
            }
    return {"test_case": test_case, "results": out}


def dump_json(records: List[dict], path: str):
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
