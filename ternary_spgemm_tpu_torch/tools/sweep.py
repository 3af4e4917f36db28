"""Benchmark sweep runner — counterpart of the repository's
``tools/sweep.py``.

Drives the reference's canonical grid (``run_benchmark.py:13-24``): M in
{1, 16, 64, 256, 1000, 4000, 16000, 64000} x (K, N) in {(512, 2048),
(1024, 4096), (2048, 8192), (4096, 16384), (2048, 512), (4096, 1024),
(8192, 2048), (16384, 4096)} x s in {2, 4, 8, 16}; or a single-dimension
sweep with the other dims at 1024 (``--varyonly M|K|N``), a sparsity-only
sweep (``--sparsityonly``) or BASELINE.json's BitNet layers (``--preset
bitnet``). Each config runs in-process through the port's harness
(``bench.harness.run_config``) and is written in the JAX sweep's JSON
schema, a list of ``{"test_case": {M, K, N, s}, "results": {name: {...}}}``
records, after every config atomically (a temporary file renamed over the
output), so ``--resume`` restarts a cut grid where it stopped.

Kernels are the port's names; ``--kernels`` also takes the JAX registry's
(mapped to their counterparts). The default set is the headline's
(``bench.headline.DEFAULT_KERNELS``: the counterparts of ``bench.py``'s 19).

Feasibility: the torch-op gather formulations (``GATHER_KERNELS``)
materialise the gathered ``(M, nnz)`` stream (nnz ~ 2KN/s), so a config
whose stream passes the budget is recorded as a documented skip, not run
into an out-of-memory error. The JAX tool's budget is 6e8 floats (2.4 GB
of a TPU's HBM). On the card the budget is a quarter of its memory
(``torch.cuda.get_device_properties(dev).total_memory / 4`` bytes, as f32
elements): the formulations hold up to two such streams at once (the
gathered values and their signed or summed copy), which leaves half the
card for the inputs, the containers and the rest. ``--device cpu`` keeps
the JAX budget.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.sweep [--output PATH]
        [--preset bitnet | --varyonly M|K|N | --sparsityonly]
        [--m-values ...] [--kn KxN ...] [--s-values ...] [--kernels a,b]
        [--correctness] [--repeats 1] [--resume] [--limit N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import torch

CANONICAL_M = [1, 16, 64, 256, 1000, 4000, 16000, 64000]
CANONICAL_KN = [(512, 2048), (1024, 4096), (2048, 8192), (4096, 16384),
                (2048, 512), (4096, 1024), (8192, 2048), (16384, 4096)]
CANONICAL_S = [2, 4, 8, 16]
VARY_DIM_VALUES = [256, 512, 1024, 2048, 4096, 8192]  # plots/run_benchmark.py:8-18
FIXED = 1024
#: BASELINE.json config 4: "BitNet-style layer sweep: M in {1,32,512},
#: K=N in {4096,11008}, s in {2,4,8,16} roofline study".
BITNET_M = [1, 32, 512]
BITNET_KN = [(4096, 4096), (11008, 11008)]

#: the torch-op formulations that materialise the (M, nnz) stream
#: (BaseTCSC walks M in chunks above its own budget, so it runs everywhere)
GATHER_KERNELS = ("BaseTCSR", "BlockedTCSC", "InterleavedTCSC",
                  "InterleavedBlockedTCSC", "EllTCSC", "PackedCSC")
#: the JAX tool's budget: f32 elements of the (M, nnz) stream (~2.4 GB)
GATHER_BUDGET_FLOATS = 6e8


def build_grid(args):
    """The (M, K, N, s) configs of ``args`` (the JAX ``build_grid``'s
    order: s innermost, so X stays cached across the sparsities)."""
    if args.preset == "bitnet":
        for (k, n) in BITNET_KN:
            for s in (args.s_values or CANONICAL_S):
                for m in (args.m_values or BITNET_M):
                    yield m, k, n, s
        return
    if args.varyonly:
        for v in VARY_DIM_VALUES:
            cfg = {"M": FIXED, "K": FIXED, "N": FIXED, args.varyonly: v}
            for s in (args.s_values or CANONICAL_S):
                yield cfg["M"], cfg["K"], cfg["N"], s
        return
    if args.sparsityonly:
        for s in (args.s_values or CANONICAL_S):
            yield FIXED, FIXED, FIXED, s
        return
    for (k, n), m, s in itertools.product(args.kn or CANONICAL_KN,
                                          args.m_values or CANONICAL_M,
                                          args.s_values or CANONICAL_S):
        yield m, k, n, s


def gather_budget_floats(dev: torch.device) -> float:
    """The (M, nnz) budget on ``dev`` (module docstring)."""
    if dev.type != "cuda":
        return GATHER_BUDGET_FLOATS
    return torch.cuda.get_device_properties(dev).total_memory / 4 / 4


def skip_reason(kernel: str, m: int, k: int, n: int, s: int,
                budget_floats: float = GATHER_BUDGET_FLOATS):
    """A human-readable skip reason, or None if the config is feasible."""
    if kernel in GATHER_KERNELS and m * (2 * k * n // s) > budget_floats:
        return (f"skipped: gather formulation materializes the (M, nnz) "
                f"stream = {m * (2 * k * n // s) * 4 / 1e9:.1f} GB "
                f"(> {budget_floats * 4 / 1e9:.1f} GB device budget)")
    return None


def kernel_names(arg) -> list:
    """``--kernels`` as the port's names (a JAX registry name maps to its
    counterpart); the headline's default set without it."""
    from ternary_spgemm_tpu_torch.bench.headline import DEFAULT_KERNELS
    from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS, all_kernels

    if not arg:
        return list(DEFAULT_KERNELS)
    names = arg.split(",")
    return [n if n in all_kernels() else REFERENCE_KERNELS.get(n, n)
            for n in names]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.sweep")
    p.add_argument("--output", default="sweep_results.json")
    p.add_argument("--preset", choices=["bitnet"], default=None)
    p.add_argument("--varyonly", choices=["M", "K", "N"], default=None)
    p.add_argument("--prelu", action="store_true")
    p.add_argument("--sparsityonly", action="store_true")
    p.add_argument("--m-values", type=int, nargs="*", default=None)
    p.add_argument("--kn", type=lambda s: tuple(map(int, s.split("x"))),
                   nargs="*", default=None, metavar="KxN")
    p.add_argument("--s-values", type=int, nargs="*", default=None)
    p.add_argument("--kernels", default=None,
                   help="comma-separated kernel names (default: the "
                        "headline's set, bench.py's 19 by counterpart)")
    p.add_argument("--correctness", action="store_true")
    p.add_argument("--correctness-limit", type=int, default=1 << 24,
                   help="gate correctness only when M*N <= this (the dense "
                        "reference of a larger config costs more than the "
                        "kernels)")
    p.add_argument("--min-seconds", type=float, default=0.05)
    p.add_argument("--repeats", type=int, default=1,
                   help="independent timing estimates per kernel per "
                        "config (rows carry seconds_spread / n_estimates)")
    p.add_argument("--limit", type=int, default=None,
                   help="stop after this many configs (smoke runs)")
    p.add_argument("--resume", action="store_true",
                   help="load --output if it exists and skip configs "
                        "already recorded")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench import (
        BenchConfig, run_config, to_reference_json)
    from ternary_spgemm_tpu_torch.tools import check_out, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    check_out(args.output)
    budget = gather_budget_floats(dev)
    kernels = kernel_names(args.kernels)
    records, done = [], set()
    if args.resume and os.path.exists(args.output):
        with open(args.output) as f:
            records = json.load(f)
        done = {tuple(r["test_case"][d] for d in ("M", "K", "N", "s"))
                for r in records}
        print(f"resume: {len(done)} configs already in {args.output}",
              flush=True)
    grid = list(build_grid(args))
    if args.limit:
        grid = grid[:args.limit]
    grid = [c for c in grid if c not in done]
    t_start = time.time()
    for i, (m, k, n, s) in enumerate(grid):
        skips = {kn: skip_reason(kn, m, k, n, s, budget) for kn in kernels}
        cfg = BenchConfig(M=m, K=k, N=n, s=s,
                          kernels=[kn for kn in kernels if skips[kn] is None],
                          correctness=(args.correctness
                                       and m * n <= args.correctness_limit),
                          prelu=args.prelu, min_seconds=args.min_seconds,
                          repeats=max(1, args.repeats), device=args.device,
                          timer="cuda_events" if dev.type == "cuda"
                          else "wall")
        print(f"[{i + 1}/{len(grid)}] M={m} K={k} N={n} s={s} "
              f"(elapsed {time.time() - t_start:.0f}s)", flush=True)
        try:
            results = run_config(cfg, verbose=True)
        except Exception as e:  # record the config's failure, keep sweeping
            records.append({"test_case": {"M": m, "K": k, "N": n, "s": s},
                            "error": f"{type(e).__name__}: {e}"})
        else:
            rec = to_reference_json(cfg, results)
            for kn, why in skips.items():
                if why is not None:
                    print(f"  {kn:28s} {why}", flush=True)
                    rec["results"][kn] = {"error": why}
            records.append(rec)
        write_json(args.output, records)
    print(f"wrote {len(records)} records -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
