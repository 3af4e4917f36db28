"""Headline benchmark: the hand-written kernels at the reference's
north-star config — the port's counterpart of the repository's ``bench.py``.

Usage::

    python -m ternary_spgemm_tpu_torch.bench.headline [--all] [--correctness]
        [--json-out PATH] [--device cuda|cpu]

Prints the card's name on a ``#`` line, then ONE JSON line with the keys of
``bench.py`` (its stacked-marginal keys wait for ``bench/stacked.py``)::

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Config: M=32, K=1024, N=4096, s=4 (``compiler_testing/test.sh:8``).
Metric: useful-adds GFLOP/s of the best kernel that is exact on the full
+-512 activation domain, among ``bench.py``'s 19 default kernels, each by
its counterpart here (:data:`DEFAULT_KERNELS`: the hand-written counterparts
of its Pallas kernels and the torch-op DenseMXU formulations), the
competition of the JAX headline; a ``#`` line says so.
vs_baseline: the reference C++ code's best published
number at this config on its CPU — 2.31712e7 cycles for 33,685,504 useful
adds (``compiler_testing/compiler_results_cold_cache.txt:1-2``) at its
FREQUENCY=3.2 GHz (``cpp_impl/perf.cpp:30``) = 4.652 GFLOP/s.
"""

from __future__ import annotations

import argparse
import json
import sys

from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS, all_kernels

#: Reference best at the north-star config (see module docstring).
REFERENCE_GFLOPS = 33_685_504 / (2.31712e7 / 3.2e9) / 1e9

#: ``bench.py``'s default kernel set, by the JAX registry's names
#: (``bench.py:30-39``).
BENCH_PY_DEFAULT_KERNELS = [
    "PallasDense", "PallasDense_bf16", "PallasDense_i8",
    "PallasPacked2Bit", "PallasPacked2Bit_i8",
    "PallasPacked53", "PallasPacked53_i8",
    "PallasBlockPacked_i8",
    "PallasTiledDense_i8", "PallasTiledBlockPacked_i8",
    "PallasTiledBitplane_i8", "PallasEllDeposit_i8",
    "PallasTiledBitplane_x8", "PallasTiledDense_x8", "DenseMXU_x8",
    "PallasEllGather", "PallasTiledEllGather", "DenseMXU", "DenseMXU_bf16",
]
#: The kernels benchmarked by default: the port's counterparts of
#: ``bench.py``'s default set, so that the headline holds the same
#: competition (``--all`` sweeps the port's whole registry).
DEFAULT_KERNELS = [REFERENCE_KERNELS[n] for n in BENCH_PY_DEFAULT_KERNELS]


def _round(v, nd):
    return None if v is None else round(v, nd)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.bench.headline")
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--K", type=int, default=1024)
    p.add_argument("--N", type=int, default=4096)
    p.add_argument("--s", type=int, default=4)
    p.add_argument("--all", action="store_true",
                   help="benchmark the full kernel registry")
    p.add_argument("--kernels", default=None,
                   help="comma-separated kernel names (overrides --all)")
    p.add_argument("--correctness", action="store_true",
                   help="gate every kernel vs the dense reference first")
    p.add_argument("--prelu", action="store_true")
    p.add_argument("--repeats", type=int, default=3,
                   help="independent timing estimates per kernel (median "
                        "reported, spread emitted)")
    p.add_argument("--json-out", default=None,
                   help="also write the full per-kernel records (reference "
                        "sweep schema) to this path")
    p.add_argument("--measure-beta", action="store_true",
                   help="measure the card's memory bandwidth and use it as "
                        "the roofline beta instead of the advertised number")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench import (
        BenchConfig, dump_json, run_config, to_reference_json)
    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    if args.kernels:
        kernels = args.kernels.split(",")
    else:
        kernels = None if args.all else DEFAULT_KERNELS
    cfg = BenchConfig(
        M=args.M, K=args.K, N=args.N, s=args.s, prelu=args.prelu,
        correctness=args.correctness, kernels=kernels,
        repeats=max(1, args.repeats), device=args.device,
        timer="cuda_events" if args.device == "cuda" else "wall")
    print(f"# device: {device_name(args.device)}")
    if kernels is DEFAULT_KERNELS:
        print(f"# bench.py's {len(BENCH_PY_DEFAULT_KERNELS)} default "
              "kernels, each by its counterpart here")
    beta = None
    if args.measure_beta:
        from ternary_spgemm_tpu_torch.bench import measure_hbm_bandwidth
        beta = measure_hbm_bandwidth()
        print(f"# measured memory bandwidth: {beta / 1e9:.1f} GB/s")
    results = run_config(cfg, verbose=args.verbose, bandwidth=beta)
    ok = [r for r in results if not r.error]
    if args.json_out:
        dump_json([to_reference_json(cfg, results)], args.json_out)
    if not ok:
        print(json.dumps({"metric": "ternary_spgemm_useful_gflops",
                          "value": 0.0, "unit": "GFLOP/s", "vs_baseline": 0.0,
                          "error": "; ".join(f"{r.name}: {r.error}"
                                             for r in results)}))
        return 1
    registry = all_kernels()
    # Headline = best kernel that passes the exact tolerance gate on the
    # reference's full +-512 activation domain: not approximate, an
    # unrestricted domain or one of at least 512, and measured correct when
    # --correctness ran (bench.py:114-118).
    exact = [r for r in ok
             if not registry[r.name].approximate and r.correct is not False
             and (registry[r.name].x_absmax is None
                  or registry[r.name].x_absmax >= 512)]
    best = max(exact or ok, key=lambda r: r.gflops)
    best_any = max(ok, key=lambda r: r.gflops)
    print(json.dumps({
        "metric": "ternary_spgemm_useful_gflops",
        "value": round(best.gflops, 3),
        "unit": "GFLOP/s",
        "vs_baseline": round(best.gflops / REFERENCE_GFLOPS, 3),
        "best_kernel": best.name,
        "seconds": best.seconds,
        "seconds_spread": round(best.seconds_spread, 4),
        "n_estimates": best.n_estimates,
        "effective_gflops": round(best.effective_gflops, 3),
        "nnz_per_s": best.nnz_per_s,
        "roofline_fraction": _round(best.roofline_fraction, 4),
        "own_roofline_fraction": _round(best.own_roofline_fraction, 4),
        "best_any_kernel": best_any.name,
        "best_any_gflops": round(best_any.gflops, 3),
        "config": {"M": args.M, "K": args.K, "N": args.N, "s": args.s},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
