"""Summarize a sweep artifact: per-kernel win counts, the flagship's
speedup over BaseTCSC, median roofline fractions — counterpart of the
repository's ``tools/grid_summary.py``, whose JSON it prints for the same
records.

Kernels are read by either registry's names: the approximate and the
restricted-domain kernels are the JAX tool's and their counterparts here,
and the flagship is ``PallasTiledBitplane_i8`` or its counterpart
``CudaTiledBitplane_i8``.

Usage: python -m ternary_spgemm_tpu_torch.tools.grid_summary sweep.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from ternary_spgemm_tpu_torch.ops.api import REFERENCE_KERNELS

#: the JAX tool's approximate and restricted-domain (x_absmax 127) kernels
JAX_APPROX = ("DenseMXU_bf16", "PallasDense_bf16", "PallasTiledBitplane_bf16")
JAX_RESTRICTED = ("DenseMXU_x8", "PallasTiledDense_x8",
                  "PallasTiledBitplane_x8")
APPROX = set(JAX_APPROX) | {REFERENCE_KERNELS[n] for n in JAX_APPROX}
RESTRICTED = set(JAX_RESTRICTED) | {REFERENCE_KERNELS[n]
                                    for n in JAX_RESTRICTED}
FLAGSHIPS = ("PallasTiledBitplane_i8",
             REFERENCE_KERNELS["PallasTiledBitplane_i8"])


def summarize(records) -> dict:
    """The summary the JAX tool prints for ``records``."""
    wins, wins_exact = {}, {}
    base_speedups, missing_base = [], []
    base_rows = 0
    per_kernel_roofline = {}
    for rec in records:
        res = rec.get("results", {})
        timed = {k: v for k, v in res.items()
                 if isinstance(v, dict) and v.get("seconds")}
        if not timed:
            continue
        best = min(timed, key=lambda k: timed[k]["seconds"])
        wins[best] = wins.get(best, 0) + 1
        exact = {k: v for k, v in timed.items()
                 if k not in APPROX and k not in RESTRICTED}
        if exact:
            be = min(exact, key=lambda k: exact[k]["seconds"])
            wins_exact[be] = wins_exact.get(be, 0) + 1
        b = res.get("BaseTCSC")
        if isinstance(b, dict) and b.get("seconds"):
            base_rows += 1
            flag = next((res[f] for f in FLAGSHIPS if f in res), None)
            if isinstance(flag, dict) and flag.get("seconds"):
                base_speedups.append(b["seconds"] / flag["seconds"])
        else:
            missing_base.append(rec.get("test_case"))
        for k, v in timed.items():
            fr = v.get("own_roofline_fraction", v.get("roofline_fraction"))
            if fr is not None:
                per_kernel_roofline.setdefault(k, []).append(fr)
    return {
        "records": len(records),
        "basetcsc_rows_with_seconds": base_rows,
        "basetcsc_missing": missing_base[:8],
        "overall_winner_counts": dict(
            sorted(wins.items(), key=lambda kv: -kv[1])),
        "exact_winner_counts": dict(
            sorted(wins_exact.items(), key=lambda kv: -kv[1])),
        "flagship_speedup_vs_basetcsc": {
            "n": len(base_speedups),
            "median": (statistics.median(base_speedups)
                       if base_speedups else None),
            "max": max(base_speedups) if base_speedups else None,
            "min": min(base_speedups) if base_speedups else None,
        },
        "median_roofline_fraction_per_kernel": {
            k: round(statistics.median(v), 4)
            for k, v in sorted(per_kernel_roofline.items())},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.grid_summary")
    p.add_argument("artifact")
    args = p.parse_args(argv)
    with open(args.artifact) as f:
        print(json.dumps(summarize(json.load(f)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
