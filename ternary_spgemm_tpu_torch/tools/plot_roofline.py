"""Roofline plot — counterpart of the repository's
``tools/plot_roofline.py`` (``plots/plot_roofline.py`` of the reference):
useful-adds GFLOP/s against operational intensity, log-log, under the
card's roof. Writes a PNG with matplotlib's ``Agg`` backend; needs no
card.

The roof's defaults are the H100 SXM's constants that the port's bounds
use: ``beta`` = 3,350 GB/s, its memory rate
(``bench.instrument.ADVERTISED_HBM_GBPS``, NVIDIA's data sheet), and
``pi`` = 1,979,000 GFLOP/s, its dense int8 tensor-core peak at 700 W
(``bench.instrument.INT8_OPS_PER_S``, the same data sheet): the fastest
rate the card computes at, so no kernel's useful adds pass it. ``--beta``
(a measured rate, ``bench.instrument.measure_hbm_bandwidth``) and ``--pi``
override them.

Usage: python -m ternary_spgemm_tpu_torch.tools.plot_roofline sweep.json
       [--output roofline.png] [--beta GB/s] [--pi GFLOP/s]
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

import numpy as np

from ternary_spgemm_tpu_torch.bench.instrument import (
    ADVERTISED_HBM_GBPS,
    INT8_OPS_PER_S,
)
from ternary_spgemm_tpu_torch.tools.plot_perf import pyplot, timed_results

BETA_GBPS = ADVERTISED_HBM_GBPS["H100 80GB HBM3"]
PI_GFLOPS = INT8_OPS_PER_S / 1e9


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.plot_roofline")
    p.add_argument("json_path")
    p.add_argument("--output", default="roofline.png")
    p.add_argument("--beta", type=float, default=BETA_GBPS,
                   help="memory bandwidth [GB/s] (default: the H100 SXM's)")
    p.add_argument("--pi", type=float, default=PI_GFLOPS,
                   help="compute ceiling [GFLOP/s] (default: the H100 "
                        "SXM's int8 tensor-core peak)")
    p.add_argument("--title", default="Ternary SpMM roofline (GPU)")
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.tools import check_out

    plt = pyplot()
    beta, pi = args.beta, args.pi
    series = defaultdict(list)
    for name, r in timed_results(args.json_path):
        series[name].append((r["operational_intensity"], r["performance"]))
    fig, ax = plt.subplots(figsize=(9, 6))
    oi = np.logspace(-3, 4, 200)
    ax.plot(oi, np.minimum(oi * beta, pi), "k-", lw=2, label="roofline")
    ridge = pi / beta
    ax.axvline(ridge, color="k", ls=":", alpha=0.5)
    ax.annotate(f"ridge {ridge:.2f} F/B", (ridge, pi), fontsize=8,
                xytext=(ridge * 1.2, pi * 0.5))
    for name in sorted(series):
        pts = series[name]
        ax.scatter([o for o, _ in pts], [v for _, v in pts], s=14, label=name)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("operational intensity [flops/byte]")
    ax.set_ylabel("performance [GFLOP/s useful adds]")
    ax.set_title(f"{args.title}  (beta={beta:.0f} GB/s, pi={pi:.0f} GFLOP/s)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(check_out(args.output), dpi=150)
    plt.close(fig)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
