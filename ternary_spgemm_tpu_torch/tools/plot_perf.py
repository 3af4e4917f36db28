"""Performance plot — counterpart of the repository's
``tools/plot_perf.py`` (``plots/plot_perf.py`` of the reference): a metric
(default GFLOP/s of useful adds) against total input size (log x), one
line a kernel, from a sweep artifact (``tools.sweep``). Writes a PNG with
matplotlib's ``Agg`` backend; needs no card.

Usage: python -m ternary_spgemm_tpu_torch.tools.plot_perf sweep.json
       [--output performance.png] [--metric performance]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

LABELS = {"performance": "useful-adds GFLOP/s",
          "effective_gflops": "dense-equivalent GFLOP/s",
          "nnz_per_s": "nnz/s",
          "roofline_fraction": "fraction of the memory roofline"}


def timed_results(path: str):
    """``(kernel, result)`` for every measured result of a sweep
    artifact (documented skips and failures left out)."""
    with open(path) as f:
        records = json.load(f)
    for rec in records:
        for name, r in rec.get("results", {}).items():
            if isinstance(r, dict) and "error" not in r:
                yield name, r


def pyplot():
    """matplotlib's pyplot on the ``Agg`` backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.plot_perf")
    p.add_argument("json_path")
    p.add_argument("--output", default="performance.png")
    p.add_argument("--title", default="Ternary SpMM performance (GPU)")
    p.add_argument("--metric", default="performance", choices=sorted(LABELS))
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.tools import check_out

    plt = pyplot()
    series = defaultdict(list)
    for name, r in timed_results(args.json_path):
        if r.get(args.metric) is not None:
            series[name].append((r["total_input_size"], r[args.metric]))
    fig, ax = plt.subplots(figsize=(9, 5.5))
    for name in sorted(series):
        pts = sorted(series[name])
        ax.plot([b for b, _ in pts], [v for _, v in pts], marker="o",
                markersize=3, label=name)
    ax.set_xscale("log")
    ax.set_xlabel("total input size [bytes]")
    ax.set_ylabel(LABELS[args.metric])
    ax.set_title(args.title)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(check_out(args.output), dpi=150)
    plt.close(fig)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
