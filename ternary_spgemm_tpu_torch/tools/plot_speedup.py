"""Speedup / percent-of-peak report — counterpart of the repository's
``tools/plot_speedup.py``: each kernel's speedup over the baseline kernel
of its config (default ``BaseTCSC``, the reference's convention,
``main.cpp:257-263``) against total input size, and a printed table of
each kernel's largest share of the memory roofline. Writes a PNG with
matplotlib's ``Agg`` backend; needs no card.

Usage: python -m ternary_spgemm_tpu_torch.tools.plot_speedup sweep.json
       [--output speedup.png] [--baseline BaseTCSC]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from ternary_spgemm_tpu_torch.tools.plot_perf import pyplot


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.plot_speedup")
    p.add_argument("json_path")
    p.add_argument("--output", default="speedup.png")
    p.add_argument("--baseline", default="BaseTCSC")
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.tools import check_out

    plt = pyplot()
    series = defaultdict(list)
    peak = defaultdict(float)
    with open(args.json_path) as f:
        records = json.load(f)
    for rec in records:
        res = rec.get("results", {})
        base = res.get(args.baseline)
        for name, r in res.items():
            if not isinstance(r, dict) or "error" in r:
                continue
            # the CPU's records carry no roofline share (None)
            peak[name] = max(peak[name], r.get("roofline_fraction") or 0.0)
            if base and "seconds" in base and name != args.baseline:
                series[name].append(
                    (r["total_input_size"], base["seconds"] / r["seconds"]))

    print(f"{'kernel':28s} max % of the memory roofline")
    for name in sorted(peak, key=peak.get, reverse=True):
        print(f"{name:28s} {peak[name]:6.1%}")
    if series:
        fig, ax = plt.subplots(figsize=(9, 5.5))
        for name in sorted(series):
            pts = sorted(series[name])
            ax.plot([b for b, _ in pts], [v for _, v in pts], marker="o",
                    markersize=3, label=name)
        ax.axhline(1.0, color="k", ls=":", alpha=0.5)
        ax.set_xscale("log")
        ax.set_xlabel("total input size [bytes]")
        ax.set_ylabel(f"speedup vs {args.baseline}")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(check_out(args.output), dpi=150)
        plt.close(fig)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
