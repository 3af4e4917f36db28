"""Scrub physically impossible measurements from a sweep artifact —
counterpart of the repository's ``tools/sweep_sanitize.py``, with its
thresholds.

A record is scrubbed when any kernel result has ``seconds`` below the hard
floor (default 100 ns: no config of the canonical grid is remotely that
fast) or ``roofline_fraction`` above the cutoff (default 1.05: above the
memory roofline is a broken measurement, not a fast kernel). Documented
skips and failures (results with ``error``) stay as they are. The file is
rewritten without the scrubbed records, so that ``tools.sweep --resume``
measures exactly those configs again::

    python -m ternary_spgemm_tpu_torch.tools.sweep_sanitize sweep.json
    python -m ternary_spgemm_tpu_torch.tools.sweep --output sweep.json --resume
"""

from __future__ import annotations

import argparse
import json
import sys


def scan(records, *, min_seconds: float, max_roofline: float):
    """Partition records into (kept, [(scrubbed record, its reasons)])."""
    kept, scrubbed = [], []
    for rec in records:
        reasons = []
        for name, res in rec.get("results", {}).items():
            if not isinstance(res, dict) or "error" in res:
                continue
            sec = res.get("seconds")
            rf = res.get("roofline_fraction")
            if sec is not None and sec < min_seconds:
                reasons.append(f"{name}: seconds={sec:.3g} < {min_seconds:g}")
            elif rf is not None and rf > max_roofline:
                reasons.append(f"{name}: roofline_fraction={rf:.3g} > "
                               f"{max_roofline:g}")
        if reasons:
            scrubbed.append((rec, reasons))
        else:
            kept.append(rec)
    return kept, scrubbed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.sweep_sanitize")
    p.add_argument("artifact")
    p.add_argument("--min-seconds", type=float, default=1e-7,
                   help="hard physical floor for a per-invocation time")
    p.add_argument("--max-roofline", type=float, default=1.05,
                   help="measurements above the memory roofline are broken")
    p.add_argument("--dry-run", action="store_true",
                   help="report what would be scrubbed without rewriting")
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.tools import write_json

    with open(args.artifact) as f:
        records = json.load(f)
    kept, scrubbed = scan(records, min_seconds=args.min_seconds,
                          max_roofline=args.max_roofline)
    for rec, reasons in scrubbed:
        tc = rec.get("test_case", {})
        print(f"scrub M={tc.get('M')} K={tc.get('K')} N={tc.get('N')} "
              f"s={tc.get('s')}: " + "; ".join(reasons))
    if not scrubbed:
        print(f"{args.artifact}: all {len(records)} records sane")
        return 0
    if args.dry_run:
        print(f"dry run: would scrub {len(scrubbed)}/{len(records)} records")
        return 0
    write_json(args.artifact, kept)
    print(f"scrubbed {len(scrubbed)}/{len(records)} records -> "
          f"{args.artifact}; refill with tools.sweep --resume")
    return 0


if __name__ == "__main__":
    sys.exit(main())
