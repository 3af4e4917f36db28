"""The end-to-end benchmark pipeline — counterpart of the repository's
``tools/run_all.sh`` (the reference's ``plots/plots.sh``).

In order, each step in this process, stopping at the first that fails
(``set -e``), its exit code this tool's:

1. ``chipgate`` at its default multi-tile shape with the PReLU epilogue,
   then at the hostile 333x2048x2560 s=8 (odd M, N = 2560: a part tile);
2. ``bytes_validation``;
3. ``sweep --preset bitnet`` over the counterparts of the JAX pipeline's
   four kernels (``--limit`` passed through);
4. the three plots of that sweep (and of ``canonical_sweep.json`` where
   ``--out`` holds one) — only where matplotlib is installed: where it is
   not (the card's machine), the step prints that it was skipped and why,
   and the pipeline goes on;
5. the headline, its records in ``headline.json``.

Everything is written under ``--out`` (refused under ``bench_artifacts/``,
the JAX tools' TPU records).

Usage::

    python -m ternary_spgemm_tpu_torch.tools.run_all --out DIR
        [--limit N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

#: the steps' arguments, each tool's own (the device and the paths are
#: added by :func:`steps`)
CHIPGATE = [["--prelu"],
            ["--M", "333", "--K", "2048", "--N", "2560", "--s", "8",
             "--prelu"]]
#: the JAX pipeline's sweep kernels by counterpart (PallasTiledDense_i8,
#: PallasTiledBitplane_i8, PallasDense_bf16, PallasDense)
SWEEP_KERNELS = ("CudaTiledDense_i8,CudaTiledBitplane_i8,CudaDense_bf16,"
                 "CudaDense")
SWEEP = ["--preset", "bitnet", "--kernels", SWEEP_KERNELS]
PLOT_BASELINE = "CudaDense"
HEADLINE = []


def steps(out: str, device: str, limit=None) -> list:
    """(label, main, argv) of every step, in order."""
    from ternary_spgemm_tpu_torch.bench import headline
    from ternary_spgemm_tpu_torch.tools import (
        bytes_validation, chipgate, plot_perf, plot_roofline, plot_speedup,
        sweep)

    dev = ["--device", device]
    path = lambda name: os.path.join(out, name)
    todo = [("chipgate", chipgate.main,
             CHIPGATE[0] + ["--output", path("chipgate.json")] + dev),
            ("chipgate_hostile", chipgate.main,
             CHIPGATE[1] + ["--output", path("chipgate_hostile.json")] + dev),
            ("bytes_validation", bytes_validation.main,
             ["--output", path("bytes_validation.json")] + dev),
            ("sweep", sweep.main,
             SWEEP + ["--output", path("bitnet_sweep.json")] + dev
             + (["--limit", str(limit)] if limit else []))]
    sweeps = [("bitnet_sweep.json", "", PLOT_BASELINE)]
    if os.path.exists(path("canonical_sweep.json")):
        sweeps.append(("canonical_sweep.json", "canonical_", "BaseTCSC"))
    for src, prefix, base in sweeps:
        todo += [(f"plot_perf {src}", plot_perf.main,
                  [path(src), "--output", path(prefix + "performance.png")]),
                 (f"plot_roofline {src}", plot_roofline.main,
                  [path(src), "--output", path(prefix + "roofline.png")]),
                 (f"plot_speedup {src}", plot_speedup.main,
                  [path(src), "--baseline", base, "--output",
                   path(prefix + "speedup.png")])]
    todo.append(("headline", headline.main,
                 HEADLINE + ["--json-out", path("headline.json")] + dev))
    return todo


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.run_all")
    p.add_argument("--out", required=True,
                   help="directory for every record and plot")
    p.add_argument("--limit", type=int, default=None,
                   help="the sweep's --limit (smoke runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.tools import check_out
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    os.makedirs(check_out(args.out), exist_ok=True)
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    for label, step, argv_ in steps(args.out, args.device, args.limit):
        if label.startswith("plot") and not have_mpl:
            print(f"run_all: {label} skipped: matplotlib is not installed "
                  "here", flush=True)
            continue
        print(f"run_all: {label}", flush=True)
        rc = step(argv_)
        if rc:
            print(f"run_all: {label} exited {rc}; stopping", flush=True)
            return rc
    print(f"run_all: artifacts in {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
