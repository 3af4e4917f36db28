"""The readings the limits of ``limits/<cell>.json`` are set from: the
program over many seeds, and the controls, on the card at the cell's own
size and load, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--lower <variant> ...]
        --control-seeds <n> [<n> ...] [--controls <path> ...]

Each seed is one run of ``serve.run`` with a short window, long enough to
finish the batches the cell checks. ``--seeds`` run the program as the
configuration states it (the lower reading is the largest ``logit_gap``
they give); on each of them the reference's lower-precision variants
named by ``--lower`` (``reference.LOWER``, all by default) are put in the
program's place over the same checked requests. ``--control-seeds`` run
each of the program's own lower-precision paths named by ``--controls``
(``serve.CONTROLS``, all by default). The upper reading is the smallest a
control gives. One JSON line a run. The benchmark's own runs never run a
control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--lower", nargs="*", default=None)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import reference, serve

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cell = serve.Cell(args.workload)
    lower = reference.LOWER if args.lower is None else tuple(args.lower)
    controls = serve.CONTROLS if args.controls is None else args.controls
    runs = ([(s, None, lower) for s in args.seeds]
            + [(s, c, ()) for c in controls for s in args.control_seeds])
    for seed, control, variants in runs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = serve.run(cell, seed, args.seconds, False, "cuda", t0,
                        control=control, lower=variants)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": control or "as configured",
            "logit_gap": out["checks"]["logit_gap"]["value"],
            "lower": out.get("controls", {}),
            "correct": out["correct"], "attempted": out["attempted"],
            "seconds": time.perf_counter() - t0,
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
