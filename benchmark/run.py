"""The benchmark of the PyTorch and CUDA port on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It builds the cell's BitNet LM on the card
from the seed, captures its generate loop, serves the cell's traffic for
the window (``serve.py``), checks what the timed replays served against
the plain reference, and prints one JSON line last on standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of a slice of the
window. The numbers compared, each beside its limit, are the last lines
on standard error and the last key of that line.

It exits with 1 and prints no result without a CUDA card (or with fewer
than the cell asks for), when the port is not this checkout's, or when
JAX or the JAX package has been loaded by the time the window has closed.
The port's kernel library is built in ``build/cuda/`` of the checkout;
only the first run there builds it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that may not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "ternary_spgemm_tpu", "tools")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))

    import torch

    from benchmark import serve

    cell = serve.Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    import ternary_spgemm_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        print(f"the port was loaded from {port.__file__}, not from this "
              f"checkout ({ROOT})", file=sys.stderr)
        return 1
    result = serve.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
