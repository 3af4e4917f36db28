"""CLI mirroring the reference benchmark binary — counterpart of
``python -m ternary_spgemm_tpu``.

Reference usage (``readme.md:30-35``)::

    sudo ./sparseGEMM.out -M 32 -K 1024 -N 4096 -s 4 [-correctness]

Here::

    python -m ternary_spgemm_tpu_torch -M 32 -K 1024 -N 4096 -s 4 \\
        [-correctness] [-prelu] [--kernels a,b] [--device cuda|cpu]

Runs every kernel of the port's registry (or ``--kernels``) on the card,
gates each against the dense reference when ``-correctness`` is given
(``main.cpp:206-249``), then prints per-kernel timing, speedup vs BaseTCSC
(``main.cpp:257-263``) and the instrumented flops/OI quantities
(``main.cpp:264-271``). ``--device cpu`` runs the kernels' plain versions
(host-clock times; no roofline); ``--device cuda`` without a card raises.
Exits 1 if any kernel failed its correctness gate or raised; a kernel
whose container cannot be built at this K (the blocked ones need K a
multiple of their 512-row block) prints ERROR and does not fail the run,
as in ``python -m ternary_spgemm_tpu``.

The port's registry holds a counterpart of every kernel of the JAX
registry, which ``python -m ternary_spgemm_tpu`` sweeps; a run without
``--kernels`` says so on a ``#`` line after the header.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ternary_spgemm_tpu_torch")
    p.add_argument("-M", type=int, default=32)
    p.add_argument("-K", type=int, default=1024)
    p.add_argument("-N", type=int, default=4096)
    p.add_argument("-s", type=int, default=4)
    p.add_argument("-correctness", action="store_true")
    p.add_argument("-prelu", action="store_true")
    p.add_argument("--kernels", default=None, help="comma-separated subset")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import (
        BenchConfig, device_name, fmt_fraction, run_config)
    from ternary_spgemm_tpu_torch.ops import BASELINE_KERNEL_NAME

    cfg = BenchConfig(
        M=args.M, K=args.K, N=args.N, s=args.s, prelu=args.prelu,
        correctness=args.correctness, device=args.device,
        timer="cuda_events" if args.device == "cuda" else "wall",
        kernels=args.kernels.split(",") if args.kernels else None)
    results = run_config(cfg)
    print(f"M={args.M} K={args.K} N={args.N} s={args.s} "
          f"prelu={args.prelu} correctness={args.correctness} "
          f"device={device_name(args.device)}")
    if not args.kernels:
        print(f"# {len(results)} kernels, the port's registry: a "
              "counterpart of every kernel of the JAX registry")
    failed = False
    for r in results:
        if r.error:
            print(f"{r.name:28s} ERROR {r.error}")
            # a container that cannot be built at this K is reported, as
            # the JAX CLI reports it; a kernel that raised fails the run
            failed = failed or not r.unbuildable
            continue
        line = (f"{r.name:28s} {r.seconds * 1e6:10.2f} us   "
                f"{r.gflops:9.2f} GF/s   OI {r.operational_intensity:7.4f}   "
                f"roofline {fmt_fraction(r.roofline_fraction)}")
        if r.speedup is not None:
            line += f"   speedup vs {BASELINE_KERNEL_NAME} {r.speedup:7.2f}x"
        if args.correctness:
            line += f"   correct={r.correct}"
            failed = failed or not r.correct
        print(line)
    # hard-exit on a failure like the reference (main.cpp:216-247)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
