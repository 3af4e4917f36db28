"""Time the fused SwiGLU kernel's two branches at decode rows.

At each BitNet block shape d -> ff -> d (gate, up and down drawn at
density 1/2 from a seeded generator on the device, as ``chip_smoke.py``
phase 3 draws them) and each row count M, it runs the decode branch
(``ops.fused_ffn._swiglu_lanes``) and the tensor-core branch
(``_swiglu_mma``) once, holds their y, h and rmax bitwise equal, and
times each: the median of ``--repeats`` estimates, each the median of 15
CUDA-event launches with the L2 evicted before each (``bench.timing.
event_ms``). Beside them, ``bound_ms``: the larger of the bytes (the three
planes without their tile padding, f32 xq and y, sx) at 3.35 TB/s and the
operations (2 M nnz a product) at the int8 peak (``bench.instrument``).

Usage::

    python -m ternary_spgemm_tpu_torch.tools.swiglu_bench [--rows 1 4 8]
        [--shapes 4096x11008 3200x8640] [--repeats 3] [--device cuda|cpu]
        [--out PATH]

It uses nothing but what every checkout of the port since the SwiGLU's
two branches has, so the same file times another checkout's kernels (the
parent of a change, unpacked beside it) when that checkout comes first on
the path::

    PYTHONPATH=path/to/checkout python path/to/swiglu_bench.py ...

``--device cpu`` runs the plain version alone, on the host clock (a CPU
number, never a device one). Prints a row per (shape, M) and one JSON
object ``{"device", "card", "rows"}``; a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ternary_spgemm_tpu_torch.bench.instrument import bound, spmm_ops, weight_bytes
from ternary_spgemm_tpu_torch.formats import TiledBitplane
from ternary_spgemm_tpu_torch.models.serving import random_ternary
from ternary_spgemm_tpu_torch.ops import fused_ffn
from ternary_spgemm_tpu_torch.tools import card_line, emit
from ternary_spgemm_tpu_torch.utils.device import resolve_device

GAMMAS = dict(gamma_gate=0.03, gamma_up=0.03, gamma_down=0.03)


def _ms(fn, dev, flush, repeats: int) -> tuple:
    """(median, spread) of ``repeats`` estimates of ``fn()``'s ms."""
    if dev.type == "cuda":
        from ternary_spgemm_tpu_torch.bench.timing import event_ms
        est = [event_ms(fn, flush=flush) for _ in range(repeats)]
    else:
        est = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            est.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(est)
    return med, (max(est) - min(est)) / med if med > 0 else 0.0


def bench_shape(d: int, ff: int, rows, dev, flush, repeats: int) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(d + ff)
    fg, fu, fd = (TiledBitplane.from_dense(random_ternary(K, N, 2, gen, dev))
                  for K, N in ((d, ff), (d, ff), (ff, d)))
    out = []
    for M in rows:
        x = torch.randn((M, d), generator=gen, device=dev)
        xq, sx = fused_ffn.requantize_rows(x)
        row = {"d": d, "ff": ff, "M": M}
        if dev.type == "cuda":
            lanes = fused_ffn._swiglu_lanes(xq, sx, fg, fu, fd, **GAMMAS)
            mma = fused_ffn._swiglu_mma(xq, sx, fg, fu, fd, **GAMMAS)
            torch.cuda.synchronize()
            row["bitwise"] = all(torch.equal(a, b) for a, b in zip(lanes, mma))
            for name, fn in (("decode", fused_ffn._swiglu_lanes),
                             ("mma", fused_ffn._swiglu_mma)):
                row[f"{name}_ms"], row[f"{name}_spread"] = _ms(
                    lambda: fn(xq, sx, fg, fu, fd, **GAMMAS), dev, flush,
                    repeats)
        else:
            row["plain_ms"], row["plain_spread"] = _ms(
                lambda: fused_ffn.swiglu_plain(xq, sx, fg, fu, fd, **GAMMAS),
                dev, flush, repeats)
        row["bound_ms"], row["bound_by"] = bound(
            sum(weight_bytes(f) for f in (fg, fu, fd)) + 4 * (2 * M * d + M),
            sum(spmm_ops(M, f) for f in (fg, fu, fd)))
        print("swiglu_bench " + json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, nargs="+", default=[1, 4, 8])
    p.add_argument("--shapes", nargs="+", default=["4096x11008", "3200x8640"],
                   help="d x ff of each block")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    flush = (torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
             if dev.type == "cuda" else None)
    rows = []
    for shape in args.shapes:
        d, ff = (int(v) for v in shape.split("x"))
        rows += bench_shape(d, ff, args.rows, dev, flush, args.repeats)
    emit({"device": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
          "card": card_line(dev), "rows": rows}, args.out)
    return 0 if all(r.get("bitwise", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
