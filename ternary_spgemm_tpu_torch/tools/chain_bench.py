"""Layer-chain study: the per-layer cost of ``CudaTiledBitplane_i8`` inside
a stack, as the marginal slope over depth — counterpart of the
repository's ``tools/chain_bench.py``.

At the north-star layer (M=32, K=1024, N=4096, s=4), each layer with its
own weights (``generate_ternary(K, N, s, seed=100 + i)``), two stacks at
depths 1, 2, 4, 8 and 16:

* ``independent`` — L layer calls on the same X, the outputs summed;
* ``chained`` — layer i+1 takes ``clamp(Y_i[:, :K], -512, 512)``
  (``bench.stacked.make_chain``, the stacked marginal's chain).

On the card each stack at each depth is captured as one CUDA graph and a
replay is timed (``bench.timing.time_cuda_graph``, as ``bench/stacked.py``
times its chains): the counterpart of JAX timing one compiled L-layer
program; the host's gaps between the ops stay out. The variants are
interleaved inside each depth, so a slow stretch of the card biases both.
``--device cpu`` times the plain versions on the host clock.

Reported per variant: each depth's time, the least-squares slope of time
against L (the marginal cost of a layer; the intercept holds every fixed
cost), the pair slopes, and the slope as a fraction of the layer's bound
(``bench.instrument.spmm_bound``, the bound ``chip_smoke.py`` gives each
kernel: the weights at 2 bits, f32 X and Y and the bias at 3.35 TB/s
against 2*M*nnz operations at the int8 peak). The JAX tool's ``tns``
tile-rule axis is not ported: the CUDA kernels take no tile argument.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.chain_bench [--output PATH]
        [--depths 1 2 4 8 16] [--repeats 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

M, K, N, S = 32, 1024, 4096, 4
DEPTHS = [1, 2, 4, 8, 16]
KERNEL = "CudaTiledBitplane_i8"


def make_independent(spec, fmts, biases):
    """L calls of ``spec`` on the same X, one a layer, outputs summed."""
    def fn(x):
        acc = None
        for fmt, b in zip(fmts, biases):
            y = spec.fn(x, fmt, b, None)
            acc = y if acc is None else acc + y
        return acc
    return fn


def fit(rows) -> dict:
    """The least-squares line of ``seconds`` against ``L`` over ``rows``
    (``[{"L", "seconds"}, ...]`` in depth order): its slope (the marginal
    seconds a layer), intercept and the pair slopes between neighbouring
    depths (the deepest is the stack's asymptote)."""
    Ls = np.array([r["L"] for r in rows], np.float64)
    ts = np.array([r["seconds"] for r in rows], np.float64)
    A = np.stack([Ls, np.ones_like(Ls)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, ts, rcond=None)
    pairs = [(rows[i + 1]["seconds"] - rows[i]["seconds"])
             / (rows[i + 1]["L"] - rows[i]["L"]) for i in range(len(rows) - 1)]
    return {"marginal_seconds_lsq": float(slope),
            "intercept_seconds": float(intercept), "pair_slopes": pairs,
            "deep_marginal_seconds": pairs[-1] if pairs else None}


def build(dev, depth: int):
    """The stack's inputs on ``dev``: (spec, containers, biases, X)."""
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.ops import all_kernels

    spec = all_kernels()[KERNEL]
    fmts = [TiledBitplane.from_dense(generate_ternary(K, N, S, seed=100 + i),
                                     device=dev) for i in range(depth)]
    biases = [torch.from_numpy(generate_bias(N)).to(dev)
              for _ in range(depth)]
    X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)
    return spec, fmts, biases, X


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.chain_bench")
    p.add_argument("--depths", type=int, nargs="+", default=DEPTHS)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.bench.instrument import spmm_bound
    from ternary_spgemm_tpu_torch.bench.stacked import make_chain
    from ternary_spgemm_tpu_torch.bench.timing import (
        time_cuda_graph, time_wall)
    from ternary_spgemm_tpu_torch.tools import card_line, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    depths = sorted(args.depths)
    spec, fmts, biases, X = build(dev, max(depths))
    makers = {"independent": make_independent,
              "chained": lambda sp, f, b: make_chain(sp, f, b, K)}
    timer = time_cuda_graph if dev.type == "cuda" else time_wall
    rows = {v: [] for v in makers}
    for L in depths:
        for name, maker in makers.items():
            t = timer(maker(spec, fmts[:L], biases[:L]), X,
                      repeats=args.repeats)
            rows[name].append({"L": L, "seconds": t.seconds,
                               "seconds_spread": t.seconds_spread,
                               "runs": t.runs})
            print(f"{name} L={L}: {t.seconds * 1e6:.3f} us (spread "
                  f"{t.seconds_spread:.1%})", flush=True)
    bound_ms, bound_by = spmm_bound(M, fmts[0])
    out = {"config": {"M": M, "K": K, "N": N, "s": S}, "kernel": KERNEL,
           "depths": depths, "device": device_name(args.device),
           "card": card_line(dev),
           "timer": timer.__name__,
           "bound_seconds": bound_ms / 1e3, "bound_by": bound_by,
           "variants": {}}
    for name, vrows in rows.items():
        v = {"rows": vrows, **fit(vrows)}
        if dev.type == "cuda":   # a host-clock slope is no device time
            for key, slope in (("lsq", v["marginal_seconds_lsq"]),
                               ("deep", v["deep_marginal_seconds"])):
                if slope and slope > 0:
                    v[f"bound_fraction_{key}"] = out["bound_seconds"] / slope
        out["variants"][name] = v
    if args.output:
        write_json(args.output, out)
    print(json.dumps({"chain_bench": {
        name: {"marginal_us": v["marginal_seconds_lsq"] * 1e6,
               "deep_marginal_us": (v["deep_marginal_seconds"] or 0) * 1e6,
               "bound_fraction": v.get("bound_fraction_lsq")}
        for name, v in out["variants"].items()},
        "bound_us": out["bound_seconds"] * 1e6, "device": out["device"],
        "card": out["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
