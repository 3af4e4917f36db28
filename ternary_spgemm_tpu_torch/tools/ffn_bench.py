"""Gate and benchmark of the fused FFN blocks — counterpart of
``tools/ffn_bench.py``.

Holds :func:`~ternary_spgemm_tpu_torch.ops.fused_ffn.fused_bitplane_ffn`
(the PReLU FFN) and ``fused_bitplane_swiglu`` (the transformer's SwiGLU FFN)
against their unfused compositions through the registry's default dispatch
(the hand-written SpMM kernels on the card), at the JAX tool's blocks,
shapes and seeds (M = 32, s = 4; PReLU K -> N1 -> N2 in {1024 -> 4096 ->
1024, 2048 -> 4096 -> 2048}, seeds 11/12/13; SwiGLU d -> ff in {1024 ->
4096, 2048 -> 4096, 3200 -> 8640, 4096 -> 11008}, seeds 21-24, gammas
0.02/0.03/0.025): ``correct`` when the largest difference is below 1e-5 of
the output's scale. Then it times fused and unfused two ways, medians of
CUDA events around one replay of a captured CUDA graph (so that no host gap
between the ops lands in the time), with the L2 evicted before each
replay:

* single — one block (median of 3 estimates, as the JAX tool's);
* stacked marginal — ``(t(L=8) - t(L=2)) / 6`` over L blocks chained the
  way the JAX tool chains them (PReLU: y -> round, clip to +-512 -> next
  block; SwiGLU: y -> requantize -> next block).

Usage::

    python -m ternary_spgemm_tpu_torch.tools.ffn_bench [--out PATH]
        [--device cuda|cpu]

It prints a row per block and one JSON object ``{"device", "blocks"}``
whose rows have the JAX record's keys; a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import sys
import warnings

import torch

from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.formats import (
    TiledBitplane,
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.ops.fused_ffn import (
    fused_bitplane_ffn,
    fused_bitplane_swiglu,
    requantize_rows,
    true_div,
    unfused_reference_ffn,
    unfused_reference_swiglu,
)
from ternary_spgemm_tpu_torch.tools import emit, timer
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: the JAX tool's blocks (``tools/ffn_bench.py:52,107``)
PRELU_SHAPES = [(1024, 4096, 1024), (2048, 4096, 2048)]
SWIGLU_SHAPES = [(1024, 4096), (2048, 4096), (3200, 8640), (4096, 11008)]
M, S = 32, 4
SWIGLU_GAMMAS = dict(gamma_gate=0.02, gamma_up=0.03, gamma_down=0.025)


def _times(run, X, dev) -> dict:
    """single (median of 3 estimates, and their spread) and the stacked
    marginal of ``run(X, L)``, in µs, as the JAX tool times them. Fused and
    unfused alike are several ops (the unfused block a dozen), so on the
    card each is timed from a replayed CUDA graph: the host's gaps between
    the ops stay out of the time, as they stay out of JAX's compiled
    loop."""
    t1, t2, t8 = (timer(dev, graph=True)(run, X, aux=(L,), repeats=3)
                  for L in (1, 2, 8))
    return {"single_us": t1.seconds * 1e6,
            "single_spread": t1.seconds_spread,
            "marginal_us": (t8.seconds - t2.seconds) / 6 * 1e6}


def _row(block: dict, got, want, floor: float, fused, unfused, X,
         dev) -> dict:
    err = float((got - want).abs().max())
    rel = err / max(floor, float(want.abs().max()))
    row = dict(block, max_abs_err=err, rel_err=rel, correct=bool(rel < 1e-5))
    for name, run in (("fused", fused), ("unfused", unfused)):
        row[name] = _times(run, X, dev)
    return row


def prelu_block(K: int, N1: int, N2: int, dev) -> dict:
    f1 = TiledBitplane.from_dense(generate_ternary(K, N1, S, seed=11),
                                  device=dev)
    f2 = TiledBitplane.from_dense(generate_ternary(N1, N2, S, seed=12),
                                  device=dev)
    b1 = torch.from_numpy(generate_bias(N1)).to(dev)
    a1 = torch.from_numpy(generate_alpha(N1)).to(dev)
    b2 = torch.from_numpy(generate_bias(N2)).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=13)).to(dev)

    def chain(ffn):
        def run(cur, L):
            for _ in range(L):
                y = ffn(cur, f1, b1, a1, f2, b2)
                cur = torch.clamp(torch.round(y[:, :K]), -512.0, 512.0)
            return cur
        return run

    got = fused_bitplane_ffn(X, f1, b1, a1, f2, b2)
    want = unfused_reference_ffn(X, f1, b1, a1, f2, b2)
    return _row({"block": "prelu_ffn", "K": K, "N1": N1, "N2": N2}, got,
                want, 1.0, chain(fused_bitplane_ffn),
                chain(unfused_reference_ffn), X, dev)


def swiglu_block(d: int, ff: int, dev) -> dict:
    fg, fu, fd = (TiledBitplane.from_dense(generate_ternary(*kn, S, seed=sd),
                                           device=dev)
                  for kn, sd in (((d, ff), 21), ((d, ff), 22), ((ff, d), 23)))
    X = true_div(torch.from_numpy(generate_x(M, d, seed=24)).to(dev), 256.0)
    xq, sx = requantize_rows(X)

    def chain(ffn):
        def run(cur, L):
            for _ in range(L):
                q, sc = requantize_rows(cur)
                cur = ffn(q, sc, fg, fu, fd, **SWIGLU_GAMMAS)
            return cur
        return run

    got = fused_bitplane_swiglu(xq, sx, fg, fu, fd, **SWIGLU_GAMMAS)
    want = unfused_reference_swiglu(xq, sx, fg, fu, fd, **SWIGLU_GAMMAS)
    return _row({"block": "swiglu", "d": d, "ff": ff}, got, want, 1e-9,
                chain(fused_bitplane_swiglu),
                chain(unfused_reference_swiglu), X, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.ffn_bench")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"device": device_name(dev), "blocks": []}
    with warnings.catch_warnings():
        # default dispatch over TiledBitplane is the integer-activation
        # kernel and warns that non-integer X would be rounded; every X
        # here is integer-valued
        warnings.simplefilter("ignore", UserWarning)
        rows = [prelu_block(*s, dev) for s in PRELU_SHAPES]
        rows += [swiglu_block(*s, dev) for s in SWIGLU_SHAPES]
    for row in rows:
        what = (f"prelu_ffn {row['K']}->{row['N1']}->{row['N2']}"
                if row["block"] == "prelu_ffn"
                else f"swiglu {row['d']}->{row['ff']}->{row['d']}")
        print(f"{what}: max_abs_err {row['max_abs_err']:.3g} (rel "
              f"{row['rel_err']:.2e}) correct={row['correct']}; fused single "
              f"{row['fused']['single_us']:.2f} us, marginal "
              f"{row['fused']['marginal_us']:.2f} us; unfused single "
              f"{row['unfused']['single_us']:.2f} us, marginal "
              f"{row['unfused']['marginal_us']:.2f} us [{out['device']}]",
              flush=True)
        out["blocks"].append(row)
    emit(out, args.out)
    return 0 if all(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
