"""The nibble pair against the bit planes, and the bit planes' K-block size
— counterpart of the repository's ``tools/kernel_v4b_study.py``.

(a) ``CudaTiledNibblePair_i8`` (4 bits a weight, on ``csrc/
    dense_mma.cuh``'s bf16 tile) against ``CudaTiledBitplane_i8`` (2 bits,
    the decode body at up to 32 rows, the int8 tensor cores above) at the
    north star, 32x4096x4096, 32x11008x11008 and 512x4096x4096 (s=4), the
    nibble pair gated bitwise against the bit planes' output.
(b) The north star through ``CudaTiledBitplane_i8`` over containers packed
    at ``tkb`` 128 (the default at K = 1024: one K-block), 64 and 32 (two
    and four K-blocks), each gated bitwise against the default's output.

Times from ``tools.timer`` (CUDA events with the L2 evicted before each
launch on the card; the host clock with ``--device cpu``), ``--repeats``
estimates each. The JAX study's ``tns`` variants (an N-split of the one
Pallas grid step) are not ported: the CUDA kernels take no tile argument.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.kernel_v4b_study
        [--output PATH] [--repeats 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

NIBBLE_SHAPES = [(32, 1024, 4096, 4), (32, 4096, 4096, 4),
                 (32, 11008, 11008, 4), (512, 4096, 4096, 4)]
NS = (32, 1024, 4096, 4)
TKB = (128, 64, 32)


def measure(timer, spec, fmt, M: int, K: int, dev, repeats: int,
            ref=None):
    """``spec`` on ``fmt`` at M rows of the seeded X: (its output, a row
    with its time and, against ``ref``, its max |diff| and whether it is
    bitwise)."""
    from ternary_spgemm_tpu_torch.formats import generate_bias, generate_x

    X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)
    b = torch.from_numpy(generate_bias(fmt.N)).to(dev)
    y = spec.fn(X, fmt, b, None)
    row = {}
    if ref is not None:
        row["max_err_vs_ref"] = float((y - ref).abs().max())
        row["ok"] = bool(torch.equal(y, ref))
    t = timer(lambda x: spec.fn(x, fmt, b, None), X, repeats=repeats)
    row.update(us=t.seconds * 1e6, spread=t.seconds_spread,
               n_estimates=t.n_estimates)
    return y, row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.kernel_v4b_study")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, TiledNibblePair, generate_ternary)
    from ternary_spgemm_tpu_torch.ops import all_kernels
    from ternary_spgemm_tpu_torch.tools import card_line, timer, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    time_fn = timer(dev)
    bitplane = all_kernels()["CudaTiledBitplane_i8"]
    nibpair = all_kernels()["CudaTiledNibblePair_i8"]
    result = {"device": device_name(args.device), "card": card_line(dev)}

    def record(label, row):
        result[label] = row
        print(f"{label}: {row['us']:.2f} us (spread {row['spread']:.1%}, "
              f"{row.get('max_err_vs_ref', 'ungated')})", flush=True)

    for M, K, N, s in NIBBLE_SHAPES:
        W = torch.from_numpy(generate_ternary(K, N, s, seed=0)).to(dev)
        tag = f"{M}x{K}x{N}"
        ref, row = measure(time_fn, bitplane, TiledBitplane.from_dense(W),
                           M, K, dev, args.repeats)
        record(f"nib/{tag}/bitplane2", row)
        _, row = measure(time_fn, nibpair, TiledNibblePair.from_dense(W),
                         M, K, dev, args.repeats, ref)
        record(f"nib/{tag}/nibpair4", row)
        del W, ref
    M, K, N, s = NS
    W = torch.from_numpy(generate_ternary(K, N, s, seed=0)).to(dev)
    ref = None
    for tkb in TKB:
        y, row = measure(time_fn, bitplane,
                         TiledBitplane.from_dense(W, tkb=tkb), M, K, dev,
                         args.repeats, ref)
        record(f"tkb/{tkb}", row)
        ref = y if ref is None else ref
    if args.output:
        write_json(args.output, result)
    gated = {k: v["ok"] for k, v in result.items()
             if isinstance(v, dict) and "ok" in v}
    ratio = {f"{M}x{K}x{N}": result[f"nib/{M}x{K}x{N}/nibpair4"]["us"]
             / result[f"nib/{M}x{K}x{N}/bitplane2"]["us"]
             for M, K, N, _ in NIBBLE_SHAPES}
    print(json.dumps({"kernel_v4b_study": {
        "nibpair_over_bitplane": ratio,
        "tkb_us": {t: result[f"tkb/{t}"]["us"] for t in TKB},
        "bitwise": all(gated.values())},
        "failed": [k for k, ok in gated.items() if not ok],
        "device": result["device"], "card": result["card"]}), flush=True)
    return 0 if all(gated.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
