"""Decode-shaped transformer-block A/B of the serving fast paths, with
error bars — counterpart of the repository's ``tools/fused_block_bench.py``.

Times the BitNet-7B (or 3B) ``ExportedTransformerBlock`` at the decode
shape (B = 1, one token against a KV cache of T + 8 positions, attention
live) in four configurations: no fast paths (``fixed``), the fused SwiGLU
FFN, the merged QKV, and both; each ``--repeats`` independent estimates
from a replayed CUDA graph (``bench.timing.time_cuda_graph``; the host
clock on the CPU) with their spread, (max - min) / median. Then the
measured flag picker (``autotune_serving_flags``) on the same builder, and
whether its pick lies within the spread of the best variant.

The block is W1.58-A8 over TiledBitplane with gamma 0.03 and zero biases,
its weights from the port's seeded generator
(``formats.generate.generate_ternary``, the JAX package's; seeds ``seed +
1`` .. ``seed + 7`` for wq, wk, wv, wo, w_gate, w_up, w_down), generated
once and shared by the variants.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.fused_block_bench
        [--preset bitnet7b] [--repeats 3] [--s 2] [--output PATH]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.formats import TiledBitplane, generate_ternary
from ternary_spgemm_tpu_torch.models.exported import ExportedBitLinear
from ternary_spgemm_tpu_torch.models.generate import (
    _block_decode,
    _fused_hooks,
    autotune_serving_flags,
    init_cache,
)
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerConfig,
    ExportedTransformerBlock,
    MergedQKV,
)
from ternary_spgemm_tpu_torch.tools import emit, timer
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: the JAX tool's presets (``tools/fused_block_bench.py:30-34``)
PRESETS = {
    "test": dict(d_model=64, n_heads=4, d_ff=128, T=16),
    "bitnet3b": dict(d_model=3200, n_heads=32, d_ff=8640, T=512),
    "bitnet7b": dict(d_model=4096, n_heads=32, d_ff=11008, T=512),
}
GAMMA = 0.03
#: the variants by name: (fused_ffn, fused_qkv), the JAX tool's names
VARIANTS = {"fixed": (False, False), "fused_ffn": (True, False),
            "fused_qkv": (False, True), "fused_ffn_qkv": (True, True)}


def block_weights(cfg: BitTransformerConfig, *, s: int = 2, seed: int = 0,
                  device="cpu") -> dict:
    """The block's seven ternary matrices (int8, on ``device``)."""
    d, ff = cfg.d_model, cfg.d_ff
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
              "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    return {n: torch.from_numpy(generate_ternary(K, N, s, seed=seed + i))
            .to(device) for i, (n, (K, N)) in enumerate(shapes.items(), 1)}


def build_block(cfg: BitTransformerConfig, *, s: int = 2, seed: int = 0,
                fused_ffn: bool = False, fused_qkv: bool = False,
                device="cuda", weights=None) -> ExportedTransformerBlock:
    """The JAX tool's ``build_block``: the decode block from the seeded
    weights (``weights``, :func:`block_weights`, when given), A8 over
    TiledBitplane without transposes, with the fast paths asked for."""
    dev = resolve_device(device)
    W = weights if weights is not None else block_weights(
        cfg, s=s, seed=seed, device=dev)
    linears = {n: ExportedBitLinear.from_dense(
        w, TiledBitplane, gamma=GAMMA, bias=torch.zeros(w.shape[1]),
        with_transpose=False, a8=True) for n, w in W.items()}
    qkv = None
    if fused_qkv:
        w3 = torch.cat([W["wq"], W["wk"], W["wv"]], dim=1)
        qkv = MergedQKV(TiledBitplane.from_dense(w3),
                        torch.full((w3.shape[1],), GAMMA),
                        torch.zeros(w3.shape[1]))
    return ExportedTransformerBlock(
        cfg, linears, torch.ones(cfg.d_model), torch.ones(cfg.d_model),
        fused_ffn=fused_ffn, qkv=qkv, a8=True)


def decode_fn(blk: ExportedTransformerBlock, cache: dict, pos: int):
    """``x (B, 1, d) -> y``: the block's decode step against ``cache`` at
    position ``pos``."""
    cfg = blk.cfg

    def fn(x):
        B = x.shape[0]
        lin = lambda n, z: blk.linears[n](z.reshape(B, -1))[:, None, :]
        ffn, qkv = _fused_hooks(blk, B, lambda z: (B, 1))
        return _block_decode(cfg.head_tuple, lin, blk.norm_attn,
                             blk.norm_ffn, x, cache, pos, ffn=ffn, qkv=qkv,
                             window=cfg.window)[0]
    return fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.fused_block_bench")
    p.add_argument("--preset", choices=sorted(PRESETS), default="bitnet7b")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--s", type=int, default=2)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    shape = PRESETS[args.preset]
    cfg = BitTransformerConfig(vocab=64, d_model=shape["d_model"],
                               n_heads=shape["n_heads"], d_ff=shape["d_ff"],
                               n_layers=1)
    B, T = 1, shape["T"]
    weights = block_weights(cfg, s=args.s, device=dev)
    cache = init_cache(cfg, B, T + 8, device=dev)[0]
    x1 = torch.zeros((B, 1, cfg.d_model), device=dev)
    time_fn = timer(dev, graph=True)
    out = {"preset": args.preset, "shape": shape, "s": args.s, "B": B,
           "device": device_name(dev),
           "protocol": f"{args.repeats} independent estimates per variant "
                       "(a replayed CUDA graph on the card); spread = "
                       "(max-min)/median",
           "variants": {}}
    build = lambda ffn, qkv: build_block(cfg, s=args.s, fused_ffn=ffn,
                                         fused_qkv=qkv, device=dev,
                                         weights=weights)
    with torch.no_grad():
        for name, (ffn, qkv) in VARIANTS.items():
            r = time_fn(lambda x, fn=decode_fn(build(ffn, qkv), cache, T):
                        fn(x), x1, repeats=args.repeats)
            out["variants"][name] = {
                "us": r.seconds * 1e6, "seconds_spread": r.seconds_spread,
                "n_estimates": r.n_estimates}
            print(f"{name}: {r.seconds * 1e6:.2f} us (spread "
                  f"{r.seconds_spread:.1%}, n={r.n_estimates})", flush=True)
        # the measured flag picker must land on (one of) the best variants
        picks = autotune_serving_flags(cfg, None, None, rows=B,
                                       cache_len=T + 8, builder=build,
                                       verbose=True, device=dev)
    auto_name = {flags: n for n, flags in VARIANTS.items()}[
        (picks["fused_ffn"], picks["fused_qkv"])]
    out["auto_picks"] = picks
    out["auto_equivalent_variant"] = auto_name
    v = out["variants"]
    best_us = min(r["us"] for r in v.values())
    worst_spread = max(r["seconds_spread"] for r in v.values())
    out["auto_within_spread_of_best"] = bool(
        v[auto_name]["us"] <= best_us * (1 + 2 * worst_spread))
    print(f"auto picked {auto_name} ({v[auto_name]['us']:.2f} us; best "
          f"variant {best_us:.2f})", flush=True)
    fixed, both = v["fixed"], v["fused_ffn_qkv"]
    out["end_to_end_win_pct"] = round(100 * (1 - both["us"] / fixed["us"]), 2)
    out["win_resolvable"] = bool(
        fixed["us"] - both["us"] > fixed["us"] * fixed["seconds_spread"]
        + both["us"] * both["seconds_spread"])
    emit(out, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
