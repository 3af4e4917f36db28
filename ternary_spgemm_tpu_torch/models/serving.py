"""The serving export at full width, built on the card — counterpart of
``tools/serving_bench.py``'s ``PRESETS`` and ``build_serving_lm``
(``:42-107`` there).

Weights are random ternary matrices of density 1/s drawn from an explicit
``torch.Generator`` on ``device`` and packed there: at 7B width the numpy
generator and packer would dominate a run. Each entry is +1 with
probability 1/(2s) and -1 with probability 1/(2s) (the JAX tool's native
generator fixes the per-row counts instead; the bytes per weight and the
kernels' work are the same). The export is the serving one: W1.58-A8
projections and no transposes, with the JAX tool's two fast paths as
options: the merged QKV (``fused_qkv``; the separate wq/wk/wv layers are
then not built, since the merged container replaces them) and the fused
SwiGLU FFN (``fused_ffn``, which the block takes where its contract
holds). The draws do not depend on the options: one seed gives the same
weights to every variant, the QKV drawn as one ``(d, d + 2*kv_width)``
matrix and split by columns where the projections stay separate.
"""

from __future__ import annotations

import dataclasses

import torch

from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.models.exported import ExportedBitLinear
from ternary_spgemm_tpu_torch.models.generate import ExportedTransformerLM
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerConfig,
    ExportedTransformerBlock,
    MergedQKV,
)
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: the JAX serving tool's presets (``tools/serving_bench.py:42-49``): the
#: model's widths, its prompt length ``T0`` and its new tokens ``n_new``
PRESETS = {
    "test": dict(d_model=64, n_heads=4, d_ff=128, n_layers=2, vocab=64,
                 T0=8, n_new=4),
    "bitnet3b": dict(d_model=3200, n_heads=32, d_ff=8640, n_layers=26,
                     vocab=32000, T0=512, n_new=64),
    "bitnet7b": dict(d_model=4096, n_heads=32, d_ff=11008, n_layers=32,
                     vocab=32000, T0=512, n_new=64),
}


def preset_config(name: str) -> BitTransformerConfig:
    """The model configuration of preset ``name`` (its serving lengths
    left out)."""
    fields = {f.name for f in dataclasses.fields(BitTransformerConfig)}
    return BitTransformerConfig(
        **{k: v for k, v in PRESETS[name].items() if k in fields})


#: serving-realistic absmean scale of the random exports
GAMMA = 0.03


def random_ternary(K: int, N: int, s: int, gen: torch.Generator,
                   device) -> torch.Tensor:
    """``(K, N)`` int8 in {-1, 0, +1} with density 1/s, signs balanced."""
    u = torch.rand((K, N), generator=gen, device=device)
    p = 1.0 / s
    return ((u < p / 2).to(torch.int8)
            - ((u >= p / 2) & (u < p)).to(torch.int8))


def build_serving_lm(cfg: BitTransformerConfig, *, s: int = 2, seed: int = 0,
                     device="cuda", head_dtype=None, fused_ffn: bool = True,
                     fused_qkv: bool = True,
                     n_kv_heads=None) -> ExportedTransformerLM:
    """A serving-export LM with random ternary weights of density 1/s, built
    on the card (raises without one) unless ``device="cpu"``;
    ``head_dtype=torch.bfloat16`` stores the tied embedding in bf16 (the
    JAX tool's ``--head-dtype``); ``fused_ffn`` / ``fused_qkv`` the JAX
    tool's fast paths (its ``--fast-paths``); ``n_kv_heads`` replaces
    ``cfg.n_kv_heads`` (its ``--kv-heads``; grouped-query attention)."""
    if n_kv_heads is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=n_kv_heads)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width
    w3 = d + 2 * kvw

    def lin_of(W):
        return ExportedBitLinear.from_dense(
            W.contiguous(), TiledBitplane, gamma=GAMMA,
            bias=torch.zeros(W.shape[1]), a8=True)

    def lin(K, N):
        return lin_of(random_ternary(K, N, s, gen, device))

    blocks = []
    for _ in range(cfg.n_layers):
        W3 = random_ternary(d, w3, s, gen, device)
        if fused_qkv:
            qkv = MergedQKV(TiledBitplane.from_dense(W3),
                            torch.full((w3,), GAMMA), torch.zeros(w3))
            linears = {}
        else:
            qkv = None
            linears = {"wq": lin_of(W3[:, :d]),
                       "wk": lin_of(W3[:, d:d + kvw]),
                       "wv": lin_of(W3[:, d + kvw:])}
        linears.update({"wo": lin(d, d), "w_gate": lin(d, ff),
                        "w_up": lin(d, ff), "w_down": lin(ff, d)})
        del W3
        blocks.append(ExportedTransformerBlock(
            cfg, linears, torch.ones(d), torch.ones(d), fused_ffn=fused_ffn,
            qkv=qkv, a8=True))
    embed = 0.02 * torch.randn((cfg.vocab, d), generator=gen, device=device)
    return ExportedTransformerLM(cfg, blocks, embed, torch.ones(d),
                                 head_dtype=head_dtype)
