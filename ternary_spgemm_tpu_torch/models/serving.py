"""The serving export at full width, built on the card — counterpart of
``tools/serving_bench.py::build_serving_lm`` (``:42-107`` there).

Weights are random ternary matrices of density 1/s drawn from an explicit
``torch.Generator`` on ``device`` and packed there: at 7B width the numpy
generator and packer would dominate a run. Each entry is +1 with
probability 1/(2s) and -1 with probability 1/(2s) (the JAX tool's native
generator fixes the per-row counts instead; the bytes per weight and the
kernels' work are the same). The export is the serving one: W1.58-A8
projections, merged QKV, fused SwiGLU FFN, no transposes. The separate
wq/wk/wv layers are not built, since the merged container replaces them.
"""

from __future__ import annotations

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

#: the BitNet-7B widths of the JAX serving tool (``tools/serving_bench.py:47-48``)
PRESETS = {
    "bitnet7b": dict(d_model=4096, n_heads=32, d_ff=11008, n_layers=32,
                     vocab=32000),
}

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
                     device="cuda", head_dtype=None) -> ExportedTransformerLM:
    """A serving-export LM with random ternary weights of density 1/s, built
    on the card (raises without one) unless ``device="cpu"``;
    ``head_dtype=torch.bfloat16`` stores the tied embedding in bf16 (the
    JAX tool's ``--head-dtype``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width
    w3 = d + 2 * kvw

    def lin(K, N):
        return ExportedBitLinear.from_dense(
            random_ternary(K, N, s, gen, device), TiledBitplane, gamma=GAMMA,
            bias=torch.zeros(N), a8=True)

    blocks = []
    for _ in range(cfg.n_layers):
        qkv = MergedQKV(
            TiledBitplane.from_dense(random_ternary(d, w3, s, gen, device)),
            torch.full((w3,), GAMMA), torch.zeros(w3))
        linears = {"wo": lin(d, d), "w_gate": lin(d, ff), "w_up": lin(d, ff),
                   "w_down": lin(ff, d)}
        blocks.append(ExportedTransformerBlock(
            cfg, linears, torch.ones(d), torch.ones(d), fused_ffn=True,
            qkv=qkv, a8=True))
    embed = 0.02 * torch.randn((cfg.vocab, d), generator=gen, device=device)
    return ExportedTransformerLM(cfg, blocks, embed, torch.ones(d),
                                 head_dtype=head_dtype)
