"""Weight carry-over from the JAX package's QAT parameter tree.

:func:`lm_from_jax_params` takes the tree ``BitTransformerLM.init`` gives
(``ternary_spgemm_tpu/models/transformer.py:256-265``) as numpy arrays —
``{"embed": (vocab, d), "blocks": [{"wq": {"w", "b"}, ..., "norm_attn",
"norm_ffn"}, ...], "norm_out": (d,)}`` — and builds the port's serving
export, quantizing with the same absmean formula and packing with the port's
``TiledBitplane`` (byte-identical planes). No JAX is needed: the tree can
come from ``np.savez`` of the JAX params, or be drawn in its shape.
"""

from __future__ import annotations

from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.models.generate import ExportedTransformerLM
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerConfig,
    ExportedTransformerBlock,
)
from ternary_spgemm_tpu_torch.utils.device import resolve_device


def lm_from_jax_params(cfg: BitTransformerConfig, params_np: dict, *,
                       a8: bool, fused_qkv: bool, fused_ffn: bool,
                       device="cuda", format_cls=TiledBitplane, kernel=None,
                       head_dtype=None, **fmt_kwargs) -> ExportedTransformerLM:
    """The port's :class:`ExportedTransformerLM` from a JAX QAT tree (the
    counterpart of ``ExportedTransformerLM.from_params(model, params,
    format_cls, kernel=..., a8=..., fused_qkv=..., fused_ffn=...,
    head_dtype=..., with_transpose=False)``), built on the card (raises
    without one) unless ``device="cpu"``. ``kernel`` names a kernel of this
    port's registry (None: dispatch as the JAX package does)."""
    device = resolve_device(device)
    if cfg.moe_experts:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP A7)")
    if len(params_np["blocks"]) != cfg.n_layers:
        raise ValueError(f"params hold {len(params_np['blocks'])} blocks, "
                         f"cfg.n_layers={cfg.n_layers}")
    blocks = [ExportedTransformerBlock.from_params(
        cfg, p, format_cls, kernel=kernel, fused_ffn=fused_ffn,
        fused_qkv=fused_qkv, a8=a8, device=device, **fmt_kwargs)
        for p in params_np["blocks"]]
    return ExportedTransformerLM(cfg, blocks, params_np["embed"],
                                 params_np["norm_out"], head_dtype=head_dtype)
