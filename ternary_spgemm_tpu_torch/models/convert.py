"""Weight carry-over between the JAX package's parameter trees and the port.

* :func:`lm_from_jax_params` takes the tree ``BitTransformerLM.init`` gives
  (``ternary_spgemm_tpu/models/transformer.py:256-265``) as numpy arrays —
  ``{"embed": (vocab, d), "blocks": [{"wq": {"w", "b"}, ..., "norm_attn",
  "norm_ffn"}, ...], "norm_out": (d,)}``, an MoE block's FFN the subtree
  ``"moe": {"router", "w_gate", "w_up", "w_down"}`` in the place of the
  three FFN linears — and builds the port's serving
  export, quantizing with the same absmean formula and packing with the
  port's ``TiledBitplane`` (byte-identical planes). No JAX is needed: the
  tree can come from ``np.savez`` of the JAX params, or be drawn in its
  shape.
* :func:`qat_lm_from_jax_params`, :func:`mlp_from_jax_params` and
  :func:`mlp_from_flax_params` load such a tree, a ``TernaryMLP.init``
  list or a ``FlaxTernaryMLP`` variables tree (``{"params": {"layers_<i>":
  {"w", "b", ["alpha"]}}}``) into the port's QAT modules, whose parameter
  names are the trees' keys; :func:`jax_tree` gives a module's parameters
  back in the JAX layout, so a tree trained in the port serves through
  :func:`lm_from_jax_params` and trains on in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ternary_spgemm_tpu_torch.formats.base import as_f32
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.models.bitlinear import TernaryMLP
from ternary_spgemm_tpu_torch.models.generate import ExportedTransformerLM
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerConfig,
    BitTransformerLM,
    ExportedTransformerBlock,
)
from ternary_spgemm_tpu_torch.utils.device import resolve_device


def lm_from_jax_params(cfg: BitTransformerConfig, params_np: dict, *,
                       a8: bool, fused_qkv: bool, fused_ffn: bool,
                       device="cuda", format_cls=TiledBitplane, kernel=None,
                       head_dtype=None, with_transpose: bool = False,
                       **fmt_kwargs) -> ExportedTransformerLM:
    """The port's :class:`ExportedTransformerLM` from a JAX QAT tree (the
    counterpart of ``ExportedTransformerLM.from_params(model, params,
    format_cls, kernel=..., a8=..., fused_qkv=..., fused_ffn=...,
    head_dtype=..., with_transpose=False)``: a serving export unless
    ``with_transpose=True``), built on the card (raises without one) unless
    ``device="cpu"``. ``kernel`` names a kernel of this port's registry
    (None: dispatch as the JAX package does)."""
    device = resolve_device(device)
    if len(params_np["blocks"]) != cfg.n_layers:
        raise ValueError(f"params hold {len(params_np['blocks'])} blocks, "
                         f"cfg.n_layers={cfg.n_layers}")
    blocks = [ExportedTransformerBlock.from_params(
        cfg, p, format_cls, kernel=kernel, fused_ffn=fused_ffn,
        fused_qkv=fused_qkv, a8=a8, device=device,
        with_transpose=with_transpose, **fmt_kwargs)
        for p in params_np["blocks"]]
    return ExportedTransformerLM(cfg, blocks, params_np["embed"],
                                 params_np["norm_out"], head_dtype=head_dtype)


def _flat(tree, prefix: str = "") -> dict:
    """A nested dict / list tree -> ``{"a.0.b": leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _unflat(flat: dict):
    """:func:`_flat` undone: levels whose keys are all digits are lists."""
    root: dict = {}
    for key, leaf in flat.items():
        node, parts = root, key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _load(module: torch.nn.Module, flat: dict):
    """Copy ``flat`` (numpy or torch leaves, the module's state_dict keys)
    into ``module``'s parameters; every key must match."""
    dev = next(module.parameters()).device
    module.load_state_dict({k: as_f32(v, dev) for k, v in flat.items()})
    return module


def qat_lm_from_jax_params(cfg: BitTransformerConfig, params: dict, *,
                           device="cuda") -> BitTransformerLM:
    """A :class:`BitTransformerLM` holding the JAX ``BitTransformerLM.init``
    tree ``params`` (numpy or torch leaves), on the card unless
    ``device="cpu"``."""
    return _load(BitTransformerLM(cfg, device=device), _flat(params))


def mlp_from_jax_params(params, *, device="cuda") -> TernaryMLP:
    """A :class:`TernaryMLP` holding the JAX ``TernaryMLP.init`` list
    ``[{"w", "b", ["alpha"]}, ...]``; its features come from the shapes."""
    features = [params[0]["w"].shape[0]] + [p["w"].shape[1] for p in params]
    return _load(TernaryMLP(features, device=device),
                 _flat({"layers": list(params)}))


def mlp_from_flax_params(variables: dict, *, device="cuda") -> TernaryMLP:
    """A :class:`TernaryMLP` holding a ``FlaxTernaryMLP`` variables tree
    ``{"params": {"layers_<i>": {"w", "b", ["alpha"]}}}`` (the JAX
    package's ``models/flax_module.py`` layout: PReLU on every layer but
    the last, as here)."""
    p = variables["params"]
    return mlp_from_jax_params([p[f"layers_{i}"] for i in range(len(p))],
                               device=device)


def jax_tree(module: torch.nn.Module, *, numpy: bool = True):
    """A :class:`BitTransformerLM`'s, :class:`BitTransformerBlock`'s or
    :class:`TernaryMLP`'s parameters in the JAX layout (the ``init`` tree;
    for a TernaryMLP its list): numpy f32 arrays, or with ``numpy=False``
    detached tensors where they lie."""
    conv = ((lambda t: np.array(t.detach().cpu().numpy(), np.float32))
            if numpy else (lambda t: t.detach()))
    tree = _unflat({k: conv(v) for k, v in module.state_dict().items()})
    return tree["layers"] if isinstance(module, TernaryMLP) else tree
