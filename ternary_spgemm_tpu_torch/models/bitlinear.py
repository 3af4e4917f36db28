"""BitNet-style ternary layers: QAT training and ternary-container
inference — counterpart of ``ternary_spgemm_tpu/models/bitlinear.py`` and
of the layout of ``models/flax_module.py`` there.

* :func:`ternary_quantize` — BitNet-b1.58 absmean quantization: per-tensor
  scale ``gamma = mean|W| + eps``, ``Wq = clip(round(W / gamma), -1, 1)``;
* :func:`ternary_quantize_ste` — the same with a straight-through
  estimator, so latent f32 weights train under autograd while the forward
  pass sees ternary values;
* :class:`BitLinear` — ``y = x @ quant_ste(w) + b`` with an optional PReLU,
  an ``nn.Module`` with parameters ``w`` (K, N), ``b`` (N,) and, with
  ``prelu``, ``alpha`` (N,): the JAX params dict's names, so that its
  ``state_dict()`` is that dict;
* :class:`TernaryMLP` — a stack of BitLinear layers with PReLU between
  them (the JAX ``TernaryMLP``, and the ``FlaxTernaryMLP`` of the flax
  layout: ``models/convert.py`` carries either tree in);
* :func:`export_layer` — freeze a trained layer into a registered ternary
  container and its scale; :func:`apply_exported` and
  :func:`apply_exported_a8` run it through the kernel registry.

Initial weights come from an explicit ``torch.Generator`` (never the
global one); they follow the JAX package's distributions, not its draws.
Parity with it comes from carried weights (``models/convert.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
from torch import nn

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat, as_f32
from ternary_spgemm_tpu_torch.ops.api import get_kernel, ternary_spgemm
from ternary_spgemm_tpu_torch.ops.fused_ffn import true_div
from ternary_spgemm_tpu_torch.utils.device import resolve_device


def ternary_quantize(W: torch.Tensor, eps: float = 1e-6):
    """BitNet-b1.58 absmean ternarization -> (Wq in {-1,0,+1} f32, gamma).

    ``gamma = mean|W| + eps``, ``Wq = clip(round(W / gamma), -1, 1)``
    (f32 throughout, round half to even, as in the JAX package)."""
    W = torch.as_tensor(W, dtype=torch.float32)
    gamma = torch.mean(torch.abs(W)) + eps
    Wq = torch.clamp(torch.round(W / gamma), -1.0, 1.0)
    return Wq, gamma


def ternary_quantize_ste(W: torch.Tensor) -> torch.Tensor:
    """Quantize with a straight-through estimator: the forward value is the
    JAX expression ``W + stop_gradient(Wq * gamma - W)`` (its bits, not
    only ``Wq * gamma``'s), the gradient the identity to ``W``."""
    Wq, gamma = ternary_quantize(W.detach())
    return W + (Wq * gamma - W).detach()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gather_rows(x):
    """A DTensor ``x (rows..., features)`` with every split of a middle
    dim (the sequence, under sequence parallelism) gathered, the batch and
    feature splits kept: Megatron's all-gather before a tensor-parallel
    product, and the layout a product that flattens the rows can take. The
    redistribution is made even where nothing moves, so that the gradient
    comes back in this layout too (DTensor cannot flatten a sequence split
    in the backward either). Anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard() and 0 < p.dim < x.dim() - 1 else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def reduce_partial(y, out_placements=None):
    """A DTensor product ``y``'s partial sums reduced into
    ``out_placements`` on their mesh dims (the residual stream's layout:
    under sequence parallelism its sequence split, so the reduction is a
    reduce-scatter) or, without it, replicated (an all-reduce); the other
    mesh dims kept. The redistribution is made even where nothing moves,
    so that the gradient comes back in this layout too. Anything else as
    it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate

    pl = [(Replicate() if out_placements is None else out_placements[i])
          if p.is_partial() else p for i, p in enumerate(y.placements)]
    return y.redistribute(y.device_mesh, pl)


def default_generator(device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with 0 (the JAX package's
    ``key(0)`` default), where the caller gives none."""
    return torch.Generator(device=device).manual_seed(0)


class BitLinear(nn.Module):
    """BitNet linear layer: ``y = x @ quant_ste(w) + b`` [PReLU].

    The weights are quantized at f32 master precision (casting the latents
    first would flip ternary decisions at the 0.5 boundary), then cast to
    x's dtype; the product is accumulated in f32, the bias and PReLU added
    in f32, and the result returned at x's dtype, as the JAX layer does
    (``jnp.dot(..., preferred_element_type=f32)``). For bf16 operands the
    product runs as an f32 matmul of the widened operands: each product of
    two bf16 values is exact in f32, so this is that dot and its gradient
    (the JAX transpose rule's, cast back to bf16). PyTorch's bf16 matmul
    with an f32 result (``torch.mm(..., out_dtype=)``) has no derivative.

    Built on the card unless ``device="cpu"``; ``generator`` (on that
    device) draws ``w`` from N(0, 2 / in_features), ``b`` is zero and
    ``alpha`` 0.1."""

    def __init__(self, in_features: int, out_features: int, *,
                 prelu: bool = False, generator=None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.prelu = prelu
        self.w = nn.Parameter(torch.empty((in_features, out_features),
                                          device=dev))
        self.b = nn.Parameter(torch.zeros((out_features,), device=dev))
        self.register_parameter("alpha", nn.Parameter(torch.full(
            (out_features,), 0.1, device=dev)) if prelu else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        gen = generator or default_generator(self.w.device)
        std = (2.0 / self.in_features) ** 0.5
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=gen,
                                     device=self.w.device) * std)
            self.b.zero_()
            if self.alpha is not None:
                self.alpha.fill_(0.1)

    def forward(self, x: torch.Tensor, out_placements=None) -> torch.Tensor:
        """``out_placements``: for DTensor operands, where a row-parallel
        product's partial sums go (:func:`reduce_partial`); the bias and
        PReLU follow the reduction."""
        x = gather_rows(x)
        wq = ternary_quantize_ste(self.w).to(x.dtype)
        y = reduce_partial(torch.matmul(x.to(torch.float32),
                                        wq.to(torch.float32)),
                           out_placements) + self.b
        if self.alpha is not None:
            y = torch.where(y > 0, y, self.alpha * y)
        return y.to(x.dtype)


class TernaryMLP(nn.Module):
    """A stack of :class:`BitLinear` layers, PReLU on every layer but the
    last (the reference's fused epilogue as the model's nonlinearity).
    ``features``: input, hidden and output sizes."""

    def __init__(self, features: Sequence[int], *, generator=None,
                 device="cuda"):
        super().__init__()
        if len(features) < 2:
            raise ValueError("need at least input and output feature sizes")
        dev = resolve_device(device)
        gen = generator or default_generator(dev)
        self.features = tuple(features)
        self.layers = nn.ModuleList(
            BitLinear(features[i], features[i + 1],
                      prelu=i < len(features) - 2, generator=gen, device=dev)
            for i in range(len(features) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def export_layer(params, format_cls: Type[TernaryFormat], **fmt_kwargs):
    """Freeze a trained BitLinear (its params dict, numpy or torch, or a
    layer's ``state_dict()``) into ``(container, gamma, bias, alpha)``;
    inference then runs ``ternary_spgemm(x, fmt, b / gamma, alpha) *
    gamma`` (:func:`apply_exported`), which keeps the kernel's integer-exact
    accumulation."""
    Wq, gamma = ternary_quantize(as_f32(params["w"]))
    fmt = format_cls.from_dense(Wq.to(torch.int8), **fmt_kwargs)
    return fmt, float(gamma), params["b"], params.get("alpha")


def apply_exported(x: torch.Tensor, fmt: TernaryFormat, gamma: float, bias,
                   alpha=None, *, kernel: Optional[str] = None):
    """An exported BitLinear through the kernel registry: ``(x @ Wq +
    b / gamma) * gamma``, equal to ``x @ (gamma Wq) + b``; with PReLU the
    same folding holds, since ``prelu(c y) = c prelu(y)`` for c > 0."""
    dev = x.device
    b_scaled = true_div(as_f32(bias, dev), gamma)
    a = None if alpha is None else as_f32(alpha, dev)
    return ternary_spgemm(x, fmt, b_scaled, a, kernel=kernel) * gamma


def apply_exported_a8(x: torch.Tensor, fmt: TernaryFormat, gamma: float,
                      bias, alpha=None, *, kernel: Optional[str] = None):
    """The W1.58-A8 serving path over an exported container: per-row scale
    ``s = max|x| / 127 + 1e-12``, the int8-native kernel on ``x / s``
    (which rounds and clamps), then ``y * (s * gamma) + b`` and the PReLU
    outside the kernel (a per-row scale cannot fold into a per-column
    bias).

    ``kernel`` must be an int8-native (_x8) kernel; by default the one
    ``models.exported._default_a8_kernel`` picks for ``type(fmt)``, which
    must be int8-native."""
    from ternary_spgemm_tpu_torch.models.exported import _default_a8_kernel

    if kernel is not None:
        spec = get_kernel(kernel)
        if spec.x_absmax != 127:
            raise ValueError(
                f"apply_exported_a8 needs an int8-native (_x8) kernel; "
                f"{kernel!r} has x_absmax={spec.x_absmax}")
    else:
        name = _default_a8_kernel(fmt)
        if name is None or get_kernel(name).x_absmax != 127:
            raise TypeError(
                f"no int8-native (_x8) kernel registered for "
                f"{type(fmt).__name__}; export into TiledBitplane, "
                f"TiledDenseTernary, or DenseTernary")
        spec = get_kernel(name)
    x = as_f32(x)
    dev = x.device
    s = true_div(torch.amax(torch.abs(x), dim=-1, keepdim=True), 127.0) \
        + 1e-12
    zeros = torch.zeros((fmt.shape[1],), dtype=torch.float32, device=dev)
    y = spec(x / s, fmt, zeros) * (s * gamma) + as_f32(bias, dev)
    if alpha is not None:
        y = torch.where(y > 0, y, as_f32(alpha, dev)[None, :] * y)
    return y
