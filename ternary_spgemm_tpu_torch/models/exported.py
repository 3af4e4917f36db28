"""Exported ternary linear layers, differentiable through the transposed
container — counterpart of ``ternary_spgemm_tpu/models/exported.py``.

The backward pass of a ternary linear layer is itself a ternary SpMM
against the transposed weights::

    y = gamma * (x @ Wq) + b            dx = gamma * (g' @ Wq^T)
    out = prelu(y, alpha)               g' = where(y > 0, g, alpha * g)
                                        db = sum_m g'
                                        dalpha = sum_m where(y > 0, 0, y g)

so :class:`ExportedBitLinear` keeps the container and, with
``with_transpose=True`` (the default, as in the JAX package), its
transpose, and a ``torch.autograd.Function`` runs the forward and the
backward on the registered kernels (the frozen-backbone fine-tuning path:
gradients with respect to activations and downstream parameters).
:class:`ExportedMLP` chains such layers. The layer's measured kernel
(``kernel="auto"``, :meth:`ExportedBitLinear.resolve_kernel`) and
:func:`autotune_exported` for a whole model are here too.
"""

from __future__ import annotations

from typing import Optional, Type

import torch
from torch import nn

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    as_f32,
    format_from_buffers,
    register_format_buffers,
)
from ternary_spgemm_tpu_torch.models.bitlinear import ternary_quantize
from ternary_spgemm_tpu_torch.ops.api import (
    all_kernels,
    default_kernel,
    dispatch_rank,
    get_kernel,
    ternary_spgemm,
)
from ternary_spgemm_tpu_torch.ops.fused_ffn import requantize_rows, true_div


def _requantize_a8(x: torch.Tensor):
    """Per-row absmax int8 requantize -> (xq f32-integer-valued, scale),
    through :func:`ops.fused_ffn.requantize_rows` (one formula for the a8
    linears, the merged QKV and the fused FFN); the clip only guards the
    all-zero-row corner."""
    xq, s = requantize_rows(x)
    return torch.clamp(xq, -127.0, 127.0), s


def _default_a8_kernel(fmt) -> Optional[str]:
    """The kernel for A8-requantized (integer, |x| <= 127) activations over
    ``fmt``: the int8-native (_x8) domain first, then any restricted-integer
    (_i8) kernel; within a domain, default dispatch's order
    (:func:`~ternary_spgemm_tpu_torch.ops.api.dispatch_rank`). None -> the
    format has fully-exact kernels."""
    cands = [s for s in all_kernels().values()
             if isinstance(fmt, s.format_cls) and not s.approximate
             and s.x_absmax is not None]
    if not cands:
        return None
    return min(cands, key=lambda s: (s.x_absmax != 127,
                                     *dispatch_rank(s))).name


class _ExportedLinearFn(torch.autograd.Function):
    """An exported layer's forward, and its backward on the transposed
    container (the JAX ``_make_vjp_fn``, ``models/exported.py:272-348``
    there): the gradients of x, the bias and the PReLU slope; the
    containers take none."""

    @staticmethod
    def forward(ctx, x, bias, alpha, layer):
        y, kernel = layer._linear(x, bias)
        ctx.layer, ctx.kernel, ctx.has_alpha = layer, kernel, alpha is not None
        if alpha is None:
            return y
        ctx.save_for_backward(y, alpha)
        return torch.where(y > 0, y, alpha[None, :] * y)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dalpha = None
        if ctx.has_alpha:
            y, alpha = ctx.saved_tensors
            pos = y > 0
            if ctx.needs_input_grad[2]:
                dalpha = torch.sum(torch.where(pos, 0.0, y * g), dim=0)
            g = torch.where(pos, g, alpha[None, :] * g)
        dx = (ctx.layer._linear_t(g, ctx.kernel) if ctx.needs_input_grad[0]
              else None)
        db = torch.sum(g, dim=0) if ctx.needs_input_grad[1] else None
        return dx, db, dalpha, None


class ExportedBitLinear(nn.Module):
    """Frozen ternary linear layer: ``y = gamma * (x @ Wq) + b`` [PReLU],
    differentiable with respect to x, the bias and the slope.

    The container's tensors are buffers, so ``.to(device)`` moves them.
    ``a8=True`` is the W1.58-A8 serving regime: per-row absmax int8
    requantization before the kernel, row scale and bias after it
    (``y * (s * gamma) + b``). Without it the layer runs
    ``spgemm(x, b / gamma) * gamma`` through default dispatch — over a
    TiledBitplane that is the _i8 kernel, which floors non-integer x (and
    warns), exactly as the JAX package does.

    ``fmt_t``: the transposed container (``with_transpose=True`` in
    :meth:`from_params` / :meth:`from_dense`, or a loaded bundle's), kept as
    buffers beside ``fmt``. Where grad is enabled and x, the bias or the
    slope requires grad, the call runs through an autograd function whose
    backward is ``gamma * (g' @ Wq^T)`` on ``fmt_t`` with the layer's
    kernel (a bias or slope tensor given to the layer that requires grad
    gets its gradient). When that kernel — the layer's, or default
    dispatch's for ``fmt_t`` — is restricted to integer X (``_i8``,
    ``_x8``), the cotangent is requantized per row first (scale ``sg *
    gamma`` after the product), as the A8 forward treats activations; the
    JAX package does so only for an explicitly named kernel
    (``models/exported.py:297-300`` there), so its default-dispatch
    backward over TiledBitplane floors the small f32 cotangent to
    integers. Without ``fmt_t`` the backward raises. Under ``torch.no_grad()``
    (serving, captured graphs) the call is the forward alone.

    ``kernel="auto"``: the first call measures the candidates on the
    activations the kernel receives (in the A8 regime the requantized
    ones) and keeps the winner (``ops/autotune.py``); a call while a CUDA
    stream is capturing raises, so resolve it first (an eager call,
    :meth:`resolve_kernel` or :func:`autotune_exported`).
    """

    def __init__(self, fmt: TernaryFormat, gamma: float, bias, alpha=None, *,
                 kernel: Optional[str] = None, a8: bool = False,
                 fmt_t: Optional[TernaryFormat] = None):
        super().__init__()
        register_format_buffers(self, fmt)
        dev = fmt.device
        if fmt_t is not None:
            register_format_buffers(self, fmt_t.to(dev), prefix="fmt_t")
            self.register_buffer("zero_bias_t", torch.zeros(
                fmt.shape[0], dtype=torch.float32, device=dev),
                persistent=False)
        self.gamma = float(gamma)
        self.register_buffer("bias", as_f32(bias, dev))
        self.register_buffer("alpha",
                             None if alpha is None else as_f32(alpha, dev))
        self.register_buffer("zero_bias", torch.zeros(
            fmt.shape[1], dtype=torch.float32, device=dev), persistent=False)
        self.kernel = kernel
        self.a8 = bool(a8)

    @property
    def fmt(self) -> TernaryFormat:
        return format_from_buffers(self)

    @property
    def fmt_t(self) -> Optional[TernaryFormat]:
        if "fmt_t" not in self._format_meta:
            return None
        return format_from_buffers(self, "fmt_t")

    @classmethod
    def from_params(cls, params: dict, format_cls: Type[TernaryFormat], *,
                    kernel: Optional[str] = None, with_transpose: bool = True,
                    a8: bool = False, device=None, **fmt_kwargs):
        """From BitLinear params ``{"w": (K, N) latent f32, "b": (N,),
        ["alpha": (N,)]}`` (numpy or torch): absmean-quantized and packed on
        ``device``, with the transposed container unless ``with_transpose=
        False`` (a forward-only serving export: half the build time and
        memory)."""
        Wq, gamma = ternary_quantize(as_f32(params["w"], device))
        Wq = Wq.to(torch.int8)
        fmt_t = (format_cls.from_dense(Wq.t().contiguous(), **fmt_kwargs)
                 if with_transpose else None)
        return cls(format_cls.from_dense(Wq, **fmt_kwargs), float(gamma),
                   params["b"], params.get("alpha"), kernel=kernel, a8=a8,
                   fmt_t=fmt_t)

    @classmethod
    def from_dense(cls, W, format_cls: Type[TernaryFormat], *,
                   gamma: float = 1.0, bias=None, alpha=None,
                   kernel: Optional[str] = None, with_transpose: bool = True,
                   a8: bool = False, device=None, **fmt_kwargs):
        W = _as_int8_dense(W, device)
        fmt = format_cls.from_dense(W, **fmt_kwargs)
        fmt_t = (format_cls.from_dense(W.t().contiguous(), **fmt_kwargs)
                 if with_transpose else None)
        if bias is None:
            bias = torch.zeros(fmt.shape[1], dtype=torch.float32)
        return cls(fmt, gamma, bias, alpha, kernel=kernel, a8=a8,
                   fmt_t=fmt_t)

    def resolve_kernel(self, M: int, *, absmax: int = 127,
                       integer: bool = True, cache_path=None,
                       verbose: bool = False) -> str:
        """Set ``kernel`` to the measured winner for an ``(M, K)`` batch in
        the given domain (integer ``|x| <= absmax``, or with ``integer=
        False`` non-integer X, the fully-exact kernels' domain): memoized
        per shape and domain, and in ``cache_path`` across processes (the
        JAX ``resolve_kernel``, ``models/exported.py:98-116`` there)."""
        from ternary_spgemm_tpu_torch.formats.generate import generate_x
        from ternary_spgemm_tpu_torch.ops.autotune import autotune

        fmt = self.fmt
        X = torch.from_numpy(generate_x(M, fmt.shape[0], seed=0,
                                        value_range=absmax)).to(fmt.device)
        if not integer:
            X = X + 0.5
        self.kernel = autotune(X, fmt, self.bias, self.alpha,
                               cache_path=cache_path, verbose=verbose)
        return self.kernel

    def _kernel_for(self, x: torch.Tensor, fmt) -> Optional[str]:
        """The kernel of this call: ``"auto"`` measured on ``x`` (what the
        kernel receives) and kept; None in the A8 regime the A8 default."""
        from ternary_spgemm_tpu_torch.ops.autotune import resolve

        kernel = resolve(self, x, fmt, self.bias, self.alpha)
        if kernel is None and self.a8:
            return _default_a8_kernel(fmt)
        return kernel

    def _linear(self, x: torch.Tensor, bias: torch.Tensor):
        """``gamma * (x @ Wq) + bias`` before the PReLU -> (y, the kernel
        name it ran, None for default dispatch)."""
        fmt = self.fmt
        if self.a8:
            # A8: integer kernel dot, per-row scale and bias outside
            xq, s = _requantize_a8(x)
            kernel = self._kernel_for(xq, fmt)
            y = ternary_spgemm(xq, fmt, self.zero_bias, None, kernel=kernel)
            return y * (s * self.gamma) + bias, kernel
        # gamma * (x @ Wq) + b  ==  gamma * (x @ Wq + b/gamma)
        kernel = self._kernel_for(x, fmt)
        return ternary_spgemm(x, fmt, true_div(bias, self.gamma), None,
                              kernel=kernel) * self.gamma, kernel

    def _linear_t(self, g: torch.Tensor, kernel: Optional[str]):
        """``gamma * (g @ Wq^T)`` through the transposed container, with
        ``kernel`` (None: default dispatch's for ``fmt_t``); a restricted
        kernel takes the per-row requantized cotangent."""
        fmt_t = self.fmt_t
        if fmt_t is None:
            raise ValueError(
                "this ExportedBitLinear was built with with_transpose=False "
                "(forward-only, serving export); rebuild with "
                "with_transpose=True to backpropagate through it")
        spec = (get_kernel(kernel) if kernel is not None
                else default_kernel(fmt_t))
        if spec.x_absmax is not None:
            gq, sg = _requantize_a8(g)
            return ternary_spgemm(gq, fmt_t, self.zero_bias_t, None,
                                  kernel=spec.name) * (sg * self.gamma)
        return ternary_spgemm(g, fmt_t, self.zero_bias_t, None,
                              kernel=spec.name) * self.gamma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, self.bias, self.alpha)):
            return _ExportedLinearFn.apply(x, self.bias, self.alpha, self)
        y, _ = self._linear(x, self.bias)
        if self.alpha is not None:
            y = torch.where(y > 0, y, self.alpha[None, :] * y)
        return y


class ExportedMLP(nn.Module):
    """A trained :class:`~ternary_spgemm_tpu_torch.models.bitlinear.
    TernaryMLP` frozen into containers layer by layer (the JAX
    ``ExportedMLP``; its in-stack tile rule ``stack_mode`` is a TPU tile
    choice with no counterpart here). Differentiable with respect to the
    input through the chain of layers, so a frozen ternary backbone
    composes with trainable heads."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_params(cls, params, format_cls: Type[TernaryFormat], *,
                    kernel: Optional[str] = None, with_transpose: bool = True,
                    device=None, **fmt_kwargs) -> "ExportedMLP":
        """From the JAX ``TernaryMLP`` params list (numpy or torch dicts;
        ``[l.state_dict() for l in mlp.layers]`` of the port's)."""
        return cls(ExportedBitLinear.from_params(
            p, format_cls, kernel=kernel, with_transpose=with_transpose,
            device=device, **fmt_kwargs) for p in params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def autotune_exported(model: nn.Module, M: int, *, absmax: int = 127,
                      integer: bool = True, cache_path=None,
                      verbose: bool = False) -> dict:
    """Resolve every :class:`ExportedBitLinear` of ``model`` to its measured
    fastest kernel for batch ``M`` in the given activation domain
    (:meth:`ExportedBitLinear.resolve_kernel`; layers of one shape and
    domain share a probe through the memo). Returns ``{(K, N): kernel}``
    (the JAX ``autotune_exported``, ``models/exported.py:208-228``)."""
    picks = {}
    for layer in model.modules():
        if isinstance(layer, ExportedBitLinear):
            picks[layer.fmt.shape] = layer.resolve_kernel(
                M, absmax=absmax, integer=integer, cache_path=cache_path,
                verbose=verbose)
    return picks
