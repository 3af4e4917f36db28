"""Exported ternary linear layers — counterpart of
``ternary_spgemm_tpu/models/exported.py`` (forward only in this slice; the
custom-VJP backward through the transposed container comes later).
"""

from __future__ import annotations

from typing import Optional, Type

import torch
from torch import nn

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    as_f32,
    format_from_buffers,
    register_format_buffers,
)
from ternary_spgemm_tpu_torch.models.bitlinear import ternary_quantize
from ternary_spgemm_tpu_torch.ops.api import (
    all_kernels,
    dispatch_rank,
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


class ExportedBitLinear(nn.Module):
    """Frozen ternary linear layer: ``y = gamma * (x @ Wq) + b`` [PReLU].

    The container's tensors are buffers, so ``.to(device)`` moves them.
    ``a8=True`` is the W1.58-A8 serving regime: per-row absmax int8
    requantization before the kernel, row scale and bias after it
    (``y * (s * gamma) + b``). Without it the layer runs
    ``spgemm(x, b / gamma) * gamma`` through default dispatch — over a
    TiledBitplane that is the _i8 kernel, which floors non-integer x (and
    warns), exactly as the JAX package does.

    ``fmt_t``: the transposed container of a loaded bundle (the JAX
    export's ``with_transpose=True``). The forward never reads it; it is
    kept on the host so that a re-save writes it back unchanged.
    """

    def __init__(self, fmt: TernaryFormat, gamma: float, bias, alpha=None, *,
                 kernel: Optional[str] = None, a8: bool = False,
                 fmt_t: Optional[TernaryFormat] = None):
        super().__init__()
        self.fmt_t = None if fmt_t is None else fmt_t.to("cpu")
        register_format_buffers(self, fmt)
        dev = fmt.device
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

    @classmethod
    def from_params(cls, params: dict, format_cls: Type[TernaryFormat], *,
                    kernel: Optional[str] = None, a8: bool = False,
                    device=None, **fmt_kwargs):
        """From BitLinear params ``{"w": (K, N) latent f32, "b": (N,),
        ["alpha": (N,)]}`` (numpy or torch): absmean-quantized and packed on
        ``device``."""
        Wq, gamma = ternary_quantize(as_f32(params["w"], device))
        fmt = format_cls.from_dense(Wq.to(torch.int8), **fmt_kwargs)
        return cls(fmt, float(gamma), params["b"], params.get("alpha"),
                   kernel=kernel, a8=a8)

    @classmethod
    def from_dense(cls, W, format_cls: Type[TernaryFormat], *,
                   gamma: float = 1.0, bias=None, alpha=None,
                   kernel: Optional[str] = None, a8: bool = False,
                   device=None, **fmt_kwargs):
        fmt = format_cls.from_dense(W, device=device, **fmt_kwargs)
        if bias is None:
            bias = torch.zeros(fmt.shape[1], dtype=torch.float32)
        return cls(fmt, gamma, bias, alpha, kernel=kernel, a8=a8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fmt = self.fmt
        kernel = self.kernel
        if kernel is None and self.a8:
            kernel = _default_a8_kernel(fmt)
        if self.a8:
            # A8: integer kernel dot, per-row scale and bias outside
            xq, s = _requantize_a8(x)
            y = ternary_spgemm(xq, fmt, self.zero_bias, None, kernel=kernel)
            y = y * (s * self.gamma) + self.bias
        else:
            # gamma * (x @ Wq) + b  ==  gamma * (x @ Wq + b/gamma)
            y = ternary_spgemm(x, fmt, true_div(self.bias, self.gamma), None,
                               kernel=kernel) * self.gamma
        if self.alpha is not None:
            y = torch.where(y > 0, y, self.alpha[None, :] * y)
        return y
