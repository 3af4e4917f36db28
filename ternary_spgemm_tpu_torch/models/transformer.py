"""BitNet-b1.58-style ternary transformer, exported inference — counterpart
of ``ternary_spgemm_tpu/models/transformer.py``.

The LLaMA topology BitNet b1.58 keeps: RMSNorm -> ternary QKV/O attention
with rotary embeddings -> RMSNorm -> ternary SwiGLU FFN, residuals around
both. Every projection runs on the kernel registry; attention, norms and
rotary are plain PyTorch. The QAT model (``BitTransformerLM``) is not ported
yet: its parameter tree comes over through ``models/convert.py``.

Device-independent glue: the glue that reduces or calls a transcendental
function (RMSNorm's mean square and rsqrt, rotary cos/sin, the attention
dots and softmax, the sigmoid) is evaluated in f64 and rounded once to the
f32 the JAX package computes in. Every other op is an IEEE-exact f32 op.
So the same model gives the same bits on the CPU and on the card (but for
the f32 logits head), which matters because the A8 requantize turns a
last-ULP difference at a .5 boundary into a whole int8 step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Type

import torch
from torch import nn

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    as_f32,
    format_from_buffers,
    register_format_buffers,
)
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.models.bitlinear import ternary_quantize
from ternary_spgemm_tpu_torch.models.exported import (
    ExportedBitLinear,
    _default_a8_kernel,
    _requantize_a8,
)
from ternary_spgemm_tpu_torch.ops.api import ternary_spgemm
from ternary_spgemm_tpu_torch.ops.fused_ffn import (
    fused_bitplane_swiglu,
    requantize_rows,
    sigmoid_f32,
)

F64 = torch.float64


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, the formula of ``jax.nn.silu``."""
    return x * sigmoid_f32(x)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm: ``(x * rsqrt(mean(x^2) + eps)) * scale``, the normalised x
    evaluated in f64 and rounded once to x's dtype."""
    xd = x.to(F64)
    var = torch.mean(torch.square(xd), dim=-1, keepdim=True)
    return (xd * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope_freqs(half: int, device, base: float = 10000.0) -> torch.Tensor:
    """``base ** (-arange(half) / half)`` rounded once to f32."""
    return (base ** (-torch.arange(0, half, dtype=F64, device=device) / half)
            ).to(torch.float32)


def cos_sin(ang: torch.Tensor):
    """cos and sin of f32 angles, evaluated in f64, rounded once to f32."""
    a = ang.to(F64)
    return torch.cos(a).to(torch.float32), torch.sin(a).to(torch.float32)


def rotary_embed(x: torch.Tensor, *, base: float = 10000.0, offset=0):
    """Rotary position embeddings over the last axis of ``(..., T, D)``
    (half-split pairing, positions ``offset..offset+T-1``; ``offset`` an
    int or a 0-d tensor, the same bits: an integer position is exact in
    f32, so a row's angles are those of ``_rotary_at`` at its position)."""
    T, D = x.shape[-2], x.shape[-1]
    half = D // 2
    freqs = rope_freqs(half, x.device, base)
    pos = torch.arange(T, dtype=torch.float32, device=x.device)
    if isinstance(offset, torch.Tensor):
        pos = pos + offset.to(torch.float32)
    elif offset:
        pos = pos + float(offset)
    cos, sin = cos_sin(pos[:, None] * freqs[None, :])
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _norm_heads(n_heads):
    """``n_heads`` is an int (MHA) or ``(n_q_heads, n_kv_heads)`` (GQA)."""
    if isinstance(n_heads, int):
        return n_heads, n_heads
    nq, nkv = n_heads
    return int(nq), int(nkv)


def causal_attend(n_heads, q, k, v, window: int = 0):
    """(B, T, d) multi-head causal attention with rotary q/k; GQA when
    ``n_heads = (n_q, n_kv)``; ``window > 0`` is sliding-window attention.
    The dots and the softmax run in f64; the output is rounded to f32."""
    B, T, d = q.shape
    nq, nkv = _norm_heads(n_heads)
    hd = d // nq
    G = nq // nkv
    q = q.reshape(B, T, nq, hd).transpose(1, 2)
    kv = lambda z: z.reshape(B, T, nkv, hd).transpose(1, 2)
    k, v = kv(k), kv(v)
    q, k = rotary_embed(q), rotary_embed(k)
    q5 = q.reshape(B, nkv, G, T, hd).to(F64)
    logits = torch.einsum("bngqd,bnkd->bngqk", q5, k.to(F64)) / (hd ** 0.5)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    if window:
        qi = torch.arange(T, device=q.device)[:, None]
        mask = mask & (qi - torch.arange(T, device=q.device)[None, :] < window)
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v.to(F64))
    return out.reshape(B, nq, T, hd).transpose(1, 2).reshape(B, T, d).to(
        torch.float32)


@dataclasses.dataclass(frozen=True)
class BitTransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    #: grouped-query attention: number of shared K/V heads (0 = n_heads)
    n_kv_heads: int = 0
    #: sliding-window attention span (0 = full causal)
    window: int = 0
    d_ff: int = 384
    n_layers: int = 2
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 2.0
    remat: bool = False
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide into n_heads")
        if (self.d_model // self.n_heads) % 2:
            raise ValueError("head_dim must be even (rotary half-split)")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide into n_kv_heads (GQA "
                             "groups are equal-size)")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_tuple(self):
        return (self.n_heads, self.kv_heads)

    @property
    def kv_width(self) -> int:
        return self.kv_heads * (self.d_model // self.n_heads)


LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class MergedQKV(nn.Module):
    """One ternary container over ``hstack(Wq, Wk, Wv)`` with per-segment
    output scales (the three absmean gammas) and concatenated biases."""

    def __init__(self, fmt: TernaryFormat, scale, bias):
        super().__init__()
        register_format_buffers(self, fmt)
        dev = fmt.device
        self.register_buffer("scale", as_f32(scale, dev))
        self.register_buffer("bias", as_f32(bias, dev))
        self.register_buffer("zero_bias", torch.zeros(
            fmt.shape[1], dtype=torch.float32, device=dev), persistent=False)

    @property
    def fmt(self) -> TernaryFormat:
        return format_from_buffers(self)

    @classmethod
    def from_params(cls, params: dict, format_cls, *, device=None,
                    **fmt_kwargs) -> "MergedQKV":
        Ws, scales, biases = [], [], []
        for n in ("wq", "wk", "wv"):
            Wq, g = ternary_quantize(as_f32(params[n]["w"], device))
            Ws.append(Wq.to(torch.int8))
            scales.append(torch.full((Wq.shape[1],), float(g),
                                     dtype=torch.float32))
            biases.append(as_f32(params[n]["b"]))
        fmt = format_cls.from_dense(torch.cat(Ws, dim=1), **fmt_kwargs)
        return cls(fmt, torch.cat(scales), torch.cat(biases))


class ExportedTransformerBlock(nn.Module):
    """A block frozen into ternary containers, run on the kernel registry.

    ``qkv``: a :class:`MergedQKV` (the merged-QKV fast path) or None.
    ``fused_ffn``: run the SwiGLU FFN as one :func:`fused_bitplane_swiglu`
    call when its contract holds (:meth:`_fused_ffn_applicable`, the JAX
    rule). ``a8``: the W1.58-A8 regime of the projections (default: that of
    ``linears["wq"]``, as the JAX block decides it)."""

    def __init__(self, cfg: BitTransformerConfig, linears: dict, norm_attn,
                 norm_ffn, *, fused_ffn: bool = False,
                 qkv: Optional[MergedQKV] = None,
                 kernel: Optional[str] = None, a8: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        self.linears = nn.ModuleDict(linears)
        dev = next(iter(self.linears.values())).bias.device
        self.register_buffer("norm_attn", as_f32(norm_attn, dev))
        self.register_buffer("norm_ffn", as_f32(norm_ffn, dev))
        self.fused_ffn = bool(fused_ffn)
        self.qkv = qkv
        self.kernel = kernel
        if a8 is None:
            a8 = "wq" in self.linears and self.linears["wq"].a8
        self.a8 = bool(a8)
        self._ffn_biasless = self._check_ffn_biasless()

    def _check_ffn_biasless(self) -> bool:
        for n in ("w_gate", "w_up", "w_down"):
            if n not in self.linears or bool(torch.any(self.linears[n].bias)):
                return False
        return True

    @classmethod
    def from_params(cls, cfg: BitTransformerConfig, params: dict,
                    format_cls: Type[TernaryFormat], *,
                    kernel: Optional[str] = None, fused_ffn: bool = False,
                    fused_qkv: bool = False, a8: bool = False, device=None,
                    **fmt_kwargs):
        """From one block of the JAX ``BitTransformerLM.init`` tree (numpy
        or torch leaves), quantized and packed on ``device``."""
        linears = {n: ExportedBitLinear.from_params(
            params[n], format_cls, kernel=kernel, a8=a8, device=device,
            **fmt_kwargs) for n in LINEARS}
        qkv = (MergedQKV.from_params(params, format_cls, device=device,
                                     **fmt_kwargs) if fused_qkv else None)
        return cls(cfg, linears, params["norm_attn"], params["norm_ffn"],
                   fused_ffn=fused_ffn, qkv=qkv, kernel=kernel, a8=a8)

    def _fused_ffn_applicable(self) -> bool:
        """The JAX rule (``models/transformer.py:439-457`` there):
        TiledBitplane containers, biasless projections, and an output
        projection that fits one storage tile."""
        if not self._ffn_biasless:
            return False
        for n in ("w_gate", "w_up", "w_down"):
            if not isinstance(self.linears[n].fmt, TiledBitplane):
                return False
        return self.linears["w_down"].fmt.plane.shape[1] == 1

    def _fused_ffn_call(self, h):
        g, u, dn = (self.linears[n] for n in ("w_gate", "w_up", "w_down"))
        hq, sx = requantize_rows(h)
        return fused_bitplane_swiglu(
            hq, sx, g.fmt, u.fmt, dn.fmt, gamma_gate=g.gamma,
            gamma_up=u.gamma, gamma_down=dn.gamma)

    def _ffn(self, h):
        """SwiGLU FFN over flattened rows: one fused kernel call for all rows
        (rows are independent, so the JAX package's 128-row chunking does
        not change the result and is not needed), else three linears."""
        if self.fused_ffn and self._fused_ffn_applicable():
            return self._fused_ffn_call(h)
        return self.linears["w_down"](
            silu(self.linears["w_gate"](h)) * self.linears["w_up"](h))

    def _qkv_kernel(self, x, fmt):
        """The merged QKV's kernel: ``kernel="auto"`` measured on the first
        call's activations (what the kernel receives) and kept, as an
        :class:`ExportedBitLinear` keeps it."""
        from ternary_spgemm_tpu_torch.ops.autotune import resolve

        return resolve(self, x, fmt, self.qkv.zero_bias)

    def _qkv(self, h):
        """(rows, d) -> q, k, v. With the merged container: ONE SpMM over
        (d, d + 2*kv_width); in the A8 regime one shared requantize."""
        if self.qkv is not None:
            d, kvw = self.cfg.d_model, self.cfg.kv_width
            fmt = self.qkv.fmt
            if self.a8:
                hq, s = _requantize_a8(h)
                kname = self._qkv_kernel(hq, fmt) or _default_a8_kernel(fmt)
                out = ternary_spgemm(hq, fmt, self.qkv.zero_bias, None,
                                     kernel=kname)
                out = (out * s) * self.qkv.scale[None, :] \
                    + self.qkv.bias[None, :]
            else:
                out = ternary_spgemm(h, fmt, self.qkv.zero_bias, None,
                                     kernel=self._qkv_kernel(h, fmt))
                out = out * self.qkv.scale[None, :] + self.qkv.bias[None, :]
            return out[:, :d], out[:, d:d + kvw], out[:, d + kvw:]
        return (self.linears["wq"](h), self.linears["wk"](h),
                self.linears["wv"](h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        flat = lambda n, z: self.linears[n](z.reshape(B * T, -1)).reshape(
            B, T, -1)
        h = rms_norm(x, self.norm_attn)
        q, kk, v = (z.reshape(B, T, -1) for z in self._qkv(h.reshape(B * T, d)))
        x = x + flat("wo", causal_attend(self.cfg.head_tuple, q, kk, v,
                                         window=self.cfg.window))
        h = rms_norm(x, self.norm_ffn)
        return x + self._ffn(h.reshape(B * T, d)).reshape(B, T, d)
