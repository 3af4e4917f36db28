"""BitNet-b1.58-style ternary transformer: QAT blocks and exported
inference — counterpart of ``ternary_spgemm_tpu/models/transformer.py``.

The LLaMA topology BitNet b1.58 keeps: RMSNorm -> ternary QKV/O attention
with rotary embeddings -> RMSNorm -> ternary SwiGLU FFN, residuals around
both. Two regimes:

* QAT (:class:`BitTransformerLM`): every linear a latent-f32
  :class:`~ternary_spgemm_tpu_torch.models.bitlinear.BitLinear`, trained
  with ``torch.optim`` through :func:`make_lm_train_step`; attention in
  the JAX formulation (:func:`causal_attend_f32`);
* exported (:class:`ExportedTransformerBlock`): every projection frozen
  into a container and run on the kernel registry, differentiable through
  the transposed containers (``models/exported.py``).

Attention, norms and rotary are plain PyTorch.

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
from torch.utils.checkpoint import checkpoint

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    as_f32,
    format_from_buffers,
    register_format_buffers,
)
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.models.bitlinear import (
    BitLinear,
    default_generator,
    gather_rows,
    is_dtensor,
    ternary_quantize,
)
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
    true_div,
)
from ternary_spgemm_tpu_torch.utils.device import resolve_device

F64 = torch.float64


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, the formula of ``jax.nn.silu``, at x's dtype."""
    return x * sigmoid_f32(x).to(x.dtype)


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
    f32, so a row's angles are those of ``_rotary_at`` at its position).
    The f32 cos and sin are cast to x's dtype, as the JAX package casts
    them."""
    T, D = x.shape[-2], x.shape[-1]
    half = D // 2
    freqs = rope_freqs(half, x.device, base)
    pos = torch.arange(T, dtype=torch.float32, device=x.device)
    if isinstance(offset, torch.Tensor):
        pos = pos + offset.to(torch.float32)
    elif offset:
        pos = pos + float(offset)
    cos, sin = (c.to(x.dtype) for c in cos_sin(pos[:, None] * freqs[None, :]))
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _norm_heads(n_heads):
    """``n_heads`` is an int (MHA) or ``(n_q_heads, n_kv_heads)`` (GQA)."""
    if isinstance(n_heads, int):
        return n_heads, n_heads
    nq, nkv = n_heads
    return int(nq), int(nkv)


def causal_mask(T: int, window: int, device) -> torch.Tensor:
    """(T, T) bool: query i sees key j <= i, and with ``window > 0`` only
    the last ``window`` of them."""
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
    if window:
        qi = torch.arange(T, device=device)[:, None]
        mask = mask & (qi - torch.arange(T, device=device)[None, :] < window)
    return mask


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
    logits = torch.where(causal_mask(T, window, q.device), logits, -torch.inf)
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
#: an MoE block's linears: its FFN is the experts
ATTN_LINEARS = ("wq", "wk", "wv", "wo")


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
    ``linears["wq"]``, as the JAX block decides it). ``moe``: an MoE
    block's :class:`~ternary_spgemm_tpu_torch.models.moe.ExportedMoE`,
    which is its FFN (its linears then are the attention's alone)."""

    def __init__(self, cfg: BitTransformerConfig, linears: dict, norm_attn,
                 norm_ffn, *, fused_ffn: bool = False,
                 qkv: Optional[MergedQKV] = None,
                 kernel: Optional[str] = None, a8: Optional[bool] = None,
                 moe: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.linears = nn.ModuleDict(linears)
        self.moe = moe
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
                    fused_qkv: bool = False, with_transpose: bool = True,
                    a8: bool = False, device=None, **fmt_kwargs):
        """From one block of the JAX ``BitTransformerLM.init`` tree (numpy
        or torch leaves), quantized and packed on ``device``; each linear
        with its transposed container unless ``with_transpose=False``
        (serving). The merged QKV and the fused FFN bypass the linears'
        backward, as in the JAX package: a block built to backpropagate
        leaves them off.

        With ``cfg.moe_experts`` the FFN is an ``ExportedMoE`` of
        ``params["moe"]`` (its experts with their transposes, as the JAX
        package builds them) and the linears the attention's. The experts
        follow the block's ``a8``, as ``docs/serving.md`` says every
        projection of an A8 export does; the JAX block does not pass it on
        (``models/transformer.py:397-401`` there)."""
        moe = None
        if cfg.moe_experts:
            from ternary_spgemm_tpu_torch.models.moe import (
                ExportedMoE, moe_config)

            moe = ExportedMoE.from_params(
                moe_config(cfg), params["moe"], format_cls, kernel=kernel,
                a8=a8, device=device, **fmt_kwargs)
        names = ATTN_LINEARS if cfg.moe_experts else LINEARS
        linears = {n: ExportedBitLinear.from_params(
            params[n], format_cls, kernel=kernel, a8=a8, device=device,
            with_transpose=with_transpose, **fmt_kwargs) for n in names}
        qkv = (MergedQKV.from_params(params, format_cls, device=device,
                                     **fmt_kwargs) if fused_qkv else None)
        return cls(cfg, linears, params["norm_attn"], params["norm_ffn"],
                   fused_ffn=fused_ffn, qkv=qkv, kernel=kernel, a8=a8,
                   moe=moe)

    def _fused_ffn_applicable(self) -> bool:
        """The JAX rule (``models/transformer.py:439-457`` there): a dense
        FFN (not an MoE block), TiledBitplane containers, biasless
        projections, and an output projection that fits one storage
        tile."""
        if self.moe is not None or not self._ffn_biasless:
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
        if self.moe is not None:
            return x + self.moe(h)
        return x + self._ffn(h.reshape(B * T, d)).reshape(B, T, d)


def _attend_local(attend, n_heads, q, k, v, window: int):
    """``attend`` over DTensor ``q, k, v (B, T, width)`` on each rank's own
    heads: the batch stays split where it is, the width stays split where
    the KV heads divide over the mesh dim (whole heads and whole GQA groups
    a rank), anything else (the sequence, partial sums, a split inside a
    head) is gathered first. The result is a DTensor laid out as the
    inputs were redistributed."""
    from torch.distributed.tensor import DTensor, Replicate

    nq, nkv = _norm_heads(n_heads)
    mesh = q.device_mesh
    pl, parts = [], 1
    for i, p in enumerate(q.placements):
        if p.is_shard(0):
            pl.append(p)
        elif p.is_shard(2) and nkv % (parts * mesh.size(i)) == 0:
            pl.append(p)
            parts *= mesh.size(i)
        else:
            pl.append(Replicate())
    ql, kl, vl = (z.redistribute(mesh, pl).to_local() for z in (q, k, v))
    out = attend((nq // parts, nkv // parts), ql, kl, vl, window)
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=q.shape,
                              stride=q.stride())


def causal_attend_f32(n_heads, q, k, v, window: int = 0):
    """The QAT forward's attention, JAX's formulation
    (``ternary_spgemm_tpu/models/transformer.py:83-112``): q and k at the
    compute dtype after rotary, logits and softmax in f32 (the bf16 q and k
    widened: their products are exact in f32), the probabilities cast to
    v's dtype and the output at v's dtype. The serving forward's
    :func:`causal_attend` runs the dots and softmax in f64 for bits that
    match across devices; for training those f64 probabilities would be
    kept for the backward at twice the bytes (0.27 GB a layer at bitnet3b
    width, 4 x 512 tokens). DTensor inputs (the sharded train steps) run
    on each rank's heads (:func:`_attend_local`)."""
    if is_dtensor(q):
        return _attend_local(causal_attend_f32, n_heads, q, k, v, window)
    B, T, d = q.shape
    nq, nkv = _norm_heads(n_heads)
    hd = d // nq
    G = nq // nkv
    q = q.reshape(B, T, nq, hd).transpose(1, 2)
    kv = lambda z: z.reshape(B, T, nkv, hd).transpose(1, 2)
    k, v = kv(k), kv(v)
    q, k = rotary_embed(q), rotary_embed(k)
    q5 = q.reshape(B, nkv, G, T, hd).to(torch.float32)
    logits = true_div(torch.einsum("bngqd,bnkd->bngqk", q5,
                                   k.to(torch.float32)), hd ** 0.5)
    logits = torch.where(causal_mask(T, window, q.device), logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v)
    return out.reshape(B, nq, T, hd).transpose(1, 2).reshape(B, T, d)


def _compute_dtype(cfg: BitTransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


class BitTransformerBlock(nn.Module):
    """One pre-norm QAT block: ternary attention and a ternary SwiGLU FFN.

    Its linears are :class:`BitLinear` attributes named as the JAX block's
    params (``wq``/``wk``/``wv`` d -> d or the K/V width, ``wo``,
    ``w_gate``/``w_up`` d -> ff, ``w_down`` ff -> d), beside the RMSNorm
    scales ``norm_attn`` / ``norm_ffn``, so that its ``state_dict()`` keys
    are the JAX block tree's paths. With ``cfg.moe_experts`` the FFN is a
    :class:`~ternary_spgemm_tpu_torch.models.moe.BitMoE` at ``moe`` in the
    place of the three FFN linears (the JAX ``params["moe"]``). Under a
    compute dtype other than f32 the activations ride at it and each linear
    casts its quantized weights down at use; the norms and softmax keep f32
    (or f64) inside."""

    def __init__(self, cfg: BitTransformerConfig, *, generator=None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or default_generator(dev)
        self.cfg = cfg
        d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width
        shapes = {"wq": (d, d), "wk": (d, kvw), "wv": (d, kvw),
                  "wo": (d, d), "w_gate": (d, ff), "w_up": (d, ff),
                  "w_down": (ff, d)}
        for n in ATTN_LINEARS if cfg.moe_experts else LINEARS:
            setattr(self, n, BitLinear(*shapes[n], generator=gen, device=dev))
        self.moe = None
        if cfg.moe_experts:
            from ternary_spgemm_tpu_torch.models.moe import BitMoE, moe_config

            self.moe = BitMoE(moe_config(cfg), generator=gen, device=dev)
        self.norm_attn = nn.Parameter(torch.ones(d, device=dev))
        self.norm_ffn = nn.Parameter(torch.ones(d, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(x)[0]

    def forward_with_aux(self, x: torch.Tensor):
        """``(x', aux)``; aux, the MoE balance loss, is 0 for the dense
        FFN."""
        x = x.to(_compute_dtype(self.cfg))
        # a DTensor branch's row-parallel sums land in the residual's
        # layout: a reduce-scatter under sequence parallelism
        res = x.placements if is_dtensor(x) else None
        h = rms_norm(x, self.norm_attn)
        attn = self.wo(causal_attend_f32(self.cfg.head_tuple, self.wq(h),
                                         self.wk(h), self.wv(h),
                                         window=self.cfg.window), res)
        x = x + attn
        h = rms_norm(x, self.norm_ffn)
        if self.moe is not None:
            ffn, aux = self.moe(h)
            return x + ffn, aux
        ffn = self.w_down(silu(self.w_gate(h)) * self.w_up(h), res)
        return x + ffn, torch.zeros((), device=x.device)


class BitTransformerLM(nn.Module):
    """Ternary-backbone causal LM for QAT: an f32 embedding (BitNet keeps
    embeddings and head full precision), :class:`BitTransformerBlock`s and
    a tied head; ``state_dict()`` keys are the JAX tree's paths
    (``embed``, ``blocks.<i>.wq.w``, ..., ``norm_out``).

    Built on the card unless ``device="cpu"``; ``generator`` (on that
    device; None: one seeded with 0) draws the embedding from N(0, 1/d) and
    then each block's linears in order. ``cfg.remat`` recomputes each
    block's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``cfg.compute_dtype`` is
    the blocks' dtype (the embedding lookup, the final norm and the logits
    stay f32)."""

    def __init__(self, cfg: BitTransformerConfig, *, generator=None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or default_generator(dev)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.randn(
            (cfg.vocab, cfg.d_model), generator=gen, device=dev)
            * cfg.d_model ** -0.5)
        self.blocks = nn.ModuleList(
            BitTransformerBlock(cfg, generator=gen, device=dev)
            for _ in range(cfg.n_layers))
        self.norm_out = nn.Parameter(torch.ones(cfg.d_model, device=dev))

    def forward(self, tokens: torch.Tensor, *, constrain=None):
        """``tokens (B, T) -> logits (B, T, vocab)``."""
        return self.forward_with_aux(tokens, constrain=constrain)[0]

    def forward_with_aux(self, tokens: torch.Tensor, *, constrain=None):
        """``(logits, aux)``, aux the MoE balance loss averaged over the
        blocks (0 without MoE).
        ``constrain``: an ``x -> x`` hook on the ``(B, T, d)`` activations
        after the embedding and after every block (the JAX package's
        sequence-parallel sharding constraint goes there)."""
        con = constrain or (lambda z: z)
        cdtype = _compute_dtype(self.cfg)
        # a DTensor table looks up through aten.embedding, which DTensor
        # shards in both directions (indexing's backward, index_put, it
        # does not everywhere); the same rows either way
        x = (torch.nn.functional.embedding(tokens, self.embed)
             if is_dtensor(self.embed) else self.embed[tokens])
        x = con(x).to(cdtype)
        aux = torch.zeros((), device=x.device)
        for block in self.blocks:
            if self.cfg.remat:
                x, a = checkpoint(block.forward_with_aux, x,
                                  use_reentrant=False)
            else:
                x, a = block.forward_with_aux(x)
            x = con(x.to(cdtype))
            aux = aux + a
        x = rms_norm(gather_rows(x).to(torch.float32), self.norm_out)
        logits = torch.einsum("btd,vd->btv", x, self.embed)
        return logits, aux / max(1, self.cfg.n_layers)


def lm_loss(model: BitTransformerLM, tokens: torch.Tensor, *,
            aux_coef: float = 0.01, constrain=None) -> torch.Tensor:
    """Next-token cross-entropy over ``tokens (B, T)`` plus ``aux_coef``
    times the MoE balance loss (0 without MoE)."""
    logits, aux = model.forward_with_aux(tokens, constrain=constrain)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    ce = -torch.mean(torch.take_along_dim(logp, targets[..., None], dim=-1))
    return ce + aux_coef * aux


def lm_param_specs(model: BitTransformerLM,
                   axis: str = "model") -> dict:
    """Megatron-style TP specs keyed by ``state_dict()`` path (``()`` is
    replicated, as ``P()``): QKV, gate and
    up column parallel (output features on ``axis``), O and down row
    parallel (input features on ``axis``), norms and embedding replicated;
    an MoE block's expert stacks split on their leading E dim over the same
    axis (expert parallelism), its router replicated."""
    from ternary_spgemm_tpu_torch.models.moe import moe_param_specs

    col = {"w": (None, axis), "b": (axis,)}
    row = {"w": (axis, None), "b": ()}
    block = {"wq": col, "wk": col, "wv": col, "wo": row}
    if model.cfg.moe_experts:
        block["moe"] = moe_param_specs(axis)
    else:
        block.update({"w_gate": col, "w_up": col, "w_down": row})
    specs = {"embed": (), "norm_out": ()}
    for i in range(model.cfg.n_layers):
        specs[f"blocks.{i}.norm_attn"] = ()
        specs[f"blocks.{i}.norm_ffn"] = ()
        for name, sub in block.items():
            for leaf, spec in sub.items():
                specs[f"blocks.{i}.{name}.{leaf}"] = spec
    return specs


def lm_param_shardings(model: BitTransformerLM, mesh,
                       axis: str = "model") -> dict:
    """:func:`lm_param_specs` as DTensor placements on ``mesh`` — one
    reduce per attention and one per FFN."""
    from ternary_spgemm_tpu_torch.parallel.sharding import placements

    return {k: placements(mesh, s)
            for k, s in lm_param_specs(model, axis).items()}


def make_lm_train_step(model: BitTransformerLM, optimizer, *,
                       constrain=None):
    """``step(tokens) -> loss``: one ``torch.optim`` step of ``optimizer``
    (over ``model``'s parameters) on :func:`lm_loss`, the parameters
    updated in place; the loss returned is the one before the update, as
    the JAX step returns it."""

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(model, tokens, constrain=constrain)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
