"""KV-cached autoregressive decoding — counterpart of
``ternary_spgemm_tpu/models/generate.py`` for the exported model.

* :func:`init_cache` — per-block ``(B, H, max_T, hd)`` K/V caches, f32 or
  int8 with per-(token, head) absmax scales; ``ring=True`` (sliding-window
  models) a ring of ``window`` slots that records each slot's position;
* :class:`ExportedTransformerLM` — full forward, prefill that fills the
  caches (the whole prompt, or one chunk of it at ``start``), and the
  one-token decode step; every projection runs on the kernel registry;
  an f32 or a bf16 tied head (``head_dtype``); :meth:`~ExportedTransformerLM.
  from_params` from a JAX parameter tree;
* :func:`lm_prefill` and :func:`lm_decode_step` — the same prefill and
  decode step for the QAT :class:`~ternary_spgemm_tpu_torch.models.
  transformer.BitTransformerLM`;
* :func:`chunked_prefill` — a long prompt in fixed-size chunks, each
  attending to the cache the chunks before it filled;
* :func:`sample` — the JAX ``_make_sampler``'s temperature, top-k and
  top-p (nucleus) masking, then ``argmax(masked + gumbel)``;
* :func:`generate` — greedy or sampled decoding, with or without the
  prefill; on the card a captured prefill and captured decode steps
  (``models/graphs.py``), on the CPU the eager loop.

The decode position ``pos`` is a Python int or a 0-d int64 tensor on the
model's device (the captured step keeps it there and bumps it in place);
the two give the same bits. The JAX package is functional; here
:func:`_cache_put` writes the new rows into the cache tensors in place (no
copy of the cache per step) and returns the same dict.

:func:`autotune_serving_flags` measures which of the serving fast paths
(fused SwiGLU FFN, merged QKV) one block runs fastest at the decode shape;
``ExportedTransformerLM.from_params(auto=True)`` builds with its choice.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from ternary_spgemm_tpu_torch.formats.base import as_f32
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.ops.fused_ffn import true_div
from ternary_spgemm_tpu_torch.models.transformer import (
    F64,
    BitTransformerConfig,
    BitTransformerLM,
    ExportedTransformerBlock,
    _norm_heads,
    cos_sin,
    rms_norm,
    rope_freqs,
    rotary_embed,
    silu,
)


def _rotary_at(x: torch.Tensor, pos, base: float = 10000.0):
    """Rotary embedding of ``x (B, H, 1, hd)`` at absolute position ``pos``
    (an int or a 0-d tensor: an integer is exact in f32, so both give the
    angles ``float(pos) * freqs``)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(half, x.device, base)
    ang = (pos.to(torch.float32) * freqs if isinstance(pos, torch.Tensor)
           else float(pos) * freqs)
    cos, sin = cos_sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def init_cache(cfg: BitTransformerConfig, batch: int, max_t: int,
               dtype=torch.float32, *, ring: bool = False, device=None):
    """Zeroed per-block caches: a list of ``{"k", "v"}: (B, H, max_T, hd)``;
    ``dtype=torch.int8`` adds ``k_scale``/``v_scale`` ``(B, H, max_T, 1)``
    f32 (4x smaller cache; scales applied outside the attention dots). With
    GQA, H is the KV-head count.

    ``ring=True`` (needs ``cfg.window > 0``): ``window`` slots whatever
    ``max_t``; position p lives at slot ``p % window``, and ``pos_tab
    (window,)`` int32 holds each slot's position (-1: empty), which the
    decode step masks by. A prompt longer than the window cannot be
    prefilled into a ring (its own earlier queries need the keys it would
    evict): :func:`generate` refuses it."""
    hd = cfg.d_model // cfg.n_heads
    slots = max_t
    if ring:
        if not cfg.window:
            raise ValueError("ring=True requires cfg.window > 0")
        slots = cfg.window
    shape = (batch, cfg.kv_heads, slots, hd)
    caches = []
    for _ in range(cfg.n_layers):
        if dtype == torch.int8:
            cache = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3] + (1,), device=device),
                "v_scale": torch.zeros(shape[:3] + (1,), device=device)}
        else:
            cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
        if ring:
            cache["pos_tab"] = torch.full((slots,), -1, dtype=torch.int32,
                                          device=device)
        caches.append(cache)
    return caches


def _quant_rows(x: torch.Tensor):
    """Per-row absmax int8 quantization -> (int8, f32 scale). The eps comes
    after the division here (``max/127 + 1e-12``), as in the JAX package."""
    s = true_div(torch.amax(torch.abs(x), dim=-1, keepdim=True), 127.0) + 1e-12
    return torch.round(x / s).to(torch.int8), s


def _cache_put(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
               pos) -> dict:
    """Write (quantizing for int8 caches) rotated K/V rows at positions
    ``pos, pos + 1, ...`` (``pos`` an int or a 0-d tensor), in place. A
    ring cache (``pos_tab``) takes position p at slot ``p % window`` and
    records p there."""
    idx = torch.arange(k_new.shape[2], device=k_new.device) + pos
    if "pos_tab" in cache:
        slots = torch.remainder(idx, cache["pos_tab"].shape[0])
        cache["pos_tab"].index_copy_(0, slots, idx.to(torch.int32))
        idx = slots
    if "k_scale" in cache:
        kq, ks = _quant_rows(k_new)
        vq, vs = _quant_rows(v_new)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k_new, "v": v_new}
    for name, r in rows.items():
        cache[name].index_copy_(2, idx, r)
    return cache


def _cache_attn(q: torch.Tensor, cache: dict, T=None, hd_scale: float = 1.0):
    """Attention logits over a (possibly int8) cache and the value combine;
    returns ``(logits (B,H,Q,Tc), combine(probs) -> out)``, both in f64 (the
    caller rounds the output to f32). int8 scales apply outside the dots:
    ``q.(c_k s_k) == (q.c_k) s_k`` per key row."""
    ck, cv = cache["k"], cache["v"]
    if T is not None:
        ck, cv = ck[:, :, :T], cv[:, :, :T]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(F64), ck.to(F64)) * hd_scale
    if "k_scale" in cache:
        ks, vs = cache["k_scale"][..., 0], cache["v_scale"][..., 0]
        if T is not None:
            ks, vs = ks[:, :, :T], vs[:, :, :T]
        logits = logits * ks[:, :, None, :].to(F64)

        def combine(probs):
            return torch.einsum("bhqk,bhkd->bhqd",
                                probs * vs[:, :, None, :].to(F64), cv.to(F64))
    else:
        def combine(probs):
            return torch.einsum("bhqk,bhkd->bhqd", probs, cv.to(F64))
    return logits, combine


def _cached_attend(n_heads, q, k_new, v_new, cache, pos, window: int = 0):
    """One-token attention against the cache -> (out (B, 1, d), cache)."""
    nq, nkv = _norm_heads(n_heads)
    B, _, d = q.shape
    hd = d // nq
    G = nq // nkv
    q = q.reshape(B, 1, nq, hd).transpose(1, 2)
    kv = lambda z: z.reshape(B, 1, nkv, hd).transpose(1, 2)
    k_new, v_new = kv(k_new), kv(v_new)
    q, k_new = _rotary_at(q, pos), _rotary_at(k_new, pos)
    cache = _cache_put(cache, k_new, v_new, pos)
    qg = q.reshape(B, nkv, G, hd)
    logits, combine = _cache_attn(qg, cache, hd_scale=hd ** -0.5)
    if "pos_tab" in cache:
        # a ring's slots are in no order: mask by the position each holds
        pt = cache["pos_tab"]
        mask = (pt >= 0) & (pt <= pos) & (pos - pt < pt.shape[0])
    else:
        kidx = torch.arange(cache["k"].shape[2], device=q.device)
        mask = kidx <= pos
        if window:
            mask = mask & (pos - kidx < window)
    logits = torch.where(mask[None, None, None, :], logits, -torch.inf)
    out = combine(torch.softmax(logits, dim=-1)).to(torch.float32)
    return out.reshape(B, nq, 1, hd).transpose(1, 2).reshape(B, 1, d), cache


def _block_decode(n_heads, lin, norm_attn, norm_ffn, x, cache, pos,
                  ffn=None, qkv=None, window: int = 0):
    """One block, one token; ``ffn``/``qkv`` override the SwiGLU and the
    three attention input projections."""
    h = rms_norm(x, norm_attn)
    q, k, v = (qkv(h) if qkv is not None
               else (lin("wq", h), lin("wk", h), lin("wv", h)))
    attn, cache = _cached_attend(n_heads, q, k, v, cache, pos, window=window)
    x = x + lin("wo", attn)
    h = rms_norm(x, norm_ffn)
    if ffn is not None:
        x = x + ffn(h)
    else:
        x = x + lin("w_down", silu(lin("w_gate", h)) * lin("w_up", h))
    return x, cache


def _prefill_attend(n_heads, q, k, v, cache, start=None, window: int = 0):
    """Causal attention over a prompt that also fills the cache; attention
    reads through the cache, so prefill and stepwise decode use one
    formulation (int8 caches included).

    ``start=None``: the whole prompt at positions 0..T-1 (the cache read
    cut to T). ``start`` an int or a 0-d tensor: one chunk of a longer
    prompt at positions ``start..start+T-1``, attending to the whole cache
    under the mask ``k_idx <= start + q_local`` (the chunks before it
    visible, later slots masked). A ring cache takes no chunk."""
    nq, nkv = _norm_heads(n_heads)
    B, T, d = q.shape
    hd = d // nq
    G = nq // nkv
    chunked = start is not None
    if chunked and "pos_tab" in cache:
        raise NotImplementedError(
            "chunked prefill into a ring cache is unsupported (writing a "
            "chunk before attending would evict keys its own earlier "
            "queries still need); prefill a full cache, or keep the whole "
            "prompt within the window")
    off = start if chunked else 0
    q = q.reshape(B, T, nq, hd).transpose(1, 2)
    kv = lambda z: z.reshape(B, T, nkv, hd).transpose(1, 2)
    k, v = kv(k), kv(v)
    q, k = rotary_embed(q, offset=off), rotary_embed(k, offset=off)
    cache = _cache_put(cache, k, v, off)
    qg = q.reshape(B, nkv, G * T, hd)
    logits, combine = _cache_attn(qg, cache, T=None if chunked else T,
                                  hd_scale=hd ** -0.5)
    K = logits.shape[-1]
    logits = logits.reshape(B, nkv, G, T, K)
    qabs = torch.arange(T, device=q.device)[:, None] + off
    kidx = torch.arange(K, device=q.device)[None, :]
    mask = kidx <= qabs
    if window:
        mask = mask & (qabs - kidx < window)
    logits = torch.where(mask[None, None, None], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1).reshape(B, nkv, G * T, K)
    out = combine(probs).to(torch.float32).reshape(B, nq, T, hd)
    return out.transpose(1, 2).reshape(B, T, d), cache


def _block_prefill(n_heads, lin, norm_attn, norm_ffn, x, cache, ffn=None,
                   qkv=None, start=None, window: int = 0):
    """One block over the whole prompt (or one chunk of it at ``start``),
    filling its cache."""
    h = rms_norm(x, norm_attn)
    q, k, v = (qkv(h) if qkv is not None
               else (lin("wq", h), lin("wk", h), lin("wv", h)))
    attn, cache = _prefill_attend(n_heads, q, k, v, cache, start=start,
                                  window=window)
    x = x + lin("wo", attn)
    h = rms_norm(x, norm_ffn)
    if ffn is not None:
        x = x + ffn(h)
    else:
        x = x + lin("w_down", silu(lin("w_gate", h)) * lin("w_up", h))
    return x, cache


def _fused_hooks(block: ExportedTransformerBlock, rows: int, bt):
    """(ffn, qkv) overrides for an exported block's serving fast paths: the
    fused SwiGLU kernel when its contract holds, and the merged-QKV
    container when present; an MoE block's FFN is its experts. ``bt(z)``
    gives the (B, T) of 3-D activations."""
    ffn = qkv = None
    if block.moe is not None:
        ffn = block.moe
    elif block.fused_ffn and block._fused_ffn_applicable():
        def ffn(h, b_=block):
            B, T = bt(h)
            return b_._ffn(h.reshape(rows, -1)).reshape(B, T, -1)
    if block.qkv is not None:
        def qkv(h, b_=block):
            B, T = bt(h)
            return tuple(z.reshape(B, T, -1)
                         for z in b_._qkv(h.reshape(rows, -1)))
    return ffn, qkv


class ExportedTransformerLM(nn.Module):
    """Ternary-backbone causal LM over exported blocks with a tied head.
    ``.to(device)`` moves every container.

    ``head_dtype=torch.bfloat16`` keeps the tied embedding in bf16, which
    halves the bytes the head streams a decode step (the whole ``(vocab,
    d)`` matrix): the lookup upcasts its rows to f32, and the head
    multiplies bf16 operands into f32 sums and f32 logits, as the JAX
    package's ``preferred_element_type=f32`` does. None: f32 throughout."""

    def __init__(self, cfg: BitTransformerConfig, blocks, embed, norm_out,
                 head_dtype=None):
        super().__init__()
        if head_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"head_dtype must be None, torch.float32 or "
                             f"torch.bfloat16, got {head_dtype!r}")
        self.cfg = cfg
        self.blocks = nn.ModuleList(blocks)
        dev = self.blocks[0].norm_attn.device
        self.register_buffer("embed", as_f32(embed, dev).to(
            head_dtype or torch.float32))
        self.register_buffer("norm_out", as_f32(norm_out, dev))
        # The f32 head must run in full f32 on the card: TF32 keeps ~3
        # decimal digits and would move the greedy argmax. PyTorch's default is already False; it is set here so
        # that no ambient setting changes the model's numbers.
        torch.backends.cuda.matmul.allow_tf32 = False
        #: the captured generate loops (``models/graphs.py``) by their
        #: settings; their graphs point at this model's tensors where they
        #: lay at capture, so clear it after moving the model
        self._captured: dict = {}

    @classmethod
    def from_params(cls, cfg: BitTransformerConfig, params: dict,
                    format_cls=TiledBitplane, *, kernel=None,
                    fused_ffn: bool = False, fused_qkv: bool = False,
                    a8: bool = False, head_dtype=None, auto: bool = False,
                    auto_rows: int = 1, cache_path=None, device="cuda",
                    with_transpose: bool = True,
                    **fmt_kwargs) -> "ExportedTransformerLM":
        """From a JAX ``BitTransformerLM.init`` parameter tree as numpy
        (the counterpart of the JAX ``from_params(model, params, ...)``,
        which takes the model for its cfg), through
        :func:`~ternary_spgemm_tpu_torch.models.convert.lm_from_jax_params`:
        ``format_cls``, ``kernel`` (a name of this port's registry, or
        ``"auto"``), the serving flags and the head's dtype; built on the
        card (raises without one) unless ``device="cpu"``. Each linear
        keeps its transposed container, so the model backpropagates, unless
        ``with_transpose=False`` (serving).

        ``auto=True`` replaces ``fused_ffn`` / ``fused_qkv`` by the
        measured choice of :func:`autotune_serving_flags` for the first
        block at ``auto_rows`` rows, with the caller's ``kernel`` (the JAX
        package drops it, ``models/generate.py:417`` there) and the JSON
        ``cache_path`` shared with ``ops/autotune.py``. An MoE model has no
        fused FFN to choose: ``auto=True`` warns and keeps the caller's
        flags (the JAX package skips the probe without a word,
        ``models/generate.py:416`` there)."""
        from ternary_spgemm_tpu_torch.models.convert import lm_from_jax_params

        if auto and cfg.moe_experts:
            warnings.warn(
                "from_params(auto=True): the serving-flag probe times a dense "
                "FFN block, so it is skipped for this MoE model; the given "
                f"fused_ffn={fused_ffn}, fused_qkv={fused_qkv} stand",
                stacklevel=2)
        elif auto:
            picks = autotune_serving_flags(
                cfg, params["blocks"][0], format_cls, rows=auto_rows, a8=a8,
                kernel=kernel, cache_path=cache_path, device=device,
                **fmt_kwargs)
            fused_ffn, fused_qkv = picks["fused_ffn"], picks["fused_qkv"]

        return lm_from_jax_params(cfg, params, a8=a8, fused_qkv=fused_qkv,
                                  fused_ffn=fused_ffn, device=device,
                                  format_cls=format_cls, kernel=kernel,
                                  head_dtype=head_dtype,
                                  with_transpose=with_transpose, **fmt_kwargs)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(torch.float32)

    def _head(self, x):
        """Tied-embedding logits head: a plain f32 matmul, or bf16 operands
        into f32 sums and f32 logits (``torch.mm(..., out_dtype=f32)`` on the
        card; on the CPU, which has no kernel for that, both operands
        upcast: a bf16 product is exact in f32)."""
        if self.embed.dtype == torch.float32:
            return torch.einsum("btd,vd->btv", x, self.embed)
        B, T, d = x.shape
        a = x.reshape(B * T, d).to(self.embed.dtype)
        if a.is_cuda:
            y = torch.mm(a, self.embed.t(), out_dtype=torch.float32)
        else:
            y = a.to(torch.float32) @ self.embed.to(torch.float32).t()
        return y.reshape(B, T, -1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full causal forward: ``tokens (B, T) -> logits (B, T, vocab)``."""
        x = self._embed(tokens)
        for block in self.blocks:
            x = block(x)
        return self._head(rms_norm(x, self.norm_out))

    def prefill(self, tokens: torch.Tensor, caches, start=None):
        """Prompt prefill: ``tokens (B, T0) -> (logits (B, T0, vocab),
        caches)``, the caches filled at positions 0..T0-1; with ``start``
        (an int or a 0-d tensor) one chunk of a longer prompt at positions
        ``start..start+T0-1`` (:func:`chunked_prefill`).

        MoE caveat: an expert's capacity comes from the tokens of the call
        (S = B * T0 here, S = B in a decode step), so the prefill equals T0
        decode steps only where ``moe_capacity_factor`` is large enough
        that routing binds in neither (``docs/serving.md``)."""
        B, T = tokens.shape
        x = self._embed(tokens)
        for block, cache in zip(self.blocks, caches):
            lin = (lambda b_: lambda n, z: b_.linears[n](
                z.reshape(B * T, -1)).reshape(B, T, -1))(block)
            ffn, qkv = _fused_hooks(block, B * T, lambda z: (B, T))
            x, _ = _block_prefill(self.cfg.head_tuple, lin, block.norm_attn,
                                  block.norm_ffn, x, cache, ffn=ffn, qkv=qkv,
                                  start=start, window=self.cfg.window)
        return self._head(rms_norm(x, self.norm_out)), caches

    def decode_step(self, tokens: torch.Tensor, caches, pos):
        """``tokens (B,) -> (logits (B, vocab), caches)`` at position ``pos``:
        a Python int, or a 0-d int64 tensor on the model's device (what a
        captured step reads), with the same bits."""
        B = tokens.shape[0]
        x = self._embed(tokens)[:, None, :]
        for block, cache in zip(self.blocks, caches):
            lin = (lambda b_: lambda n, z: b_.linears[n](
                z.reshape(B, -1))[:, None, :])(block)
            ffn, qkv = _fused_hooks(block, B, lambda z: (B, 1))
            x, _ = _block_decode(self.cfg.head_tuple, lin, block.norm_attn,
                                 block.norm_ffn, x, cache, pos, ffn=ffn,
                                 qkv=qkv, window=self.cfg.window)
        return self._head(rms_norm(x, self.norm_out))[:, 0], caches


def _qat_lin(block):
    return lambda n, z: getattr(block, n)(z)


def _qat_ffn(block):
    """A QAT MoE block's FFN, its experts' output without the balance loss
    (None: the block's dense SwiGLU)."""
    return None if block.moe is None else (lambda h: block.moe(h)[0])


@torch.no_grad()
def lm_prefill(model: BitTransformerLM, tokens: torch.Tensor, caches,
               start=None):
    """QAT backend prompt prefill: ``tokens (B, T0) -> (logits (B, T0,
    vocab), caches)``, the caches filled at positions 0..T0-1 (with
    ``start``, one chunk at ``start..start+T0-1``); the counterpart of the
    JAX ``lm_prefill`` (``models/generate.py:309-332`` there), at f32 as
    that serves, on the exported model's block prefill; the MoE caveat of
    :meth:`ExportedTransformerLM.prefill` holds."""
    x = model.embed[tokens]
    for block, cache in zip(model.blocks, caches):
        x, _ = _block_prefill(model.cfg.head_tuple, _qat_lin(block),
                              block.norm_attn, block.norm_ffn, x, cache,
                              ffn=_qat_ffn(block), start=start,
                              window=model.cfg.window)
    x = rms_norm(x, model.norm_out)
    return torch.einsum("btd,vd->btv", x, model.embed), caches


@torch.no_grad()
def lm_decode_step(model: BitTransformerLM, tokens: torch.Tensor, caches,
                   pos):
    """QAT backend decode step: ``tokens (B,) -> (logits (B, vocab),
    caches)`` at position ``pos`` (the JAX ``lm_decode_step``,
    ``models/generate.py:335-353`` there)."""
    x = model.embed[tokens][:, None, :]
    for block, cache in zip(model.blocks, caches):
        x, _ = _block_decode(model.cfg.head_tuple, _qat_lin(block),
                             block.norm_attn, block.norm_ffn, x, cache, pos,
                             ffn=_qat_ffn(block), window=model.cfg.window)
    x = rms_norm(x, model.norm_out)
    return torch.einsum("btd,vd->btv", x, model.embed)[:, 0], caches


#: the serving flags' choices by name, as the JAX cache file stores them
FLAG_NAMES = {(False, False): "none", (True, False): "ffn",
              (False, True): "qkv", (True, True): "ffn_qkv"}


def _flags(name: str) -> dict:
    return {"fused_ffn": "ffn" in name, "fused_qkv": "qkv" in name}


@torch.no_grad()
def autotune_serving_flags(cfg: BitTransformerConfig, block_params: dict,
                           format_cls=TiledBitplane, *, rows: int = 1,
                           a8: bool = True, cache_len: int = 256,
                           min_seconds: float = 0.2, repeats: int = 2,
                           cache_path=None, verbose: bool = False,
                           builder=None, kernel=None, device="cuda",
                           **fmt_kwargs) -> dict:
    """Measure the serving fast-path flags for one block shape — the JAX
    ``autotune_serving_flags`` (``models/generate.py:506-610`` there).

    Builds the four variants of one :class:`ExportedTransformerBlock`
    (fused_ffn x fused_qkv; a fused FFN whose contract does not hold is
    skipped) from ``block_params`` (a JAX parameter block, numpy) or with
    ``builder(ffn, qkv)``, and times each one decode step at ``rows`` rows
    against a KV cache of ``cache_len`` positions, from a CUDA graph on the
    card (the host clock on the CPU); returns ``{"fused_ffn": bool,
    "fused_qkv": bool}`` of the fastest. The probe attends with the
    model's heads (``cfg.head_tuple``: GQA too, where the JAX probe passes
    ``cfg.n_heads`` and fails, ``models/generate.py:580`` there) and
    builds the blocks with ``kernel``. Memoized per (device type, format,
    d_model, n_heads, d_ff, rows, a8) in ``ops/autotune.py``'s memo and
    JSON file, whose key string is the JAX package's; K/V heads other than
    ``n_heads`` and a ``kernel`` other than None are appended to it
    (``kv_heads=8``, ``kernel=`` the JAX registry's name)."""
    from ternary_spgemm_tpu_torch.ops.autotune import (
        memoized, remember, time_call)
    from ternary_spgemm_tpu_torch.ops.api import jax_name
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    key = (dev.type, "servingflags",
           getattr(format_cls, "__name__", "builder"),
           cfg.d_model, cfg.n_heads, cfg.d_ff, rows, bool(a8))
    # what the JAX probe leaves out extends its key only where it differs
    # from what that probe runs, so the common key stays the JAX one
    if cfg.kv_heads != cfg.n_heads:
        key += (f"kv_heads={cfg.kv_heads}",)
    if kernel is not None:
        key += (f"kernel={jax_name(kernel)}",)
    same = lambda v: v
    hit = memoized(key, cache_path, same, same)
    if hit is not None:
        return _flags(hit)

    B = max(1, rows)
    cache = init_cache(cfg, B, cache_len, device=dev)[0]
    x1 = torch.zeros((B, 1, cfg.d_model), device=dev)
    best_name, best_t = "none", float("inf")
    for ffn, qkv in FLAG_NAMES:
        blk = (builder(ffn, qkv) if builder is not None else
               ExportedTransformerBlock.from_params(
                   cfg, block_params, format_cls, kernel=kernel,
                   fused_ffn=ffn, fused_qkv=qkv, a8=a8, device=dev,
                   with_transpose=False, **fmt_kwargs))
        if ffn and not blk._fused_ffn_applicable():
            continue

        def block_fn(x, bk=blk):
            lin = lambda n, z: bk.linears[n](z.reshape(B, -1))[:, None, :]
            f, q = _fused_hooks(bk, B, lambda z: (B, 1))
            return _block_decode(cfg.head_tuple, lin, bk.norm_attn,
                                 bk.norm_ffn, x, cache, cache_len - 1,
                                 ffn=f, qkv=q, window=cfg.window)[0]

        t = time_call(block_fn, x1, min_seconds=min_seconds, repeats=repeats,
                      graph=True)
        name = FLAG_NAMES[(ffn, qkv)]
        if verbose:
            print(f"serving flags {name}: {t * 1e6:.1f} us", flush=True)
        if t < best_t:
            best_name, best_t = name, t
    remember(key, best_name, cache_path, same)
    return _flags(best_name)


@torch.no_grad()
def chunked_prefill(lm: ExportedTransformerLM, tokens: torch.Tensor, caches,
                    chunk: int):
    """Prefill a long prompt ``(B, T0)`` in chunks of ``chunk`` tokens (the
    last may be shorter), each through ``lm.prefill(..., start=s)``: each
    chunk attends to everything the chunks before it cached, so the result
    is the unchunked prefill's, while the attention logits of one call take
    O(chunk * max_t) memory, not O(T0**2). Returns ``(the last chunk's
    logits (B, Tc, vocab), caches)``. The counterpart of the JAX
    ``chunked_prefill`` (``ternary_spgemm_tpu/models/generate.py:605-632``);
    here each chunk runs eagerly."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    logits = None
    for s in range(0, tokens.shape[1], chunk):
        logits, caches = lm.prefill(tokens[:, s:s + chunk], caches, start=s)
    return logits, caches


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniform draws ``u`` in [0, 1): ``-log(-log(u))``
    with ``u`` held at or above f32's smallest normal, as
    ``jax.random.gumbel`` draws it."""
    return -torch.log(-torch.log(torch.clamp_min(
        u, torch.finfo(torch.float32).tiny)))


def sample(logits: torch.Tensor, gumbel, temperature: float, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """Next tokens ``(B,)`` from ``logits (B, V)`` and Gumbel noise of the
    same shape — the JAX ``_make_sampler``
    (``ternary_spgemm_tpu/models/generate.py:635-657``). ``temperature <=
    0``: ``argmax(logits)``, the noise ignored (it may be None). Else the
    logits are divided by the temperature (an IEEE division), cut to the
    ``top_k`` largest (below the k-th largest -> -inf) and to the ``top_p``
    nucleus (sorted descending, f32 softmax and cumsum, a logit kept while
    the mass before it is under ``top_p``, so the first always is; below
    the least kept -> -inf), and the token is ``argmax(masked + gumbel)``:
    ``jax.random.categorical``'s Gumbel-max draw. Ties go to the first
    index, as in ``jnp.argmax``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = true_div(logits, temperature)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p and top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, sorted_l, torch.inf).amin(dim=-1,
                                                             keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return torch.argmax(logits + gumbel, dim=-1)


def draw_uniform(u: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``u`` with uniform [0, 1) draws from ``generator`` (never the
    global generator), in place: the noise of one sampled token."""
    if generator is None:
        raise ValueError("sampling draws from an explicit torch.Generator")
    return torch.rand(u.shape, generator=generator, out=u)


@torch.no_grad()
def generate(lm: ExportedTransformerLM, prompt: torch.Tensor, n_new: int, *,
             max_t=None, prefill: bool = True, cache_dtype=torch.float32,
             ring: bool = False, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, generator=None, graph=None):
    """Decode ``n_new`` tokens after ``prompt (B, T0)``; returns ``(B, T0 +
    n_new)`` tokens. ``prefill=True`` runs the prompt as one batched
    forward that fills the caches, then ``n_new - 1`` decode steps (the JAX
    scan also computes an n_new-th step whose token it discards);
    ``prefill=False`` feeds the prompt one token per step.

    Sampling, as in the JAX ``generate``: ``temperature=0`` is greedy (ties
    in the argmax go to the first index, as in ``jnp.argmax``); above 0
    each token is drawn by :func:`sample` at that temperature, cut to
    ``top_k`` and / or the ``top_p`` nucleus. The noise of each sampled
    token is one ``(B, vocab)`` uniform draw from ``generator``, a
    ``torch.Generator`` on the prompt's device (None: one seeded with 0,
    as the JAX package defaults to ``key(0)``); the global generator is
    never used. JAX folds its key with the position, so the two packages
    sample one distribution, not the same tokens.

    ``graph=None`` runs captured on a CUDA prompt and eagerly on a CPU one;
    ``graph=True`` raises on the CPU; ``graph=False`` is the eager loop.
    Captured (``models/graphs.py``): one CUDA graph of the prefill and one
    of the decode step, captured at the first call for each (B, T0,
    max_t, cache dtype, ring, prefill, sampler) and kept on ``lm``, then
    replayed; a capture that fails raises. Both loops draw the same noise
    in the same order, so one generator seed gives the same tokens.

    ``ring=True`` (sliding-window models): the caches are rings of
    ``window`` slots (:func:`init_cache`), whatever the generation's
    length. It needs ``cfg.window > 0``, and with the prefill a prompt that
    fits the window (``prefill=False`` feeds a longer one token by token,
    which evicts only keys no later query needs)."""
    B, T0 = prompt.shape
    if ring:
        if not lm.cfg.window:
            raise ValueError("generate(ring=True) requires cfg.window > 0")
        if prefill and T0 > lm.cfg.window:
            raise ValueError(
                f"generate(ring=True): prompt length {T0} exceeds the "
                f"window ({lm.cfg.window}); use prefill=False (stepwise "
                "feeding evicts legitimately) or prefill a full cache "
                "(ring prefill would evict keys its own queries need)")
    if graph is None:
        graph = prompt.is_cuda
    elif graph and not prompt.is_cuda:
        raise ValueError("generate(graph=True) replays CUDA graphs; the "
                         f"prompt is on {prompt.device}")
    if n_new <= 0:
        return prompt
    max_t = max_t or (T0 + n_new)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=prompt.device)
        generator.manual_seed(0)
    if graph:
        from ternary_spgemm_tpu_torch.models.graphs import captured

        loop = captured(lm, B, T0, max_t, cache_dtype=cache_dtype,
                        ring=ring, prefill=prefill, temperature=temperature,
                        top_k=top_k, top_p=top_p, device=prompt.device)
        return torch.cat([prompt, loop.run(prompt, n_new, generator).to(
            prompt.dtype)], dim=1)
    u = (torch.empty((B, lm.cfg.vocab), device=prompt.device)
         if temperature > 0.0 else None)

    def pick(logits):
        noise = (None if u is None
                 else gumbel_from_uniform(draw_uniform(u, generator)))
        return sample(logits, noise, temperature, top_k, top_p)

    caches = init_cache(lm.cfg, B, max_t, dtype=cache_dtype, ring=ring,
                        device=prompt.device)
    if prefill:
        logits, caches = lm.prefill(prompt, caches)
        cur = pick(logits[:, T0 - 1])
        out = [cur]
        for t in range(T0, T0 + n_new - 1):
            logits, caches = lm.decode_step(cur, caches, t)
            cur = pick(logits)
            out.append(cur)
        return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)],
                         dim=1)
    cur = torch.zeros((B,), dtype=prompt.dtype, device=prompt.device)
    gen = []
    for t in range(T0 + n_new - 1):
        tok = prompt[:, t] if t < T0 else cur
        logits, caches = lm.decode_step(tok, caches, t)
        cur = pick(logits).to(prompt.dtype)
        gen.append(cur)
    return torch.cat([prompt, torch.stack(gen[T0 - 1:], dim=1)], dim=1)
