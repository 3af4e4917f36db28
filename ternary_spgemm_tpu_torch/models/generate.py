"""KV-cached autoregressive decoding — counterpart of
``ternary_spgemm_tpu/models/generate.py`` for the exported model.

* :func:`init_cache` — per-block ``(B, H, max_T, hd)`` K/V caches, f32 or
  int8 with per-(token, head) absmax scales;
* :class:`ExportedTransformerLM` — full forward, whole-prompt prefill that
  fills the caches, and the one-token decode step; every projection runs on
  the kernel registry;
* :func:`sample` — the JAX ``_make_sampler``'s temperature, top-k and
  top-p (nucleus) masking, then ``argmax(masked + gumbel)``;
* :func:`generate` — greedy or sampled decoding, with or without the
  prefill; on the card a captured prefill and captured decode steps
  (``models/graphs.py``), on the CPU the eager loop.

The decode position ``pos`` is a Python int or a 0-d int64 tensor on the
model's device (the captured step keeps it there and bumps it in place);
the two give the same bits. The JAX package is functional; here
:func:`_cache_put` writes the new rows into the cache tensors in place (no
copy of the cache per step) and returns the same dict. Ring caches, chunked
prefill, the bf16 head and serving-flag autotuning come in later slices of
the port.
"""

from __future__ import annotations

import torch
from torch import nn

from ternary_spgemm_tpu_torch.formats.base import as_f32
from ternary_spgemm_tpu_torch.ops.fused_ffn import true_div
from ternary_spgemm_tpu_torch.models.transformer import (
    F64,
    BitTransformerConfig,
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
               dtype=torch.float32, *, device=None):
    """Zeroed per-block caches: a list of ``{"k", "v"}: (B, H, max_T, hd)``;
    ``dtype=torch.int8`` adds ``k_scale``/``v_scale`` ``(B, H, max_T, 1)``
    f32 (4x smaller cache; scales applied outside the attention dots). With
    GQA, H is the KV-head count."""
    hd = cfg.d_model // cfg.n_heads
    shape = (batch, cfg.kv_heads, max_t, hd)
    caches = []
    for _ in range(cfg.n_layers):
        if dtype == torch.int8:
            caches.append({
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3] + (1,), device=device),
                "v_scale": torch.zeros(shape[:3] + (1,), device=device)})
        else:
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)})
    return caches


def _quant_rows(x: torch.Tensor):
    """Per-row absmax int8 quantization -> (int8, f32 scale). The eps comes
    after the division here (``max/127 + 1e-12``), as in the JAX package."""
    s = true_div(torch.amax(torch.abs(x), dim=-1, keepdim=True), 127.0) + 1e-12
    return torch.round(x / s).to(torch.int8), s


def _cache_put(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
               pos) -> dict:
    """Write (quantizing for int8 caches) rotated K/V rows at positions
    ``pos, pos + 1, ...`` (``pos`` an int or a 0-d tensor), in place."""
    idx = torch.arange(k_new.shape[2], device=k_new.device) + pos
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


def _prefill_attend(n_heads, q, k, v, cache, window: int = 0):
    """Whole-prompt causal attention (positions 0..T-1) that also fills the
    cache; attention reads through the cache, so prefill and stepwise decode
    use one formulation (int8 caches included)."""
    nq, nkv = _norm_heads(n_heads)
    B, T, d = q.shape
    hd = d // nq
    G = nq // nkv
    q = q.reshape(B, T, nq, hd).transpose(1, 2)
    kv = lambda z: z.reshape(B, T, nkv, hd).transpose(1, 2)
    k, v = kv(k), kv(v)
    q, k = rotary_embed(q), rotary_embed(k)
    cache = _cache_put(cache, k, v, 0)
    qg = q.reshape(B, nkv, G * T, hd)
    logits, combine = _cache_attn(qg, cache, T=T, hd_scale=hd ** -0.5)
    logits = logits.reshape(B, nkv, G, T, T)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    if window:
        qi = torch.arange(T, device=q.device)[:, None]
        mask = mask & (qi - torch.arange(T, device=q.device)[None, :] < window)
    logits = torch.where(mask[None, None, None], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1).reshape(B, nkv, G * T, T)
    out = combine(probs).to(torch.float32).reshape(B, nq, T, hd)
    return out.transpose(1, 2).reshape(B, T, d), cache


def _block_prefill(n_heads, lin, norm_attn, norm_ffn, x, cache, ffn=None,
                   qkv=None, window: int = 0):
    """One block over the whole prompt, filling its cache."""
    h = rms_norm(x, norm_attn)
    q, k, v = (qkv(h) if qkv is not None
               else (lin("wq", h), lin("wk", h), lin("wv", h)))
    attn, cache = _prefill_attend(n_heads, q, k, v, cache, window=window)
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
    container when present. ``bt(z)`` gives the (B, T) of 3-D activations."""
    ffn = qkv = None
    if block.fused_ffn and block._fused_ffn_applicable():
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
    """Ternary-backbone causal LM over exported blocks: f32 embeddings,
    tied f32 head. ``.to(device)`` moves every container."""

    def __init__(self, cfg: BitTransformerConfig, blocks, embed, norm_out):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(blocks)
        dev = self.blocks[0].norm_attn.device
        self.register_buffer("embed", as_f32(embed, dev))
        self.register_buffer("norm_out", as_f32(norm_out, dev))
        # The f32 head must run in full f32 on the card: TF32 keeps ~3
        # decimal digits and would move the greedy argmax. PyTorch's default is already False; it is set here so
        # that no ambient setting changes the model's numbers.
        torch.backends.cuda.matmul.allow_tf32 = False
        #: the captured generate loops (``models/graphs.py``) by their
        #: settings; their graphs point at this model's tensors where they
        #: lay at capture, so clear it after moving the model
        self._captured: dict = {}

    def _head(self, x):
        """Tied-embedding logits head, a plain f32 matmul."""
        return torch.einsum("btd,vd->btv", x, self.embed)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full causal forward: ``tokens (B, T) -> logits (B, T, vocab)``."""
        x = self.embed[tokens]
        for block in self.blocks:
            x = block(x)
        return self._head(rms_norm(x, self.norm_out))

    def prefill(self, tokens: torch.Tensor, caches):
        """Prompt prefill: ``tokens (B, T0) -> (logits (B, T0, vocab),
        caches)``, the caches filled at positions 0..T0-1."""
        B, T = tokens.shape
        x = self.embed[tokens]
        for block, cache in zip(self.blocks, caches):
            lin = (lambda b_: lambda n, z: b_.linears[n](
                z.reshape(B * T, -1)).reshape(B, T, -1))(block)
            ffn, qkv = _fused_hooks(block, B * T, lambda z: (B, T))
            x, _ = _block_prefill(self.cfg.head_tuple, lin, block.norm_attn,
                                  block.norm_ffn, x, cache, ffn=ffn, qkv=qkv,
                                  window=self.cfg.window)
        return self._head(rms_norm(x, self.norm_out)), caches

    def decode_step(self, tokens: torch.Tensor, caches, pos):
        """``tokens (B,) -> (logits (B, vocab), caches)`` at position ``pos``:
        a Python int, or a 0-d int64 tensor on the model's device (what a
        captured step reads), with the same bits."""
        B = tokens.shape[0]
        x = self.embed[tokens][:, None, :]
        for block, cache in zip(self.blocks, caches):
            lin = (lambda b_: lambda n, z: b_.linears[n](
                z.reshape(B, -1))[:, None, :])(block)
            ffn, qkv = _fused_hooks(block, B, lambda z: (B, 1))
            x, _ = _block_decode(self.cfg.head_tuple, lin, block.norm_attn,
                                 block.norm_ffn, x, cache, pos, ffn=ffn,
                                 qkv=qkv, window=self.cfg.window)
        return self._head(rms_norm(x, self.norm_out))[:, 0], caches


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
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             generator=None, graph=None):
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
    max_t, cache dtype, prefill, sampler) and kept on ``lm``, then
    replayed; a capture that fails raises. Both loops draw the same noise
    in the same order, so one generator seed gives the same tokens."""
    B, T0 = prompt.shape
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
                        prefill=prefill, temperature=temperature,
                        top_k=top_k, top_p=top_p, device=prompt.device)
        return torch.cat([prompt, loop.run(prompt, n_new, generator).to(
            prompt.dtype)], dim=1)
    u = (torch.empty((B, lm.cfg.vocab), device=prompt.device)
         if temperature > 0.0 else None)

    def pick(logits):
        noise = (None if u is None
                 else gumbel_from_uniform(draw_uniform(u, generator)))
        return sample(logits, noise, temperature, top_k, top_p)

    caches = init_cache(lm.cfg, B, max_t, dtype=cache_dtype,
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
