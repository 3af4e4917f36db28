"""The plain reference of the BitNet b1.58 configurations: the W1.58-A8
forward in float32 PyTorch, TF32 off, with no kernel, no cache and no
batching of the program.

The model, as the configuration files state it (each block; x is the
residual stream, f32):

    h      = rmsnorm(x) * norm_attn
    hq, s  = requant(h)                   per row: s = (max|h| + 1e-12) / 127,
                                          hq = round(h / s)
    q|k|v  = ((hq @ Wqkv) * s) * gamma
    q, k   = rope(q), rope(k)             per head, half-split pairs
    kq, ks = kvquant(k); vq, vs likewise  per (token, head): ks = max|k| / 127
                                          + 1e-12, kq = round(k / ks)
    a      = softmax((q . kq) * ks / sqrt(hd), causal) @ (vs * vq)
    x      = x + (requant(a) @ Wo) * (s_a * gamma)
    h      = rmsnorm(x) * norm_ffn;  hq, s = requant(h)
    g, u   = gamma * (s * (hq @ Wgate)), gamma * (s * (hq @ Wup))
    m      = (g * sigmoid(g)) * u;  mq, sm = requant(m)
    x      = x + (mq @ Wdown) * (sm * gamma)

then ``logits = (rmsnorm(x) * norm_out) @ embed.T``. The reductions that
end in a transcendental function or a division (the norms' mean square
and rsqrt, rope's cos and sin, the attention, the sigmoid) are evaluated
in float64 and rounded once to float32; every other operation is the
float32 operation in the order written above. The integer products are
exact in float32 (|sum| <= 127 * K < 2**24).

The keys and values pass through int8 as the configuration's int8 cache
holds them: a decode step of the program reads a cache, and this forward
quantizes every key and value row alike, so the two attend to the same
numbers. The reference runs the whole sequence at once (the prompt and
the served tokens before the last), draws each block's weights again from
the seed (``inputs.py``) when it reaches it, and frees them after it.

The sampler (``cutoff``, ``gumbel``): the logits divided by the
temperature (an IEEE division), cut to the ``top_k`` largest and to the
``top_p`` nucleus (sorted descending, f32 softmax and cumsum, a logit kept
while the mass before it is under ``top_p``), and the token the argmax of
the kept logits plus the Gumbel noise ``-log(-log(u))`` of the request's
uniform draws ``u``.

``LOWER`` names the controls that put this reference, in a precision
below the configuration's, in the program's place: the head's operands
rounded to bf16 or to TF32 (f32 sums), or the attention in f32.
"""

from __future__ import annotations

import torch

from benchmark.inputs import GAMMA, embedding, final_norm, layer_weights

F32, F64 = torch.float32, torch.float64
RMS_EPS = 1e-6
ROPE_BASE = 10000.0
#: bytes of float64 attention logits one chunk of sequences may take
ATTN_CHUNK_BYTES = 2 << 30
#: the lower-precision variants of :func:`logits`
LOWER = ("head_bf16", "head_tf32", "attention_f32")


def tdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xd = x.to(F64)
    var = torch.mean(torch.square(xd), dim=-1, keepdim=True)
    return (xd * torch.rsqrt(var + RMS_EPS)).to(F32) * scale


def requant(h: torch.Tensor):
    """Per-row absmax int8 activations -> (integer-valued f32, scale)."""
    rowmax = torch.amax(torch.abs(h), dim=-1, keepdim=True) + 1e-12
    s = tdiv(rowmax, 127.0)
    return torch.round(h / s), s


def kvquant(x: torch.Tensor):
    """Per-(token, head) absmax int8 rows of the cache -> (integer-valued
    f32, scale)."""
    s = tdiv(torch.amax(torch.abs(x), dim=-1, keepdim=True), 127.0) + 1e-12
    return torch.round(x / s), s


def rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of ``x (..., S, hd)`` at positions 0..S-1."""
    S, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    freqs = (ROPE_BASE ** (-torch.arange(0, half, dtype=F64, device=x.device)
                           / half)).to(F32)
    pos = torch.arange(S, dtype=F32, device=x.device)
    ang = (pos[:, None] * freqs[None, :]).to(F64)
    cos, sin = torch.cos(ang).to(F32), torch.sin(ang).to(F32)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32's 10-bit mantissa, half away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniform draws in [0, 1), each held at or above
    f32's smallest normal."""
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(F32).tiny)))


def cutoff(scaled: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """The least of the logits ``scaled (..., vocab)`` (already divided by
    the temperature) that the sampler keeps, per row, ``(..., 1)``."""
    cut = torch.full(scaled.shape[:-1] + (1,), -torch.inf,
                     dtype=scaled.dtype, device=scaled.device)
    if top_k:
        cut = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < cut, -torch.inf, scaled)
    if top_p and top_p < 1.0:
        ordered = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(ordered, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cut = torch.where(keep, ordered, torch.inf).amin(dim=-1,
                                                         keepdim=True)
    return cut


def ternary_product(xq: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``xq @ W`` of integer-valued f32 rows and a ternary int8 matrix, in
    f32 (exact)."""
    return xq @ W.to(F32)


def attention(q, k, v, model: dict, dt=F64) -> torch.Tensor:
    """Causal attention of ``(n, S, d)`` f32 q, k, v over int8 keys and
    values -> ``(n, S, d)`` f32, its products and softmax in ``dt``."""
    n, S, d = q.shape
    H, Hk, hd = model["heads"], model["kv_heads"], model["hd"]
    G = H // Hk
    q = rope(q.reshape(n, S, H, hd).transpose(1, 2))
    k = rope(k.reshape(n, S, Hk, hd).transpose(1, 2))
    v = v.reshape(n, S, Hk, hd).transpose(1, 2)
    kq, ks = kvquant(k)
    vq, vs = kvquant(v)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    out = torch.empty((n, H, S, hd), dtype=F32, device=q.device)
    step = max(1, ATTN_CHUNK_BYTES // (H * S * S * 8))
    for a in range(0, n, step):
        b = min(n, a + step)
        qg = q[a:b].reshape(b - a, Hk, G, S, hd).to(dt)
        logits = torch.einsum("bngqd,bnkd->bngqk", qg, kq[a:b].to(dt)) \
            * hd ** -0.5
        logits = logits * ks[a:b, :, None, None, :, 0].to(dt)
        logits = torch.where(mask, logits, -torch.inf)
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bngqk,bnkd->bngqd",
                         probs * vs[a:b, :, None, None, :, 0].to(dt),
                         vq[a:b].to(dt))
        out[a:b] = o.reshape(b - a, H, S, hd).to(F32)
        del qg, logits, probs, o
    return out.transpose(1, 2).reshape(n, S, d)


def block(x: torch.Tensor, w: dict, model: dict, dt=F64) -> torch.Tensor:
    """One block over ``x (n, S, d)`` (the module docstring's equations)."""
    n, S, d = x.shape
    kvw = model["kv_width"]
    h = rms_norm(x, w["norm_attn"]).reshape(n * S, d)
    hq, s = requant(h)
    qkv = (ternary_product(hq, w["wqkv"]) * s) * GAMMA
    q, k, v = (z.reshape(n, S, -1) for z in
               (qkv[:, :d], qkv[:, d:d + kvw], qkv[:, d + kvw:]))
    del h, hq, qkv
    a = attention(q, k, v, model, dt).reshape(n * S, d)
    del q, k, v
    aq, sa = requant(a)
    x = x + (ternary_product(aq, w["wo"]) * (sa * GAMMA)).reshape(n, S, d)
    del a, aq
    h = rms_norm(x, w["norm_ffn"]).reshape(n * S, d)
    hq, s = requant(h)
    g = GAMMA * (s * ternary_product(hq, w["w_gate"]))
    u = GAMMA * (s * ternary_product(hq, w["w_up"]))
    m = (g * torch.sigmoid(g.to(F64)).to(F32)) * u
    del h, hq, g, u
    mq, sm = requant(m)
    return x + (ternary_product(mq, w["w_down"]) * (sm * GAMMA)).reshape(
        n, S, d)


@torch.no_grad()
def logits(model: dict, seed: int, tokens: torch.Tensor, first: int,
           device, lower=None) -> torch.Tensor:
    """The reference logits of ``tokens (n, S)`` at positions ``first`` ..
    ``S - 1``: ``(n, S - first, vocab)`` f32, each position's logits over
    the token that follows it; ``lower``, one of :data:`LOWER`, for a
    control."""
    if lower not in (None, *LOWER):
        raise ValueError(f"no variant {lower!r}; there are {LOWER}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    embed = embedding(model, seed, device)
    x = embed[tokens.to(device)]
    for layer in range(model["layers"]):
        w = layer_weights(model, seed, layer, device)
        x = block(x, w, model, F32 if lower == "attention_f32" else F64)
        del w
    x = rms_norm(x[:, first:], final_norm(model, seed, device))
    if lower == "head_bf16":
        x, embed = (t.to(torch.bfloat16).to(F32) for t in (x, embed))
    elif lower == "head_tf32":
        x, embed = tf32(x), tf32(embed)
    return x @ embed.t()
