"""The BitNet b1.58 configurations on the program: the serving LM built
from the seed's inputs through the port's public constructors, the
captured generate loop that keeps the logits it emits, and the bounds of
the model's work.

The build is the port's serving export (``models/serving.py``): every
projection an A8 ``ExportedBitLinear`` over ``TiledBitplane``, the merged
QKV and the fused SwiGLU (both fast paths), no transposes, the f32 tied
head (``head_dtype=torch.bfloat16`` is the program's own lower-precision
head, the control of ``control.py``).
"""

from __future__ import annotations

import weakref

import torch

from benchmark import bounds, inputs, reference
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.models.exported import ExportedBitLinear
from ternary_spgemm_tpu_torch.models.generate import ExportedTransformerLM
from ternary_spgemm_tpu_torch.models.graphs import (
    CapturedGenerate,
    GenerateLoop,
)
from ternary_spgemm_tpu_torch.models.transformer import (
    BitTransformerConfig,
    ExportedTransformerBlock,
    MergedQKV,
)

reference_logits = reference.logits


def build_lm(model: dict, seed: int, device,
             head_dtype=None) -> ExportedTransformerLM:
    cfg = BitTransformerConfig(
        vocab=model["vocab"], d_model=model["d"], n_heads=model["heads"],
        n_kv_heads=model["kv_heads"], d_ff=model["ff"],
        n_layers=model["layers"])
    gamma = inputs.GAMMA

    def lin(W):
        return ExportedBitLinear.from_dense(
            W, TiledBitplane, gamma=gamma, bias=torch.zeros(W.shape[1]),
            a8=True, with_transpose=False)

    blocks = []
    for layer in range(model["layers"]):
        w = inputs.layer_weights(model, seed, layer, device)
        n3 = w["wqkv"].shape[1]
        qkv = MergedQKV(TiledBitplane.from_dense(w["wqkv"]),
                        torch.full((n3,), gamma), torch.zeros(n3))
        linears = {n: lin(w[n]) for n in ("wo", "w_gate", "w_up", "w_down")}
        blocks.append(ExportedTransformerBlock(
            cfg, linears, w["norm_attn"], w["norm_ffn"], fused_ffn=True,
            qkv=qkv, a8=True))
        del w
    return ExportedTransformerLM(
        cfg, blocks, inputs.embedding(model, seed, device),
        inputs.final_norm(model, seed, device), head_dtype=head_dtype)


class _KeepLogits:
    """A generate loop whose bodies also store the logits each emits:
    ``kept[:, j]`` holds the logits that chose served token ``j`` (the
    prefill's last position for ``j = 0``, the step at position ``T0 + j -
    1`` after it). One ``index_copy_`` a body; nothing else changes."""

    def __init__(self, lm, batch, prompt_len, max_t, *, new_tokens, device,
                 **kwargs):
        self.kept = torch.zeros((batch, new_tokens, lm.cfg.vocab),
                                device=device)
        super().__init__(lm, batch, prompt_len, max_t, device=device,
                         **kwargs)

    def _emit(self, logits, at):
        super()._emit(logits, at)
        self.kept.index_copy_(1, at - self.prompt_len, logits[:, None, :])


class KeptLoop(_KeepLogits, GenerateLoop):
    pass


class KeptCaptured(_KeepLogits, CapturedGenerate):
    pass


def generate_loop(lm, traffic: dict, device):
    """The cell's one captured loop (eager on the CPU) for its batch,
    prompt length, ``max_t`` and sampler, with an int8 cache."""
    kw = dict(new_tokens=traffic["new_tokens"], device=device,
              cache_dtype=torch.int8, prefill=True,
              temperature=traffic["temperature"], top_k=traffic["top_k"],
              top_p=traffic["top_p"])
    args = (traffic["batch"], traffic["prompt_len"], traffic["max_t"])
    if torch.device(device).type == "cuda":
        return KeptCaptured(weakref.proxy(lm), *args, **kw)
    return KeptLoop(lm, *args, **kw)


def _matrices(model: dict) -> list:
    """A block's ternary ``(K, N)`` matrices, in :data:`inputs.MATRICES`'s
    order."""
    return [f(model["d"], model["kv_width"], model["ff"])
            for _, f in inputs.MATRICES]


def _layer_products(model: dict, rows: int) -> bounds.Work:
    return sum((bounds.product(rows, K, N, inputs.DENSITY)
                for K, N in _matrices(model)), bounds.Work())


def _layer_weights(model: dict) -> bounds.Work:
    return sum((bounds.weights(K, N, inputs.DENSITY)
                for K, N in _matrices(model)), bounds.Work())


def _head(model: dict, rows: int) -> bounds.Work:
    """The tied f32 table read once (it also serves the embedding's rows)
    and the logits of ``rows`` rows."""
    d, V = model["d"], model["vocab"]
    return bounds.Work(2.0 * rows * d * V, V * d * 4 + rows * V * 4)


def kernel_seconds(model: dict, rows: int) -> float:
    """The summed bounds of the port's ternary kernel calls in one forward
    over ``rows`` rows: a layer's merged QKV, output projection and fused
    SwiGLU, each its own call."""
    d, ff, kvw, p = model["d"], model["ff"], model["kv_width"], \
        inputs.DENSITY
    layer = (bounds.projection(rows, d, d + 2 * kvw, p).seconds()
             + bounds.projection(rows, d, d, p).seconds()
             + bounds.swiglu(rows, d, ff, p).seconds())
    return model["layers"] * layer


def decode_work(model: dict, batch: int, seen: int) -> bounds.Work:
    """One decode step of ``batch`` requests that each attend ``seen``
    positions (their new one included)."""
    L = model["layers"]
    layer = (_layer_products(model, batch) + _layer_weights(model)
             + bounds.attention(batch * seen, model["heads"], model["hd"])
             + bounds.kv_rows(batch * seen, model["kv_heads"], model["hd"]))
    return layer * L + _head(model, batch) + bounds.Work(0.0, batch * 8)


def prefill_work(model: dict, batch: int, prompt_len: int) -> bounds.Work:
    """The prefill of ``batch`` prompts of ``prompt_len`` tokens: causal
    attention, the cache rows written, the head at the last position."""
    L, T = model["layers"], prompt_len
    layer = (_layer_products(model, batch * T) + _layer_weights(model)
             + bounds.attention(batch * T * (T + 1) // 2, model["heads"],
                                model["hd"])
             + bounds.kv_rows(batch * T, model["kv_heads"], model["hd"]))
    return layer * L + _head(model, batch) + bounds.Work(0.0, batch * T * 8)
