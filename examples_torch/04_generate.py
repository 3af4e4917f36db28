#!/usr/bin/env python
"""KV-cached autoregressive generation from an exported ternary LM — the
PyTorch + CUDA port's twin of ``examples/04_generate.py``.

A QAT ``BitTransformerLM`` is frozen into ternary containers
(``ExportedTransformerLM.from_params``) and decoded with a KV cache:
batched prompt prefill, then one token a step (on the card, a captured
CUDA graph a step). Shown:

  * ``prefill=True``  — one (B, T0) forward fills the caches;
  * ``cache_dtype=torch.int8`` — a 4x smaller KV cache, per-row absmax;
  * exported containers — inference runs through the SpMM kernel registry.

Run:  python examples_torch/04_generate.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
parser.add_argument("--new-tokens", type=int, default=12)
args = parser.parse_args()

import torch  # noqa: E402

from ternary_spgemm_tpu_torch.formats import DenseTernary  # noqa: E402
from ternary_spgemm_tpu_torch.models import (  # noqa: E402
    BitTransformerConfig, BitTransformerLM, ExportedTransformerLM, generate,
    jax_tree, lm_decode_step, lm_prefill, init_cache)
from ternary_spgemm_tpu_torch.utils.device import resolve_device  # noqa: E402

dev = resolve_device(args.device)
cfg = BitTransformerConfig(vocab=256, d_model=128, n_heads=4, d_ff=256,
                           n_layers=2)
gen = torch.Generator(device=dev).manual_seed(0)
model = BitTransformerLM(cfg, generator=gen, device=dev)  # untrained toy
prompt = torch.randint(0, cfg.vocab, (2, 8), generator=gen, device=dev)
T0, n_new = prompt.shape[1], args.new_tokens

with torch.no_grad():
    # Greedy decode from the QAT model (latent weights) ...
    caches = init_cache(cfg, 2, T0 + n_new, device=dev)
    logits, caches = lm_prefill(model, prompt, caches)
    cur, qat = logits[:, -1].argmax(-1), []
    for t in range(T0, T0 + n_new):
        qat.append(cur)
        if t < T0 + n_new - 1:
            logits, caches = lm_decode_step(model, cur, caches, t)
            cur = logits.argmax(-1)
    y_qat = torch.cat([prompt, torch.stack(qat, dim=1)], dim=1)

# ... and from the exported frozen-container model: the same tokens, the
# forward through the ternary SpMM kernels (2-8 bits a weight in memory).
exported = ExportedTransformerLM.from_params(cfg, jax_tree(model),
                                             DenseTernary, device=dev)
y_exp = generate(exported, prompt, n_new, prefill=True)

# int8 KV cache: 4x smaller cache, negligible drift at these scales
y_kv8 = generate(exported, prompt, n_new, prefill=True,
                 cache_dtype=torch.int8)

print("prompt:         ", prompt[0].tolist())
print("QAT decode:     ", y_qat[0, T0:].tolist())
print("exported decode:", y_exp[0, T0:].tolist())
print("int8-KV decode: ", y_kv8[0, T0:].tolist())
assert torch.equal(y_qat, y_exp)
