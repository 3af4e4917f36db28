#!/usr/bin/env python
"""Serving fast paths: the fused SwiGLU FFN kernel and the merged-QKV
container on an exported transformer block, and letting measurement pick
them — the PyTorch + CUDA port's twin of ``examples/05_fused_serving.py``.

* ``fused_ffn=True`` — the whole SwiGLU FFN (gate and up, silu times up,
  the per-row int8 requantize, down) runs as one hand-written kernel
  (``csrc/swiglu.cu``): the W1.58-A8 path.
* ``fused_qkv=True`` — q/k/v merged into one ternary container over
  ``hstack(Wq, Wk, Wv)``: one SpMM instead of three.

Which wins depends on the shape, so the deployment API can measure:
``ExportedTransformerLM.from_params(..., auto=True)`` times the
combinations at the decode shape and applies the fastest
(``models/generate.py::autotune_serving_flags``).

Run:  python examples_torch/05_fused_serving.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = parser.parse_args()

import torch  # noqa: E402

from ternary_spgemm_tpu_torch.formats import TiledBitplane  # noqa: E402
from ternary_spgemm_tpu_torch.models import (  # noqa: E402
    BitTransformerBlock, BitTransformerConfig, BitTransformerLM,
    ExportedTransformerBlock, ExportedTransformerLM, jax_tree)
from ternary_spgemm_tpu_torch.utils.device import resolve_device  # noqa: E402

dev = resolve_device(args.device)
cfg = BitTransformerConfig(vocab=256, d_model=128, n_heads=4, d_ff=256,
                           n_layers=1)
gen = torch.Generator(device=dev).manual_seed(0)
params = jax_tree(BitTransformerBlock(cfg, generator=gen, device=dev))

# Export the same block two ways: plain, and with both serving fast paths.
# The flags are serving-only (they bypass the layers' backward) and fall
# back where their kernel contract is not met (trained-in FFN biases, ...).
plain = ExportedTransformerBlock.from_params(
    cfg, params, TiledBitplane, kernel="CudaTiledBitplane_i8", device=dev,
    with_transpose=False)
fast = ExportedTransformerBlock.from_params(
    cfg, params, TiledBitplane, kernel="CudaTiledBitplane_i8", device=dev,
    with_transpose=False, fused_ffn=True, fused_qkv=True)

x = torch.randn((1, 8, cfg.d_model), generator=gen, device=dev)
with torch.no_grad():
    y_plain, y_fast = plain(x), fast(x)
print(f"decode-shaped block forward: {tuple(y_fast.shape)}")
print(f"fused-vs-plain max |delta| = "
      f"{float((y_fast - y_plain).abs().max()):.4f} (the fused FFN applies "
      "the per-row A8 requantize, the deployed numeric regime, where the "
      "plain _i8 path floors raw activations)")
assert bool(torch.isfinite(y_fast).all())

# --- measured flag selection on a whole LM export -----------------------
lm_params = jax_tree(BitTransformerLM(cfg, generator=gen, device=dev))
lm = ExportedTransformerLM.from_params(
    cfg, lm_params, TiledBitplane, kernel="CudaTiledBitplane_i8", a8=True,
    with_transpose=False, auto=True, device=dev)   # <- flags by measurement
blk = lm.blocks[0]
print(f"auto-measured flags: fused_ffn={blk.fused_ffn} "
      f"fused_qkv={blk.qkv is not None}")
toks = torch.randint(0, cfg.vocab, (1, 4), generator=gen, device=dev)
with torch.no_grad():
    assert bool(torch.isfinite(lm(toks)).all())
print("OK")
