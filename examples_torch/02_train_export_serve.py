#!/usr/bin/env python
"""Train a ternary MLP (BitNet-style QAT), export, and serve via a kernel —
the PyTorch + CUDA port's twin of ``examples/02_train_export_serve.py``.

  1. QAT-train a ``TernaryMLP``: latent f32 weights, a ternary forward
     with a straight-through estimator (BitNet b1.58 absmean quantization),
     ``torch.optim.Adam``.
  2. Export each layer's quantized weights into a registered container.
  3. Serve through the kernel registry, the path the benchmarks time, in
     two modes: f32 activations over ``DenseTernary`` (exact against the
     QAT forward) and the BitNet W1.58-A8 path, per-token int8 activations
     over ``TiledBitplane`` (2 bits a weight of device-memory traffic).

Run:  python examples_torch/02_train_export_serve.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
parser.add_argument("--steps", type=int, default=200)
args = parser.parse_args()

import torch  # noqa: E402

from ternary_spgemm_tpu_torch.formats import (  # noqa: E402
    DenseTernary, TiledBitplane)
from ternary_spgemm_tpu_torch.models import (  # noqa: E402
    TernaryMLP, apply_exported, apply_exported_a8, export_layer,
    make_train_step, mse_loss)
from ternary_spgemm_tpu_torch.utils.device import resolve_device  # noqa: E402

dev = resolve_device(args.device)

# 1. QAT training on a toy regression task -------------------------------
gen = torch.Generator(device=dev).manual_seed(0)
model = TernaryMLP([64, 256, 8], generator=gen, device=dev)
step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=3e-3))

x = torch.randn((512, 64), generator=gen, device=dev)
w_true = torch.randn((64, 8), generator=gen, device=dev) / 8.0
y = torch.tanh(x @ w_true)

print(f"initial loss: {float(mse_loss(model, x, y)):.4f}")
for _ in range(args.steps):
    loss = step(x, y)
print(f"final loss:   {float(loss):.4f} after {args.steps} steps")

# 2. Export each layer into ternary containers ----------------------------
layers = [layer.state_dict() for layer in model.layers]
exact = [export_layer(p, DenseTernary) for p in layers]
bitp = [export_layer(p, TiledBitplane) for p in layers]
print(f"exported {len(exact)} layers: DenseTernary "
      f"{sum(f.size_bytes() for f, _, _, _ in exact) / 1e3:.1f} kB, "
      f"TiledBitplane {sum(f.size_bytes() for f, _, _, _ in bitp) / 1e3:.1f}"
      " kB (2 bits/weight)")


# 3. Serve through the kernel registry ------------------------------------
def serve(h, frozen, apply_fn):
    for fmt, gamma, bias, alpha in frozen:
        # alpha is the layer's PReLU slope, fused into the kernel epilogue
        h = apply_fn(h, fmt, gamma, bias, alpha)
    return h


with torch.no_grad():
    y_qat = model(x)                # QAT forward (latent weights, STE path)

    # (a) f32 activations, exact kernels: parity with training
    y_f32 = serve(x, exact, apply_exported)
    err = float(torch.max(torch.abs(y_qat - y_f32)))
    print(f"f32 serving (DenseTernary):      max |err| vs QAT = {err:.2e}")
    assert err < 1e-4

    # (b) BitNet W1.58-A8: int8 activations over 2-bit weights; the only
    # approximation is the per-token activation rounding
    y_a8 = serve(x, bitp, apply_exported_a8)
    rel = float(torch.max(torch.abs(y_qat - y_a8))
                / (torch.max(torch.abs(y_qat)) + 1e-9))
    print(f"a8 serving  (TiledBitplane):     max rel err vs QAT = {rel:.2e}")
    assert rel < 0.05
