"""BitNet-b1.58 absmean ternarization — counterpart of the quantizer in
``ternary_spgemm_tpu/models/bitlinear.py`` (QAT layers come in a later
slice of the port)."""

from __future__ import annotations

import torch


def ternary_quantize(W: torch.Tensor, eps: float = 1e-6):
    """BitNet-b1.58 absmean ternarization -> (Wq in {-1,0,+1} f32, gamma).

    ``gamma = mean|W| + eps``, ``Wq = clip(round(W / gamma), -1, 1)``
    (f32 throughout, round half to even, as in the JAX package)."""
    W = torch.as_tensor(W, dtype=torch.float32)
    gamma = torch.mean(torch.abs(W)) + eps
    Wq = torch.clamp(torch.round(W / gamma), -1.0, 1.0)
    return Wq, gamma
