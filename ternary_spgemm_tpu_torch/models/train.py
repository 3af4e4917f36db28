"""Training loop pieces for the ternary MLP — counterpart of
``ternary_spgemm_tpu/models/train.py`` (``mse_loss``, ``make_train_step``)
with ``torch.optim`` in optax's place. The mesh-sharded steps of that
module come with the port's parallel layer (ROADMAP A8)."""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.models.bitlinear import TernaryMLP


def mse_loss(model: TernaryMLP, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    return torch.mean((model(x) - y) ** 2)


def make_train_step(model: TernaryMLP, optimizer):
    """``step(x, y) -> loss``: one ``torch.optim`` step of ``optimizer``
    (over ``model``'s parameters) on :func:`mse_loss`, the parameters
    updated in place; the loss returned is the one before the update, as
    the JAX step returns it."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = mse_loss(model, x, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
