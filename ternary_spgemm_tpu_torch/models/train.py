"""Training loop pieces: loss, optimizer step and mesh-sharded training —
counterpart of ``ternary_spgemm_tpu/models/train.py`` with ``torch.optim``
in optax's place and DTensor in GSPMD's.

The sharded steps lay the parameters out as DTensors on a (data x model)
mesh (Megatron-style tensor parallelism from the spec functions, the batch
split along ``data``) and run the model's own forward on them: DTensor
propagates the sharding op by op and inserts the collectives, as GSPMD
does for the JAX step, so each step computes what the unsharded step
computes (the gradients of replicated parameters summed over the batch
shards: data-parallel averaging). ``torch.optim`` updates the DTensor
parameters in place.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ternary_spgemm_tpu_torch.models.bitlinear import TernaryMLP
from ternary_spgemm_tpu_torch.parallel.sharding import placements


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


def param_specs(model: TernaryMLP, axis: str = "model") -> Dict[str, tuple]:
    """Megatron-style alternating TP specs of the BitLinear stack, keyed by
    ``state_dict()`` path: even layers split output features (column
    parallel), odd layers input features (row parallel), so activations
    stay split between the pair and one reduce falls per pair."""
    specs = {}
    for i, layer in enumerate(model.layers):
        col = i % 2 == 0
        specs[f"layers.{i}.w"] = (None, axis) if col else (axis, None)
        specs[f"layers.{i}.b"] = (axis,) if col else ()
        if layer.prelu:
            specs[f"layers.{i}.alpha"] = specs[f"layers.{i}.b"]
    return specs


def param_shardings(model: TernaryMLP, mesh: DeviceMesh,
                    axis: str = "model") -> Dict[str, list]:
    """:func:`param_specs` as DTensor placements on ``mesh``."""
    return {k: placements(mesh, s)
            for k, s in param_specs(model, axis).items()}


def zero1_spec(spec: tuple, shape, mesh: DeviceMesh,
               data_axis: str) -> tuple:
    """A moment's spec under ZeRO-1: its parameter's spec with the first
    free dim that splits evenly over ``data_axis`` split over it too (the
    parameter's spec where none does), JAX's ``_zero1_sharding``."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    dp = mesh.size(mesh.mesh_dim_names.index(data_axis))
    for i, ax in enumerate(spec):
        if ax is None and len(shape) and shape[i] % dp == 0 \
                and shape[i] >= dp:
            spec[i] = data_axis
            break
    return tuple(spec)


def _moment(v, p: torch.Tensor) -> bool:
    """A state entry that mirrors its parameter (Adam's moments, SGD's
    momentum), not a scalar such as Adam's step."""
    return isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(p.shape) \
        and v.dim() > 0


def _owner(model: nn.Module, path: str):
    mod, _, leaf = path.rpartition(".")
    return (model.get_submodule(mod) if mod else model), leaf


class _Placer:
    """Lays a model's parameters out as DTensors by ``specs`` (one per
    ``state_dict()`` path), swaps them into ``optimizer`` and keeps every
    moment at ``moment_spec(path, moment)``."""

    def __init__(self, model: nn.Module, optimizer, mesh: DeviceMesh,
                 specs: Dict[str, tuple],
                 moment_spec: Callable[[str, torch.Tensor], tuple]):
        self.model, self.optimizer, self.mesh = model, optimizer, mesh
        self.specs, self.moment_spec = specs, moment_spec

    def _layout(self, t: torch.Tensor, spec) -> DTensor:
        pl = placements(self.mesh, spec)
        if isinstance(t, DTensor):
            return t if list(t.placements) == pl else \
                t.redistribute(self.mesh, pl)
        return distribute_tensor(t.detach(), self.mesh, pl)

    def params(self) -> None:
        swap = {}
        for path, p in list(self.model.named_parameters()):
            if path not in self.specs:
                raise KeyError(f"no sharding spec for parameter {path!r}")
            spec = self.specs[path]
            if isinstance(p, DTensor) and \
                    list(p.placements) == placements(self.mesh, spec):
                continue
            new = nn.Parameter(self._layout(p.detach(), spec),
                               requires_grad=p.requires_grad)
            mod, leaf = _owner(self.model, path)
            setattr(mod, leaf, new)
            swap[p] = new
        for group in self.optimizer.param_groups:
            group["params"] = [swap.get(p, p) for p in group["params"]]
        for old, new in swap.items():
            if old in self.optimizer.state:
                self.optimizer.state[new] = self.optimizer.state.pop(old)
        self.moments(prime=True)

    def moments(self, prime: bool = False) -> None:
        """Every moment to its spec; with ``prime``, Adam's (and AdamW's)
        state created now, as ``optax.adam``'s init creates it, so that its
        moments are laid out before the first step."""
        adam = isinstance(self.optimizer, (torch.optim.Adam,
                                           torch.optim.AdamW))
        names = {p: n for n, p in self.model.named_parameters()}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                state = self.optimizer.state[p]
                if prime and adam and not state:
                    keys = ["exp_avg", "exp_avg_sq"] + (
                        ["max_exp_avg_sq"] if group["amsgrad"] else [])
                    state["step"] = (
                        torch.zeros((), dtype=torch.float32,
                                    device=p.device)
                        if group["capturable"] or group["fused"]
                        else torch.tensor(0.0, dtype=torch.float32))
                    for k in keys:
                        state[k] = torch.zeros_like(p.detach())
                for k, v in list(state.items()):
                    if _moment(v, p):
                        state[k] = self._layout(
                            v, self.moment_spec(names[p], v))


def _dtensor(t, mesh: DeviceMesh, spec) -> DTensor:
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements(mesh, spec))
    return distribute_tensor(torch.as_tensor(t), mesh, placements(mesh, spec))


def _sharded_step(base_step, placer: _Placer, zero1: bool):
    def step(*batch):
        with implicit_replication():
            loss = base_step(*batch)
        if zero1:
            placer.moments()
        return loss.full_tensor() if isinstance(loss, DTensor) else loss

    return step


def make_sharded_lm_train_step(model, optimizer, mesh: DeviceMesh, *,
                               data_axis: str = "data",
                               model_axis: str = "model",
                               sequence_parallel: bool = False,
                               zero1: bool = False):
    """The transformer-LM train step SPMD over a (data x model) mesh.

    The batch rides ``data_axis``; the parameters follow
    :func:`~ternary_spgemm_tpu_torch.models.transformer.lm_param_shardings`
    (Megatron TP, and expert parallelism for MoE configurations, over
    ``model_axis``). With ``sequence_parallel`` the ``(B, T, d)``
    activations between blocks are redistributed to ``(data, model,
    None)`` through the model's ``constrain`` hook: the sequence splits
    over the TP ranks, and the all-gather / reduce-scatter pair of Megatron
    sequence parallelism replaces activations replicated per TP rank. With
    ``zero1`` every moment also splits one free dim over ``data_axis``
    (:func:`zero1_spec`) and is put back there after every step.

    Returns ``(step, place)``: ``place(tokens)`` lays out the model's
    parameters (swapped into ``optimizer``), its moments and the tokens
    (along ``data_axis``) and returns the tokens' DTensor; ``step(tokens)``
    runs one step and returns the loss (a plain tensor, the same on every
    rank)."""
    from ternary_spgemm_tpu_torch.models.transformer import (
        lm_param_specs, make_lm_train_step)

    specs = lm_param_specs(model, model_axis)
    constrain = None
    if sequence_parallel:
        act = placements(mesh, (data_axis, model_axis, None))
        constrain = lambda z: z.redistribute(mesh, act) \
            if isinstance(z, DTensor) else z
    moment_spec = (lambda n, v: zero1_spec(specs[n], v.shape, mesh,
                                           data_axis)) if zero1 \
        else (lambda n, v: specs[n])
    placer = _Placer(model, optimizer, mesh, specs, moment_spec)
    step = _sharded_step(make_lm_train_step(model, optimizer,
                                            constrain=constrain),
                         placer, zero1)

    def place(tokens):
        placer.params()
        return _dtensor(tokens, mesh, (data_axis, None))

    return step, place


def make_sharded_train_step(model: TernaryMLP, optimizer,
                            mesh: DeviceMesh, *, data_axis: str = "data",
                            model_axis: str = "model"):
    """The MLP train step SPMD over a (data x model) mesh.

    Returns ``(step, place)``: ``place(x, y)`` lays the parameters out per
    :func:`param_shardings`, the moments like the parameters they mirror
    and the batch along ``data_axis``, and returns ``(x, y)`` as DTensors;
    ``step(x, y)`` returns the loss (a plain tensor)."""
    specs = param_specs(model, model_axis)
    placer = _Placer(model, optimizer, mesh, specs, lambda n, v: specs[n])
    step = _sharded_step(make_train_step(model, optimizer), placer, False)

    def place(x, y):
        placer.params()
        return (_dtensor(x, mesh, (data_axis, None)),
                _dtensor(y, mesh, (data_axis, None)))

    return step, place

