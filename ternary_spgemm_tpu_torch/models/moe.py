"""Ternary Mixture-of-Experts — counterpart of
``ternary_spgemm_tpu/models/moe.py``: BitNet SwiGLU experts behind a
top-k router with GShard / Switch dispatch.

* :class:`BitMoEConfig` — the expert count, top-k and capacity factor;
  :meth:`~BitMoEConfig.capacity` the static slot count per expert;
* :func:`moe_route` — top-k routing as dense one-hot ``dispatch`` and
  ``combine`` tensors of shape ``(S, E, C)``: per round each token takes
  its best remaining expert, slots are assigned in token order by a
  per-expert cumsum, overflow is dropped (its output 0: the residual
  carries it); ``aux`` is the Switch balance loss from the first-choice
  fractions;
* :class:`BitMoE` — the QAT layer: latent f32 expert stacks quantized per
  expert through the STE, three batched expert products;
* :class:`ExportedMoE` — the serving layer: each expert's three matrices
  an :class:`~ternary_spgemm_tpu_torch.models.exported.ExportedBitLinear`
  on the kernel registry, one static loop over the experts.

Every shape is static (the capacity comes from the token count), so a
captured decode step holds the whole route: no host sync, no data-dependent
branch. Glue that reduces or calls a transcendental function (the router's
logits and softmax, the balance loss, the combine's sum over a token's
top-k slots) runs in f64 and is rounded once to f32, so the CPU and the
card agree bit for bit; the dispatch product only selects rows and is
exact. :func:`moe_param_shardings` lays the experts out for expert
parallelism (the sharded train steps).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Type

import torch
from torch import nn

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat, as_f32
from ternary_spgemm_tpu_torch.models.bitlinear import (
    default_generator,
    is_dtensor,
    ternary_quantize_ste,
)
from ternary_spgemm_tpu_torch.models.exported import ExportedBitLinear
from ternary_spgemm_tpu_torch.models.transformer import F64, silu
from ternary_spgemm_tpu_torch.utils.device import resolve_device

F32 = torch.float32
#: each expert's projections, named as the JAX ``BitMoE`` params
EXPERT_LINEARS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class BitMoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 1
    capacity_factor: float = 1.5

    def __post_init__(self):
        if self.top_k < 1 or self.top_k > self.n_experts:
            raise ValueError(f"top_k={self.top_k} outside 1..{self.n_experts}")

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert slot count for ``n_tokens`` routed ``top_k``
        ways: ``ceil(capacity_factor * top_k * n_tokens / n_experts)``,
        within ``[4, n_tokens]`` (4 where there are fewer tokens)."""
        c = math.ceil(self.capacity_factor * self.top_k * n_tokens
                      / self.n_experts)
        return max(4, min(n_tokens, c))


def moe_config(cfg) -> BitMoEConfig:
    """The MoE FFN of a ``BitTransformerConfig`` with ``moe_experts``."""
    return BitMoEConfig(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                        top_k=cfg.moe_top_k,
                        capacity_factor=cfg.moe_capacity_factor)


def moe_route(cfg: BitMoEConfig, router_w: torch.Tensor, xs: torch.Tensor):
    """Top-k dispatch and combine tensors for flat tokens ``xs (S, d)``.

    Returns ``(dispatch (S, E, C) f32 0/1, combine (S, E, C) f32, aux)``
    (the JAX ``moe_route``, ``models/moe.py:57-92`` there). The router's
    logits and softmax run in f64, each rounded to f32; the gradient
    reaches ``router_w`` (and ``xs``) through the gates and ``aux``."""
    S, E = xs.shape[0], cfg.n_experts
    C = cfg.capacity(S)
    dev = xs.device
    logits = (xs.to(F64) @ router_w.to(F64)).to(F32)
    probs = torch.softmax(logits.to(F64), dim=-1).to(F32)       # (S, E)
    experts = torch.arange(E, device=dev)
    slots = torch.arange(C, device=dev)
    one_hot = lambda idx: (idx[:, None] == experts).to(F32)

    # the Switch balance loss takes the FIRST-choice assignment fractions
    mask1 = one_hot(torch.argmax(probs, dim=-1))
    aux = (E * torch.mean(torch.mean(mask1.to(F64), dim=0)
                          * torch.mean(probs.to(F64), dim=0)) * E).to(F32)

    remaining = probs.detach()
    fill = torch.zeros((E,), dtype=F32, device=dev)      # slots used so far
    dispatch = torch.zeros((S, E, C), dtype=F32, device=dev)
    combine = torch.zeros((S, E, C), dtype=F32, device=dev)
    for _ in range(cfg.top_k):
        choice = torch.argmax(remaining, dim=-1)                  # (S,)
        gate = torch.gather(probs, 1, choice[:, None])[:, 0]
        mask = one_hot(choice)                                    # (S, E)
        pos = fill[None, :] + torch.cumsum(mask, dim=0) - mask    # slot index
        keep = mask * (pos < C)
        # a slot index at or past C matches no slot: all zeros, as
        # jax.nn.one_hot gives for an index out of range
        d_k = keep[:, :, None] * (pos.to(torch.int64)[:, :, None] == slots)
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[:, None, None]
        fill = fill + torch.sum(keep, dim=0)
        remaining = remaining * (1.0 - mask)                  # exclude chosen
    return dispatch, combine, aux


def _dispatch(dispatch: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``einsum("sec,sd->ecd")``: each expert's capacity rows (a slot holds
    one token or none, so the product only selects rows: exact)."""
    return torch.einsum("sec,sd->ecd", dispatch.to(xs.dtype),
                        xs).contiguous()


def _combine(combine: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``einsum("sec,ecd->sd")``: each token's gated sum over its top-k
    slots, in f64 (the f32 products are exact there), rounded once to
    ``out``'s dtype."""
    return torch.einsum("sec,ecd->sd", combine.to(F64), out.to(F64)).to(
        out.dtype)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched expert product at f32 (a bf16 operand widened: its
    products are exact in f32), returned at ``a``'s dtype, as
    :class:`~ternary_spgemm_tpu_torch.models.bitlinear.BitLinear`
    multiplies."""
    return torch.bmm(a.to(F32), b.to(F32)).to(a.dtype)


class BitMoE(nn.Module):
    """The QAT ternary-expert MoE layer.

    Parameters named as the JAX params dict, so that ``state_dict()`` keys
    are its paths: ``router (d, E)`` and the latent expert stacks
    ``w_gate`` / ``w_up (E, d, ff)``, ``w_down (E, ff, d)``. Each expert is
    its own BitNet matrix: quantized through
    :func:`~ternary_spgemm_tpu_torch.models.bitlinear.ternary_quantize_ste`
    with its own absmean gamma, at f32, then cast to x's dtype.
    ``forward(x (..., d)) -> (y (..., d), aux)``, aux the Switch balance
    loss (``E * sum_e fraction_e * mean-prob_e``; 1.0 is balanced).

    Built on the card unless ``device="cpu"``; ``generator`` (on that
    device) draws the router from N(0, 1/d), gate and up from N(0, 2/d),
    down from N(0, 2/ff): the JAX scales, not its draws."""

    def __init__(self, cfg: BitMoEConfig, *, generator=None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or default_generator(dev)
        self.cfg = cfg
        E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
        draw = lambda shape, std: nn.Parameter(
            torch.randn(shape, generator=gen, device=dev) * std)
        self.router = draw((d, E), d ** -0.5)
        self.w_gate = draw((E, d, ff), (2.0 / d) ** 0.5)
        self.w_up = draw((E, d, ff), (2.0 / d) ** 0.5)
        self.w_down = draw((E, ff, d), (2.0 / ff) ** 0.5)

    def forward(self, x: torch.Tensor):
        if is_dtensor(x):
            return self._forward_sharded(x)
        d = x.shape[-1]
        xs = x.reshape(-1, d)
        stacks = {n: getattr(self, n) for n in EXPERT_LINEARS}
        y, aux = _moe_local(self.cfg, xs, xs, self.router, stacks,
                            slice(None))
        return y.reshape(x.shape), aux

    def _forward_sharded(self, x):
        """The layer on DTensors (the sharded train steps), with the JAX
        package's global semantics. The tokens are gathered whole on every
        rank, so the route (capacity, slot order, balance loss) is the
        unsharded one, computed alike everywhere on local tensors; each
        rank runs its own experts (the stacks split on E over one mesh
        axis, expert parallelism; whole where they are not split) on its
        slice of that dispatch, their outputs are all-gathered over the
        expert axis, and every rank combines all E experts, whose result
        goes back to the batch split of ``x``. So the route's gradient
        (gates, balance loss, router) is whole on every rank, as its
        replicated layout says; the expert input's is partial over the
        expert axis (each rank's experts' share)."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)

        mesh, d = x.device_mesh, x.shape[-1]
        stacks = {n: getattr(self, n) for n in EXPERT_LINEARS}
        pl = list(stacks["w_gate"].placements)
        axes = [i for i, p in enumerate(pl) if p.is_shard()]
        if any(not pl[i].is_shard(0) for i in axes) or len(axes) > 1:
            raise ValueError(f"the expert stacks may split only on their "
                             f"expert dim over one mesh axis, got {pl}")
        rep = [Replicate()] * mesh.ndim
        over_experts = [Partial() if i in axes else Replicate()
                        for i in range(mesh.ndim)]
        xr = x.redistribute(mesh, rep)
        xs = xr.to_local().reshape(-1, d)
        xe = xr.to_local(grad_placements=over_experts).reshape(-1, d)
        router = self.router.to_local() if is_dtensor(self.router) \
            else self.router
        local = {n: w.to_local() for n, w in stacks.items()}
        E_loc = local["w_gate"].shape[0]
        e0 = mesh.get_local_rank(axes[0]) * E_loc if axes else 0
        split = [Shard(0) if i in axes else Replicate()
                 for i in range(mesh.ndim)]
        gather = lambda out: DTensor.from_local(
            out, mesh, split, run_check=False).redistribute(
            mesh, rep).to_local()
        y, aux = _moe_local(self.cfg, xs, xe, router, local,
                            slice(e0, e0 + E_loc), gather)
        # the rows back to x's batch split; the redistribution kept after
        # the reshape brings the gradient back to that layout too (DTensor
        # cannot unflatten a sequence split)
        rows = [p if p.is_shard(0) else Replicate() for p in x.placements]
        y = DTensor.from_local(y, mesh, rep, run_check=False)
        y = y.redistribute(mesh, rows).reshape(x.shape).redistribute(
            mesh, rows)
        return y, DTensor.from_local(aux, mesh, rep, run_check=False)


def _moe_local(cfg: BitMoEConfig, xs, xe, router, stacks: dict, mine: slice,
               gather=lambda out: out):
    """The layer's body on plain tensors, flat tokens ``(S, d)``: the route
    on ``xs``, the experts ``mine`` (``stacks`` holds just those) on their
    dispatch of ``xe``, ``gather`` turning their outputs into all E
    experts', and the combine of every expert. Returns ``(y (S, d),
    aux)``. Unsharded, ``xs`` and ``xe`` are one tensor, ``mine`` every
    expert and ``gather`` the identity."""
    dispatch, combine, aux = moe_route(cfg, router, xs)
    wq = {n: _quantize_stack(w).to(xe.dtype) for n, w in stacks.items()}
    out = gather(_experts(_dispatch(dispatch[:, mine], xe), wq))
    return _combine(combine, out), aux


def _quantize_stack(ws: torch.Tensor) -> torch.Tensor:
    """An expert stack through the STE, one absmean gamma an expert."""
    return torch.stack([ternary_quantize_ste(w) for w in ws])


def _experts(expert_in: torch.Tensor, wq: dict) -> torch.Tensor:
    """The experts' SwiGLU on their capacity rows ``(E, C, d)``."""
    h = silu(_bmm(expert_in, wq["w_gate"])) * _bmm(expert_in, wq["w_up"])
    return _bmm(h, wq["w_down"])


class ExportedMoE(nn.Module):
    """A trained :class:`BitMoE` frozen into ternary containers: the router
    stays f32 (``router`` buffer), every expert's gate, up and down matrix
    is an :class:`ExportedBitLinear` with a zero bias (``experts[e][n]``),
    run on the kernel registry in one static loop over the experts (three
    calls an expert, each at the expert's capacity rows)."""

    def __init__(self, cfg: BitMoEConfig, router, experts):
        super().__init__()
        self.cfg = cfg
        self.experts = nn.ModuleList(nn.ModuleDict(ex) for ex in experts)
        dev = self.experts[0]["w_gate"].bias.device
        self.register_buffer("router", as_f32(router, dev))

    @classmethod
    def from_params(cls, cfg: BitMoEConfig, params: dict,
                    format_cls: Type[TernaryFormat], *, kernel=None,
                    a8: bool = False, device=None,
                    **fmt_kwargs) -> "ExportedMoE":
        """From the JAX ``BitMoE.init`` dict (numpy or torch leaves), each
        expert quantized and packed on ``device`` with its transposed
        container, as the JAX package builds its experts whatever the
        block's ``with_transpose``. ``a8``: the experts' W1.58-A8 regime
        (the JAX block does not pass its own on, ``models/transformer.py:
        397-401`` there, so its A8 experts over a TiledBitplane round raw
        activations; the port's follow the block)."""
        experts = [{n: ExportedBitLinear.from_params(
            {"w": params[n][e],
             "b": torch.zeros(params[n][e].shape[-1], dtype=F32)},
            format_cls, kernel=kernel, a8=a8, device=device, **fmt_kwargs)
            for n in EXPERT_LINEARS} for e in range(cfg.n_experts)]
        return cls(cfg, params["router"], experts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        xs = x.reshape(-1, d)
        dispatch, combine, _ = moe_route(self.cfg, self.router, xs)
        expert_in = _dispatch(dispatch, xs)
        outs = []
        for e, ex in enumerate(self.experts):
            h = silu(ex["w_gate"](expert_in[e])) * ex["w_up"](expert_in[e])
            outs.append(ex["w_down"](h))
        return _combine(combine, torch.stack(outs)).reshape(x.shape)


def moe_param_specs(axis: str = "expert") -> dict:
    """Expert-parallel specs keyed by parameter name: the expert stacks
    split on their leading E dim, the router replicated (every rank routes
    its own tokens)."""
    return {"router": (), "w_gate": (axis, None, None),
            "w_up": (axis, None, None), "w_down": (axis, None, None)}


def moe_param_shardings(mesh, axis: str = "expert") -> dict:
    """:func:`moe_param_specs` as DTensor placements on ``mesh``."""
    from ternary_spgemm_tpu_torch.parallel.sharding import placements

    return {k: placements(mesh, s) for k, s in moe_param_specs(axis).items()}
