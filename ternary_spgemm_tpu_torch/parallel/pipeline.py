"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis — counterpart
of ``ternary_spgemm_tpu/parallel/pipeline.py`` on ``torch.distributed``.

Transformer blocks are grouped into P stages along a mesh axis; the
activations flow stage to stage by point-to-point sends on the axis's
group, and microbatches keep every stage busy after the P-1-step fill: the
JAX schedule of ``n_micro + P - 1`` steps. Training runs through the same
schedule: the hop is an autograd function whose backward sends the
cotangent one hop back (the transpose of JAX's ``ppermute``), the input
(read by stage 0 alone) sums its cotangent over the stages, and the last
stage's outputs reach every rank with a broadcast whose backward keeps the
last stage's own cotangent (every rank computes the loss on the same
outputs, as JAX's replicated global output). The backward schedule is
GPipe's (every activation kept), not 1F1B.

:func:`pipeline_apply` runs any ``stage_fn`` over stacked per-stage
params; :func:`pipeline_lm_apply` pipelines a
:class:`~ternary_spgemm_tpu_torch.models.transformer.BitTransformerLM`'s
blocks (the embedding and the tied head outside the pipe, on every rank).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call


def _hop(t: torch.Tensor, group, stage: int, n: int, step: int):
    """Send ``t`` to stage ``stage + step`` and receive from ``stage -
    step`` (zeros where that stage does not exist), as ``ppermute`` with
    the pairs ``(s, s + step)``."""
    out = torch.zeros_like(t)
    ops = []
    peer = lambda s: dist.get_global_rank(group, s)
    if 0 <= stage + step < n:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer(stage + step),
                              group))
    if 0 <= stage - step < n:
        ops.append(dist.P2POp(dist.irecv, out, peer(stage - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Hop(torch.autograd.Function):
    """The stage-to-stage hop; its backward is the hop the other way."""

    @staticmethod
    def forward(ctx, t, group, stage, n):
        ctx.args = (group, stage, n)
        return _hop(t, group, stage, n, +1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, *ctx.args, -1), None, None, None


class _Replicated(torch.autograd.Function):
    """Identity on an input every stage holds; its cotangent (stage 0's
    alone is nonzero) is summed over the stages, as ``shard_map``
    transposes a replicated input."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage; its backward takes the last
    stage's cotangent (every stage computes the same loss from it)."""

    @staticmethod
    def forward(ctx, t, group, stage, n):
        ctx.last = stage == n - 1
        out = t.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, n - 1),
                       group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equal-structure dicts, lists and tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return type(t0)((k, _tree_map(fn, *(t[k] for t in trees)))
                        for k in t0)
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *c) for c in zip(*trees))
    return fn(*trees)


def stack_stages(per_stage_params):
    """Stack a list of per-stage trees (the same structure) into one tree
    whose leaves carry a leading stage axis — the layout
    :func:`pipeline_apply` splits."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def pipeline_apply(stage_fn, stacked_params, x: torch.Tensor,
                   mesh: DeviceMesh, *, axis: str = "pipe", n_micro: int):
    """Run ``P = mesh[axis]`` pipeline stages over microbatched ``x``.

    ``stacked_params``: a tree whose leaves have a leading stage axis of
    size P (:func:`stack_stages`); the rank at stage s uses slice s.
    ``stage_fn(local_params, h) -> h`` applies one stage, keeping the
    microbatch shape ``(B / n_micro, ...)``. Microbatch m enters stage 0
    at step m and leaves stage P-1 at step m + P - 1; ``x`` is passed whole
    to every rank (only stage 0 reads it). Every stage computes at every
    step, as JAX's scan does (the fill and drain steps' results are
    discarded), and the hops run in step order on every rank, forward and
    backward; the last step's hop, whose result JAX discards, is left out.
    Returns the last stage's outputs in microbatch order, ``(B, ...)``, on
    every rank."""
    names = mesh.mesh_dim_names
    Pn = mesh.size(names.index(axis))
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible into {n_micro} microbatches")
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    params = _tree_map(lambda a: a[stage], stacked_params)
    xm = _Replicated.apply(x, group).reshape((n_micro, B // n_micro)
                                             + tuple(x.shape[1:]))
    steps = n_micro + Pn - 1
    h = torch.zeros_like(xm[0])
    first = torch.tensor(stage == 0, device=x.device)
    outs = []
    for i in range(steps):
        # stage 0 reads the feed, the others h, through JAX's where: the
        # other branch's value is dropped (an inf there stays out), and
        # its zero cotangent still runs the backward of every hop and of
        # the input on every stage, in the same order
        feed = xm[min(i, n_micro - 1)]
        inp = torch.where(first, feed, h)
        out = stage_fn(params, inp).to(xm.dtype)
        outs.append(out)
        if Pn > 1 and i < steps - 1:
            h = _Hop.apply(out, group, stage, Pn)
    y = torch.stack(outs[Pn - 1:Pn - 1 + n_micro])
    if Pn > 1:
        y = _FromLast.apply(y, group, stage, Pn)
    return y.reshape((B,) + tuple(y.shape[2:]))


# ---------------------------------------------------------------------------
# Transformer glue
# ---------------------------------------------------------------------------


def lm_stage_params(model, n_stages: int) -> dict:
    """Group a BitTransformerLM's blocks into ``n_stages`` equal stages and
    stack: leaves ``(n_stages, blocks_per_stage, ...)``, keyed by a block's
    ``state_dict()`` path (stacked from the model's parameters, so the
    gradients reach them)."""
    nb = model.cfg.n_layers
    if nb % n_stages:
        raise ValueError(f"{nb} blocks do not split into {n_stages} stages")
    L = nb // n_stages
    blocks = [dict(b.named_parameters()) for b in model.blocks]
    return stack_stages([stack_stages(blocks[s * L:(s + 1) * L])
                         for s in range(n_stages)])


def _lm_stage_fn(model):
    """A stage: its ``blocks_per_stage`` blocks in turn, each the model's
    first block run with the stage's parameters
    (``torch.func.functional_call``), the carry cast to the compute dtype
    first."""
    from ternary_spgemm_tpu_torch.models.transformer import _compute_dtype

    template = model.blocks[0]
    cdtype = _compute_dtype(model.cfg)

    def stage(stacked_blocks, h):
        h = h.to(cdtype)
        L = next(iter(stacked_blocks.values())).shape[0]
        for b in range(L):
            p = {k: v[b] for k, v in stacked_blocks.items()}
            h = functional_call(template, p, (h,))
        return h

    return stage


def pipeline_lm_apply(model, tokens: torch.Tensor, mesh: DeviceMesh, *,
                      axis: str = "pipe", n_micro: int):
    """The BitTransformerLM forward with its blocks pipeline-parallel over
    ``axis`` (the embedding and tied head on every rank, outside the
    pipe). Equals ``model(tokens)`` — for MoE blocks while the expert
    capacity does not bind (each microbatch routes its own (B/n_micro)*T
    tokens)."""
    from ternary_spgemm_tpu_torch.models.transformer import rms_norm

    Pn = mesh.size(mesh.mesh_dim_names.index(axis))
    x = model.embed[tokens]
    x = pipeline_apply(_lm_stage_fn(model), lm_stage_params(model, Pn), x,
                       mesh, axis=axis, n_micro=n_micro)
    x = rms_norm(x, model.norm_out)
    return torch.einsum("btd,vd->btv", x, model.embed)
