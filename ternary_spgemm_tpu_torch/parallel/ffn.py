"""Tensor-parallel fused SwiGLU FFN — counterpart of
``ternary_spgemm_tpu/parallel/ffn.py`` on ``torch.distributed``.

Megatron-style FFN tensor parallelism over the fused block kernel
(:func:`~ternary_spgemm_tpu_torch.ops.fused_ffn.fused_bitplane_swiglu`):
the gate and up projections split by columns along ``axis`` (each rank a
slice of the hidden width), the down projection by rows on the same
boundary, so each rank runs its whole block (both up projections, silu-mul,
the per-row requantize, the down projection) as one kernel call, and the
partial outputs meet in one ``all_reduce`` (or ``reduce_scatter_tensor``).

Numerics: the int8 requantize of the hidden state happens per shard (one
scale a (row, shard)), a finer grid than the one-card per-row scale; at
d = 1 it is the one-card kernel exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ternary_spgemm_tpu_torch.formats import TiledBitplane
from ternary_spgemm_tpu_torch.ops.fused_ffn import fused_bitplane_swiglu
from ternary_spgemm_tpu_torch.parallel.sharding import (
    column_leaf_specs,
    local_container,
    local_part,
    row_leaf_specs,
)
from ternary_spgemm_tpu_torch.parallel.spgemm import (
    _check_tiled_alignment,
    _global,
    axis_size,
    reduce_over,
)


def swiglu_local(xq, sx, fg_local: TiledBitplane, fu_local: TiledBitplane,
                 fd_local: TiledBitplane, N2: int, *, gamma_gate: float = 1.0,
                 gamma_up: float = 1.0,
                 gamma_down: float = 1.0) -> torch.Tensor:
    """A rank's work in :func:`tensor_parallel_fused_swiglu`: the fused
    block over its hidden slice, its partial ``(M, N2)`` output. The local
    down container reports its padded width (``gn * tile_n``: the true N2
    is not in its leaves); the pad columns are exact zeros and are cut
    before the sum."""
    y = fused_bitplane_swiglu(xq, sx, fg_local, fu_local, fd_local,
                              gamma_gate=gamma_gate, gamma_up=gamma_up,
                              gamma_down=gamma_down)
    return y[:, :N2]


def tensor_parallel_fused_swiglu(xq, sx, fmt_gate: TiledBitplane,
                                 fmt_up: TiledBitplane,
                                 fmt_down: TiledBitplane, *,
                                 mesh: DeviceMesh, axis: str,
                                 batch_axis: Optional[str] = None,
                                 scatter_output: bool = False,
                                 gamma_gate: float = 1.0,
                                 gamma_up: float = 1.0,
                                 gamma_down: float = 1.0) -> DTensor:
    """Run the fused SwiGLU FFN block tensor-parallel over ``mesh[axis]``.

    ``xq`` / ``sx``: int8-valued activations and their row scales
    (replicated over ``axis``, optionally split along ``batch_axis``);
    ``fmt_gate`` / ``fmt_up`` split by columns along ``axis``,
    ``fmt_down`` by rows on the same hidden boundary. The hidden width must
    split evenly (JAX's four checks and texts). Returns Y replicated, or
    split by columns with ``scatter_output``, as a DTensor."""
    n_dev = axis_size(mesh, axis)
    _check_tiled_alignment(fmt_gate, "N")
    _check_tiled_alignment(fmt_up, "N")
    _check_tiled_alignment(fmt_down, "K", n_dev)
    gn = fmt_gate.plane.shape[1]
    if gn % n_dev:
        raise ValueError(
            f"tensor_parallel_fused_swiglu needs the hidden storage tiles "
            f"({gn}) to split evenly over {n_dev} devices")
    if fmt_down.K != fmt_gate.N or fmt_down.K % n_dev:
        raise ValueError(
            f"down projection K={fmt_down.K} must equal the hidden width "
            f"{fmt_gate.N} and split evenly over {n_dev} devices")
    if (fmt_down.K // n_dev) % (8 * fmt_down.tkb):
        raise ValueError(
            f"per-device down-projection shard ({fmt_down.K // n_dev} rows) "
            f"must be a multiple of the K-block (8*tkb={8 * fmt_down.tkb}); "
            "rebuild fmt_down with a smaller tkb")
    N2 = fmt_down.N
    if scatter_output and N2 % n_dev:
        raise ValueError(
            f"scatter_output needs N2={N2} divisible by {n_dev} devices")

    cspec = column_leaf_specs(TiledBitplane, axis)
    fg = local_container(fmt_gate, mesh, cspec)
    fu = local_container(fmt_up, mesh, cspec)
    fd = local_container(fmt_down, mesh, row_leaf_specs(TiledBitplane, axis))
    x = local_part(xq, mesh, (batch_axis, None))
    s = local_part(sx, mesh, (batch_axis, None))
    y = swiglu_local(x, s, fg, fu, fd, N2, gamma_gate=gamma_gate,
                     gamma_up=gamma_up, gamma_down=gamma_down)
    y = reduce_over(y.contiguous(), mesh, axis, scatter=scatter_output)
    return _global(y, mesh, (batch_axis, axis if scatter_output else None))
