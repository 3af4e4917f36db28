"""Sharded ternary SpMM over a device mesh — counterpart of
``ternary_spgemm_tpu/parallel/spgemm.py`` on ``torch.distributed``.

Three schemes, each the port's kernels run on every rank's local shards
(``ternary_spgemm`` with the caller's ``kernel=``) plus the collectives of
the JAX scheme:

* :func:`column_sharded_spgemm` — W columns, bias and alpha split along
  ``axis``; X replicated (or split along ``batch_axis`` too). No
  collective: per-column streams are shard-local.
* :func:`row_sharded_spgemm` — W rows and X columns split along ``axis``;
  the partial outputs are summed by ``all_reduce`` (Y replicated) or
  ``reduce_scatter_tensor`` (Y column-split); bias and PReLU come after the
  sum (the PReLU does not commute with it).
* :func:`overlapped_gather_spgemm` — X arrives row-split, W column-split;
  a ring passes the X chunks on with ``batch_isend_irecv``, each step's
  send and receive started before the step's kernel and waited after it,
  so every rank computes its output columns for every chunk without the
  gathered X.

Each scheme's per-rank work is a function of its own (:func:`column_local`,
:func:`row_local`, :func:`overlapped_gather_local`) over plain local
tensors. Inputs may be DTensors (redistributed as the scheme needs) or
plain tensors that every rank holds whole (sliced locally, no
communication); the result is a DTensor with the placements of the JAX
scheme's ``out_specs``, so its ``full_tensor()`` is JAX's global output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ternary_spgemm_tpu_torch.formats import (
    BlockedEllTCSC,
    BlockPackedTernary,
    TiledBitplane,
    TiledBlockPacked,
    TiledDenseTernary,
    TiledEllDeposit,
    TiledEllTCSC,
)
from ternary_spgemm_tpu_torch.formats.ell_deposit import SB_ROWS
from ternary_spgemm_tpu_torch.ops.api import finish, ternary_spgemm
from ternary_spgemm_tpu_torch.parallel.sharding import (
    column_leaf_specs,
    local_container,
    local_part,
    placements,
    row_leaf_specs,
)


def _check_tiled_alignment(fmt, dim: str, nshards: int = 1):
    """Blocked and tiled containers pad N (and K) to tile multiples; a
    shard along a padded dim lines up with the true-N bias and X shards
    only when the dim is an exact tile multiple (else shard edges fall
    inside tiles, or a padded last K-block decodes rows beyond the rank's X
    columns, and the result is silently wrong). JAX's checks and texts."""
    if isinstance(fmt, (TiledDenseTernary, TiledBlockPacked)):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding a tiled container requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<128-multiple divisor of N>)")
        if dim == "K":
            blk = (fmt.tile_k if isinstance(fmt, TiledDenseTernary)
                   else fmt.factor * fmt.tile_kq)
            if fmt.K % blk:
                raise ValueError(
                    f"row-sharding a tiled container requires K % {blk} == 0 "
                    f"(K={fmt.K}); rebuild with a K-tile dividing K")
    elif isinstance(fmt, BlockPackedTernary):
        blk = fmt.factor * fmt.tile_kq
        if dim == "K":
            if fmt.K % blk:
                raise ValueError(
                    f"row-sharding BlockPackedTernary requires K % (factor*"
                    f"tile_kq) == 0 (K={fmt.K}, factor={fmt.factor}, "
                    f"tile_kq={fmt.tile_kq}); rebuild with a block size "
                    f"dividing K")
            nb = fmt.K // blk
            if nb % nshards:
                raise ValueError(
                    f"row-sharding BlockPackedTernary over {nshards} devices "
                    f"requires the device count to divide the block count "
                    f"({nb} = K/(factor*tile_kq)); a shard boundary inside a "
                    f"packed block decodes the wrong dense rows")
    elif isinstance(fmt, TiledBitplane):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding TiledBitplane requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<128-multiple divisor of N>)")
        if dim == "K" and fmt.K % (8 * fmt.tkb):
            raise ValueError(
                f"row-sharding TiledBitplane requires K % (8*tkb) == 0 "
                f"(K={fmt.K}, tkb={fmt.tkb}); rebuild with a block "
                f"dividing K")
    elif isinstance(fmt, TiledEllDeposit):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding TiledEllDeposit requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<128-multiple divisor of N>)")
        if dim == "K" and fmt.K % SB_ROWS:
            raise ValueError(
                f"row-sharding TiledEllDeposit requires K % {SB_ROWS} == 0 "
                f"(K={fmt.K}); a shard boundary inside a deposit superblock "
                f"maps activations to the wrong decoded rows")
    elif isinstance(fmt, TiledEllTCSC):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding TiledEllTCSC requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<divisor of N>)")
        if dim == "K" and fmt.K % fmt.block_k:
            raise ValueError(
                f"row-sharding TiledEllTCSC requires K % block_k == 0 "
                f"(K={fmt.K}, block_k={fmt.block_k}); rebuild with "
                f"from_dense(..., block_k=<divisor of K, <=127>)")
    elif isinstance(fmt, BlockedEllTCSC):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding BlockedEllTCSC requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<divisor of N>)")
        if dim == "K" and fmt.K % fmt.block_k:
            raise ValueError(
                f"row-sharding BlockedEllTCSC requires K % block_k == 0 "
                f"(K={fmt.K}, block_k={fmt.block_k}); rebuild with "
                f"from_dense(..., block_k=<divisor of K>)")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _global(y: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """The rank's block ``y`` of an evenly split global array as a
    DTensor laid out as ``spec``."""
    return DTensor.from_local(y, mesh, placements(mesh, spec),
                              run_check=False)


def reduce_over(y: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                scatter: bool) -> torch.Tensor:
    """Sum the partial ``y (M, N)`` over ``axis``: ``all_reduce`` (every
    rank the whole sum) or, with ``scatter``, ``reduce_scatter_tensor``
    (rank r columns ``[r N/d, (r+1) N/d)`` of it, JAX's
    ``psum_scatter(..., scatter_dimension=1, tiled=True)``)."""
    group = mesh.get_group(axis)
    if not scatter:
        dist.all_reduce(y, group=group)
        return y
    d = axis_size(mesh, axis)
    M, N = y.shape
    if N % d:
        raise ValueError(f"scatter_output needs N={N} divisible by {d} "
                         "devices")
    chunks = y.reshape(M, d, N // d).transpose(0, 1).contiguous()
    out = torch.empty((M, N // d), dtype=y.dtype, device=y.device)
    dist.reduce_scatter_tensor(out, chunks.reshape(d * M, N // d),
                               group=group)
    return out


def column_local(x: torch.Tensor, f_local, b_local: torch.Tensor,
                 a_local=None, *, kernel: Optional[str] = None):
    """A rank's work in :func:`column_sharded_spgemm`: its output columns
    ``x @ W[:, cols] + b[cols]`` (PReLU'd with ``a_local``). The port's
    kernels take K from the container, JAX's stride-packed ones from X;
    :func:`localize` rounds a stride-packed K up to its FACTOR, so X gets
    zero columns up to it (they meet the pad rows, which decode to 0)."""
    if x.shape[1] < f_local.K:
        x = torch.nn.functional.pad(x, (0, f_local.K - x.shape[1]))
    return ternary_spgemm(x, f_local, b_local, a_local, kernel=kernel)


def column_sharded_spgemm(X, fmt, bias, alpha=None, *, mesh: DeviceMesh,
                          axis: str, batch_axis: Optional[str] = None,
                          kernel: Optional[str] = None) -> DTensor:
    """Output-column-parallel SpMM: ``Y[:, cols] = X @ W[:, cols] + b[cols]``.

    ``fmt`` / ``bias`` / ``alpha`` split along ``axis`` (DTensors, or whole
    on every rank); X replicated over ``axis`` and optionally split along
    ``batch_axis``. Returns Y laid out ``(batch_axis, axis)``."""
    _check_tiled_alignment(fmt, "N")
    f_local = local_container(fmt, mesh, column_leaf_specs(type(fmt), axis))
    x = local_part(X, mesh, (batch_axis, None))
    b = local_part(bias, mesh, (axis,))
    a = None if alpha is None else local_part(alpha, mesh, (axis,))
    y = column_local(x, f_local, b, a, kernel=kernel)
    return _global(y, mesh, (batch_axis, axis))


def row_local(x_local: torch.Tensor, f_local, *,
              kernel: Optional[str] = None) -> torch.Tensor:
    """A rank's work in :func:`row_sharded_spgemm`: its partial product
    ``x[:, rows] @ W[rows, :]``, the kernel run with a zero bias."""
    zero_b = torch.zeros((f_local.N,), dtype=torch.float32,
                         device=x_local.device)
    return ternary_spgemm(x_local, f_local, zero_b, None, kernel=kernel)


def row_sharded_spgemm(X, fmt, bias, alpha=None, *, mesh: DeviceMesh,
                       axis: str, batch_axis: Optional[str] = None,
                       scatter_output: bool = False,
                       kernel: Optional[str] = None) -> DTensor:
    """Contraction-parallel SpMM: partial Y from K/d rows, summed over
    ``axis``; bias and the optional PReLU after the sum. With
    ``scatter_output`` the sum is a reduce-scatter and Y comes back split
    by columns along ``axis``."""
    _check_tiled_alignment(fmt, "K", axis_size(mesh, axis))
    f_local = local_container(fmt, mesh, row_leaf_specs(type(fmt), axis))
    x = local_part(X, mesh, (batch_axis, axis))
    bspec = (axis,) if scatter_output else (None,)
    b = local_part(bias, mesh, bspec)
    a = None if alpha is None else local_part(alpha, mesh, bspec)
    y = reduce_over(row_local(x, f_local, kernel=kernel), mesh, axis,
                    scatter=scatter_output)
    return _global(finish(y, b, a), mesh,
                   (batch_axis, axis if scatter_output else None))


def overlapped_gather_local(x_chunk: torch.Tensor, f_local, b_local,
                            a_local=None, *, group=None, rank: int = 0,
                            d: int = 1, kernel: Optional[str] = None):
    """A rank's ring in :func:`overlapped_gather_spgemm`: at step t it
    starts sending the chunk it holds to rank ``rank + 1`` and receiving
    the next from ``rank - 1`` (group ranks, mod d), runs
    :func:`column_local` on the held chunk into rows ``owner * m`` of its
    output, ``owner = (rank - t) mod d``, and then waits. The last step
    sends nothing (JAX's last ``ppermute`` result is unused), so d = 1 is
    the kernel call alone."""
    m = x_chunk.shape[0]
    y = torch.empty((d * m, f_local.N), dtype=torch.float32,
                    device=x_chunk.device)
    chunk = x_chunk.contiguous()
    for t in range(d):
        reqs, nxt = [], None
        if t < d - 1:
            nxt = torch.empty_like(chunk)
            peer = lambda r: dist.get_global_rank(group, r % d)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, chunk, peer(rank + 1), group),
                dist.P2POp(dist.irecv, nxt, peer(rank - 1), group)])
        owner = (rank - t) % d
        y[owner * m:(owner + 1) * m] = column_local(
            chunk, f_local, b_local, a_local, kernel=kernel)
        for r in reqs:
            r.wait()
        if nxt is not None:
            chunk = nxt
    return y


def overlapped_gather_spgemm(X, fmt, bias, alpha=None, *, mesh: DeviceMesh,
                             axis: str,
                             kernel: Optional[str] = None) -> DTensor:
    """Ring-overlapped activation gather x column-parallel SpMM.

    X arrives row(M)-split along ``axis`` (chunk r on rank r); W, bias and
    alpha column-split. After d steps every rank holds its whole (M, N/d)
    output block, never the gathered (M, K) activations. Returns Y laid
    out ``(None, axis)``."""
    _check_tiled_alignment(fmt, "N")
    f_local = local_container(fmt, mesh, column_leaf_specs(type(fmt), axis))
    x = local_part(X, mesh, (axis, None))
    b = local_part(bias, mesh, (axis,))
    a = None if alpha is None else local_part(alpha, mesh, (axis,))
    y = overlapped_gather_local(
        x, f_local, b, a, group=mesh.get_group(axis),
        rank=mesh.get_local_rank(axis), d=axis_size(mesh, axis),
        kernel=kernel)
    return _global(y, mesh, (None, axis))
