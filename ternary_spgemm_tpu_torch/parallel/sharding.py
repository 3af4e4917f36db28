"""Device-mesh sharding of ternary containers — counterpart of
``ternary_spgemm_tpu/parallel/sharding.py`` on ``torch.distributed``.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of a process group, its dims named as the JAX mesh's axes. A *spec*
is the port's counterpart of a ``PartitionSpec``: a tuple with one entry
per dim of a tensor, the mesh axis that dim is split over or None
(``(None, "model")`` is ``P(None, "model")``); :func:`placements` turns it
into the DTensor placement list of a mesh. Containers shard as in the JAX
package: only the rectangular ones (:data:`SHARDABLE_FORMATS`), the stream
formats having data-dependent per-column nnz.

:func:`make_mesh` on ``"cuda"`` (the default) raises without a card and
needs an NCCL group; on ``"cpu"`` it runs over a gloo group (the CPU
tests). :func:`init_distributed` starts such a group; it has no JAX
counterpart (JAX finds its devices itself).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Type

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.formats.blocked_ell import BlockedEllTCSC
from ternary_spgemm_tpu_torch.formats.ell_deposit import (
    SB_ROWS,
    TiledEllDeposit,
)
from ternary_spgemm_tpu_torch.formats.ell_tiled import TiledEllTCSC
from ternary_spgemm_tpu_torch.formats.packed import (
    BlockPackedTernary,
    DenseTernary,
    PackedTernary2Bit,
    PackedTernary53,
)
from ternary_spgemm_tpu_torch.formats.tiled import (
    TiledBlockPacked,
    TiledDenseTernary,
)
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: Formats with rectangular leaves, shardable into equal static shards.
SHARDABLE_FORMATS = (DenseTernary, PackedTernary2Bit, PackedTernary53,
                     BlockPackedTernary, BlockedEllTCSC,
                     TiledDenseTernary, TiledBlockPacked, TiledEllTCSC,
                     TiledBitplane, TiledEllDeposit)

#: the mesh dim that :func:`make_mesh` adds when the group holds several
#: copies of the mesh asked for
REPLICA_AXIS = "replica"


def init_distributed(rank: int, world_size: int, init_method: str,
                     device_type: str = "cuda") -> None:
    """Join the default process group: NCCL for ``"cuda"`` (the rank's
    card is ``rank % device_count``; raises without a card), gloo for
    ``"cpu"``. ``init_method`` is a store address such as
    ``"tcp://127.0.0.1:<port>"``: nothing here discovers a cluster."""
    if device_type == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world_size, device_id=dev)
    elif device_type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")


def make_mesh(shape: dict, *, device_type: str = "cuda") -> DeviceMesh:
    """A mesh ``{"axis": size}`` over the ranks of the default process
    group, raising JAX's error when the group is too small. A group of
    ``k * n`` ranks for a mesh of ``n`` holds ``k`` copies of it (an outer
    :data:`REPLICA_AXIS` dim; each rank gets the copy it sits in), as JAX
    takes the first ``n`` of more devices. A ``"cuda"`` mesh raises without
    a card and needs the NCCL backend."""
    if device_type == "cuda":
        resolve_device("cuda")
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed(rank, world_size, init_method, "
                           "device_type) first")
    backend = dist.get_backend()
    if device_type == "cuda" and backend != "nccl":
        raise ValueError(f"a cuda mesh runs on NCCL; the process group's "
                         f"backend is {backend!r}")
    names = tuple(shape)
    sizes = tuple(int(shape[n]) for n in names)
    n = math.prod(sizes)
    have = dist.get_world_size()
    if n > have:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    if have % n:
        raise ValueError(f"mesh {shape} of {n} devices does not divide the "
                         f"group's {have}")
    if n == have:
        return init_device_mesh(device_type, sizes, mesh_dim_names=names)
    full = init_device_mesh(device_type, (have // n,) + sizes,
                            mesh_dim_names=(REPLICA_AXIS,) + names)
    return full[names]


def placements(mesh: DeviceMesh, spec: Sequence) -> list:
    """The DTensor placements (one a mesh dim) of ``spec``: ``Shard(d)``
    for the mesh axis named at tensor dim ``d``, ``Replicate()`` for a
    mesh axis the spec does not name."""
    names = mesh.mesh_dim_names
    for ax in spec:
        if ax is not None and ax not in names:
            raise ValueError(f"spec {tuple(spec)} names axis {ax!r}, not "
                             f"one of the mesh's {names}")
    out = []
    for name in names:
        dims = [d for d, ax in enumerate(spec) if ax == name]
        if len(dims) > 1:
            raise ValueError(f"spec {tuple(spec)} names axis {name!r} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _leaf_specs(format_cls: Type[TernaryFormat], axis: str, dim_for: dict):
    """Per-ARRAY_FIELDS specs, ``axis`` at the dim ``dim_for[field]``
    gives (its ndim known per format)."""
    specs = []
    for f in format_cls.ARRAY_FIELDS:
        nd, d = dim_for[f]
        spec = [None] * nd
        if d is not None:
            spec[d] = axis
        specs.append(tuple(spec))
    return specs


def column_leaf_specs(format_cls: Type[TernaryFormat], axis: str):
    """Specs (ARRAY_FIELDS order) sharding along output columns N."""
    if format_cls is DenseTernary:
        return _leaf_specs(format_cls, axis, {"dense": (2, 1)})
    if format_cls in (PackedTernary2Bit, PackedTernary53, BlockPackedTernary):
        return _leaf_specs(format_cls, axis, {"packed": (2, 1)})
    if format_cls in (TiledDenseTernary, TiledBlockPacked):
        return _leaf_specs(format_cls, axis, {"tiles": (4, 1)})  # grid_n
    if format_cls is BlockedEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "idx_pos": (3, 2), "idx_neg": (3, 2),
            "tile_cap_pos": (2, 1), "tile_cap_neg": (2, 1)})
    if format_cls is TiledEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 1), "cap_pos": (2, 1), "cap_neg": (2, 1)})
    if format_cls is TiledBitplane:
        return _leaf_specs(format_cls, axis, {"plane": (4, 1), "wsum": (4, 1)})
    if format_cls is TiledEllDeposit:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 1), "cap_pos": (2, 1), "cap_neg": (2, 1),
            "wsum": (4, 1)})
    raise TypeError(
        f"{format_cls.__name__} is not column-shardable (ragged 1-D streams); "
        "use one of " + ", ".join(c.__name__ for c in SHARDABLE_FORMATS))


def row_leaf_specs(format_cls: Type[TernaryFormat], axis: str):
    """Specs (ARRAY_FIELDS order) sharding along contraction rows K.

    The globally stride-packed planes (PackedTernary2Bit/53) are not
    row-shardable: field j of packed row k' is dense row j*Kq + k', so a
    contiguous chunk of packed rows is no contiguous block of dense rows.
    BlockPackedTernary is: its stride is local to ``factor*tile_kq``-row
    blocks (the shard count must divide the block count)."""
    if format_cls is DenseTernary:
        return _leaf_specs(format_cls, axis, {"dense": (2, 0)})
    if format_cls is BlockPackedTernary:
        return _leaf_specs(format_cls, axis, {"packed": (2, 0)})
    if format_cls in (PackedTernary2Bit, PackedTernary53):
        raise TypeError(
            f"{format_cls.__name__} is not row-shardable (global stride "
            "packing interleaves dense rows across the whole plane); use "
            "BlockPackedTernary for row parallelism")
    if format_cls in (TiledDenseTernary, TiledBlockPacked):
        return _leaf_specs(format_cls, axis, {"tiles": (4, 0)})  # grid_k
    if format_cls is BlockedEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "idx_pos": (3, 0), "idx_neg": (3, 0),
            "tile_cap_pos": (2, 0), "tile_cap_neg": (2, 0)})
    if format_cls is TiledEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 0), "cap_pos": (2, 0), "cap_neg": (2, 0)})
    if format_cls is TiledBitplane:
        return _leaf_specs(format_cls, axis, {"plane": (4, 0), "wsum": (4, 0)})
    if format_cls is TiledEllDeposit:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 0), "cap_pos": (2, 0), "cap_neg": (2, 0),
            "wsum": (4, 0)})
    raise TypeError(f"{format_cls.__name__} is not row-shardable")


def spec_tree(fmt: TernaryFormat, leaf_specs):
    """The specs of ``fmt``'s leaves as a list in ARRAY_FIELDS order (the
    JAX function builds a pytree of ``fmt``'s structure; a port container
    is no pytree, and its leaves are its ARRAY_FIELDS in that order)."""
    specs = list(leaf_specs)
    if len(specs) != len(type(fmt).ARRAY_FIELDS):
        raise ValueError(f"{type(fmt).__name__} has "
                         f"{len(type(fmt).ARRAY_FIELDS)} leaves, got "
                         f"{len(specs)} specs")
    return specs


def localize(fmt: TernaryFormat) -> TernaryFormat:
    """Rebuild the static (K, N) metadata from the leaves' *local* shapes.

    A rank's shard arrives with the global metadata and per-rank leaves
    (plain tensors: a DTensor's ``.shape`` is global); the kernels
    specialise on fmt.K / fmt.N, so the local view must carry local
    numbers. Field for field the JAX ``localize``."""
    cls = type(fmt)
    if cls is DenseTernary:
        d = fmt.dense
        return DenseTernary(dense=d, K=d.shape[0], N=d.shape[1])
    if cls in (PackedTernary2Bit, PackedTernary53):
        p = fmt.packed
        return cls(packed=p, K=p.shape[0] * cls.FACTOR, N=p.shape[1])
    if cls is BlockPackedTernary:
        p = fmt.packed
        return cls(packed=p, K=min(fmt.K, p.shape[0] * fmt.factor),
                   N=p.shape[1], factor=fmt.factor, tile_kq=fmt.tile_kq)
    if cls is TiledDenseTernary:
        t = fmt.tiles
        return cls(tiles=t, K=min(fmt.K, t.shape[0] * fmt.tile_k),
                   N=t.shape[1] * fmt.tile_n, tile_k=fmt.tile_k,
                   tile_n=fmt.tile_n)
    if cls is TiledBlockPacked:
        t = fmt.tiles
        return cls(tiles=t,
                   K=min(fmt.K, t.shape[0] * fmt.factor * fmt.tile_kq),
                   N=t.shape[1] * fmt.tile_n, factor=fmt.factor,
                   tile_kq=fmt.tile_kq, tile_n=fmt.tile_n)
    if cls is BlockedEllTCSC:
        ip = fmt.idx_pos
        return BlockedEllTCSC(
            idx_pos=ip, idx_neg=fmt.idx_neg,
            tile_cap_pos=fmt.tile_cap_pos, tile_cap_neg=fmt.tile_cap_neg,
            K=min(fmt.K, ip.shape[0] * fmt.block_k), N=ip.shape[2],
            block_k=fmt.block_k, tile_n=fmt.tile_n, cap_align=fmt.cap_align)
    if cls is TiledEllTCSC:
        p = fmt.plane
        return TiledEllTCSC(
            plane=p, cap_pos=fmt.cap_pos, cap_neg=fmt.cap_neg,
            K=min(fmt.K, p.shape[0] * fmt.block_k),
            N=p.shape[1] * fmt.tile_n, block_k=fmt.block_k,
            tile_n=fmt.tile_n, cap_p_max=fmt.cap_p_max)
    if cls is TiledBitplane:
        p = fmt.plane
        return TiledBitplane(
            plane=p, wsum=fmt.wsum,
            K=min(fmt.K, p.shape[0] * 8 * fmt.tkb),
            N=p.shape[1] * fmt.tile_n, tkb=fmt.tkb, tile_n=fmt.tile_n)
    if cls is TiledEllDeposit:
        p = fmt.plane
        return TiledEllDeposit(
            plane=p, cap_pos=fmt.cap_pos, cap_neg=fmt.cap_neg,
            wsum=fmt.wsum, K=min(fmt.K, p.shape[0] * SB_ROWS),
            N=p.shape[1] * fmt.tile_n, tile_n=fmt.tile_n,
            cap_p_max=fmt.cap_p_max)
    raise TypeError(cls.__name__)


def local_part(t, mesh: DeviceMesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of ``t`` laid out as ``spec`` says, as a
    contiguous plain tensor: a DTensor is redistributed (collectives where
    its placements differ); a plain tensor, which every rank holds whole,
    is sliced without communication. An uneven split raises, as
    ``shard_map`` refuses one."""
    pl = placements(mesh, spec)
    for d, ax in enumerate(spec):
        if ax is not None and t.shape[d] % mesh.size(
                mesh.mesh_dim_names.index(ax)):
            raise ValueError(
                f"dim {d} of size {t.shape[d]} does not split evenly over "
                f"mesh axis {ax!r} of size "
                f"{mesh.size(mesh.mesh_dim_names.index(ax))}")
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl).to_local().contiguous()
    t = torch.as_tensor(t)
    for i, p in enumerate(pl):     # the rank's even block, mesh dim by dim
        if p.is_shard():
            n = t.shape[p.dim] // mesh.size(i)
            t = t.narrow(p.dim, mesh.get_local_rank(i) * n, n)
    return t.contiguous()


def shard_container(fmt: TernaryFormat, mesh: DeviceMesh,
                    leaf_specs) -> TernaryFormat:
    """``fmt`` with every leaf a DTensor laid out on ``mesh`` as its spec
    says (every rank holds ``fmt`` whole; each keeps its own blocks)."""
    leaves = {f: distribute_tensor(
                  getattr(fmt, f), mesh, placements(mesh, s),
                  src_data_rank=None)
              for f, s in zip(type(fmt).ARRAY_FIELDS,
                              spec_tree(fmt, leaf_specs))}
    return dataclasses.replace(fmt, **leaves)


def local_container(fmt: TernaryFormat, mesh: DeviceMesh,
                    leaf_specs) -> TernaryFormat:
    """This rank's shard of ``fmt`` (DTensor or whole leaves) laid out per
    ``leaf_specs``, with local K and N (:func:`localize`)."""
    leaves = {f: local_part(getattr(fmt, f), mesh, s)
              for f, s in zip(type(fmt).ARRAY_FIELDS,
                              spec_tree(fmt, leaf_specs))}
    return localize(dataclasses.replace(fmt, **leaves))


def container_from_local_shard(fmt_local: TernaryFormat, mesh: DeviceMesh,
                               axis: str, *, dim: str, K: int,
                               N: int) -> TernaryFormat:
    """Assemble the global sharded container from this rank's locally built
    shard — the construction where no process ever holds the whole W.

    ``fmt_local = cls.from_dense(W[:, my_cols])`` (``dim="N"``) or
    ``cls.from_dense(W[my_rows, :])`` (``dim="K"``); ``K`` / ``N`` are the
    global dims. Each leaf becomes a DTensor through
    ``DTensor.from_local``, its global shape the local one times the
    axis's size along the sharded dim: the shards must be equal and sit in
    rank order along ``axis``. On a mesh of one rank the local shard is
    the whole matrix."""
    cls = type(fmt_local)
    specs = (column_leaf_specs(cls, axis) if dim == "N"
             else row_leaf_specs(cls, axis))
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    leaves = {}
    for field, spec in zip(cls.ARRAY_FIELDS, specs):
        local = getattr(fmt_local, field).contiguous()
        gshape = list(local.shape)
        sharded = next((d for d, s in enumerate(spec) if s == axis), None)
        if sharded is not None:
            gshape[sharded] *= n
        stride = torch.empty(gshape, device="meta").stride()
        leaves[field] = DTensor.from_local(
            local, mesh, placements(mesh, spec), run_check=False,
            shape=torch.Size(gshape), stride=stride)
    static = {f.name: getattr(fmt_local, f.name)
              for f in dataclasses.fields(cls)
              if f.name not in cls.ARRAY_FIELDS}
    static["K"], static["N"] = K, N
    return cls(**leaves, **static)
