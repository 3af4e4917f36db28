"""Checkpoints and serving bundles — counterpart of
``ternary_spgemm_tpu/checkpoint.py``, in the JAX package's file format, so
that a file written by either package loads in the other with the same
array bytes:

* :func:`save_container` / :func:`load_container`: one container with its
  scale, bias and slope, an ``.npz`` of ``field_<name>`` arrays and a JSON
  ``header`` ``{"format", "static", "gamma"}`` (the legacy ``leaf_<i>``
  layout is read too);
* :func:`save_lm_bundle` / :func:`load_lm_bundle`: a whole serving LM, one
  self-describing ``.npz`` (``{"version": 1, "cfg", "embed_dtype",
  "blocks"}``; arrays keyed by their path, such as ``b3.wo.fmt.plane``);
* :func:`save_pytree` / :func:`restore_pytree`: a tree of arrays as
  ``leaf_<i>`` in ``jax.tree_util``'s flatten order (a dict's values by
  sorted key, lists and tuples in order, None no leaf), the layout the JAX
  package writes where orbax is not importable. An orbax directory cannot
  be read here;
* :func:`save_sharded_pytree` / :func:`restore_sharded_pytree`: each rank
  writes only the blocks it holds, ``path.shard{rank}.npz`` (arrays
  ``l{i}s{j}``, a JSON ``header`` of each leaf's shape, dtype and the
  global index ranges of its blocks, keyed as the JAX ``_index_key``
  writes them), and reads back the blocks its target layout needs.

Names on disk are the JAX package's: a container's class name (looked up
in :func:`~ternary_spgemm_tpu_torch.formats.all_formats`) and a kernel's
JAX registry name, mapped to and from this port's through
``ops.api.REFERENCE_KERNELS``. A file never holds pickled objects: a
container field that is None is left out (the JAX package writes it as a
pickled ``None``, which this loader reads as None without unpickling). A
64-bit container field (the JAX packer's host column sums) loads as the
32-bit array that the JAX package's device copy, and the port's kernels,
hold.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict

import numpy as np
import torch

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat, all_formats
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.ops.api import jax_name, port_name
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: the serving bundle's format version (the JAX package's)
BUNDLE_VERSION = 1

#: the attention inputs a merged-QKV block also carries in the JAX export
QKV_LINEARS = ("wq", "wk", "wv")


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _numpy(x) -> np.ndarray:
    """A tensor or array as a host numpy array with the same bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: store the raw bits "
                            "(the bundle's bf16 embedding does)")
        return x.numpy()
    return np.asarray(x)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: keep the shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(
        np.shape(a)).to(device)


#: 64-bit host arrays as the JAX package's device arrays hold them (64-bit
#: types off): a container the JAX package saves straight from its packer
#: has int64 column sums, which its kernels see as int32, as the port's do
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32}


def _field_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A container field of a file as the tensor the port's kernels read."""
    narrow = _NARROW.get(a.dtype)
    if narrow is not None:
        info = np.iinfo(narrow) if a.dtype.kind in "iu" else None
        if info and a.size and (a.min() < info.min or a.max() > info.max):
            raise ValueError(f"a {a.dtype} field does not fit "
                             f"{np.dtype(narrow)}")
        a = a.astype(narrow)
    return _tensor(a, device)


def _encode(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _decode(data) -> dict:
    return json.loads(bytes(data["header"]).decode())


def _field(data, key: str):
    """The array ``key`` of an open ``.npz``, or None where the file holds
    none: left out (this package), or a pickled ``None`` (the JAX package's
    ``np.asarray(None)``), which ``np.load`` refuses to unpickle."""
    if key not in data:
        return None
    try:
        return data[key]
    except ValueError:
        return None


def _format_class(name: str):
    cls = all_formats().get(name)
    if cls is None:
        raise ValueError(
            f"no container {name!r} in either package; they have "
            f"{sorted(all_formats())}")
    return cls


def _fmt_record(fmt: TernaryFormat, prefix: str, arrays: dict) -> dict:
    """``fmt``'s arrays into ``arrays`` as ``<prefix><field>``; returns its
    header ``{"format", "static"}``."""
    for name, t in fmt.arrays().items():
        if t is not None:
            arrays[prefix + name] = _numpy(t)
    return {"format": type(fmt).__name__, "static": fmt.meta()}


def _fmt_restore(hdr: dict, prefix: str, data, device) -> TernaryFormat:
    cls = _format_class(hdr["format"])
    fields = {}
    for name in cls.ARRAY_FIELDS:
        a = _field(data, prefix + name)
        fields[name] = None if a is None else _field_tensor(a, device)
    return cls(**fields, **hdr["static"])


def save_container(path: str, fmt: TernaryFormat, *, gamma: float = 1.0,
                   bias=None, alpha=None) -> None:
    """Save one container with its scale and optional bias and per-column
    slope (the JAX ``save_container``'s layout)."""
    arrays = {}
    header = _fmt_record(fmt, "field_", arrays)
    if bias is not None:
        arrays["bias"] = _numpy(bias)
    if alpha is not None:
        arrays["alpha"] = _numpy(alpha)
    arrays["header"] = _encode({**header, "gamma": float(gamma)})
    np.savez(_npz(path), **arrays)


def load_container(path: str, device="cuda"):
    """Load a container file (either package's) -> ``(fmt, gamma, bias,
    alpha)``, the tensors on ``device`` (the card unless ``device="cpu"``;
    raises without one); bias and alpha None where the file has none."""
    device = resolve_device(device)
    with np.load(_npz(path)) as data:
        header = _decode(data)
        cls = _format_class(header["format"])
        if f"field_{cls.ARRAY_FIELDS[0]}" in data:
            fmt = _fmt_restore(header, "field_", data, device)
        else:   # the legacy positional layout
            fmt = cls(**header["static"], **{
                name: _field_tensor(data[f"leaf_{i}"], device)
                for i, name in enumerate(cls.ARRAY_FIELDS)})
        bias, alpha = (None if k not in data else _tensor(data[k], device)
                       for k in ("bias", "alpha"))
    return fmt, header["gamma"], bias, alpha


def _linear_record(lin, prefix: str, arrays: dict) -> dict:
    hdr = {"fmt": _fmt_record(lin.fmt, f"{prefix}.fmt.", arrays),
           "fmt_t": (None if lin.fmt_t is None else
                     _fmt_record(lin.fmt_t, f"{prefix}.fmt_t.", arrays)),
           "gamma": float(lin.gamma), "kernel": jax_name(lin.kernel),
           "has_alpha": lin.alpha is not None, "a8": bool(lin.a8)}
    arrays[f"{prefix}.bias"] = _numpy(lin.bias)
    if lin.alpha is not None:
        arrays[f"{prefix}.alpha"] = _numpy(lin.alpha)
    return hdr


def _linear_restore(hdr: dict, prefix: str, data, device):
    from ternary_spgemm_tpu_torch.models.exported import ExportedBitLinear

    return ExportedBitLinear(
        _fmt_restore(hdr["fmt"], f"{prefix}.fmt.", data, device),
        hdr["gamma"], data[f"{prefix}.bias"],
        data[f"{prefix}.alpha"] if hdr["has_alpha"] else None,
        kernel=port_name(hdr["kernel"]), a8=hdr.get("a8", False),
        fmt_t=(None if hdr["fmt_t"] is None else
               _fmt_restore(hdr["fmt_t"], f"{prefix}.fmt_t.", data, device)))


def _split_qkv(block) -> dict:
    """``wq``/``wk``/``wv`` of a merged-QKV block, in the form the JAX
    export keeps them beside the merged container: each column segment of
    the merged container re-packed with its ``tkb`` and ``tile_n``, its
    gamma the segment's scale (which must be one value), its bias the
    segment's, the block's kernel and A8 regime. The JAX block reads its
    A8 regime from ``wq``, so a bundle without them would run the merged
    QKV outside A8 there."""
    from ternary_spgemm_tpu_torch.models.exported import ExportedBitLinear

    fmt = block.qkv.fmt
    if not isinstance(fmt, TiledBitplane):
        raise NotImplementedError(
            f"re-packing a merged {type(fmt).__name__} QKV into wq/wk/wv is "
            "not supported; the port merges TiledBitplane only")
    d, kvw = block.cfg.d_model, block.cfg.kv_width
    W = fmt.to_dense()
    out = {}
    for name, lo, hi in (("wq", 0, d), ("wk", d, d + kvw),
                         ("wv", d + kvw, d + 2 * kvw)):
        scale = block.qkv.scale[lo:hi]
        if not bool((scale == scale[0]).all()):
            raise ValueError(f"the merged QKV's scale is not one value over "
                             f"the {name} segment, so it has no gamma")
        out[name] = ExportedBitLinear(
            TiledBitplane.from_dense(W[:, lo:hi].contiguous(), tkb=fmt.tkb,
                                     tile_n=fmt.tile_n),
            float(scale[0]), block.qkv.bias[lo:hi], kernel=block.kernel,
            a8=block.a8)
    return out


def save_lm_bundle(path: str, lm) -> None:
    """Save an :class:`~ternary_spgemm_tpu_torch.models.ExportedTransformerLM`
    as one serving bundle in the JAX package's format.

    The header's ``cfg`` has the JAX ``BitTransformerConfig``'s fields,
    each linear's and block's ``kernel`` the JAX registry's name, ``fmt_t``
    the linear's transposed container (else null); a bf16
    embedding is stored as its raw ``uint16`` bits with ``embed_dtype:
    "bfloat16"``. A merged-QKV block without ``wq``/``wk``/``wv`` gets them
    from :func:`_split_qkv`, listed under the block's ``"derived"`` key
    (which the JAX loader ignores and :func:`load_lm_bundle` drops). An
    MoE block adds ``b{i}.moe.router`` and its ``"moe"`` list, a linear
    record an expert under ``b{i}.moe.e{e}.{w_gate, w_up, w_down}``."""
    from ternary_spgemm_tpu_torch.models.moe import EXPERT_LINEARS

    emb = lm.embed.detach().cpu()
    if emb.dtype == torch.bfloat16:
        embed_dtype = "bfloat16"
        emb = emb.view(torch.int16).numpy().view(np.uint16)
    else:
        embed_dtype = str(emb.numpy().dtype)
        emb = emb.numpy()
    arrays = {"embed": emb, "norm_out": _numpy(lm.norm_out)}
    blocks = []
    for i, blk in enumerate(lm.blocks):
        linears = dict(blk.linears)
        bh = {"linears": {}, "fused_ffn": bool(blk.fused_ffn),
              "kernel": jax_name(blk.kernel)}
        if blk.qkv is not None and not any(n in linears for n in QKV_LINEARS):
            linears = {**_split_qkv(blk), **linears}
            bh["derived"] = list(QKV_LINEARS)
        for name, lin in linears.items():
            bh["linears"][name] = _linear_record(lin, f"b{i}.{name}", arrays)
        if blk.qkv is not None:
            bh["qkv"] = _fmt_record(blk.qkv.fmt, f"b{i}.qkv.fmt.", arrays)
            arrays[f"b{i}.qkv.scale"] = _numpy(blk.qkv.scale)
            arrays[f"b{i}.qkv.bias"] = _numpy(blk.qkv.bias)
        arrays[f"b{i}.norm_attn"] = _numpy(blk.norm_attn)
        arrays[f"b{i}.norm_ffn"] = _numpy(blk.norm_ffn)
        if blk.moe is not None:
            arrays[f"b{i}.moe.router"] = _numpy(blk.moe.router)
            bh["moe"] = [{n: _linear_record(ex[n], f"b{i}.moe.e{e}.{n}",
                                            arrays) for n in EXPERT_LINEARS}
                         for e, ex in enumerate(blk.moe.experts)]
        blocks.append(bh)
    arrays["header"] = _encode({
        "version": BUNDLE_VERSION, "cfg": dataclasses.asdict(lm.cfg),
        "embed_dtype": embed_dtype, "blocks": blocks})
    np.savez(_npz(path), **arrays)


def load_lm_bundle(path: str, device="cuda"):
    """Load a serving bundle (either package's) -> ``ExportedTransformerLM``
    built on ``device`` (the card unless ``device="cpu"``; raises without
    one). Transposed containers are placed with the rest of their linear,
    so a bundle that has them backpropagates (one without stays
    forward-only); the ``"derived"`` ``wq``/``wk``/``wv`` that
    :func:`save_lm_bundle` wrote are dropped. An MoE block's experts come
    from its ``"moe"`` list (one ``{w_gate, w_up, w_down}`` linear record
    an expert, each with its ``a8`` flag) and its ``b{i}.moe.router``; a
    block whose list does not hold ``cfg.moe_experts`` experts raises."""
    from ternary_spgemm_tpu_torch.models.generate import ExportedTransformerLM
    from ternary_spgemm_tpu_torch.models.moe import (
        EXPERT_LINEARS, ExportedMoE, moe_config)
    from ternary_spgemm_tpu_torch.models.transformer import (
        BitTransformerConfig, ExportedTransformerBlock, MergedQKV)

    device = resolve_device(device)
    with np.load(_npz(path)) as data:
        header = _decode(data)
        if header.get("version") != BUNDLE_VERSION:
            raise ValueError(f"bundle version {header.get('version')!r}; "
                             f"this loader reads {BUNDLE_VERSION}")
        cfg = BitTransformerConfig(**header["cfg"])
        blocks = []
        for i, bh in enumerate(header["blocks"]):
            derived = set(bh.get("derived", ()))
            hdrs = bh["linears"]
            linears = {n: _linear_restore(h, f"b{i}.{n}", data, device)
                       for n, h in hdrs.items() if n not in derived}
            qkv = None
            if bh.get("qkv") is not None:
                qkv = MergedQKV(
                    _fmt_restore(bh["qkv"], f"b{i}.qkv.fmt.", data, device),
                    data[f"b{i}.qkv.scale"], data[f"b{i}.qkv.bias"])
            experts = bh.get("moe", [])
            if len(experts) != cfg.moe_experts:
                raise ValueError(f"block {i} of the bundle holds "
                                 f"{len(experts)} experts; its cfg has "
                                 f"moe_experts={cfg.moe_experts}")
            moe = None
            if experts:
                moe = ExportedMoE(moe_config(cfg), data[f"b{i}.moe.router"], [
                    {n: _linear_restore(eh[n], f"b{i}.moe.e{e}.{n}", data,
                                        device) for n in EXPERT_LINEARS}
                    for e, eh in enumerate(experts)])
            blocks.append(ExportedTransformerBlock(
                cfg, linears, data[f"b{i}.norm_attn"], data[f"b{i}.norm_ffn"],
                fused_ffn=bh.get("fused_ffn", False), qkv=qkv,
                kernel=port_name(bh.get("kernel")),
                a8=hdrs.get("wq", {}).get("a8", False), moe=moe))
        embed, head_dtype = data["embed"], None
        edt = header.get("embed_dtype", "float32")
        if edt == "bfloat16":
            embed = torch.from_numpy(embed.view(np.int16)).view(torch.bfloat16)
            head_dtype = torch.bfloat16
        elif edt != "float32":
            raise ValueError(f"embed_dtype {edt!r}: the port's head is f32 "
                             "or bf16")
        return ExportedTransformerLM(cfg, blocks, embed, data["norm_out"],
                                     head_dtype=head_dtype)


def _leaves(tree) -> list:
    """``tree``'s leaves in ``jax.tree_util``'s order: a dict's values by
    sorted key (an OrderedDict's in its own order), a list's or tuple's in
    order, no leaf for None."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = tree if isinstance(tree, OrderedDict) else sorted(tree)
        return [leaf for k in keys for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in _leaves(child)]
    return [tree]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in turn from the iterator
    ``leaves`` (the order of :func:`_leaves`); an array where ``like`` has a
    tensor becomes a tensor on its device."""
    if like is None:
        return None
    if isinstance(like, dict):
        keys = like if isinstance(like, OrderedDict) else sorted(like)
        values = {k: _rebuild(like[k], leaves) for k in keys}
        return type(like)((k, values[k]) for k in like)
    if isinstance(like, (list, tuple)):
        children = [_rebuild(c, leaves) for c in like]
        if hasattr(like, "_fields"):              # a namedtuple
            return type(like)(*children)
        return type(like)(children)
    arr = next(leaves)
    if isinstance(like, torch.Tensor) and isinstance(arr, np.ndarray):
        return _tensor(arr, like.device)
    return arr


def save_pytree(path: str, tree) -> None:
    """Save a tree of tensors or arrays (dicts, lists, tuples, None) as the
    ``.npz`` the JAX ``save_pytree`` writes where orbax is not importable:
    ``leaf_<i>`` in ``jax.tree_util``'s flatten order."""
    np.savez(_npz(path), **{f"leaf_{i}": _numpy(leaf)
                            for i, leaf in enumerate(_leaves(tree))})


def restore_pytree(path: str, like):
    """Restore a :func:`save_pytree` file (either package's ``.npz``) into
    ``like``'s structure: a leaf that is a tensor in ``like`` comes back a
    tensor on its device, any other a numpy array. An orbax directory (what
    the JAX ``save_pytree`` writes where orbax is importable) raises."""
    p = _npz(path)
    if not os.path.exists(p):
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory: an orbax checkpoint, which the JAX "
                "package's save_pytree writes where orbax is importable. "
                "The port reads only the .npz layout (leaf_<i> in "
                "jax.tree_util's flatten order): save the tree where orbax "
                "is not importable, or with this package's save_pytree")
        raise FileNotFoundError(p)
    n = len(_leaves(like))
    with np.load(p) as data:
        stored = sum(k.startswith("leaf_") for k in data.files)
        if stored != n:
            raise ValueError(f"{p} holds {stored} leaves; the tree given as "
                             f"`like` has {n}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(like, iter(leaves))


def _index_key(ranges) -> str:
    """The JAX package's key of a block: ``[[start, stop], ...]`` a dim, as
    JSON."""
    return json.dumps([[int(a), int(b)] for a, b in ranges])


def _block_ranges(t) -> list:
    """The global ``[start, stop)`` of each dim of the block this rank
    holds of ``t``: a DTensor's local block (its Shard placements applied
    in mesh-dim order, with ``torch.chunk``'s sizes), the whole of
    anything else."""
    from torch.distributed.tensor import DTensor

    shape = list(np.shape(t))
    start, length = [0] * len(shape), list(shape)
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        for i, p in enumerate(t.placements):
            if p.is_partial():
                raise ValueError("a Partial DTensor has no blocks to save: "
                                 "redistribute it first")
            if p.is_shard():
                d, n = p.dim, mesh.size(i)
                c = mesh.get_local_rank(i)
                chunk = -(-length[d] // n)
                start[d] += c * chunk
                length[d] = max(0, min(chunk, length[d] - c * chunk))
    return [(a, a + n) for a, n in zip(start, length)]


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def save_sharded_pytree(path: str, tree) -> None:
    """Every rank writes only the blocks it holds of ``tree``'s leaves
    (DTensors, tensors or arrays, in :func:`save_pytree`'s order) to
    ``path.shard{rank}.npz``; no rank gathers a whole array. A rank holds
    one block of each leaf (a leaf that is not a DTensor: all of it), so
    its record ``j`` is 0; the JAX package writes the blocks of all of a
    process's devices, a replicated block once. The blocks of the ranks'
    files together are the JAX file's for the same layout, key for key and
    byte for byte."""
    from torch.distributed.tensor import DTensor

    arrays, header = {}, []
    for i, leaf in enumerate(_leaves(tree)):
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        a = _numpy(local)
        arrays[f"l{i}s0"] = a
        header.append({"shape": list(np.shape(leaf)), "dtype": str(a.dtype),
                       "indices": [_index_key(_block_ranges(leaf))]})
    arrays["header"] = _encode(header)
    np.savez(f"{path}.shard{_rank()}.npz", **arrays)


def restore_sharded_pytree(path: str, like):
    """Restore a :func:`save_sharded_pytree` checkpoint (either package's)
    into ``like``'s structure and layout: each rank reads only its own
    ``path.shard{rank}.npz`` and takes, for each leaf, the saved block
    whose global index range is the one its target holds (a DTensor leaf
    of ``like``: its local block, rebuilt as a DTensor of the same
    placements; a tensor: the whole array on its device; anything else: a
    numpy array). Blocks are matched by index range, not by rank, so the
    target layout must hold the same index set a rank as the save; JAX's
    two errors otherwise."""
    from torch.distributed.tensor import DTensor

    leaves_like = _leaves(like)
    with np.load(f"{path}.shard{_rank()}.npz") as data:
        header = _decode(data)
        out = []
        for i, ref in enumerate(leaves_like):
            shape = tuple(header[i]["shape"])
            if shape != tuple(np.shape(ref)):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {shape} != target "
                    f"{tuple(np.shape(ref))}")
            saved = {key: f"l{i}s{j}"
                     for j, key in enumerate(header[i]["indices"])}
            key = _index_key(_block_ranges(ref))
            if key not in saved:
                dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
                raise ValueError(
                    f"leaf {i}: no saved shard covers index {key} needed by "
                    f"device {dev} — restore layout must match the saved "
                    "shard index set per process")
            a = data[saved[key]]
            if isinstance(ref, DTensor):
                out.append(DTensor.from_local(
                    _tensor(a, ref.to_local().device), ref.device_mesh,
                    ref.placements, run_check=False, shape=ref.shape,
                    stride=ref.stride()))
            else:
                out.append(a)
    return _rebuild(like, iter(out))

