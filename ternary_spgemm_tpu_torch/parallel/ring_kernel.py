"""Ring all-gather SpMM — counterpart of
``ternary_spgemm_tpu/parallel/ring_kernel.py``.

``Y = X @ W + b`` with X (M, K) cut row-wise into d chunks of ``mc = M //
d`` rows, and the int8 ternary W (a :class:`DenseTernary`) and the bias cut
column-wise into d shards of ``NL = N // d`` columns. Rank ``r`` holds
chunk ``r`` and shard ``r``; at each of d steps it starts copying the chunk
it holds to its right neighbour, and while the copy is in flight it
multiplies that chunk by its shard into rows ``owner * mc`` of its Y
columns, ``owner = (r - t) mod d``. The chunks are double-buffered, and an
ack goes back to the left neighbour before a slot is overwritten (ranks can
lag each other by up to ``d - 1`` steps). Y is the (M, N) array that the
JAX kernel's ``P(None, axis)`` output assembles to.

Two ways to run it, one body of the hand-written kernel ``csrc/ring.cu``:

* **One rank a process**, the JAX kernel's topology (one rank a chip):
  :func:`ring_allgather_spgemm` with JAX's ``mesh=`` and ``axis=``, or
  :func:`ring_rank_local` over a process group. Each process makes its own
  launch for its rank (``ternary_ring_rank``) and stores into its right
  neighbour's slots and flags through peer pointers that CUDA IPC opened
  (:class:`RingComm`); the process group only carries the 64-byte handles.
  The mesh path is for an NCCL mesh over several cards. On one card NCCL
  refuses two ranks on the same device, so the card's tests and
  ``chip_smoke.py`` call :func:`ring_rank_local` over a gloo group whose
  processes all use ``cuda:0``; the card then time-slices the ranks'
  kernels. That proves the rendezvous, the peer pointers, the flags across
  processes and the per-rank launch, but neither the link nor the overlap.
* **All ranks in one launch** (``ranks=``): the d ranks are groups of
  blocks of one cooperative launch (``ternary_ring_spgemm``), their
  "remote" buffers in the same device memory: the counterpart of the JAX
  tests, which emulate the ring's chips, remote copies and semaphores on
  one host in Pallas interpret mode.

On CPU tensors the plain versions run instead: :func:`ring_rank_plain`
sends the chunks with ``torch.distributed`` point-to-point calls, and
:func:`ring_allgather_spgemm_plain` runs every rank's steps in one process.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ternary_spgemm_tpu_torch.formats.base import as_f32
from ternary_spgemm_tpu_torch.formats.packed import DenseTernary
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.api import matmul_dense
from ternary_spgemm_tpu_torch.ops.cuda_kernels import (
    check_dense,
    check_f32,
    launches,
    note_plain,
    stream_handle,
)
from ternary_spgemm_tpu_torch.parallel.sharding import (
    column_leaf_specs,
    local_container,
    local_part,
)
from ternary_spgemm_tpu_torch.parallel.spgemm import _global, axis_size
from ternary_spgemm_tpu_torch.utils.device import resolve_device

KERNEL_NAME = "ring_allgather_spgemm"
SOURCE = "ternary_spgemm_tpu_torch/csrc/ring.cu"
REFERENCE = "ternary_spgemm_tpu/parallel/ring_kernel.py:92"
#: int32 flags a rank: ready, recv (2 slots), ack (2 slots)
FLAGS_PER_RANK = 5
#: bytes at the head of a rank's IPC buffer that hold its flags; its two
#: chunk slots follow (16-byte aligned, as the chunk copies need)
FLAG_BYTES = 256
#: bytes of a ``cudaIpcMemHandle_t``
IPC_HANDLE_BYTES = 64


def ring_geometry(M: int, N: int, ranks: int):
    """(mc, NL): the chunk rows and shard columns of a ring of ``ranks``;
    raises JAX's errors (``ring_kernel.py:101-105``) for the same inputs,
    and for a width the ranks do not divide (which JAX's sharding
    refuses)."""
    if ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    if M % ranks:
        raise ValueError(f"M={M} not divisible by ring size {ranks}")
    mc = M // ranks
    if mc % 8:
        raise ValueError(f"chunk rows {mc} not a multiple of 8 (pad M)")
    if N % ranks:
        raise ValueError(f"N={N} not divisible by ring size {ranks}")
    return mc, N // ranks


def _check_format(fmt) -> None:
    if not isinstance(fmt, DenseTernary):
        raise TypeError(f"the ring takes a DenseTernary, got "
                        f"{type(fmt).__name__}")


def _check(X: torch.Tensor, fmt: DenseTernary, bias: torch.Tensor,
           ranks: int):
    _check_format(fmt)
    if len(X.shape) != 2 or X.shape[1] != fmt.K:
        raise ValueError(f"X must be (M, {fmt.K}), got {tuple(X.shape)}")
    if tuple(bias.shape) != (fmt.N,):
        raise ValueError(f"bias must be ({fmt.N},), got {tuple(bias.shape)}")
    return ring_geometry(X.shape[0], fmt.N, ranks)


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` is the current card, as
    the tensors put there are."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class RingComm:
    """One rank's end of a ring over the process group ``group``, for
    chunks of ``(mc, K)`` f32.

    On a CUDA device it holds the rank's IPC buffer (its flags and its two
    chunk slots, ``cudaMalloc``'d and zeroed), the peer pointers of its two
    neighbours' buffers (each opened once: at d = 2 they are one rank; at d
    = 1 there is none, and a process never opens its own handle), and the
    blocks that its earlier calls launched (``epoch``, modulo 2**32: the
    kernel offsets every wait by the epoch times what a call adds to the
    counter a block, ``csrc/ring.cu``'s ``call_adds``). Making one is a
    collective: every rank of the group makes it at the same point, and
    the handles travel by ``all_gather_object`` over ``group`` (any
    backend), which returns on no rank before every rank's buffer is zeroed.
    The calls on it are collectives too: every rank makes the same calls in
    the same order, on one stream. :meth:`close` (or leaving a ``with``
    block) unmaps the peers, meets the group at a barrier and frees the
    buffer. On the CPU it holds the group and nothing else."""

    def __init__(self, group, mc: int, K: int, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.d = dist.get_world_size(group)
        self.mc, self.K = mc, K
        self.device = _indexed(device)
        self.left = (self.rank - 1) % self.d
        self.right = (self.rank + 1) % self.d
        self.calls = 0
        self.epoch = 0
        #: group rank -> the base of its buffer in this process
        self.base = {}
        self._opened = []
        if self.device.type == "cuda":
            self._share()

    def _share(self) -> None:
        lib = _build.load()
        nbytes = FLAG_BYTES + 2 * self.mc * self.K * 4
        with torch.cuda.device(self.device):
            ptr = ctypes.c_void_p()
            _build.check(lib.ternary_ipc_alloc(nbytes, ctypes.addressof(ptr)),
                         "ternary_ipc_alloc")
            self.base[self.rank] = ptr.value
            handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
            _build.check(lib.ternary_ipc_handle(ptr, handle),
                         "ternary_ipc_handle")
            handles = [None] * self.d
            dist.all_gather_object(handles, handle.raw, group=self.group)
            for p in sorted({self.left, self.right} - {self.rank}):
                peer = ctypes.c_void_p()
                _build.check(lib.ternary_ipc_open(
                    handles[p], ctypes.addressof(peer)), "ternary_ipc_open")
                self.base[p] = peer.value
                self._opened.append(p)

    def flags(self, p: int) -> int:
        """The address of group rank ``p``'s flag block (this rank or a
        neighbour) in this process."""
        return self.base[p]

    def slots(self, p: int) -> int:
        """The address of group rank ``p``'s chunk slots ``(2, mc, K)``."""
        return self.base[p] + FLAG_BYTES

    def close(self) -> None:
        if not self.base:
            return
        lib = _build.load()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            for p in self._opened:
                _build.check(lib.ternary_ipc_close(self.base[p]),
                             "ternary_ipc_close")
            dist.barrier(group=self.group)   # no rank maps it any more
            _build.check(lib.ternary_ipc_free(self.base[self.rank]),
                         "ternary_ipc_free")
        self.base.clear()
        self._opened.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


#: (group, mc, K, device) -> RingComm: the mesh path's communicators
_COMMS: dict = {}


def ring_comm(group, mc: int, K: int, device) -> RingComm:
    """The communicator of ``(group, mc, K)`` on ``device``, made (by every
    rank of the group together) at its first use and reused after, until
    :func:`close_ring_comms`."""
    key = (group, mc, K, _indexed(device))
    if key not in _COMMS:
        _COMMS[key] = RingComm(group, mc, K, key[3])
    return _COMMS[key]


def close_ring_comms() -> None:
    """Close every communicator that the mesh path made (:func:`ring_comm`),
    freeing their IPC buffers and unmapping their peers', in the order they
    were made. A collective, like the calls that made them: every rank
    calls it at the same point, after its last ring call on those groups
    and before their process group is destroyed. A later call makes new
    communicators."""
    while _COMMS:
        _COMMS.pop(next(iter(_COMMS))).close()


def _check_rank(x_chunk, w_local, b_local, comm: RingComm) -> None:
    _check_format(w_local)
    if tuple(x_chunk.shape) != (comm.mc, comm.K) or w_local.K != comm.K:
        raise ValueError(f"the rank's chunk must be ({comm.mc}, {comm.K}) "
                         f"over W rows {comm.K}; got {tuple(x_chunk.shape)} "
                         f"and W {w_local.K} x {w_local.N}")
    if tuple(b_local.shape) != (w_local.N,):
        raise ValueError(f"the rank's bias must be ({w_local.N},), got "
                         f"{tuple(b_local.shape)}")


def ring_rank_plain(x_chunk: torch.Tensor, w_local: DenseTernary,
                    b_local: torch.Tensor, *, comm: RingComm,
                    trace: Optional[List[dict]] = None) -> torch.Tensor:
    """The plain version of :func:`ring_rank_local`: the JAX kernel's steps
    (``ring_kernel.py:42-89``) for this rank, the held chunk sent to the
    right neighbour and the next one received from the left by
    ``batch_isend_irecv`` over ``comm.group``, started before the step's
    product and waited after it. ``trace``, when given, gets one record a
    step: ``{"step", "rank", "owner", "held"}``."""
    note_plain(KERNEL_NAME, x_chunk)
    _check_rank(x_chunk, w_local, b_local, comm)
    d, me, mc = comm.d, comm.rank, comm.mc
    peer = lambda r: dist.get_global_rank(comm.group, r)   # noqa: E731
    W, b = w_local.dense, b_local.to(torch.float32)
    Y = torch.empty((d * mc, w_local.N), dtype=torch.float32,
                    device=x_chunk.device)
    held = x_chunk.to(torch.float32).contiguous()
    for t in range(d):
        reqs, nxt = [], None
        if t < d - 1:
            nxt = torch.empty_like(held)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, held, peer(comm.right), comm.group),
                dist.P2POp(dist.irecv, nxt, peer(comm.left), comm.group)])
        owner = (me - t) % d
        Y[owner * mc:(owner + 1) * mc] = matmul_dense(held, W) + b
        if trace is not None:
            trace.append({"step": t, "rank": me, "owner": owner,
                          "held": held})
        for r in reqs:
            r.wait()
        if nxt is not None:
            held = nxt
    comm.calls += 1
    return Y


def ring_rank_launch(x_chunk: torch.Tensor, w_local: DenseTernary,
                     b_local: torch.Tensor, *, comm: RingComm):
    """This rank's launch of the kernel (``ternary_ring_rank``) -> (Y, B),
    Y its columns (M, NL) and B the blocks of the launch, which the
    communicator's epoch counts."""
    dev = x_chunk.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors (CPU tensors "
                         f"take the plain version); got a tensor on {dev}")
    if comm.device != dev or not comm.base:
        raise ValueError(f"the communicator is on {comm.device}"
                         f"{'' if comm.base else ' and closed'}; the chunk "
                         f"on {dev}")
    _check_rank(x_chunk, w_local, b_local, comm)
    mc, K, NL, d = comm.mc, comm.K, w_local.N, comm.d
    check_f32(x_chunk, (mc, K), dev, f"{KERNEL_NAME}: the chunk")
    if x_chunk.data_ptr() % 16:      # the chunk copies move 16-byte words
        x_chunk = x_chunk.clone()
    W = check_dense(w_local, dev)
    check_f32(b_local, (NL,), dev, f"{KERNEL_NAME}: the bias")
    Y = torch.empty((d * mc, NL), dtype=torch.float32, device=dev)
    blocks = ctypes.c_int(0)
    me, left, right = comm.rank, comm.left, comm.right
    err = _build.load().ternary_ring_rank(
        x_chunk.data_ptr(), W.data_ptr(), b_local.data_ptr(), Y.data_ptr(),
        comm.slots(me), comm.slots(right), comm.flags(me), comm.flags(left),
        comm.flags(right), d, me, mc, K, NL, comm.epoch,
        ctypes.addressof(blocks), stream_handle(dev))
    _build.check(err, "ternary_ring_rank")
    comm.calls += 1
    comm.epoch = (comm.epoch + blocks.value) % 2 ** 32
    launches[KERNEL_NAME] += 1
    return Y, blocks.value


def ring_rank_local(x_chunk: torch.Tensor, w_local: DenseTernary,
                    b_local: torch.Tensor, *, comm: RingComm) -> torch.Tensor:
    """This rank's part of the ring over ``comm.group`` (the JAX kernel's
    body under ``shard_map``): its chunk ``(mc, K)``, its W columns ``(K,
    NL)`` and bias ``(NL,)`` in, its Y columns ``(d * mc, NL)`` out. One
    launch of the per-rank kernel on CUDA tensors
    (:func:`ring_rank_launch`), the plain version on CPU tensors
    (:func:`ring_rank_plain`)."""
    if x_chunk.device.type == "cpu":
        return ring_rank_plain(x_chunk, w_local, b_local, comm=comm)
    return ring_rank_launch(x_chunk, w_local, b_local, comm=comm)[0]


def ring_allgather_spgemm_plain(X: torch.Tensor, fmt: DenseTernary,
                                bias: torch.Tensor, *, ranks: int,
                                trace: Optional[List[dict]] = None
                                ) -> torch.Tensor:
    """The plain version of the whole ring in one process: the JAX kernel's
    schedule (``ring_kernel.py:42-89``) step by step, every rank's double
    buffer a pair of tensors. At step t each rank reads slot ``t % 2``;
    when ``t < ranks - 1`` it first copies that slot into its right
    neighbour's slot ``(t + 1) % 2`` (the slot the neighbour does not read
    at step t), then writes ``buf[slot] @ W_r + b_r`` into rows ``owner *
    mc`` of its columns. ``trace``, when given, gets one record a rank and
    step: ``{"step", "rank", "slot", "owner", "held", "sent_to"}``,
    ``held`` the chunk the rank multiplied and ``sent_to`` ``(rank, slot)``
    of the copy or None."""
    note_plain(KERNEL_NAME, X)
    mc, NL = _check(X, fmt, bias, ranks)
    d = ranks
    X = X.to(torch.float32)
    W, b = fmt.dense, bias.to(torch.float32)
    Y = torch.empty((X.shape[0], fmt.N), dtype=torch.float32, device=X.device)
    buf = [[X[me * mc:(me + 1) * mc].clone(), torch.zeros_like(X[:mc])]
           for me in range(d)]
    for t in range(d):
        slot = t % 2
        for me in range(d):
            right, owner = (me + 1) % d, (me - t) % d
            held = buf[me][slot]
            sent_to = None
            if t < d - 1:
                sent_to = (right, (t + 1) % 2)
                buf[right][(t + 1) % 2] = held.clone()
            cols = slice(me * NL, (me + 1) * NL)
            Y[owner * mc:(owner + 1) * mc, cols] = \
                matmul_dense(held, W[:, cols]) + b[cols]
            if trace is not None:
                trace.append({"step": t, "rank": me, "slot": slot,
                              "owner": owner, "held": held,
                              "sent_to": sent_to})
    return Y


def ring_launch(X: torch.Tensor, fmt: DenseTernary, bias: torch.Tensor, *,
                ranks: int):
    """One cooperative launch of the kernel for the whole ring -> (Y, B),
    B the blocks a rank (the kernel picks it from the card's occupancy)."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors (CPU tensors "
                         f"take the plain version); got a tensor on {dev}")
    mc, _ = _check(X, fmt, bias, ranks)
    M, K, N = X.shape[0], fmt.K, fmt.N
    check_f32(X, (M, K), dev, f"{KERNEL_NAME}: X")
    if X.data_ptr() % 16:      # the chunk copies move 16-byte words
        X = X.clone()
    W = check_dense(fmt, dev)
    check_f32(bias, (N,), dev, f"{KERNEL_NAME}: bias")
    Y = torch.empty((M, N), dtype=torch.float32, device=dev)
    buf = torch.empty((ranks, 2, mc, K), dtype=torch.float32, device=dev)
    flags = torch.empty((FLAGS_PER_RANK * ranks,), dtype=torch.int32,
                        device=dev)
    blocks = ctypes.c_int(0)
    err = _build.load().ternary_ring_spgemm(
        X.data_ptr(), W.data_ptr(), bias.data_ptr(), Y.data_ptr(),
        buf.data_ptr(), flags.data_ptr(), ranks, mc, K, N,
        ctypes.addressof(blocks), stream_handle(dev))
    _build.check(err, "ternary_ring_spgemm")
    launches[KERNEL_NAME] += 1
    return Y, blocks.value


def _mesh_ring(X, fmt: DenseTernary, bias, mesh: DeviceMesh, axis: str,
               dev: torch.device) -> DTensor:
    """One rank a process over ``mesh``'s ``axis`` (the module docstring):
    X row-split, W and bias column-split (DTensors, or whole on every
    rank), Y a DTensor laid out ``(None, axis)``."""
    dev = _indexed(dev)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the ring "
                         f"was asked to run on {dev}")
    mc, _ = _check(X, fmt, bias, axis_size(mesh, axis))
    x = local_part(X, mesh, (axis, None)).to(dev, torch.float32)
    f_local = local_container(fmt, mesh, column_leaf_specs(DenseTernary,
                                                           axis)).to(dev)
    b = local_part(bias, mesh, (axis,)).to(dev, torch.float32)
    comm = ring_comm(mesh.get_group(axis), mc, fmt.K, dev)
    y = ring_rank_local(x.contiguous(), f_local, b.contiguous(), comm=comm)
    return _global(y, mesh, (None, axis))


def ring_allgather_spgemm(X, fmt: DenseTernary, bias, *,
                          mesh: Optional[DeviceMesh] = None,
                          axis: Optional[str] = None,
                          ranks: Optional[int] = None, device=None):
    """``Y = X @ W + b`` over a ring (module docstring); exactly one of
    ``mesh=`` with ``axis=`` and ``ranks=``.

    * ``mesh``, ``axis`` (JAX's signature): one rank a process over the
      mesh's ``axis``. X is split by rows along ``axis``, W and the bias by
      columns; each may be a DTensor or a plain tensor (or numpy array)
      that every rank holds whole. ``M`` must divide into chunks of a
      multiple of 8 rows (JAX's errors). Returns a DTensor laid out
      ``(None, axis)``, whose ``full_tensor()`` is JAX's output. Every rank
      of the axis calls it, as a collective; the communicator of each
      (group, chunk shape) is made at its first call and kept until
      :func:`close_ring_comms`.
    * ``ranks``: the whole ring in this process, one launch of all its
      ranks as groups of blocks; returns the (M, N) tensor.

    Runs on the card unless ``device="cpu"``, which runs the plain
    versions (the mesh then a CPU mesh over gloo)."""
    if (mesh is None) != (axis is None):
        raise TypeError("ring_allgather_spgemm: mesh= and axis= go together")
    if (mesh is None) == (ranks is None):
        raise TypeError("ring_allgather_spgemm takes mesh= and axis= (one "
                        "rank a process) or ranks= (all ranks in one "
                        "launch): exactly one of the two")
    _check_format(fmt)
    dev = resolve_device("cuda" if device is None else device)
    if mesh is not None:
        return _mesh_ring(X, fmt, bias, mesh, axis, dev)
    X, bias = as_f32(X, dev), as_f32(bias, dev)
    if fmt.device != dev:
        fmt = fmt.to(dev)
    if dev.type == "cpu":
        return ring_allgather_spgemm_plain(X, fmt, bias, ranks=ranks)
    return ring_launch(X, fmt, bias, ranks=ranks)[0]
