"""Ring all-gather SpMM — counterpart of
``ternary_spgemm_tpu/parallel/ring_kernel.py``.

``Y = X @ W + b`` with X (M, K) cut row-wise into ``ranks`` chunks of ``mc
= M // ranks`` rows, and the int8 ternary W (a :class:`DenseTernary`) and
the bias cut column-wise into ``ranks`` shards of ``NL = N // ranks``
columns. Rank ``r`` holds chunk ``r`` and shard ``r``; at each of ``ranks``
steps it starts copying the chunk it holds to its right neighbour, and
while the copy is in flight it multiplies that chunk by its shard into rows
``owner * mc`` of its Y columns, ``owner = (r - t) mod ranks``. The chunks
are double-buffered, and an ack goes back to the left neighbour before a
slot is overwritten (ranks can lag each other by up to ``ranks - 1``
steps). Y is the (M, N) array that the JAX kernel's ``P(None, axis)``
output assembles to.

On the card the ranks are groups of blocks of one cooperative launch of the
hand-written kernel ``csrc/ring.cu`` (``ternary_ring_spgemm``), their
"remote" buffers in the same device memory: the counterpart of the JAX
tests, which emulate the ring's chips, remote copies and semaphores on one
host in Pallas interpret mode. On the CPU :func:`ring_allgather_spgemm_plain`
runs the same schedule step by step. Launching the same protocol with one
rank a card needs several cards (peer pointers); it is not here yet.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

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
from ternary_spgemm_tpu_torch.utils.device import resolve_device

KERNEL_NAME = "ring_allgather_spgemm"
SOURCE = "ternary_spgemm_tpu_torch/csrc/ring.cu"
REFERENCE = "ternary_spgemm_tpu/parallel/ring_kernel.py:92"
#: int32 flags a rank: ready, recv (2 slots), ack (2 slots)
FLAGS_PER_RANK = 5


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


def _check(X: torch.Tensor, fmt: DenseTernary, bias: torch.Tensor,
           ranks: int):
    if not isinstance(fmt, DenseTernary):
        raise TypeError(f"the ring takes a DenseTernary, got "
                        f"{type(fmt).__name__}")
    if X.dim() != 2 or X.shape[1] != fmt.K:
        raise ValueError(f"X must be (M, {fmt.K}), got {tuple(X.shape)}")
    if tuple(bias.shape) != (fmt.N,):
        raise ValueError(f"bias must be ({fmt.N},), got {tuple(bias.shape)}")
    return ring_geometry(X.shape[0], fmt.N, ranks)


def ring_allgather_spgemm_plain(X: torch.Tensor, fmt: DenseTernary,
                                bias: torch.Tensor, *, ranks: int,
                                trace: Optional[List[dict]] = None
                                ) -> torch.Tensor:
    """The plain version: the JAX kernel's schedule (``ring_kernel.py:42-89``)
    step by step, every rank's double buffer a pair of tensors. At step t
    each rank reads slot ``t % 2``; when ``t < ranks - 1`` it first copies
    that slot into its right neighbour's slot ``(t + 1) % 2`` (the slot the
    neighbour does not read at step t), then writes ``buf[slot] @ W_r +
    b_r`` into rows ``owner * mc`` of its columns. ``trace``, when given,
    gets one record a rank and step: ``{"step", "rank", "slot", "owner",
    "held", "sent_to"}``, ``held`` the chunk the rank multiplied and
    ``sent_to`` ``(rank, slot)`` of the copy or None."""
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


def ring_allgather_spgemm(X, fmt: DenseTernary, bias, *, ranks: int,
                          device=None) -> torch.Tensor:
    """``Y = X @ W + b`` (M, N) f32 over a ring of ``ranks`` (module
    docstring). ``M`` must divide into ``ranks`` chunks of a multiple of 8
    rows, and ``N`` into ``ranks`` shards. Runs on the card (one launch of
    ``csrc/ring.cu``) unless ``device="cpu"``, which runs the plain version;
    the inputs (numpy or torch) are moved to the device."""
    dev = resolve_device("cuda" if device is None else device)
    X, bias = as_f32(X, dev), as_f32(bias, dev)
    if fmt.device != dev:
        fmt = fmt.to(dev)
    if dev.type == "cpu":
        return ring_allgather_spgemm_plain(X, fmt, bias, ranks=ranks)
    return ring_launch(X, fmt, bias, ranks=ranks)[0]
