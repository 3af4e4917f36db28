"""The truly-ragged-CSC question, measured on the card.

Counterpart of ``tools/ragged_probe.py``. A per-column ragged CSC stream
(one byte a nonzero, 8/s bits a weight) is the only layout that stores
less than the 2-bit bitplane for s > 32. Its consumer reads a flat (row,
column) entry stream and deposits each entry's bit into the word its
column picks. On the TPU only the scalar core can consume such a stream,
one entry at a time; on the card every SM can, with shared-memory atomics,
so ``csrc/ragged.cu`` spreads the stream over the whole card (a grid of
:func:`deposit_plan`, each block ORing its share into its own tile in
shared memory, the blocks' tiles merged over thread block clusters), and
what bounds it is the stream's bytes. The tool measures what settles the
question:

1. **Scalar-deposit rate** (:func:`scalar_deposit_rate`): 4096 (row, lane,
   bit) entries, drawn as the JAX tool draws them, deposited into a zeroed
   (8, 128) int32 tile, the JAX record's size and key. At 49 KB this times
   a launch, not a rate. (The TPU's Mosaic refused this kernel, "Cannot
   store scalars to VMEM"; the card runs it.)
2. **High-sparsity kernel times**: ``CudaTiledBitplane_i8`` (2 bits a
   weight, positional) against ``CudaEllDeposit_i8`` (cap-padded ELL)
   through ``bench.run_config`` at M = 32, K = N in {4096, 11008}, s in
   {16, 32, 64}, the two designs that bracket the ragged stream, each as a
   user calls it: at M = 32 the bitplane kernel takes its decode branch
   (up to ``ops.cuda_kernels.I8_MMA_MIN_M`` rows), which its rows name
   (``branch``; None for the ELL kernel).
3. **The ragged floor**: the deposit time alone of a ragged stream over the
   same W, measured a config by :func:`scalar_deposit_rate` at the
   config's own nonzeros (the same draws, :func:`scalar_entries`), written
   as ``nnz / entries_per_s`` beside that rate. nnz is counted from the
   container (about K * N / s: ``generate_ternary`` places ``2 * ((N //
   s) // 2)`` nonzeros a row); the JAX tool's ``2 * kn * kn // s``
   (``tools/ragged_probe.py:121``) counts twice that, at its one rate.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.ragged_probe [--kn 4096 11008]
        [--s-values 16 32 64] [--M 32] [--device cuda|cpu] [--out PATH]

It prints the kernel rows and one JSON object with the JAX record's keys
(``purpose``, ``scalar_deposit``, ``high_sparsity``,
``ragged_floor_analysis``) and the device; a file only with ``--out``. On
the CPU every time is the plain versions' host-clock time.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ternary_spgemm_tpu_torch.bench import BenchConfig, run_config
from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.cuda_kernels import (
    i8_branch,
    launches,
    note_plain,
    stream_handle,
)
from ternary_spgemm_tpu_torch.tools import emit, timer
from ternary_spgemm_tpu_torch.utils.device import resolve_device, sm_count

KERNEL_NAME = "scalar_deposit_rate"
SOURCE = "ternary_spgemm_tpu_torch/csrc/ragged.cu"
REFERENCE = "tools/ragged_probe.py:37"
ROWS, LANES, BITS = 8, 128, 31
#: the two designs that bracket the ragged stream (the JAX tool's pair)
KERNELS = ["CudaTiledBitplane_i8", "CudaEllDeposit_i8"]
#: ``csrc/ragged.cu``'s grid: blocks in clusters of ``DEPOSIT_CLUSTER``
#: (its ``kCluster``), at most ``DEPOSIT_BLOCKS_PER_SM`` an SM (the blocks
#: its ``__launch_bounds__`` asks an SM to hold), none given fewer than
#: ``DEPOSIT_MIN_ENTRIES`` entries unless the stream is short (one group of
#: four entries a thread of its 256)
DEPOSIT_CLUSTER = 8
DEPOSIT_BLOCKS_PER_SM = 2
DEPOSIT_MIN_ENTRIES = 1024


def scalar_entries(entries: int = 4096) -> np.ndarray:
    """(entries, 3) int32 (row < 8, lane < 128, bit < 31): the JAX tool's
    three draws from ``default_rng(0)`` (``tools/ragged_probe.py:61-64``)."""
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, ROWS, entries),
                     rng.integers(0, LANES, entries),
                     rng.integers(0, BITS, entries)], axis=1).astype(np.int32)


def _check(ents: torch.Tensor) -> None:
    if ents.dim() != 2 or ents.shape[1] != 3 or ents.dtype != torch.int32 \
            or not ents.is_contiguous():
        raise ValueError("entries must be a contiguous (n, 3) int32 tensor "
                         f"of (row, lane, bit); got {ents.dtype} "
                         f"{tuple(ents.shape)}")


def scalar_deposit_plain(ents: torch.Tensor) -> torch.Tensor:
    """The plain version: word (r, c) of the (8, 128) int32 tile is the OR of
    ``1 << b`` over the entries (r, c, b)."""
    note_plain(KERNEL_NAME, ents)
    _check(ents)
    e = ents.to(torch.int64)
    present = torch.zeros((ROWS * LANES, BITS), dtype=torch.bool,
                          device=ents.device)
    present[e[:, 0] * LANES + e[:, 1], e[:, 2]] = True
    weights = torch.ones(BITS, dtype=torch.int64, device=ents.device) \
        << torch.arange(BITS, device=ents.device)
    return (present.to(torch.int64) * weights).sum(dim=1).to(
        torch.int32).reshape(ROWS, LANES)


def deposit_plan(n: int, sms: int) -> tuple:
    """-> (blocks, per_block): the kernel's grid over ``n`` entries on a
    card of ``sms`` SMs. Block b takes entries ``[b * per_block, min(n, (b +
    1) * per_block))``; ``per_block`` is a multiple of 4 (so that every
    block's 16-byte loads share one alignment) and ``blocks`` a multiple of
    ``DEPOSIT_CLUSTER``, enough to fill the card once the stream gives each
    block ``DEPOSIT_MIN_ENTRIES``; the last blocks may take fewer entries,
    or none."""
    want = min(sms * DEPOSIT_BLOCKS_PER_SM, -(-n // DEPOSIT_MIN_ENTRIES))
    blocks = max(1, -(-want // DEPOSIT_CLUSTER)) * DEPOSIT_CLUSTER
    return blocks, max(4, 4 * -(-n // (4 * blocks)))


def scalar_deposit_launch(ents: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel over the entries (on the grid of
    :func:`deposit_plan`) -> the (8, 128) int32 tile."""
    _check(ents)
    if ents.shape[0] >= 2 ** 31:
        raise ValueError(f"{KERNEL_NAME} takes fewer than 2**31 entries (a C "
                         f"int); got {ents.shape[0]}")
    if not ents.is_cuda:
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors (CPU tensors "
                         "take the plain version)")
    blocks, per_block = deposit_plan(ents.shape[0], sm_count(ents.device))
    tile = torch.empty((ROWS, LANES), dtype=torch.int32, device=ents.device)
    err = _build.load().ternary_scalar_deposit(
        ents.data_ptr(), ents.shape[0], blocks, per_block, tile.data_ptr(),
        stream_handle(ents.device))
    _build.check(err, "ternary_scalar_deposit")
    launches[KERNEL_NAME] += 1
    return tile


def scalar_deposit(ents: torch.Tensor) -> torch.Tensor:
    """The probe's function: the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if ents.device.type == "cpu":
        return scalar_deposit_plain(ents)
    return scalar_deposit_launch(ents)


def scalar_deposit_rate(entries: int = 4096, device="cuda") -> dict:
    """Entries a second of the deposit of ``scalar_entries(entries)`` (the
    launch alone, ``bench.timing``'s CUDA-event timer with the L2 evicted
    before each; on the CPU the plain version's host time). At the default
    4096 entries, the JAX record's, it times a launch."""
    dev = resolve_device(device)
    ents = torch.from_numpy(scalar_entries(entries)).to(dev)
    t = timer(dev)(scalar_deposit, ents, min_seconds=0.2)
    return {"entries": entries, "seconds": t.seconds,
            "entries_per_s": entries / t.seconds}


def high_sparsity_rows(kns, s_values, M: int, dev: torch.device):
    """-> (rows, nnz): the JAX tool's rows (``tools/ragged_probe.py:101-114``),
    one a kernel and config, ``container_bytes`` the container's own
    (``TernaryFormat.size_bytes``, not the JAX tool's subtraction from the
    total); and each config's nonzeros, counted from its container, by
    ``(kn, s)``."""
    rows, nnz = [], {}
    for kn in kns:
        for s in s_values:
            cfg = BenchConfig(
                M=M, K=kn, N=kn, s=s, correctness=False, min_seconds=0.15,
                kernels=list(KERNELS), device=dev.type,
                timer="cuda_events" if dev.type == "cuda" else "wall")
            print(f"K=N={kn} s={s}", flush=True)
            for r in run_config(cfg, verbose=True):
                rows.append({"K": kn, "N": kn, "s": s, "kernel": r.name,
                             "branch": (i8_branch(M, dev)
                                        if r.name == KERNELS[0] else None),
                             "seconds": r.seconds, "error": r.error,
                             "container_bytes": r.container_bytes})
                if r.nnz is not None:
                    nnz[(kn, s)] = r.nnz
    return rows, nnz


def ragged_floor_analysis(nnz: dict, rates: dict) -> dict:
    """The ragged stream's deposit floor a config: its nonzeros over the
    rate :func:`scalar_deposit_rate` measured at those nonzeros (``rates``,
    by ``(kn, s)``), beside that rate (None where no kernel built the
    container)."""
    floors, per_s = {}, {}
    for (kn, s), n in nnz.items():
        key = f"KN={kn},s={s}"
        per_s[key] = None if n is None else rates[(kn, s)]["entries_per_s"]
        floors[key] = None if n is None else n / per_s[key]
    return {
        "note": "ragged stream floor = nnz / entries_per_s, the deposit of "
                "the config's nnz entries timed at that size (deposit only, "
                "before decode+dot; nnz counted from the container); "
                "compare with the measured kernels",
        "floors_seconds": floors,
        "entries_per_s": per_s,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.ragged_probe")
    p.add_argument("--kn", type=int, nargs="*", default=[4096, 11008])
    p.add_argument("--s-values", type=int, nargs="*", default=[16, 32, 64])
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    result = {"purpose": __doc__.splitlines()[0], "device": device_name(dev)}
    sd = result["scalar_deposit"] = scalar_deposit_rate(device=dev)
    print(f"scalar deposit: {sd['entries']} entries, "
          f"{sd['entries_per_s']:.4g} entries/s [{result['device']}]",
          flush=True)
    rows, nnz = high_sparsity_rows(args.kn, args.s_values, args.M, dev)
    result["high_sparsity"] = rows
    nnz = {(kn, s): nnz.get((kn, s)) for kn in args.kn for s in args.s_values}
    rates = {}
    for (kn, s), n in nnz.items():
        if n is not None:
            r = rates[(kn, s)] = scalar_deposit_rate(n, device=dev)
            print(f"deposit K=N={kn} s={s}: {n} entries, "
                  f"{r['entries_per_s']:.4g} entries/s", flush=True)
    result["ragged_floor_analysis"] = ragged_floor_analysis(nnz, rates)
    emit(result, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
