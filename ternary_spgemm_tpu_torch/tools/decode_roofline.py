"""Decode rate of the bitplane decode body, and the roofline with decode as
a resource — counterpart of ``tools/decode_roofline.py``.

The decode branch of the flagship ``CudaTiledBitplane_i8`` (its small-M
branch, ``csrc/gemv_core.cuh``) makes four int8 weights from a nibble pair
of its two planes with ``ternary4`` and consumes them with the i8 rule's two
``__dp4a`` a row, ``dp4a(32w, hi) + dp4a(w, lo)``, on the CUDA cores. This
tool measures that decode's rate pi directly: :func:`measure_decode_rate`
runs ``csrc/decode_rate.cu``, ``reps`` repetitions of the body's inner step
(``gemv::consume`` at an M-tile of 8 rows: a lane's pos and neg words of a
byte-row, ``ternary4``, the two ``__dp4a``) over a (2*tkb, tns) plane tile
held in shared memory, into 8 rows of all-ones X. It reports the rate of
all the card's SMs at one block each (132 on an H100 SXM) and of one SM.
Then it measures the card's memory rate beta
(``bench.instrument.measure_hbm_bandwidth``), times both branches of
``CudaTiledBitplane_i8`` at the JAX tool's four configs (on the inputs
``bench.harness.run_config`` makes) and writes a roofline row for each::

    t_bytes  = own_bytes / beta          (f32 X as the kernel reads it, the
                                          container, f32 Y and bias)
    decode branch (ternary4 and the two __dp4a a row, on the CUDA cores):
      t_decode = K * N / pi
      t_dot    = 2 * M * K * N / 1979e12 (the H100's int8 tensor-core peak,
                                          although this branch runs on the
                                          CUDA cores: a floor, not its rate)
    mma branch (the plane bytes decode straight into mma fragments, so no
    decode-rate bound; X as 32*hi + lo, two int8 mma a k-step):
      t_decode = None
      t_dot    = 2 * 2 * M * K * N / 1979e12
    augmented  = (max(t_bytes, t_decode) + t_dot) / t
    overlapped = max(t_bytes, t_decode, t_dot) / t

The registered kernel takes the decode branch up to
``ops.cuda_kernels.I8_MMA_MIN_M`` rows and the mma branch above; each row
names its ``branch``. On the CPU the one row is the plain version's
(``branch`` "plain").

Usage::

    python -m ternary_spgemm_tpu_torch.tools.decode_roofline
        [--configs MxKxNxs ...] [--device cuda|cpu] [--out PATH]

On the CPU the rates are the plain versions' host-clock rates and no
roofline fraction is given (there is no device rate to hold them to).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ternary_spgemm_tpu_torch.bench import instrument, measure_hbm_bandwidth
from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.bench.instrument import INT8_OPS_PER_S
from ternary_spgemm_tpu_torch.formats import (
    TiledBitplane,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.formats.bitplane import decode_planes
from ternary_spgemm_tpu_torch.ops import _build, get_kernel
from ternary_spgemm_tpu_torch.ops.cuda_kernels import (
    _bitplane_i8_lanes,
    _bitplane_i8_mma,
    launches,
    note_plain,
    stream_handle,
)
from ternary_spgemm_tpu_torch.tools import emit, timer
from ternary_spgemm_tpu_torch.utils.device import resolve_device, sm_count

KERNEL_NAME = "decode_rate"
SOURCE = "ternary_spgemm_tpu_torch/csrc/decode_rate.cu"
REFERENCE = "tools/decode_roofline.py:32"
FLAGSHIP = "CudaTiledBitplane_i8"
#: the JAX tool's configs (``tools/decode_roofline.py:87-89``)
DEFAULT_CONFIGS = ["32x1024x4096x4", "32x4096x4096x4", "32x11008x11008x4",
                   "512x4096x4096x4"]
ROWS = 8
#: the flagship's branches on the card, each timed at every config
BRANCHES = {"decode": _bitplane_i8_lanes, "mma": _bitplane_i8_mma}


def decode_rate_plain(plane: torch.Tensor, x: torch.Tensor,
                      reps: int) -> torch.Tensor:
    """The plain version: ``sum_r x @ W_r`` -> (8, tns) int32, ``W_r`` the
    tile perturbed as ``(plane + r) & 0xFF`` decoded by the bitplane row
    map (sums in f64, exact for these sizes). The kernel's contract: x in
    [-127, 127], where its int8 hi / lo split is exact."""
    note_plain(KERNEL_NAME, plane)
    tkb = plane.shape[0] // 2
    acc = torch.zeros((ROWS, plane.shape[1]), dtype=torch.float64,
                      device=plane.device)
    xf = x.to(torch.float64)
    p = plane.to(torch.int32)
    for r in range(reps):
        q = ((p + r) & 0xFF).to(torch.uint8)
        acc += xf @ decode_planes(q[None, None], tkb).to(torch.float64)
    return acc.to(torch.int32)


def _check(plane, x):
    if plane.dim() != 2 or plane.shape[0] % 2 or plane.dtype != torch.uint8 \
            or not plane.is_contiguous():
        raise ValueError("plane must be a contiguous (2*tkb, tns) uint8 "
                         f"tensor, got {plane.dtype} {tuple(plane.shape)}")
    B = 4 * plane.shape[0]
    if tuple(x.shape) != (ROWS, B) or x.dtype != torch.int32 \
            or not x.is_contiguous() or x.device != plane.device:
        raise ValueError(f"x must be a contiguous ({ROWS}, {B}) int32 tensor "
                         f"on {plane.device}")


def decode_rate_launch(plane, x, reps: int, blocks: int) -> torch.Tensor:
    """One launch of ``blocks`` blocks, each decoding the whole tile
    ``reps`` times -> (8, tns) int32 (every block stores the same values)."""
    _check(plane, x)
    if not plane.is_cuda:
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors (CPU tensors "
                         "take the plain version)")
    out = torch.empty((ROWS, plane.shape[1]), dtype=torch.int32,
                      device=plane.device)
    err = _build.load().ternary_decode_rate(
        plane.data_ptr(), plane.shape[0] // 2, plane.shape[1], x.data_ptr(),
        reps, blocks, out.data_ptr(), stream_handle(plane.device))
    _build.check(err, "ternary_decode_rate")
    launches[KERNEL_NAME] += 1
    return out


def decode_rate(plane, x, reps: int, blocks: int = 1) -> torch.Tensor:
    """The probe's function: the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if plane.device.type == "cpu":
        _check(plane, x)
        return decode_rate_plain(plane, x, reps)
    return decode_rate_launch(plane, x, reps, blocks)


def probe_inputs(tkb: int, tns: int, dev, *, seed: int = 0):
    """The probe's tile (random bytes from ``seed``) and all-ones X."""
    g = torch.Generator(device=dev).manual_seed(seed)
    plane = torch.randint(0, 256, (2 * tkb, tns), generator=g, device=dev,
                          dtype=torch.uint8)
    return plane, torch.ones((ROWS, 8 * tkb), dtype=torch.int32, device=dev)


def measure_decode_rate(dev, tkb: int = 128, tns: int = 512,
                        reps: int = 64) -> dict:
    """Weights a second of the decode body's inner step (``ternary4`` and
    the i8 rule's two ``__dp4a`` a row, 8 rows) on a shared-memory-resident
    tile: all SMs (one block each) and one SM."""
    plane, x = probe_inputs(tkb, tns, dev)
    weights = reps * 8 * tkb * tns
    rec = {"tkb": tkb, "tns": tns, "reps": reps}
    if dev.type == "cuda":
        for key, blocks in (("all_sms", sm_count(dev)), ("one_sm", 1)):
            t = timer(dev)(lambda p, xx: decode_rate_launch(p, xx, reps,
                                                            blocks),
                           plane, aux=(x,), min_seconds=0.3)
            rec[key] = {"blocks": blocks, "seconds": t.seconds,
                        "weights_per_s": blocks * weights / t.seconds}
        rec["seconds"] = rec["all_sms"]["seconds"]
        rec["weights_per_s"] = rec["all_sms"]["weights_per_s"]
    else:
        t = timer(dev)(lambda p, xx: decode_rate(p, xx, reps), plane,
                       aux=(x,), min_seconds=0.3)
        rec.update(seconds=t.seconds, weights_per_s=weights / t.seconds)
    rec["note"] = ("the i8 decode body's inner step (ternary4, then two "
                   "__dp4a a row for each of 8 rows) with a per-byte "
                   "perturbation of the plane words each repetition: a "
                   "conservative (low) rate")
    return rec


def roofline_row(config: str, seconds: float, own_bytes: float,
                 beta: float, pi: float, branch: str = "decode") -> dict:
    """The roofline of one config and branch from measured rates: bytes at
    ``beta``, and for the decode branch (and the plain version) decode at
    ``pi``, serial with, or overlapping, the dot at the int8 tensor-core
    peak (the decode branch runs on the CUDA cores, so its ``t_dot`` is a
    floor it cannot reach); the mma branch has no decode bound and twice
    the dot's operations (hi and lo). Fractions are None without
    ``beta``."""
    M, K, N, _ = map(int, config.split("x"))
    t_bytes = own_bytes / beta if beta else None
    t_decode = None if branch == "mma" else K * N / pi
    t_dot = (4 if branch == "mma" else 2) * M * K * N / INT8_OPS_PER_S
    row = {"config": config, "branch": branch, "seconds": seconds,
           "own_bytes": own_bytes, "byte_ideal_s": t_bytes,
           "decode_ideal_s": t_decode, "dot_ideal_s": t_dot,
           "own_bytes_fraction": None, "augmented_roofline_fraction": None,
           "overlapped_roofline_fraction": None}
    if t_bytes is not None:
        t_mem = max(t_bytes, t_decode or 0.0)
        row.update(
            own_bytes_fraction=t_bytes / seconds,
            augmented_roofline_fraction=(t_mem + t_dot) / seconds,
            overlapped_roofline_fraction=max(t_mem, t_dot) / seconds)
    return row


def time_branches(config: str, dev, *, min_seconds: float = 0.2) -> dict:
    """Seconds a call of each branch of the flagship at ``config``
    (``MxKxNxs``) on ``run_config``'s inputs (W, X and bias from seeds 0, 1
    and the bias rule); on the CPU the plain version's host time."""
    M, K, N, s = map(int, config.split("x"))
    W = torch.from_numpy(generate_ternary(K, N, s, seed=0)).to(dev)
    X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)
    b = torch.from_numpy(generate_bias(N)).to(dev)
    fmt = TiledBitplane.from_dense(W).prepare(M)
    fns = (BRANCHES if dev.type == "cuda"
           else {"plain": get_kernel(FLAGSHIP).fn})
    return {branch: timer(dev)(lambda x, f, fn=fn: fn(x, f, b), X,
                               aux=(fmt,), min_seconds=min_seconds).seconds
            for branch, fn in fns.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.decode_roofline")
    p.add_argument("--configs", nargs="*", default=DEFAULT_CONFIGS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = device_name(dev)
    result = {"device": name, "decode_rate": measure_decode_rate(dev)}
    print(json.dumps(result["decode_rate"]), flush=True)
    beta = measure_hbm_bandwidth(device=dev) if dev.type == "cuda" else None
    result["beta_measured_GBps"] = beta / 1e9 if beta else None
    pi = result["decode_rate"]["weights_per_s"]
    spec = get_kernel(FLAGSHIP)
    rows = []
    for cs in args.configs:
        M, K, N, _ = map(int, cs.split("x"))
        try:
            times = time_branches(cs, dev)
        except Exception as e:  # record, keep sweeping
            rows.append({"config": cs, "error": f"{type(e).__name__}: {e}"})
            print(json.dumps(rows[-1]), flush=True)
            continue
        # own bytes depend on the container's shape, not its values
        fmt = TiledBitplane.from_dense(
            torch.zeros((K, N), dtype=torch.int8, device=dev))
        own = instrument(M, fmt, x_bytes=spec.x_bytes).own_bytes
        for branch, seconds in times.items():
            rows.append(roofline_row(cs, seconds, own, beta, pi, branch))
            print(json.dumps(rows[-1]), flush=True)
    result["configs"] = rows
    result["model"] = (
        "bounds from measured rates on the card, a row for each branch of "
        "the flagship: SERIAL ideal = max(own_bytes/beta, K*N/pi_decode) + "
        "2*M*K*N/int8_peak (augmented_roofline_fraction; > 1 means the "
        "kernel overlaps better than fully serial) and FULL-OVERLAP ideal = "
        "max(bytes, decode, dot) (overlapped_roofline_fraction). pi_decode "
        "is the all-SM rate of the decode body's inner step (gemv_core.cuh: "
        "ternary4 and the i8 rule's two __dp4a a row) at an 8-row M-tile; "
        "the decode row's t_dot is taken at the int8 tensor-core peak "
        "although that branch runs on the CUDA cores. The mma branch has no "
        "decode term and 4*M*K*N operations (X as 32*hi + lo). The int8 "
        "peak is the H100's data-sheet 1,979 TOP/s.")
    emit(result, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
