"""Device-memory streaming probe — counterpart of ``tools/membench.py``.

What read rate does a tile-streaming pass over an int8 array reach on the
card, as a function of array size, tile shape and layout? The kernel
(``csrc/stream.cu``) reads every byte of the array with 16-byte loads, each
tile cut into runs of 4096-byte steps so that about two blocks an SM (the
SM count read from the card) fill it whatever the tile count, and
wraparound-adds its 32-bit words into an (8, 128) int32 checksum, which it
adds to ``x`` (the JAX kernel's output, ``acc + x``); every byte flows into
that output, so no load can be elided. The checksum is a function of the
bytes alone: bucket ``q`` of the 1,024 holds the sum of the words whose
flat index is ``q`` modulo 1024 (:func:`stream_plain`).

Layouts: ``tiled4d`` (gk, gn, tk, tn), a tile contiguous (tk*tn a multiple
of 4096); ``rowmajor`` (gk*tk, gn*tn), a tile tk rows of tn bytes (tn a
multiple of 4096). Every timed launch starts with the L2 evicted (a 256 MB
buffer overwritten between launches; the card's L2 holds 50 MB), so every
rate is a device-memory rate.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.membench [--sizes-mb 16,32,...]
        [--tiles 256,4096;...] [--layouts tiled4d,rowmajor]
        [--device cuda|cpu] [--out PATH]

One JSON line per config, ``{"mb", "tile", "layout", "grid", "seconds",
"gbps", "device"}`` (the JAX record's keys and the device), or ``{"mb",
"tile", "layout", "error", "device"}`` for a config that failed (the sweep
goes on, as JAX's does); then one JSON object of all records.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.cuda_kernels import (
    launches,
    note_plain,
    stream_handle,
)
from ternary_spgemm_tpu_torch.tools import emit, timer
from ternary_spgemm_tpu_torch.utils.device import resolve_device, sm_count

KERNEL_NAME = "stream_rate"
SOURCE = "ternary_spgemm_tpu_torch/csrc/stream.cu"
REFERENCE = "tools/membench.py:84"
LAYOUTS = {"tiled4d": 0, "rowmajor": 1}
#: checksum buckets, the (8, 128) output
BUCKETS = 1024
#: copies of the buckets the kernel's blocks add into (atomics on one
#: address serialise; ``csrc/stream.cu``)
REPLICAS = 16

#: the JAX tool's sweep (``tools/membench.py:128-129``)
DEFAULT_SIZES_MB = [16, 32, 64, 121, 160, 256, 384, 512]
DEFAULT_TILES = [(256, 4096), (512, 4096), (256, 8192), (1024, 4096)]


def grid_for(arr_bytes: int, tk: int, tn: int):
    """(gk, gn) of an array of about ``arr_bytes``, as the JAX tool cuts it
    (a near-square grid of whole tiles)."""
    ntiles = max(1, arr_bytes // (tk * tn))
    gk = max(1, int(math.isqrt(ntiles)))
    return gk, max(1, ntiles // gk)


def make_array(gk: int, gn: int, tk: int, tn: int, layout: str, dev,
               seed: int = 0) -> torch.Tensor:
    """A random int8 array of the layout's shape, made on ``dev``."""
    shape = (gk, gn, tk, tn) if layout == "tiled4d" else (gk * tk, gn * tn)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


def _check(arr: torch.Tensor, tk: int, tn: int, layout: str):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}, got "
                         f"{layout!r}")
    ok = (tk * tn) % 4096 == 0 if layout == "tiled4d" else tn % 4096 == 0
    if not ok:
        raise ValueError(f"{layout} tile ({tk}, {tn}): the checksum's "
                         "buckets need tk*tn (tiled4d) or tn (rowmajor) a "
                         "multiple of 4096 bytes")
    if arr.dtype != torch.int8 or not arr.is_contiguous():
        raise ValueError("the array must be a contiguous int8 tensor")
    if layout == "tiled4d":
        if arr.dim() != 4 or tuple(arr.shape[2:]) != (tk, tn):
            raise ValueError(f"tiled4d array must be (gk, gn, {tk}, {tn}), "
                             f"got {tuple(arr.shape)}")
        return arr.shape[0], arr.shape[1]
    if arr.dim() != 2 or arr.shape[0] % tk or arr.shape[1] % tn:
        raise ValueError(f"rowmajor array must be (gk*{tk}, gn*{tn}), got "
                         f"{tuple(arr.shape)}")
    return arr.shape[0] // tk, arr.shape[1] // tn


def stream_plain(arr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x`` plus, in bucket ``q``, the wraparound sum of
    the array's 32-bit words (little-endian, in memory order) whose index
    is ``q`` modulo 1024 -> (8, 128) int32."""
    note_plain(KERNEL_NAME, arr)
    words = arr.reshape(-1).view(torch.int32).reshape(-1, BUCKETS)
    s = words.sum(dim=0, dtype=torch.int64) + x.reshape(-1).to(torch.int64)
    return (((s + 2**31) % 2**32) - 2**31).to(torch.int32).reshape(8, 128)


def stream_launch(arr: torch.Tensor, tk: int, tn: int, layout: str,
                  out: torch.Tensor) -> None:
    """Add the array's checksum into ``out`` ((8, 128) int32 on the card)
    with one call of the kernel (the stream launch and the fold of its
    bucket copies)."""
    gk, gn = _check(arr, tk, tn, layout)
    if not arr.is_cuda or out.device != arr.device \
            or out.dtype != torch.int32 or out.shape != (8, 128) \
            or not out.is_contiguous():
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors: an int8 array "
                         "and an (8, 128) int32 output on the same card")
    scratch = torch.empty((REPLICAS, BUCKETS), dtype=torch.int32,
                          device=arr.device)
    err = _build.load().ternary_stream_rate(
        arr.data_ptr(), gk, gn, tk, tn, LAYOUTS[layout],
        sm_count(arr.device), scratch.data_ptr(), REPLICAS, out.data_ptr(),
        stream_handle(arr.device))
    _build.check(err, "ternary_stream_rate")
    launches[KERNEL_NAME] += 1


def stream_checksum(arr: torch.Tensor, tk: int, tn: int, layout: str,
                    x: torch.Tensor) -> torch.Tensor:
    """``x (8, 128) int32`` plus the array's checksum: the kernel on a CUDA
    tensor, :func:`stream_plain` on a CPU one."""
    if arr.device.type == "cpu":
        _check(arr, tk, tn, layout)
        return stream_plain(arr, x)
    out = x.to(device=arr.device, dtype=torch.int32).contiguous().clone()
    stream_launch(arr, tk, tn, layout, out)
    return out


def stream_rate(arr_bytes: int, tk: int, tn: int, layout: str, dev) -> dict:
    """Time one streaming pass over an int8 array of about ``arr_bytes``
    (the launch alone on the card, ``bench.timing``'s CUDA-event timer with
    the L2 evicted before each launch; the plain version's host time on the
    CPU)."""
    gk, gn = grid_for(arr_bytes, tk, tn)
    nbytes = gk * gn * tk * tn
    arr = make_array(gk, gn, tk, tn, layout, dev)
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        t = timer(dev)(lambda a: stream_launch(a, tk, tn, layout, x), arr)
    else:
        t = timer(dev)(lambda a: stream_checksum(a, tk, tn, layout, x), arr)
    del arr
    return {"mb": nbytes / 2**20, "tile": [tk, tn], "layout": layout,
            "grid": [gk, gn], "seconds": t.seconds,
            "gbps": nbytes / t.seconds / 1e9}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.membench")
    p.add_argument("--sizes-mb", default=",".join(map(str, DEFAULT_SIZES_MB)))
    p.add_argument("--tiles",
                   default=";".join(f"{a},{b}" for a, b in DEFAULT_TILES))
    p.add_argument("--layouts", default="tiled4d,rowmajor")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = device_name(dev)
    sizes = [int(float(s) * 2**20) for s in args.sizes_mb.split(",")]
    tiles = [tuple(map(int, t.split(","))) for t in args.tiles.split(";")]
    records = []
    for layout in args.layouts.split(","):
        for tk, tn in tiles:
            for sz in sizes:
                try:
                    rec = stream_rate(sz, tk, tn, layout, dev)
                except Exception as e:   # record, keep sweeping (as JAX)
                    rec = {"mb": sz / 2**20, "tile": [tk, tn],
                           "layout": layout, "error": repr(e)}
                rec["device"] = name
                print(json.dumps(rec), flush=True)
                records.append(rec)
    emit({"device": name, "records": records}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
