"""CUDA kernels over the TiledBitplane container — counterpart of the
bitplane part of ``ternary_spgemm_tpu/ops/pallas_kernels.py``.

Two registered kernels, one CUDA source (``csrc/bitplane.cu``):

* ``CudaTiledBitplane_x8`` replaces ``PallasTiledBitplane_x8``: X is rounded
  half to even and clamped to int8 +-127, then one exact int32 dot. The A8
  serving path's merged QKV and ``wo``.
* ``CudaTiledBitplane_i8`` replaces ``PallasTiledBitplane_i8``: exact for
  integer |x| <= 512; non-integer X is floored (as the TPU kernel's
  truncating int8 split does). The headline SpMM and the default
  ``TiledBitplane`` dispatch.

Each wrapper checks its inputs, allocates the output, launches on the
current stream and adds one to :data:`launches`. On a CPU tensor, and only
there, it runs the plain PyTorch version beside it (the bitplanes decoded to
a dense +-1 matrix, one f32 matmul — exact, since every partial sum is an
integer below 2**24). On a CUDA tensor it launches or raises; there is no
fallback. A plain version that runs on a CUDA tensor (as ``chip_smoke.py``
does to compare) adds one to :data:`plain_on_cuda`.
"""

from __future__ import annotations

import collections

import torch

from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane, decode_planes
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.api import finish, register_kernel

#: kernel launches by name (each wrapper counts where it launches)
launches: collections.Counter = collections.Counter()
#: plain-version runs on CUDA tensors, by name
plain_on_cuda: collections.Counter = collections.Counter()


def reset_counts() -> None:
    launches.clear()
    plain_on_cuda.clear()


def note_plain(name: str, X: torch.Tensor) -> None:
    if X.is_cuda:
        plain_on_cuda[name] += 1


def to_x8(X: torch.Tensor) -> torch.Tensor:
    """``_to_x8``: round half to even, clamp to [-127, 127] (f32 values)."""
    return torch.clamp(torch.round(X.to(torch.float32)), -127.0, 127.0)


def to_i8(X: torch.Tensor) -> torch.Tensor:
    """The value the TPU's int8 split ``x = 8a + r - 512`` represents:
    ``floor(x + 512) - 512`` in f32 (= floor(x) for |x| <= 512)."""
    return torch.floor(X.to(torch.float32) + 512.0) - 512.0


def bitplane_matmul_plain(Xi: torch.Tensor, fmt: TiledBitplane) -> torch.Tensor:
    """Integer-valued f32 ``Xi (M, K)`` times the decoded ternary matrix, in
    f32 — exact while every partial sum stays below 2**24."""
    if Xi.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain bitplane matmul needs full f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    W = decode_planes(fmt.plane, fmt.tkb)[:Xi.shape[1], :fmt.N]
    return Xi @ W.to(torch.float32)


def bitplane_x8_plain(X, fmt: TiledBitplane, bias, alpha=None) -> torch.Tensor:
    note_plain("CudaTiledBitplane_x8", X)
    return finish(bitplane_matmul_plain(to_x8(X), fmt), bias, alpha)


def bitplane_i8_plain(X, fmt: TiledBitplane, bias, alpha=None) -> torch.Tensor:
    note_plain("CudaTiledBitplane_i8", X)
    return finish(bitplane_matmul_plain(to_i8(X), fmt), bias, alpha)


def check_plane(fmt: TiledBitplane, device: torch.device) -> torch.Tensor:
    p = fmt.plane
    if p.device != device or p.dtype != torch.uint8 or not p.is_contiguous() \
            or p.dim() != 4 or p.shape[2] != 2 * fmt.tkb \
            or p.shape[3] != fmt.tile_n or p.shape[1] * fmt.tile_n < fmt.N \
            or p.shape[0] * 8 * fmt.tkb < fmt.K:
        raise ValueError(
            f"plane must be a contiguous uint8 (nb, gn, 2*tkb, tile_n) tensor "
            f"on {device}; got {p.dtype} {tuple(p.shape)} on {p.device}")
    return p


def check_f32(t: torch.Tensor, shape: tuple, device: torch.device,
              what: str) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.device != device \
            or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"{what} must be a contiguous float32 tensor of "
                         f"shape {tuple(shape)} on {device}; got {got}")
    return t


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_bitplane(name: str, entry: str, X, fmt: TiledBitplane, bias,
                     alpha) -> torch.Tensor:
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors (CPU tensors take the "
                         f"plain version); got a tensor on {dev}")
    if X.dim() != 2:
        raise ValueError(f"{name}: X must be 2-D (M, K), got {tuple(X.shape)}")
    M, K, N = X.shape[0], fmt.K, fmt.N
    check_f32(X, (M, K), dev, f"{name}: X")
    plane = check_plane(fmt, dev)
    check_f32(bias, (N,), dev, f"{name}: bias")
    if alpha is not None:
        check_f32(alpha, (N,), dev, f"{name}: alpha")
    Y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return Y
    lib = _build.load()
    err = getattr(lib, entry)(
        X.data_ptr(), M, K, plane.data_ptr(), plane.shape[0], plane.shape[1],
        fmt.tkb, fmt.tile_n, N, bias.data_ptr(),
        None if alpha is None else alpha.data_ptr(), Y.data_ptr(),
        stream_handle(dev))
    _build.check(err, entry)
    launches[name] += 1
    return Y


@register_kernel(
    "CudaTiledBitplane_x8", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight) decoded per lane, int8-"
                "native activations (round + clamp +-127) accumulated in "
                "int32; the A8 serving projections",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1552",
    x_absmax=127, x_bytes=4.0)
def cuda_tiled_bitplane_x8_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_x8_plain(X, fmt, bias, alpha)
    return _launch_bitplane("CudaTiledBitplane_x8", "ternary_bitplane_x8",
                            X, fmt, bias, alpha)


@register_kernel(
    "CudaTiledBitplane_i8", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight) decoded per lane, "
                "integer activations |x| <= 512 (non-integer X floored) "
                "accumulated in int32; the headline SpMM",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1277",
    x_absmax=512, x_bytes=4.0)
def cuda_tiled_bitplane_i8_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_i8_plain(X, fmt, bias, alpha)
    return _launch_bitplane("CudaTiledBitplane_i8", "ternary_bitplane_i8",
                            X, fmt, bias, alpha)
