"""CUDA SpMM kernels over the tiled containers — counterpart of the tiled
part of ``ternary_spgemm_tpu/ops/pallas_kernels.py``.

Six registered kernels, one shared core (``csrc/bitplane_core.cuh``):

====================  ======================  ===================  ==========
kernel                replaces (Pallas)       source               X rule
====================  ======================  ===================  ==========
CudaTiledBitplane_x8  PallasTiledBitplane_x8  bitplane.cu          x8
CudaTiledBitplane_i8  PallasTiledBitplane_i8  bitplane.cu          i8
CudaTiledBitplane_bf16  ..._bf16              bitplane_bf16.cu     bf16
CudaTiledNibblePair_i8  PallasTiledNibblePair_i8  nibblepair.cu    i8
CudaTiledDense_i8     PallasTiledDense_i8     tiled_dense.cu       i8
CudaTiledDense_x8     PallasTiledDense_x8     tiled_dense.cu       x8
====================  ======================  ===================  ==========

X rules: *x8* rounds half to even and clamps to int8 +-127 (``_to_x8``),
int32 accumulation — exact on any float; *i8* stages ``floor(x + 512) -
512``, the value of the TPU's int8 split (exact for integer |x| <= 512,
non-integer X floored), int32 accumulation; *bf16* rounds X to bf16
(nearest even) and sums in f32 (exact for integer |x| <= 256).

Each wrapper checks its inputs, allocates the output, launches on the
current stream and adds one to :data:`launches`. On a CPU tensor, and only
there, it runs the plain PyTorch version beside it (the container decoded to
a dense +-1 matrix, the X rule, one f32 matmul — exact on the integer
domains, since every partial sum is an integer below 2**24). On a CUDA
tensor it launches or raises; there is no fallback. A plain version that
runs on a CUDA tensor (as ``chip_smoke.py`` does to compare) adds one to
:data:`plain_on_cuda`.
"""

from __future__ import annotations

import collections

import torch

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane, TiledNibblePair
from ternary_spgemm_tpu_torch.formats.tiled import TiledDenseTernary
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.api import finish, register_kernel
from ternary_spgemm_tpu_torch.utils import cdiv

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


def to_bf16(X: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(X, bfloat16)`` (round to nearest even), widened back
    to f32 values."""
    return X.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def matmul_plain(Xv: torch.Tensor, fmt: TernaryFormat) -> torch.Tensor:
    """f32 ``Xv (M, K)`` times the decoded ternary matrix, in full f32 —
    exact while ``Xv`` is integer-valued and every partial sum stays below
    2**24."""
    if Xv.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain ternary matmul needs full f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return Xv @ fmt.to_dense().to(torch.float32)


def _plain(name: str, rule):
    def plain(X, fmt, bias, alpha=None) -> torch.Tensor:
        note_plain(name, X)
        return finish(matmul_plain(rule(X), fmt), bias, alpha)

    plain.__name__ = f"{name}_plain"
    plain.__doc__ = f"The plain PyTorch version of {name}."
    return plain


bitplane_x8_plain = _plain("CudaTiledBitplane_x8", to_x8)
bitplane_i8_plain = _plain("CudaTiledBitplane_i8", to_i8)
bitplane_bf16_plain = _plain("CudaTiledBitplane_bf16", to_bf16)
nibblepair_i8_plain = _plain("CudaTiledNibblePair_i8", to_i8)
tiled_dense_i8_plain = _plain("CudaTiledDense_i8", to_i8)
tiled_dense_x8_plain = _plain("CudaTiledDense_x8", to_x8)


def _check_weights(t: torch.Tensor, what: str, dtype: torch.dtype,
                   shape: tuple, device: torch.device) -> torch.Tensor:
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(
            f"{what} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def check_plane(fmt: TiledBitplane, device: torch.device) -> torch.Tensor:
    """TiledBitplane ``plane``: uint8 (nb, gn, 2*tkb, tile_n)."""
    shape = (cdiv(fmt.K, 8 * fmt.tkb), cdiv(fmt.N, fmt.tile_n), 2 * fmt.tkb,
             fmt.tile_n)
    return _check_weights(fmt.plane, "plane", torch.uint8, shape, device)


def check_words(fmt: TiledNibblePair, device: torch.device) -> torch.Tensor:
    """TiledNibblePair ``words``: int32 (nb, gn, tkb, tile_n)."""
    shape = (cdiv(fmt.K, 8 * fmt.tkb), cdiv(fmt.N, fmt.tile_n), fmt.tkb,
             fmt.tile_n)
    return _check_weights(fmt.words, "words", torch.int32, shape, device)


def check_tiles(fmt: TiledDenseTernary, device: torch.device) -> torch.Tensor:
    """TiledDenseTernary ``tiles``: int8 (gk, gn, tile_k, tile_n), tile_k a
    multiple of 8 (the core reads a tile as tile_k / 8 byte-rows)."""
    if fmt.tile_k % 8:
        raise ValueError(f"tiles: tile_k must be a multiple of 8, got "
                         f"{fmt.tile_k}")
    shape = (cdiv(fmt.K, fmt.tile_k), cdiv(fmt.N, fmt.tile_n), fmt.tile_k,
             fmt.tile_n)
    return _check_weights(fmt.tiles, "tiles", torch.int8, shape, device)


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


def _launch(name: str, entry: str, X, fmt: TernaryFormat, weights, tkb: int,
            bias, alpha) -> torch.Tensor:
    """Launch ``entry`` over ``fmt``; ``weights`` checks and returns the
    container's weight tensor, ``tkb`` is its byte-rows per K-block."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors (CPU tensors take the "
                         f"plain version); got a tensor on {dev}")
    if X.dim() != 2:
        raise ValueError(f"{name}: X must be 2-D (M, K), got {tuple(X.shape)}")
    M, K, N = X.shape[0], fmt.K, fmt.N
    check_f32(X, (M, K), dev, f"{name}: X")
    w = weights(fmt, dev)
    check_f32(bias, (N,), dev, f"{name}: bias")
    if alpha is not None:
        check_f32(alpha, (N,), dev, f"{name}: alpha")
    Y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return Y
    lib = _build.load()
    err = getattr(lib, entry)(
        X.data_ptr(), M, K, w.data_ptr(), w.shape[0], w.shape[1], tkb,
        fmt.tile_n, N, bias.data_ptr(),
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
    x_absmax=127)
def cuda_tiled_bitplane_x8_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_x8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledBitplane_x8", "ternary_bitplane_x8", X, fmt,
                   check_plane, fmt.tkb, bias, alpha)


@register_kernel(
    "CudaTiledBitplane_i8", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight) decoded per lane, "
                "integer activations |x| <= 512 (non-integer X floored) "
                "accumulated in int32; the headline SpMM",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1277",
    x_absmax=512)
def cuda_tiled_bitplane_i8_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledBitplane_i8", "ternary_bitplane_i8", X, fmt,
                   check_plane, fmt.tkb, bias, alpha)


@register_kernel(
    "CudaTiledBitplane_bf16", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight) decoded per lane, X "
                "rounded to bf16 and summed in f32 (exact for integer "
                "activations |x| <= 256; bf16 rounding outside)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1602",
    x_absmax=256)
def cuda_tiled_bitplane_bf16_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_bf16_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledBitplane_bf16", "ternary_bitplane_bf16", X, fmt,
                   check_plane, fmt.tkb, bias, alpha)


@register_kernel(
    "CudaTiledNibblePair_i8", TiledNibblePair,
    description="signed-nibble words (4 bits/weight) sign-extended per lane, "
                "integer activations |x| <= 512 (non-integer X floored) "
                "accumulated in int32",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1463",
    x_absmax=512)
def cuda_tiled_nibblepair_i8_kernel(X, fmt: TiledNibblePair, bias,
                                    alpha=None):
    if X.device.type == "cpu":
        return nibblepair_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledNibblePair_i8", "ternary_nibblepair_i8", X, fmt,
                   check_words, fmt.tkb, bias, alpha)


@register_kernel(
    "CudaTiledDense_i8", TiledDenseTernary,
    description="tile-contiguous int8 plane (8 bits/weight), integer "
                "activations |x| <= 512 (non-integer X floored) accumulated "
                "in int32",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:777",
    x_absmax=512)
def cuda_tiled_dense_i8_kernel(X, fmt: TiledDenseTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return tiled_dense_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledDense_i8", "ternary_tiled_dense_i8", X, fmt,
                   check_tiles, fmt.tile_k // 8, bias, alpha)


@register_kernel(
    "CudaTiledDense_x8", TiledDenseTernary,
    description="tile-contiguous int8 plane (8 bits/weight), int8-native "
                "activations (round + clamp +-127) accumulated in int32",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:821",
    x_absmax=127)
def cuda_tiled_dense_x8_kernel(X, fmt: TiledDenseTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return tiled_dense_x8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledDense_x8", "ternary_tiled_dense_x8", X, fmt,
                   check_tiles, fmt.tile_k // 8, bias, alpha)
