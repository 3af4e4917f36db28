"""CUDA SpMM kernels — counterpart of the SpMM kernels of
``ternary_spgemm_tpu/ops/pallas_kernels.py``.

Eighteen registered kernels on four cores: ``csrc/gemv_core.cuh`` (the
planes streamed a warp-row at a time, ``__dp4a`` on the CUDA cores, the
walk split across blocks and folded in one launch) for the x8 and i8
bitplane kernels' decode branches, with the int8 tensor-core core
(``csrc/bitplane_mma.cuh``) of their prefill branches, which they take
above :data:`X8_MMA_MIN_M` and :data:`I8_MMA_MIN_M` rows of X; the bf16
tensor-core tile (``csrc/dense_mma.cuh``) at every M for ``CudaDense``
and ``CudaDense_bf16`` (f32 X as three bf16 pieces, :func:`split_bf16`;
bf16 X as one), for the kernels over the packed-row containers, the
int8-X tiled-dense i8 and x8, dense i8, block-packed, tiled block-packed
and stride-packed i8 ones and the f32 stride-packed ones (X staged by its
rule, i8 as two exact pieces, x8 as one, f32 as three; the 2-bit and
base-3 codes decoded as they are staged, :func:`swar_decode`), for
``CudaTiledBitplane_bf16`` (its pos and neg bit planes decoded as they
are staged, bf16 X as one piece) and for ``CudaTiledNibblePair_i8`` (its
signed-nibble words transposed and decoded as they are staged, i8 X as
two pieces); ``csrc/ell_core.cuh`` for the ELL gathers:

=======================  ========================  ================  =====  ==========
kernel                   replaces (Pallas)         source            X      core
=======================  ========================  ================  =====  ==========
CudaTiledBitplane_x8     PallasTiledBitplane_x8    bitplane.cu       x8     gemv,
                                                                            int8 mma
CudaTiledBitplane_i8     PallasTiledBitplane_i8    bitplane.cu       i8     gemv,
                                                                            int8 mma
CudaTiledBitplane_bf16   PallasTiledBitplane_bf16  bitplane_bf16.cu  bf16   bf16 tile
CudaTiledNibblePair_i8   PallasTiledNibblePair_i8  nibblepair.cu     i8     bf16 tile
CudaTiledDense_i8        PallasTiledDense_i8       tiled_dense.cu    i8     bf16 tile
CudaTiledDense_x8        PallasTiledDense_x8       tiled_dense.cu    x8     bf16 tile
CudaDense                PallasDense               dense.cu          f32    bf16 tile
CudaDense_bf16           PallasDense_bf16          dense.cu          bf16   bf16 tile
CudaDense_i8             PallasDense_i8            dense.cu          i8     bf16 tile
CudaBlockPacked_i8       PallasBlockPacked_i8      blockpacked.cu    i8     bf16 tile
CudaTiledBlockPacked_i8  PallasTiledBlockPacked_i8 blockpacked.cu    i8     bf16 tile
CudaPacked2Bit           PallasPacked2Bit          packed.cu         f32    bf16 tile
CudaPacked53             PallasPacked53            packed.cu         f32    bf16 tile
CudaPacked2Bit_i8        PallasPacked2Bit_i8       blockpacked.cu    i8     bf16 tile
CudaPacked53_i8          PallasPacked53_i8         blockpacked.cu    i8     bf16 tile
CudaEllDeposit_i8        PallasEllDeposit_i8       ell.cu            i8     ELL
CudaTiledEllGather       PallasTiledEllGather      ell.cu            f32    ELL
CudaEllGather            PallasEllGather           ell.cu            f32    ELL
=======================  ========================  ================  =====  ==========

X rules (``ops/api.py``): *x8* rounds half to even and clamps to int8 +-127
(``_to_x8``) — exact on any float; *i8* stages ``floor(x + 512) - 512``,
the value of the TPU's int8 split (exact for integer |x| <= 512,
non-integer X floored); both accumulate in int32 on the bitplane cores and
as exact integer f32 sums on the bf16 tile (the bitplane kernels'
decode body and tensor-core branch stage i8 as ``32 * int8(v >> 5) + (v &
31)``, equal to v on [-4096, 4095]); *bf16*
rounds X to bf16 (nearest even) and sums in f32 (exact for integer
|x| <= 256); *f32* takes X as it is and sums in f32 in a fixed order
(on the bf16 tile: three exact bf16 passes, :func:`split_bf16`).

Each wrapper checks its inputs, allocates the output, launches on the
current stream and adds one to :data:`launches`. On a CPU tensor, and only
there, it runs the plain PyTorch version beside it (the container decoded to
a dense +-1 matrix, the X rule, one f32 matmul — exact on the integer
domains, since every partial sum is an integer below 2**24). On a CUDA
tensor it launches or raises; there is no fallback. A plain version that
runs on a CUDA tensor (as ``chip_smoke.py`` does to compare) adds one to
:data:`plain_on_cuda`. Each registration names its CUDA source and its
plain version (``KernelSpec.source``, ``KernelSpec.plain``): the registry is
the one list of the hand-written SpMM kernels.
"""

from __future__ import annotations

import collections

import torch

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat
from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane, TiledNibblePair
from ternary_spgemm_tpu_torch.formats.blocked_ell import BlockedEllTCSC
from ternary_spgemm_tpu_torch.formats.ell_deposit import (
    SB_ROWS,
    WORDS,
    TiledEllDeposit,
)
from ternary_spgemm_tpu_torch.formats.ell_tiled import TiledEllTCSC
from ternary_spgemm_tpu_torch.formats.packed import (
    BlockPackedTernary,
    DenseTernary,
    PackedTernary2Bit,
    PackedTernary53,
    check_factor,
)
from ternary_spgemm_tpu_torch.formats.tiled import (
    TiledBlockPacked,
    TiledDenseTernary,
)
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.api import (  # noqa: F401  (X rules re-exported)
    finish,
    matmul_plain,
    register_kernel,
    to_bf16,
    to_f32,
    to_i8,
    to_x8,
)
from ternary_spgemm_tpu_torch.utils import cdiv, round_up
from ternary_spgemm_tpu_torch.utils.device import sm_count

#: kernel launches by name (each wrapper counts where it launches). A
#: launch captured into a CUDA graph counts once, at the capture; replays
#: of the graph do not count (``models/graphs.py`` keeps each capture's)
launches: collections.Counter = collections.Counter()
#: plain-version runs on CUDA tensors, by name
plain_on_cuda: collections.Counter = collections.Counter()

_CSRC = "ternary_spgemm_tpu_torch/csrc/"


def reset_counts() -> None:
    launches.clear()
    plain_on_cuda.clear()


def note_plain(name: str, X: torch.Tensor) -> None:
    if X.is_cuda:
        plain_on_cuda[name] += 1


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
dense_plain = _plain("CudaDense", to_f32)
dense_bf16_plain = _plain("CudaDense_bf16", to_bf16)
dense_i8_plain = _plain("CudaDense_i8", to_i8)
blockpacked_i8_plain = _plain("CudaBlockPacked_i8", to_i8)
tiled_blockpacked_i8_plain = _plain("CudaTiledBlockPacked_i8", to_i8)
packed2_plain = _plain("CudaPacked2Bit", to_f32)
packed53_plain = _plain("CudaPacked53", to_f32)
packed2_i8_plain = _plain("CudaPacked2Bit_i8", to_i8)
packed53_i8_plain = _plain("CudaPacked53_i8", to_i8)
ell_deposit_i8_plain = _plain("CudaEllDeposit_i8", to_i8)
tiled_ell_plain = _plain("CudaTiledEllGather", to_f32)
ell_gather_plain = _plain("CudaEllGather", to_f32)


#: the X rules of ``csrc/dense_mma.cuh`` -> (the rule, ops/api.py; the bf16
#: pieces its staged values take)
STAGES = {"f32": (to_f32, 3), "bf16": (to_f32, 1), "x8": (to_x8, 1),
          "i8": (to_i8, 2)}


def split_bf16(x: torch.Tensor, pieces: int = None, *,
               stage: str = "f32") -> list:
    """The bf16 pieces that ``csrc/dense_mma.cuh`` splits X into: X staged
    by ``stage``'s rule (:data:`STAGES`: f32 and bf16 as it is, x8
    :func:`to_x8`, i8 :func:`to_i8`), then the first piece ``bf16(v)``
    (round to nearest even), each next one ``bf16`` of the remainder ``v -
    (the pieces so far)``, every remainder exact in f32; ``pieces``
    defaults to the stage's count. Where the first piece is not finite (v
    inf or NaN, or rounding to inf) the others are 0, so that ``inf * 0``
    makes the plain f32 product's NaN.

    Three pieces (f32) sum back to v exactly (3 x 8 significant bits cover
    f32's 24) for every v with ``2**-110 <= |v| < 0x1.FFp127``, and for 0.
    Below 2**-110 the last piece may drop bits under bf16's smallest
    subnormal (2**-133); from 0x1.FFp127 on (the bf16 overflow threshold,
    under f32's largest 0x1.FFFFFEp127) the first piece is inf. One piece
    is X rounded to bf16 (``CudaDense_bf16``, :func:`to_bf16`); two leave
    the last 8 bits of a general f32 out. The x8 rule's values, integers in
    [-127, 127], are exact in one piece. The i8 rule's are integers, and
    two pieces hold every integer |v| < 2**17 exactly (the first keeps 8
    significant bits, the remainder is an integer below half its spacing;
    the domain |x| <= 512 gives |v| <= 512 and a remainder in {-1, 0, 1});
    from 2**17 on a remainder may need 9 bits (2**17 + 257 splits into
    2**17 and 256)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {sorted(STAGES)}, got "
                         f"{stage!r}")
    rule, default = STAGES[stage]
    pieces = default if pieces is None else pieces
    if not 1 <= pieces <= 3:
        raise ValueError(f"pieces must be 1, 2 or 3, got {pieces}")
    rest = rule(x)
    out = [rest.to(torch.bfloat16)]
    first = out[0].to(torch.float32)
    rest = torch.where(torch.isfinite(first), rest - first,
                       torch.zeros_like(rest))
    for _ in range(pieces - 1):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].to(torch.float32)
    return out


def swar_decode(words: torch.Tensor, factor: int) -> list:
    """The Python twin of ``csrc/dense_mma.cuh``'s ``decode_word``: the
    ``factor`` fields of four packed bytes at a time. ``words`` holds 32-bit
    words (any integer dtype, the low 32 bits; byte j little-endian is
    packed byte j); returns ``factor`` int64 tensors of words whose byte j
    is the int8 weight of that field of byte j (0x00, 0x01 or 0xFF). A code
    or digit d becomes ``(d & 1) | 0xFF * ((d >> 1) & 1)``: for factor 4
    ``d = (word >> 2f) & 0x03030303``; for factor 5 the even and odd bytes
    go to two 16-bit lanes each and ``qn = (q*171) >> 9``, ``d = q - 3*qn``,
    ``q = qn`` field by field. Equal to ``formats.packed.decode_fields``
    (and the TPU's ``_decode_block``) on every byte the packers emit (codes
    {0, 1, 3}; bytes up to 242 of base-3 digits {0, 1, 2})."""
    check_factor(factor)
    w = words.to(torch.int64) & 0xFFFFFFFF

    def sign_bytes(d):
        return (d & 0x01010101) | (((d >> 1) & 0x01010101) * 0xFF)

    if factor == 4:
        return [sign_bytes((w >> (2 * j)) & 0x03030303) for j in range(4)]
    e, o = w & 0x00FF00FF, (w >> 8) & 0x00FF00FF
    out = []
    for _ in range(5):
        en = ((e * 171) >> 9) & 0x007F007F
        on = ((o * 171) >> 9) & 0x007F007F
        out.append(sign_bytes((e - 3 * en) | ((o - 3 * on) << 8)))
        e, o = en, on
    return out


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
    """TiledDenseTernary ``tiles``: int8 (gk, gn, tile_k, tile_n)."""
    shape = (cdiv(fmt.K, fmt.tile_k), cdiv(fmt.N, fmt.tile_n), fmt.tile_k,
             fmt.tile_n)
    return _check_weights(fmt.tiles, "tiles", torch.int8, shape, device)


def check_dense(fmt: DenseTernary, device: torch.device) -> torch.Tensor:
    """DenseTernary ``dense``: int8 (K, N), unpadded."""
    return _check_weights(fmt.dense, "dense", torch.int8, (fmt.K, fmt.N),
                          device)


def check_packed(fmt: BlockPackedTernary, device: torch.device) -> torch.Tensor:
    """BlockPackedTernary ``packed``: uint8 (nb*tile_kq, N), K padded to
    nb blocks of factor*tile_kq rows."""
    check_factor(fmt.factor)
    nb = cdiv(fmt.K, fmt.factor * fmt.tile_kq)
    return _check_weights(fmt.packed, "packed", torch.uint8,
                          (nb * fmt.tile_kq, fmt.N), device)


def check_packed_tiles(fmt: TiledBlockPacked,
                       device: torch.device) -> torch.Tensor:
    """TiledBlockPacked ``tiles``: uint8 (nb, gn, tile_kq, tile_n)."""
    check_factor(fmt.factor)
    shape = (cdiv(fmt.K, fmt.factor * fmt.tile_kq), cdiv(fmt.N, fmt.tile_n),
             fmt.tile_kq, fmt.tile_n)
    return _check_weights(fmt.tiles, "tiles", torch.uint8, shape, device)


def check_stride_packed(fmt: PackedTernary2Bit,
                        device: torch.device) -> torch.Tensor:
    """PackedTernary2Bit / PackedTernary53 ``packed``: uint8 (Kq, N), Kq =
    round_up(K, FACTOR) / FACTOR."""
    return _check_weights(fmt.packed, "packed", torch.uint8,
                          (cdiv(fmt.K, fmt.FACTOR), fmt.N), device)


def _check_caps(fmt, names, shape, device) -> tuple:
    return tuple(_check_weights(getattr(fmt, n), n, torch.int32, shape,
                                device) for n in names)


def check_tiled_ell(fmt: TiledEllTCSC, device: torch.device) -> tuple:
    """TiledEllTCSC: ``plane`` int8 (nb, gn, CAPS, tile_n) split at row
    ``cap_p_max`` into its pos and neg sections, ``cap_pos``/``cap_neg``
    int32 (nb, gn)."""
    nb, gn = cdiv(fmt.K, fmt.block_k), cdiv(fmt.N, fmt.tile_n)
    caps = fmt.plane.shape[2] if fmt.plane.dim() == 4 else 0
    plane = _check_weights(fmt.plane, "plane", torch.int8,
                           (nb, gn, caps, fmt.tile_n), device)
    if not 0 < fmt.block_k <= 127 or not 0 <= fmt.cap_p_max <= caps:
        raise ValueError(f"TiledEllTCSC: block_k={fmt.block_k} must be in "
                         f"1..127 and cap_p_max={fmt.cap_p_max} in 0..{caps}")
    return (plane, plane[:, :, fmt.cap_p_max:],
            *_check_caps(fmt, ("cap_pos", "cap_neg"), (nb, gn), device))


def check_ell_deposit(fmt: TiledEllDeposit, device: torch.device) -> tuple:
    """TiledEllDeposit: ``plane`` int8 (nsb, gn, 8*CAPS, tile_n) split at
    row ``8*cap_p_max``, ``cap_pos``/``cap_neg`` int32 (nsb, gn)."""
    nsb, gn = cdiv(fmt.K, SB_ROWS), cdiv(fmt.N, fmt.tile_n)
    rows = fmt.plane.shape[2] if fmt.plane.dim() == 4 else 0
    plane = _check_weights(fmt.plane, "plane", torch.int8,
                           (nsb, gn, rows, fmt.tile_n), device)
    if rows % WORDS or not 0 <= WORDS * fmt.cap_p_max <= rows:
        raise ValueError(f"TiledEllDeposit: plane rows {rows} must be a "
                         f"multiple of {WORDS} holding cap_p_max="
                         f"{fmt.cap_p_max} slots")
    return (plane, plane[:, :, WORDS * fmt.cap_p_max:],
            *_check_caps(fmt, ("cap_pos", "cap_neg"), (nsb, gn), device))


def check_blocked_ell(fmt: BlockedEllTCSC, device: torch.device) -> tuple:
    """BlockedEllTCSC: ``idx_pos``/``idx_neg`` int8 (nb, CAP, N_pad),
    ``tile_cap_pos``/``tile_cap_neg`` int32 (nb, N_pad / tile_n)."""
    if not 0 < fmt.block_k <= 128:
        raise ValueError(f"BlockedEllTCSC: block_k={fmt.block_k} must be in "
                         "1..128")
    nb, n_pad = cdiv(fmt.K, fmt.block_k), cdiv(fmt.N, fmt.tile_n) * fmt.tile_n
    planes = []
    for name in ("idx_pos", "idx_neg"):
        t = getattr(fmt, name)
        cap = t.shape[1] if t.dim() == 3 else 0
        planes.append(_check_weights(t, name, torch.int8, (nb, cap, n_pad),
                                     device))
    return (*planes, *_check_caps(fmt, ("tile_cap_pos", "tile_cap_neg"),
                                  (nb, n_pad // fmt.tile_n), device))


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


def _launch(name: str, entry: str, X, fmt: TernaryFormat, weights, geom,
            bias, alpha, *, scratch_row_bytes: int = 0, tail=None,
            counts: tuple = ()) -> torch.Tensor:
    """Launch ``entry`` over ``fmt``: ``weights`` checks and returns the
    container's weight tensor (or a tuple of them, passed in order), ``geom``
    is the tuple of integers the entry point takes between the weight
    pointers and N. With ``scratch_row_bytes``, an int8 scratch of that many
    bytes a row of X is passed after the stream; with ``tail``, the
    arguments ``tail(M, N, device, stream)`` returns (tensors passed as
    pointers, None as a null pointer). A launch adds one to ``name``'s
    count and to each of ``counts``."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors (CPU tensors take the "
                         f"plain version); got a tensor on {dev}")
    if X.dim() != 2:
        raise ValueError(f"{name}: X must be 2-D (M, K), got {tuple(X.shape)}")
    M, K, N = X.shape[0], fmt.K, fmt.N
    check_f32(X, (M, K), dev, f"{name}: X")
    w = weights(fmt, dev)
    ptrs = [t.data_ptr() for t in (w if isinstance(w, tuple) else (w,))]
    check_f32(bias, (N,), dev, f"{name}: bias")
    if alpha is not None:
        check_f32(alpha, (N,), dev, f"{name}: alpha")
    Y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return Y
    lib = _build.load()
    stream = stream_handle(dev)
    extra = []
    # scratch is held until the launch is queued; in a CUDA graph's capture
    # it comes from the graph's pool, which keeps it for the replays
    if scratch_row_bytes:
        scratch = torch.empty(M * scratch_row_bytes, dtype=torch.int8,
                              device=dev)
        extra.append(scratch.data_ptr())
    if tail is not None:
        held = tail(M, N, dev, stream)   # held until the launch is queued
        extra.extend(t.data_ptr() if isinstance(t, torch.Tensor) else t
                     for t in held)
    err = getattr(lib, entry)(
        X.data_ptr(), M, K, *ptrs, *geom, N, bias.data_ptr(),
        None if alpha is None else alpha.data_ptr(), Y.data_ptr(), stream,
        *extra)
    _build.check(err, entry)
    for n in (name, *counts):
        launches[n] += 1
    return Y


#: The x8 kernel's two branches split at M: up to this many rows of X the
#: decode body (``ternary_bitplane_x8``, ``csrc/gemv_core.cuh``), above it
#: the int8 tensor-core kernel (``ternary_bitplane_x8_mma``,
#: ``csrc/bitplane_mma.cuh``). The crossover, measured by ``chip_smoke.py``
#: phase 3 on the merged QKV (M x 4096 x 12288; NVIDIA H100 80GB HBM3,
#: 700 W), decode vs tensor-core ms: M=4 0.0229 vs 0.0696, M=8 0.0287 vs
#: 0.0703, M=16 0.0439 vs 0.0712, M=32 0.0668 vs 0.0730, M=48 0.0996 vs
#: 0.0739, M=64 0.1155 vs 0.0757, M=128 0.2130 vs 0.0823 (the decode body
#: at ``ops.fused_ffn.gemv_parts``' parts; the chunk-walk kernel it
#: replaced lost from M = 8, 0.0771 vs 0.0698). The serve's decode (4
#: rows) and prefill (512) lie on either side.
X8_MMA_MIN_M = 32
#: launches of the x8 kernel's tensor-core branch (also counted under the
#: kernel's own name)
X8_MMA_COUNT = "CudaTiledBitplane_x8/mma"
#: The i8 kernel's two branches split at M: up to this many rows of X the
#: decode body (``ternary_bitplane_i8``, ``csrc/gemv_core.cuh``), above it
#: the int8 tensor-core kernel (``ternary_bitplane_i8_mma``); both stage X
#: as 32*hi + lo. The crossover, measured by ``chip_smoke.py`` phase 3
#: (NVIDIA H100 80GB HBM3, 700 W), decode vs tensor-core ms: at the north
#: star's K = 1024 (N = 4096) M=4 0.0109 vs 0.0316, M=8 0.0123 vs 0.0316,
#: M=16 0.0148 vs 0.0317, M=32 0.0182 vs 0.0328, M=48 0.0235 vs 0.0345,
#: M=64 0.0244 vs 0.0345, M=128 0.0341 vs 0.0382, M=512 0.1104 vs 0.0431;
#: at K = 4096 (N = 11008) M=4 0.0259 vs 0.0925, M=8 0.0352 vs 0.0934,
#: M=16 0.0541 vs 0.0941, M=32 0.0903 vs 0.0967, M=48 0.1180 vs 0.1013,
#: M=64 0.1605 vs 0.1020. The decode body's time grows with M * K (each
#: row tile of 16 re-reads the planes and re-stages X), the tensor-core
#: branch's floor with K, so the split falls at 32 at K = 4096 (above 128
#: at K = 1024); the headline op's 32 rows take the decode body.
I8_MMA_MIN_M = 32
#: launches of the i8 kernel's tensor-core branch (also counted under the
#: kernel's own name)
I8_MMA_COUNT = "CudaTiledBitplane_i8/mma"


def i8_branch(M: int, device) -> str:
    """The branch ``CudaTiledBitplane_i8`` takes on ``M`` rows of X on
    ``device``: ``"plain"`` on the CPU, ``"decode"`` up to
    :data:`I8_MMA_MIN_M` rows, ``"mma"`` above."""
    if torch.device(device).type == "cpu":
        return "plain"
    return "mma" if M > I8_MMA_MIN_M else "decode"


def mma_row_bytes(fmt: TiledBitplane) -> int:
    """Bytes a row of one int8 plane of X in the tensor-core branches'
    scratch (``csrc/bitplane_mma.cuh``, ``stage_kernel``): each K-block's
    two halves of ``4*tkb`` staged activations, each padded to a multiple
    of the 128 that one staged chunk holds (``kHalf``). The x8 branch
    stages one plane, the i8 branch two (hi and lo)."""
    return fmt.plane.shape[0] * 2 * round_up(4 * fmt.tkb, 128)


#: the decode body's counters by (device, stream): one int32 a (column
#: tile, row tile) of a split launch, zero between calls (the last part of
#: a tile to arrive resets its own), so launches on one stream share them
_GEMV_COUNTERS: dict = {}


def gemv_counters(dev: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """At least ``tiles`` zeroed counters for the decode body on ``dev``'s
    stream ``stream`` (a handle), allocated once and grown when a launch
    needs more. Raises rather than allocate while the stream captures a
    CUDA graph: the graph would keep a pointer to counters zeroed by a
    captured memset, which no eager launch could share."""
    c = _GEMV_COUNTERS.get((dev, stream))
    if c is None or c.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the decode body's counters for this stream do not exist yet "
                "(or are too few) while a CUDA graph is being captured: run "
                "the captured work once on the capture stream first (the "
                "warm-up) so that they are allocated before the capture")
        c = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
        _GEMV_COUNTERS[(dev, stream)] = c
    return c


def gemv_plan(name: str, M: int, N: int, nb: int, tkb: int, planes: int,
              dev: torch.device, parts=None) -> tuple:
    """(S, tiles) of one decode-body call: S the parts of its walk of ``nb
    * tkb`` byte-rows, ``ops.fused_ffn.gemv_parts``' or ``parts``, checked
    against the walk and the staged X (ValueError); tiles its (column,
    row) tiles."""
    from ternary_spgemm_tpu_torch.ops import fused_ffn   # imports this module

    walk = nb * tkb
    S = parts if parts is not None else fused_ffn.gemv_parts(
        M, N, nb, tkb, sm_count(dev), planes)
    most = fused_ffn.gemv_part_max(M, planes)
    if not 1 <= S <= max(1, walk) or cdiv(walk, S) > most:
        raise ValueError(f"{name}: {S} parts of a walk of {walk} byte-rows "
                         f"(each part at most {most})")
    return S, cdiv(N, fused_ffn.GEMV_COLS) * cdiv(M, fused_ffn.gemv_tile(M))


def _bitplane_lanes(name, entry, planes, X, fmt: TiledBitplane, bias, alpha,
                    parts=None):
    """The decode branch (``csrc/gemv_core.cuh``): one launch, its byte-row
    walk split into :func:`gemv_plan`'s parts (1: no scratch, no counters);
    ``planes``: the X rule's int8 planes (x8 1, i8 2)."""
    def tail(M, N, dev, stream):
        S, tiles = gemv_plan(name, M, N, cdiv(fmt.K, 8 * fmt.tkb), fmt.tkb,
                             planes, dev, parts)
        if S == 1:
            return None, None, 1
        return (torch.empty(S * M * N, dtype=torch.int32, device=dev),
                gemv_counters(dev, stream, tiles), S)

    return _launch(name, entry, X, fmt, check_plane,
                   (*fmt.plane.shape[:2], fmt.tkb, fmt.tile_n), bias, alpha,
                   tail=tail)


def _bitplane_mma(name, entry, planes, X, fmt: TiledBitplane, bias, alpha):
    return _launch(name, entry, X, fmt, check_plane,
                   (*fmt.plane.shape[:2], fmt.tkb, fmt.tile_n), bias, alpha,
                   scratch_row_bytes=planes * mma_row_bytes(fmt),
                   counts=(f"{name}/mma",))


def _bitplane_x8_lanes(X, fmt: TiledBitplane, bias, alpha=None, *,
                       parts=None):
    """The decode branch of ``CudaTiledBitplane_x8`` at any M (``parts``:
    :func:`_bitplane_lanes`)."""
    return _bitplane_lanes("CudaTiledBitplane_x8", "ternary_bitplane_x8", 1,
                           X, fmt, bias, alpha, parts)


def _bitplane_x8_mma(X, fmt: TiledBitplane, bias, alpha=None):
    """The tensor-core branch of ``CudaTiledBitplane_x8`` at any M."""
    return _bitplane_mma("CudaTiledBitplane_x8", "ternary_bitplane_x8_mma", 1,
                         X, fmt, bias, alpha)


def _bitplane_i8_lanes(X, fmt: TiledBitplane, bias, alpha=None, *,
                       parts=None):
    """The decode branch of ``CudaTiledBitplane_i8`` at any M (``parts``:
    :func:`_bitplane_lanes`): X staged as the tensor-core branch stages it,
    ``32 * int8(v >> 5) + (v & 31)``, so the two give the same bits on
    every input."""
    return _bitplane_lanes("CudaTiledBitplane_i8", "ternary_bitplane_i8", 2,
                           X, fmt, bias, alpha, parts)


def _bitplane_i8_mma(X, fmt: TiledBitplane, bias, alpha=None):
    """The tensor-core branch of ``CudaTiledBitplane_i8`` at any M: exact
    on the kernel's domain (integer |x| <= 512, non-integer X floored) and
    on to ``floor(x + 512) - 512`` in [-4096, 4095]; beyond that the hi
    byte of the split wraps, and the branch computes with
    ``32 * int8(v >> 5) + (v & 31)``, a multiple of 8192 off ``v``."""
    return _bitplane_mma("CudaTiledBitplane_i8", "ternary_bitplane_i8_mma", 2,
                         X, fmt, bias, alpha)


@register_kernel(
    "CudaTiledBitplane_x8", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight), int8-native "
                "activations (round + clamp +-127) accumulated in int32: "
                "streamed with __dp4a, split-K, up to X8_MMA_MIN_M rows, on "
                "the int8 tensor cores above; the A8 serving projections",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1552",
    x_absmax=127, source=_CSRC + "bitplane.cu", plain=bitplane_x8_plain)
def cuda_tiled_bitplane_x8_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_x8_plain(X, fmt, bias, alpha)
    if X.dim() == 2 and X.shape[0] > X8_MMA_MIN_M:
        return _bitplane_x8_mma(X, fmt, bias, alpha)
    return _bitplane_x8_lanes(X, fmt, bias, alpha)


@register_kernel(
    "CudaTiledBitplane_i8", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight), integer activations "
                "|x| <= 512 (non-integer X floored) accumulated in int32: "
                "streamed with __dp4a, split-K, up to I8_MMA_MIN_M rows, on "
                "the int8 tensor cores above (X as 32*hi + lo in both); the "
                "headline SpMM",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1277",
    x_absmax=512, source=_CSRC + "bitplane.cu", plain=bitplane_i8_plain)
def cuda_tiled_bitplane_i8_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_i8_plain(X, fmt, bias, alpha)
    if X.dim() == 2 and X.shape[0] > I8_MMA_MIN_M:
        return _bitplane_i8_mma(X, fmt, bias, alpha)
    return _bitplane_i8_lanes(X, fmt, bias, alpha)


@register_kernel(
    "CudaTiledBitplane_bf16", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight) decoded as they are "
                "staged, X rounded to bf16, one bf16 tensor-core pass summed "
                "in f32 (exact for integer activations |x| <= 256; bf16 "
                "rounding outside)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1602",
    x_absmax=256, source=_CSRC + "bitplane_bf16.cu",
    plain=bitplane_bf16_plain)
def cuda_tiled_bitplane_bf16_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    if X.device.type == "cpu":
        return bitplane_bf16_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledBitplane_bf16", "ternary_bitplane_bf16", X, fmt,
                   check_plane, (*fmt.plane.shape[:2], fmt.tkb, fmt.tile_n),
                   bias, alpha)


@register_kernel(
    "CudaTiledNibblePair_i8", TiledNibblePair,
    description="signed-nibble words (4 bits/weight) decoded as they are "
                "staged, integer activations |x| <= 512 (non-integer X "
                "floored) as two exact bf16 pieces on the bf16 tensor "
                "cores, exact sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1463",
    x_absmax=512, source=_CSRC + "nibblepair.cu", plain=nibblepair_i8_plain)
def cuda_tiled_nibblepair_i8_kernel(X, fmt: TiledNibblePair, bias,
                                    alpha=None):
    if X.device.type == "cpu":
        return nibblepair_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledNibblePair_i8", "ternary_nibblepair_i8", X, fmt,
                   check_words, (*fmt.words.shape[:2], fmt.tkb, fmt.tile_n),
                   bias, alpha)


@register_kernel(
    "CudaTiledDense_i8", TiledDenseTernary,
    description="tile-contiguous int8 plane (8 bits/weight), integer "
                "activations |x| <= 512 (non-integer X floored) as two "
                "exact bf16 pieces on the bf16 tensor cores, exact sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:777",
    x_absmax=512, source=_CSRC + "tiled_dense.cu", plain=tiled_dense_i8_plain)
def cuda_tiled_dense_i8_kernel(X, fmt: TiledDenseTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return tiled_dense_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledDense_i8", "ternary_tiled_dense_i8", X, fmt,
                   check_tiles,
                   (*fmt.tiles.shape[:2], fmt.tile_k, fmt.tile_n), bias,
                   alpha)


@register_kernel(
    "CudaTiledDense_x8", TiledDenseTernary,
    description="tile-contiguous int8 plane (8 bits/weight), int8-native "
                "activations (round + clamp +-127) as one exact bf16 piece "
                "on the bf16 tensor cores, exact sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:821",
    x_absmax=127, source=_CSRC + "tiled_dense.cu", plain=tiled_dense_x8_plain)
def cuda_tiled_dense_x8_kernel(X, fmt: TiledDenseTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return tiled_dense_x8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledDense_x8", "ternary_tiled_dense_x8", X, fmt,
                   check_tiles,
                   (*fmt.tiles.shape[:2], fmt.tile_k, fmt.tile_n), bias,
                   alpha)


@register_kernel(
    "CudaDense", DenseTernary,
    description="unpadded int8 plane (8 bits/weight), f32 activations "
                "split into three exact bf16 pieces, three bf16 tensor-core "
                "passes summed in f32 in a fixed order (exact f32 SpMM)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:173",
    source=_CSRC + "dense.cu", plain=dense_plain)
def cuda_dense_kernel(X, fmt: DenseTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return dense_plain(X, fmt, bias, alpha)
    return _launch("CudaDense", "ternary_dense_f32", X, fmt, check_dense,
                   (), bias, alpha)


@register_kernel(
    "CudaDense_bf16", DenseTernary,
    description="unpadded int8 plane (8 bits/weight), X rounded to bf16, "
                "one bf16 tensor-core pass summed in f32 (inexact for "
                "|x| > 256)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:181",
    approximate=True, source=_CSRC + "dense.cu", plain=dense_bf16_plain)
def cuda_dense_bf16_kernel(X, fmt: DenseTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return dense_bf16_plain(X, fmt, bias, alpha)
    return _launch("CudaDense_bf16", "ternary_dense_bf16", X, fmt,
                   check_dense, (), bias, alpha)


@register_kernel(
    "CudaDense_i8", DenseTernary,
    description="unpadded int8 plane (8 bits/weight), integer activations "
                "|x| <= 512 (non-integer X floored) as two exact bf16 "
                "pieces on the bf16 tensor cores, exact sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:420",
    x_absmax=512, source=_CSRC + "dense.cu", plain=dense_i8_plain)
def cuda_dense_i8_kernel(X, fmt: DenseTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return dense_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaDense_i8", "ternary_dense_i8", X, fmt, check_dense,
                   (1, 1, fmt.K, fmt.N), bias, alpha)


@register_kernel(
    "CudaBlockPacked_i8", BlockPackedTernary,
    description="block-local 2-bit or base-3 codes (2 / 1.6 bits/weight) "
                "decoded as they are staged, integer activations |x| <= 512 "
                "(non-integer X floored) on the bf16 tensor cores, exact "
                "sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:596",
    x_absmax=512, source=_CSRC + "blockpacked.cu", plain=blockpacked_i8_plain)
def cuda_blockpacked_i8_kernel(X, fmt: BlockPackedTernary, bias, alpha=None):
    if X.device.type == "cpu":
        return blockpacked_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaBlockPacked_i8", "ternary_blockpacked_i8", X, fmt,
                   check_packed,
                   (fmt.packed.shape[0] // fmt.tile_kq, 1, fmt.tile_kq, fmt.N,
                    fmt.factor), bias, alpha)


@register_kernel(
    "CudaTiledBlockPacked_i8", TiledBlockPacked,
    description="tile-contiguous block-local 2-bit or base-3 codes (2 / 1.6 "
                "bits/weight) decoded as they are staged, integer "
                "activations |x| <= 512 (non-integer X floored) on the bf16 "
                "tensor cores, exact sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:886",
    x_absmax=512, source=_CSRC + "blockpacked.cu",
    plain=tiled_blockpacked_i8_plain)
def cuda_tiled_blockpacked_i8_kernel(X, fmt: TiledBlockPacked, bias,
                                     alpha=None):
    if X.device.type == "cpu":
        return tiled_blockpacked_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaTiledBlockPacked_i8", "ternary_blockpacked_i8", X,
                   fmt, check_packed_tiles,
                   (*fmt.tiles.shape[:2], fmt.tile_kq, fmt.tile_n, fmt.factor),
                   bias, alpha)


@register_kernel(
    "CudaPacked2Bit", PackedTernary2Bit,
    description="stride-packed 2-bit codes (2 bits/weight) decoded as they "
                "are staged, f32 activations split into three exact bf16 "
                "pieces, three bf16 tensor-core passes summed in f32 in a "
                "fixed order (exact f32 SpMM)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:264",
    source=_CSRC + "packed.cu", plain=packed2_plain)
def cuda_packed2_kernel(X, fmt: PackedTernary2Bit, bias, alpha=None):
    if X.device.type == "cpu":
        return packed2_plain(X, fmt, bias, alpha)
    # the global stride is the block layout with one block of Kq rows
    return _launch("CudaPacked2Bit", "ternary_packed_f32", X, fmt,
                   check_stride_packed,
                   (1, 1, cdiv(fmt.K, fmt.FACTOR), fmt.N, fmt.FACTOR), bias,
                   alpha)


@register_kernel(
    "CudaPacked53", PackedTernary53,
    description="stride-packed base-3 codes (1.6 bits/weight) decoded as "
                "they are staged, f32 activations split into three exact "
                "bf16 pieces, three bf16 tensor-core passes summed in f32 in "
                "a fixed order (exact f32 SpMM)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:275",
    source=_CSRC + "packed.cu", plain=packed53_plain)
def cuda_packed53_kernel(X, fmt: PackedTernary53, bias, alpha=None):
    if X.device.type == "cpu":
        return packed53_plain(X, fmt, bias, alpha)
    return _launch("CudaPacked53", "ternary_packed_f32", X, fmt,
                   check_stride_packed,
                   (1, 1, cdiv(fmt.K, fmt.FACTOR), fmt.N, fmt.FACTOR), bias,
                   alpha)


@register_kernel(
    "CudaPacked2Bit_i8", PackedTernary2Bit,
    description="stride-packed 2-bit codes (2 bits/weight) decoded as they "
                "are staged, integer activations |x| <= 512 (non-integer X "
                "floored) on the bf16 tensor cores, exact sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:502",
    x_absmax=512, source=_CSRC + "blockpacked.cu", plain=packed2_i8_plain)
def cuda_packed2_i8_kernel(X, fmt: PackedTernary2Bit, bias, alpha=None):
    if X.device.type == "cpu":
        return packed2_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaPacked2Bit_i8", "ternary_blockpacked_i8", X, fmt,
                   check_stride_packed,
                   (1, 1, cdiv(fmt.K, fmt.FACTOR), fmt.N, fmt.FACTOR), bias,
                   alpha)


@register_kernel(
    "CudaPacked53_i8", PackedTernary53,
    description="stride-packed base-3 codes (1.6 bits/weight) decoded as "
                "they are staged, integer activations |x| <= 512 "
                "(non-integer X floored) on the bf16 tensor cores, exact "
                "sums",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:513",
    x_absmax=512, source=_CSRC + "blockpacked.cu", plain=packed53_i8_plain)
def cuda_packed53_i8_kernel(X, fmt: PackedTernary53, bias, alpha=None):
    if X.device.type == "cpu":
        return packed53_i8_plain(X, fmt, bias, alpha)
    return _launch("CudaPacked53_i8", "ternary_blockpacked_i8", X, fmt,
                   check_stride_packed,
                   (1, 1, cdiv(fmt.K, fmt.FACTOR), fmt.N, fmt.FACTOR), bias,
                   alpha)


@register_kernel(
    "CudaEllDeposit_i8", TiledEllDeposit,
    description="ELL offset slots (8/s bits/weight before cap padding) "
                "gathered per lane from staged 248-row superblocks, integer "
                "activations |x| <= 512 (non-integer X floored) accumulated "
                "in int32",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1703",
    x_absmax=512, source=_CSRC + "ell.cu", plain=ell_deposit_i8_plain)
def cuda_ell_deposit_i8_kernel(X, fmt: TiledEllDeposit, bias, alpha=None):
    if X.device.type == "cpu":
        return ell_deposit_i8_plain(X, fmt, bias, alpha)
    nsb, gn, rows = (cdiv(fmt.K, SB_ROWS), cdiv(fmt.N, fmt.tile_n),
                     fmt.plane.shape[2])
    return _launch("CudaEllDeposit_i8", "ternary_ell_deposit_i8", X, fmt,
                   check_ell_deposit,
                   (nsb, gn, rows, rows, fmt.tile_n, fmt.tile_n, gn, SB_ROWS),
                   bias, alpha)


@register_kernel(
    "CudaTiledEllGather", TiledEllTCSC,
    description="tile-contiguous split-sign ELL gather of f32 activations "
                "with exact per-tile capacity loop bounds and a zero-entry "
                "sentinel, f32 sums in a fixed order (exact f32 SpMM)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1839",
    source=_CSRC + "ell.cu", plain=tiled_ell_plain)
def cuda_tiled_ell_kernel(X, fmt: TiledEllTCSC, bias, alpha=None):
    if X.device.type == "cpu":
        return tiled_ell_plain(X, fmt, bias, alpha)
    nb, gn, caps = (cdiv(fmt.K, fmt.block_k), cdiv(fmt.N, fmt.tile_n),
                    fmt.plane.shape[2])
    return _launch("CudaTiledEllGather", "ternary_tiled_ell_f32", X, fmt,
                   check_tiled_ell,
                   (nb, gn, caps, caps, fmt.tile_n, fmt.tile_n, gn,
                    fmt.block_k), bias, alpha)


@register_kernel(
    "CudaEllGather", BlockedEllTCSC,
    description="per-K-block local-offset ELL gather of f32 activations, "
                "the -1 slots reading a staged zero, f32 sums in a fixed "
                "order (exact f32 SpMM)",
    reference="ternary_spgemm_tpu/ops/pallas_kernels.py:1890",
    source=_CSRC + "ell.cu", plain=ell_gather_plain)
def cuda_ell_gather_kernel(X, fmt: BlockedEllTCSC, bias, alpha=None):
    if X.device.type == "cpu":
        return ell_gather_plain(X, fmt, bias, alpha)
    nb, ntiles = cdiv(fmt.K, fmt.block_k), cdiv(fmt.N, fmt.tile_n)
    return _launch("CudaEllGather", "ternary_blocked_ell_f32", X, fmt,
                   check_blocked_ell,
                   (nb, 1, fmt.idx_pos.shape[1], fmt.idx_neg.shape[1],
                    ntiles * fmt.tile_n, fmt.tile_n, ntiles, fmt.block_k),
                   bias, alpha)
