"""Fused ternary FFN blocks — counterpart of
``ternary_spgemm_tpu/ops/fused_ffn.py``.

The W1.58-A8 transformer's SwiGLU FFN::

    g   = gamma_g * (sx * (xq @ Wg))        u = gamma_u * (sx * (xq @ Wu))
    h   = silu(g) * u
    hq  = round(h / ((rowmax|h| + 1e-12) / 127))        (requantize_rows)
    y   = (hq @ Wd) * (((rowmax|h| + 1e-12) / 127) * gamma_d)

and the reference-epilogue PReLU FFN over integer activations |X| <= 512::

    h   = PReLU(X @ W1 + b1 / gamma1, alpha1)   (kept unscaled: the
                                                 requantize is scale-free)
    hq  = round(h / ((rowmax|h| + 1e-12) / 127))
    y   = (hq @ W2) * (((rowmax|h| + 1e-12) / 127) * (gamma1 * gamma2)) + b2
    [y  = PReLU(y, alpha2)]

:func:`fused_bitplane_swiglu` runs the first as one call of the CUDA kernel
in ``csrc/swiglu.cu``, :func:`fused_bitplane_ffn` the second as one call of
``csrc/ffn.cu``; each makes two products (the up-projection with its
epilogue and the row absmax, then the requantizing down projection; the
SwiGLU's up to :data:`SWIGLU_MMA_MIN_M` rows each a split walk of
:func:`split_parts` parts and a finishing kernel, above it on the int8
tensor cores with a pre-pass before each product; the PReLU FFN's each one
launch of ``csrc/gemv_core.cuh``'s streaming decode body, its walk split
into :func:`gemv_parts` parts). On a
CPU tensor each runs its plain version (:func:`swiglu_plain`,
:func:`ffn_plain`), the same math in PyTorch with every op in the JAX
order. silu is ``g * sigmoid(g)`` as ``jax.nn.silu`` writes it, with the
sigmoid evaluated in f64 and rounded once to f32 (:func:`sigmoid_f32`), in
the kernel as in the plain version, so that the card and the CPU give the
same bits. Both blocks share JAX's geometry contract (:func:`ffn_geometry`).
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.bitplane import TiledBitplane
from ternary_spgemm_tpu_torch.ops import _build
from ternary_spgemm_tpu_torch.ops.api import finish, to_i8
from ternary_spgemm_tpu_torch.ops.cuda_kernels import (
    check_f32,
    check_plane,
    gemv_counters,
    gemv_plan,
    launches,
    matmul_plain,
    mma_row_bytes,
    note_plain,
    stream_handle,
)
from ternary_spgemm_tpu_torch.utils import cdiv, round_up
from ternary_spgemm_tpu_torch.utils.device import sm_count

#: requantization constants shared by every path (the JAX values)
_RQ_ABSMAX = 127.0
_RQ_EPS = 1e-12

KERNEL_NAME = "fused_bitplane_swiglu"
#: the kernel's CUDA source, and the TPU kernel it replaces
SOURCE = "ternary_spgemm_tpu_torch/csrc/swiglu.cu"
REFERENCE = "ternary_spgemm_tpu/ops/fused_ffn.py:384"
FFN_KERNEL_NAME = "fused_bitplane_ffn"
FFN_SOURCE = "ternary_spgemm_tpu_torch/csrc/ffn.cu"
FFN_REFERENCE = "ternary_spgemm_tpu/ops/fused_ffn.py:229"
#: the PReLU FFN's serving-M contract (JAX's; the SwiGLU has no row limit)
SERVING_M = 128
#: The SwiGLU's two branches split at M: up to this many rows of xq the
#: decode kernel (``ternary_swiglu``, ``csrc/bitplane_core.cuh``, each
#: phase a split walk of :func:`split_parts` parts), above it the int8
#: tensor-core kernel (``ternary_swiglu_mma``, ``csrc/bitplane_mma.cuh``).
#: The crossover, measured by ``chip_smoke.py`` phase 3 at 4096 -> 11008 ->
#: 4096 (NVIDIA H100 80GB HBM3, 700 W), decode vs tensor-core ms: M=4
#: 0.1311 vs 0.2566, M=8 0.2100 vs 0.2585, M=16 0.4033 vs 0.2620, M=32
#: 0.9231 vs 0.2668, M=64 1.7924 vs 0.2742, M=128 3.6957 vs 0.2946 (the
#: unsplit decode kernel: M=4 0.2177, M=8 0.3394). So the split falls at 8
#: rows; decode's M = 4 keeps the decode kernel.
SWIGLU_MMA_MIN_M = 8
#: launches of the SwiGLU's tensor-core branch (also counted under
#: :data:`KERNEL_NAME`)
SWIGLU_MMA_COUNT = f"{KERNEL_NAME}/mma"
#: The decode branch's split walk (``csrc/bitplane_core.cuh``
#: ``launch_split``): blocks of the decode kernel an SM holds at decode's
#: M-tile of 4 rows (256 threads of 64 registers: the unsplit kernel's
#: count, and the split kernel's cap), so a phase's blocks run in waves of
#: ``SPLIT_BLOCKS_PER_SM * SMs``.
SPLIT_BLOCKS_PER_SM = 4
#: bitplane_core.cuh's geometry: output columns a block, byte-rows a chunk,
#: and the M-tiles it launches (the smallest that holds M)
_CORE_COLS, _CORE_CHUNK, _CORE_MT = 32, 32, (4, 8, 16, 32)


def split_walk(nb: int, tkb: int) -> int:
    """The chunks each block of the decode kernel walks in series over a
    TiledBitplane of ``nb`` K-blocks of ``tkb`` byte-rows: ``nb *
    cdiv(tkb, 32)``."""
    return nb * cdiv(tkb, _CORE_CHUNK)


def split_parts(M: int, N: int, nb: int, tkb: int, sms: int) -> int:
    """S, the parts of one phase's split walk for ``M`` rows of X, ``N``
    output columns, ``nb`` K-blocks of ``tkb`` byte-rows on a card of
    ``sms`` SMs. Each block waits on its chunks in series, so a phase takes
    about (waves of blocks) x (chunks a part + 1, the block's reduction
    and writes costing about one chunk): S minimises ``cdiv(blocks * S,
    slots) * (cdiv(W, S) + 1)`` over 1..W (:func:`split_walk`), the fewest
    parts on a tie, with ``blocks = cdiv(N, 32) * cdiv(M, MT)`` and
    ``slots = SPLIT_BLOCKS_PER_SM * sms``. At 7B width and M = 4 on 132
    SMs: 3 for gate and up (344 blocks, 16 chunks: 2 waves of 6 against 1
    of 16), 4 for down (128 blocks, 44 chunks: 1 wave of 11)."""
    mt = next((t for t in _CORE_MT if M <= t), _CORE_MT[-1])
    blocks = cdiv(N, _CORE_COLS) * cdiv(M, mt)
    slots, walk = SPLIT_BLOCKS_PER_SM * sms, split_walk(nb, tkb)
    return min(range(1, walk + 1),
               key=lambda S: (cdiv(blocks * S, slots) * (cdiv(walk, S) + 1),
                              S))


#: ``csrc/gemv_core.cuh``, the decode body of the x8 and i8 bitplane
#: kernels: output columns a block (four a lane), warps a block, byte-rows
#: a warp's register set, its M-tiles (the smallest that holds M; row
#: tiles of 16 above 16 rows) and the int32 words of staged X a block holds
GEMV_COLS, GEMV_WARPS, GEMV_BATCH, GEMV_MT = 128, 8, 4, (4, 8, 16)
GEMV_X_WORDS = 8192
#: :func:`gemv_parts`' bounds: blocks an SM and parts, from phase 3's
#: sweep of S (PERF.md §6: fuller waves of shorter parts lost)
GEMV_SLOTS_PER_SM, GEMV_MAX_PARTS = 3, 8


def gemv_tile(M: int) -> int:
    """The decode body's M-tile for ``M`` rows of X."""
    return next((t for t in GEMV_MT if M <= t), GEMV_MT[-1])


def gemv_part_max(M: int, planes: int = 1) -> int:
    """The most byte-rows a part of the decode body may take at ``M`` rows:
    its staged X (two halves of ``planes`` int8 words a row of the M-tile,
    x8 one plane, i8 two) fills :data:`GEMV_X_WORDS`."""
    return GEMV_X_WORDS // (2 * planes * gemv_tile(M))


def gemv_parts(M: int, N: int, nb: int, tkb: int, sms: int,
               planes: int = 1) -> int:
    """S, the parts of the decode body's byte-row walk for ``M`` rows of X,
    ``N`` columns, ``nb`` K-blocks of ``tkb`` byte-rows on a card of
    ``sms`` SMs (``planes``: the X rule's int8 planes, x8 1, i8 2), its
    walk the ``nb * tkb`` byte-rows of the container: the
    largest power of two up to :data:`GEMV_MAX_PARTS` whose ``tiles * S``
    blocks fit :data:`GEMV_SLOTS_PER_SM` an SM (``tiles = cdiv(N, 128) *
    cdiv(M, MT)``) and whose parts give each warp a whole register set
    (``walk // S >= 8 * 4`` byte-rows); then at least the parts whose X
    fits (:func:`gemv_part_max`), and 1. Phase 3's sweep (PERF.md §6)
    found such S within 8% of the fastest at every measured shape: parts of
    a whole number of the warps' register sets beat their neighbours, and
    more than 8 parts (shorter walks, a longer fold) lost."""
    tiles = cdiv(N, GEMV_COLS) * cdiv(M, gemv_tile(M))
    walk = nb * tkb
    S = 1
    while (2 * S <= GEMV_MAX_PARTS
           and tiles * 2 * S <= GEMV_SLOTS_PER_SM * sms
           and walk // (2 * S) >= GEMV_WARPS * GEMV_BATCH):
        S *= 2
    return max(S, cdiv(walk, gemv_part_max(M, planes)), 1)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by an IEEE division on every device. (On CUDA, PyTorch
    divides by a Python scalar as ``x * (1 / c)``, which differs from the
    division in the last ULP — and a requantize turns that into int8
    flips.) The divisor is filled on the device: a copy from the host
    would synchronise the stream."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 sigmoid evaluated in f64 and rounded once to f32.

    ``exp`` differs in its last f32 ULP between libraries (and between the
    CPU and the card), and the per-row requantize turns such a difference
    into a whole int8 step when it lands on a .5 boundary. Rounded from
    f64, the result is the correctly rounded f32 sigmoid on every device
    (except on ~1e-7 of inputs that sit on an f32 rounding midpoint)."""
    return torch.sigmoid(x.to(torch.float64)).to(torch.float32)


def requantize_rows(h: torch.Tensor, absmax: float = _RQ_ABSMAX,
                    eps: float = _RQ_EPS):
    """Per-row symmetric int8 requantization -> (hq f32-int-valued, scale).

    ``scale = (rowmax + eps) / absmax``, ``hq = round(h / scale)`` (round
    half to even, true division) — the op order of the JAX formula, which
    the kernels and the A8 linears share."""
    rowmax = torch.amax(torch.abs(h), dim=-1, keepdim=True) + eps
    scale = true_div(rowmax, absmax)
    return torch.round(h / scale), scale


def ffn_geometry(fmt1: TiledBitplane, fmt2: TiledBitplane,
                 name: str) -> None:
    """JAX's ``_ffn_geometry`` contract (``ops/fused_ffn.py:194-226``
    there): the OUTPUT container is one storage tile (gn == 1; the hidden
    width may span several), it contracts over the hidden width, and its K
    padding covers exactly the padded hidden width."""
    gn2 = fmt2.plane.shape[1]
    if gn2 != 1:
        raise ValueError(
            f"{name} needs a single-N-tile OUTPUT container (gn == 1), got "
            f"gn2={gn2}; shard N2 across cards for wider outputs "
            "(the hidden width may span multiple tiles)")
    if fmt2.K != fmt1.N:
        raise ValueError(
            f"layer-2 container contracts over K={fmt2.K}, expected fmt1.N="
            f"{fmt1.N}")
    B2 = 8 * fmt2.tkb
    nb2 = fmt2.plane.shape[0]
    if nb2 * B2 != round_up(fmt1.N, B2):
        raise ValueError(
            f"{name}: layer-2 K padding ({nb2 * B2}) does not cover the "
            f"hidden width {fmt1.N}")


def _check_swiglu(fmt_gate: TiledBitplane, fmt_up: TiledBitplane,
                  fmt_down: TiledBitplane) -> None:
    if (fmt_up.K, fmt_up.N, fmt_up.tkb, fmt_up.tile_n) != \
            (fmt_gate.K, fmt_gate.N, fmt_gate.tkb, fmt_gate.tile_n) \
            or fmt_up.plane.shape[:2] != fmt_gate.plane.shape[:2]:
        raise ValueError("gate and up projections must share (K, N, tkb, "
                         "tile_n)")
    ffn_geometry(fmt_gate, fmt_down, KERNEL_NAME)


def swiglu_hidden_plain(xq, sx, fmt_gate, fmt_up, *, gamma_gate: float = 1.0,
                        gamma_up: float = 1.0) -> torch.Tensor:
    """``h = silu(gamma_g*(sx*(xq@Wg))) * (gamma_u*(sx*(xq@Wu)))`` in f32."""
    xi = torch.trunc(xq.to(torch.float32))
    sx = sx.reshape(-1, 1).to(torch.float32)
    g = gamma_gate * (sx * matmul_plain(xi, fmt_gate))
    u = gamma_up * (sx * matmul_plain(xi, fmt_up))
    return (g * sigmoid_f32(g)) * u


def swiglu_plain(xq, sx, fmt_gate, fmt_up, fmt_down, *,
                 gamma_gate: float = 1.0, gamma_up: float = 1.0,
                 gamma_down: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (``unfused_reference_swiglu``'s
    math, ``ops/fused_ffn.py:464-481`` of the JAX package)."""
    note_plain(KERNEL_NAME, xq)
    _check_swiglu(fmt_gate, fmt_up, fmt_down)
    h = swiglu_hidden_plain(xq, sx, fmt_gate, fmt_up, gamma_gate=gamma_gate,
                            gamma_up=gamma_up)
    hq, scale = requantize_rows(h)
    return matmul_plain(hq, fmt_down) * (scale * gamma_down)


def swiglu_mma_row_bytes(fmt_gate: TiledBitplane,
                         fmt_down: TiledBitplane) -> tuple:
    """Bytes a row of the tensor-core branch's two int8 scratches: xq staged
    for the gate and up containers, the requantized h for the down one
    (``ops.cuda_kernels.mma_row_bytes`` of each)."""
    return mma_row_bytes(fmt_gate), mma_row_bytes(fmt_down)


def _swiglu_run(mma: bool, xq, sx, fmt_gate, fmt_up, fmt_down, *,
                gamma_gate: float = 1.0, gamma_up: float = 1.0,
                gamma_down: float = 1.0, parts: tuple = None):
    """One call of the decode (``mma`` False) or the tensor-core branch ->
    ``(y, h, rmax)``, as :func:`swiglu_launch`. The decode branch splits
    each phase's walk into :func:`split_parts` parts, or into ``parts`` =
    (S1, S2) where a test or a timing asks for others."""
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL_NAME} runs on CUDA tensors (CPU tensors "
                         f"take the plain version); got a tensor on {dev}")
    _check_swiglu(fmt_gate, fmt_up, fmt_down)
    if xq.dim() != 2:
        raise ValueError(f"xq must be 2-D (M, K), got {tuple(xq.shape)}")
    M, K = xq.shape[0], fmt_gate.K
    N1, N2 = fmt_gate.N, fmt_down.N
    check_f32(xq, (M, K), dev, f"{KERNEL_NAME}: xq")
    check_f32(sx.reshape(-1) if sx.dim() == 2 else sx, (M,), dev,
              f"{KERNEL_NAME}: sx")
    pg, pu, pd = (check_plane(f, dev) for f in (fmt_gate, fmt_up, fmt_down))
    h = torch.empty((M, N1), dtype=torch.float32, device=dev)
    rmax = torch.empty((M,), dtype=torch.int32, device=dev)
    y = torch.empty((M, N2), dtype=torch.float32, device=dev)
    if M == 0:
        return y, h, rmax.view(torch.float32)
    # held until the launches are queued
    if mma:
        entry = "ternary_swiglu_mma"
        scratch = [torch.empty(M * n, dtype=torch.int8, device=dev)
                   for n in swiglu_mma_row_bytes(fmt_gate, fmt_down)]
        extra = [t.data_ptr() for t in scratch]
    else:
        entry = "ternary_swiglu"
        s1, s2 = parts or (
            split_parts(M, N1, pg.shape[0], fmt_gate.tkb, sm_count(dev)),
            split_parts(M, N2, pd.shape[0], fmt_down.tkb, sm_count(dev)))
        for p, f, w in ((s1, fmt_gate, pg), (s2, fmt_down, pd)):
            if not 1 <= p <= split_walk(w.shape[0], f.tkb):
                raise ValueError(f"{KERNEL_NAME}: {p} parts of a walk of "
                                 f"{split_walk(w.shape[0], f.tkb)} chunks")
        scratch = torch.empty(max(s1 * 2 * M * N1, s2 * M * N2)
                              if max(s1, s2) > 1 else 0,
                              dtype=torch.int32, device=dev)
        extra = [scratch.data_ptr() or None, s1, s2]
    err = getattr(_build.load(), entry)(
        xq.data_ptr(), sx.data_ptr(), M, K,
        pg.data_ptr(), pu.data_ptr(), pg.shape[0], pg.shape[1],
        fmt_gate.tkb, fmt_gate.tile_n, N1,
        pd.data_ptr(), pd.shape[0], pd.shape[1], fmt_down.tkb,
        fmt_down.tile_n, N2,
        float(gamma_gate), float(gamma_up), float(gamma_down),
        h.data_ptr(), rmax.data_ptr(), y.data_ptr(), stream_handle(dev),
        *extra)
    _build.check(err, entry)
    # counted where it is launched or captured, not at a graph's replay
    # (``ops.cuda_kernels.launches``)
    launches[KERNEL_NAME] += 1
    if mma:
        launches[SWIGLU_MMA_COUNT] += 1
    return y, h, rmax.view(torch.float32)


def _swiglu_lanes(xq, sx, fmt_gate, fmt_up, fmt_down, *, parts=None,
                  **gammas):
    """The decode branch of the SwiGLU kernel at any M; ``parts`` = (S1,
    S2) splits its phases' walks into other parts than
    :func:`split_parts`' (``(1, 1)``: the unsplit kernel)."""
    return _swiglu_run(False, xq, sx, fmt_gate, fmt_up, fmt_down,
                       parts=parts, **gammas)


def _swiglu_mma(xq, sx, fmt_gate, fmt_up, fmt_down, **gammas):
    """The tensor-core branch of the SwiGLU kernel at any M."""
    return _swiglu_run(True, xq, sx, fmt_gate, fmt_up, fmt_down, **gammas)


def swiglu_launch(xq, sx, fmt_gate, fmt_up, fmt_down, **gammas):
    """Run the CUDA kernel -> ``(y (M, N2), h (M, N1), rmax (M,))``: the
    output, the f32 hidden state and its per-row absmax (as f32), so a
    caller can check the requantized hidden against the plain version.
    Above :data:`SWIGLU_MMA_MIN_M` rows the tensor-core branch runs, up to
    it the decode branch; the two give the same bits."""
    mma = xq.dim() == 2 and xq.shape[0] > SWIGLU_MMA_MIN_M
    return _swiglu_run(mma, xq, sx, fmt_gate, fmt_up, fmt_down, **gammas)


def fused_bitplane_swiglu(xq, sx, fmt_gate: TiledBitplane,
                          fmt_up: TiledBitplane, fmt_down: TiledBitplane, *,
                          gamma_gate: float = 1.0, gamma_up: float = 1.0,
                          gamma_down: float = 1.0) -> torch.Tensor:
    """Fused ternary SwiGLU FFN over int8-valued activations ``xq (M, K)``
    (f32, |xq| <= 127, e.g. from :func:`requantize_rows`) with row scales
    ``sx (M, 1)``. ``fmt_down.K == fmt_gate.N == fmt_up.N`` and the down
    container is one storage tile (:func:`ffn_geometry`); the three
    projections are biasless. Any M: rows are independent."""
    kw = dict(gamma_gate=gamma_gate, gamma_up=gamma_up, gamma_down=gamma_down)
    if xq.device.type == "cpu":
        return swiglu_plain(xq, sx, fmt_gate, fmt_up, fmt_down, **kw)
    return swiglu_launch(xq, sx, fmt_gate, fmt_up, fmt_down, **kw)[0]


def unfused_reference_swiglu(xq, sx, fmt_gate, fmt_up, fmt_down, *,
                             gamma_gate: float = 1.0, gamma_up: float = 1.0,
                             gamma_down: float = 1.0, kernel: str = None):
    """The fused block as three registry SpMM calls + the shared
    requantize — the unfused counterpart."""
    from ternary_spgemm_tpu_torch.ops.api import ternary_spgemm

    xq = xq.to(torch.float32)
    sx = sx.to(torch.float32)
    zg = torch.zeros((fmt_gate.N,), dtype=torch.float32, device=xq.device)
    zd = torch.zeros((fmt_down.N,), dtype=torch.float32, device=xq.device)
    g = gamma_gate * (sx * ternary_spgemm(xq, fmt_gate, zg, None, kernel=kernel))
    u = gamma_up * (sx * ternary_spgemm(xq, fmt_up, zg, None, kernel=kernel))
    h = (g * sigmoid_f32(g)) * u
    hq, scale = requantize_rows(h)
    y = ternary_spgemm(hq, fmt_down, zd, None, kernel=kernel)
    return y * (scale * gamma_down)


# ---------------------------------------------------------------------------
# The PReLU FFN block (fused_bitplane_ffn)
# ---------------------------------------------------------------------------


def _check_ffn(X, fmt1: TiledBitplane, fmt2: TiledBitplane) -> None:
    M = X.shape[0]
    if M > SERVING_M:
        raise ValueError(
            f"{FFN_KERNEL_NAME} is the serving-M path (M <= {SERVING_M}), got "
            f"{M}; run the layers unfused at training M")
    ffn_geometry(fmt1, fmt2, FFN_KERNEL_NAME)


def _vec(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def ffn_hidden_plain(X, fmt1: TiledBitplane, b1, alpha1, *,
                     gamma1: float = 1.0) -> torch.Tensor:
    """``h = PReLU(i8(X) @ W1 + b1 / gamma1, alpha1)`` in f32, unscaled
    (``_i8_epilogue`` with ``b1/gamma1``, ``ops/fused_ffn.py:168-175``)."""
    return finish(matmul_plain(to_i8(X), fmt1),
                  true_div(_vec(b1, X.device), gamma1), alpha1)


def ffn_plain(X, fmt1: TiledBitplane, b1, alpha1, fmt2: TiledBitplane, b2,
              alpha2=None, *, gamma1: float = 1.0,
              gamma2: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (``unfused_reference_ffn``'s
    math, ``ops/fused_ffn.py:484-501`` of the JAX package); ``gamma1 *
    gamma2`` is one Python product, rounded once to f32 as JAX folds it."""
    note_plain(FFN_KERNEL_NAME, X)
    _check_ffn(X, fmt1, fmt2)
    h = ffn_hidden_plain(X, fmt1, b1, alpha1, gamma1=gamma1)
    hq, scale = requantize_rows(h)
    y = matmul_plain(hq, fmt2) * (scale * (gamma1 * gamma2))
    return finish(y, b2, alpha2)


def ffn_launch(X, fmt1: TiledBitplane, b1, alpha1, fmt2: TiledBitplane, b2,
               alpha2=None, *, gamma1: float = 1.0, gamma2: float = 1.0,
               parts: tuple = None):
    """Run the CUDA kernel -> ``(y (M, N2), h (M, N1), rmax (M,))``: the
    output, the unscaled f32 hidden state and its per-row absmax (as f32),
    so a caller can check the requantized hidden against the plain
    version. Each phase's byte-row walk is split into :func:`gemv_parts`
    parts (phase 1's X rule two int8 planes, phase 2's one), or into
    ``parts`` = (S1, S2) where a test or a timing asks for others
    (ValueError before any launch for parts the walk or the staged X does
    not allow)."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"{FFN_KERNEL_NAME} runs on CUDA tensors (CPU "
                         f"tensors take the plain version); got a tensor on "
                         f"{dev}")
    if X.dim() != 2:
        raise ValueError(f"X must be 2-D (M, K), got {tuple(X.shape)}")
    _check_ffn(X, fmt1, fmt2)
    M, K, N1, N2 = X.shape[0], fmt1.K, fmt1.N, fmt2.N
    name = FFN_KERNEL_NAME
    check_f32(X, (M, K), dev, f"{name}: X")
    p1, p2 = check_plane(fmt1, dev), check_plane(fmt2, dev)
    check_f32(b1, (N1,), dev, f"{name}: b1")
    check_f32(b2, (N2,), dev, f"{name}: b2")
    for a, n, what in ((alpha1, N1, "alpha1"), (alpha2, N2, "alpha2")):
        if a is not None:
            check_f32(a, (n,), dev, f"{name}: {what}")
    b1g = true_div(b1, gamma1)
    h = torch.empty((M, N1), dtype=torch.float32, device=dev)
    rmax = torch.empty((M,), dtype=torch.int32, device=dev)
    y = torch.empty((M, N2), dtype=torch.float32, device=dev)
    if M == 0:
        return y, h, rmax.view(torch.float32)
    (s1, t1), (s2, t2) = (
        gemv_plan(name, M, f.N, w.shape[0], f.tkb, planes, dev, p)
        for f, w, planes, p in zip((fmt1, fmt2), (p1, p2), (2, 1),
                                   parts or (None, None)))
    stream = stream_handle(dev)
    # held until the launches are queued
    part = counters = None
    if max(s1, s2) > 1:
        part = torch.empty(max(s1 * M * N1, s2 * M * N2), dtype=torch.int32,
                           device=dev)
        counters = gemv_counters(dev, stream, max(t1, t2))
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _build.load().ternary_prelu_ffn(
        X.data_ptr(), M, K, p1.data_ptr(), p1.shape[0], p1.shape[1],
        fmt1.tkb, fmt1.tile_n, N1, b1g.data_ptr(), ptr(alpha1),
        p2.data_ptr(), p2.shape[0], p2.shape[1], fmt2.tkb, fmt2.tile_n, N2,
        b2.data_ptr(), ptr(alpha2), float(gamma1 * gamma2), h.data_ptr(),
        rmax.data_ptr(), y.data_ptr(), stream, ptr(part), ptr(counters), s1,
        s2)
    _build.check(err, "ternary_prelu_ffn")
    launches[FFN_KERNEL_NAME] += 1
    return y, h, rmax.view(torch.float32)


def fused_bitplane_ffn(X, fmt1: TiledBitplane, b1, alpha1,
                       fmt2: TiledBitplane, b2, alpha2=None, *,
                       gamma1: float = 1.0,
                       gamma2: float = 1.0) -> torch.Tensor:
    """The fused PReLU FFN block (module docstring) over TiledBitplane
    weights. Contract, JAX's: serving M (at most 128 rows), integer-valued
    f32 ``X`` with ``|X| <= 512``, a single-N-tile OUTPUT container and
    ``fmt2.K == fmt1.N`` (:func:`ffn_geometry`); ``alpha1``/``alpha2`` may
    be None (no PReLU); ``gamma*`` are the exported absmean scales."""
    kw = dict(gamma1=gamma1, gamma2=gamma2)
    if X.device.type == "cpu":
        return ffn_plain(X, fmt1, b1, alpha1, fmt2, b2, alpha2, **kw)
    return ffn_launch(X, fmt1, b1, alpha1, fmt2, b2, alpha2, **kw)[0]


def unfused_reference_ffn(X, fmt1, b1, alpha1, fmt2, b2, alpha2=None, *,
                          gamma1: float = 1.0, gamma2: float = 1.0,
                          kernel: str = None) -> torch.Tensor:
    """The PReLU block as two registry SpMM calls + the shared requantize —
    the unfused counterpart (``kernel=None``: default dispatch)."""
    from ternary_spgemm_tpu_torch.ops.api import ternary_spgemm

    X = X.to(torch.float32)
    b1f = true_div(_vec(b1, X.device), gamma1)
    h = ternary_spgemm(X, fmt1, b1f, alpha1, kernel=kernel)
    hq, scale = requantize_rows(h)
    zeros = torch.zeros((fmt2.N,), dtype=torch.float32, device=X.device)
    y = ternary_spgemm(hq, fmt2, zeros, None, kernel=kernel)
    return finish(y * (scale * (gamma1 * gamma2)), b2, alpha2)
