"""The XLA formulations of the JAX registry as torch ops — counterpart of
``ternary_spgemm_tpu/ops/xla_kernels.py``: the speedup denominator
``BaseTCSC`` (``:67-160`` there), the masked gather ``BlockedEllTCSC``
(``:242-264``), the three dense products over ``DenseTernary``,
``DenseMXU``, ``DenseMXU_bf16`` and ``DenseMXU_x8`` (``:267-305``), and the
two decode-then-dot products over the stride-packed containers,
``PackedMXU_2bit`` and ``PackedMXU_base3`` (``:308-356``).

In the JAX package these are XLA, not Pallas, so the port writes them with
torch ops and no kernel of its own; they are registered kernels, not plain
versions of one, and count no plain-version runs. The dense products are
one ``torch.matmul`` each, in full f32 (``allow_tf32`` must be off on the
card, as for :func:`ops.api.matmul_plain`):

* ``DenseMXU``: f32 X times the int8 plane widened to f32 — JAX's f32 dot at
  precision HIGHEST;
* ``DenseMXU_bf16``: X rounded to bf16 and widened back, so the sums stay
  f32 as with JAX's ``preferred_element_type=float32`` (a bf16 x bf16
  ``torch.matmul`` would round its output to bf16);
* ``DenseMXU_x8``: X rounded half to even and clamped to +-127, JAX's int8 x
  int8 -> int32 dot; in f32 every partial sum is an integer of magnitude
  at most 127*K, exact while 127*K <= 2**24 (K <= 132,104), so the result is
  the int32 dot's;
* ``PackedMXU_2bit`` / ``PackedMXU_base3``: the stride codes decoded
  (:func:`decode_2bit`, :func:`decode_base3`, K taken from X as JAX does),
  then f32 X times them.

``BlockedEllTCSC`` gathers, per K-block, the X column of each slot's local
offset (a sentinel -1 reads an appended zero column) and sums over the
slots, pos minus neg.

BaseTCSC (in JAX a gather plus a sorted segment sum) is an
``index_select`` of the activation columns each nonzero reads, then
``index_add_`` into its output column. Above ``_GATHER_CHUNK_FLOATS`` the
(M, nnz) gathered stream would be too large, and the kernel walks M in
chunks over the container's padded per-column gather tables instead (a pure
gather and a sum over the slot axis, no scatter).

Sums are exact for the integer test distribution (|partial sums| < 2**24).
On a CUDA tensor ``index_add_`` adds with atomics, so on non-integer X the
f32 result can differ from run to run in the last bits.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.blocked_ell import BlockedEllTCSC
from ternary_spgemm_tpu_torch.formats.packed import (
    DenseTernary,
    PackedTernary2Bit,
    PackedTernary53,
    decode_fields,
)
from ternary_spgemm_tpu_torch.formats.tcsc import TCSC
from ternary_spgemm_tpu_torch.ops.api import (
    finish,
    matmul_dense,
    matmul_plain,
    register_kernel,
    to_bf16,
    to_f32,
    to_x8,
)

#: Cap (in f32 elements) for the materialized (M, nnz) gather stream; above
#: it the kernel takes the M-chunked path. 2**26 floats = 256 MB.
_GATHER_CHUNK_FLOATS = 1 << 26

#: Intermediate budget (f32 elements) of one (M-chunk, slot section, N)
#: gather of the chunked path.
_CHUNK_BUDGET_FLOATS = 1 << 28

#: Slot-axis section of the chunked path's gathers.
_SEC = 1024


def _segment_cols(data: torch.Tensor, col_ids: torch.Tensor,
                  N: int) -> torch.Tensor:
    """Sum ``data[:, i]`` into output column ``col_ids[i]``: (M, nnz) ->
    (M, N)."""
    out = torch.zeros((data.shape[0], N), dtype=data.dtype, device=data.device)
    return out.index_add_(1, col_ids, data)


def _tcsc_chunked(X: torch.Tensor, fmt: TCSC) -> torch.Tensor:
    """M-chunks of per-column padded gathers (``fmt.ell_pos``/``ell_neg``,
    empty slots pointing at an appended zero column)."""
    M, K = X.shape
    N = fmt.N
    sec_rows = min(_SEC, max(fmt.ell_pos.shape[0], fmt.ell_neg.shape[0], 1))
    MC = max(1, _CHUNK_BUDGET_FLOATS // (N * sec_rows))
    Xp = torch.nn.functional.pad(X, (0, 1))              # zero column at K
    out = torch.empty((M, N), dtype=torch.float32, device=X.device)
    for m0 in range(0, M, MC):
        xc = Xp[m0:m0 + MC]
        acc = torch.zeros((xc.shape[0], N), dtype=torch.float32,
                          device=X.device)
        for tbl, sign in ((fmt.ell_pos, 1.0), (fmt.ell_neg, -1.0)):
            for s0 in range(0, tbl.shape[0], _SEC):
                sec = tbl[s0:s0 + _SEC]
                part = xc.index_select(1, sec.reshape(-1)).view(
                    xc.shape[0], sec.shape[0], N).sum(dim=1)
                acc = acc + sign * part
        out[m0:m0 + MC] = acc
    return out


@register_kernel(
    "BaseTCSC", TCSC,
    description="split-sign gather + segment-sum as torch ops (speedup "
                "baseline); walks M in chunks over padded gather tables when "
                "the (M, nnz) stream exceeds the budget",
    reference="ternary_spgemm_tpu/ops/xla_kernels.py:140")
def tcsc_kernel(X, fmt: TCSC, bias, alpha=None):
    X = torch.as_tensor(X, dtype=torch.float32)
    if X.shape[0] * fmt.nnz > _GATHER_CHUNK_FLOATS:
        return finish(_tcsc_chunked(X, fmt.with_ell_tables()), bias, alpha)
    pos = _segment_cols(X.index_select(1, fmt.row_index_pos),
                        fmt.col_ids_pos, fmt.N)
    neg = _segment_cols(X.index_select(1, fmt.row_index_neg),
                        fmt.col_ids_neg, fmt.N)
    return finish(pos - neg, bias, alpha)


@register_kernel(
    "BlockedEllTCSC", BlockedEllTCSC,
    description="masked gather over per-K-block local-offset ELL planes as "
                "torch ops (the formulation of the PallasEllGather strategy)",
    reference="ternary_spgemm_tpu/ops/xla_kernels.py:248")
def blocked_ell_kernel(X, fmt: BlockedEllTCSC, bias, alpha=None):
    X = to_f32(torch.as_tensor(X))
    M = X.shape[0]
    nb, BK = fmt.num_blocks, fmt.block_k
    # one zero column after each block: the sentinel -1 reads it
    Xz = torch.nn.functional.pad(
        torch.nn.functional.pad(X, (0, nb * BK - fmt.K)).view(M, nb, BK),
        (0, 1))
    out = []
    for idx in (fmt.idx_pos, fmt.idx_neg):      # (nb, CAP, N_pad) int8
        cap, n_pad = idx.shape[1:]
        lanes = torch.where(idx >= 0, idx.long(), BK)
        acc = torch.zeros((M, n_pad), dtype=torch.float32, device=X.device)
        for b in range(nb):                     # one (M, CAP, N_pad) gather
            acc += Xz[:, b].index_select(1, lanes[b].reshape(-1)).view(
                M, cap, n_pad).sum(dim=1)
        out.append(acc)
    return finish((out[0] - out[1])[:, :fmt.N], bias, alpha)


@register_kernel(
    "DenseMXU", DenseTernary,
    description="densified int8 weights, exact f32 torch.matmul",
    reference="ternary_spgemm_tpu/ops/xla_kernels.py:272")
def dense_mxu_kernel(X, fmt: DenseTernary, bias, alpha=None):
    return finish(matmul_plain(to_f32(X), fmt), bias, alpha)


@register_kernel(
    "DenseMXU_bf16", DenseTernary,
    description="X rounded to bf16, f32 torch.matmul (inexact for |x| > 256)",
    reference="ternary_spgemm_tpu/ops/xla_kernels.py:283",
    approximate=True)
def dense_mxu_bf16_kernel(X, fmt: DenseTernary, bias, alpha=None):
    return finish(matmul_plain(to_bf16(X), fmt), bias, alpha)


@register_kernel(
    "DenseMXU_x8", DenseTernary,
    description="int8-native activations (round + clamp +-127), exact "
                "integer sums in an f32 torch.matmul (exact for integer "
                "activations |x| <= 127, clamps outside)",
    reference="ternary_spgemm_tpu/ops/xla_kernels.py:298",
    x_absmax=127)
def dense_mxu_x8_kernel(X, fmt: DenseTernary, bias, alpha=None):
    return finish(matmul_plain(to_x8(X), fmt), bias, alpha)


def decode_2bit(packed: torch.Tensor, K: int) -> torch.Tensor:
    """A stride-packed 2-bit plane ``(Kq, N)`` uint8 -> ``(K, N)`` int8:
    field j of byte row k' is dense row ``j*Kq + k'``."""
    return torch.cat(decode_fields(packed, 4))[:K]


def decode_base3(packed: torch.Tensor, K: int) -> torch.Tensor:
    """A stride-packed base-3 plane ``(Kq, N)`` uint8 -> ``(K, N)`` int8."""
    return torch.cat(decode_fields(packed, 5))[:K]


@register_kernel(
    "PackedMXU_2bit", PackedTernary2Bit,
    description="2-bit packed weights (4 a byte) decoded, exact f32 "
                "torch.matmul",
    reference="ternary_spgemm_tpu/ops/xla_kernels.py:339")
def packed2_mxu_kernel(X, fmt: PackedTernary2Bit, bias, alpha=None):
    X = to_f32(torch.as_tensor(X))
    return finish(matmul_dense(X, decode_2bit(fmt.packed, X.shape[1])),
                  bias, alpha)


@register_kernel(
    "PackedMXU_base3", PackedTernary53,
    description="base-3 packed weights (5 a byte) decoded, exact f32 "
                "torch.matmul",
    reference="ternary_spgemm_tpu/ops/xla_kernels.py:352")
def packed53_mxu_kernel(X, fmt: PackedTernary53, bias, alpha=None):
    X = to_f32(torch.as_tensor(X))
    return finish(matmul_dense(X, decode_base3(fmt.packed, X.shape[1])),
                  bias, alpha)
