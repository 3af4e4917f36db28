"""The benchmark's speedup denominator ``BaseTCSC`` as plain torch ops —
counterpart of ``ternary_spgemm_tpu/ops/xla_kernels.py:67-160``.

In the JAX package this kernel is XLA (a gather plus a sorted segment sum),
not Pallas, so the port writes it with torch ops and no kernel of its own:
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

from ternary_spgemm_tpu_torch.formats.tcsc import TCSC
from ternary_spgemm_tpu_torch.ops.api import finish, register_kernel

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
