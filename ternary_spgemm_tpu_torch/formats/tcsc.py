"""Split-sign compressed-column and compressed-row ternary containers —
counterpart of ``ternary_spgemm_tpu/formats/tcsc.py`` (``TCSC``, ``TCSR``).

Per-column pointer arrays ``col_start_pos``/``col_start_neg`` (N+1 each)
and row-index streams ``row_index_pos``/``row_index_neg``; the sign is
implied by the stream. A flattened companion view, the per-nonzero column
ids ``col_ids_*``, feeds the gather + segment-sum kernel
(``ops/xla_kernels.py``), and the padded per-column gather tables
``ell_pos``/``ell_neg`` feed its M-chunked path; the tables are built only
when that path will run (:meth:`TCSC.prepare`).

:class:`TCSR` is the row-major dual: per-row pointers ``row_start_*``
(K+1 each), column-index streams ``col_index_*`` in row-major order, and
the per-nonzero row ids ``row_ids_*`` as its companion view, which the
scatter formulation ``BaseTCSR`` reads. Every array is int32 and identical
to the JAX package's for the same matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)


def _csc_arrays(W: torch.Tensor, value: int):
    """(col_start, row_index, col_ids) for entries of W equal to ``value``,
    ordered column-major (by column, then row) — the CSC stream order."""
    K, N = W.shape
    nz = torch.nonzero(W.t() == value)      # lexicographic: column, then row
    n_idx, k_idx = nz[:, 0], nz[:, 1]
    col_start = torch.zeros(N + 1, dtype=torch.int32, device=W.device)
    col_start[1:] = torch.cumsum(torch.bincount(n_idx, minlength=N), 0)
    return col_start, k_idx.to(torch.int32), n_idx.to(torch.int32)


def _csr_arrays(W: torch.Tensor, value: int):
    """(row_start, col_index, row_ids) for entries of W equal to ``value``,
    ordered row-major (by row, then column) — the CSR stream order."""
    K, N = W.shape
    nz = torch.nonzero(W == value)          # lexicographic: row, then column
    k_idx, n_idx = nz[:, 0], nz[:, 1]
    row_start = torch.zeros(K + 1, dtype=torch.int32, device=W.device)
    row_start[1:] = torch.cumsum(torch.bincount(k_idx, minlength=K), 0)
    return row_start, n_idx.to(torch.int32), k_idx.to(torch.int32)


def _ell_table(row_index, col_start, col_ids, K: int, N: int) -> torch.Tensor:
    """Padded per-column gather table (cap, N): slot s of column n = the
    s-th row index of column n's stream; empty slots point at K (callers
    append a zero column)."""
    counts = col_start[1:] - col_start[:-1]
    cap = int(counts.max()) if N else 0
    tbl = torch.full((max(cap, 1), N), K, dtype=torch.int32,
                     device=row_index.device)
    cols = col_ids.long()
    slot = torch.arange(len(row_index), device=row_index.device) \
        - col_start[cols].long()
    tbl[slot, cols] = row_index
    return tbl


@register_format
class TCSC(TernaryFormat):
    """Split-sign ternary CSC (reference ``TCSC.h:5-50``)."""

    ARRAY_FIELDS = (
        "col_start_pos", "col_start_neg", "row_index_pos", "row_index_neg",
        "col_ids_pos", "col_ids_neg", "ell_pos", "ell_neg",
    )

    col_start_pos: torch.Tensor  # (N+1,) int32
    col_start_neg: torch.Tensor  # (N+1,) int32
    row_index_pos: torch.Tensor  # (nnz_pos,) int32
    row_index_neg: torch.Tensor  # (nnz_neg,) int32
    col_ids_pos: torch.Tensor    # (nnz_pos,) int32, derived companion view
    col_ids_neg: torch.Tensor    # (nnz_neg,) int32
    K: int
    N: int
    #: padded gather tables (cap, N) int32, or None until prepared; derived
    #: data, not counted in size_bytes, but the real weight stream of the
    #: M-chunked kernel path
    ell_pos: torch.Tensor = None
    ell_neg: torch.Tensor = None

    @classmethod
    def from_dense(cls, W, *, device=None) -> "TCSC":
        """Build from a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own)."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        csp, rip, cip = _csc_arrays(W, 1)
        csn, rin, cin = _csc_arrays(W, -1)
        return cls(col_start_pos=csp, col_start_neg=csn,
                   row_index_pos=rip, row_index_neg=rin,
                   col_ids_pos=cip, col_ids_neg=cin, K=K, N=N)

    def with_ell_tables(self) -> "TCSC":
        """A copy carrying the padded gather tables (a no-op if present),
        memoized on the instance so repeated calls build them once."""
        if self.ell_pos is not None:
            return self
        cached = getattr(self, "_ell_cached", None)
        if cached is None:
            cached = dataclasses.replace(
                self,
                ell_pos=_ell_table(self.row_index_pos, self.col_start_pos,
                                   self.col_ids_pos, self.K, self.N),
                ell_neg=_ell_table(self.row_index_neg, self.col_start_neg,
                                   self.col_ids_neg, self.K, self.N))
            object.__setattr__(self, "_ell_cached", cached)
        return cached

    def prepare(self, M: int) -> "TCSC":
        """Build the gather tables iff an (M, ...) SpMM takes the M-chunked
        path."""
        from ternary_spgemm_tpu_torch.ops import xla_kernels

        if M * self.nnz > xla_kernels._GATHER_CHUNK_FLOATS:
            return self.with_ell_tables()
        return self

    def to_dense(self) -> torch.Tensor:
        W = torch.zeros((self.K, self.N), dtype=torch.int8,
                        device=self.row_index_pos.device)
        W[self.row_index_pos.long(), self.col_ids_pos.long()] = 1
        W[self.row_index_neg.long(), self.col_ids_neg.long()] = -1
        return W

    def size_bytes(self) -> int:
        # CSP + CSN (N+1 each) + RIP + RIN, all int32 (TCSC.h:41-48)
        return 4 * (2 * (self.N + 1) + len(self.row_index_pos)
                    + len(self.row_index_neg))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.row_index_pos) + len(self.row_index_neg)


@register_format
class TCSR(TernaryFormat):
    """Split-sign ternary CSR (reference ``TCSR.h:5-50``), the scatter-style
    dual of :class:`TCSC`."""

    ARRAY_FIELDS = (
        "row_start_pos", "row_start_neg", "col_index_pos", "col_index_neg",
        "row_ids_pos", "row_ids_neg",
    )

    row_start_pos: torch.Tensor  # (K+1,) int32
    row_start_neg: torch.Tensor  # (K+1,) int32
    col_index_pos: torch.Tensor  # (nnz_pos,) int32
    col_index_neg: torch.Tensor  # (nnz_neg,) int32
    row_ids_pos: torch.Tensor    # (nnz_pos,) int32, derived companion view
    row_ids_neg: torch.Tensor    # (nnz_neg,) int32
    K: int
    N: int

    @classmethod
    def from_dense(cls, W, *, device=None) -> "TCSR":
        """Build from a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own)."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        rsp, cip, kip = _csr_arrays(W, 1)
        rsn, cin, kin = _csr_arrays(W, -1)
        return cls(row_start_pos=rsp, row_start_neg=rsn,
                   col_index_pos=cip, col_index_neg=cin,
                   row_ids_pos=kip, row_ids_neg=kin, K=K, N=N)

    def to_dense(self) -> torch.Tensor:
        W = torch.zeros((self.K, self.N), dtype=torch.int8,
                        device=self.col_index_pos.device)
        W[self.row_ids_pos.long(), self.col_index_pos.long()] = 1
        W[self.row_ids_neg.long(), self.col_index_neg.long()] = -1
        return W

    def size_bytes(self) -> int:
        return 4 * (2 * (self.K + 1) + len(self.col_index_pos)
                    + len(self.col_index_neg))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.col_index_pos) + len(self.col_index_neg)
