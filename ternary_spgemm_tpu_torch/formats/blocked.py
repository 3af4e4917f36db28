"""K-blocked and sign-interleaved split-sign containers — counterpart of
``ternary_spgemm_tpu/formats/blocked.py`` (``BlockedTCSC``,
``InterleavedBlockedTCSC``, ``_check_block``, ``_interleave_streams``).

* :class:`BlockedTCSC` — a split-sign CSC per K-block of ``block_size``
  rows (reference ``BlockedTCSC.h:6-49``): column pointers of
  ``(K/B)*N + 1`` entries, block-major then column, *global* row indices,
  per-nonzero column ids and per-block stream offsets ``block_ptr_*``.
* :class:`InterleavedBlockedTCSC` — one stream per (block, column)
  (reference ``InterleavedBlockedTCSC.h:7-157``): while both signs have a
  full ``group`` left, ``group`` positives then ``group`` negatives; then
  the leftover positives, then the leftover negatives. ``seg_ptr`` holds
  three pointers a (block, column): the end of the interleaved run, of the
  leftover positives and of the segment. The companion ``signs`` (int8)
  and ``col_ids`` streams make the sign and column of every entry
  explicit for the torch-op formulation.

The packers are vectorised torch (no loop over columns, which the JAX
packer runs) and give the JAX package's arrays byte for byte; they run on
whatever device their input lies on.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)


def _check_block(K: int, block_size: int):
    if K % block_size != 0:
        raise ValueError(
            f"K={K} must be divisible by block_size={block_size} "
            "(reference asserts the same, BlockedTCSC.h:5)")


def _exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0) - counts


def _segment_entries(W: torch.Tensor, value: int, block_size: int):
    """(segment, global row) of every entry of ``W`` equal to ``value``,
    segment ``b * N + n`` for K-block b and column n, ordered by segment and
    then row (one block of all K rows gives segment = column)."""
    K, N = W.shape
    nb = K // block_size
    nz = torch.nonzero(W.view(nb, block_size, N).permute(0, 2, 1) == value)
    return nz[:, 0] * N + nz[:, 1], nz[:, 0] * block_size + nz[:, 2]


def _interleave_segments(seg_pos, row_pos, seg_neg, row_neg, n_seg: int,
                         group: int):
    """The interleaved streams of ``n_seg`` segments at once: every entry's
    place in its segment by the rule of ``_interleave_streams``. Returns
    ``(indices int32, signs int8, segment of each entry int64, seg_ptr
    (3 * n_seg + 1,) int32)``."""
    dev = row_pos.device
    g = group
    P = torch.bincount(seg_pos, minlength=n_seg)
    Q = torch.bincount(seg_neg, minlength=n_seg)
    pr = torch.minimum(P // g, Q // g) * g        # entries a sign interleaves
    start = _exclusive_cumsum(P + Q)

    def place(seg, counts, first_neg):
        r = torch.arange(len(seg), device=dev) - _exclusive_cumsum(counts)[seg]
        p = pr[seg]
        inter = (r // g) * 2 * g + r % g + (g if first_neg else 0)
        rest = 2 * p + r - p + (P[seg] - p if first_neg else 0)
        return start[seg] + torch.where(r < p, inter, rest)

    total = int(P.sum() + Q.sum())
    idx = torch.empty(total, dtype=torch.int32, device=dev)
    sgn = torch.empty(total, dtype=torch.int8, device=dev)
    seg = torch.empty(total, dtype=torch.int64, device=dev)
    for s_ids, rows, sign, neg in ((seg_pos, row_pos, 1, False),
                                   (seg_neg, row_neg, -1, True)):
        dest = place(s_ids, P if not neg else Q, neg)
        idx[dest] = rows.to(torch.int32)
        sgn[dest] = sign
        seg[dest] = s_ids
    ptr = torch.stack([start + 2 * pr, start + 2 * pr + P - pr, start + P + Q],
                      dim=1).reshape(-1)
    seg_ptr = torch.cat([torch.zeros(1, dtype=ptr.dtype, device=dev), ptr])
    return idx, sgn, seg, seg_ptr.to(torch.int32)


def _interleave_streams(pos: torch.Tensor, neg: torch.Tensor, group: int):
    """Interleave ``group`` positives with ``group`` negatives while both
    streams have a full group left, then the leftover positives, then the
    leftover negatives; returns ``(indices, signs, n_interleaved_pairs)``
    (the rule of ``InterleavedTCSC.h:44-72`` at group 4 and of both
    ``InterleavedBlockedTCSC`` constructors)."""
    z = lambda t: torch.zeros(len(t), dtype=torch.int64, device=t.device)
    idx, sgn, _, _ = _interleave_segments(z(pos), pos, z(neg), neg, 1, group)
    return idx, sgn, min(len(pos) // group, len(neg) // group)


@register_format
class BlockedTCSC(TernaryFormat):
    """Per-K-block split-sign CSC (reference ``BlockedTCSC.h:6-49``)."""

    ARRAY_FIELDS = (
        "col_start_pos", "col_start_neg", "row_index_pos", "row_index_neg",
        "col_ids_pos", "col_ids_neg", "block_ptr_pos", "block_ptr_neg",
    )

    col_start_pos: torch.Tensor  # (num_blocks*N + 1,) int32, block-major
    col_start_neg: torch.Tensor  # (num_blocks*N + 1,) int32
    row_index_pos: torch.Tensor  # (nnz_pos,) int32, global row ids
    row_index_neg: torch.Tensor  # (nnz_neg,) int32
    col_ids_pos: torch.Tensor    # (nnz_pos,) int32 companion
    col_ids_neg: torch.Tensor    # (nnz_neg,) int32
    block_ptr_pos: torch.Tensor  # (num_blocks+1,) int32 stream offsets
    block_ptr_neg: torch.Tensor  # (num_blocks+1,) int32
    K: int
    N: int
    block_size: int

    @classmethod
    def from_dense(cls, W, block_size: int = 512, *,
                   device=None) -> "BlockedTCSC":
        """Build from a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own); K must be a multiple of
        ``block_size``."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        _check_block(K, block_size)
        nb = K // block_size

        def build(value):
            seg, rows = _segment_entries(W, value, block_size)
            col_start = torch.zeros(nb * N + 1, dtype=torch.int64,
                                    device=W.device)
            col_start[1:] = torch.cumsum(
                torch.bincount(seg, minlength=nb * N), 0)
            return (col_start.to(torch.int32), rows.to(torch.int32),
                    (seg % N).to(torch.int32),
                    col_start[::N].to(torch.int32))

        csp, rip, cip, bpp = build(1)
        csn, rin, cin, bpn = build(-1)
        return cls(col_start_pos=csp, col_start_neg=csn,
                   row_index_pos=rip, row_index_neg=rin,
                   col_ids_pos=cip, col_ids_neg=cin,
                   block_ptr_pos=bpp, block_ptr_neg=bpn,
                   K=K, N=N, block_size=block_size)

    @property
    def num_blocks(self) -> int:
        return self.K // self.block_size

    def to_dense(self) -> torch.Tensor:
        W = torch.zeros((self.K, self.N), dtype=torch.int8,
                        device=self.row_index_pos.device)
        W[self.row_index_pos.long(), self.col_ids_pos.long()] = 1
        W[self.row_index_neg.long(), self.col_ids_neg.long()] = -1
        return W

    def size_bytes(self) -> int:
        # two pointer tables of (K/B)*N+1 entries + the two index streams
        # (BlockedTCSC::getDataStructureSize)
        return 4 * (2 * (self.num_blocks * self.N + 1)
                    + len(self.row_index_pos) + len(self.row_index_neg))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.row_index_pos) + len(self.row_index_neg)


def _interleaved_container(W: torch.Tensor, block_size: int, group: int):
    """(all_indices, signs, seg_ptr, col_ids) of the interleaved streams of
    ``W``'s (block, column) segments."""
    K, N = W.shape
    n_seg = (K // block_size) * N
    sp, rp = _segment_entries(W, 1, block_size)
    sn, rn = _segment_entries(W, -1, block_size)
    idx, sgn, seg, seg_ptr = _interleave_segments(sp, rp, sn, rn, n_seg,
                                                  group)
    return idx, sgn, seg_ptr, (seg % N).to(torch.int32)


@register_format
class InterleavedBlockedTCSC(TernaryFormat):
    """Blocked + sign-interleaved container (reference
    ``InterleavedBlockedTCSC.h:7-157``); ``group=1`` is the reference's base
    constructor, ``group=UF/2`` the unrolled one (``main.cpp:8,72`` runs
    UF=12, group 6)."""

    ARRAY_FIELDS = ("all_indices", "signs", "seg_ptr", "col_ids", "block_ptr")

    all_indices: torch.Tensor  # (nnz,) int32 global row ids
    signs: torch.Tensor        # (nnz,) int8 companion sign stream
    seg_ptr: torch.Tensor      # (num_blocks*3N + 1,) int32
    col_ids: torch.Tensor      # (nnz,) int32 companion
    block_ptr: torch.Tensor    # (num_blocks+1,) int32
    K: int
    N: int
    block_size: int
    group: int

    @classmethod
    def from_dense(cls, W, block_size: int = 512, group: int = 1, *,
                   device=None) -> "InterleavedBlockedTCSC":
        """Build from a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own); K must be a multiple of
        ``block_size``."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        _check_block(K, block_size)
        idx, sgn, seg_ptr, col_ids = _interleaved_container(W, block_size,
                                                            group)
        # a block's stream ends where its last column's segment does
        block_ptr = seg_ptr[::3 * N].contiguous()
        return cls(all_indices=idx, signs=sgn, seg_ptr=seg_ptr,
                   col_ids=col_ids, block_ptr=block_ptr, K=K, N=N,
                   block_size=block_size, group=group)

    @property
    def num_blocks(self) -> int:
        return self.K // self.block_size

    def to_dense(self) -> torch.Tensor:
        """Decoded from ``(all_indices, seg_ptr)``: the sign of every index
        is implied by where it lies in its segment (``comp.h:782-848``)."""
        return _decode_segments(self.all_indices, self.seg_ptr, self.K,
                                self.N, self.group)

    def size_bytes(self) -> int:
        # index stream + segment-pointer table (the signs are implied by
        # the segments; the explicit companion is derived, not counted)
        return 4 * (len(self.all_indices) + len(self.seg_ptr))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.all_indices)


def _decode_segments(all_indices: torch.Tensor, seg_ptr: torch.Tensor,
                     K: int, N: int, group: int) -> torch.Tensor:
    """The dense ``(K, N)`` int8 matrix of interleaved streams, each entry's
    sign and column read from the segment pointers alone (segment s is
    column ``s % N``)."""
    dev = all_indices.device
    W = torch.zeros((K, N), dtype=torch.int8, device=dev)
    n = len(all_indices)
    if not n:
        return W
    ptr = seg_ptr.long()
    bounds = ptr[1:]                         # 3 ends a segment
    pos = torch.arange(n, device=dev)
    which = torch.searchsorted(bounds, pos, right=True)   # 0 .. 3*S - 1
    s, part = which // 3, which % 3
    j = pos - ptr[3 * s]                     # offset in the segment
    inter = torch.where((j // group) % 2 == 0, 1, -1)
    sign = torch.where(part == 0, inter, torch.where(part == 1, 1, -1))
    W[all_indices.long(), s % N] = sign.to(torch.int8)
    return W
