"""Sign-interleaved split-sign CSC — counterpart of
``ternary_spgemm_tpu/formats/interleaved.py::InterleavedTCSC``.

One row-index stream ``all_indices`` with three pointers a column in
``col_segment_ptr`` (3N+1 entries, reference ``InterleavedTCSC.h:7-84``):
per column, groups of ``group`` positive then ``group`` negative indices
while both signs have a full group left, then the leftover positives, then
the leftover negatives (``InterleavedTCSC.h:44-72``). The companion
``signs`` (int8) and ``col_ids`` streams make the branch-free signed stream
explicit for the torch-op formulation. The packer is the blocked one's
(``formats/blocked.py``) with one block of all K rows, and gives the JAX
package's arrays byte for byte.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)
from ternary_spgemm_tpu_torch.formats.blocked import (
    _decode_segments,
    _interleaved_container,
)


@register_format
class InterleavedTCSC(TernaryFormat):
    """Interleaved split-sign CSC (reference ``InterleavedTCSC.h:7-84``)."""

    ARRAY_FIELDS = ("all_indices", "col_segment_ptr", "signs", "col_ids")

    all_indices: torch.Tensor      # (nnz,) int32
    col_segment_ptr: torch.Tensor  # (3N+1,) int32
    signs: torch.Tensor            # (nnz,) int8 companion (derived)
    col_ids: torch.Tensor          # (nnz,) int32 companion (derived)
    K: int
    N: int
    group: int

    @classmethod
    def from_dense(cls, W, group: int = 4, *,
                   device=None) -> "InterleavedTCSC":
        """Build from a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own)."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        idx, sgn, seg_ptr, col_ids = _interleaved_container(W, K, group)
        return cls(all_indices=idx, col_segment_ptr=seg_ptr, signs=sgn,
                   col_ids=col_ids, K=K, N=N, group=group)

    def to_dense(self) -> torch.Tensor:
        """Decoded from ``(all_indices, col_segment_ptr)`` alone."""
        return _decode_segments(self.all_indices, self.col_segment_ptr,
                                self.K, self.N, self.group)

    def size_bytes(self) -> int:
        # index stream + 3N+1 pointer table
        # (InterleavedTCSC::getDataStructureSize)
        return 4 * (len(self.all_indices) + len(self.col_segment_ptr))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.all_indices)
