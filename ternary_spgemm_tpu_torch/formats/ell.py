"""Rectangular (ELL-style) split-sign container — counterpart of
``ternary_spgemm_tpu/formats/ell.py::EllTCSC`` (with ``_ell_plane``).

The reference's ``VectorTCSC`` (``VectorTCSC.h:5-73``) with its
over-padding and its ``X[-1]`` sentinel fixed: columns in tiles of
``tile_n``, each sign's capacity the largest nonzero count of a column
within the tile rounded up to ``cap_align``; the index planes are
rectangular ``(CAP, N_pad)`` int32 whose empty slots hold the sentinel
``K`` (the formulation appends one zero column to X), and the per-tile
capacities ``tile_cap_pos/neg`` are kept for the byte count. Every array is
the JAX package's, byte for byte.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)
from ternary_spgemm_tpu_torch.utils import cdiv, round_up


def _cdiv_t(a: torch.Tensor, b: int) -> torch.Tensor:
    """Ceiling division of a non-negative integer tensor."""
    return (a + b - 1) // b


def _ell_plane(W: torch.Tensor, value: int, tile_n: int, cap_align: int):
    """(idx_plane (CAP, N_pad) int32 with sentinel K, tile_caps (T,) int32):
    slot s of column n holds the row of the s-th entry of n equal to
    ``value``."""
    K, N = W.shape
    N_pad = round_up(N, tile_n)
    mask = W == value
    counts = torch.zeros(N_pad, dtype=torch.int64, device=W.device)
    counts[:N] = mask.sum(dim=0)
    tile_max = counts.view(-1, tile_n).amax(dim=1)
    tile_caps = (_cdiv_t(tile_max, cap_align) * cap_align).to(torch.int32)
    cap = int(tile_caps.max()) if len(tile_caps) else 0
    cap = max(cap, cap_align)      # a non-empty plane, for shape stability
    idx = torch.full((cap, N_pad), K, dtype=torch.int32, device=W.device)
    slots = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    k_idx, n_idx = torch.nonzero(mask, as_tuple=True)
    idx[slots[k_idx, n_idx].long(), n_idx] = k_idx.to(torch.int32)
    return idx, tile_caps


@register_format
class EllTCSC(TernaryFormat):
    """Padded split-sign ELL (``VectorTCSC.h`` re-designed; module doc)."""

    ARRAY_FIELDS = ("idx_pos", "idx_neg", "tile_cap_pos", "tile_cap_neg")

    idx_pos: torch.Tensor       # (CAP_pos, N_pad) int32, sentinel = K
    idx_neg: torch.Tensor       # (CAP_neg, N_pad) int32, sentinel = K
    tile_cap_pos: torch.Tensor  # (num_tiles,) int32
    tile_cap_neg: torch.Tensor  # (num_tiles,) int32
    K: int
    N: int
    tile_n: int
    cap_align: int

    @classmethod
    def from_dense(cls, W, tile_n: int = 128, cap_align: int = 8, *,
                   device=None) -> "EllTCSC":
        """Build from a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own)."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        ip, cp = _ell_plane(W, 1, tile_n, cap_align)
        im, cm = _ell_plane(W, -1, tile_n, cap_align)
        return cls(idx_pos=ip, idx_neg=im, tile_cap_pos=cp, tile_cap_neg=cm,
                   K=K, N=N, tile_n=tile_n, cap_align=cap_align)

    @property
    def num_tiles(self) -> int:
        return cdiv(self.N, self.tile_n)

    def to_dense(self) -> torch.Tensor:
        dev = self.idx_pos.device
        W = torch.zeros((self.K + 1, self.N), dtype=torch.int8, device=dev)
        cols = torch.arange(self.N, device=dev)
        for idx, sign in ((self.idx_pos, 1), (self.idx_neg, -1)):
            W[idx[:, :self.N].long(), cols[None, :].expand(idx.shape[0], -1)] \
                = sign
        return W[:self.K]            # the sentinel row K dropped

    def size_bytes(self) -> int:
        # per-tile capacities (what a tile-bounded kernel reads), not the
        # global rectangle
        per_tile = (self.tile_cap_pos.to(torch.int64)
                    + self.tile_cap_neg.to(torch.int64))
        return int(4 * (int(per_tile.sum()) * self.tile_n
                        + 2 * self.num_tiles))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.idx_pos != self.K).sum()
                   + (self.idx_neg != self.K).sum())
