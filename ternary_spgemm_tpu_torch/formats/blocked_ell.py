"""Blocked-ELL split-sign container — counterpart of
``ternary_spgemm_tpu/formats/blocked_ell.py``.

K is cut into blocks of ``block_k <= 128`` rows, and each (K-block, column)
stores the local row offsets of its nonzeros, one plane a sign:

* ``idx_pos`` / ``idx_neg`` — ``(nb, CAP, N_pad)`` int8, local offsets in
  ``[0, block_k)``, sentinel ``-1``; ``N_pad = round_up(N, tile_n)``;
* ``CAP`` is the largest per-(block, N-tile) count of the sign, rounded up
  to ``cap_align`` slots, and at least ``cap_align``;
* ``tile_cap_pos/neg`` — ``(nb, N_pad / tile_n)`` int32 per-(block, N-tile)
  counts, rounded up to ``cap_align``: a loop bound (slots past a column's
  own count hold the sentinel).

``size_bytes`` is the JAX package's honest per-tile sum (one byte a slot of
the tile caps, plus the cap tables), not the physical size of the planes.
The arrays are identical to the JAX packer's for the same matrix and
arguments; the packer is vectorised torch and runs on its input's device.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)
from ternary_spgemm_tpu_torch.utils import cdiv, round_up


def padded_mask(W: torch.Tensor, value: int, rows: int,
                cols: int) -> torch.Tensor:
    """``W == value`` zero-padded to a ``(rows, cols)`` bool mask."""
    K, N = W.shape
    mask = torch.zeros((rows, cols), dtype=torch.bool, device=W.device)
    mask[:K, :N] = W == value
    return mask


def ell_slots(mask: torch.Tensor, cap: int, sentinel: int) -> torch.Tensor:
    """ELL slots of a ``(..., R, C)`` bool mask: ``(..., cap, C)`` int8 whose
    slot ``s`` of column ``c`` holds the offset (< R) of the s-th True entry
    down axis -2, and ``sentinel`` past the column's count."""
    slot = mask.cumsum(-2, dtype=torch.int32) - 1
    idx = torch.full((*mask.shape[:-2], cap, mask.shape[-1]), sentinel,
                     dtype=torch.int8, device=mask.device)
    nz = torch.nonzero(mask, as_tuple=True)
    idx[(*nz[:-2], slot[nz].long(), nz[-1])] = nz[-2].to(torch.int8)
    return idx


def _blocked_planes(W: torch.Tensor, value: int, block_k: int, tile_n: int,
                    cap_align: int):
    K, N = W.shape
    nb = cdiv(K, block_k)
    N_pad = round_up(N, tile_n)
    num_tiles = N_pad // tile_n
    m3 = padded_mask(W, value, nb * block_k, N_pad).view(nb, block_k, N_pad)
    counts = m3.sum(dim=1, dtype=torch.int32)              # (nb, N_pad)
    tile_caps = counts.view(nb, num_tiles, tile_n).amax(dim=2)
    tile_caps = (torch.div(tile_caps + cap_align - 1, cap_align,
                           rounding_mode="floor") * cap_align)
    cap = max(int(tile_caps.max()) if tile_caps.numel() else 0, cap_align)
    return ell_slots(m3, cap, -1), tile_caps.to(torch.int32)


@register_format
class BlockedEllTCSC(TernaryFormat):
    """Per-K-block local-offset ELL planes (see module docstring)."""

    ARRAY_FIELDS = ("idx_pos", "idx_neg", "tile_cap_pos", "tile_cap_neg")

    idx_pos: torch.Tensor       # (nb, CAP_p, N_pad) int8, local, sentinel -1
    idx_neg: torch.Tensor       # (nb, CAP_n, N_pad) int8
    tile_cap_pos: torch.Tensor  # (nb, num_tiles) int32
    tile_cap_neg: torch.Tensor  # (nb, num_tiles) int32
    K: int
    N: int
    block_k: int
    tile_n: int
    cap_align: int

    @classmethod
    def from_dense(cls, W, block_k: int = 128, tile_n: int = 128,
                   cap_align: int = 8, *, device=None) -> "BlockedEllTCSC":
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own)."""
        if not 0 < block_k <= 128:
            raise ValueError(
                f"block_k={block_k}: local offsets must fit int8 (at most "
                "128 rows a block)")
        W = _as_int8_dense(W, device)
        K, N = W.shape
        ip, cp = _blocked_planes(W, 1, block_k, tile_n, cap_align)
        im, cm = _blocked_planes(W, -1, block_k, tile_n, cap_align)
        return cls(idx_pos=ip, idx_neg=im, tile_cap_pos=cp, tile_cap_neg=cm,
                   K=K, N=N, block_k=block_k, tile_n=tile_n,
                   cap_align=cap_align)

    @property
    def num_blocks(self) -> int:
        return cdiv(self.K, self.block_k)

    @property
    def num_tiles(self) -> int:
        return cdiv(self.N, self.tile_n)

    def to_dense(self) -> torch.Tensor:
        W = torch.zeros((self.num_blocks * self.block_k, self.N),
                        dtype=torch.int8, device=self.device)
        for plane, v in ((self.idx_pos, 1), (self.idx_neg, -1)):
            rows = plane[:, :, :self.N]
            b, _, c = nz = torch.nonzero(rows >= 0, as_tuple=True)
            W[b * self.block_k + rows[nz].long(), c] = v
        return W[:self.K]

    def size_bytes(self) -> int:
        per = self.tile_cap_pos.long() + self.tile_cap_neg.long()
        return int(per.sum()) * self.tile_n + 4 * 2 * self.tile_cap_pos.numel()

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.idx_pos >= 0).sum() + (self.idx_neg >= 0).sum())
