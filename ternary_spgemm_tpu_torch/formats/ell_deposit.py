"""Bit-deposit ELL container — counterpart of
``ternary_spgemm_tpu/formats/ell_deposit.py::TiledEllDeposit``.

* A **superblock** covers ``SB_ROWS = 8 * 31 = 248`` dense rows: 8 words of
  31 rows each; word ``w`` of superblock ``sb`` holds dense rows ``sb*248 +
  w*31 + o``, ``o < 31``, and the offset 31 is the **sentinel** of a slot
  past the column's count;
* ``plane[sb, g, 8*s + w, n]`` (int8, ``(nsb, gn, 8*CAPS, tile_n)``) is the
  offset of the ``s``-th nonzero of word ``w`` in column ``g*tile_n + n``:
  slot rows ``[0, 8*cap_p_max)`` hold the +1 entries, the rest the -1
  entries;
* ``cap_pos`` / ``cap_neg`` are ``(nsb, gn)`` int32, the exact largest slot
  count of a word in each (superblock, tile), a loop bound; ``cap_p_max``
  (at least 1) is the size of the pos section in slots;
* ``wsum`` is ``(nsb, gn, 1, tile_n)`` int32, the per-column sums of the
  weights of each superblock (read by the TPU kernel's int8-split
  epilogue; kept because the container bytes are the contract).

The TPU decode chain's row permutation (``deposit_rowmap``,
``activation_row_order`` there) is not part of the container bytes and is
not ported. The arrays are identical to the JAX packer's for the same
matrix and ``tile_n``; the packer is vectorised torch and runs on its
input's device.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)
from ternary_spgemm_tpu_torch.formats.blocked_ell import ell_slots, padded_mask
from ternary_spgemm_tpu_torch.utils import cdiv, round_up

#: Dense rows addressed by one word (offset 31 = sentinel).
WORD_ROWS = 31
#: Words per superblock.
WORDS = 8
#: Dense rows per superblock.
SB_ROWS = WORDS * WORD_ROWS


@register_format
class TiledEllDeposit(TernaryFormat):
    """Bit-deposit ELL: int8 offset slots, per-tile caps (module docstring)."""

    ARRAY_FIELDS = ("plane", "cap_pos", "cap_neg", "wsum")

    plane: torch.Tensor    # (nsb, gn, 8*CAPS, tile_n) int8; sentinel = 31
    cap_pos: torch.Tensor  # (nsb, gn) int32 exact slot counts
    cap_neg: torch.Tensor  # (nsb, gn) int32
    wsum: torch.Tensor     # (nsb, gn, 1, tile_n) int32 column weight sums
    K: int
    N: int
    tile_n: int
    cap_p_max: int         # the slot where the neg section starts

    @classmethod
    def from_dense(cls, W, tile_n: int = 4096, *,
                   device=None) -> "TiledEllDeposit":
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own); ``tile_n = min(tile_n,
        round_up(N, 128))``."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        nsb = cdiv(K, SB_ROWS)
        tile_n = min(tile_n, round_up(N, 128))
        if tile_n % 128:
            raise ValueError(f"tile_n={tile_n} must be a multiple of 128")
        Np = round_up(N, tile_n)
        gn = Np // tile_n

        def planes(value):
            m4 = padded_mask(W, value, nsb * SB_ROWS, Np).view(
                nsb, WORDS, WORD_ROWS, Np)
            counts = m4.sum(dim=2, dtype=torch.int32)          # (nsb, 8, Np)
            caps = counts.view(nsb, WORDS, gn, tile_n).amax(dim=(1, 3))
            cap = max(int(caps.max()), 1)
            idx = ell_slots(m4, cap, WORD_ROWS)           # (nsb, 8, cap, Np)
            return idx.permute(0, 2, 1, 3).reshape(nsb, cap * WORDS, Np), caps

        ip, cp = planes(1)
        im, cm = planes(-1)
        both = torch.cat([ip, im], dim=1)                       # (nsb, R, Np)
        plane = both.view(nsb, both.shape[1], gn, tile_n).permute(0, 2, 1, 3)
        Wp = torch.zeros((nsb * SB_ROWS, Np), dtype=torch.int8,
                         device=W.device)
        Wp[:K, :N] = W
        wsum = Wp.view(nsb, SB_ROWS, gn, tile_n).sum(dim=1, dtype=torch.int32)
        return cls(plane=plane.contiguous(), cap_pos=cp, cap_neg=cm,
                   wsum=wsum.view(nsb, gn, 1, tile_n), K=K, N=N,
                   tile_n=tile_n, cap_p_max=ip.shape[1] // WORDS)

    @property
    def num_superblocks(self) -> int:
        return self.plane.shape[0]

    @property
    def cap_n_max(self) -> int:
        return self.plane.shape[2] // WORDS - self.cap_p_max

    def to_dense(self) -> torch.Tensor:
        nsb, gn, R, TN = self.plane.shape
        flat = self.plane.permute(0, 2, 1, 3).reshape(nsb, R, gn * TN)
        W = torch.zeros((nsb * SB_ROWS, gn * TN), dtype=torch.int8,
                        device=self.device)
        split = WORDS * self.cap_p_max
        for lo, hi, v in ((0, split, 1), (split, R, -1)):
            rows = flat[:, lo:hi]
            sb, s, c = nz = torch.nonzero(rows < WORD_ROWS, as_tuple=True)
            w = (lo + s) % WORDS
            W[sb * SB_ROWS + w * WORD_ROWS + rows[nz].long(), c] = v
        return W[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.plane.numel()
                   + 4 * (self.cap_pos.numel() + self.cap_neg.numel()
                          + self.wsum.numel()))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.plane < WORD_ROWS).sum())
