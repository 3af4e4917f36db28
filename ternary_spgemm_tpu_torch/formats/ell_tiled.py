"""Tile-contiguous blocked-ELL container — counterpart of
``ternary_spgemm_tpu/formats/ell_tiled.py``.

* K is cut into blocks of ``block_k <= 127`` rows (default 127) and N into
  tiles of ``tile_n`` columns (a multiple of 128, default 512);
* ``plane`` is ``(nb, gn, CAPS, tile_n)`` int8, each (K-block, N-tile) slab
  contiguous: rows ``[0, cap_p_max)`` hold the local row offsets of the +1
  entries, slot by slot, rows ``[cap_p_max, CAPS)`` those of the -1 entries;
  each sign section is rounded up to 8 slot rows, and a slot past a
  column's count holds the sentinel ``block_k`` — an offset one past the
  block, which a kernel points at a zero;
* ``cap_pos`` / ``cap_neg`` are ``(nb, gn)`` int32, the exact largest count
  of the sign in each (block, tile): a loop bound.

``size_bytes`` is the physical size: the padded plane plus the cap tables.
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
from ternary_spgemm_tpu_torch.formats.blocked_ell import ell_slots, padded_mask
from ternary_spgemm_tpu_torch.utils import cdiv, round_up


@register_format
class TiledEllTCSC(TernaryFormat):
    """Tile-contiguous split-sign ELL with exact per-tile capacities."""

    ARRAY_FIELDS = ("plane", "cap_pos", "cap_neg")

    plane: torch.Tensor    # (nb, gn, CAPS, tile_n) int8; sentinel = block_k
    cap_pos: torch.Tensor  # (nb, gn) int32 exact per-(block, tile) capacity
    cap_neg: torch.Tensor  # (nb, gn) int32
    K: int
    N: int
    block_k: int
    tile_n: int
    cap_p_max: int         # the row where the neg section starts

    @classmethod
    def from_dense(cls, W, block_k: int = 127, tile_n: int = 512, *,
                   device=None) -> "TiledEllTCSC":
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own); ``tile_n = min(tile_n,
        round_up(N, 128))``."""
        if not 0 < block_k <= 127:
            raise ValueError(
                f"block_k={block_k}: the local offsets and the sentinel "
                "block_k must fit 128 entries")
        W = _as_int8_dense(W, device)
        K, N = W.shape
        nb = cdiv(K, block_k)
        tile_n = min(tile_n, round_up(N, 128))
        if tile_n % 128:
            raise ValueError(f"tile_n={tile_n} must be a multiple of 128")
        Np = round_up(N, tile_n)
        gn = Np // tile_n

        def planes(value):
            m3 = padded_mask(W, value, nb * block_k, Np).view(nb, block_k, Np)
            counts = m3.sum(dim=1, dtype=torch.int32)             # (nb, Np)
            caps = counts.view(nb, gn, tile_n).amax(dim=2)         # (nb, gn)
            cap = max(round_up(int(caps.max()), 8), 8)
            return ell_slots(m3, cap, block_k), caps

        ip, cp = planes(1)
        im, cm = planes(-1)
        both = torch.cat([ip, im], dim=1)                     # (nb, CAPS, Np)
        plane = both.view(nb, both.shape[1], gn, tile_n).permute(0, 2, 1, 3)
        return cls(plane=plane.contiguous(), cap_pos=cp, cap_neg=cm, K=K, N=N,
                   block_k=block_k, tile_n=tile_n, cap_p_max=ip.shape[1])

    @property
    def num_blocks(self) -> int:
        return self.plane.shape[0]

    @property
    def num_tiles(self) -> int:
        return self.plane.shape[1]

    @property
    def cap_n_max(self) -> int:
        return self.plane.shape[2] - self.cap_p_max

    def to_dense(self) -> torch.Tensor:
        nb, gn, CAPS, TN = self.plane.shape
        flat = self.plane.permute(0, 2, 1, 3).reshape(nb, CAPS, gn * TN)
        W = torch.zeros((nb * self.block_k, gn * TN), dtype=torch.int8,
                        device=self.device)
        for lo, hi, v in ((0, self.cap_p_max, 1), (self.cap_p_max, CAPS, -1)):
            rows = flat[:, lo:hi]
            b, _, c = nz = torch.nonzero(rows < self.block_k, as_tuple=True)
            W[b * self.block_k + rows[nz].long(), c] = v
        return W[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.plane.numel()
                   + 4 * (self.cap_pos.numel() + self.cap_neg.numel()))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.plane < self.block_k).sum())
