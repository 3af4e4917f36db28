"""Tile-contiguous split-sign bitplane container — 2 bits/weight.

Counterpart of ``ternary_spgemm_tpu/formats/bitplane.py::TiledBitplane``.
The container bytes are the contract between the two packages: ``plane``
``(nb, gn, 2*tkb, tile_n)`` uint8 and ``wsum`` ``(nb, gn, 1, tile_n)`` int32
are byte-identical to the JAX packer's for the same matrix and the same
``tkb``/``tile_n`` defaults.

Layout: the K axis is cut into blocks of ``B = 8*tkb`` dense rows and the N
axis into storage tiles of ``tile_n`` columns. Within a block, byte-row
``t`` of the pos plane (rows ``[0, tkb)``) holds in bit ``j`` the +1 flag of
one dense row, and the neg plane (rows ``[tkb, 2*tkb)``) the -1 flag; the
dense row of (t, j) is :func:`bitplane_rowmap` — ``4t + j`` for ``j < 4``
and ``4*tkb + 4t + (j - 4)`` for ``j >= 4`` (the byte order of the TPU's
int32 -> int8 bitcast, which the CUDA kernels decode directly). ``wsum``
holds per-(block, tile) column sums; the CUDA kernels do not read it, but it
stays part of the byte contract.

:meth:`TiledBitplane.from_dense` is a vectorised torch packer that runs on
whatever device its input lies on — at 7B width the serving build packs on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)
from ternary_spgemm_tpu_torch.utils import round_up


def bitplane_rowmap(tkb: int):
    """Dense-row -> (byte-row, bit) mapping (numpy int64 arrays ``rt``, ``rj``).

    Decoded row r of a block of B = 8*tkb dense rows comes from:
      r <  4*tkb: byte-row t = r//4, bit j = r%4
      r >= 4*tkb: t = (r-4*tkb)//4, j = (r-4*tkb)%4+4
    """
    rt = np.empty(8 * tkb, np.int64)
    rj = np.empty(8 * tkb, np.int64)
    r = np.arange(8 * tkb)
    lo = r < 4 * tkb
    rt[lo] = r[lo] // 4
    rj[lo] = r[lo] % 4
    rh = r[~lo] - 4 * tkb
    rt[~lo] = rh // 4
    rj[~lo] = rh % 4 + 4
    return rt, rj


def decode_planes(plane: torch.Tensor, tkb: int) -> torch.Tensor:
    """``plane (nb, gn, 2*tkb, tn)`` uint8 -> padded dense ``(nb*8*tkb,
    gn*tn)`` int8, by :func:`bitplane_rowmap`: bit ``4h + jj`` of byte-row
    ``t`` is dense row ``h*4*tkb + 4t + jj`` of its block."""
    nb, gn, _, tn = plane.shape
    shifts = torch.arange(8, device=plane.device, dtype=torch.uint8)

    def bits(p):                                   # (nb, gn, tkb, tn)
        b = (p[:, :, :, None, :] >> shifts[:, None]) & 1   # (nb,gn,tkb,8,tn)
        b = b.view(nb, gn, tkb, 2, 4, tn).permute(0, 1, 3, 2, 4, 5)
        return b.reshape(nb, gn, 8 * tkb, tn).to(torch.int8)

    W = bits(plane[:, :, :tkb]) - bits(plane[:, :, tkb:])
    return W.permute(0, 2, 1, 3).reshape(nb * 8 * tkb, gn * tn)


@register_format
class TiledBitplane(TernaryFormat):
    """Tile-contiguous pos/neg bitplanes + per-tile column sums."""

    ARRAY_FIELDS = ("plane", "wsum")

    plane: torch.Tensor   # (nb, gn, 2*tkb, tile_n) uint8: pos rows then neg rows
    wsum: torch.Tensor    # (nb, gn, 1, tile_n) int32 per-(block, tile) col sums
    K: int
    N: int
    tkb: int              # byte-rows per block; block covers 8*tkb dense rows
    tile_n: int

    @classmethod
    def from_dense(cls, W, tkb: int = None, tile_n: int = 4096, *,
                   device=None) -> "TiledBitplane":
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; packed on
        ``device``, default the tensor's own) with the JAX packer's
        defaults: ``tkb = min(128, max(16, round_up(K, 128) // 8))`` and
        ``tile_n = min(tile_n, round_up(N, 128))``."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        if tkb is None:
            tkb = min(128, max(16, round_up(K, 128) // 8))
        B = 8 * tkb
        tile_n = min(tile_n, round_up(N, 128))
        Kp, Np = round_up(K, B), round_up(N, tile_n)
        nb, gn = Kp // B, Np // tile_n
        Wp = torch.zeros((Kp, Np), dtype=torch.int8, device=W.device)
        Wp[:K, :N] = W
        # row h*4*tkb + 4t + jj of a block -> bit 4h + jj of byte-row t
        Wb = Wp.view(nb, 2, tkb, 4, gn, tile_n)
        pos = torch.zeros((nb, tkb, gn, tile_n), dtype=torch.uint8,
                          device=W.device)
        neg = torch.zeros_like(pos)
        for h in range(2):
            for jj in range(4):
                rows = Wb[:, h, :, jj]                     # (nb, tkb, gn, tn)
                pos |= (rows == 1).to(torch.uint8) << (4 * h + jj)
                neg |= (rows == -1).to(torch.uint8) << (4 * h + jj)
        plane = torch.cat([pos, neg], dim=1).permute(0, 2, 1, 3).contiguous()
        wsum = Wp.view(nb, B, gn, tile_n).sum(dim=1, dtype=torch.int32)
        return cls(plane=plane, wsum=wsum.reshape(nb, gn, 1, tile_n), K=K,
                   N=N, tkb=tkb, tile_n=tile_n)

    @property
    def num_blocks(self) -> int:
        return self.plane.shape[0]

    def to_dense(self) -> torch.Tensor:
        return decode_planes(self.plane, self.tkb)[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.plane.numel() + 4 * self.wsum.numel())

    @property
    def shape(self):
        return (self.K, self.N)
