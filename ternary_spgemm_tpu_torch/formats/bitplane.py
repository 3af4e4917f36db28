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

:class:`TiledNibblePair` is the 4-bit sibling (the JAX package's
``TiledNibblePair``): the same blocks and tiles, eight weights per int32 word
as two's-complement nibbles; its ``words`` and ``wsum`` are byte-identical
to the JAX packer's too.
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


def _blocks(W: torch.Tensor, tkb, tile_n: int):
    """Zero-pad int8 ``W (K, N)`` to whole blocks and tiles with the JAX
    packers' defaults (``tkb = min(128, max(16, round_up(K, 128) // 8))``,
    ``tile_n = min(tile_n, round_up(N, 128))``) -> ``(Wb (nb, 8*tkb, gn,
    tile_n), tkb, tile_n)``."""
    K, N = W.shape
    if tkb is None:
        tkb = min(128, max(16, round_up(K, 128) // 8))
    B = 8 * tkb
    tile_n = min(tile_n, round_up(N, 128))
    Kp, Np = round_up(K, B), round_up(N, tile_n)
    Wp = torch.zeros((Kp, Np), dtype=torch.int8, device=W.device)
    Wp[:K, :N] = W
    return Wp.view(Kp // B, B, Np // tile_n, tile_n), tkb, tile_n


def _block_wsum(Wb: torch.Tensor) -> torch.Tensor:
    """Per-(block, tile) column sums ``(nb, gn, 1, tile_n)`` int32."""
    nb, _, gn, tile_n = Wb.shape
    return Wb.sum(dim=1, dtype=torch.int32).reshape(nb, gn, 1, tile_n)


def decode_nibbles(words: torch.Tensor) -> torch.Tensor:
    """``words (nb, gn, tkb, tn)`` int32 -> padded dense ``(nb*8*tkb,
    gn*tn)`` int8: little-endian byte ``b`` of word row ``t`` holds dense
    row ``4t + b`` of its block in the low nibble and ``4*tkb + 4t + b`` in
    the high nibble, sign-extended with ``((v + 8) & 0xF) - 8``."""
    nb, gn, tkb, tn = words.shape
    u8 = words.contiguous().view(torch.uint8).view(nb, gn, tkb, tn, 4)
    nib = u8.permute(0, 2, 4, 1, 3).reshape(nb, 4 * tkb, gn * tn)

    def sx(v):
        return (((v.to(torch.int16) + 8) & 0xF) - 8).to(torch.int8)

    W = torch.cat([sx(nib & 0xF), sx(nib >> 4)], dim=1)
    return W.reshape(nb * 8 * tkb, gn * tn)


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
        Wb, tkb, tile_n = _blocks(W, tkb, tile_n)
        nb, _, gn, _ = Wb.shape
        # row h*4*tkb + 4t + jj of a block -> bit 4h + jj of byte-row t
        Wb6 = Wb.view(nb, 2, tkb, 4, gn, tile_n)
        pos = torch.zeros((nb, tkb, gn, tile_n), dtype=torch.uint8,
                          device=W.device)
        neg = torch.zeros_like(pos)
        for h in range(2):
            for jj in range(4):
                rows = Wb6[:, h, :, jj]                    # (nb, tkb, gn, tn)
                pos |= (rows == 1).to(torch.uint8) << (4 * h + jj)
                neg |= (rows == -1).to(torch.uint8) << (4 * h + jj)
        plane = torch.cat([pos, neg], dim=1).permute(0, 2, 1, 3).contiguous()
        return cls(plane=plane, wsum=_block_wsum(Wb), K=K, N=N, tkb=tkb,
                   tile_n=tile_n)

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


@register_format
class TiledNibblePair(TernaryFormat):
    """Tile-contiguous signed-nibble words — 4 bits/weight.

    Each int32 word holds 8 weights as 4-bit two's-complement nibbles
    (+1 -> 0x1, -1 -> 0xF, 0 -> 0x0). Decoded row r of a B = 8*tkb block
    comes from word row ``(r mod 4*tkb) // 4``, little-endian byte
    ``r % 4``: the LOW nibble for r < 4*tkb, the HIGH nibble above — the
    row order of :func:`bitplane_rowmap`, with nibbles for bits.
    """

    ARRAY_FIELDS = ("words", "wsum")

    words: torch.Tensor   # (nb, gn, tkb, tile_n) int32 nibble-pair words
    wsum: torch.Tensor    # (nb, gn, 1, tile_n) int32 per-(block, tile) col sums
    K: int
    N: int
    tkb: int              # word-rows per block; block covers 8*tkb dense rows
    tile_n: int

    @classmethod
    def from_dense(cls, W, tkb: int = None, tile_n: int = 4096, *,
                   device=None) -> "TiledNibblePair":
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; packed on
        ``device``, default the tensor's own) with the JAX packer's
        defaults."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        Wb, tkb, tile_n = _blocks(W, tkb, tile_n)
        nb, _, gn, _ = Wb.shape
        H = 4 * tkb
        codes = (Wb & 0xF).to(torch.uint8)           # -1 -> 0xF
        nib = codes[:, :H] | (codes[:, H:] << 4)       # (nb, H, gn, tn)
        # word row t, byte b <- nibble row 4t + b (little-endian)
        words = (nib.view(nb, tkb, 4, gn, tile_n).permute(0, 3, 1, 4, 2)
                 .contiguous().view(torch.int32).reshape(nb, gn, tkb, tile_n))
        return cls(words=words, wsum=_block_wsum(Wb), K=K, N=N, tkb=tkb,
                   tile_n=tile_n)

    @property
    def num_blocks(self) -> int:
        return self.words.shape[0]

    def to_dense(self) -> torch.Tensor:
        return decode_nibbles(self.words)[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(4 * self.words.numel() + 4 * self.wsum.numel())

    @property
    def shape(self):
        return (self.K, self.N)
