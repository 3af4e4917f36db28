"""Tile-contiguous ternary layouts — counterpart of
``ternary_spgemm_tpu/formats/tiled.py``.

Both containers store their planes pre-tiled as 4-D arrays whose every
(K-tile, N-tile) block is contiguous; the ``tiles`` bytes are identical to
the JAX packers' for the same matrix and arguments:

* :class:`TiledDenseTernary` — ``(grid_k, grid_n, tile_k, tile_n)`` int8,
  one weight a byte;
* :class:`TiledBlockPacked` — ``(nb, gn, tile_kq, tile_n)`` uint8, the
  block-local 2-bit or base-3 codes of ``BlockPackedTernary``
  (``formats/packed.py``) with the stride block ``B = factor * tile_kq``
  as the K-tile.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)
from ternary_spgemm_tpu_torch.formats.packed import (
    decode_fields,
    encode_fields,
)
from ternary_spgemm_tpu_torch.utils import round_up


def _tile4(plane: torch.Tensor, tk: int, tn: int) -> torch.Tensor:
    """(R, C) -> contiguous (R/tk, C/tn, tk, tn), zero-padding to multiples."""
    R, C = plane.shape
    Rp, Cp = round_up(R, tk), round_up(C, tn)
    if (Rp, Cp) != (R, C):
        p = torch.zeros((Rp, Cp), dtype=plane.dtype, device=plane.device)
        p[:R, :C] = plane
        plane = p
    return plane.reshape(Rp // tk, tk, Cp // tn, tn).permute(0, 2, 1, 3) \
        .contiguous()


def _untile4(t4: torch.Tensor) -> torch.Tensor:
    gk, gn, tk, tn = t4.shape
    return t4.permute(0, 2, 1, 3).reshape(gk * tk, gn * tn)


@register_format
class TiledDenseTernary(TernaryFormat):
    """Tile-contiguous int8 ternary plane, 8 bits/weight."""

    ARRAY_FIELDS = ("tiles",)

    tiles: torch.Tensor  # (gk, gn, tile_k, tile_n) int8
    K: int
    N: int
    tile_k: int
    tile_n: int

    @classmethod
    def from_dense(cls, W, tile_k: int = 256, tile_n: int = 4096, *,
                   device=None) -> "TiledDenseTernary":
        """Tile a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own) with the JAX defaults
        ``tile_k = min(tile_k, round_up(K, 32))`` and ``tile_n =
        min(tile_n, round_up(N, 128))``."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        tile_n = min(tile_n, round_up(N, 128))
        tile_k = min(tile_k, round_up(K, 32))
        return cls(tiles=_tile4(W, tile_k, tile_n), K=K, N=N,
                   tile_k=tile_k, tile_n=tile_n)

    def to_dense(self) -> torch.Tensor:
        return _untile4(self.tiles)[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.tiles.numel())

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class TiledBlockPacked(TernaryFormat):
    """Tile-contiguous block-local packed codes: packed tile ``(b, j)``
    holds, at packed row ``kq``, the codes of dense rows ``b*factor*tile_kq
    + f*tile_kq + kq`` for fields ``f < factor``."""

    ARRAY_FIELDS = ("tiles",)

    tiles: torch.Tensor  # (nb, gn, tile_kq, tile_n) uint8
    K: int
    N: int
    factor: int
    tile_kq: int
    tile_n: int

    @classmethod
    def from_dense(cls, W, factor: int = 4, tile_kq: int = 256,
                   tile_n: int = 4096, *, device=None) -> "TiledBlockPacked":
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own) with the JAX defaults; K pads
        to a multiple of ``factor * tile_kq``, N to one of ``tile_n =
        min(tile_n, round_up(N, 128))``."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        tile_n = min(tile_n, round_up(N, 128))
        B = factor * tile_kq
        Kp, Np = round_up(K, B), round_up(N, tile_n)
        Wp = torch.zeros((Kp, Np), dtype=torch.int8, device=W.device)
        Wp[:K, :N] = W
        nb, gn = Kp // B, Np // tile_n
        packed = encode_fields(Wp.view(nb, factor, tile_kq, gn, tile_n),
                               factor)                 # (nb, tkq, gn, tn)
        return cls(tiles=packed.permute(0, 2, 1, 3).contiguous(), K=K, N=N,
                   factor=factor, tile_kq=tile_kq, tile_n=tile_n)

    @property
    def num_blocks(self) -> int:
        return self.tiles.shape[0]

    def to_dense(self) -> torch.Tensor:
        nb, gn, tkq, tn = self.tiles.shape
        p = self.tiles.permute(0, 2, 1, 3).reshape(nb, tkq, gn * tn)
        out = torch.stack(decode_fields(p, self.factor), dim=1)
        return out.reshape(nb * self.factor * tkq, gn * tn)[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.tiles.numel())

    @property
    def shape(self):
        return (self.K, self.N)
