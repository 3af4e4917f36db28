"""Tile-contiguous int8 ternary plane — counterpart of
``ternary_spgemm_tpu/formats/tiled.py::TiledDenseTernary``.

The plane is stored pre-tiled as a 4-D ``(grid_k, grid_n, tile_k, tile_n)``
int8 array, every (K-tile, N-tile) block contiguous; the ``tiles`` bytes are
identical to the JAX packer's for the same matrix and tile sizes.
``TiledBlockPacked`` is not ported yet.
"""

from __future__ import annotations

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
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
