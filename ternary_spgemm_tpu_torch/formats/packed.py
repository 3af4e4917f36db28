"""Dense, stride-packed and block-packed ternary containers — counterpart
of ``ternary_spgemm_tpu/formats/packed.py`` (``DenseTernary``,
``PackedTernary2Bit``, ``PackedTernary53``, ``BlockPackedTernary``, the
codecs, ``_pad_k`` and ``_POW3``).

Codes are chosen so the all-zero byte decodes to weight 0, making
zero-padding of K free:

* 2-bit (``factor=4``): ``code = w & 3`` -> {0: 0, +1: 1, -1: 3}; decode
  ``w = (c & 1) - (c & 2)``;
* base-3 digit (``factor=5``): {0: 0, +1: 1, -1: 2}, five digits a byte
  weighted by ``_POW3``; decode ``w = d - 3*(d >> 1)``.

:class:`PackedTernary2Bit` (``FACTOR = 4``) and :class:`PackedTernary53`
(``FACTOR = 5``) use the global stride: K pads to a multiple of ``F``, and
field ``j`` of packed row ``k'`` holds dense row ``j*Kq + k'``, ``Kq =
K_pad / F``. :class:`BlockPackedTernary` applies the stride within blocks
of ``B = factor * tile_kq`` dense rows: packed row ``blk*tile_kq + kq``
holds, in field ``f``, the weight of dense row ``blk*B + f*tile_kq + kq``.
The global stride is thus the block layout with one block of ``tile_kq =
Kq``. Every container's bytes are identical to the JAX packer's for the
same matrix and arguments. ``PackedCSC`` is not ported yet.

The packers are vectorised torch and run on whatever device their input
lies on.
"""

from __future__ import annotations

from typing import ClassVar, List

import torch

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    _as_int8_dense,
    register_format,
)
from ternary_spgemm_tpu_torch.utils import round_up

#: base-3 digit weights of the five fields of a byte
_POW3 = (1, 3, 9, 27, 81)


def _pad_k(W: torch.Tensor, factor: int) -> torch.Tensor:
    """Zero-pad the rows of ``W (K, N)`` to a multiple of ``factor``."""
    K, N = W.shape
    K_pad = round_up(K, factor)
    if K_pad != K:
        W = torch.cat([W, torch.zeros((K_pad - K, N), dtype=W.dtype,
                                      device=W.device)], dim=0)
    return W


def encode_fields(fields: torch.Tensor, factor: int) -> torch.Tensor:
    """Pack int8 ternary ``fields (nb, factor, ...)`` into uint8 bytes
    ``(nb, ...)``: field ``j`` in bits ``2j, 2j+1`` (``factor=4``) or in
    base-3 digit ``j`` (``factor=5``)."""
    check_factor(factor)
    if factor == 4:
        codes = (fields & 3).to(torch.int16)          # -1 -> 3
        acc = sum(codes[:, j] << (2 * j) for j in range(4))
    else:
        digits = torch.where(fields < 0, 2, fields).to(torch.int16)
        acc = sum(digits[:, j] * _POW3[j] for j in range(5))
    return acc.to(torch.uint8)


def decode_fields(packed: torch.Tensor, factor: int) -> List[torch.Tensor]:
    """The ``factor`` int8 weight fields of uint8 ``packed`` bytes, each
    the shape of ``packed`` (inverse of :func:`encode_fields`)."""
    p = packed.to(torch.int16)
    out = []
    for j in range(factor):
        if factor == 4:
            c = (p >> (2 * j)) & 3
            w = (c & 1) - (c & 2)
        else:
            d = (p // _POW3[j]) % 3
            w = d - 3 * (d >> 1)
        out.append(w.to(torch.int8))
    return out


def check_factor(factor: int) -> None:
    if factor not in (4, 5):
        raise ValueError(f"factor must be 4 (2-bit) or 5 (base-3), got "
                         f"{factor}")


@register_format
class _StridePacked(TernaryFormat):
    """Global stride packing, ``FACTOR`` weights a byte (module docstring)."""

    ARRAY_FIELDS = ("packed",)
    FACTOR: ClassVar[int]

    packed: torch.Tensor  # (Kq, N) uint8, Kq = round_up(K, FACTOR) / FACTOR
    K: int
    N: int

    @classmethod
    def from_dense(cls, W, *, device=None):
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own)."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        Wp = _pad_k(W, cls.FACTOR)
        Kq = Wp.shape[0] // cls.FACTOR
        packed = encode_fields(Wp.view(1, cls.FACTOR, Kq, N), cls.FACTOR)
        return cls(packed=packed[0], K=K, N=N)

    def to_dense(self) -> torch.Tensor:
        return torch.cat(decode_fields(self.packed, self.FACTOR))[:self.K]

    def size_bytes(self) -> int:
        return int(self.packed.numel())

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class PackedTernary2Bit(_StridePacked):
    """Dense ternary packed 4 values a byte (2-bit codes), stride layout."""

    FACTOR = 4


@register_format
class PackedTernary53(_StridePacked):
    """Dense ternary packed 5 values a byte (base-3 codes), stride layout."""

    FACTOR = 5


@register_format
class BlockPackedTernary(TernaryFormat):
    """Block-local stride-packed ternary codes (see module docstring)."""

    ARRAY_FIELDS = ("packed",)

    packed: torch.Tensor  # (nb * tile_kq, N) uint8
    K: int
    N: int
    factor: int
    tile_kq: int

    @classmethod
    def from_dense(cls, W, factor: int = 4, tile_kq: int = 256, *,
                   device=None) -> "BlockPackedTernary":
        """Pack a dense ternary ``(K, N)`` matrix (numpy or torch; on
        ``device``, default the tensor's own), K zero-padded to a multiple
        of ``B = factor * tile_kq``."""
        W = _as_int8_dense(W, device)
        K, N = W.shape
        B = factor * tile_kq
        Wp = _pad_k(W, B)
        nb = Wp.shape[0] // B
        packed = encode_fields(Wp.view(nb, factor, tile_kq, N), factor)
        return cls(packed=packed.reshape(nb * tile_kq, N), K=K, N=N,
                   factor=factor, tile_kq=tile_kq)

    @property
    def num_blocks(self) -> int:
        return self.packed.shape[0] // self.tile_kq

    def to_dense(self) -> torch.Tensor:
        nb, tkq, f = self.num_blocks, self.tile_kq, self.factor
        fields = decode_fields(self.packed.view(nb, tkq, self.N), f)
        out = torch.stack(fields, dim=1)                 # (nb, f, tkq, N)
        return out.reshape(nb * f * tkq, self.N)[:self.K]

    def size_bytes(self) -> int:
        return int(self.packed.numel())

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class DenseTernary(TernaryFormat):
    """Dense int8 ternary matrix, unpadded ``(K, N)`` — the container of
    the plain dense kernels and the correctness oracle."""

    ARRAY_FIELDS = ("dense",)

    dense: torch.Tensor  # (K, N) int8
    K: int
    N: int

    @classmethod
    def from_dense(cls, W, *, device=None) -> "DenseTernary":
        W = _as_int8_dense(W, device).contiguous()
        return cls(dense=W, K=W.shape[0], N=W.shape[1])

    def to_dense(self) -> torch.Tensor:
        return self.dense

    def size_bytes(self) -> int:
        return int(self.dense.numel())

    @property
    def shape(self):
        return (self.K, self.N)
