"""Ternary sparse container formats: all 18 of the JAX package's, each
packing the same bytes (TiledBitplane, TiledNibblePair, TiledDenseTernary,
TiledBlockPacked, BlockPackedTernary, PackedTernary2Bit, PackedTernary53,
DenseTernary, TCSC, TCSR, BlockedTCSC, InterleavedTCSC,
InterleavedBlockedTCSC, EllTCSC, PackedCSC, TiledEllTCSC, BlockedEllTCSC,
TiledEllDeposit)."""

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    all_formats,
    format_from_buffers,
    register_format,
    register_format_buffers,
)
from ternary_spgemm_tpu_torch.formats.bitplane import (
    TiledBitplane,
    TiledNibblePair,
    bitplane_rowmap,
    decode_nibbles,
    decode_planes,
)
from ternary_spgemm_tpu_torch.formats.blocked import (
    BlockedTCSC,
    InterleavedBlockedTCSC,
)
from ternary_spgemm_tpu_torch.formats.blocked_ell import BlockedEllTCSC
from ternary_spgemm_tpu_torch.formats.ell import EllTCSC
from ternary_spgemm_tpu_torch.formats.ell_deposit import TiledEllDeposit
from ternary_spgemm_tpu_torch.formats.ell_tiled import TiledEllTCSC
from ternary_spgemm_tpu_torch.formats.generate import (
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.formats.interleaved import InterleavedTCSC
from ternary_spgemm_tpu_torch.formats.packed import (
    BlockPackedTernary,
    DenseTernary,
    PackedCSC,
    PackedTernary2Bit,
    PackedTernary53,
    pack_signs_base3,
    unpack_signs_base3,
)
from ternary_spgemm_tpu_torch.formats.tcsc import TCSC, TCSR
from ternary_spgemm_tpu_torch.formats.tiled import (
    TiledBlockPacked,
    TiledDenseTernary,
)

__all__ = [
    "TernaryFormat", "register_format", "all_formats",
    "register_format_buffers", "format_from_buffers",
    "TiledBitplane", "TiledNibblePair", "TiledDenseTernary",
    "TiledBlockPacked", "BlockPackedTernary", "PackedTernary2Bit",
    "PackedTernary53", "DenseTernary", "TCSC", "TCSR", "BlockedTCSC",
    "InterleavedTCSC", "InterleavedBlockedTCSC", "EllTCSC", "PackedCSC",
    "TiledEllTCSC", "BlockedEllTCSC", "TiledEllDeposit",
    "pack_signs_base3", "unpack_signs_base3",
    "bitplane_rowmap", "decode_planes", "decode_nibbles",
    "generate_ternary", "generate_x", "generate_bias", "generate_alpha",
]
