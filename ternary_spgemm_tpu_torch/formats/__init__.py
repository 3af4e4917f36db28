"""Ternary sparse container formats (ported so far: TiledBitplane,
TiledNibblePair, TiledDenseTernary, TiledBlockPacked, BlockPackedTernary,
DenseTernary, TCSC; the other eleven of the JAX package's 18 are not ported
yet)."""

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
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
from ternary_spgemm_tpu_torch.formats.generate import (
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu_torch.formats.packed import (
    BlockPackedTernary,
    DenseTernary,
)
from ternary_spgemm_tpu_torch.formats.tcsc import TCSC
from ternary_spgemm_tpu_torch.formats.tiled import (
    TiledBlockPacked,
    TiledDenseTernary,
)

__all__ = [
    "TernaryFormat", "register_format",
    "register_format_buffers", "format_from_buffers",
    "TiledBitplane", "TiledNibblePair", "TiledDenseTernary",
    "TiledBlockPacked", "BlockPackedTernary", "DenseTernary", "TCSC",
    "bitplane_rowmap", "decode_planes", "decode_nibbles",
    "generate_ternary", "generate_x", "generate_bias", "generate_alpha",
]
