"""Ternary sparse container formats (the slice ported so far: TiledBitplane)."""

from ternary_spgemm_tpu_torch.formats.base import (
    TernaryFormat,
    format_from_buffers,
    register_format,
    register_format_buffers,
)
from ternary_spgemm_tpu_torch.formats.bitplane import (
    TiledBitplane,
    bitplane_rowmap,
    decode_planes,
)
from ternary_spgemm_tpu_torch.formats.generate import (
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)

__all__ = [
    "TernaryFormat", "register_format",
    "register_format_buffers", "format_from_buffers",
    "TiledBitplane", "bitplane_rowmap", "decode_planes",
    "generate_ternary", "generate_x", "generate_bias", "generate_alpha",
]
