"""Small shape arithmetic helpers shared across the framework."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return cdiv(x, m) * m


def pad_to(x, m: int):
    """Amount of padding needed to bring ``x`` to a multiple of ``m``."""
    return round_up(x, m) - x
