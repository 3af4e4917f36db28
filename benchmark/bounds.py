"""The yardstick: the least time a piece of work could take on one H100,
from the operations and bytes the work itself needs.

A bound is the larger of two times: the operations at the int8 peak and
the bytes at the memory's peak rate. The bytes are what the request needs
and not what a container or a kernel happens to move: ternary weights at
their entropy (1.5 bits a weight at density 1/2 with balanced signs), each
byte counted once, attention over the positions a query may see, the head
over the rows whose logits are used. So no implementation can read above
100% of its bound, whatever format it packs the weights in.
"""

from __future__ import annotations

import dataclasses
import math

#: NVIDIA H100 SXM data sheet, dense: int8 tensor-core operations a second
PEAK_OPS = 1.979e15
#: HBM3 bytes a second
PEAK_BYTES = 3.35e12


def ternary_bits(density: float) -> float:
    """Entropy in bits of one weight that is 0 with probability
    ``1 - density`` and +1 or -1 with ``density / 2`` each."""
    h = 0.0
    for p in (1.0 - density, density / 2, density / 2):
        if p > 0:
            h -= p * math.log2(p)
    return h


@dataclasses.dataclass
class Work:
    ops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.ops * k, self.bytes * k)

    def seconds(self) -> float:
        return max(self.ops / PEAK_OPS, self.bytes / PEAK_BYTES)


def weights(K: int, N: int, density: float) -> Work:
    """A ternary ``(K, N)`` matrix read once, at its entropy."""
    return Work(0.0, K * N * ternary_bits(density) / 8)


def product(rows: int, K: int, N: int, density: float) -> Work:
    """``rows`` int8 rows times a ternary ``(K, N)`` matrix: two operations
    a nonzero a row, no bytes (:func:`weights` counts the matrix)."""
    return Work(2.0 * rows * K * N * density, 0.0)


def projection(rows: int, K: int, N: int, density: float) -> Work:
    """One A8 projection as one kernel call: its product, its weights, the
    int8 rows and their f32 scales in, the f32 rows out."""
    return (product(rows, K, N, density) + weights(K, N, density)
            + Work(0.0, rows * (K + 4) + rows * N * 4))


def swiglu(rows: int, d: int, ff: int, density: float) -> Work:
    """The fused SwiGLU FFN as one call: gate, up and down products and
    weights, the int8 rows and scales in, the f32 rows out (the hidden
    rows need not leave the chip)."""
    return (product(rows, d, 2 * ff, density) + product(rows, ff, d, density)
            + weights(d, 2 * ff, density) + weights(ff, d, density)
            + Work(0.0, rows * (d + 4) + rows * d * 4))


def attention(queries_keys: int, heads: int, hd: int) -> Work:
    """The two dots (q.k and p.v) over ``queries_keys`` visible
    (query, key) pairs a head."""
    return Work(4.0 * queries_keys * heads * hd, 0.0)


def kv_rows(rows: int, kv_heads: int, hd: int) -> Work:
    """int8 key and value rows, each with its f32 scale a head."""
    return Work(0.0, rows * kv_heads * 2 * (hd + 4))
