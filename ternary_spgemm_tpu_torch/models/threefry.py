"""The JAX package's sampling noise, drawn the way ``jax.random`` draws it,
so that a seed gives the JAX ``generate``'s sampled tokens here too.

The JAX ``generate`` samples token ``t`` with
``jax.random.categorical(fold_in(key(seed), t), logits)``: the argmax of
the logits plus Gumbel noise from ``uniform(minval=tiny)`` over the
``(B, vocab)`` shape. ``jax.random``'s default generator is Threefry-2x32
(20 rounds) with partitionable bits (``jax_threefry_partitionable``, on
by default since JAX 0.5): the 32 bits at flat index ``i`` are the two
words of ``threefry2x32(key, (i >> 32, i & 0xffffffff))`` xor-ed, and a
float in [0, 1) is the bits' top 23 as the mantissa of a number in [1, 2)
less 1. :class:`KeyStream` reproduces that in numpy; the port's
``generate`` takes it in the place of a ``torch.Generator``
(``models.generate.draw_uniform``), drawing one ``(B, vocab)`` uniform a
token at positions ``start, start + 1, ...``: ``T0 - 1`` first for a
prefilled prompt of ``T0`` tokens, 0 without the prefill, as the JAX loop
folds them.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under the key ``(k0, k1)``, all uint32."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> tuple:
    """``jax.random.key(seed)``'s two words."""
    return (np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF))


def fold_in(k: tuple, data: int) -> tuple:
    """``jax.random.fold_in(k, data)``."""
    a, b = threefry2x32(k[0], k[1], np.array([(data >> 32) & 0xFFFFFFFF],
                                             np.uint32),
                        np.array([data & 0xFFFFFFFF], np.uint32))
    return (a[0], b[0])


def uniform(k: tuple, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32)`` in [0, 1)."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


class KeyStream:
    """JAX's per-token keys ``fold_in(key(seed), t)`` for ``t = start,
    start + 1, ...``, one a draw: what ``models.generate.draw_uniform``
    takes in the place of a ``torch.Generator``."""

    def __init__(self, seed: int, start: int):
        self.key = key(seed)
        self.t = start

    def fill_(self, u: torch.Tensor) -> torch.Tensor:
        """Fill ``u`` with the next position's uniform draw, in place."""
        draw = uniform(fold_in(self.key, self.t), tuple(u.shape))
        self.t += 1
        return u.copy_(torch.from_numpy(draw))
