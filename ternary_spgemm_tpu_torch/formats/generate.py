"""Seeded ternary matrix / activation generators (numpy, host side).

A copy of ``ternary_spgemm_tpu/formats/generate.py``: the same seeds give the
same arrays in both packages, which is what lets the parity tests feed one
set of inputs to both. See that module for the distribution semantics
(``cpp_impl/sparseUtils.h:6-90`` of the reference project).
"""

from __future__ import annotations

import numpy as np


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.Generator(np.random.SFC64(seed))


def generate_ternary(K: int, N: int, s: int, *, seed=0, uniform: bool = False) -> np.ndarray:
    """``K x N`` int8 ternary matrix with density ~= 1/s (see the JAX
    package's ``generate_ternary`` for the exact per-row semantics)."""
    if s < 1:
        raise ValueError(f"sparsity parameter s must be >= 1, got {s}")
    rng = _rng(seed)
    W = np.zeros((K, N), dtype=np.int8)

    if uniform:
        if N % (2 * s) != 0:
            raise ValueError(f"uniform mode needs N divisible by 2*s (N={N}, s={s})")
        win = 2 * s
        nwin = N // win
        a = rng.integers(0, win, size=(K, nwin))
        b = rng.integers(0, win - 1, size=(K, nwin))
        b = np.where(b >= a, b + 1, b)
        base = np.arange(nwin) * win
        rows = np.repeat(np.arange(K), nwin)
        W[rows, (base[None, :] + a).ravel()] = 1
        W[rows, (base[None, :] + b).ravel()] = -1
        return W

    half = (N // s) // 2
    vari_hi = N // s // 20 + 1
    pos_vari = rng.integers(0, vari_hi + 1, size=K)
    limit_pos = half + pos_vari
    limit_neg = half - pos_vari
    keys = rng.random((K, N), dtype=np.float32)
    order = np.argsort(keys, axis=1)
    cols = np.arange(N)[None, :]
    plus_mask = cols < limit_pos[:, None]
    minus_mask = (cols >= limit_pos[:, None]) & (cols < (limit_pos + limit_neg)[:, None])
    rows = np.repeat(np.arange(K)[:, None], N, axis=1)
    W[rows[plus_mask], order[plus_mask]] = 1
    W[rows[minus_mask], order[minus_mask]] = -1
    return W


def generate_x(M: int, K: int, *, seed=0, value_range: int = 512, dtype=np.float32) -> np.ndarray:
    """Dense activations of random integers in [-range, range] (``initX``)."""
    rng = _rng(seed)
    return rng.integers(-value_range, value_range + 1, size=(M, K)).astype(dtype)


def generate_bias(N: int, *, value: float = 2.0, dtype=np.float32) -> np.ndarray:
    """Constant bias, mirroring ``perf.cpp:304`` (B = 2)."""
    return np.full((N,), value, dtype=dtype)


def generate_alpha(N: int, *, value: float = 0.1, dtype=np.float32) -> np.ndarray:
    """Constant PReLU slope, mirroring ``perf.cpp:611`` (alpha = 0.1)."""
    return np.full((N,), value, dtype=dtype)
