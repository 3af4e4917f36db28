"""The property that makes the ELL kernels' early exit exact, on both
packages' containers.

``csrc/ell_core.cuh`` walks each K-block's slot rows with 8 warps (warp w
takes rows w, w + 8, ... of a section; for ``TiledEllDeposit`` that is word
w's slots in order) and stops a warp once every lane of it reads the
sentinel. That drops nothing only if, in every column, each section (each
word of a section, for the deposit) holds its real offsets first and the
sentinels after them. These tests pin that property for ``TiledEllTCSC``,
``TiledEllDeposit`` and ``BlockedEllTCSC`` as packed by the port and by the
JAX package from one numpy W made from a seed, and emulate the kernel's walk
in numpy: the walk with the early exit visits no fewer slot-lanes than the
nonzeros and no more than the walk to the caps, and its signed gather-sum
is exactly X @ W on integer X.
"""

import numpy as np
import pytest

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu_torch import formats as tf

COLS = 32          # columns a block, one a lane (ell_core.cuh kCols)
WARPS = 8          # warps a block, splitting the slot rows
WORD_ROWS, WORDS = 31, 8

#: (K, N, s, dense column or None): a small north star (32x1024x4096 s=4
#: cut to 256x512), a ragged K and N (off every block, tile and 32) at s in
#: {2, 3, 16}, and a sparse tile with one dense column (the early exit's
#: worst case: that column sets the cap of its warps)
SHAPES = {
    "ns_small": (256, 512, 4, None),
    "ragged_s2": (299, 201, 2, None),
    "ragged_s3": (299, 201, 3, None),
    "ragged_s16": (299, 201, 16, None),
    "dense_column": (260, 300, 16, 37),
}
#: container -> packer arguments that give several N-tiles at these sizes
PACK = {"TiledEllTCSC": {"tile_n": 128},
        "TiledEllDeposit": {"tile_n": 128},
        "BlockedEllTCSC": {"tile_n": 64}}


def _weights(name):
    K, N, s, dense = SHAPES[name]
    W = tf.generate_ternary(K, N, s, seed=K * N + s)
    if dense is not None:
        W[:, dense] = np.where(np.arange(K) % 2 == 0, 1, -1)
    return W


def _pack(pkg, cls, W):
    mod = tf if pkg == "port" else jf
    return getattr(mod, cls).from_dense(W, **PACK[cls])


def _np(t):
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def sections(fmt):
    """The container as the kernel walks it: a list of (slots, sign, caps)
    with slots (nb, groups, S, Ncols) int (group g's slot s of a column),
    caps (nb, Ncols) the walk bound of each column in slots; and a
    function (kb, group, offset) -> dense row, the sentinel."""
    if isinstance(fmt, (tf.TiledEllTCSC, jf.TiledEllTCSC)):
        plane = _np(fmt.plane).astype(np.int32)
        nb, gn, caps_rows, tn = plane.shape
        flat = plane.transpose(0, 2, 1, 3).reshape(nb, caps_rows, gn * tn)
        tile = np.arange(gn * tn) // tn
        secs = [(flat[:, None, :fmt.cap_p_max], 1, _np(fmt.cap_pos)[:, tile]),
                (flat[:, None, fmt.cap_p_max:], -1, _np(fmt.cap_neg)[:, tile])]
        return secs, (lambda kb, g, off: kb * fmt.block_k + off), fmt.block_k
    if isinstance(fmt, (tf.TiledEllDeposit, jf.TiledEllDeposit)):
        plane = _np(fmt.plane).astype(np.int32)
        nsb, gn, rows, tn = plane.shape
        flat = plane.transpose(0, 2, 1, 3).reshape(nsb, rows, gn * tn)
        split = WORDS * fmt.cap_p_max
        tile = np.arange(gn * tn) // tn
        words = [flat[:, :split], flat[:, split:]]    # row 8*s + w
        secs = [(w.reshape(nsb, -1, WORDS, gn * tn).transpose(0, 2, 1, 3),
                 sign, _np(cap)[:, tile])
                for w, sign, cap in zip(words, (1, -1),
                                        (fmt.cap_pos, fmt.cap_neg))]
        return (secs, (lambda kb, w, off: kb * WORDS * WORD_ROWS
                       + w * WORD_ROWS + off), WORD_ROWS)
    tile = np.arange(_np(fmt.idx_pos).shape[2]) // fmt.tile_n
    secs = [(_np(fmt.idx_pos).astype(np.int32)[:, None], 1,
             _np(fmt.tile_cap_pos)[:, tile]),
            (_np(fmt.idx_neg).astype(np.int32)[:, None], -1,
             _np(fmt.tile_cap_neg)[:, tile])]
    return secs, (lambda kb, g, off: kb * fmt.block_k + off), -1


CASES = [(cls, pkg, shape) for cls in sorted(PACK) for pkg in ("port", "jax")
         for shape in sorted(SHAPES)]


@pytest.mark.parametrize("cls,pkg,shape", CASES)
def test_sentinels_trail_real_slots(cls, pkg, shape):
    """In every column of every K-block, each section (each word of a
    section) holds its real offsets first and sentinels only after them,
    and no more real slots than the column's cap."""
    W = _weights(shape)
    fmt = _pack(pkg, cls, W)
    secs, _, sent = sections(fmt)
    real_total = 0
    for slots, _, caps in secs:
        real = slots != sent
        # a real slot never follows a sentinel down the slot axis
        assert not np.any(real[:, :, 1:] & ~real[:, :, :-1])
        counts = real.sum(axis=2)                      # (nb, groups, Ncols)
        assert np.all(counts <= caps[:, None, :])
        real_total += int(real.sum())
    assert real_total == int(np.count_nonzero(W))


def emulate_walk(fmt, X, N):
    """The kernel's walk in numpy: per K-block, 32-column block and
    section, the rows bound is the largest cap x rows-a-slot among the
    block's columns below N; warp w takes its rows in order and stops after
    the longest real prefix among its lanes. Returns (Y = the signed
    gather-sum, slot-lanes visited, slot-lanes of the walk to the caps)."""
    secs, dense_row, sent = sections(fmt)
    M = X.shape[0]
    Yt = np.zeros((N, M), np.int64)
    visited = capwalk = 0
    for slots, sign, caps in secs:
        nb, groups, S, ncols = slots.shape
        rps = groups      # the deposit's 8 words: 8 slot rows a slot
        for kb in range(nb):
            for c0 in range(0, N, COLS):
                cols = np.arange(c0, min(c0 + COLS, ncols))
                ok = cols < N
                rows = int((caps[kb, cols] * ok).max()) * rps
                for w in range(WARPS):
                    mine = np.arange(w, rows, WARPS)  # this warp's slot rows
                    if groups == 1:
                        blk = slots[kb, 0][mine][:, cols]
                    else:      # deposit: row 8*s + w is word w's slot s
                        blk = slots[kb, w][mine // WORDS][:, cols]
                    real = blk != sent
                    live = int(real.sum(axis=0).max()) if len(mine) else 0
                    visited += COLS * live
                    capwalk += COLS * len(mine)
                    i, lane = np.nonzero(real[:live])
                    k = dense_row(kb, w, blk[i, lane])
                    assert np.all(k < X.shape[1]) and np.all(ok[lane])
                    np.add.at(Yt, cols[lane], sign * X.T[k])
    return Yt.T, visited, capwalk


@pytest.mark.parametrize("cls,pkg,shape", CASES)
def test_early_exit_walk_is_exact(cls, pkg, shape):
    """The early-exit walk visits at least the nonzeros and fewer
    slot-lanes than the walk to the caps, and its sum is X @ W exactly
    (integer X)."""
    W = _weights(shape)
    fmt = _pack(pkg, cls, W)
    K, N = W.shape
    X = tf.generate_x(5, K, seed=K).astype(np.int64)
    Y, visited, capwalk = emulate_walk(fmt, X, N)
    nnz = int(np.count_nonzero(W))
    assert nnz <= visited <= capwalk
    np.testing.assert_array_equal(Y, X @ W.astype(np.int64))
    # a tile's cap is its longest column's count; a warp stops at its own
    assert visited < capwalk


#: ell_core.cuh's packed int16 sums (the deposit): kEllPackRows,
#: kEllPackBias, and the slot rows a warp adds between two room() checks
PACK_ROWS, PACK_BIAS, UNROLL = 28, 512, 4


def _wrap32(v):
    return (v + 2**31) % 2**32 - 2**31


def packed_sums(x, rows, signs):
    """EllAcc<MT, kStageI8> in numpy: the staged words of ``x`` (MT, E)
    (rows 2i and 2i + 1 of an entry as one int32 word, the low half biased
    by PACK_BIAS), added or subtracted (``signs``) at the entries ``rows``
    into packed int32 sums, flushed into int sums whenever UNROLL more rows
    could pass PACK_ROWS and at the end."""
    lo, hi = x[0::2].astype(np.int64), x[1::2].astype(np.int64)
    words = _wrap32(hi * 65536 + lo + PACK_BIAS)        # (MT/2, E) int32
    v = np.zeros(x.shape[0], np.int64)
    p = np.zeros(words.shape[0], np.int64)
    n = bias = 0
    for g in range(0, len(rows), UNROLL):
        if n + UNROLL > PACK_ROWS:
            low = (p + 2**15) % 2**16 - 2**15
            v[0::2] += low - PACK_BIAS * bias
            v[1::2] += (p - low) >> 16
            p[:] = 0
            n = bias = 0
        for e, sgn in zip(rows[g:g + UNROLL], signs[g:g + UNROLL]):
            p = _wrap32(p + sgn * words[:, e])
            n += 1
            bias += sgn
    low = (p + 2**15) % 2**16 - 2**15
    v[0::2] += low - PACK_BIAS * bias
    v[1::2] += (p - low) >> 16
    return v


@pytest.mark.parametrize("case", ["random", "plus_edge", "minus_edge",
                                  "alternating_edges", "zero_entries"])
@pytest.mark.parametrize("MT", [4, 8, 32])
def test_packed_int16_sums_exact(case, MT):
    """The deposit's packed sums equal the int sums of the staged values
    over every value of its domain, the +-512 edges included, for pos and
    neg rows in any mix, with walks of many flushes."""
    rng = np.random.default_rng(MT)
    E, R = 64, 300
    x = rng.integers(-512, 513, (MT, E))
    rows = rng.integers(0, E, R)
    signs = rng.choice([-1, 1], R)
    if case == "plus_edge":        # every pos row +512, every neg row -512
        x[:] = 512
        x[:, 1::2] = -512
        rows = np.where(signs > 0, 0, 1)
    elif case == "minus_edge":
        x[:] = -512
        x[:, 1::2] = 512
        rows = np.where(signs > 0, 0, 1)
    elif case == "alternating_edges":
        x[0::2], x[1::2] = 512, -512
    elif case == "zero_entries":   # a sentinel's entry: every row 0
        x[:, ::3] = 0
    want = (x[:, rows] * signs).sum(axis=1)
    np.testing.assert_array_equal(packed_sums(x, rows, signs), want)
