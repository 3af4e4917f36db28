"""The x8 and i8 bitplane kernels' decode body (``csrc/gemv_core.cuh``) and
its split rule (``ops/fused_ffn.py`` ``gemv_parts``), on the CPU: numpy
twins of the kernel's index maps and arithmetic, all exact and bitwise.

* The walk: part z of S takes byte-rows ``[z*W // S, (z+1)*W // S)`` of the
  ``W = nb * tkb`` byte-rows, warp w of its block the part's rows w, w + 8,
  ... (the kernel's ``RowIter``), lane l of block b columns ``128b + 4l ..
  + 3``; over S in 1..W every (byte-row, column) of the container is taken
  exactly once, at the byte the container holds it (ragged K, ``tkb`` not a
  multiple of the 8 warps or the 4-row batches, N not a multiple of
  ``tile_n``, several tiles, ``tile_n`` not a multiple of 4: byte loads).
* The staging: each thread's (row, half, byte-row) words of X cover the
  block's part once, each holding its four activations k .. k + 3.
* ``ternary4`` against ``bits(pos) - bits(neg)`` for all 65,536 (pos, neg)
  byte pairs, both nibbles.
* The sums: the ``__dp4a`` products of each byte-row (x8: one a row; i8:
  ``dp4a(32w, hi) + dp4a(w, lo)``), the warps' sums, the parts' sums and the
  fold, in wrapping int32, against ``X @ W`` in int64 (the i8 rule also out
  of its domain, where it computes with ``32 * int8(v >> 5) + (v & 31)`` as
  the tensor-core branch does).
* The reduction's and the fold's element maps cover a tile once.
* The rule that computes S, pinned at the 7B geometry on 132 SMs.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``-k "x8 or i8_"``)."""

import numpy as np
import pytest

from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import fused_ffn

#: gemv_core.cuh's kWarps, kBatch, kCols, kColsLane, kXWords
WARPS, BATCH, COLS, LANE_COLS, X_WORDS = 8, 4, 128, 4, 8192
M32 = 0xFFFFFFFF


def warp_rows(nb: int, tkb: int, S: int, z: int, warp: int) -> list:
    """(kb, t, rel) of the byte-rows warp ``warp`` of part ``z`` loads, in
    order: ``RowIter`` from walk index ``w0 + warp``, kWarps on each time;
    ``rel`` is the row's index in the part (its staged X)."""
    walk = nb * tkb
    w0, w1 = z * walk // S, (z + 1) * walk // S
    length = w1 - w0
    cnt = (length - warp + WARPS - 1) // WARPS if length > warp else 0
    out = []
    if cnt:
        kb, t = divmod(w0 + warp, tkb)
        for i in range(cnt):
            out.append((kb, t, warp + WARPS * i))
            t += WARPS
            while t >= tkb:
                t -= tkb
                kb += 1
    return out


def lane_cols(N: int, tkb: int, tile_n: int, vec: bool) -> dict:
    """col -> its byte's offset in a K-block's slab row (the kernel's
    ``col_off``, VEC: the lane's first column's and + c), for every column
    a lane of a block takes below N."""
    out = {}
    for bx in range(-(-N // COLS)):
        for lane in range(32):
            col0 = bx * COLS + LANE_COLS * lane
            g0 = col0 // tile_n
            off0 = g0 * 2 * tkb * tile_n + (col0 - g0 * tile_n)
            for c in range(LANE_COLS):
                cc = col0 + c
                if vec:     # one word from the first column's byte
                    if col0 < N:
                        out.setdefault(cc, []).append(off0 + c)
                elif cc < N:
                    g = cc // tile_n
                    out.setdefault(cc, []).append(
                        g * 2 * tkb * tile_n + (cc - g * tile_n))
    return {c: v for c, v in out.items() if c < N}


#: (K, N, tkb, tile_n): ragged K with tkb = 20 (not a multiple of the 8
#: warps' step nor of the batches), three tiles with N off the last; the
#: packer's tkb at K = 999 with tile_n = 96; tile_n not a multiple of 4
#: (byte loads); the 7B merged QKV's geometry
GEOMS = [(999, 300, 20, 128), (999, 260, None, 96), (200, 77, 16, 30),
         (4096, 12288, 128, 4096)]


def _fmt(K, N, tkb, tile_n, seed=0):
    W = tf.generate_ternary(K, N, 3, seed=seed + K + N)
    return tf.TiledBitplane.from_dense(W, tkb=tkb, tile_n=tile_n), W


@pytest.mark.parametrize("K,N,tkb,tile_n", GEOMS)
def test_walk_takes_every_byte_row_once(K, N, tkb, tile_n):
    """For every S in 1..W the parts' warps' rows are the walk, each row
    once, at the (K-block, byte-row) its walk index names; no warp loads a
    row twice and each part's rows are its own."""
    tkb = tkb or min(128, max(16, -(-K // 128) * 128 // 8))
    nb = -(-K // (8 * tkb))
    walk = nb * tkb
    for S in range(1, walk + 1):
        seen = np.zeros(walk, np.int64)
        for z in range(S):
            w0 = z * walk // S
            for warp in range(WARPS):
                for kb, t, rel in warp_rows(nb, tkb, S, z, warp):
                    w = w0 + rel
                    assert (kb, t) == divmod(w, tkb)
                    assert w < (z + 1) * walk // S
                    seen[w] += 1
        assert (seen == 1).all(), S


@pytest.mark.parametrize("K,N,tkb,tile_n", GEOMS[:3])
@pytest.mark.parametrize("S", [1, 2, 3, 7, 8])
def test_every_byte_row_and_column_once(K, N, tkb, tile_n, S):
    """The byte offsets the kernel reads (``kb*kb_stride + t*tile_n +
    col_off``, the neg plane ``tkb*tile_n`` on) are every pos and neg byte
    of the container's columns below N exactly once, and each holds the
    byte the container stores for that (K-block, byte-row, column)."""
    fmt, _ = _fmt(K, N, tkb, tile_n)
    plane = fmt.plane.numpy()
    nb, gn, rows2, tn = plane.shape
    tkb = fmt.tkb
    vec = tn % 4 == 0
    cols = lane_cols(N, tkb, tn, vec)
    assert sorted(cols) == list(range(N))
    assert all(len(v) == 1 for v in cols.values())
    kb_stride, neg = gn * 2 * tkb * tn, tkb * tn
    flat = plane.reshape(-1)
    hits = np.zeros(flat.size, np.int64)
    for z in range(S):
        for warp in range(WARPS):
            for kb, t, _ in warp_rows(nb, tkb, S, z, warp):
                for col, (off,) in cols.items():
                    o = kb * kb_stride + t * tn + off
                    g, n = divmod(col, tn)
                    assert flat[o] == plane[kb, g, t, n]
                    assert flat[o + neg] == plane[kb, g, tkb + t, n]
                    hits[o] += 1
                    hits[o + neg] += 1
    want = np.zeros_like(plane, dtype=np.int64)
    for col in range(N):
        want[:, col // tn, :, col % tn] = 1
    np.testing.assert_array_equal(hits.reshape(plane.shape), want)


def stage_rule(x: np.ndarray, rule: str) -> np.ndarray:
    """``stage_value``: x8 rint and clamp to +-127; i8 ``floor(x + 512) -
    512`` in f32 (int64 out)."""
    x = x.astype(np.float32)
    if rule == "x8":
        return np.clip(np.rint(x), -127, 127).astype(np.int64)
    return (np.floor(x + np.float32(512)) - np.float32(512)).astype(np.int64)


def pack4(v: np.ndarray) -> np.ndarray:
    """Four int values (last axis) as the bytes of one word (int64 of its
    32 bits): byte j is v[j] & 0xFF."""
    v = v.astype(np.int64) & 0xFF
    return v[..., 0] | v[..., 1] << 8 | v[..., 2] << 16 | v[..., 3] << 24


def stage_part(X, rule, m0, MT, nb, tkb, K, w0, length):
    """The block's staged words ``xs[rel*RW + (m*2 + h)*NA + a]`` as the
    kernel's threads write them: thread tid stages row (tid % 2MT) // 2,
    half tid & 1 of byte-rows tid // 2MT + RSTEP*i (its walk position kept
    as (kb, t), RSTEP on each time); the number of writes a word."""
    NA = 2 if rule == "i8" else 1
    G, RW = 2 * MT, 2 * NA * MT
    RSTEP = 32 * WARPS // G
    M = X.shape[0]
    xs = np.zeros(length * RW, np.int64)
    writes = np.zeros(length * RW, np.int64)
    for tid in range(32 * WARPS):
        m, h = (tid % G) >> 1, tid & 1
        rel = tid // G
        kb, t = divmod(w0 + rel, tkb)
        while rel < length:
            k = kb * 8 * tkb + h * 4 * tkb + 4 * t
            v = np.zeros(4, np.float32)
            for j in range(4):
                if m0 + m < M and k + j < K:
                    v[j] = X[m0 + m, k + j]
            s = stage_rule(v, rule)
            at = rel * RW + (tid % G) * NA
            if NA == 2:
                xs[at], xs[at + 1] = pack4(s >> 5), pack4(s & 31)
            else:
                xs[at] = pack4(s)
            writes[at:at + NA] += 1
            rel += RSTEP
            t += RSTEP
            while t >= tkb:
                t -= tkb
                kb += 1
    return xs, writes


@pytest.mark.parametrize("rule", ["x8", "i8"])
@pytest.mark.parametrize("MT", [4, 8, 16])
def test_staging_writes_every_word_once(rule, MT):
    """Each word of a part's staged X is written once and holds the staged
    activations k .. k + 3 of its (byte-row, row, half), zero past K and M;
    parts up to ``gemv_part_max`` fit the kernel's shared words."""
    K, tkb = 999, 20
    nb = -(-K // (8 * tkb))
    NA = 2 if rule == "i8" else 1
    assert fused_ffn.gemv_part_max(MT, NA) * 2 * NA * MT == X_WORDS
    rng = np.random.default_rng(MT)
    M = MT - 1    # a row of the tile past M
    X = rng.uniform(-700, 700, (M, K)).astype(np.float32)
    w0, length = 17, 61
    xs, writes = stage_part(X, rule, 0, MT, nb, tkb, K, w0, length)
    assert (writes == 1).all()
    RW = 2 * NA * MT
    for rel in range(length):
        kb, t = divmod(w0 + rel, tkb)
        for m in range(MT):
            for h in range(2):
                k = kb * 8 * tkb + h * 4 * tkb + 4 * t + np.arange(4)
                v = np.zeros(4, np.float32)
                ok = (k < K) & (m < M)
                if m < M:
                    v[ok] = X[m, k[ok]]
                s = stage_rule(v, rule)
                at = rel * RW + (m * 2 + h) * NA
                if NA == 2:
                    assert xs[at] == pack4(s >> 5) and xs[at + 1] == pack4(s & 31)
                else:
                    assert xs[at] == pack4(s)


def ternary4(p, n):
    """``ternary4.cuh``: byte j of the word is pos bit j - neg bit j of the
    nibbles p and n (int64 arrays of the 32 bits)."""
    p, n = np.asarray(p, np.int64), np.asarray(n, np.int64)
    sp = (p * 0x00204081) & 0x01010101
    sn = (n * 0x00204081) & 0x01010101
    return (((sp | 0x80808080) - sn) ^ 0x80808080) & M32


def times32(b):
    """``times32``: 32 w bytewise."""
    return (np.asarray(b, np.int64) << 5) & 0xE0E0E0E0


def bytes_s8(w):
    """The four int8 bytes of 32-bit words (last axis 4)."""
    w = np.asarray(w, np.int64) & M32
    b = (w[..., None] >> (8 * np.arange(4))) & 0xFF
    return np.where(b > 127, b - 256, b)


def dp4a(a, b):
    """``__dp4a(a, b, 0)``: the sum of the four int8 byte products."""
    return (bytes_s8(a) * bytes_s8(b)).sum(-1)


def test_ternary4_every_byte_pair():
    """Both nibbles of every (pos, neg) byte pair: byte j of ternary4 is
    bit j - bit j of the nibble, as int8 (a pair with both flags set gives
    0, the plain version's ``bits(pos) - bits(neg)``); times32 is 32 times
    each byte."""
    pos, neg = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    pos, neg = pos.ravel(), neg.ravel()
    bits = (np.arange(8))
    want = ((pos[:, None] >> bits) & 1) - ((neg[:, None] >> bits) & 1)
    lo = bytes_s8(ternary4(pos & 15, neg & 15))
    hi = bytes_s8(ternary4(pos >> 4, neg >> 4))
    np.testing.assert_array_equal(np.concatenate([lo, hi], 1), want)
    np.testing.assert_array_equal(
        bytes_s8(times32(ternary4(pos >> 4, neg >> 4))), 32 * want[:, 4:])


def gemv_emulate(X, fmt, rule, S):
    """Y's int32 sums (before the epilogue) as the kernel computes them:
    each block (column tile, row tile of MT, part z) stages its part's X,
    its warps take their rows, decode each byte of the lane words to
    ternary4 words and accumulate ``__dp4a`` products per row, the warps'
    sums add, each part's sums go to the (S, M, N) scratch, and the fold
    adds the parts in order; every sum wraps to int32."""
    plane = fmt.plane.numpy().astype(np.int64)
    nb, gn, _, tn = plane.shape
    tkb, K, N = fmt.tkb, fmt.K, fmt.N
    M = X.shape[0]
    MT = fused_ffn.gemv_tile(M)
    NA = 2 if rule == "i8" else 1
    RW = 2 * NA * MT
    walk = nb * tkb
    assert -(-walk // S) <= fused_ffn.gemv_part_max(M, NA)
    flat = plane.reshape(-1)
    kb_stride, neg = gn * 2 * tkb * tn, tkb * tn
    cols = lane_cols(N, tkb, tn, tn % 4 == 0)
    offs = np.array([cols[c][0] for c in range(N)], np.int64)
    part = np.zeros((S, M, N), np.int64)
    for m0 in range(0, M, MT):
        rows = min(MT, M - m0)
        for z in range(S):
            w0 = z * walk // S
            length = (z + 1) * walk // S - w0
            xs, _ = stage_part(X, rule, m0, MT, nb, tkb, K, w0, length)
            warp_sums = np.zeros((WARPS, MT, N), np.int64)
            for warp in range(WARPS):
                acc = np.zeros((MT, N), np.int64)
                for kb, t, rel in warp_rows(nb, tkb, S, z, warp):
                    o = kb * kb_stride + t * tn + offs
                    p, q = flat[o], flat[o + neg]
                    w = [ternary4(p & 15, q & 15), ternary4(p >> 4, q >> 4)]
                    for m in range(MT):
                        for h in range(2):
                            at = rel * RW + (m * 2 + h) * NA
                            if NA == 1:
                                acc[m] += dp4a(w[h], xs[at])
                            else:
                                acc[m] += dp4a(times32(w[h]), xs[at])
                                acc[m] += dp4a(w[h], xs[at + 1])
                    acc = (acc + 2**31) % 2**32 - 2**31
                warp_sums[warp] = acc
            s = (warp_sums.sum(0) + 2**31) % 2**32 - 2**31
            part[z, m0:m0 + rows] = s[:rows]
    return (part.sum(0) + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("K,N,tkb,tile_n", GEOMS[:3])
@pytest.mark.parametrize("rule", ["x8", "i8"])
@pytest.mark.parametrize("M,S", [(1, 1), (4, 3), (5, 8), (16, 2), (17, 5)])
def test_sums_equal_the_product(K, N, tkb, tile_n, rule, M, S):
    """The emulated kernel's int32 sums equal ``stage(X) @ W`` in int64: x8
    on X that rounds and clamps, i8 on integer X at the +-512 edges and on
    floored non-integer X, for M-tiles of 4, 8 and 16 (two row tiles at
    17) and S parts."""
    fmt, W = _fmt(K, N, tkb, tile_n)
    rng = np.random.default_rng(M * S + K)
    if rule == "x8":
        X = (1.3 * rng.integers(-127, 128, (M, K))).astype(np.float32)
        X[:, ::3] = np.round(X[:, ::3]) + 0.5
    else:
        X = rng.uniform(-512, 512, (M, K)).astype(np.float32)
        X[:, ::7], X[:, 3::7] = 512.0, -512.0
    got = gemv_emulate(X, fmt, rule, S)
    want = stage_rule(X, rule) @ W.astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_i8_rule_beyond_its_domain():
    """Out of +-4096 the i8 stage computes with ``32 * int8(v >> 5) + (v &
    31)``, the tensor-core branch's split, so both branches give the same
    bits on every input (a multiple of 8192 off ``v`` where the hi byte
    wraps)."""
    K, N = 300, 70
    fmt, W = _fmt(K, N, 16, 128)
    rng = np.random.default_rng(5)
    X = rng.uniform(-70000, 70000, (3, K)).astype(np.float32)
    v = stage_rule(X, "i8")
    hi = ((v >> 5) + 128) % 256 - 128
    split = 32 * hi + (v & 31)
    assert (split != v).any()
    got = gemv_emulate(X, fmt, "i8", 2)
    np.testing.assert_array_equal(got, split @ W.astype(np.int64))


@pytest.mark.parametrize("MT", [4, 8, 16])
def test_reduction_and_fold_cover_the_tile(MT):
    """The reduction's passes of RG rows and the fold give thread tid
    element (pass*RG + (tid + e*256) // 128, tid % 128) of the block's MT x
    128 tile: every element once, each column's lanes consecutive."""
    red_rows = X_WORDS // (WARPS * COLS)
    RG = min(MT, red_rows)
    EPT = RG * COLS // (32 * WARPS)
    seen = np.zeros((MT, COLS), np.int64)
    for pss in range(MT // RG):
        for e in range(EPT):
            for tid in range(32 * WARPS):
                seen[pss * RG + (tid + e * 32 * WARPS) // COLS, tid % COLS] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("M,N,nb,tkb,planes,want", [
    # the 7B merged QKV and wo at decode's 4 rows (x8): 96 and 32 column
    # tiles; three blocks an SM on 132 SMs hold 4 x 96 and 8 x 32
    (4, 12288, 4, 128, 1, 4),
    (4, 4096, 4, 128, 1, 8),
    (1, 4096, 4, 128, 1, 8),
    (16, 12288, 4, 128, 1, 4),
    (32, 12288, 4, 128, 1, 2),       # two row tiles of 16: 192 tiles
    (32, 4096, 4, 128, 1, 4),
    # i8 at the north star's K (one K-block: parts of 32 byte-rows at most
    # 4) and the up-projection (at M-tile 16 parts of <= 128 byte-rows: 4)
    (4, 4096, 1, 128, 2, 4),
    (32, 4096, 1, 128, 2, 4),
    (4, 11008, 4, 128, 2, 4),
    (16, 11008, 4, 128, 2, 4),
    (33, 4096, 4, 128, 1, 4),        # three row tiles of 16: 96 tiles
    (4, 32, 1, 16, 1, 1),            # a walk of 16 byte-rows
    (4, 32, 0, 16, 1, 1),            # K = 0: no walk
])
def test_gemv_parts_rule(M, N, nb, tkb, planes, want):
    """S is the largest power of two up to 8 whose blocks fit three an SM
    on 132 SMs and whose parts give each warp a whole register set (32
    byte-rows a part), then at least the parts whose X fits."""
    assert (fused_ffn.GEMV_SLOTS_PER_SM, fused_ffn.GEMV_MAX_PARTS) == (3, 8)
    # the kernel's geometry, as the twins above take it
    assert (fused_ffn.GEMV_COLS, fused_ffn.GEMV_WARPS, fused_ffn.GEMV_BATCH,
            fused_ffn.GEMV_X_WORDS) == (COLS, WARPS, BATCH, X_WORDS)
    assert fused_ffn.gemv_parts(M, N, nb, tkb, 132, planes) == want
