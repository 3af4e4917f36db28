"""The streaming decode body (``csrc/gemv_core.cuh``: the x8 and i8 bitplane
kernels' decode branches and both phases of the fused PReLU FFN) and its
split rule (``ops/fused_ffn.py`` ``gemv_parts``), on the CPU: numpy twins
of the kernel's index maps and arithmetic, all exact and bitwise.

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
* The fused PReLU FFN's rules: ``kStageRequant`` (one plane, ``rint(h /
  scale)`` with the row's scale, zeros past K) and the epilogues
  ``kEpiBiasRmax`` (h, then the row absmax folded a warp at a time: a
  warp's 32 threads hold 32 consecutive columns of one row) and
  ``kEpiScaleBias``: the emulated block's y, h, requantized h and rmax
  bitwise those of ``ffn_plain`` / ``ffn_hidden_plain`` for S parts of
  each phase, ragged hidden widths and byte loads.
* The decode-rate probe (``csrc/decode_rate.cu``): the body's inner step
  (``ternary4``, the i8 rule's two ``__dp4a`` a row) on a perturbed tile,
  against ``decode_rate_plain``.
* The rule that computes S, pinned at the 7B geometry and the FFN's blocks
  on 132 SMs.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``-k "x8 or i8_ or gemv or ffn or decode_rate"``)."""

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import fused_ffn
from ternary_spgemm_tpu_torch.tools import decode_roofline as dr

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


def stage_rule(x: np.ndarray, rule: str, scale=None) -> np.ndarray:
    """``stage_value``: x8 rint and clamp to +-127; i8 ``floor(x + 512) -
    512`` in f32; rq (the requantizing rule) ``rint(x / scale)`` by an f32
    division (int64 out)."""
    x = x.astype(np.float32)
    if rule == "x8":
        return np.clip(np.rint(x), -127, 127).astype(np.int64)
    if rule == "rq":
        return np.rint(x / np.float32(scale)).astype(np.int64)
    return (np.floor(x + np.float32(512)) - np.float32(512)).astype(np.int64)


def requant_scale(rmax_bits):
    """``requant_scale``: ``(rmax + 1e-12) / 127`` in f32 from the int bits
    of the row absmax."""
    rmax = np.asarray(rmax_bits, np.int32).view(np.float32)
    return (rmax + np.float32(1e-12)) / np.float32(127)


def pack4(v: np.ndarray) -> np.ndarray:
    """Four int values (last axis) as the bytes of one word (int64 of its
    32 bits): byte j is v[j] & 0xFF."""
    v = v.astype(np.int64) & 0xFF
    return v[..., 0] | v[..., 1] << 8 | v[..., 2] << 16 | v[..., 3] << 24


def stage_part(X, rule, m0, MT, nb, tkb, K, w0, length, scales=None):
    """The block's staged words ``xs[rel*RW + (m*2 + h)*NA + a]`` as the
    kernel's threads write them: thread tid stages row (tid % 2MT) // 2,
    half tid & 1 of byte-rows tid // 2MT + RSTEP*i (its walk position kept
    as (kb, t), RSTEP on each time), the rq rule by the scale of its row
    (``scales``, one a row of X; 1 past M); the number of writes a word."""
    NA = 2 if rule == "i8" else 1
    G, RW = 2 * MT, 2 * NA * MT
    RSTEP = 32 * WARPS // G
    M = X.shape[0]
    xs = np.zeros(length * RW, np.int64)
    writes = np.zeros(length * RW, np.int64)
    for tid in range(32 * WARPS):
        m, h = (tid % G) >> 1, tid & 1
        scale = scales[m0 + m] if scales is not None and m0 + m < M else 1.0
        rel = tid // G
        kb, t = divmod(w0 + rel, tkb)
        while rel < length:
            k = kb * 8 * tkb + h * 4 * tkb + 4 * t
            v = np.zeros(4, np.float32)
            for j in range(4):
                if m0 + m < M and k + j < K:
                    v[j] = X[m0 + m, k + j]
            s = stage_rule(v, rule, scale)
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


def dp4a_rows(x, w):
    """``__dp4a(w[n], x[m], 0)`` for every staged word x[m] of a byte-row's
    rows and lane word w[n] of its columns: (len(x), len(w))."""
    return bytes_s8(x) @ bytes_s8(w).T


def wrap32(v):
    """int64 values as the int32 they wrap to."""
    return (v + 2**31) % 2**32 - 2**31


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


def gemv_emulate(X, fmt, rule, S, scales=None):
    """Y's int32 sums (before the epilogue) as the kernel computes them:
    each block (column tile, row tile of MT, part z) stages its part's X,
    its warps take their rows, decode each byte of the lane words to
    ternary4 words and accumulate ``__dp4a`` products per row, the warps'
    sums add, each part's sums go to the (S, M, N) scratch, and the fold
    adds the parts in order; every sum wraps to int32. ``scales``: the rq
    rule's row scales."""
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
            xs, _ = stage_part(X, rule, m0, MT, nb, tkb, K, w0, length,
                               scales)
            warp_sums = np.zeros((WARPS, MT, N), np.int64)
            for warp in range(WARPS):
                acc = np.zeros((MT, N), np.int64)
                for kb, t, rel in warp_rows(nb, tkb, S, z, warp):
                    o = kb * kb_stride + t * tn + offs
                    p, q = flat[o], flat[o + neg]
                    w = [ternary4(p & 15, q & 15), ternary4(p >> 4, q >> 4)]
                    for h in range(2):
                        at = rel * RW + (np.arange(MT) * 2 + h) * NA
                        if NA == 1:
                            acc += dp4a_rows(xs[at], w[h])
                        else:
                            acc += dp4a_rows(xs[at], times32(w[h]))
                            acc += dp4a_rows(xs[at + 1], w[h])
                    acc = wrap32(acc)
                warp_sums[warp] = acc
            s = wrap32(warp_sums.sum(0))
            part[z, m0:m0 + rows] = s[:rows]
    return wrap32(part.sum(0))


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
    # the PReLU FFN's phases at the ffn_bench block 1024 -> 4096 -> 1024
    # (phase 1 i8, phase 2 the requantizing rule, one plane): M = 1, 32,
    # 33 and 128 (eight row tiles of phase 1 fill the card unsplit; phase
    # 2's 512 byte-rows need 2 parts at M-tile 16)
    (1, 4096, 1, 128, 2, 4),
    (1, 1024, 4, 128, 1, 8),
    (32, 4096, 1, 128, 2, 4),
    (32, 1024, 4, 128, 1, 8),
    (33, 1024, 4, 128, 1, 8),
    (128, 4096, 1, 128, 2, 1),
    (128, 1024, 4, 128, 1, 4),
    (32, 4096, 2, 128, 2, 4),        # 2048 -> 4096 -> 2048
    (32, 2048, 4, 128, 1, 8),
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


# ---------------------------------------------------------------------------
# the fused PReLU FFN's phases (csrc/ffn.cu on the decode body)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("MT", [4, 8, 16])
def test_requant_staging_writes_every_word_once(MT):
    """kStageRequant stages one plane: each word of a part's staged X is
    written once and holds ``rint(h / scale)`` of its row's scale for the
    four activations k .. k + 3 of its (byte-row, row, half), zero past K
    and M; parts up to ``gemv_part_max(M, 1)`` fit the kernel's words."""
    K, tkb = 300, 48
    nb = -(-K // (8 * tkb))
    assert fused_ffn.gemv_part_max(MT, 1) * 2 * MT == X_WORDS
    rng = np.random.default_rng(MT + 1)
    M = MT - 1
    H = rng.normal(0, 3, (M, K)).astype(np.float32)
    H[:, ::5] = -H[:, ::5]
    bits = np.abs(H).max(1).astype(np.float32).view(np.int32)
    scales = requant_scale(bits)
    w0, length = 5, nb * tkb - 5
    xs, writes = stage_part(H, "rq", 0, MT, nb, tkb, K, w0, length, scales)
    assert (writes == 1).all()
    want_q = np.rint(H / scales[:, None]).astype(np.int64)
    assert np.abs(want_q).max() <= 127
    RW = 2 * MT
    for rel in range(length):
        kb, t = divmod(w0 + rel, tkb)
        for m in range(MT):
            for h in range(2):
                k = kb * 8 * tkb + h * 4 * tkb + 4 * t + np.arange(4)
                q = np.zeros(4, np.int64)
                ok = (k < K) & (m < M)
                if m < M:
                    q[ok] = want_q[m, k[ok]]
                assert xs[rel * RW + m * 2 + h] == pack4(q)


def out_map(MT):
    """The block's output map after the warps' reduction: for each (pass,
    e) the (row, column) of its MT x 128 tile that thread tid holds."""
    RG = min(MT, X_WORDS // (WARPS * COLS))
    EPT = RG * COLS // (32 * WARPS)
    tid = np.arange(32 * WARPS)
    return [(p, e, p * RG + (tid + e * 32 * WARPS) // COLS, tid % COLS)
            for p in range(MT // RG) for e in range(EPT)]


def ffn_emulate(X, f1, b1g, a1, f2, b2, a2, gamma12, S1, S2):
    """The fused block as the two launches compute it -> (y, h, hq,
    rmax bits): phase 1's sums (i8 rule), ``kEpiBiasRmax`` by the output
    map (h in f32; each warp's 32 threads, one row and 32 consecutive
    columns, fold the max of their |h| bits into the row's rmax, 0 for the
    elements past N or M), phase 2's sums over h staged by the rq rule at
    the rows' scales, then ``kEpiScaleBias`` with f32 roundings."""
    M, N1, N2 = X.shape[0], f1.N, f2.N
    acc1 = gemv_emulate(X, f1, "i8", S1)
    h = np.zeros((M, N1), np.float32)
    rmax = np.zeros(M, np.int64)
    MT = fused_ffn.gemv_tile(M)
    for m0 in range(0, M, MT):
        for bx in range(-(-N1 // COLS)):
            for _, _, rows, cols in out_map(MT):
                gm, gc = m0 + rows, bx * COLS + cols
                for w in range(WARPS):
                    lanes = slice(32 * w, 32 * w + 32)
                    r = gm[lanes]
                    assert (r == r[0]).all()
                    c = gc[lanes]
                    assert (np.diff(c) == 1).all()
                    if r[0] >= M:
                        continue
                    hv = np.zeros(32, np.float32)
                    ok = c < N1
                    v = acc1[r[0], c[ok]].astype(np.float32) + b1g[c[ok]]
                    hv[ok] = np.where(v > 0, v, a1[c[ok]] * v)
                    h[r[0], c[ok]] = hv[ok]
                    rmax[r[0]] = max(rmax[r[0]],
                                     np.abs(hv).view(np.int32).max())
    scales = requant_scale(rmax)
    hq = stage_rule(h, "rq", scales[:, None])
    acc2 = gemv_emulate(h, f2, "rq", S2, scales)
    y = acc2.astype(np.float32) * (scales[:, None] * np.float32(gamma12)) + b2
    if a2 is not None:
        y = np.where(y > 0, y, a2 * y)
    return y, h, hq, rmax


#: (K, N1, N2, tile_n1): a ragged hidden width with tile_n1 30 (byte loads
#: in phase 1, several tiles); a ragged K and hidden width on word loads
FFN_GEOMS = [(200, 300, 96, 30), (999, 260, 77, 4096)]


@pytest.mark.parametrize("K,N1,N2,tile_n1", FFN_GEOMS)
@pytest.mark.parametrize("M", [1, 4, 16, 33])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_ffn_phases_equal_the_plain_block(K, N1, N2, tile_n1, M, S):
    """The emulated block's y, h, requantized h and row absmax bitwise
    those of ``ffn_plain`` / ``ffn_hidden_plain`` / ``requantize_rows``, for
    S parts of both phases, PReLU2 on and off: rmax is the max over all N1
    columns of the finished h whatever the parts."""
    W1 = tf.generate_ternary(K, N1, 3, seed=K)
    W2 = tf.generate_ternary(N1, N2, 3, seed=N1)
    f1 = tf.TiledBitplane.from_dense(W1, tile_n=tile_n1)
    f2 = tf.TiledBitplane.from_dense(W2)
    rng = np.random.default_rng(M * S + K)
    X = rng.integers(-512, 513, (M, K)).astype(np.float32)
    X[:, ::7] = 512.0
    b1, b2 = (rng.uniform(-2, 2, n).astype(np.float32) for n in (N1, N2))
    a1, a2 = (rng.uniform(0, 0.25, n).astype(np.float32) for n in (N1, N2))
    kw = dict(gamma1=0.037, gamma2=1.9)
    b1g = fused_ffn.true_div(torch.from_numpy(b1), kw["gamma1"]).numpy()
    Xt = torch.from_numpy(X)
    h_plain = fused_ffn.ffn_hidden_plain(Xt, f1, b1, a1, gamma1=kw["gamma1"])
    hq_plain, _ = fused_ffn.requantize_rows(h_plain)
    for alpha2 in (None, a2):
        y, h, hq, rmax = ffn_emulate(X, f1, b1g, a1, f2, b2, alpha2,
                                     kw["gamma1"] * kw["gamma2"], S, S)
        want = fused_ffn.ffn_plain(Xt, f1, b1, a1, f2, b2, alpha2, **kw)
        np.testing.assert_array_equal(h, h_plain.numpy())
        np.testing.assert_array_equal(
            rmax, np.abs(h_plain.numpy()).max(1).view(np.int32))
        np.testing.assert_array_equal(hq, hq_plain.numpy())
        np.testing.assert_array_equal(y, want.numpy())


# ---------------------------------------------------------------------------
# the decode-rate probe (csrc/decode_rate.cu)
# ---------------------------------------------------------------------------


def vadd4(w, r):
    """``__vadd4(w, r * 0x01010101)``: each byte plus r, wrapping."""
    b = (np.asarray(w, np.int64)[..., None] >> (8 * np.arange(4))) & 0xFF
    b = (b + (r & 0xFF)) & 0xFF
    return (b << (8 * np.arange(4))).sum(-1)


def probe_emulate(plane, x, reps):
    """The probe kernel's sums: X staged as the body's i8 words (hi, lo), the
    tile's rows padded to 128-column tiles, warp w taking byte-rows w, w +
    8, ..., each lane word perturbed by __vadd4, ternary4 on each nibble
    pair and the two __dp4a a row; the warps' sums added."""
    tkb, tns = plane.shape[0] // 2, plane.shape[1]
    TS = -(-tns // COLS) * COLS
    ps = np.zeros((2 * tkb, TS), np.int64)
    ps[:, :tns] = plane
    words = (ps.reshape(2 * tkb, TS // 4, 4) << (8 * np.arange(4))).sum(-1)
    rows = 8
    xs = np.zeros((tkb, rows, 2, 2), np.int64)        # (t, m, h, hi / lo)
    for t in range(tkb):
        for m in range(rows):
            for h in range(2):
                v = x[m, h * 4 * tkb + 4 * t + np.arange(4)].astype(np.int64)
                xs[t, m, h] = pack4(v >> 5), pack4(v & 31)
    seen = np.zeros(tkb, np.int64)
    red = np.zeros((rows, TS), np.int64)
    for warp in range(WARPS):
        acc = np.zeros((rows, TS), np.int64)
        for t in range(warp, tkb, WARPS):
            seen[t] += 1
            for r in range(reps):
                p, q = vadd4(words[t], r), vadd4(words[tkb + t], r)
                for h, (pn, qn) in enumerate(((p, q), (p >> 4, q >> 4))):
                    # the lane word's byte c is column 4 * word + c
                    w = np.stack([ternary4((pn >> (8 * c)) & 15,
                                           (qn >> (8 * c)) & 15)
                                  for c in range(4)], -1).reshape(-1)
                    for m in range(rows):
                        hi, lo = xs[t, m, h]
                        acc[m] += dp4a(times32(w), hi) + dp4a(w, lo)
            acc = wrap32(acc)
        red = wrap32(red + acc)
    assert (seen == 1).all()
    return red[:, :tns]


@pytest.mark.parametrize("tkb,tns,reps", [(20, 40, 3), (8, 130, 2)])
def test_decode_rate_probe_arithmetic(tkb, tns, reps):
    """The probe's i8 step (hi / lo words, ternary4 on perturbed words, two
    __dp4a a row) gives ``decode_rate_plain``'s sums: tkb not a multiple of
    the 8 warps, tns padded to column tiles, random X in [-127, 127] (the
    contract, where the split is exact) and all-ones X."""
    cpu = torch.device("cpu")
    plane, ones = dr.probe_inputs(tkb, tns, cpu, seed=tkb)
    x = torch.from_numpy(np.random.default_rng(tns).integers(
        -127, 128, ones.shape).astype(np.int32))
    for xx in (x, ones):
        want = dr.decode_rate_plain(plane, xx, reps)
        got = probe_emulate(plane.numpy(), xx.numpy(), reps)
        np.testing.assert_array_equal(got, want.numpy())
