"""The kernels over the packed-row and bit-plane containers on the bf16
tensor-core tile of ``csrc/dense_mma.cuh`` (the int8-X ``CudaTiledDense_i8``
/ ``_x8``, ``CudaDense_i8``, ``CudaBlockPacked_i8``,
``CudaTiledBlockPacked_i8``, ``CudaPacked2Bit_i8``, ``CudaPacked53_i8``; the
f32-X ``CudaPacked2Bit`` and ``CudaPacked53``; the bf16-X
``CudaTiledBitplane_bf16``; the int8-X ``CudaTiledNibblePair_i8``), on the
CPU.

* ``ops.cuda_kernels.split_bf16`` under the i8 and x8 rules: two pieces
  (i8) and one (x8) sum back to the staged value bitwise over the whole
  domain, and where the i8 split stops being exact.
* ``ops.cuda_kernels.swar_decode``, the Python twin of the tile's decode
  of four packed bytes at a time, against ``formats.packed.decode_fields``
  for every byte the packers emit; ``nibble_decode``, the twin of the
  nibbles' transposing decode, against ``formats.bitplane.decode_nibbles``
  for every nibble the packer emits at every byte and column of a group.
* A numpy emulation of the tile's lanes over the slab layouts (``Slabs<F>``
  and ``Bitplane``) — the (K-block, chunk of packed rows) walk, X staged
  run by run (a field's, or a half of a bit-plane block's) by its rule and
  split, the masks at a run's end and at K, the skipped k-steps, the
  codes and the pos / neg bits decoded into int8 rows of W, the B
  registers ``b_pairs`` interleaves, ``mma.sync`` m16n8k16, the groups of
  k-steps the float rules sum into zeroed fragments (rounded to f32 as
  they are added) and the epilogue's column map — gives ``rule(X) @ W``
  (W from ``decode_fields`` / ``decode_planes``) for DenseTernary,
  TiledDenseTernary (K = 100, where ``tile_k`` = 128 is under the Narrow
  tile's 256-row chunk), BlockPackedTernary, TiledBlockPacked, the
  stride-packed containers (``tkq`` = 250 and 200, not multiples of 16;
  i8 and f32 X: F = 5's ragged split and ragged last group),
  TiledBitplane and TiledNibblePair (``tkb`` = 16 under the 32-row chunk
  at K = 100; K = 999 over two slabs; four K-blocks), in every geometry:
  exactly on
  integer X, and on non-integer X exactly for the integer rules and within
  rtol=1e-5, atol=1e-3 for the float ones.

The plain versions against the JAX Pallas kernels (interpret mode) are
``tests/test_torch_kernels.py``'s ``test_plain_equals_pallas`` and
``test_i8_kernels_floor_non_integer_x``. The tile itself runs only on the
card (``tests/test_torch_cuda.py``, ``-k packed_mma``)."""

import itertools

import numpy as np
import pytest
import torch

from test_torch_dense_mma import G, T4, b_pairs, byte_perm, mma
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.formats.bitplane import (
    decode_nibbles,
    decode_planes,
)
from ternary_spgemm_tpu_torch.formats.packed import decode_fields
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops.api import to_bf16, to_f32, to_i8, to_x8


# -- the split under the integer rules -------------------------------------

def _pieces_sum(x: torch.Tensor, stage: str) -> torch.Tensor:
    out = torch.zeros_like(x)
    for p in ck.split_bf16(x, stage=stage):
        out = out + p.to(torch.float32)
    return out


def test_stage_piece_counts():
    """i8 takes two pieces, x8 and bf16 one, f32 three; an unknown rule
    is refused."""
    x = torch.tensor([3.7, -300.2])
    assert {s: len(ck.split_bf16(x, stage=s)) for s in ck.STAGES} == \
        {"f32": 3, "bf16": 1, "x8": 1, "i8": 2}
    with pytest.raises(ValueError, match="stage"):
        ck.split_bf16(x, stage="i4")


@pytest.mark.parametrize("offset", [0.0, 0.25, 0.5, 0.999])
def test_i8_two_pieces_sum_back(offset):
    """Every x in [-512, 512] (integers, and each plus a fraction, which
    the rule floors): hi + lo == floor(x + 512) - 512 bitwise, lo in
    {-1, 0, 1}."""
    x = torch.arange(-512, 513, dtype=torch.float32) + offset
    x = x[x <= 512]
    hi, lo = (p.to(torch.float32) for p in ck.split_bf16(x, stage="i8"))
    assert torch.equal(hi + lo, to_i8(x))
    assert set(lo.unique().tolist()) <= {-1.0, 0.0, 1.0}


def test_i8_two_pieces_beyond_the_domain():
    """Past the domain the two pieces stay exact for every integer
    |v| < 2**17; from there on a remainder may need 9 bits: 2**17 + 257
    splits into 2**17 and 256 (257 rounds to even), one short."""
    v = torch.arange(-2 ** 17 + 1, 2 ** 17, dtype=torch.float32)
    assert torch.equal(_pieces_sum(v, "i8"), to_i8(v))
    x = torch.tensor([2.0 ** 17 + 257])
    assert [float(p) for p in ck.split_bf16(x, stage="i8")] == \
        [2.0 ** 17, 256.0]
    assert float(_pieces_sum(x, "i8")) == float(x) - 1


def test_x8_one_piece_sums_back():
    """Every x in [-127, 127] and past it (the rule clamps), integer or
    not: the one piece is the staged value."""
    x = torch.cat([torch.arange(-127, 128, dtype=torch.float32),
                   torch.linspace(-600.0, 600.0, 4001)])
    (piece,) = ck.split_bf16(x, stage="x8")
    assert torch.equal(piece.to(torch.float32), to_x8(x))


# -- the decode of the packed codes ----------------------------------------

def _emitted_bytes(factor: int) -> torch.Tensor:
    """Every byte the packers emit: codes {0, 1, 3} in each of four 2-bit
    fields, or five base-3 digits (0..242)."""
    if factor == 4:
        vals = [sum(c << (2 * j) for j, c in enumerate(cs))
                for cs in itertools.product((0, 1, 3), repeat=4)]
    else:
        vals = range(3 ** 5)
    return torch.tensor(list(vals), dtype=torch.uint8)


def _word_bytes(word: torch.Tensor, j: int) -> torch.Tensor:
    return ((word >> (8 * j)) & 0xFF).to(torch.uint8).view(torch.int8)


@pytest.mark.parametrize("factor", [4, 5])
@pytest.mark.parametrize("position", [0, 1, 2, 3])
def test_swar_decode_every_emitted_byte(factor, position):
    """Each emitted byte, at each of a word's four byte positions (the
    others holding other emitted bytes), decodes to decode_fields' fields."""
    b = _emitted_bytes(factor)
    others = [b.roll(7 * (j + 1)) for j in range(4)]
    others[position] = b
    words = sum(o.to(torch.int64) << (8 * j) for j, o in enumerate(others))
    got = ck.swar_decode(words, factor)
    for f, want in enumerate(decode_fields(b, factor)):
        assert torch.equal(_word_bytes(got[f], position), want), f


@pytest.mark.parametrize("cls,kw", [
    ("BlockPackedTernary", {"factor": 4, "tile_kq": 40}),
    ("BlockPackedTernary", {"factor": 5, "tile_kq": 24}),
    ("PackedTernary2Bit", {}), ("PackedTernary53", {})])
def test_swar_decode_packed_container(cls, kw):
    """The words of a packed container decode to its dense weights."""
    W = tf.generate_ternary(300, 64, 3, seed=5)
    fmt = getattr(tf, cls).from_dense(W, **kw)
    F = kw.get("factor") or fmt.FACTOR
    packed = fmt.packed
    words = packed.view(torch.int32).to(torch.int64)     # (rows, N / 4)
    fields = [torch.stack([_word_bytes(w, j) for j in range(4)], -1)
              .reshape(packed.shape) for w in ck.swar_decode(words, F)]
    rows = fmt.tile_kq if "tile_kq" in kw else packed.shape[0]
    nb = packed.shape[0] // rows
    dense = torch.stack([f.view(nb, rows, -1) for f in fields], 1)
    assert torch.equal(dense.reshape(nb * F * rows, -1)[:300],
                       torch.from_numpy(W))


def _words(rows: np.ndarray) -> np.ndarray:
    """(R, C) bytes -> (R, C / 4) little-endian 32-bit words."""
    return (rows.reshape(rows.shape[0], -1, 4) <<
            (8 * np.arange(4))).sum(-1)


def bitplane_decode(pos: np.ndarray, neg: np.ndarray) -> list:
    """dense_mma.cuh ``Bitplane::decode`` on words of four columns of a pos
    and a neg byte-row: output o (bit o of each byte) is
    ``pbit | 0xFF * nbit``."""
    return [((pos >> o) & 0x01010101) | (((neg >> o) & 0x01010101) * 0xFF)
            for o in range(8)]


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_bitplane_decode_every_byte_pair(shift):
    """``bitplane_decode`` (the twin of ``Bitplane::decode``) on every pos /
    neg byte pair the packer emits (no bit set in both: 3**8 pairs), each
    at every byte position of a word (the columns shifted by ``shift``):
    output o holds, byte for byte, ``decode_planes``' weight of bit o."""
    digits = np.array(list(itertools.product((0, 1, 2), repeat=8)))
    bits = 1 << np.arange(8)
    pos = ((digits == 1) * bits).sum(1)
    neg = ((digits == 2) * bits).sum(1)
    cols = -(-(len(pos) + shift) // 4) * 4
    plane = np.zeros((1, 1, 2, cols), np.uint8)
    plane[0, 0, 0, shift:shift + len(pos)] = pos
    plane[0, 0, 1, shift:shift + len(pos)] = neg
    want = decode_planes(torch.from_numpy(plane), 1).numpy()   # (8, cols)
    outs = bitplane_decode(_words(plane[0, 0, :1].astype(np.int64)),
                           _words(plane[0, 0, 1:].astype(np.int64)))
    for o, d in enumerate(outs):
        got = ((d[..., None] >> (8 * np.arange(4))) & 0xFF).reshape(-1)
        assert np.array_equal(got.astype(np.uint8).view(np.int8), want[o]), o


def nibble_decode(words: np.ndarray) -> list:
    """dense_mma.cuh ``Nibble::decode`` on the words of four columns of a
    word row (``words[..., e]``: column e): a 4 x 4 byte transpose with
    byte permutes, then ``sign_bytes`` of each nibble; output o = 4h + j
    holds in byte e the weight of column e from nibble h of its byte j."""
    w = [words[..., e] for e in range(4)]
    lo01, hi01 = byte_perm(w[0], w[1], 0x5140), byte_perm(w[0], w[1], 0x7362)
    lo23, hi23 = byte_perm(w[2], w[3], 0x5140), byte_perm(w[2], w[3], 0x7362)
    t = [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
         byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]

    def sign_bytes(d):
        return (d & 0x01010101) | (((d >> 1) & 0x01010101) * 0xFF)

    return [sign_bytes(x) for x in t] + [sign_bytes(x >> 4) for x in t]


@pytest.mark.parametrize("column", [0, 1, 2, 3])
def test_nibble_decode_every_emitted_nibble(column):
    """``nibble_decode`` (the twin of ``Nibble::decode``) on groups of four
    columns whose word at ``column`` runs through every combination of
    the packer's nibbles (0x0, 0x1, 0xF: 3**8 words, so every nibble at
    every byte and half), the other columns' words other such words:
    output o, byte e, is ``decode_nibbles``' weight of dense row o of
    column e (one word row, tkb = 1)."""
    digits = np.array(list(itertools.product((0x0, 0x1, 0xF), repeat=8)))
    word = (digits << (4 * np.arange(8))).sum(1)     # nibble i: bits 4i..
    group = np.stack([np.roll(word, 11 * (e + 1)) for e in range(4)], 1)
    group[:, column] = word
    words = torch.from_numpy(group.reshape(1, 1, 1, -1).astype(np.uint32)
                             .view(np.int32))
    want = decode_nibbles(words).numpy()                # (8, 4 * groups)
    for o, d in enumerate(nibble_decode(group)):
        got = ((d[:, None] >> (8 * np.arange(4))) & 0xFF).reshape(-1)
        assert np.array_equal(got.astype(np.uint8).view(np.int8), want[o]), o


# -- the tile's lanes over the slab layout ----------------------------------

#: dense_mma.cuh's geometries over the slabs: (WM, WN, KC, MF); a warp
#: 16 * MF x 32, 8 warps, the 8 / (WM * WN) warps left over splitting each
#: chunk's k-steps; Narrow16 up to 16 rows of X, Narrow up to 32, Wide above
TILES = {"narrow16": (1, 1, 256, 1), "narrow": (1, 1, 256, 2),
         "wide": (2, 4, 128, 2)}

#: dense_mma.cuh's kSumSteps: k-steps the float rules sum into one zeroed
#: fragment
SUM_STEPS = 4
#: the X rules (ops/api.py) by stage
RULES = {"x8": to_x8, "i8": to_i8, "f32": to_f32, "bf16": to_bf16}


def _slabs(fmt):
    """(bytes, nb, gn, tkq, tile_n, trait) as the wrappers pass them; the
    trait (R, D, KDIV, NW, CB) is dense_mma.cuh's layout: R runs of D*KQ
    staged columns a chunk of KC / KDIV packed rows, NW planes of CB bytes
    a column."""
    if isinstance(fmt, tf.TiledBitplane):
        nb, gn = fmt.plane.shape[:2]
        return fmt.plane, nb, gn, fmt.tkb, fmt.tile_n, (2, 4, 8, 2, 1)
    if isinstance(fmt, tf.TiledNibblePair):
        nb, gn = fmt.words.shape[:2]
        return (fmt.words.view(torch.uint8), nb, gn, fmt.tkb, fmt.tile_n,
                (2, 4, 8, 1, 4))
    if isinstance(fmt, tf.DenseTernary):
        return (fmt.dense.view(torch.uint8), 1, 1, fmt.K, fmt.N,
                (1, 1, 1, 1, 1))
    if isinstance(fmt, tf.TiledDenseTernary):
        gk, gn = fmt.tiles.shape[:2]
        return (fmt.tiles.view(torch.uint8), gk, gn, fmt.tile_k, fmt.tile_n,
                (1, 1, 1, 1, 1))
    if isinstance(fmt, tf.BlockPackedTernary):
        return (fmt.packed, fmt.packed.shape[0] // fmt.tile_kq, 1,
                fmt.tile_kq, fmt.N, (fmt.factor, 1, 4, 1, 1))
    if isinstance(fmt, tf.TiledBlockPacked):
        nb, gn = fmt.tiles.shape[:2]
        return (fmt.tiles, nb, gn, fmt.tile_kq, fmt.tile_n,
                (fmt.factor, 1, 4, 1, 1))
    return (fmt.packed, 1, 1, fmt.packed.shape[0], fmt.N,
            (fmt.FACTOR, 1, 4, 1, 1))


def _decode(raw: list, R: int, D: int, KQ: int, BN: int,
            CB: int) -> np.ndarray:
    """The chunk's decoded W rows (R*D*KQ, BN) from its NW planes of raw
    bytes (KQ, CB*BN): output o of packed row r lands on row (o // D) * D*KQ
    + D*r + o % D."""
    if R * D == 1:
        return raw[0]
    if CB == 4:         # a word a column, groups of four columns
        outs = nibble_decode(_words(raw[0]).reshape(KQ, BN // 4, 4))
    elif len(raw) == 2:
        outs = bitplane_decode(_words(raw[0]), _words(raw[1]))
    else:
        outs = [d.numpy() for d in
                ck.swar_decode(torch.from_numpy(_words(raw[0])), R)]
    ws = np.zeros((R * D * KQ, BN), np.int64)
    for o, d in enumerate(outs):
        rows = (o // D) * D * KQ + D * np.arange(KQ) + o % D
        ws[rows] = ((d[..., None] >> (8 * np.arange(4))) & 0xFF
                    ).reshape(KQ, BN)
    return ws


def emulate_slabs(X: np.ndarray, fmt, stage: str, tile: str) -> np.ndarray:
    """stage(X) (M, K) times the container's W as the tile's lanes compute
    it (``csrc/dense_mma.cuh``: ``stage_chunk``, ``dense_tile``): the exact
    rules (x8, i8) sum every k-step straight into the accumulators; the
    float ones (f32, bf16) each group of at most ``SUM_STEPS`` of a warp's
    k-steps into a zeroed fragment (exact here), rounded to f32 as it is
    added to the f32 accumulator."""
    WM, WN, KC, MF = TILES[tile]
    WK, BM, BN = 8 // (WM * WN), 16 * MF * WM, 32 * WN
    data, nb, gn, tkq, tile_n, (R, D, KDIV, NW, CB) = _slabs(fmt)
    flat = data.reshape(-1).numpy().astype(np.int64)
    KQ = KC // KDIV                      # packed rows a chunk
    RL = D * KQ                          # staged columns a run
    CW = R * RL                          # staged columns, decoded W rows
    KS, NJ = CW // 16, -(-CW // 16 // WK)
    exact = stage in ("x8", "i8")
    PS = NJ if exact or NJ < SUM_STEPS else SUM_STEPS
    groups = [range(s0, min(s0 + PS, NJ)) for s0 in range(0, NJ, PS)]
    assert max(len(grp) for grp in groups) <= SUM_STEPS or exact
    M, (K, N) = X.shape[0], fmt.shape
    pieces = [p.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
              for p in ck.split_bf16(torch.from_numpy(X), stage=stage)]
    NP = len(pieces)

    def dense_row(kb, q0, c):
        """The dense row of staged column c, or None past its run or K."""
        run, q = divmod(c, RL)
        k = kb * R * D * tkq + run * D * tkq + D * q0 + q
        return k if D * q0 + q < D * tkq and k < K else None

    Y = np.zeros((M, N))
    for m0 in range(0, M, BM):
        rows = min(BM, M - m0)
        for n0 in range(0, N, BN):
            g = n0 // tile_n
            cols = min(BN, N - n0)
            acc = np.zeros((8, MF, 4, 4, 32),
                           np.float64 if exact else np.float32)
            for kb in range(nb):
                base = CB * ((kb * gn + g) * NW * tkq * tile_n + n0 -
                             g * tile_n)
                for q0 in range(0, tkq, KQ):
                    xs = np.zeros((NP, BM, CW), np.int64)
                    for c in range(CW):
                        k = dense_row(kb, q0, c)
                        if k is not None:
                            for p in range(NP):
                                xs[p, :rows, c] = pieces[p][m0:m0 + rows, k]
                    raw = [np.zeros((KQ, CB * BN), np.int64)
                           for _ in range(NW)]
                    for r in range(min(KQ, tkq - q0)):
                        for p in range(NW):
                            at = base + CB * (p * tkq + q0 + r) * tile_n
                            raw[p][r, :CB * cols] = flat[at:at + CB * cols]
                    ws = _decode(raw, R, D, KQ, BN, CB)
                    for warp in range(8):
                        wk, wmn = warp // (WM * WN), warp % (WM * WN)
                        wm, wn = 16 * MF * (wmn // WN), 32 * (wmn % WN)
                        for grp in groups:
                            part = np.zeros((MF, 4, 4, 32))
                            for j in grp:
                                ks = 16 * (wk + j * WK)
                                if ks >= CW or dense_row(kb, q0, ks) is None:
                                    continue

                                def word(row):
                                    c4 = wn + 4 * G[:, None] + np.arange(4)
                                    return (ws[row[:, None], c4] <<
                                            (8 * np.arange(4))).sum(1)

                                b0 = b_pairs(word(ks + 2 * T4),
                                             word(ks + 2 * T4 + 1))
                                b1 = b_pairs(word(ks + 2 * T4 + 8),
                                             word(ks + 2 * T4 + 9))
                                for i in range(MF):
                                    for p in range(NP):
                                        a = []
                                        for ro, co in [(0, 0), (8, 0),
                                                       (0, 8), (8, 8)]:
                                            row = wm + 16 * i + ro + G
                                            col = ks + co + 2 * T4
                                            a.append(xs[p, row, col] |
                                                     xs[p, row, col + 1]
                                                     << 16)
                                        for f8 in range(4):
                                            mma(part[i, f8], a,
                                                (b0[f8], b1[f8]))
                            if exact:
                                acc[warp] += part
                            else:
                                acc[warp] = (acc[warp] + part.astype(
                                    np.float32)).astype(np.float32)
            red = np.zeros((WK, BM, BN))
            for warp in range(8):
                wk, wmn = warp // (WM * WN), warp % (WM * WN)
                wm, wn = 16 * MF * (wmn // WN), 32 * (wmn % WN)
                for i in range(MF):
                    for f8 in range(4):
                        for r in range(4):
                            red[wk, wm + 16 * i + G + 8 * (r >> 1),
                                wn + 8 * T4 + 4 * (r & 1) + f8] = \
                                acc[warp, i, f8, r]
            Y[m0:m0 + rows, n0:n0 + cols] = red.sum(0)[:rows, :cols]
    return Y


#: layout -> (container class, K, N, packer arguments, X rules of its
#: kernels): every slab layout the wrappers launch, each with a ragged
#: edge (K = 100 under the Narrow chunk; a field's tkq not a multiple of
#: 16: 40, 24, and the stride-packed 250 and 200 at K = 999; gn = 2; the
#: bit planes' and the nibbles' tkb = 16 under the 32-row chunk at K =
#: 100, K = 999 in one 1024-row block of two slabs, and four blocks of tkb
#: = 32)
LAYOUTS = {
    "dense": ("DenseTernary", 300, 40, {}, ("i8",)),
    "tiled_k100": ("TiledDenseTernary", 100, 200, {"tile_n": 128},
                   ("i8", "x8")),
    "tiled": ("TiledDenseTernary", 300, 130, {"tile_n": 128}, ("i8", "x8")),
    "blockpacked_f4": ("BlockPackedTernary", 300, 40,
                       {"factor": 4, "tile_kq": 40}, ("i8",)),
    "blockpacked_f5": ("BlockPackedTernary", 300, 40,
                       {"factor": 5, "tile_kq": 24}, ("i8",)),
    "tiled_blockpacked_f4": ("TiledBlockPacked", 300, 200,
                             {"factor": 4, "tile_kq": 40, "tile_n": 128},
                             ("i8",)),
    "tiled_blockpacked_f5": ("TiledBlockPacked", 300, 200,
                             {"factor": 5, "tile_kq": 24, "tile_n": 128},
                             ("i8",)),
    "packed2": ("PackedTernary2Bit", 999, 40, {}, ("i8", "f32")),
    "packed53": ("PackedTernary53", 999, 40, {}, ("i8", "f32")),
    "bitplane_k100": ("TiledBitplane", 100, 40, {}, ("bf16",)),
    "bitplane": ("TiledBitplane", 999, 200, {"tile_n": 128}, ("bf16",)),
    "bitplane_tkb32": ("TiledBitplane", 999, 130,
                       {"tkb": 32, "tile_n": 128}, ("bf16",)),
    "nibble_k100": ("TiledNibblePair", 100, 40, {}, ("i8",)),
    "nibble": ("TiledNibblePair", 999, 200, {"tile_n": 128}, ("i8",)),
    "nibble_tkb32": ("TiledNibblePair", 999, 130,
                     {"tkb": 32, "tile_n": 128}, ("i8",)),
}
CASES = [(layout, stage) for layout, spec in sorted(LAYOUTS.items())
         for stage in spec[4]]


def test_layouts_are_ragged():
    """The tkq and tile_k of the cases above are what the docstring says."""
    tk = {n: _slabs(getattr(tf, c).from_dense(
        tf.generate_ternary(K, N, 3, seed=0), **kw))[3]
          for n, (c, K, N, kw, _) in LAYOUTS.items()}
    assert tk["tiled_k100"] == 128 and tk["packed2"] == 250 \
        and tk["packed53"] == 200
    assert all(t % 16 for n, t in tk.items() if "packed" in n)
    for what in ("bitplane", "nibble"):
        assert (tk[f"{what}_k100"], tk[what], tk[f"{what}_tkb32"]) == \
            (16, 128, 32)


@pytest.mark.parametrize("layout,stage", CASES)
@pytest.mark.parametrize("tile,M", [("narrow16", 7), ("narrow", 20),
                                    ("wide", 40)])
@pytest.mark.parametrize("kind", ["integer", "non-integer"])
def test_tile_lanes_give_rule_x_w(layout, stage, tile, M, kind):
    """The emulated lanes give rule(X) @ W, W the container decoded by the
    packers' own decoders: exactly on integer X with the domain's edges,
    and on non-integer X for the rules that round or floor it to integers;
    within rtol=1e-5, atol=1e-3 (phase 6's bound) on non-integer X for
    the float rules, whose groups are rounded to f32."""
    cls, K, N, kw, _ = LAYOUTS[layout]
    W = tf.generate_ternary(K, N, 3, seed=K + N)
    fmt = getattr(tf, cls).from_dense(W, **kw)
    dense = fmt.to_dense().numpy().astype(np.float64)
    assert np.array_equal(dense, W)
    vr = {"x8": 127, "bf16": 256}.get(stage, 512)
    rng = np.random.default_rng(M * K)
    if kind == "integer":
        X = rng.integers(-vr, vr + 1, (M, K)).astype(np.float32)
        X[:, ::5], X[:, 2::5] = vr, -vr
    elif stage in ("x8", "i8"):   # x8 past its clamp, i8 inside its domain
        hi = 1.3 * vr if stage == "x8" else vr - 0.01
        X = rng.uniform(-hi, hi, (M, K)).astype(np.float32)
    else:                         # the float rules: uniform in +-2
        X = rng.uniform(-2, 2, (M, K)).astype(np.float32)
    want = RULES[stage](torch.from_numpy(X)).double().numpy() @ dense
    got = emulate_slabs(X, fmt, stage, tile)
    if kind == "integer" or stage in ("x8", "i8"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
