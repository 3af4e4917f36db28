"""The bf16 tensor-core tile of ``CudaDense`` and ``CudaDense_bf16``
(``csrc/dense_mma.cuh``, also the ring's products), on the CPU.

* ``ops.cuda_kernels.split_bf16``, the Python twin of the tile's split of
  f32 X into bf16 pieces: three pieces sum back to x bitwise on the domain
  its docstring states (two do not in general); what the split does at the
  domain's edges (near FLT_MAX, near the smallest normals) and on
  non-finite x.
* The passes ``sum_p piece_p @ W`` in f32: bitwise the plain versions on
  integer X, within rtol=1e-5, atol=1e-3 off the integers, and equal to the
  JAX Pallas kernels (``PallasDense`` / ``PallasDense_bf16``, interpret
  mode) on the same inputs.
* A numpy emulation of the tile's lanes — the staged chunks, ``ldmatrix``
  A registers, the B registers that ``b_pairs`` interleaves from four
  words of W with byte permutes, ``mma.sync`` m16n8k16 and the epilogue's
  column map, for both geometries — gives ``X @ W`` exactly on integer X.

The tile itself runs only on the card (``tests/test_torch_cuda.py``, ``-k
"dense_mma or ring"``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.ops import get_kernel as jget
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops.api import finish, to_bf16

F32_MAX = float(np.finfo(np.float32).max)
#: the bf16 overflow threshold: from here on bf16(x) rounds to inf
BF16_INF_FROM = float.fromhex("0x1.FFp127")


def _pieces_sum(x: torch.Tensor, pieces: int) -> torch.Tensor:
    """The pieces added back in f32, largest first (each add exact on the
    split's domain)."""
    out = torch.zeros_like(x)
    for p in ck.split_bf16(x, pieces):
        out = out + p.to(torch.float32)
    return out


def _domain_x(kind: str, seed: int, n: int = 4096) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "integer":
        x = rng.integers(-512, 513, n).astype(np.float32)
        x[:: 9], x[4:: 9] = 512.0, -512.0
    elif kind == "uniform":
        x = rng.uniform(-2, 2, n).astype(np.float32)
    else:   # magnitudes from 1e-30 to 1e30, either sign, every mantissa
        x = (10.0 ** rng.uniform(-30, 30, n) * rng.choice([-1, 1], n)
             ).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["integer", "uniform", "magnitudes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_pieces_sum_back(kind, seed):
    """hi + mid + lo == x bitwise, each piece a bf16 value, the pieces
    non-increasing in magnitude."""
    x = _domain_x(kind, seed)
    assert torch.equal(_pieces_sum(x, 3), x)
    hi, mid, lo = (p.to(torch.float32).abs() for p in ck.split_bf16(x, 3))
    assert bool((mid <= hi).all()) and bool((lo <= mid).all())


def test_two_pieces_do_not_suffice():
    """x = 1 + 2**-9 + 2**-18 + 2**-23 has 24 significant bits and bf16
    keeps 8: hi = 1, mid = 2**-9, and 2**-18 + 2**-23 needs a third piece;
    so does some x of U(-2, 2)."""
    x = torch.tensor([1 + 2 ** -9 + 2 ** -18 + 2 ** -23], dtype=torch.float32)
    assert float(x) == 1 + 2 ** -9 + 2 ** -18 + 2 ** -23     # exact in f32
    assert not torch.equal(_pieces_sum(x, 2), x)
    assert torch.equal(_pieces_sum(x, 3), x)
    u = _domain_x("uniform", 0)
    assert not torch.equal(_pieces_sum(u, 2), u)


def test_one_piece_is_bf16_rounding():
    """One piece is X rounded to bf16 (nearest even): CudaDense_bf16's X,
    ``ops.api.to_bf16``."""
    x = torch.cat([_domain_x(k, 3) for k in ("integer", "uniform",
                                             "magnitudes")])
    assert torch.equal(ck.split_bf16(x, 1)[0].to(torch.float32), to_bf16(x))


@pytest.mark.parametrize("x,exact", [
    (float.fromhex("0x1.FEFFFEp127"), True),    # the largest x below it
    (BF16_INF_FROM, False),
    (F32_MAX, False),
    (-F32_MAX, False),
])
def test_split_near_f32_max(x, exact):
    """Up to just under 0x1.FFp127 the split is exact; from there to
    FLT_MAX hi rounds to +-inf, and mid = lo = 0 (so the product is +-inf
    or NaN where the plain f32 product is finite)."""
    t = torch.tensor([x], dtype=torch.float32)
    hi, mid, lo = (p.to(torch.float32) for p in ck.split_bf16(t, 3))
    if exact:
        assert bool(torch.isfinite(hi).all())
        assert torch.equal(hi + mid + lo, t)
    else:
        assert float(hi) == float("inf") * np.sign(x)
        assert float(mid) == 0.0 and float(lo) == 0.0


@pytest.mark.parametrize("x,total", [
    (2.0 ** -110 * (1 + 2 ** -23), None),       # lowest bit 2**-133: exact
    (2.0 ** -110 * (1 + 2 ** -9 + 2 ** -23), None),
    (2.0 ** -111 * (1 + 2 ** -23), 2.0 ** -111),    # lowest bit 2**-134
    (2.0 ** -126 * (1 + 2 ** -23), 2.0 ** -126),    # the smallest normals
    (2.0 ** -126 * (1 + 2 ** -7), None),        # 8 bits: hi alone
    (2.0 ** -133, None),                        # bf16's smallest subnormal
    (2.0 ** -140, 0.0),                         # under it: every piece 0
])
def test_split_near_smallest_normals(x, total):
    """Near 2**-126 the pieces go subnormal, and bf16's smallest subnormal
    is 2**-133: the bits of x under it are lost (the pieces sum to
    ``total``; None: to x, exactly)."""
    t = torch.tensor([x], dtype=torch.float32)
    assert float(t) == x
    assert float(_pieces_sum(t, 3)) == (x if total is None else total)


@pytest.mark.parametrize("v", [float("inf"), float("-inf"), float("nan")])
def test_split_non_finite(v):
    """hi = x, mid = lo = 0."""
    hi, mid, lo = ck.split_bf16(torch.tensor([v, 1.5]), 3)
    hi = hi.to(torch.float32)
    assert (bool(torch.isnan(hi[0])) if v != v else float(hi[0]) == v)
    assert float(mid[0]) == 0.0 and float(lo[0]) == 0.0
    assert float(hi[1]) == 1.5


def test_split_rejects_piece_count():
    with pytest.raises(ValueError, match="pieces"):
        ck.split_bf16(torch.ones(2), 4)


# -- the passes, against the plain versions and the JAX kernels ------------

#: stage -> (pieces, the port's plain version, the JAX kernel, integer |x|
#: range in which every value and partial sum is exact)
STAGES = {"f32": (3, ck.dense_plain, "PallasDense", 512),
          "bf16": (1, ck.dense_bf16_plain, "PallasDense_bf16", 256)}


def passes(X: torch.Tensor, fmt, bias, alpha, pieces: int) -> torch.Tensor:
    """``sum_p piece_p @ W`` in f32, then the epilogue: the tile's
    arithmetic, each pass an f32 matmul of exact products."""
    W = fmt.to_dense().to(torch.float32)
    Y = torch.zeros((X.shape[0], fmt.N), dtype=torch.float32)
    for p in ck.split_bf16(X, pieces):
        Y = Y + p.to(torch.float32) @ W
    return finish(Y, bias, alpha)


def _stage_case(stage, M, K, N, kind, prelu):
    vr = STAGES[stage][3]
    W = jf.generate_ternary(K, N, 3, seed=K + N)
    rng = np.random.default_rng(M + K)
    if kind == "integer":
        X = rng.integers(-vr, vr + 1, (M, K)).astype(np.float32)
        X[:, ::7], X[:, 3::7] = vr, -vr
    else:
        X = rng.uniform(-2, 2, (M, K)).astype(np.float32)
    b = rng.uniform(-4, 4, N).astype(np.float32)
    a = rng.uniform(0.01, 0.5, N).astype(np.float32) if prelu else None
    return W, X, b, a


@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("M,K,N", [(7, 999, 40), (32, 256, 128)])
@pytest.mark.parametrize("kind", ["integer", "non-integer"])
@pytest.mark.parametrize("prelu", [False, True])
def test_passes_equal_plain_and_pallas(stage, M, K, N, kind, prelu):
    """The passes against the port's plain version and the JAX Pallas
    kernel: bitwise on integer X, within rtol=1e-5, atol=1e-3 off it."""
    pieces, plain, jname, _ = STAGES[stage]
    W, X, b, a = _stage_case(stage, M, K, N, kind, prelu)
    fmt = tf.DenseTernary.from_dense(W)
    tX, tb = torch.from_numpy(X), torch.from_numpy(b)
    ta = None if a is None else torch.from_numpy(a)
    got = passes(tX, fmt, tb, ta, pieces).numpy()
    want = plain(tX, fmt, tb, ta).numpy()
    jax_y = np.asarray(jget(jname)(
        jnp.asarray(X), jf.DenseTernary.from_dense(W), jnp.asarray(b),
        None if a is None else jnp.asarray(a)))
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_y)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got, jax_y, rtol=1e-5, atol=1e-3)


# -- the tile's lanes -------------------------------------------------------

#: dense_mma.cuh's geometries: (WM, WN, KC); a warp 32 x 32, 8 warps, the
#: 8 / (WM * WN) warps left over splitting each chunk's k-steps
TILES = {"narrow": (1, 1, 256), "wide": (2, 4, 128)}
LANE = np.arange(32, dtype=np.int64)   # registers as int64 lane vectors
G, T4 = LANE >> 2, LANE & 3


def byte_perm(x, y, s: int):
    """CUDA's ``__byte_perm`` for selectors of nibbles 0-7."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def b_pairs(ra, rb):
    """dense_mma.cuh ``b_pairs``, on lane vectors."""
    lo, hi = byte_perm(ra, rb, 0x5140), byte_perm(ra, rb, 0x7362)
    nl, nh = lo & 0x01010101, hi & 0x01010101
    hl = (nl * 0x3F + (lo & 0x80808080)) & 0xFFFFFFFF
    hh = (nh * 0x3F + (hi & 0x80808080)) & 0xFFFFFFFF
    ll, lh = nl << 7, nh << 7
    return [byte_perm(ll, hl, 0x5140), byte_perm(ll, hl, 0x7362),
            byte_perm(lh, hh, 0x5140), byte_perm(lh, hh, 0x7362)]


def bf16_value(bits):
    """The value of a bf16 bit pattern (low 16 bits of ``bits``)."""
    low = (np.asarray(bits, np.int64) & 0xFFFF).astype(np.uint32)
    return (low << np.uint32(16)).view(np.float32).astype(np.float64)


def mma(c, a, b):
    """mma.sync m16n8k16 .row.col, bf16 in, sums in f64 (exact here): lane
    (g, t)'s A registers hold rows g, g + 8 and columns 2t, 2t + 8 (two k
    each, low half first), its B registers k 2t and 2t + 8 (two each) of
    column g, its C registers rows g, g + 8 and columns 2t, 2t + 1."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for j, (ro, co) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
        for h in range(2):
            A[G + ro, 2 * T4 + co + h] = bf16_value(a[j] >> (16 * h))
    for j in range(2):
        for h in range(2):
            B[2 * T4 + 8 * j + h, G] = bf16_value(b[j] >> (16 * h))
    D = A @ B
    for r in range(4):
        c[r] += D[G + 8 * (r >> 1), 2 * T4 + (r & 1)]


def emulate_tile(X: np.ndarray, W: np.ndarray, pieces: int, tile: str):
    """X (M, K) f32 times W (K, N) int8 as the tile's lanes compute it."""
    WM, WN, KC = TILES[tile]
    WK, BM, BN = 8 // (WM * WN), 32 * WM, 32 * WN
    M, K = X.shape
    N = W.shape[1]
    split = [p.view(torch.int16).numpy().astype(np.uint16)
             for p in ck.split_bf16(torch.from_numpy(X), pieces)]
    Y = np.zeros((M, N))
    for m0 in range(0, M, BM):
        for n0 in range(0, N, BN):
            red = np.zeros((WK, BM, BN))
            acc = np.zeros((8, 2, 4, 4, 32))   # warp, i, f, r, lane
            for k0 in range(0, K, KC):
                xs = np.zeros((pieces, BM, KC), np.int64)
                ws = np.zeros((KC, BN), np.int64)
                r, c = min(BM, M - m0), min(KC, K - k0)
                for q in range(pieces):
                    xs[q, :r, :c] = split[q][m0:m0 + r, k0:k0 + c]
                ws[:c, :min(BN, N - n0)] = \
                    W[k0:k0 + c, n0:n0 + BN].astype(np.uint8)
                for warp in range(8):
                    wk, wmn = warp // (WM * WN), warp % (WM * WN)
                    wm, wn = 32 * (wmn // WN), 32 * (wmn % WN)
                    for s in range(KC // 16 // WK):
                        ks = 16 * (wk + s * WK)

                        def word(row):
                            cols = wn + 4 * G[:, None] + np.arange(4)
                            return (ws[row[:, None], cols] <<
                                    (8 * np.arange(4))).sum(1)

                        b0 = b_pairs(word(ks + 2 * T4), word(ks + 2 * T4 + 1))
                        b1 = b_pairs(word(ks + 2 * T4 + 8),
                                     word(ks + 2 * T4 + 9))
                        for i in range(2):
                            for q in range(pieces):
                                a = []
                                for ro, co in [(0, 0), (8, 0), (0, 8), (8, 8)]:
                                    row = wm + 16 * i + ro + G
                                    col = ks + co + 2 * T4
                                    a.append(xs[q, row, col] |
                                             xs[q, row, col + 1] << 16)
                                for f in range(4):
                                    mma(acc[warp, i, f], a, (b0[f], b1[f]))
            for warp in range(8):
                wk, wmn = warp // (WM * WN), warp % (WM * WN)
                wm, wn = 32 * (wmn // WN), 32 * (wmn % WN)
                for i in range(2):
                    for f in range(4):
                        for r in range(4):
                            red[wk, wm + 16 * i + G + 8 * (r >> 1),
                                wn + 8 * T4 + 4 * (r & 1) + f] = \
                                acc[warp, i, f, r]
            tile_y = red.sum(0)
            r, c = min(BM, M - m0), min(BN, N - n0)
            Y[m0:m0 + r, n0:n0 + c] = tile_y[:r, :c]
    return Y


@pytest.mark.parametrize("tile,M,K,N", [("narrow", 7, 300, 40),
                                        ("narrow", 32, 47, 64),
                                        ("wide", 40, 150, 130)])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_tile_lanes_give_x_w(tile, M, K, N, stage):
    """The emulated lanes give X @ W exactly on integer X with the
    domain's edges: K past the last k-step and over one chunk, N past the
    last n8 fragment and tile, M past the last m16 fragment."""
    pieces, _, _, vr = STAGES[stage]
    W = jf.generate_ternary(K, N, 3, seed=K * N)
    rng = np.random.default_rng(K)
    X = rng.integers(-vr, vr + 1, (M, K)).astype(np.float32)
    X[:, ::5], X[:, 2::5] = vr, -vr
    got = emulate_tile(X, W, pieces, tile)
    want = X.astype(np.float64) @ W.astype(np.float64)
    np.testing.assert_array_equal(got, want)


def test_b_pairs_bit_patterns():
    """Every (row k, row k + 1) pair of weights of one column decodes to
    bf16(w_k) | bf16(w_k1) << 16, for all nine pairs in each byte lane."""
    vals = [0, 1, -1]
    want = {0: 0x0000, 1: 0x3F80, -1: 0xBF80}
    for f in range(4):
        for wa in vals:
            for wb in vals:
                ra = np.array([(wa & 0xFF) << (8 * f)], np.int64)
                rb = np.array([(wb & 0xFF) << (8 * f)], np.int64)
                got = int(b_pairs(ra, rb)[f][0])
                assert got == want[wa] | want[wb] << 16, (f, wa, wb)
