"""The tensor-core branches of the i8 kernel and the fused SwiGLU, on the
CPU: above ``I8_MMA_MIN_M`` / ``SWIGLU_MMA_MIN_M`` rows the wrappers still
equal the JAX Pallas kernels (in interpret mode) on a CPU tensor, where they
take the plain versions; every branch is CUDA-only; the int8 scratches have
the sizes their CUDA source (``csrc/bitplane_mma.cuh``) writes; and a numpy
emulation of that source's arithmetic — the i8 split ``32*hi + lo``, the
``32w`` B registers, the ``ldmatrix`` and ``mma.sync`` m16n8k32 fragment
lanes over a staged chunk loop — gives ``to_i8(X) @ W`` exactly. The
branches themselves run only on the card (``tests/test_torch_cuda.py``,
``-k "i8_ or swiglu"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.ops import fused_ffn as jffn
from ternary_spgemm_tpu.ops import get_kernel as jget
from ternary_spgemm_tpu.ops import ternary_spgemm as jspgemm
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops import fused_ffn as tffn

GAMMAS = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.7)


def _i8_x(M, K, kind):
    """Integer X in +-512 with both edges on every seventh column, or
    non-integer X (floored by the i8 rule)."""
    if kind == "edges":
        X = jf.generate_x(M, K, seed=M + K, value_range=512)
        X[:, ::7], X[:, 3::7] = 512.0, -512.0
        return X.astype(np.float32)
    rng = np.random.default_rng(M + K)
    return rng.uniform(-511.9, 511.9, size=(M, K)).astype(np.float32)


@pytest.mark.parametrize("rows", [1, 28])
@pytest.mark.parametrize("K,N,kw", [(300, 260, {"tile_n": 128}),
                                    (999, 77, {"tkb": 20})])
@pytest.mark.parametrize("prelu", [False, True])
@pytest.mark.parametrize("kind", ["edges", "floored"])
def test_i8_above_split_equals_pallas(rows, K, N, kw, prelu, kind):
    """M = I8_MMA_MIN_M + rows: exact equality with
    PallasTiledBitplane_i8."""
    M = ck.I8_MMA_MIN_M + rows
    W = jf.generate_ternary(K, N, 3, seed=K + M)
    jfmt = jf.TiledBitplane.from_dense(W, **kw)
    tfmt = tf.TiledBitplane.from_dense(W, **kw)
    X = _i8_x(M, K, kind)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    want = np.asarray(jget("PallasTiledBitplane_i8")(
        jnp.asarray(X), jfmt, jnp.asarray(b),
        None if a is None else jnp.asarray(a)))
    ck.reset_counts()
    got = ck.cuda_tiled_bitplane_i8_kernel(
        torch.from_numpy(X), tfmt, torch.from_numpy(b),
        None if a is None else torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not ck.launches and not ck.plain_on_cuda   # CPU: plain version


@pytest.mark.parametrize("K,N1,N2,tile_n", [(128, 256, 128, 128),
                                            (200, 300, 96, 128),
                                            (128, 256, 128, 4096)])
def test_swiglu_above_split_matches_jax(K, N1, N2, tile_n):
    """M = SWIGLU_MMA_MIN_M + 1 against JAX's fused_bitplane_swiglu in
    interpret mode: the requantized hidden identical, the outputs within
    the JAX fused-FFN tests' tolerance (rtol=1e-5, atol=0.01)."""
    M = tffn.SWIGLU_MMA_MIN_M + 1
    Ws = [jf.generate_ternary(K, N1, 4, seed=1), jf.generate_ternary(K, N1, 4, seed=2),
          jf.generate_ternary(N1, N2, 4, seed=3)]
    tiles = [tile_n, tile_n, 4096]
    jfmts = [jf.TiledBitplane.from_dense(W, tile_n=t) for W, t in zip(Ws, tiles)]
    tfmts = [tf.TiledBitplane.from_dense(W, tile_n=t) for W, t in zip(Ws, tiles)]
    x = jf.generate_x(M, K, seed=4)
    jxq, jsx = jffn.requantize_rows(jnp.asarray(x))
    txq, tsx = tffn.requantize_rows(torch.from_numpy(x))
    ck.reset_counts()
    got = tffn.fused_bitplane_swiglu(txq, tsx, *tfmts, **GAMMAS).numpy()
    assert not ck.launches
    want = np.asarray(jffn.fused_bitplane_swiglu(jxq, jsx, *jfmts, **GAMMAS))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.01)
    th = tffn.swiglu_hidden_plain(txq, tsx, tfmts[0], tfmts[1],
                                  gamma_gate=GAMMAS["gamma_gate"],
                                  gamma_up=GAMMAS["gamma_up"])
    zg, k = jnp.zeros((N1,), jnp.float32), "PallasTiledBitplane_i8"
    jg = GAMMAS["gamma_gate"] * (jsx * jspgemm(jxq, jfmts[0], zg, kernel=k))
    ju = GAMMAS["gamma_up"] * (jsx * jspgemm(jxq, jfmts[1], zg, kernel=k))
    jhq, _ = jffn.requantize_rows(jax.nn.silu(jg) * ju)
    np.testing.assert_array_equal(tffn.requantize_rows(th)[0].numpy(),
                                  np.asarray(jhq))


@pytest.mark.parametrize("M,device,branch", [
    (1, "cuda", "decode"), (32, "cuda", "decode"), (33, "cuda", "mma"),
    (512, "cuda", "mma"), (4, "cpu", "plain"), (512, "cpu", "plain")])
def test_i8_split_rule(M, device, branch):
    """On the card the decode branch up to I8_MMA_MIN_M = 32 rows (at any
    K), the tensor-core branch above; the plain version on the CPU."""
    assert ck.I8_MMA_MIN_M == 32
    assert ck.i8_branch(M, device) == branch


@pytest.mark.parametrize("branch", ["_bitplane_i8_lanes", "_bitplane_i8_mma"])
def test_i8_branches_need_cuda(branch):
    fmt = tf.TiledBitplane.from_dense(jf.generate_ternary(64, 64, 2, seed=0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(ck, branch)(torch.zeros((40, 64)), fmt, torch.zeros(64))


@pytest.mark.parametrize("branch", ["_swiglu_lanes", "_swiglu_mma"])
def test_swiglu_branches_need_cuda(branch):
    fg, fu = (tf.TiledBitplane.from_dense(jf.generate_ternary(64, 128, 2, seed=s))
              for s in (0, 1))
    fd = tf.TiledBitplane.from_dense(jf.generate_ternary(128, 64, 2, seed=2))
    xq, sx = tffn.requantize_rows(torch.ones((40, 64)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tffn, branch)(xq, sx, fg, fu, fd)


@pytest.mark.parametrize("K,tkb,row_bytes", [
    (4096, None, 4 * 2 * 512),     # tkb 128: halves of 512, no padding
    (300, None, 1 * 2 * 256),      # tkb 48: halves of 192 padded to 256
    (999, 20, 7 * 2 * 128)])       # tkb 20: halves of 80 padded to 128
def test_i8_mma_scratch_row_bytes(K, tkb, row_bytes):
    """The i8 branch stages two planes of X (hi, lo) of one row pitch each:
    the scratch the wrapper passes holds 2 x mma_row_bytes a row."""
    fmt = tf.TiledBitplane.from_dense(jf.generate_ternary(K, 64, 2, seed=1),
                                      tkb=tkb)
    assert ck.mma_row_bytes(fmt) == row_bytes
    seen = {}

    def fake_launch(*args, scratch_row_bytes=0, counts=(), **kw):
        seen.update(rows=scratch_row_bytes, counts=counts)

    real, ck._launch = ck._launch, fake_launch
    try:
        ck._bitplane_i8_mma(torch.zeros((3, K)), fmt, torch.zeros(64))
    finally:
        ck._launch = real
    assert seen == {"rows": 2 * row_bytes, "counts": (ck.I8_MMA_COUNT,)}


@pytest.mark.parametrize("K,N1,N2,tkb1,want", [
    (4096, 2100, 512, None, (4 * 2 * 512, 3 * 2 * 512)),      # tkb 128
    (200, 300, 96, None, (1 * 2 * 128, 1 * 2 * 256)),         # tkb 32, 48
    (999, 300, 96, 20, (7 * 2 * 128, 1 * 2 * 256))])
def test_swiglu_mma_scratch_row_bytes(K, N1, N2, tkb1, want):
    """xq staged for the gate and up containers, the requantized h for the
    down container: each K-block's halves padded to a multiple of 128."""
    fg = tf.TiledBitplane.from_dense(jf.generate_ternary(K, N1, 2, seed=1),
                                     tkb=tkb1)
    fd = tf.TiledBitplane.from_dense(jf.generate_ternary(N1, N2, 2, seed=2))
    assert tffn.swiglu_mma_row_bytes(fg, fd) == want


# -- numpy emulation of the tensor-core core's arithmetic --------------------

_U32 = 0xFFFFFFFF


def ternary4(p, n):
    """``bitplane_mma.cuh::ternary4`` on uint32 words."""
    sp = (np.uint64(p) * 0x00204081) & 0x01010101
    sn = (np.uint64(n) * 0x00204081) & 0x01010101
    return int((((sp | 0x80808080) - sn) ^ 0x80808080) & _U32)


def times32(b):
    """``bitplane_mma.cuh::times32``."""
    return (b << 5) & 0xE0E0E0E0


def int8s(word):
    """The four int8 bytes of a uint32 register, little-endian."""
    return np.array([word & _U32], dtype=np.uint32).view(np.int8)


def word(four):
    """Four int8 values as one uint32 register."""
    return int(np.asarray(four, dtype=np.int8).view(np.uint32)[0])


def test_i8_split_exact():
    """v = 32 * (v >> 5) + (v & 31) for every integer v in [-512, 512], hi
    in [-16, 16] and lo in [0, 31] (both int8); the int8 bytes stored."""
    v = np.arange(-512, 513, dtype=np.int32)
    hi, lo = v >> 5, v & 31
    assert hi.min() == -16 and hi.max() == 16
    assert lo.min() == 0 and lo.max() == 31
    np.testing.assert_array_equal(32 * hi.astype(np.int8).astype(np.int32)
                                  + lo.astype(np.int8), v)


def test_times32_bytewise():
    """For every pos and neg nibble pair with no bit in both (a weight is
    +1, 0 or -1), ternary4 gives the bytes pos - neg and times32 the bytes
    32 * (pos - neg)."""
    pairs = 0
    for p in range(16):
        for n in range(16):
            if p & n:
                continue
            w = np.array([((p >> j) & 1) - ((n >> j) & 1) for j in range(4)])
            b = ternary4(p, n)
            np.testing.assert_array_equal(int8s(b), w)
            np.testing.assert_array_equal(int8s(times32(b)), 32 * w)
            pairs += 1
    assert pairs == 81


def _mma(acc, a_regs, b_regs):
    """mma.sync m16n8k32 s8 from the 32 lanes' registers: lane (g, t4)
    holds A rows g, g+8 at k 4t4.. (a0, a1) and 16+4t4.. (a2, a3), B column
    g at k 4t4.. (b0) and 16+4t4.. (b1); C rows g, g+8, columns 2t4, +1."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for j, (r, k) in enumerate([(g, 4 * t4), (g + 8, 4 * t4),
                                    (g, 16 + 4 * t4), (g + 8, 16 + 4 * t4)]):
            A[r, k:k + 4] = int8s(a_regs[lane][j])
        for j, k in enumerate([4 * t4, 16 + 4 * t4]):
            B[k:k + 4, g] = int8s(b_regs[lane][j])
    C = A @ B
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for r in range(4):
            acc[lane][r] += C[g + 8 * (r >> 1), 2 * t4 + (r & 1)]


def _ldmatrix_x4(tile, k0):
    """ldmatrix .x4 .b16 with lane l addressing row l & 15 at byte
    k0 + 16 * (l >> 4) of ``tile`` (16 rows of int8): lane T gets from
    matrix j (the rows lanes 8j..8j+7 address) row T // 4, bytes 4(T % 4)..
    +3 — the m16n8k32 A fragment."""
    regs = []
    for T in range(32):
        out = []
        for j in range(4):
            src = 8 * j + T // 4
            k = k0 + 16 * (src >> 4) + 4 * (T % 4)
            out.append(word(tile[src & 15, k:k + 4]))
        regs.append(out)
    return regs


@pytest.mark.parametrize("M,K,N,tkb,n0", [(13, 300, 40, None, 8),
                                          (16, 999, 77, 20, 64)])
def test_i8_chunk_loop_emulation(M, K, N, tkb, n0):
    """One warp's m16 x n8 fragment over the whole K walk as the i8 branch
    runs it: the pre-pass's hi and lo planes of the padded scratch, chunks
    of 32 byte-rows (zero past tkb), B registers decoded from the raw
    plane bytes (low nibble: the low half's k-step, high nibble: the high
    half's) with their 32w copies, A by ldmatrix, two mma a k-step into one
    accumulator set. Equal to to_i8(X) @ W exactly."""
    kTC, kHalf = 32, 128
    W = jf.generate_ternary(K, N, 3, seed=K)
    fmt = tf.TiledBitplane.from_dense(W, tkb=tkb)
    plane = fmt.plane.numpy()
    nb, gn, _, tile_n = plane.shape
    tkb = fmt.tkb
    X = _i8_x(M, K, "edges")
    X[:, 1::5] += 0.6                       # floored by the rule
    v = (np.floor(X + 512.0) - 512.0).astype(np.int32)
    # the pre-pass: plane a of row m at (2*kb + h)*Hp + c
    H, Hp = 4 * tkb, -(-4 * tkb // kHalf) * kHalf
    P = nb * 2 * Hp
    xq = np.zeros((2, 16, P), np.int8)
    for c in range(P):
        seg, cc = divmod(c, Hp)
        k = (seg >> 1) * 8 * tkb + (seg & 1) * H + cc
        if cc < H and k < K:
            xq[0, :M, c] = v[:, k] >> 5
            xq[1, :M, c] = v[:, k] & 31
    acc = [[0] * 4 for _ in range(32)]
    gg, col0 = divmod(n0, tile_n)
    for kb in range(nb):
        for t0 in range(0, Hp // 4, kTC):
            # the staged X rows: plane a, half h, 128 bytes from 4*t0
            xs = [[xq[a, :, (2 * kb + h) * Hp + 4 * t0:(2 * kb + h) * Hp
                      + 4 * t0 + kHalf] for h in range(2)] for a in range(2)]
            ws = np.zeros((2, kTC, 8), np.uint8)          # pos, neg rows
            for t in range(kTC):
                if t0 + t < tkb:
                    for pl in range(2):
                        ws[pl, t] = plane[kb, gg, pl * tkb + t0 + t,
                                          col0:col0 + 8]
            for s in range(kTC // 8):
                b = [[[0, 0] for _ in range(32)] for _ in range(2)]
                for lane in range(32):
                    g, t4 = lane >> 2, lane & 3
                    for r in range(2):
                        p, n = (int(ws[pl, 8 * s + 4 * r + t4, g])
                                for pl in range(2))
                        b[0][lane][r] = ternary4(p & 15, n & 15)
                        b[1][lane][r] = ternary4(p >> 4, n >> 4)
                for h in range(2):
                    b32 = [[times32(x) for x in regs] for regs in b[h]]
                    a_hi = _ldmatrix_x4(xs[0][h], 32 * s)
                    a_lo = _ldmatrix_x4(xs[1][h], 32 * s)
                    _mma(acc, a_hi, b32)
                    _mma(acc, a_lo, b[h])
    got = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for r in range(4):
            got[g + 8 * (r >> 1), 2 * t4 + (r & 1)] = acc[lane][r]
    cols = slice(n0, min(n0 + 8, N))
    want = v.astype(np.int64) @ W[:, cols].astype(np.int64)
    np.testing.assert_array_equal(got[:M, :want.shape[1]], want)
    np.testing.assert_array_equal(
        want, (ck.to_i8(torch.from_numpy(X)).numpy() @ W[:, cols]).astype(
            np.int64))
