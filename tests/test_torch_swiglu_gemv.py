"""The fused SwiGLU's decode branch on the streaming decode body
(``csrc/swiglu.cu`` ``ternary_swiglu`` on ``csrc/gemv_core.cuh``) and its
split rule (``ops/fused_ffn.py`` ``gemv_parts`` with two plane sets), on
the CPU: numpy twins of the kernel's index maps and arithmetic, exact and
bitwise, built on ``test_torch_gemv_walk``'s twins of the body.

* Phase 1 on two plane sets: xq staged once by the truncating rule (one
  int8 plane), the gate's and the up projection's planes walked at the same
  offsets and summed against the same staged words, M-tiles of 4 and 8
  rows (row tiles of 8 above 8); each part's two sets written to the
  ``(S, 2, M, N1)`` scratch and folded in part order; the epilogue
  ``kEpiSwiglu`` by the output map, h in f32 and each warp's 32 columns of
  one row folding their |h| bits into the row's rmax.
* Phase 2: ``kStageRequant`` (``rint(h / scale)``, zeros past N1) and
  ``kEpiScale`` (``acc * (scale * gamma_down)``).
* The emulated block's y, h, requantized h and rmax bitwise those of
  ``swiglu_plain`` / ``swiglu_hidden_plain`` / ``requantize_rows`` (the
  sigmoid taken from ``sigmoid_f32`` on the emulated g, as the kernel and
  the plain version both round an f64 sigmoid once), for S parts of each
  phase, ragged K and hidden widths, tile_n not a multiple of 4 (byte
  loads), several hidden tiles and M in {1, 4, 8, 16, 33}; one geometry
  also against JAX's ``fused_bitplane_swiglu`` (Pallas in interpret mode,
  jitted).
* The two-set M-tiles' staging and reduction maps, the scratch's plane
  map, and ``gemv_plan``'s refusals before any launch.
* The rule that computes S for each phase, pinned at BitNet-7B and
  bitnet3b widths on 132 SMs.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``-k swiglu``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gemv_walk import (
    COLS,
    WARPS,
    X_WORDS,
    gemv_emulate,
    out_map,
    pack4,
    requant_scale,
    stage_part,
    stage_rule,
)
from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.ops import fused_ffn as jffn
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops import fused_ffn

GAMMAS = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.7)


def phase1_fold(acc_g, acc_u, S):
    """The scratch of phase 1's parts, (S, 2, M, N1): part z's gate sums at
    plane 2z, its up sums at 2z + 1 (the kernel's write index
    ``((z * NP + s) * M + gm) * N + gc``), read back by the fold at ``z * NP
    * M * N`` and ``+ M * N`` and added in part order."""
    M, N = acc_g.shape[1:]
    flat = np.zeros(S * 2 * M * N, np.int64)
    hits = np.zeros_like(flat)
    gm, gc = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    for z in range(S):
        for s, acc in enumerate((acc_g, acc_u)):
            at = ((z * 2 + s) * M + gm) * N + gc
            flat[at] = acc[z]
            hits[at] += 1
    assert (hits == 1).all()
    g = np.zeros((M, N), np.int64)
    u = np.zeros((M, N), np.int64)
    for z in range(S):
        at = z * 2 * M * N + gm * N + gc
        g += flat[at]
        u += flat[at + M * N]
    return g, u


def swiglu_emulate(xq, sx, fg, fu, fd, S1, S2, gamma_gate, gamma_up,
                   gamma_down):
    """The fused block as the decode branch's two launches compute it ->
    (y, h, hq, rmax bits): phase 1's two sets of sums over xq staged by the
    truncating rule at the two-set M-tile, each part's sums through the
    scratch and the fold; ``kEpiSwiglu`` by the output map (h in f32: g =
    gg * (sx * acc_g), u = gu * (sx * acc_u), (g * sigmoid(g)) * u; each
    warp's 32 threads, one row and 32 consecutive columns, fold the max of
    their |h| bits into the row's rmax, 0 past N1 or M); phase 2's sums over
    h staged by the rq rule at the rows' scales; ``kEpiScale``."""
    M, N1 = xq.shape[0], fg.N
    acc_g, acc_u = phase1_fold(
        *(gemv_emulate(xq, f, "trunc", S1, wplanes=2, parts=True)
          for f in (fg, fu)), S1)
    sx = sx.reshape(-1).astype(np.float32)
    f32 = np.float32
    gv = f32(gamma_gate) * (sx[:, None] * acc_g.astype(f32))
    uv = f32(gamma_up) * (sx[:, None] * acc_u.astype(f32))
    sig = fused_ffn.sigmoid_f32(torch.from_numpy(gv)).numpy()
    hfull = (gv * sig) * uv
    h = np.zeros((M, N1), f32)
    rmax = np.zeros(M, np.int64)
    MT = fused_ffn.gemv_tile(M, 2)
    for m0 in range(0, M, MT):
        for bx in range(-(-N1 // COLS)):
            for _, _, rows, cols in out_map(MT):
                gm, gc = m0 + rows, bx * COLS + cols
                for w in range(WARPS):
                    lanes = slice(32 * w, 32 * w + 32)
                    r, c = gm[lanes], gc[lanes]
                    assert (r == r[0]).all() and (np.diff(c) == 1).all()
                    if r[0] >= M:
                        continue
                    hv = np.zeros(32, f32)
                    ok = c < N1
                    hv[ok] = hfull[r[0], c[ok]]
                    h[r[0], c[ok]] = hv[ok]
                    rmax[r[0]] = max(rmax[r[0]],
                                     np.abs(hv).view(np.int32).max())
    scales = requant_scale(rmax)
    hq = stage_rule(h, "rq", scales[:, None])
    acc2 = gemv_emulate(h, fd, "rq", S2, scales)
    y = acc2.astype(f32) * (scales[:, None] * f32(gamma_down))
    return y, h, hq, rmax


def _formats(K, N1, N2, tile_n1, seed):
    Ws = [tf.generate_ternary(K, N1, 3, seed=seed),
          tf.generate_ternary(K, N1, 3, seed=seed + 1),
          tf.generate_ternary(N1, N2, 3, seed=seed + 2)]
    return [tf.TiledBitplane.from_dense(W, tile_n=t)
            for W, t in zip(Ws, (tile_n1, tile_n1, 4096))]


def _xq(M, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    x[:, ::11] *= 9.0     # a few large activations a row
    return fused_ffn.requantize_rows(torch.from_numpy(x))


#: (K, N1, N2, tile_n1): tile_n1 30 (byte loads, ten hidden tiles) at a
#: ragged K and hidden width; a ragged K and hidden width on word loads
#: (gn1 = 3); the hidden width a whole number of tiles (gn1 = 2)
GEOMS = [(200, 300, 96, 30), (999, 260, 77, 96), (128, 256, 128, 128)]


@pytest.mark.parametrize("K,N1,N2,tile_n1", GEOMS)
@pytest.mark.parametrize("M", [1, 4, 8, 16, 33])
@pytest.mark.parametrize("S1,S2", [(1, 1), (2, 3), (4, 8), (3, 5)])
def test_swiglu_phases_equal_the_plain_block(K, N1, N2, tile_n1, M, S1, S2):
    """The emulated block's y, h, requantized h and row absmax bitwise
    those of ``swiglu_plain`` / ``swiglu_hidden_plain`` /
    ``requantize_rows`` for S1 parts of phase 1 (two plane sets) and S2 of
    phase 2: rmax is the max over all N1 columns of the finished h whatever
    the parts, and y keeps its bits for every S."""
    fg, fu, fd = _formats(K, N1, N2, tile_n1, seed=K + M)
    txq, tsx = _xq(M, K, seed=M * 7 + S1)
    kw = GAMMAS
    h_plain = fused_ffn.swiglu_hidden_plain(
        txq, tsx, fg, fu, gamma_gate=kw["gamma_gate"],
        gamma_up=kw["gamma_up"])
    hq_plain, _ = fused_ffn.requantize_rows(h_plain)
    want = fused_ffn.swiglu_plain(txq, tsx, fg, fu, fd, **kw)
    y, h, hq, rmax = swiglu_emulate(txq.numpy(), tsx.numpy(), fg, fu, fd, S1,
                                    S2, **kw)
    np.testing.assert_array_equal(h, h_plain.numpy())
    np.testing.assert_array_equal(
        rmax, np.abs(h_plain.numpy()).max(1).view(np.int32))
    np.testing.assert_array_equal(hq, hq_plain.numpy())
    np.testing.assert_array_equal(y, want.numpy())


def test_swiglu_emulation_matches_jax():
    """One geometry (gn1 = 2, M = 5) against JAX's ``fused_bitplane_swiglu``,
    the Pallas kernel in interpret mode under ``jax.jit``: the emulated hq
    equals JAX's requantized hidden state and y agrees within the JAX
    fused-FFN tests' tolerance (rtol=1e-5, atol=0.01; the integer sums are
    exact in both, the f32 epilogue order may differ by a few ULPs)."""
    M, K, N1, N2, tile_n = 5, 128, 256, 128, 128
    Ws = [jf.generate_ternary(K, N1, 4, seed=31),
          jf.generate_ternary(K, N1, 4, seed=32),
          jf.generate_ternary(N1, N2, 4, seed=33)]
    tiles = (tile_n, tile_n, 4096)
    jfmts = [jf.TiledBitplane.from_dense(W, tile_n=t) for W, t in zip(Ws, tiles)]
    tfmts = [tf.TiledBitplane.from_dense(W, tile_n=t) for W, t in zip(Ws, tiles)]
    x = jf.generate_x(M, K, seed=34)
    jxq, jsx = jffn.requantize_rows(jnp.asarray(x))
    txq, tsx = fused_ffn.requantize_rows(torch.from_numpy(x))
    fused = jax.jit(lambda xq, sx: jffn.fused_bitplane_swiglu(
        xq, sx, *jfmts, **GAMMAS))
    want = np.asarray(fused(jxq, jsx))
    g = GAMMAS["gamma_gate"] * (jsx * (jxq @ jnp.asarray(Ws[0], jnp.float32)))
    u = GAMMAS["gamma_up"] * (jsx * (jxq @ jnp.asarray(Ws[1], jnp.float32)))
    jhq, _ = jffn.requantize_rows(jax.nn.silu(g) * u)
    y, _, hq, _ = swiglu_emulate(txq.numpy(), tsx.numpy(), *tfmts, 2, 2,
                                 **GAMMAS)
    np.testing.assert_array_equal(hq, np.asarray(jhq))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=0.01)


@pytest.mark.parametrize("MT", [4, 8])
@pytest.mark.parametrize("w0,length", [(0, 16), (17, 61), (3, 512)])
def test_two_set_staging_writes_every_word_once(MT, w0, length):
    """The truncating rule stages one plane at the two-set M-tiles: each
    word of a part's staged X is written once and holds the integer parts
    of its (byte-row, row, half)'s activations k .. k + 3, zero past K and
    M; parts up to ``gemv_part_max(M, 1, 2)`` fit the kernel's words."""
    K, tkb = 8 * 128 * 4 - 5, 128
    nb = -(-K // (8 * tkb))
    assert fused_ffn.gemv_part_max(MT, 1, 2) * 2 * MT == X_WORDS
    assert length <= fused_ffn.gemv_part_max(MT, 1, 2)
    M = MT - 1
    xq, _ = _xq(M, K, seed=MT + w0)
    X = xq.numpy()
    xs, writes = stage_part(X, "trunc", 0, MT, nb, tkb, K, w0, length)
    assert (writes == 1).all()
    RW = 2 * MT
    for rel in range(0, length, 7):
        kb, t = divmod(w0 + rel, tkb)
        for m in range(MT):
            for h in range(2):
                k = kb * 8 * tkb + h * 4 * tkb + 4 * t + np.arange(4)
                q = np.zeros(4, np.int64)
                ok = (k < K) & (m < M)
                if m < M:
                    q[ok] = X[m, k[ok]].astype(np.int64)
                assert xs[rel * RW + m * 2 + h] == pack4(q)


@pytest.mark.parametrize("MT", [4, 8])
def test_two_set_reduction_covers_the_tile(MT):
    """Each set's reduction (one pass of MT <= 8 rows) and the fold give
    thread tid element ((tid + e*256) // 128, tid % 128) of the block's MT
    x 128 tile: every element once, each warp's 32 threads one row."""
    seen = np.zeros((MT, COLS), np.int64)
    maps = out_map(MT)
    assert len({p for p, _, _, _ in maps}) == 1       # one pass a set
    for _, _, rows, cols in maps:
        for w in range(WARPS):
            assert (rows[32 * w:32 * w + 32] == rows[32 * w]).all()
        seen[rows, cols] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("S", range(1, 9))
def test_scratch_holds_both_sets_of_every_part(S):
    """The (S, 2, M, N1) scratch: every part's gate and up sums at their
    own elements, and the fold gives each set's sum over the parts."""
    rng = np.random.default_rng(S)
    M, N = 3, 70
    g = rng.integers(-2**20, 2**20, (S, M, N))
    u = rng.integers(-2**20, 2**20, (S, M, N))
    got_g, got_u = phase1_fold(g, u, S)
    np.testing.assert_array_equal(got_g, g.sum(0))
    np.testing.assert_array_equal(got_u, u.sum(0))


@pytest.mark.parametrize("M,tile,row_tiles", [
    (1, 4, 1), (2, 4, 1), (3, 4, 1), (4, 4, 1), (5, 8, 1), (7, 8, 1),
    (8, 8, 1), (9, 8, 2), (16, 8, 2), (17, 8, 3), (33, 8, 5), (128, 8, 16)])
def test_two_set_m_tiles(M, tile, row_tiles):
    """Two plane sets take M-tiles of 4 and 8 rows and row tiles of 8 above
    8 (one set keeps 4, 8 and 16)."""
    assert fused_ffn.gemv_tile(M, 2) == tile
    assert -(-M // tile) == row_tiles
    assert fused_ffn.gemv_tile(M) == (4 if M <= 4 else 8 if M <= 8 else 16)


@pytest.mark.parametrize("M,N,nb,tkb,planes,wplanes,want", [
    # BitNet-7B, 4096 -> 11008 -> 4096 at tkb 128: phase 1 (two sets, 86
    # column tiles, a walk of 512 byte-rows: 3 parts, 258 blocks in one
    # wave of two an SM) and phase 2 (one set, 32 column tiles, 1408
    # byte-rows) at M = 1, 4 and 8
    (1, 11008, 4, 128, 1, 2, 3),
    (4, 11008, 4, 128, 1, 2, 3),
    (8, 11008, 4, 128, 1, 2, 3),
    (1, 4096, 11, 128, 1, 1, 8),
    (4, 4096, 11, 128, 1, 1, 8),
    (8, 4096, 11, 128, 1, 1, 8),
    # bitnet3b, 3200 -> 8640 -> 3200 (K padded to 4096 and 9216): 68
    # column tiles and 512 byte-rows; 25 column tiles and 1152 byte-rows
    (4, 8640, 4, 128, 1, 2, 3),
    (4, 3200, 9, 128, 1, 1, 8),
    # 16 rows: two row tiles of 8 (172 tiles, one wave unsplit); 48: six
    # (516 tiles); the part X of phase 2 at M-tile 16 allows 256
    # byte-rows: S >= 6
    (16, 11008, 4, 128, 1, 2, 1),
    (48, 11008, 4, 128, 1, 2, 1),
    (33, 4096, 11, 128, 1, 1, 6),
    # the TP shard's 5504-hidden gate and up (tile_n 128: 43 tiles, six
    # parts a wave) and its down at tkb 16 (688 byte-rows)
    (4, 5504, 4, 128, 1, 2, 6),
    (4, 4096, 43, 16, 1, 1, 8),
    # a walk of 16 byte-rows: one register set a warp at two sets
    (4, 300, 1, 16, 1, 2, 1),
])
def test_swiglu_gemv_parts_rule(M, N, nb, tkb, planes, wplanes, want):
    """S for each SwiGLU phase on 132 SMs. One plane set: the largest power
    of two up to 8 whose blocks fit three an SM and whose parts give each
    warp a whole register set (32 byte-rows a part); two: the largest S up
    to 8 whose blocks fit one wave of two an SM and whose parts give each
    warp a whole set (16 byte-rows); then at least the parts whose X
    fits."""
    assert fused_ffn.GEMV_SLOTS_PER_SM2 == 2
    assert fused_ffn.gemv_parts(M, N, nb, tkb, 132, planes, wplanes) == want


@pytest.mark.parametrize("parts", [(0, 1), (1, 0), (513, 1), (1, 1409),
                                   (1, 5)])
def test_swiglu_plan_refuses_bad_parts(parts):
    """``gemv_plan`` refuses, before any launch, parts outside 1..the walk
    or fewer than phase 2's staged X allows at M = 16 (1408 byte-rows at
    most 256 a part: S >= 6)."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="parts"):
        for (nb, N, sets), S in zip(((4, 11008, 2), (11, 4096, 1)), parts):
            ck.gemv_plan(fused_ffn.KERNEL_NAME, 16, N, nb, 128, 1, cpu, S,
                         wplanes=sets)


def test_swiglu_plan_counts_two_set_tiles():
    """``gemv_plan``'s tiles at two sets: the column tiles times the row
    tiles of 8 (the counters phase 1 needs)."""
    cpu = torch.device("cpu")
    assert ck.gemv_plan("s", 16, 11008, 4, 128, 1, cpu, 2,
                        wplanes=2) == (2, 86 * 2)
    assert ck.gemv_plan("s", 16, 11008, 4, 128, 1, cpu, 2) == (2, 86)
