"""The SwiGLU decode branch's split walk (``csrc/bitplane_core.cuh``
``launch_split``; ``ops/fused_ffn.py`` ``split_parts``), on the CPU.

* A numpy emulation of which (K-block, chunk) indices part s of S takes —
  chunks ``[s*W // S, (s+1)*W // S)`` of the ``W = nb * cdiv(tkb, 32)``
  chunks every block walks, chunk w being byte-rows ``[t0, t0 + 32)`` of
  K-block ``w // cdiv(tkb, 32)`` — for S in 1..16 over walks that S does
  not divide: every chunk is taken exactly once, in walk order, and every
  dense row below K lies in exactly one chunk.
* The parts' int32 sums (X staged as the integers the kernel stages, the
  weights the container's) add to the unsplit sum ``X @ W``: the
  finishing kernel's sum over the parts is exact, so y, h and rmax keep
  their bits for every S.
* The rule that computes S from the grid and the card's SMs, pinned at the
  7B geometry on 132 SMs.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``-k swiglu``)."""

import numpy as np
import pytest

from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import fused_ffn

#: bitplane_core.cuh's kTC: byte-rows a chunk
CHUNK = 32


def part_chunks(nb: int, tkb: int, S: int) -> list:
    """For each part s of S, the (K-block, first byte-row) of the chunks it
    walks, in order (``bitplane_body``'s SPLIT loop)."""
    cpb = -(-tkb // CHUNK)
    walk = nb * cpb
    return [[(w // cpb, (w % cpb) * CHUNK)
             for w in range(s * walk // S, (s + 1) * walk // S)]
            for s in range(S)]


def chunk_rows(kb: int, t0: int, tkb: int, K: int) -> np.ndarray:
    """The dense rows below K that chunk (kb, t0) holds: byte-row t of the
    block holds rows 4t + j of its low half and 4*tkb + 4t + j of its
    high half."""
    t = np.arange(t0, min(t0 + CHUNK, tkb))
    rows = (kb * 8 * tkb + np.arange(2)[:, None, None] * 4 * tkb
            + 4 * t[None, :, None] + np.arange(4)[None, None, :]).ravel()
    return rows[rows < K]


#: (K, tkb): K-blocks nb = 8, 4, 1 at K = 999 and 11 at the 7B hidden width
#: K = 11008 (tkb 128: 4 chunks a block); walks of 8, 4, 4 and 44 chunks
WALKS = [(999, 16), (999, 32), (999, 128), (11008, 128)]


@pytest.mark.parametrize("K,tkb", WALKS)
@pytest.mark.parametrize("S", range(1, 17))
def test_parts_take_every_chunk_once(K, tkb, S):
    """The parts' chunks, concatenated, are the whole walk in order; no part
    is empty while S <= W; the chunks' rows cover [0, K) exactly once."""
    nb = -(-K // (8 * tkb))
    parts = part_chunks(nb, tkb, S)
    walk = fused_ffn.split_walk(nb, tkb)
    every = [(kb, t0) for kb in range(nb) for t0 in range(0, tkb, CHUNK)]
    assert len(every) == walk
    assert [c for p in parts for c in p] == every
    if S <= walk:
        assert all(parts)
    rows = np.concatenate([chunk_rows(kb, t0, tkb, K) for kb, t0 in every])
    assert np.array_equal(np.sort(rows), np.arange(K))


@pytest.mark.parametrize("K,tkb", WALKS)
@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 11, 16])
def test_part_sums_add_to_the_product(K, tkb, S):
    """Each part's int32 sums over the rows of its chunks, added in part
    order, give ``X @ W`` exactly (W the container decoded by its own
    decoder, X integers in the int8 range as phase 1 stages xq and phase
    2 the requantized h)."""
    N = 40
    fmt = tf.TiledBitplane.from_dense(
        tf.generate_ternary(K, N, 2, seed=K + tkb), tkb=tkb)
    W = fmt.to_dense().numpy().astype(np.int64)
    rng = np.random.default_rng(S * K)
    X = rng.integers(-127, 128, (4, K)).astype(np.int64)
    nb = fmt.plane.shape[0]
    total = np.zeros((4, N), np.int64)
    for chunks in part_chunks(nb, tkb, S):
        part = np.zeros((4, N), np.int64)
        for kb, t0 in chunks:
            rows = chunk_rows(kb, t0, tkb, K)
            part += X[:, rows] @ W[rows]
        assert np.abs(part).max(initial=0) < 2 ** 31     # int32 holds it
        total += part
    np.testing.assert_array_equal(total, X @ W)


@pytest.mark.parametrize("M,N,nb,tkb,want", [
    # gate and up at 7B: 344 blocks, 16 chunks; 2 waves of 6 + 1 (S = 3)
    # against 1 wave of 16 + 1
    (4, 11008, 4, 128, 3),
    # down at 7B: 128 blocks, 44 chunks; 1 wave of 11 + 1 (S = 4)
    (4, 4096, 11, 128, 4),
    (1, 11008, 4, 128, 3),
    (1, 4096, 11, 128, 4),
    (8, 4096, 11, 128, 4),      # the M-tile grows with M: one row tile
    (33, 4096, 11, 128, 2),     # two row tiles of 32: 256 blocks
    (128, 11008, 4, 128, 1),    # 1376 blocks: more waves outweigh the walk
    (4, 32, 1, 16, 1),          # a walk of one chunk
    (4, 128, 1, 128, 4),        # 4 blocks: one chunk a part
])
def test_split_parts_rule(M, N, nb, tkb, want):
    """S minimises (waves of blocks) x (chunks a part + 1) over 1..W, with
    waves of SPLIT_BLOCKS_PER_SM = 4 blocks on each of an H100's 132 SMs
    and the blocks of the M-tile that holds M."""
    assert fused_ffn.SPLIT_BLOCKS_PER_SM == 4
    assert fused_ffn.split_parts(M, N, nb, tkb, 132) == want
