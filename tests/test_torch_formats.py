"""Port parity: generators and the TiledBitplane container.

The same numpy seeds go through the JAX package and the PyTorch port. The
container bytes are the contract between the two: ``plane`` and ``wsum``
must be identical (``wsum`` as int32, the container's documented dtype).
"""

import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.formats import (
    format_from_buffers,
    register_format_buffers,
)


@pytest.mark.parametrize("K,N,s,uniform", [
    (37, 91, 3, False), (128, 300, 2, False), (16, 64, 4, True)])
def test_generate_ternary_identical(K, N, s, uniform):
    np.testing.assert_array_equal(
        tf.generate_ternary(K, N, s, seed=5, uniform=uniform),
        jf.generate_ternary(K, N, s, seed=5, uniform=uniform))


def test_generate_x_bias_alpha_identical():
    np.testing.assert_array_equal(tf.generate_x(7, 33, seed=3),
                                  jf.generate_x(7, 33, seed=3))
    np.testing.assert_array_equal(tf.generate_x(4, 9, seed=1, value_range=127),
                                  jf.generate_x(4, 9, seed=1, value_range=127))
    np.testing.assert_array_equal(tf.generate_bias(12), jf.generate_bias(12))
    np.testing.assert_array_equal(tf.generate_alpha(12), jf.generate_alpha(12))


def test_rowmap_identical():
    for tkb in (16, 32, 128):
        for a, b in zip(tf.bitplane_rowmap(tkb), jf.bitplane_rowmap(tkb)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("K,N,kw", [
    (100, 300, {}),                      # odd shape, one block, one tile
    (2500, 260, {}),                     # nb > 1
    (300, 700, {"tile_n": 128}),         # gn > 1
    (384, 256, {"tkb": 16}),             # explicit small blocks
    (1000, 5000, {}),                    # default tile_n = 4096 -> gn = 2
])
def test_bitplane_bytes_identical(K, N, kw):
    W = jf.generate_ternary(K, N, 3, seed=K + N)
    j = jf.TiledBitplane.from_dense(W, **kw)
    t = tf.TiledBitplane.from_dense(W, **kw)
    assert (t.K, t.N, t.tkb, t.tile_n) == (j.K, j.N, j.tkb, j.tile_n)
    assert t.plane.dtype == torch.uint8 and t.wsum.dtype == torch.int32
    assert tuple(t.plane.shape) == j.plane.shape
    assert tuple(t.wsum.shape) == j.wsum.shape
    np.testing.assert_array_equal(t.plane.numpy(), np.asarray(j.plane))
    np.testing.assert_array_equal(t.wsum.numpy(),
                                  np.asarray(j.wsum).astype(np.int32))
    np.testing.assert_array_equal(t.to_dense().numpy(), W)
    assert t.size_bytes() == t.plane.numel() + 4 * t.wsum.numel()


def test_bitplane_from_torch_and_roundtrip():
    W = jf.generate_ternary(200, 150, 2, seed=9)
    a = tf.TiledBitplane.from_dense(W)
    b = tf.TiledBitplane.from_dense(torch.from_numpy(W).to(torch.float32))
    assert torch.equal(a.plane, b.plane) and torch.equal(a.wsum, b.wsum)
    assert torch.equal(a.to("cpu").to_dense(), torch.from_numpy(W))
    with pytest.raises(ValueError, match="only contain"):
        tf.TiledBitplane.from_dense(np.full((4, 4), 2, np.int8))


def test_container_as_module_buffers():
    fmt = tf.TiledBitplane.from_dense(jf.generate_ternary(64, 96, 2, seed=2))
    mod = torch.nn.Module()
    register_format_buffers(mod, fmt)
    names = {n for n, _ in mod.named_buffers()}
    assert names == {"fmt_plane", "fmt_wsum"}
    back = format_from_buffers(mod)
    assert back.meta() == fmt.meta() and torch.equal(back.plane, fmt.plane)
