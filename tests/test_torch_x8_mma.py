"""The x8 kernel's split between its decode and its tensor-core branch, on
the CPU: above ``X8_MMA_MIN_M`` rows the registered wrapper still equals
the JAX Pallas kernel (run in interpret mode) bit for bit on a CPU tensor,
where it takes the plain version; both branches are CUDA-only; the
tensor-core branch's int8 scratch has the size its CUDA source
(``csrc/bitplane_mma.cuh``) writes. The branches themselves run only on the
card (``tests/test_torch_cuda.py``, ``-k x8``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.ops import get_kernel as jget
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck


@pytest.mark.parametrize("rows", [1, 28])
@pytest.mark.parametrize("K,N,kw", [(300, 260, {"tile_n": 128}),
                                    (999, 77, {"tkb": 20})])
@pytest.mark.parametrize("prelu", [False, True])
def test_x8_above_split_equals_pallas(rows, K, N, kw, prelu):
    """M = X8_MMA_MIN_M + rows: X rounds and clamps (1.3 x integers in
    +-127, .5 on every third column); exact equality."""
    M = ck.X8_MMA_MIN_M + rows
    W = jf.generate_ternary(K, N, 3, seed=K + M)
    jfmt = jf.TiledBitplane.from_dense(W, **kw)
    tfmt = tf.TiledBitplane.from_dense(W, **kw)
    X = 1.3 * jf.generate_x(M, K, seed=M, value_range=127)
    X[:, ::3] = np.round(X[:, ::3]) + 0.5
    X = X.astype(np.float32)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    want = np.asarray(jget("PallasTiledBitplane_x8")(
        jnp.asarray(X), jfmt, jnp.asarray(b),
        None if a is None else jnp.asarray(a)))
    ck.reset_counts()
    got = ck.cuda_tiled_bitplane_x8_kernel(
        torch.from_numpy(X), tfmt, torch.from_numpy(b),
        None if a is None else torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not ck.launches and not ck.plain_on_cuda   # CPU: plain version


@pytest.mark.parametrize("branch", ["_bitplane_x8_lanes", "_bitplane_x8_mma"])
def test_x8_branches_need_cuda(branch):
    fmt = tf.TiledBitplane.from_dense(jf.generate_ternary(64, 64, 2, seed=0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(ck, branch)(torch.zeros((40, 64)), fmt, torch.zeros(64))


@pytest.mark.parametrize("K,tkb,row_bytes", [
    (4096, None, 4 * 2 * 512),     # tkb 128: halves of 512, no padding
    (300, None, 1 * 2 * 256),      # tkb 48: halves of 192 padded to 256
    (999, 20, 7 * 2 * 128),        # tkb 20: halves of 80 padded to 128
    (100, 16, 1 * 2 * 128)])
def test_x8_mma_scratch_row_bytes(K, tkb, row_bytes):
    """Each K-block's two halves of 4*tkb rounded activations, each padded
    to a multiple of the 128 that one staged chunk of 32 byte-rows holds."""
    fmt = tf.TiledBitplane.from_dense(jf.generate_ternary(K, 64, 2, seed=1),
                                      tkb=tkb)
    assert ck.mma_row_bytes(fmt) == row_bytes
