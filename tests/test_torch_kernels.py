"""Port parity: the plain versions of the CUDA bitplane kernels against the
JAX Pallas kernels (run in interpret mode on the CPU, as the JAX tests run
them). Both compute exact integer sums, so equality is exact."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu import reference as jref
from ternary_spgemm_tpu.ops import get_kernel as jget
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch import reference as tref
from ternary_spgemm_tpu_torch.models.exported import _default_a8_kernel
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops import get_kernel, ternary_spgemm

K, N = 300, 260


@pytest.fixture(scope="module")
def weights():
    W = jf.generate_ternary(K, N, 3, seed=11)
    return (W, jf.TiledBitplane.from_dense(W, tile_n=128),
            tf.TiledBitplane.from_dense(W, tile_n=128))


@pytest.mark.parametrize("kind", ["x8", "i8"])
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_plain_equals_pallas(weights, kind, M, prelu):
    W, jfmt, tfmt = weights
    assert tfmt.plane.shape[1] == 3                      # gn > 1
    vr = 127 if kind == "x8" else 512
    X = jf.generate_x(M, K, seed=M, value_range=vr)
    if kind == "x8":
        X = X * 1.3                      # rounds and clamps past +-127
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    want = np.asarray(jget(f"PallasTiledBitplane_{kind}")(
        jnp.asarray(X), jfmt, jnp.asarray(b),
        None if a is None else jnp.asarray(a)))
    tkern = get_kernel(f"CudaTiledBitplane_{kind}")
    got = tkern(torch.from_numpy(X), tfmt, torch.from_numpy(b),
                None if a is None else torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)


def test_i8_floors_non_integer_x(weights):
    W, jfmt, tfmt = weights
    rng = np.random.default_rng(0)
    X = rng.uniform(-511.9, 511.9, size=(5, K)).astype(np.float32)
    b = np.zeros(N, np.float32)
    want = np.asarray(jget("PallasTiledBitplane_i8")(jnp.asarray(X), jfmt,
                                                     jnp.asarray(b)))
    got = ck.cuda_tiled_bitplane_i8_kernel(torch.from_numpy(X), tfmt,
                                           torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.floor(X) @ W.astype(np.float32))


def test_i8_matches_dense_reference(weights):
    W, _, tfmt = weights
    X = jf.generate_x(32, K, seed=4)
    b, a = jf.generate_bias(N), jf.generate_alpha(N)
    got = get_kernel("CudaTiledBitplane_i8")(torch.from_numpy(X), tfmt,
                                             torch.from_numpy(b),
                                             torch.from_numpy(a))
    assert tref.compare_results(got, tref.dense_gemm_prelu(X, W, b, a))
    assert tref.compare_results(got, np.asarray(jref.dense_gemm_prelu(X, W, b, a)))


def test_default_dispatch_and_a8_kernel(weights):
    _, _, tfmt = weights
    X = torch.from_numpy(jf.generate_x(3, K, seed=1))
    b = torch.zeros(N)
    with pytest.warns(UserWarning, match="ROUNDED"):
        y = ternary_spgemm(X, tfmt, b)
    assert torch.equal(y, ck.bitplane_i8_plain(X, tfmt, b))
    assert _default_a8_kernel(tfmt) == "CudaTiledBitplane_x8"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ternary_spgemm(X, tfmt, b, kernel="CudaTiledBitplane_x8")


def test_plain_runs_only_on_cpu(weights):
    _, _, tfmt = weights
    ck.reset_counts()
    ck.cuda_tiled_bitplane_x8_kernel(torch.zeros(2, K), tfmt, torch.zeros(N))
    assert not ck.launches and not ck.plain_on_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        ck.cuda_tiled_bitplane_x8_kernel(torch.zeros(2, K, device="meta"),
                                         tfmt, torch.zeros(N))
