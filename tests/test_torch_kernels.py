"""Port parity: the plain versions of the CUDA SpMM kernels against the JAX
Pallas kernels (run in interpret mode on the CPU, as the JAX tests run
them), and the torch-ops BaseTCSC against the JAX XLA one. On the integer
domains both compute exact sums, so equality is exact; the bf16 kernel off
its integer domain rounds X to bf16 identically in both and differs only in
f32 summation order (rtol=1e-5, atol=1e-3)."""

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
from ternary_spgemm_tpu_torch.models.exported import (
    ExportedBitLinear,
    _default_a8_kernel,
)
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops import get_kernel, ternary_spgemm
from ternary_spgemm_tpu_torch.ops import xla_kernels

K, N = 300, 260

#: kind -> (port kernel, JAX kernel, container, integer |x| domain)
KINDS = {
    "x8": ("CudaTiledBitplane_x8", "PallasTiledBitplane_x8", "TiledBitplane",
           127),
    "i8": ("CudaTiledBitplane_i8", "PallasTiledBitplane_i8", "TiledBitplane",
           512),
    "bf16": ("CudaTiledBitplane_bf16", "PallasTiledBitplane_bf16",
             "TiledBitplane", 256),
    "nibble_i8": ("CudaTiledNibblePair_i8", "PallasTiledNibblePair_i8",
                  "TiledNibblePair", 512),
    "dense_i8": ("CudaTiledDense_i8", "PallasTiledDense_i8",
                 "TiledDenseTernary", 512),
    "dense_x8": ("CudaTiledDense_x8", "PallasTiledDense_x8",
                 "TiledDenseTernary", 127),
}


@pytest.fixture(scope="module")
def dense_w():
    return jf.generate_ternary(K, N, 3, seed=11)


@pytest.fixture(scope="module")
def containers(dense_w):
    """container name -> (JAX container, port container), tile_n = 128 so
    that gn = 3."""
    return {c: (getattr(jf, c).from_dense(dense_w, tile_n=128),
                getattr(tf, c).from_dense(dense_w, tile_n=128))
            for c in ("TiledBitplane", "TiledNibblePair", "TiledDenseTernary")}


@pytest.fixture(scope="module")
def weights(dense_w, containers):
    return (dense_w, *containers["TiledBitplane"])


def _both(jname, tkern, jfmt, tfmt, X, b, a):
    want = np.asarray(jget(jname)(
        jnp.asarray(X), jfmt, jnp.asarray(b),
        None if a is None else jnp.asarray(a)))
    got = tkern(torch.from_numpy(X), tfmt, torch.from_numpy(b),
                None if a is None else torch.from_numpy(a)).numpy()
    return got, want


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_plain_equals_pallas(containers, kind, M, prelu):
    tname, jname, cls, vr = KINDS[kind]
    jfmt, tfmt = containers[cls]
    assert tfmt.meta()["tile_n"] == 128 and N > 2 * 128     # gn > 1
    X = jf.generate_x(M, K, seed=M, value_range=vr)
    if vr == 127:
        X = X * 1.3                      # rounds and clamps past +-127
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    got, want = _both(jname, get_kernel(tname), jfmt, tfmt, X, b, a)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", [1, 7, 32])
@pytest.mark.parametrize("prelu", [False, True])
def test_bf16_off_integer_domain(containers, M, prelu):
    jfmt, tfmt = containers["TiledBitplane"]
    X = np.random.default_rng(M).uniform(-700.0, 700.0,
                                         size=(M, K)).astype(np.float32)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    got, want = _both("PallasTiledBitplane_bf16",
                      ck.cuda_tiled_bitplane_bf16_kernel, jfmt, tfmt, X, b, a)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # X is rounded to bf16, not floored or clamped
    Xb = np.asarray(jnp.asarray(X, jnp.bfloat16).astype(jnp.float32))
    W = containers["TiledBitplane"][1].to_dense().numpy()
    ref = (jref.dense_gemm_prelu(Xb, W, b, a) if prelu
           else jref.dense_gemm(Xb, W, b))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("chunked", [False, True], ids=["direct", "chunked"])
@pytest.mark.parametrize("prelu", [False, True])
def test_base_tcsc_equals_jax(monkeypatch, dense_w, chunked, prelu):
    from ternary_spgemm_tpu.ops import xla_kernels as jxla

    X = jf.generate_x(9, K, seed=5)
    b = jf.generate_bias(N)
    a = jf.generate_alpha(N) if prelu else None
    jfmt, tfmt = jf.TCSC.from_dense(dense_w), tf.TCSC.from_dense(dense_w)
    if chunked:
        # every M takes the chunked path, in chunks of 2 rows (a ragged last
        # chunk) and slot sections of 8
        for mod in (jxla, xla_kernels):
            monkeypatch.setattr(mod, "_GATHER_CHUNK_FLOATS", 1)
            monkeypatch.setattr(mod, "_CHUNK_BUDGET_FLOATS", 2 * N * 8)
        monkeypatch.setattr(xla_kernels, "_SEC", 8)
        assert tfmt.prepare(9).ell_pos is not None
    else:
        assert tfmt.prepare(9).ell_pos is None
    got, want = _both("BaseTCSC", get_kernel("BaseTCSC"), jfmt, tfmt, X, b, a)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(
        (jref.dense_gemm_prelu(X, dense_w, b, a) if prelu
         else jref.dense_gemm(X, dense_w, b))))


def test_a8_linear_over_tiled_dense(dense_w):
    """The A8 ExportedBitLinear over TiledDenseTernary picks the int8-native
    kernel in both packages and gives the same output."""
    from ternary_spgemm_tpu.models.exported import ExportedBitLinear as JLin
    from ternary_spgemm_tpu.models.exported import (
        _default_a8_kernel as j_default_a8)

    x = np.random.default_rng(3).standard_normal((6, K)).astype(np.float32)
    b = np.linspace(-1, 1, N).astype(np.float32)
    jl = JLin.from_dense(dense_w, jf.TiledDenseTernary, gamma=0.37, bias=b,
                         a8=True, with_transpose=False)
    tl = ExportedBitLinear.from_dense(dense_w, tf.TiledDenseTernary,
                                      gamma=0.37, bias=b, a8=True)
    assert j_default_a8(jl.fmt) == "PallasTiledDense_x8"
    assert _default_a8_kernel(tl.fmt) == "CudaTiledDense_x8"
    ck.reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("cls,default,a8", [
    ("TiledBitplane", "CudaTiledBitplane_i8", "CudaTiledBitplane_x8"),
    ("TiledNibblePair", "CudaTiledNibblePair_i8", "CudaTiledNibblePair_i8"),
    ("TiledDenseTernary", "CudaTiledDense_i8", "CudaTiledDense_x8")])
def test_default_dispatch_per_container(containers, cls, default, a8):
    """Default dispatch takes the widest integer domain (the bf16 kernel's
    +-256 does not displace i8's +-512); the A8 default is int8-native."""
    tfmt = containers[cls][1]
    X = torch.from_numpy(jf.generate_x(3, K, seed=1))
    b = torch.zeros(N)
    with pytest.warns(UserWarning, match="ROUNDED"):
        y = ternary_spgemm(X, tfmt, b)
    assert torch.equal(y, get_kernel(default)(X, tfmt, b))
    assert _default_a8_kernel(tfmt) == a8


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


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_runs_only_on_cpu(containers, kind):
    tname, _, cls, _ = KINDS[kind]
    tfmt = containers[cls][1]
    kern = get_kernel(tname)
    ck.reset_counts()
    kern(torch.zeros(2, K), tfmt, torch.zeros(N))
    assert not ck.launches and not ck.plain_on_cuda
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern(torch.zeros(2, K, device="meta"), tfmt, torch.zeros(N))
