"""Port parity: the fused PReLU FFN block against the JAX package.

The JAX fused kernel runs in Pallas interpret mode; the port's wrapper runs
its plain version on these CPU tensors. The inputs are the JAX fused-FFN
tests' (``tests/test_fused_ffn.py:34-119``): the same generators, seeds and
shapes. The requantized hidden values must be identical (a single +-1 flip
moves an output by about scale*colsum, far past the tolerance), and the
outputs agree within the JAX test's own tolerance (rtol=1e-5, atol=0.01:
the integer sums are exact in both, the f32 epilogue may round in another
order). The contract errors are JAX's, with its texts.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.ops import fused_ffn as jffn
from ternary_spgemm_tpu.ops import ternary_spgemm as jspgemm
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck
from ternary_spgemm_tpu_torch.ops import fused_ffn as tffn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "PallasTiledBitplane_i8"
TOL = dict(rtol=1e-5, atol=0.01)


def _block(M, K, N1, N2, s=4, *, prelu2=False, gammas=(1.0, 1.0), seed=0,
           tile_n1=4096, tkb1=None):
    """The JAX test's ``_block``: numpy arrays, then each package's
    containers from the same dense W."""
    W1 = jf.generate_ternary(K, N1, s, seed=seed)
    W2 = jf.generate_ternary(N1, N2, s, seed=seed + 1)
    X = jf.generate_x(M, K, seed=seed + 2)
    arrs = dict(X=X, b1=jf.generate_bias(N1), alpha1=jf.generate_alpha(N1),
                b2=jf.generate_bias(N2),
                alpha2=jf.generate_alpha(N2) if prelu2 else None)
    g1, g2 = gammas
    kw1 = dict(tile_n=tile_n1) if tkb1 is None else dict(tile_n=tile_n1,
                                                           tkb=tkb1)
    jkw = dict({k: None if v is None else jnp.asarray(v)
                for k, v in arrs.items()},
               fmt1=jf.TiledBitplane.from_dense(W1, **kw1),
               fmt2=jf.TiledBitplane.from_dense(W2), gamma1=g1, gamma2=g2)
    tkw = dict({k: None if v is None else torch.from_numpy(v)
                for k, v in arrs.items()},
               fmt1=tf.TiledBitplane.from_dense(W1, **kw1),
               fmt2=tf.TiledBitplane.from_dense(W2), gamma1=g1, gamma2=g2)
    return jkw, tkw


CASES = {
    "M1": dict(M=1, K=128, N1=256, N2=128),
    "M8": dict(M=8, K=128, N1=256, N2=128),
    "M33": dict(M=33, K=128, N1=256, N2=128),
    "M128": dict(M=128, K=128, N1=256, N2=128),
    "prelu2_gammas": dict(M=16, K=128, N1=256, N2=128, prelu2=True,
                          gammas=(0.037, 1.9)),
    "hidden_1152": dict(M=8, K=128, N1=1152, N2=128),
    "hostile_k100": dict(M=1, K=100, N1=256, N2=128),
    "hostile_n130": dict(M=8, K=128, N1=130, N2=128),
    "hostile_n96": dict(M=33, K=96, N1=384, N2=96),
    "multi_block_tkb16": dict(M=8, K=384, N1=256, N2=128, tkb1=16),
    "multi_tile_hidden": dict(M=8, K=128, N1=256, N2=128, tile_n1=128),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    c = dict(CASES[request.param])
    jkw, tkw = _block(c.pop("M"), c.pop("K"), c.pop("N1"), c.pop("N2"), **c)
    if request.param == "multi_block_tkb16":
        assert tkw["fmt1"].plane.shape[0] == 3
    if request.param == "multi_tile_hidden":
        assert tkw["fmt1"].plane.shape[1] == 2
    want_fused = np.asarray(jffn.fused_bitplane_ffn(**jkw))
    want_unfused = np.asarray(jffn.unfused_reference_ffn(kernel=KERNEL, **jkw))
    return jkw, tkw, want_fused, want_unfused


def test_hidden_hq_identical(case):
    jkw, tkw, _, _ = case
    b1g = jkw["b1"] / jkw["gamma1"]
    jh = jspgemm(jkw["X"], jkw["fmt1"], b1g, jkw["alpha1"], kernel=KERNEL)
    jhq, jscale = jffn.requantize_rows(jh)
    th = tffn.ffn_hidden_plain(tkw["X"], tkw["fmt1"], tkw["b1"],
                               tkw["alpha1"], gamma1=tkw["gamma1"])
    thq, tscale = tffn.requantize_rows(th)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(thq.numpy(), np.asarray(jhq))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


def test_fused_matches_jax(case):
    _, tkw, want_fused, want_unfused = case
    ck.reset_counts()
    got = tffn.fused_bitplane_ffn(**tkw).numpy()
    assert not ck.launches and not ck.plain_on_cuda   # CPU: the plain version
    np.testing.assert_allclose(got, want_fused, **TOL)
    np.testing.assert_allclose(got, want_unfused, **TOL)


def test_unfused_reference_matches_fused(case):
    _, tkw, _, want_unfused = case
    fused = tffn.fused_bitplane_ffn(**tkw)
    with pytest.warns(UserWarning, match="ROUNDED"):
        unfused = tffn.unfused_reference_ffn(**tkw)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), **TOL)
    np.testing.assert_allclose(unfused.numpy(), want_unfused, **TOL)


def _raises_both(jkw, tkw, match):
    with pytest.raises(ValueError, match=match):
        jffn.fused_bitplane_ffn(**jkw)
    with pytest.raises(ValueError, match=match):
        tffn.fused_bitplane_ffn(**tkw)


def test_serving_m_contract():
    jkw, tkw = _block(8, 128, 256, 128)
    X = jf.generate_x(256, 128, seed=5)
    jkw["X"], tkw["X"] = jnp.asarray(X), torch.from_numpy(X)
    _raises_both(jkw, tkw, "serving-M")


def test_single_tile_output_contract():
    jkw, tkw = _block(8, 128, 256, 128)
    W2 = jf.generate_ternary(256, 128, 4, seed=1)
    jkw["fmt2"] = jf.TiledBitplane.from_dense(W2, tile_n=64)      # gn2 = 2
    tkw["fmt2"] = tf.TiledBitplane.from_dense(W2, tile_n=64)
    assert tkw["fmt2"].plane.shape[1] == 2
    _raises_both(jkw, tkw, "OUTPUT")


def test_mismatched_hidden_raises():
    jkw, tkw = _block(8, 128, 256, 128)
    W2 = jf.generate_ternary(384, 128, 4, seed=9)
    jkw["fmt2"] = jf.TiledBitplane.from_dense(W2)
    tkw["fmt2"] = tf.TiledBitplane.from_dense(W2)
    _raises_both(jkw, tkw, "contracts over")


def test_k_padding_contract():
    """A down container whose planes hold an extra K-block: JAX's third
    geometry error (the K padding must cover exactly the hidden width)."""
    jkw, tkw = _block(8, 128, 256, 128)
    jp, tp = np.asarray(jkw["fmt2"].plane), tkw["fmt2"].plane
    jkw["fmt2"] = dataclasses.replace(
        jkw["fmt2"], plane=jnp.asarray(np.concatenate([jp, jp])))
    tkw["fmt2"] = dataclasses.replace(tkw["fmt2"],
                                      plane=torch.cat([tp, tp]))
    _raises_both(jkw, tkw, "K padding")


def test_launch_refuses_cpu_tensors():
    _, tkw = _block(4, 128, 256, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tffn.ffn_launch(**tkw)


def test_constants_name_the_kernel():
    assert tffn.FFN_REFERENCE == "ternary_spgemm_tpu/ops/fused_ffn.py:229"
    with open(os.path.join(ROOT, tffn.FFN_REFERENCE.split(":")[0])) as f:
        line = f.read().splitlines()[228]
    assert line.startswith("def fused_bitplane_ffn(")
    assert tffn.FFN_SOURCE.endswith("csrc/ffn.cu")
    from ternary_spgemm_tpu_torch import ops
    assert ops.fused_bitplane_ffn is tffn.fused_bitplane_ffn
    assert ops.unfused_reference_ffn is tffn.unfused_reference_ffn
