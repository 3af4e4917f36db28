"""Port parity: the fused SwiGLU FFN against the JAX package.

The JAX fused kernel runs in Pallas interpret mode. The requantized hidden
``hq`` must be identical (a single +-1 flip moves an output by about
scale*colsum, far past the tolerance), and the outputs agree within the
JAX fused-FFN tests' tolerance (``tests/test_fused_ffn.py:52``,
rtol=1e-5, atol=0.01): the integer sums are exact in both, only the f32
epilogue order may differ by a few ULPs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.ops import fused_ffn as jffn
from ternary_spgemm_tpu.ops import ternary_spgemm as jspgemm
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch.ops import fused_ffn as tffn

GAMMAS = dict(gamma_gate=0.021, gamma_up=0.034, gamma_down=1.7)


def _case(M, K, N1, N2, *, tile_n=4096, seed=0):
    Ws = [jf.generate_ternary(K, N1, 4, seed=seed),
          jf.generate_ternary(K, N1, 4, seed=seed + 1),
          jf.generate_ternary(N1, N2, 4, seed=seed + 2)]
    tiles = [tile_n, tile_n, 4096]
    jfmts = [jf.TiledBitplane.from_dense(W, tile_n=t) for W, t in zip(Ws, tiles)]
    tfmts = [tf.TiledBitplane.from_dense(W, tile_n=t) for W, t in zip(Ws, tiles)]
    x = jf.generate_x(M, K, seed=seed + 3)
    jxq, jsx = jffn.requantize_rows(jnp.asarray(x))
    txq, tsx = tffn.requantize_rows(torch.from_numpy(x))
    return jfmts, tfmts, (jxq, jsx), (txq, tsx)


@pytest.fixture(scope="module", params=[
    (8, 128, 256, 128, 128),       # gn1 = 2 (hidden spans two tiles)
    (5, 200, 300, 96, 128),        # odd widths, gn1 = 3
    (33, 128, 256, 128, 4096),     # one tile
])
def case(request):
    M, K, N1, N2, tile_n = request.param
    return _case(M, K, N1, N2, tile_n=tile_n)


def test_requantize_rows_identical(case):
    _, _, (jxq, jsx), (txq, tsx) = case
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


def test_hidden_hq_identical(case):
    jfmts, tfmts, (jxq, jsx), (txq, tsx) = case
    zg = jnp.zeros((jfmts[0].N,), jnp.float32)
    k = "PallasTiledBitplane_i8"
    g = GAMMAS["gamma_gate"] * (jsx * jspgemm(jxq, jfmts[0], zg, kernel=k))
    u = GAMMAS["gamma_up"] * (jsx * jspgemm(jxq, jfmts[1], zg, kernel=k))
    jhq, _ = jffn.requantize_rows(jax.nn.silu(g) * u)
    th = tffn.swiglu_hidden_plain(txq, tsx, tfmts[0], tfmts[1],
                                  gamma_gate=GAMMAS["gamma_gate"],
                                  gamma_up=GAMMAS["gamma_up"])
    thq, _ = tffn.requantize_rows(th)
    np.testing.assert_array_equal(thq.numpy(), np.asarray(jhq))


def test_fused_matches_jax(case):
    jfmts, tfmts, (jxq, jsx), (txq, tsx) = case
    got = tffn.fused_bitplane_swiglu(txq, tsx, *tfmts, **GAMMAS).numpy()
    want_fused = np.asarray(jffn.fused_bitplane_swiglu(jxq, jsx, *jfmts,
                                                       **GAMMAS))
    want_unfused = np.asarray(jffn.unfused_reference_swiglu(
        jxq, jsx, *jfmts, kernel="PallasTiledBitplane_i8", **GAMMAS))
    np.testing.assert_allclose(got, want_fused, rtol=1e-5, atol=0.01)
    np.testing.assert_allclose(got, want_unfused, rtol=1e-5, atol=0.01)


def test_unfused_reference_matches_fused(case):
    _, tfmts, _, (txq, tsx) = case
    fused = tffn.fused_bitplane_swiglu(txq, tsx, *tfmts, **GAMMAS)
    with pytest.warns(UserWarning, match="ROUNDED"):
        unfused = tffn.unfused_reference_swiglu(txq, tsx, *tfmts, **GAMMAS)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), rtol=1e-5,
                               atol=0.01)


def test_geometry_contracts():
    _, tfmts, _, (txq, tsx) = _case(4, 128, 256, 128)
    bad_up = tf.TiledBitplane.from_dense(jf.generate_ternary(128, 384, 4, seed=3))
    with pytest.raises(ValueError, match="share"):
        tffn.fused_bitplane_swiglu(txq, tsx, tfmts[0], bad_up, tfmts[2])
    bad_down = tf.TiledBitplane.from_dense(jf.generate_ternary(384, 128, 4, seed=9))
    with pytest.raises(ValueError, match="contracts over"):
        tffn.fused_bitplane_swiglu(txq, tsx, tfmts[0], tfmts[1], bad_down)


@pytest.mark.parametrize("fault", ["share", "OUTPUT", "contracts over",
                                   "K padding"])
def test_geometry_errors_match_jax(fault):
    """The SwiGLU raises where JAX's raises, with its texts
    (``tests/test_fused_ffn.py:107-119,165-169`` there): the shared FFN
    geometry contract."""
    jfmts, tfmts, (jxq, jsx), (txq, tsx) = _case(4, 128, 256, 128)
    if fault == "share":
        W = jf.generate_ternary(128, 384, 4, seed=3)
        jfmts[1], tfmts[1] = (m.TiledBitplane.from_dense(W) for m in (jf, tf))
    elif fault == "OUTPUT":
        W = jf.generate_ternary(256, 128, 4, seed=2)
        jfmts[2], tfmts[2] = (m.TiledBitplane.from_dense(W, tile_n=64)
                              for m in (jf, tf))
    elif fault == "contracts over":
        W = jf.generate_ternary(384, 128, 4, seed=9)
        jfmts[2], tfmts[2] = (m.TiledBitplane.from_dense(W) for m in (jf, tf))
    else:
        jp, tp = np.asarray(jfmts[2].plane), tfmts[2].plane
        jfmts[2] = dataclasses.replace(
            jfmts[2], plane=jnp.asarray(np.concatenate([jp, jp])))
        tfmts[2] = dataclasses.replace(tfmts[2], plane=torch.cat([tp, tp]))
    with pytest.raises(ValueError, match=fault):
        jffn.fused_bitplane_swiglu(jxq, jsx, *jfmts, **GAMMAS)
    with pytest.raises(ValueError, match=fault):
        tffn.fused_bitplane_swiglu(txq, tsx, *tfmts, **GAMMAS)
