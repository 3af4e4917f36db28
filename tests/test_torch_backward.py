"""Port parity: the frozen-ternary backward — ``ExportedBitLinear``'s
autograd function over the transposed container, ``ExportedMLP`` and the
exported block's input grads — against the JAX package's custom VJP
(``ternary_spgemm_tpu/models/exported.py:272-348``), on the CPU (JAX's
kernels in interpret mode or their XLA formulations, the port's plain
versions).

Over ``DenseTernary`` the backward is exact: x, bias and slope grads agree
with JAX's and with dense autodiff at JAX's ``rtol=1e-4, atol=1e-3``
(``tests/test_models.py:149``). Over ``TiledBitplane`` in the A8 regime
both packages requantize the cotangent per row before the x8 kernel on
``fmt_t``; the two agree within rtol=1e-4, atol=1e-5 (the same integer
products; the glue's last bits differ). Blocks: within rtol=atol=2e-3, the
A8 forward's tolerance (``tests/test_torch_model.py``).

The reference fault at ``models/exported.py:297-300`` (a default-dispatch
backward over TiledBitplane floors the small f32 cotangent to integers) is
an ``xfail`` cell;
the port requantizes there, and its gradient is held to dense autodiff
within the requantization error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu.checkpoint import save_lm_bundle as jsave
from ternary_spgemm_tpu.formats import DenseTernary as JDense
from ternary_spgemm_tpu.formats import TiledBitplane as JTiledBitplane
from ternary_spgemm_tpu.models import BitLinear as JBitLinear
from ternary_spgemm_tpu.models import BitTransformerConfig as JConfig
from ternary_spgemm_tpu.models import BitTransformerLM as JLM
from ternary_spgemm_tpu.models import ExportedBitLinear as JLinear
from ternary_spgemm_tpu.models import ExportedMLP as JExportedMLP
from ternary_spgemm_tpu.models import ExportedTransformerBlock as JBlock
from ternary_spgemm_tpu.models import ExportedTransformerLM as JExportedLM
from ternary_spgemm_tpu.models import TernaryMLP as JMLP
from ternary_spgemm_tpu.checkpoint import load_lm_bundle as jload
from ternary_spgemm_tpu_torch import checkpoint as tck
from ternary_spgemm_tpu_torch.formats import DenseTernary, TiledBitplane
from ternary_spgemm_tpu_torch.models import (
    BitTransformerConfig,
    ExportedBitLinear,
    ExportedMLP,
    ExportedTransformerBlock,
    ExportedTransformerLM,
    build_serving_lm,
    jax_tree,
    lm_from_jax_params,
    make_lm_train_step,
    qat_lm_from_jax_params,
    ternary_quantize,
)
from ternary_spgemm_tpu_torch.models.serving import preset_config
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

BASE = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2)
EXACT = dict(rtol=1e-4, atol=1e-3)
A8 = dict(rtol=1e-4, atol=1e-5)
BLOCK = dict(rtol=2e-3, atol=2e-3)
CPU = dict(device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _layer_params(seed, prelu=True, K=48, N=96):
    layer = JBitLinear(K, N, prelu=prelu)
    params = _np(jax.jit(layer.init)(jax.random.key(seed)))
    params["b"] = _rand((N,), seed + 1, 0.1)
    return params


def _jax_grads(jexp, x, b, alpha):
    """x, b, alpha grads of ``sum(layer(x)**2)`` through the JAX custom VJP,
    b and alpha passed as arguments of a fresh layer (the JAX test's
    ``exp_loss``)."""
    def loss(x, b, alpha):
        e = JLinear(jexp.fmt, jexp.fmt_t, jexp.gamma, b, alpha,
                    kernel=jexp.kernel, a8=jexp.a8)
        return jnp.sum(e(x) ** 2)

    args = (x, b) if alpha is None else (x, b, alpha)
    if alpha is None:
        f = lambda x, b: loss(x, b, None)
    else:
        f = loss
    return [np.asarray(g) for g in jax.jit(jax.grad(
        f, argnums=tuple(range(len(args)))))(*args)]


def _port_grads(tl, x, b, alpha):
    """The same through the port's layer: a bias and a slope that require
    grad, given to a layer over ``tl``'s containers."""
    xs = [torch.from_numpy(x).requires_grad_(),
          torch.from_numpy(b).requires_grad_()]
    if alpha is not None:
        xs.append(torch.from_numpy(alpha).requires_grad_())
    layer = ExportedBitLinear(tl.fmt, tl.gamma, xs[1],
                              None if alpha is None else xs[2],
                              kernel=tl.kernel, a8=tl.a8, fmt_t=tl.fmt_t)
    (layer(xs[0]) ** 2).sum().backward()
    return [t.grad.numpy() for t in xs]


@pytest.mark.parametrize("prelu", [True, False], ids=["prelu", "linear"])
@pytest.mark.parametrize("rows", [8, 40])
def test_dense_backward_against_jax_and_autodiff(prelu, rows):
    params = _layer_params(12 + rows, prelu)
    x = _rand((rows, 48), rows)
    jexp = JLinear.from_params(params, JDense)
    tl = ExportedBitLinear.from_params(params, DenseTernary, **CPU)
    alpha = params.get("alpha")
    want = _jax_grads(jexp, x, params["b"], alpha)
    got = _port_grads(tl, x, params["b"], alpha)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **EXACT)
    # against dense autodiff of x @ (gamma Wq) + b [PReLU]
    Wq, gamma = ternary_quantize(torch.from_numpy(params["w"]))
    xs = [torch.from_numpy(t).requires_grad_()
          for t in (x, params["b"]) + (() if alpha is None else (alpha,))]
    y = xs[0] @ (Wq * gamma) + xs[1]
    if alpha is not None:
        y = torch.where(y > 0, y, xs[2] * y)
    (y ** 2).sum().backward()
    for g, t in zip(got, xs):
        np.testing.assert_allclose(g, t.grad.numpy(), **EXACT)


@pytest.mark.parametrize("kernels", [
    (None, None), ("PallasTiledBitplane_x8", "CudaTiledBitplane_x8")],
    ids=["a8_default", "a8_named"])
def test_a8_bitplane_backward_against_jax(kernels):
    """The A8 layer over TiledBitplane: both backwards requantize the
    cotangent (the x8 kernel is restricted) and run x8 on ``fmt_t``."""
    jk, tk = kernels
    params = _layer_params(3)
    x = _rand((12, 48), 4, 2.0)
    jexp = JLinear.from_params(params, JTiledBitplane, a8=True, kernel=jk)
    tl = ExportedBitLinear.from_params(params, TiledBitplane, a8=True,
                                       kernel=tk, **CPU)
    ck.reset_counts()
    got = _port_grads(tl, x, params["b"], params["alpha"])
    want = _jax_grads(jexp, x, params["b"], params["alpha"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **A8)
    assert not ck.launches   # the CPU takes the plain versions


def test_explicit_restricted_kernel_requantizes():
    """A non-A8 layer named the i8 kernel, on integer x: both backwards
    requantize the cotangent for it (JAX's explicit-kernel branch)."""
    params = _layer_params(5, prelu=False)
    x = np.round(_rand((6, 48), 6, 20.0))
    jexp = JLinear.from_params(params, JTiledBitplane,
                               kernel="PallasTiledBitplane_i8")
    tl = ExportedBitLinear.from_params(params, TiledBitplane,
                                       kernel="CudaTiledBitplane_i8", **CPU)
    got = _port_grads(tl, x, params["b"], None)
    want = _jax_grads(jexp, x, params["b"], None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **A8)


def _fault_case():
    """A non-A8 layer over TiledBitplane with no kernel named, integer x
    (exact through the i8 forward) and a small f32 cotangent ``v``, as a
    loss downstream gives: what the backward must not round away. Returns
    the case and dense autodiff's x grad, ``v @ (gamma Wq)^T``."""
    params = _layer_params(7, prelu=False)
    x = np.round(_rand((6, 48), 8, 20.0))
    v = _rand((6, 96), 9, 0.1)
    Wq, gamma = ternary_quantize(torch.from_numpy(params["w"]))
    return params, x, v, (torch.from_numpy(v) @ (Wq * gamma).T).numpy()


def _within_requantization(got, want):
    """The requantized backward against the exact one: each cotangent row
    rounded to 127 levels of its absmax, so the error is a fraction of a
    percent of the gradient's norm."""
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0.0 < rel < 2e-2, rel


def test_default_dispatch_backward_requantizes():
    """The intended behaviour, which the port takes: default dispatch over
    TiledBitplane is the i8 kernel, restricted, so the backward
    requantizes the cotangent: the x grad is non-zero and within the
    requantization error of dense autodiff."""
    params, x, v, want = _fault_case()
    tl = ExportedBitLinear.from_params(params, TiledBitplane, **CPU)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.warns(UserWarning, match="ROUNDED"):
        y = tl(xt)
    (y * torch.from_numpy(v)).sum().backward()
    assert np.abs(xt.grad.numpy()).sum() > 0
    _within_requantization(xt.grad.numpy(), want)


@pytest.mark.xfail(strict=True, reason=(
    "ternary_spgemm_tpu/models/exported.py:297-300: the backward "
    "requantizes the cotangent only for an explicitly named kernel, so a "
    "default-dispatch layer over TiledBitplane sends its small f32 "
    "cotangent to the _i8 kernel, which floors it to integers"))
def test_jax_default_dispatch_backward():
    params, x, v, want = _fault_case()
    jexp = JLinear.from_params(params, JTiledBitplane)
    with pytest.warns(UserWarning, match="ROUNDED"):
        got = jax.grad(lambda z: jnp.sum(jexp(z) * v))(jnp.asarray(x))
    _within_requantization(np.asarray(got), want)


@pytest.mark.parametrize("fmt", ["bitplane", "dense"])
def test_transposed_containers_equal_jax(fmt):
    jcls, tcls = {"bitplane": (JTiledBitplane, TiledBitplane),
                  "dense": (JDense, DenseTernary)}[fmt]
    params = _layer_params(9, K=80, N=200)
    jexp = JLinear.from_params(params, jcls)
    tl = ExportedBitLinear.from_params(params, tcls, **CPU)
    assert tl.fmt_t.shape == (200, 80)
    for name, arr in tl.fmt_t.arrays().items():
        want = np.asarray(getattr(jexp.fmt_t, name))
        assert arr.numpy().tobytes() == want.astype(arr.numpy().dtype
                                                    ).tobytes()
    W = np.sign(_rand((80, 200), 10)).astype(np.int8)
    jd = JLinear.from_dense(W, jcls)
    td = ExportedBitLinear.from_dense(W, tcls, **CPU)
    for name, arr in td.fmt_t.arrays().items():
        np.testing.assert_array_equal(arr.numpy(),
                                      np.asarray(getattr(jd.fmt_t, name)))


def test_forward_only_layer_raises_jax_error():
    params = _layer_params(11)
    x = torch.from_numpy(_rand((4, 48), 12)).requires_grad_()
    tl = ExportedBitLinear.from_params(params, DenseTernary,
                                       with_transpose=False, **CPU)
    assert tl.fmt_t is None
    with torch.no_grad():
        tl(x)
    y = tl(x)
    with pytest.raises(ValueError, match="with_transpose=False") as te:
        y.sum().backward()
    jexp = JLinear.from_params(params, JDense, with_transpose=False)
    with pytest.raises(ValueError) as je:
        jax.grad(lambda z: jnp.sum(jexp(z)))(jnp.asarray(x.detach().numpy()))
    assert str(te.value) == str(je.value)


def test_no_grad_forward_is_the_plain_forward():
    """Under ``torch.no_grad()`` (serving) the layer skips the autograd
    function and gives the same bits."""
    params = _layer_params(13)
    tl = ExportedBitLinear.from_params(params, TiledBitplane, a8=True, **CPU)
    x = torch.from_numpy(_rand((5, 48), 14))
    with torch.no_grad():
        a = tl(x)
    b = tl(x.clone().requires_grad_())
    assert a.grad_fn is None and b.grad_fn is not None
    assert torch.equal(a, b.detach())


def test_exported_mlp_against_jax():
    model = JMLP([16, 32, 8])
    params = _np(jax.jit(model.init)(jax.random.key(20)))
    x = _rand((4, 16), 21)
    jexp = JExportedMLP.from_params(model, params, JDense)
    texp = ExportedMLP.from_params(params, DenseTernary, **CPU)
    xt = torch.from_numpy(x).requires_grad_()
    y = texp(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jexp(x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jax.jit(model.apply)(params, x)), rtol=1e-4, atol=1e-4)
    (y ** 2).sum().backward()
    want = jax.grad(lambda z: jnp.sum(jexp(z) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **EXACT)


@pytest.fixture(scope="module")
def lm_params():
    jcfg = JConfig(**BASE)
    return jcfg, _np(jax.jit(JLM(jcfg).init)(jax.random.key(8)))


@pytest.mark.parametrize("case", ["dense", "a8"])
def test_exported_block_input_grads(lm_params, case):
    """The frozen block backpropagates to its input through its linears'
    backward (the JAX ``test_exported_block_input_gradients_flow``), the
    grads against JAX's."""
    jcfg, params = lm_params
    cfg = BitTransformerConfig(**BASE)
    jcls, tcls, a8 = {"dense": (JDense, DenseTernary, False),
                      "a8": (JTiledBitplane, TiledBitplane, True)}[case]
    jb = JBlock.from_params(jcfg, params["blocks"][0], jcls, a8=a8)
    tb = ExportedTransformerBlock.from_params(cfg, params["blocks"][0], tcls,
                                              a8=a8, **CPU)
    x = _rand((2, 8, BASE["d_model"]), 9)
    want = jax.jit(jax.grad(lambda z: jnp.sum(jb(z) ** 2)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tb(xt) ** 2).sum().backward()
    assert bool(torch.isfinite(xt.grad).all()) and xt.grad.abs().sum() > 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **BLOCK)


def test_jax_bundle_with_transposes_backpropagates(lm_params, tmp_path):
    """A bundle the JAX package saved with ``with_transpose=True`` loads
    with its transposed containers beside the rest of each linear and
    backpropagates as JAX's model does."""
    jcfg, params = lm_params
    jlm = JExportedLM.from_params(JLM(jcfg), params, JTiledBitplane, a8=True)
    path = str(tmp_path / "t.npz")
    jsave(path, jlm)
    lm = tck.load_lm_bundle(path, **CPU)
    lin = lm.blocks[0].linears["w_down"]
    assert lin.fmt_t is not None and lin.fmt_t.device == lin.fmt.device
    assert "fmt_t_plane" in dict(lin.named_buffers())
    x = _rand((1, 6, BASE["d_model"]), 10)
    want = jax.jit(jax.grad(lambda z: jnp.sum(jlm.blocks[1](z) ** 2)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (lm.blocks[1](xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **BLOCK)
    tck.save_lm_bundle(str(tmp_path / "back.npz"), lm)
    back = jload(str(tmp_path / "back.npz"))
    assert back.blocks[0].linears["wq"].fmt_t is not None


def test_serving_exports_have_no_transposes(lm_params):
    jcfg, params = lm_params
    cfg = BitTransformerConfig(**BASE)
    lms = [lm_from_jax_params(cfg, params, a8=True, fused_qkv=False,
                              fused_ffn=False, **CPU),
           build_serving_lm(preset_config("test"), **CPU)]
    for lm in lms:
        lins = [l for b in lm.blocks for l in b.linears.values()]
        assert lins and all(l.fmt_t is None for l in lins)
        assert not any("fmt_t" in n for n, _ in lm.named_buffers())
    full = ExportedTransformerLM.from_params(cfg, params, a8=True, **CPU)
    assert all(l.fmt_t is not None for b in full.blocks
               for l in b.linears.values())


def test_port_trained_tree_serves_in_both_packages(lm_params, tmp_path):
    """A tree trained in the port (two Adam steps) carried back to the JAX
    layout: the JAX QAT model gives the port's logits, and its serving
    export, saved by the port, loads in JAX with the same logits."""
    jcfg, params = lm_params
    cfg = BitTransformerConfig(**BASE)
    lm = qat_lm_from_jax_params(cfg, params, **CPU)
    step = make_lm_train_step(lm, torch.optim.Adam(lm.parameters(), lr=3e-3))
    toks = np.random.default_rng(3).integers(0, BASE["vocab"], (2, 8))
    for _ in range(2):
        step(torch.from_numpy(toks))
    tree = jax_tree(lm)
    np.testing.assert_allclose(
        lm(torch.from_numpy(toks)).detach().numpy(),
        np.asarray(jax.jit(JLM(jcfg).apply)(tree, jnp.asarray(toks))),
        rtol=1e-5, atol=2e-5)
    served = lm_from_jax_params(cfg, tree, a8=True, fused_qkv=True,
                                fused_ffn=True, **CPU)
    path = str(tmp_path / "trained.npz")
    tck.save_lm_bundle(path, served)
    jlm = jload(path)
    np.testing.assert_allclose(served(torch.from_numpy(toks)).numpy(),
                               np.asarray(jlm(jnp.asarray(toks))), **BLOCK)
