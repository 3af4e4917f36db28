"""Port parity: QAT training — ``ternary_spgemm_tpu_torch.models``'
``BitLinear``, ``TernaryMLP``, ``BitTransformerLM``, their ``torch.optim``
steps, ``lm_prefill`` / ``lm_decode_step`` and the weight carry-over —
against the JAX package's counterparts, on the CPU.

The same parameters (drawn by the JAX ``init`` and carried over with
``models/convert.py``) and the same numpy inputs go through both. Forwards
and losses agree within 1e-5, parameter grads within rtol=1e-4, atol=1e-5
(the port runs the norms' reductions in f64, JAX in f32), the optimizer
steps against ``optax.adam`` within the same, the bf16 compute policy
within 0.05 of JAX's (the JAX test's own tolerance against f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ternary_spgemm_tpu.formats import DenseTernary as JDense
from ternary_spgemm_tpu.formats import PackedTernary53 as JPacked53
from ternary_spgemm_tpu.formats import TCSC as JTCSC
from ternary_spgemm_tpu.formats import TiledBitplane as JTiledBitplane
from ternary_spgemm_tpu.models import BitLinear as JBitLinear
from ternary_spgemm_tpu.models import BitTransformerConfig as JConfig
from ternary_spgemm_tpu.models import BitTransformerLM as JLM
from ternary_spgemm_tpu.models import FlaxTernaryMLP
from ternary_spgemm_tpu.models import TernaryMLP as JMLP
from ternary_spgemm_tpu.models import apply_exported as japply
from ternary_spgemm_tpu.models import export_layer as jexport
from ternary_spgemm_tpu.models import lm_loss as jlm_loss
from ternary_spgemm_tpu.models import make_lm_train_step as jlm_step
from ternary_spgemm_tpu.models import make_train_step as jtrain_step
from ternary_spgemm_tpu.models.bitlinear import apply_exported_a8 as japply8
from ternary_spgemm_tpu.models.bitlinear import ternary_quantize_ste as jste
from ternary_spgemm_tpu.models.generate import init_cache as jinit_cache
from ternary_spgemm_tpu.models.generate import lm_decode_step as jdecode
from ternary_spgemm_tpu.models.generate import lm_prefill as jprefill
from ternary_spgemm_tpu_torch.formats import (
    TCSC,
    DenseTernary,
    PackedTernary53,
    TiledBitplane,
)
from ternary_spgemm_tpu_torch.models import (
    BitLinear,
    BitTransformerConfig,
    BitTransformerLM,
    TernaryMLP,
    apply_exported,
    apply_exported_a8,
    export_layer,
    init_cache,
    jax_tree,
    lm_decode_step,
    lm_loss,
    lm_prefill,
    make_lm_train_step,
    make_train_step,
    mlp_from_flax_params,
    mlp_from_jax_params,
    qat_lm_from_jax_params,
    ternary_quantize_ste,
)

BASE = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2)
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
CPU = dict(device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _lm_tree(cfg, seed: int) -> dict:
    """A parameter tree in the shape of the JAX ``BitTransformerLM.init``,
    drawn with numpy (biases and norm scales away from 0 and 1, so that
    their grads show)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width
    shapes = {"wq": (d, d), "wk": (d, kvw), "wv": (d, kvw), "wo": (d, d),
              "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    blocks = [{**{n: {"w": f(*kn) * (2.0 / kn[0]) ** 0.5,
                      "b": 0.1 * f(kn[1])} for n, kn in shapes.items()},
               "norm_attn": 1.0 + 0.1 * f(d), "norm_ffn": 1.0 + 0.1 * f(d)}
              for _ in range(cfg.n_layers)]
    return {"embed": f(cfg.vocab, d) * d ** -0.5, "blocks": blocks,
            "norm_out": 1.0 + 0.1 * f(d)}


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _assert_trees(got, want, **tol):
    """Port tree (numpy, JAX layout) against a JAX tree, leaf by leaf."""
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    gs = jax.tree_util.tree_structure(got)
    assert gs == jax.tree_util.tree_structure(_np(want))
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def _grad_tree(module):
    """The module's parameter grads in the JAX layout (numpy)."""
    from ternary_spgemm_tpu_torch.models.convert import _unflat

    tree = _unflat({k: p.grad.numpy().copy()
                    for k, p in module.named_parameters()})
    return tree["layers"] if isinstance(module, TernaryMLP) else tree


def test_ste_forward_bits_match_jax():
    """``W + (Wq * gamma - W).detach()``: JAX's expression, so its bits
    (not only ``Wq * gamma``'s) where the two means agree: multiples of
    1/256 over 4096 weights sum exactly in f32 in any order. Elsewhere the
    means may differ in the last bit (another summation order)."""
    W = np.round(_rand((64, 64), 0) * 256.0) / 256.0
    got = ternary_quantize_ste(torch.from_numpy(W)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jste(jnp.asarray(W))))
    assert not np.array_equal(got, np.round(got / got.max()) * got.max())
    W = _rand((64, 48), 1)
    np.testing.assert_allclose(ternary_quantize_ste(torch.from_numpy(W)),
                               np.asarray(jste(jnp.asarray(W))), rtol=1e-6)
    w = torch.from_numpy(W).requires_grad_()
    (ternary_quantize_ste(w) * torch.arange(48.0)).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(),
                                  np.broadcast_to(np.arange(48.0), W.shape))


@pytest.mark.parametrize("prelu", [False, True], ids=["linear", "prelu"])
@pytest.mark.parametrize("rows", [4, 33])
def test_bitlinear_forward_and_grads(prelu, rows):
    jl = JBitLinear(48, 96, prelu=prelu)
    params = jax.jit(jl.init)(jax.random.key(rows + prelu))
    x = _rand((rows, 48), rows)
    tl = BitLinear(48, 96, prelu=prelu, **CPU)
    tl.load_state_dict({k: torch.from_numpy(v)
                        for k, v in _np(params).items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = tl(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jax.jit(jl.apply)(params, x)), **FWD)
    (y ** 2).sum().backward()
    loss = lambda p, xx: jnp.sum(jl.apply(p, xx) ** 2)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    for k, v in gp.items():
        np.testing.assert_allclose(getattr(tl, k).grad.numpy(),
                                   np.asarray(v), **GRAD)


def test_bitlinear_bf16_input():
    """bf16 activations: quantized at f32, the weights cast down, the
    result at bf16 (the JAX layer's dtype policy)."""
    jl = JBitLinear(48, 96, prelu=True)
    params = jax.jit(jl.init)(jax.random.key(5))
    x = _rand((8, 48), 5)
    tl = BitLinear(48, 96, prelu=True, **CPU)
    tl.load_state_dict({k: torch.from_numpy(v)
                        for k, v in _np(params).items()})
    got = tl(torch.from_numpy(x).to(torch.bfloat16))
    want = jax.jit(jl.apply)(params, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0.02,
                               atol=0.02)


@pytest.mark.parametrize("features", [[48, 96, 8], [16, 32, 32, 4]],
                         ids=["2layers", "3layers"])
def test_ternary_mlp_forward_and_grads(features):
    model = JMLP(features)
    params = jax.jit(model.init)(jax.random.key(len(features)))
    x = _rand((6, features[0]), 1)
    mlp = mlp_from_jax_params(_np(params), **CPU)
    assert mlp.features == tuple(features)
    y = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jax.jit(model.apply)(params, x)), **FWD)
    (y ** 2).sum().backward()
    want = jax.jit(jax.grad(lambda p: jnp.sum(model.apply(p, x) ** 2)))(
        params)
    _assert_trees(_grad_tree(mlp), want, **GRAD)
    _assert_trees(jax_tree(mlp), params, rtol=0, atol=0)


def test_flax_tree_carries_into_ternary_mlp():
    mod = FlaxTernaryMLP(features=[32, 16, 4])
    x = _rand((8, 12), 9)
    variables = jax.jit(mod.init)(jax.random.key(11), jnp.asarray(x))
    mlp = mlp_from_flax_params(_np(variables), **CPU)
    assert mlp.features == (12, 32, 16, 4)
    assert [l.prelu for l in mlp.layers] == [True, True, False]
    got = mlp(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(mod.apply)(variables, x)), **FWD)


@pytest.mark.parametrize("formats", [(JDense, DenseTernary),
                                     (JPacked53, PackedTernary53)],
                         ids=["dense", "base3"])
def test_export_layer_and_apply_exported(formats):
    jcls, tcls = formats
    layer = JBitLinear(64, 128, prelu=True)
    params = jax.jit(layer.init)(jax.random.key(4))
    x = _rand((8, 64), 5)
    jfmt, jgamma, jb, ja = jexport(params, jcls)
    tfmt, tgamma, tb, ta = export_layer(_np(params), tcls)
    assert tgamma == pytest.approx(jgamma, rel=1e-6)
    for name, arr in tfmt.arrays().items():
        np.testing.assert_array_equal(arr.numpy(), np.asarray(getattr(jfmt,
                                                                      name)))
    got = apply_exported(torch.from_numpy(x), tfmt, tgamma, tb, ta)
    want = japply(x, jfmt, jgamma, jb, ja)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(layer.apply(params, x)),
                               **FWD)


def test_apply_exported_a8_and_its_errors():
    layer = JBitLinear(64, 128, prelu=True)
    params = jax.jit(layer.init)(jax.random.key(6))
    x = _rand((8, 64), 7, scale=3.0)
    jfmt, jgamma, jb, ja = jexport(params, JTiledBitplane)
    tfmt, tgamma, tb, ta = export_layer(_np(params), TiledBitplane)
    got = apply_exported_a8(torch.from_numpy(x), tfmt, tgamma, tb, ta)
    want = japply8(x, jfmt, jgamma, jb, ja)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    with pytest.raises(ValueError, match="needs an int8-native") as te:
        apply_exported_a8(torch.from_numpy(x), tfmt, tgamma, tb,
                          kernel="CudaTiledBitplane_i8")
    with pytest.raises(ValueError, match="needs an int8-native") as je:
        japply8(x, jfmt, jgamma, jb, kernel="PallasTiledBitplane_i8")
    assert str(te.value).replace("Cuda", "Pallas") == str(je.value)
    W = np.sign(_rand((64, 32), 8)).astype(np.int8)
    with pytest.raises(TypeError) as te:
        apply_exported_a8(torch.from_numpy(x), TCSC.from_dense(W), 1.0,
                          np.zeros(32, np.float32))
    with pytest.raises(TypeError) as je:
        japply8(x, JTCSC.from_dense(W), 1.0, np.zeros(32, np.float32))
    assert str(te.value) == str(je.value)


def test_make_train_step_against_optax():
    model = JMLP([8, 32, 4])
    params = jax.jit(model.init)(jax.random.key(2))
    x, y = _rand((64, 8), 3), _rand((64, 4), 4)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    jstep = jax.jit(jtrain_step(model, opt))
    mlp = mlp_from_jax_params(_np(params), **CPU)
    step = make_train_step(mlp, torch.optim.Adam(mlp.parameters(), lr=1e-2))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        params, state, jloss = jstep(params, state, x, y)
        loss = step(xt, yt)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_trees(jax_tree(mlp), params, **GRAD)


@pytest.fixture(scope="module", params=["mha", "gqa", "window"])
def lm_case(request):
    extra = {"mha": {}, "gqa": {"n_kv_heads": 1},
             "window": {"window": 3}}[request.param]
    jcfg = JConfig(**BASE, **extra)
    params = _lm_tree(jcfg, 0)
    toks = np.random.default_rng(1).integers(0, BASE["vocab"], (4, 8))
    return jcfg, BitTransformerConfig(**BASE, **extra), params, toks


def test_lm_loss_and_every_grad(lm_case):
    jcfg, cfg, params, toks = lm_case
    lm = qat_lm_from_jax_params(cfg, _np(params), **CPU)
    loss = lm_loss(lm, torch.from_numpy(toks))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(JLM(jcfg), p, jnp.asarray(toks))))(params)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    _assert_trees(_grad_tree(lm), jgrads, **GRAD)
    np.testing.assert_allclose(
        lm(torch.from_numpy(toks)).detach().numpy(),
        np.asarray(jax.jit(JLM(jcfg).apply)(params, jnp.asarray(toks))),
        rtol=1e-5,
        atol=2e-5)


def test_lm_train_step_against_optax(lm_case):
    jcfg, cfg, params, toks = lm_case
    opt = optax.adam(3e-3)
    state = opt.init(params)
    jstep = jax.jit(jlm_step(JLM(jcfg), opt))
    lm = qat_lm_from_jax_params(cfg, _np(params), **CPU)
    step = make_lm_train_step(lm, torch.optim.Adam(lm.parameters(), lr=3e-3))
    for _ in range(2):
        params, state, jloss = jstep(params, state, jnp.asarray(toks))
        loss = step(torch.from_numpy(toks))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_trees(jax_tree(lm), params, **GRAD)


def test_remat_equals_plain(lm_case):
    """Recomputing the blocks in the backward changes memory, not values."""
    _, cfg, params, toks = lm_case
    import dataclasses

    t = torch.from_numpy(toks)
    grads = []
    for remat in (False, True):
        lm = qat_lm_from_jax_params(dataclasses.replace(cfg, remat=remat),
                                    _np(params), **CPU)
        loss = lm_loss(lm, t)
        loss.backward()
        grads.append((float(loss.detach()), _grad_tree(lm)))
    assert grads[1][0] == pytest.approx(grads[0][0], rel=1e-6)
    _assert_trees(grads[1][1], grads[0][1], rtol=1e-6, atol=1e-7)


def test_bf16_policy_against_jax():
    """bf16 blocks: logits back in f32, within 0.05 of JAX's bf16 model and
    of the port's f32 one (the JAX test's tolerance), the parameters
    staying f32 through a step."""
    jcfg = JConfig(**BASE, compute_dtype="bfloat16")
    params = _lm_tree(jcfg, 0)
    toks = np.random.default_rng(1).integers(0, BASE["vocab"], (4, 8))
    cfg = BitTransformerConfig(**BASE, compute_dtype="bfloat16")
    lm = qat_lm_from_jax_params(cfg, _np(params), **CPU)
    f32 = qat_lm_from_jax_params(BitTransformerConfig(**BASE), _np(params),
                                 **CPU)
    t = torch.from_numpy(toks)
    y = lm(t)
    assert y.dtype == torch.float32
    tol = dict(rtol=0.05, atol=0.05)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jax.jit(JLM(jcfg).apply)(params, jnp.asarray(toks))), **tol)
    np.testing.assert_allclose(y.detach().numpy(), f32(t).detach().numpy(),
                               **tol)
    jloss = float(jax.jit(lambda p: jlm_loss(JLM(jcfg), p, jnp.asarray(toks)))(
        params))
    step = make_lm_train_step(lm, torch.optim.Adam(lm.parameters(), lr=1e-2))
    losses = [float(step(t)) for _ in range(4)]
    assert losses[0] == pytest.approx(jloss, rel=0.05)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in lm.parameters())


def test_qat_model_refuses_moe():
    """An MoE model builds (its parity in ``tests/test_torch_moe.py``); one
    that routes each token to more experts than it has is refused, as the
    JAX ``BitMoEConfig`` refuses it."""
    assert BitTransformerLM(BitTransformerConfig(**BASE, moe_experts=2),
                            **CPU).blocks[0].moe is not None
    with pytest.raises(ValueError, match="top_k=3 outside 1..2"):
        BitTransformerLM(BitTransformerConfig(**BASE, moe_experts=2,
                                              moe_top_k=3), **CPU)


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_lm_prefill_and_decode_step_against_jax(lm_case, cache):
    jcfg, cfg, params, toks = lm_case
    lm = qat_lm_from_jax_params(cfg, _np(params), **CPU)
    B, T0 = 4, 5
    jdt, tdt = ((jnp.float32, torch.float32) if cache == "f32"
                else (jnp.int8, torch.int8))
    jc = jinit_cache(jcfg, B, T0 + 3, dtype=jdt)
    tc = init_cache(cfg, B, T0 + 3, dtype=tdt)
    model = JLM(jcfg)
    jl, jc = jax.jit(lambda p, t, c: jprefill(model, p, t, c))(
        params, jnp.asarray(toks[:, :T0]), jc)
    jstep = jax.jit(lambda p, t, c, pos: jdecode(model, p, t, c, pos))
    tl, tc = lm_prefill(lm, torch.from_numpy(toks[:, :T0]), tc)
    tol = dict(rtol=1e-4, atol=1e-5) if cache == "f32" else dict(
        rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for t in range(T0, T0 + 3):
        jl, jc = jstep(params, jnp.asarray(toks[:, t]), jc, jnp.asarray(t))
        tl, tc = lm_decode_step(lm, torch.from_numpy(toks[:, t]), tc, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for jcache, tcache in zip(jc, tc):
        assert set(jcache) == set(tcache)
        for k in jcache:
            got, want = tcache[k].numpy(), np.asarray(jcache[k])
            if got.dtype == np.int8:
                assert np.abs(got.astype(np.int32) - want).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
