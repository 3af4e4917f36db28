"""Port parity: the exported BitNet W1.58-A8 transformer against the JAX
package, on the CPU (JAX Pallas kernels in interpret mode, the port's plain
kernel versions).

One QAT parameter tree from ``BitTransformerLM.init`` feeds both packages.
Planes must be identical and gammas equal to f32 rounding. Logits agree
within rtol=atol=2e-3: the integer kernel sums are exact in both, but the
glue (norms, rotary, softmax, the f32 head) rounds differently — the port
evaluates its reductions and transcendentals in f64 — and the A8 requantize
can turn such a last-ULP difference at a .5 boundary into one int8 step of
one activation, which moves the logits by ~1e-3 at these widths. Greedy
tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu.formats import TiledBitplane as JTiledBitplane
from ternary_spgemm_tpu.models import BitTransformerConfig as JConfig
from ternary_spgemm_tpu.models import BitTransformerLM
from ternary_spgemm_tpu.models import ExportedTransformerLM as JLM
from ternary_spgemm_tpu.models.exported import ExportedBitLinear as JLinear
from ternary_spgemm_tpu.models.generate import generate as jgenerate
from ternary_spgemm_tpu.models.generate import init_cache as jinit_cache
from ternary_spgemm_tpu_torch.formats import TiledBitplane
from ternary_spgemm_tpu_torch.models import (
    BitTransformerConfig,
    ExportedBitLinear,
    generate,
    init_cache,
    lm_from_jax_params,
)
from ternary_spgemm_tpu_torch.models.convert import lm_from_jax_params as lfp
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

TOL = dict(rtol=2e-3, atol=2e-3)
SHAPE = dict(vocab=48, d_model=64, n_heads=4, d_ff=128, n_layers=2)
LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module", params=[0, 2], ids=["mha", "gqa"])
def models(request):
    jcfg = JConfig(n_kv_heads=request.param, **SHAPE)
    params = BitTransformerLM(jcfg).init(jax.random.key(3))
    jlm = JLM.from_params(BitTransformerLM(jcfg), params, JTiledBitplane,
                          a8=True, fused_qkv=True, fused_ffn=True,
                          with_transpose=False)
    tcfg = BitTransformerConfig(n_kv_heads=request.param, **SHAPE)
    tlm = lm_from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params),
                             a8=True, fused_qkv=True, fused_ffn=True,
                             device="cpu")
    prompt = np.random.default_rng(request.param).integers(
        0, SHAPE["vocab"], (2, 6)).astype(np.int32)
    return jlm, tlm, prompt


def test_containers_identical(models):
    jlm, tlm, _ = models
    assert lm_from_jax_params is lfp
    for jb, tb in zip(jlm.blocks, tlm.blocks):
        for n in LINEARS:
            jl, tl = jb.linears[n], tb.linears[n]
            np.testing.assert_array_equal(tl.fmt.plane.numpy(),
                                          np.asarray(jl.fmt.plane))
            np.testing.assert_array_equal(tl.fmt.wsum.numpy(),
                                          np.asarray(jl.fmt.wsum))
            assert tl.gamma == pytest.approx(jl.gamma, rel=1e-6)
            assert tl.a8 and jl.a8
        np.testing.assert_array_equal(tb.qkv.fmt.plane.numpy(),
                                      np.asarray(jb.qkv["fmt"].plane))
        np.testing.assert_allclose(tb.qkv.scale.numpy(),
                                   np.asarray(jb.qkv["scale"]), rtol=1e-6)
        assert tb._fused_ffn_applicable() and jb._fused_ffn_applicable()


def test_full_forward_parity(models):
    jlm, tlm, prompt = models
    want = np.asarray(jax.jit(lambda m, t: m(t))(jlm, jnp.asarray(prompt)))
    got = tlm(torch.from_numpy(prompt).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_ffn_block_parity_above_128_rows(models, monkeypatch):
    """A block over 200 rows: JAX runs its fused SwiGLU in chunks of 128
    rows (``ternary_spgemm_tpu/models/transformer.py:479-485``), the port in
    one call (``models/transformer.py``, ``_ffn``). Rows are independent
    (the requantize is per row), so the two blocks agree."""
    from ternary_spgemm_tpu.ops import fused_ffn as jffn
    from ternary_spgemm_tpu_torch.models import transformer as ttr

    jlm, tlm, _ = models
    rows = {"jax": [], "port": []}

    def spy(side, fn):
        def run(xq, *a, **kw):
            rows[side].append(int(xq.shape[0]))
            return fn(xq, *a, **kw)
        return run

    monkeypatch.setattr(jffn, "fused_bitplane_swiglu",
                        spy("jax", jffn.fused_bitplane_swiglu))
    monkeypatch.setattr(ttr, "fused_bitplane_swiglu",
                        spy("port", ttr.fused_bitplane_swiglu))
    x = np.random.default_rng(5).standard_normal(
        (2, 100, SHAPE["d_model"])).astype(np.float32)
    want = np.asarray(jlm.blocks[0](jnp.asarray(x)))
    got = tlm.blocks[0](torch.from_numpy(x)).numpy()
    assert rows == {"jax": [128, 72], "port": [200]}
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_and_decode_parity(models):
    jlm, tlm, prompt = models
    B, T0 = prompt.shape
    jc = jinit_cache(jlm.cfg, B, T0 + 2, dtype=jnp.int8)
    tc = init_cache(tlm.cfg, B, T0 + 2, dtype=torch.int8)
    jl, jc = jax.jit(lambda m, t, c: m.prefill(t, c))(jlm, jnp.asarray(prompt),
                                                       jc)
    tl, tc = tlm.prefill(torch.from_numpy(prompt).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)
    jd, _ = jax.jit(lambda m, t, c: m.decode_step(t, c, jnp.int32(T0)))(
        jlm, jnp.asarray(nxt), jc)
    td, _ = tlm.decode_step(torch.from_numpy(nxt).long(), tc, T0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


@pytest.mark.parametrize("prefill", [True, False])
def test_greedy_tokens_identical(models, prefill):
    jlm, tlm, prompt = models
    want = np.asarray(jgenerate(jlm, jnp.asarray(prompt), 5, prefill=prefill,
                                cache_dtype=jnp.int8))
    ck.reset_counts()
    got = generate(tlm, torch.from_numpy(prompt).long(), 5, prefill=prefill,
                   cache_dtype=torch.int8).numpy()
    np.testing.assert_array_equal(got, want)
    assert not ck.launches and not ck.plain_on_cuda     # CPU: plain versions


def test_f32_cache_matches_int8_shape(models):
    _, tlm, prompt = models
    p = torch.from_numpy(prompt).long()
    a = generate(tlm, p, 3, cache_dtype=torch.float32)
    b = generate(tlm, p, 3, cache_dtype=torch.int8)
    assert a.shape == b.shape == (2, 9)
    assert torch.equal(a[:, :6], p) and torch.equal(b[:, :6], p)


def test_non_a8_linear_floors_like_jax():
    """The non-A8 layer over TiledBitplane runs the _i8 kernel through
    default dispatch, which floors non-integer activations (with a warning)
    in both packages."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((96, 80)).astype(np.float32),
              "b": rng.standard_normal(80).astype(np.float32),
              "alpha": np.full(80, 0.1, np.float32)}
    x = (rng.standard_normal((5, 96)) * 20).astype(np.float32)
    jl = JLinear.from_params(params, JTiledBitplane, with_transpose=False)
    tl = ExportedBitLinear.from_params(params, TiledBitplane)
    with pytest.warns(UserWarning, match="ROUNDED"):
        want = np.asarray(jl(jnp.asarray(x)))
    with pytest.warns(UserWarning, match="ROUNDED"):
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_serving_build_runs_the_kernel_path(monkeypatch):
    """The full-width serving build, at a tiny width on the CPU: ternary
    weights of density 1/s, and every forward goes through x8 twice and
    the fused SwiGLU once per layer (the structure chip_smoke.py counts on
    the card)."""
    from ternary_spgemm_tpu_torch.models import build_serving_lm
    from ternary_spgemm_tpu_torch.ops import fused_ffn

    calls = {"x8": 0, "swiglu": 0}
    x8, sw = ck.bitplane_x8_plain, fused_ffn.swiglu_plain

    def count_x8(*a, **k):
        calls["x8"] += 1
        return x8(*a, **k)

    def count_sw(*a, **k):
        calls["swiglu"] += 1
        return sw(*a, **k)

    monkeypatch.setattr(ck, "bitplane_x8_plain", count_x8)
    monkeypatch.setattr(fused_ffn, "swiglu_plain", count_sw)
    cfg = BitTransformerConfig(vocab=40, d_model=64, n_heads=4, d_ff=96,
                               n_layers=3)
    lm = build_serving_lm(cfg, s=2, seed=1, device="cpu")
    W = lm.blocks[0].linears["w_gate"].fmt.to_dense().float()
    assert 0.4 < float(W.abs().mean()) < 0.6 and abs(float(W.mean())) < 0.05
    assert lm.blocks[0].qkv is not None and lm.blocks[0].a8
    assert lm.blocks[0]._fused_ffn_applicable()
    prompt = torch.randint(0, cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(0))
    toks = generate(lm, prompt, 4, cache_dtype=torch.int8)
    assert toks.shape == (2, 9) and bool(((toks >= 0) & (toks < 40)).all())
    forwards = 1 + (4 - 1)
    assert calls == {"x8": 2 * 3 * forwards, "swiglu": 3 * forwards}
    again = generate(lm, prompt, 4, cache_dtype=torch.int8, prefill=False)
    assert torch.equal(again, toks)


@pytest.mark.parametrize("builder", ["build_serving_lm", "lm_from_jax_params"])
def test_builders_default_to_the_card(monkeypatch, builder):
    """Without ``device=`` the builders build on the card, and raise where
    torch sees none; they never build on the CPU unasked."""
    from ternary_spgemm_tpu_torch import models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BitTransformerConfig(vocab=40, d_model=64, n_heads=4, d_ff=96,
                               n_layers=1)
    rng = np.random.default_rng(0)

    def lin(K, N):
        return {"w": rng.standard_normal((K, N)).astype(np.float32),
                "b": np.zeros(N, np.float32)}

    tree = {"embed": np.zeros((40, 64), np.float32),
            "norm_out": np.ones(64, np.float32),
            "blocks": [{"wq": lin(64, 64), "wk": lin(64, 64),
                        "wv": lin(64, 64), "wo": lin(64, 64),
                        "w_gate": lin(64, 96), "w_up": lin(64, 96),
                        "w_down": lin(96, 64), "norm_attn": np.ones(64),
                        "norm_ffn": np.ones(64)}]}
    call = {"build_serving_lm": lambda **kw: models.build_serving_lm(cfg, **kw),
            "lm_from_jax_params": lambda **kw: models.lm_from_jax_params(
                cfg, tree, a8=True, fused_qkv=True, fused_ffn=True, **kw)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[builder]()
    lm = call[builder](device="cpu")
    assert lm.embed.device.type == "cpu"
