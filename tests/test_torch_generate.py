"""The port's generate loop on the CPU: the device-held position, the
sampler and the loop that the card captures (``models/graphs.py``),
against the JAX package.

* A decode step at a 0-d tensor position gives the bits of the step at
  the same int position (logits and every cache array, f32 and int8
  caches): the tensor is what a captured step reads.
* ``sample`` equals JAX's ``_make_sampler`` token for token when it is fed
  the Gumbel noise ``jax.random.categorical`` draws from the same key
  (``jax.random.gumbel(key, shape, float32)``), so no RNG has to match.
* ``generate`` with ``top_k=1`` (any temperature) or ``temperature=0``
  gives the JAX package's greedy tokens; one seed gives one sequence; the
  sampled frequencies follow the truncated softmax.
* :class:`GenerateLoop`, the bodies the card captures over static
  buffers, run eagerly here, gives the eager loop's tokens.
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
from ternary_spgemm_tpu.models.generate import _make_sampler
from ternary_spgemm_tpu.models.generate import generate as jgenerate
from ternary_spgemm_tpu_torch.models import (
    BitTransformerConfig,
    generate,
    init_cache,
    lm_from_jax_params,
)
from ternary_spgemm_tpu_torch.models.generate import (
    gumbel_from_uniform,
    sample,
)
from ternary_spgemm_tpu_torch.models.graphs import GenerateLoop

SHAPE = dict(vocab=48, d_model=64, n_heads=4, d_ff=128, n_layers=2)
#: (n_kv_heads, window) of each model: MHA, GQA, sliding window
CONFIGS = {"mha": (0, 0), "gqa": (2, 0), "window": (0, 3)}
N_NEW = 5


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    kv, window = CONFIGS[request.param]
    jcfg = JConfig(n_kv_heads=kv, window=window, **SHAPE)
    params = BitTransformerLM(jcfg).init(jax.random.key(3))
    jlm = JLM.from_params(BitTransformerLM(jcfg), params, JTiledBitplane,
                          a8=True, fused_qkv=True, fused_ffn=True,
                          with_transpose=False)
    tcfg = BitTransformerConfig(n_kv_heads=kv, window=window, **SHAPE)
    tlm = lm_from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params),
                             a8=True, fused_qkv=True, fused_ffn=True,
                             device="cpu")
    prompt = np.random.default_rng(kv + 7 * window).integers(
        0, SHAPE["vocab"], (2, 6)).astype(np.int32)
    return jlm, tlm, prompt, {}


def jax_greedy(models, prefill: bool) -> np.ndarray:
    """The JAX package's greedy tokens (int8 cache), once per model."""
    jlm, _, prompt, memo = models
    if prefill not in memo:
        memo[prefill] = np.asarray(jgenerate(
            jlm, jnp.asarray(prompt), N_NEW, prefill=prefill,
            cache_dtype=jnp.int8))
    return memo[prefill]


def seeded(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
def test_tensor_pos_decode_is_bitwise_int_pos(models, cache_dtype):
    _, tlm, prompt, _ = models
    p = torch.from_numpy(prompt).long()
    B, T0 = p.shape
    caches = init_cache(tlm.cfg, B, T0 + 3, cache_dtype)
    logits, caches = tlm.prefill(p, caches)
    tok = torch.argmax(logits[:, -1], dim=-1)
    by_int = [{k: v.clone() for k, v in c.items()} for c in caches]
    by_tensor = [{k: v.clone() for k, v in c.items()} for c in caches]
    for t in range(T0, T0 + 3):
        a, by_int = tlm.decode_step(tok, by_int, t)
        b, by_tensor = tlm.decode_step(tok, by_tensor, torch.tensor(t))
        assert torch.equal(a, b)
        for ca, cb in zip(by_int, by_tensor):
            assert ca.keys() == cb.keys()
            for k in ca:
                assert torch.equal(ca[k], cb[k]), (t, k)
        tok = torch.argmax(a, dim=-1)


@pytest.mark.parametrize("key", [0, 1, 2])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.6])
@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sample_matches_jax_sampler(temperature, top_k, top_p, key):
    """Three rows of 64 logits, JAX's Gumbel noise of ``key`` fed to the
    port: the same tokens as ``_make_sampler(T, k, p)(key, logits)``."""
    B, V = 3, 64
    logits = (np.random.default_rng(key).standard_normal((B, V)) * 2.0
              ).astype(np.float32)
    jkey = jax.random.key(key)
    want = np.asarray(_make_sampler(temperature, top_k, top_p)(
        jkey, jnp.asarray(logits)))
    noise = np.array(jax.random.gumbel(jkey, (B, V), jnp.float32))
    got = sample(torch.from_numpy(logits), torch.from_numpy(noise),
                 temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_gumbel_from_uniform_matches_jax_formula():
    """``jax.random.gumbel``'s transform of its uniforms, clamped at f32's
    smallest normal: finite at u = 0."""
    u = np.array([0.0, 1e-40, 1e-30, 0.25, 0.5, 0.999999], np.float32)
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(-jnp.log(-jnp.log(jnp.maximum(jnp.asarray(u), tiny))))
    got = gumbel_from_uniform(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("prefill", [True, False])
def test_top_k1_sampling_is_jax_greedy(models, prefill):
    _, tlm, prompt, _ = models
    got = generate(tlm, torch.from_numpy(prompt).long(), N_NEW,
                   prefill=prefill, cache_dtype=torch.int8, temperature=0.8,
                   top_k=1, generator=seeded(0)).numpy()
    np.testing.assert_array_equal(got, jax_greedy(models, prefill))


@pytest.mark.parametrize("prefill", [True, False])
def test_zero_temperature_is_greedy_and_draws_nothing(models, prefill):
    """``temperature=0`` ignores top_k, top_p and the generator: the JAX
    greedy tokens, and the generator not advanced."""
    _, tlm, prompt, _ = models
    g = seeded(4)
    state = g.get_state()
    got = generate(tlm, torch.from_numpy(prompt).long(), N_NEW,
                   prefill=prefill, cache_dtype=torch.int8, temperature=0.0,
                   top_k=3, top_p=0.5, generator=g).numpy()
    np.testing.assert_array_equal(got, jax_greedy(models, prefill))
    assert torch.equal(g.get_state(), state)


@pytest.mark.parametrize("prefill", [True, False])
def test_one_seed_one_sequence(models, prefill):
    _, tlm, prompt, _ = models
    p = torch.from_numpy(prompt).long()
    kw = dict(prefill=prefill, temperature=1.5, top_p=0.95)
    a = generate(tlm, p, 8, generator=seeded(11), **kw)
    b = generate(tlm, p, 8, generator=seeded(11), **kw)
    c = generate(tlm, p, 8, **kw)                 # None: seeded with 0
    d = generate(tlm, p, 8, generator=seeded(0), **kw)
    assert torch.equal(a, b) and torch.equal(c, d)
    assert a.shape == (2, 6 + 8) and torch.equal(a[:, :6], p)
    assert bool(((a >= 0) & (a < SHAPE["vocab"])).all())


#: the 8 logits of the frequency test
FREQ_LOGITS = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0],
                       np.float32)


def truncated_softmax(logits, temperature, top_k, top_p):
    """The distribution ``sample`` draws from, in f64 numpy."""
    z = logits.astype(np.float64) / temperature
    keep = np.ones(z.shape, bool)
    if top_k:
        keep &= z >= np.sort(z)[::-1][top_k - 1]
    if top_p < 1.0:
        s = np.sort(np.where(keep, z, -np.inf))[::-1]
        p = np.exp(s - s.max())
        p /= p.sum()
        kept = (np.cumsum(p) - p) < top_p
        keep &= z >= s[kept].min()
    p = np.where(keep, np.exp(z - z.max()), 0.0)
    return p / p.sum()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.8, 3, 1.0), (1.3, 0, 0.8), (1.0, 5, 0.9)])
def test_sampled_frequencies_follow_truncated_softmax(temperature, top_k,
                                                      top_p):
    """20,000 draws over 8 logits: each token's count within 4 sigma of
    the truncated softmax, and no draw of a token cut away."""
    n = 20_000
    logits = torch.from_numpy(np.tile(FREQ_LOGITS, (n, 1)))
    u = torch.rand((n, 8), generator=seeded(1))
    toks = sample(logits, gumbel_from_uniform(u), temperature, top_k, top_p)
    counts = np.bincount(toks.numpy(), minlength=8)
    p = truncated_softmax(FREQ_LOGITS, temperature, top_k, top_p)
    sigma = np.sqrt(n * p * (1 - p))
    assert (counts[p == 0] == 0).all()
    assert (np.abs(counts - n * p) <= 4 * sigma + 1e-9).all(), (counts, n * p)


def test_graph_generate_refuses_the_cpu(models):
    _, tlm, prompt, _ = models
    with pytest.raises(ValueError, match="graph=True"):
        generate(tlm, torch.from_numpy(prompt).long(), 3, graph=True)


@pytest.mark.parametrize("prefill", [True, False])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_static_loop_bodies_match_eager(models, prefill, temperature):
    """The bodies the card captures (tensor position, static buffers, the
    prompt token chosen on the device without the prefill), run eagerly
    twice on one loop: the eager loop's tokens, and the same again after a
    reset."""
    _, tlm, prompt, _ = models
    p = torch.from_numpy(prompt).long()
    kw = dict(prefill=prefill, temperature=temperature, top_k=6, top_p=0.9)
    max_t = 6 + N_NEW + 2
    want = generate(tlm, p, N_NEW, max_t=max_t, cache_dtype=torch.int8,
                    generator=seeded(2), **kw)
    loop = GenerateLoop(tlm, 2, 6, max_t, cache_dtype=torch.int8,
                        device="cpu", **kw)
    for _ in range(2):
        got = loop.run(p, N_NEW, seeded(2))
        assert torch.equal(torch.cat([p, got], dim=1), want)
    with pytest.raises(ValueError, match="do not fit"):
        loop.run(p, N_NEW + 3, seeded(2))
