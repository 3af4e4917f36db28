"""The rest of the port's ``generate`` on the CPU, against the JAX package:
rotary at an offset, chunked prefill, the ring KV cache, ``from_params``.

* ``rotary_embed(x, offset=s)`` gives row t the bits of ``_rotary_at`` at
  position s + t (int and 0-d tensor offsets), and JAX's values.
* ``chunked_prefill`` (chunks that divide the prompt and chunks that do
  not) fills the caches of the unchunked prefill bit for bit on the CPU
  (each row's softmax sums its keys the same way whatever the masked
  slots after them; f32 and int8 caches), and its last logits within
  1e-6: the f32 head is one matmul, which the CPU sums in another order
  for one row than for several. Against JAX's ``chunked_prefill``: the
  last logits and the caches within ``TOL``.
* ``generate(ring=True)`` gives JAX's ``generate(ring=True)`` tokens, with
  the prefill (a prompt within the window) and without (a longer prompt
  fed token by token), eagerly and through ``GenerateLoop``; the
  generation runs past the window, so the ring wraps. JAX's documented
  errors are raised with their conditions.
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
from ternary_spgemm_tpu.models.generate import (
    chunked_prefill as jchunked_prefill,
)
from ternary_spgemm_tpu.models.generate import generate as jgenerate
from ternary_spgemm_tpu.models.generate import init_cache as jinit_cache
from ternary_spgemm_tpu.models.transformer import (
    rotary_embed as jrotary_embed,
)
from ternary_spgemm_tpu_torch.models import (
    BitTransformerConfig,
    ExportedTransformerLM,
    generate,
    init_cache,
    lm_from_jax_params,
)
from ternary_spgemm_tpu_torch.models.generate import (
    _rotary_at,
    chunked_prefill,
)
from ternary_spgemm_tpu_torch.models.graphs import GenerateLoop
from ternary_spgemm_tpu_torch.models.transformer import rotary_embed

SHAPE = dict(vocab=48, d_model=64, n_heads=4, d_ff=128, n_layers=2)
#: (n_kv_heads, window) of each model: MHA, GQA, sliding window
CONFIGS = {"mha": (0, 0), "gqa": (2, 0), "window": (0, 3)}
#: the port's model tolerance (``tests/test_torch_model.py``)
TOL = dict(rtol=2e-3, atol=2e-3)
T0 = 8


def build(kv: int, window: int):
    """The JAX export, the port's from the same tree, a prompt, the tree."""
    jcfg = JConfig(n_kv_heads=kv, window=window, **SHAPE)
    params = BitTransformerLM(jcfg).init(jax.random.key(5))
    jlm = JLM.from_params(BitTransformerLM(jcfg), params, JTiledBitplane,
                          a8=True, fused_qkv=True, fused_ffn=True,
                          with_transpose=False)
    tcfg = BitTransformerConfig(n_kv_heads=kv, window=window, **SHAPE)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tlm = lm_from_jax_params(tcfg, tree, a8=True, fused_qkv=True,
                             fused_ffn=True, device="cpu")
    prompt = np.random.default_rng(kv + 7 * window).integers(
        0, SHAPE["vocab"], (2, T0)).astype(np.int32)
    return jlm, tlm, prompt, tree


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return build(*CONFIGS[request.param])


@pytest.fixture(scope="module")
def window_model():
    return build(*CONFIGS["window"])


def _clone(caches):
    return [{k: v.clone() for k, v in c.items()} for c in caches]


@pytest.mark.parametrize("offset", [0, 5, 37])
def test_rotary_offset_is_rotary_at_each_position(offset):
    x = torch.from_numpy(np.random.default_rng(offset).standard_normal(
        (2, 3, 4, 16)).astype(np.float32))
    want = np.asarray(jrotary_embed(jnp.asarray(x.numpy()), offset=offset))
    for off in (offset, torch.tensor(offset)):
        got = rotary_embed(x, offset=off)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        for t in range(x.shape[2]):
            assert torch.equal(got[:, :, t:t + 1],
                               _rotary_at(x[:, :, t:t + 1], offset + t))


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
def test_chunked_prefill_is_unchunked(models, chunk, cache_dtype):
    """Chunks of 1, 3 (not dividing the prompt), 4 and 8 (the whole
    prompt, one chunk at start 0): the caches of the whole-prompt prefill
    bit for bit, the last position's logits within the head's f32
    summation order."""
    _, tlm, prompt, _ = models
    p = torch.from_numpy(prompt).long()
    max_t = T0 + 4
    want_logits, want = tlm.prefill(p, init_cache(tlm.cfg, 2, max_t,
                                                  cache_dtype))
    logits, got = chunked_prefill(tlm, p, init_cache(tlm.cfg, 2, max_t,
                                                     cache_dtype), chunk)
    assert logits.shape == (2, T0 - (T0 - 1) // chunk * chunk, SHAPE["vocab"])
    torch.testing.assert_close(logits[:, -1], want_logits[:, -1],
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(got, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_chunked_prefill_matches_jax(models):
    """Chunks of 3 (the last one shorter) against JAX's."""
    jlm, tlm, prompt, _ = models
    chunk = 3
    max_t = T0 + 4
    jl, jc = jchunked_prefill(jlm, jnp.asarray(prompt),
                              jinit_cache(jlm.cfg, 2, max_t), chunk)
    tl, tc = chunked_prefill(tlm, torch.from_numpy(prompt).long(),
                             init_cache(tlm.cfg, 2, max_t), chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a["k"].numpy(), np.asarray(b["k"]), **TOL)
        np.testing.assert_allclose(a["v"].numpy(), np.asarray(b["v"]), **TOL)


def test_chunk_at_tensor_start_is_int_start(models):
    """A chunk at a 0-d tensor start gives the int start's bits."""
    _, tlm, prompt, _ = models
    p = torch.from_numpy(prompt).long()
    caches = init_cache(tlm.cfg, 2, T0, torch.int8)
    tlm.prefill(p[:, :4], caches, start=0)
    a, ca = tlm.prefill(p[:, 4:], _clone(caches), start=4)
    b, cb = tlm.prefill(p[:, 4:], _clone(caches), start=torch.tensor(4))
    assert torch.equal(a, b)
    for x, y in zip(ca, cb):
        for k in x:
            assert torch.equal(x[k], y[k])


@pytest.mark.parametrize("prefill,prompt_len", [(True, 3), (False, T0)])
def test_ring_generate_matches_jax(window_model, prefill, prompt_len):
    """The window model's ring (3 slots) against JAX's ring, 6 new tokens,
    so the ring wraps; the port's ring and full caches agree; the loop the
    card captures, run eagerly, gives the same tokens."""
    jlm, tlm, prompt, _ = window_model
    p = prompt[:, :prompt_len]
    kw = dict(prefill=prefill, cache_dtype=jnp.int8, ring=True)
    want = np.asarray(jgenerate(jlm, jnp.asarray(p), 6, **kw))
    tp = torch.from_numpy(p).long()
    got = generate(tlm, tp, 6, prefill=prefill, cache_dtype=torch.int8,
                   ring=True)
    np.testing.assert_array_equal(got.numpy(), want)
    full = generate(tlm, tp, 6, prefill=prefill, cache_dtype=torch.int8)
    assert torch.equal(full, got)
    loop = GenerateLoop(tlm, 2, prompt_len, prompt_len + 6,
                        cache_dtype=torch.int8, ring=True, prefill=prefill,
                        device="cpu")
    assert loop.caches[0]["k"].shape[2] == tlm.cfg.window
    for _ in range(2):          # the second run after a reset
        assert torch.equal(torch.cat([tp, loop.run(tp, 6)], dim=1), got)


def test_ring_cache_layout(window_model):
    """A ring holds ``window`` slots; decode writes position p at slot
    p % window and records p in ``pos_tab`` (-1: empty)."""
    _, tlm, prompt, _ = window_model
    W = tlm.cfg.window
    caches = init_cache(tlm.cfg, 2, 100, torch.float32, ring=True)
    assert caches[0]["k"].shape[2] == W
    assert torch.equal(caches[0]["pos_tab"], torch.full((W,), -1,
                                                        dtype=torch.int32))
    p = torch.from_numpy(prompt).long()
    _, caches = tlm.prefill(p[:, :2], caches)
    assert caches[0]["pos_tab"].tolist() == [0, 1, -1]
    for t in range(2, 7):
        _, caches = tlm.decode_step(p[:, t], caches, t)
    assert caches[0]["pos_tab"].tolist() == [6, 4, 5]


def test_ring_errors(models):
    """JAX's documented errors: a ring without a window, a ring prompt
    longer than the window with the prefill, a chunk into a ring."""
    _, tlm, prompt, _ = models
    p = torch.from_numpy(prompt).long()
    if not tlm.cfg.window:
        with pytest.raises(ValueError, match="window > 0"):
            generate(tlm, p, 3, ring=True)
        with pytest.raises(ValueError, match="window > 0"):
            init_cache(tlm.cfg, 2, 16, ring=True)
        return
    with pytest.raises(ValueError, match="exceeds the window"):
        generate(tlm, p, 3, ring=True)
    caches = init_cache(tlm.cfg, 2, 16, ring=True)
    with pytest.raises(NotImplementedError, match="ring cache"):
        tlm.prefill(p[:, :2], caches, start=0)
    with pytest.raises(NotImplementedError, match="ring cache"):
        chunked_prefill(tlm, p, caches, 2)


def test_from_params_is_lm_from_jax_params(models):
    """``ExportedTransformerLM.from_params`` builds what the converter
    builds (a serving export: ``with_transpose=False``, which the
    converter's default is and ``from_params``' is not); with ``auto=True``
    it builds what the measured serving flags (``autotune_serving_flags``)
    choose."""
    from ternary_spgemm_tpu_torch.models import autotune_serving_flags

    _, tlm, _, tree = models
    lm = ExportedTransformerLM.from_params(
        tlm.cfg, tree, a8=True, fused_qkv=True, fused_ffn=True, device="cpu",
        with_transpose=False)
    a, b = lm.state_dict(), tlm.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    auto = ExportedTransformerLM.from_params(
        tlm.cfg, tree, a8=True, auto=True, device="cpu")
    picks = autotune_serving_flags(tlm.cfg, tree["blocks"][0], a8=True,
                                   device="cpu")       # the memo's answer
    assert [(b.fused_ffn, b.qkv is not None) for b in auto.blocks] == \
        [(picks["fused_ffn"], picks["fused_qkv"])] * tlm.cfg.n_layers
