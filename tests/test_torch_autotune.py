"""Port parity: autotune (``ops/autotune.py``), ``kernel="auto"`` and the
serving flags (``models/generate.py::autotune_serving_flags``) against the
JAX package's, on the CPU.

* ``candidates_for`` names the JAX package's candidates, kernel by
  counterpart, for every container at every domain bucket;
* the memo key and the JSON key string are the JAX package's (the device
  type in the backend's place), and a cache file written by either
  package is read by the other, the kernel under its JAX registry name;
* ``ternary_spgemm(kernel="auto")``, ``ExportedBitLinear(kernel="auto")``,
  ``autotune_exported``, ``autotune_serving_flags`` and
  ``from_params(auto=True)`` run with a tiny ``min_seconds`` and give the
  dense reference's results; on the CPU a candidate that raises is
  skipped with a warning that names it (on the card only one that refuses
  the shape, ``tests/test_torch_cuda.py``);
* the serving flags' key appends K/V heads other than ``n_heads`` and a
  caller's kernel, so a pick for one never answers the other;
* the reference faults, each an ``xfail`` cell with its citation: the JAX
  probe passes ``cfg.n_heads`` for the heads, so GQA fails
  (``ternary_spgemm_tpu/models/generate.py:580``); ``from_params`` does
  not pass the caller's ``kernel`` on
  (``ternary_spgemm_tpu/models/generate.py:417``); an A8 layer with
  ``kernel="auto"`` measures its raw input, not the requantized one its
  kernel receives (``ternary_spgemm_tpu/models/exported.py:137``).

No JAX Pallas kernel is timed here: the JAX probes run over DenseTernary
(XLA kernels only), and the file exchange reads what the other package
wrote without probing.
"""

import dataclasses
import importlib
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import formats as jf
from ternary_spgemm_tpu.models import BitTransformerConfig as JConfig
from ternary_spgemm_tpu.models import BitTransformerLM
from ternary_spgemm_tpu_torch import formats as tf
from ternary_spgemm_tpu_torch import reference
from ternary_spgemm_tpu_torch.models import (
    BitTransformerConfig,
    ExportedBitLinear,
    ExportedTransformerLM,
    autotune_exported,
    autotune_serving_flags,
)
from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS, ternary_spgemm
from ternary_spgemm_tpu_torch.ops import api
from ternary_spgemm_tpu_torch.ops import autotune as tat

#: the JAX package's autotune module (its ``ops`` exports the function
#: of that name)
jat = importlib.import_module("ternary_spgemm_tpu.ops.autotune")
#: both packages' ``models/generate.py`` (``models`` exports the function)
jgen = importlib.import_module("ternary_spgemm_tpu.models.generate")
tgen = importlib.import_module("ternary_spgemm_tpu_torch.models.generate")
TINY = 0.001
SHAPE = dict(vocab=32, d_model=64, n_heads=4, d_ff=128, n_layers=1)


@pytest.fixture(autouse=True)
def empty_memos():
    tat._CACHE.clear()
    jat._CACHE.clear()
    yield
    tat._CACHE.clear()
    jat._CACHE.clear()


def _setup():
    W = jf.generate_ternary(64, 128, 4, seed=0)
    X = jf.generate_x(8, 64, seed=1)               # integer, |x| <= 512
    return W, X, jf.generate_bias(128)


def _kwargs(name):
    return {"block_size": 32} if "Blocked" in name and "Ell" not in name \
        else {}


@pytest.mark.parametrize("domain", [(100.0, True), (200.0, True),
                                    (512.0, True), (600.0, True),
                                    (3.5, False)],
                         ids=["127", "256", "512", "inf", "float"])
@pytest.mark.parametrize("name", sorted(tf.all_formats()))
def test_candidates_name_jax_candidates(name, domain):
    W = jf.generate_ternary(64, 96, 3, seed=2)
    j = jf.all_formats()[name].from_dense(W, **_kwargs(name))
    t = tf.all_formats()[name].from_dense(W, **_kwargs(name))
    want = {REFERENCE_KERNELS[s.name] for s in jat.candidates_for(j, *domain)}
    got = [s.name for s in tat.candidates_for(t, *domain)]
    assert len(got) == len(want) and set(got) == want


@pytest.mark.parametrize("absmax,integer,prelu", [
    (100.0, True, False), (256.0, True, True), (512.0, True, False),
    (513.0, True, False), (2.5, False, True)])
def test_key_and_string_are_jax(absmax, integer, prelu):
    W, _, _ = _setup()
    j, t = jf.TiledBitplane.from_dense(W), tf.TiledBitplane.from_dense(W)
    jkey = jat._key(j, 8, absmax, integer, prelu)
    tkey = tat._key(t, 8, absmax, integer, prelu, "cpu")
    assert jax.default_backend() == "cpu"
    assert tkey == jkey
    assert tat._skey(tkey) == "|".join(map(str, jkey))
    assert tat._domain_bucket(absmax, integer) == \
        jat._domain_bucket(absmax, integer)


def test_domain_matches_jax():
    rng = np.random.default_rng(3)
    for X in (jf.generate_x(5, 33, seed=4), rng.uniform(-3, 3, (4, 9)),
              np.zeros((0, 4))):
        X = X.astype(np.float32)
        assert tat._domain(torch.from_numpy(X)) == jat._domain(X)


def test_autotune_winner_memo_and_file(tmp_path):
    W, X, b = _setup()
    fmt = tf.TiledBitplane.from_dense(W)
    cache = str(tmp_path / "tune.json")
    name = tat.autotune(torch.from_numpy(X), fmt, b, min_seconds=TINY,
                        cache_path=cache)
    assert name in {s.name for s in tat.candidates_for(fmt, 512.0, True)}
    disk = json.load(open(cache))
    key = "cpu|TiledBitplane|8|64|128|512.0|True|False"
    assert disk == {key: api.jax_name(name)}
    assert name == REFERENCE_KERNELS[disk[key]]
    # a memo hit: no probe (a probe would raise here)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tat, "time_call", _no_probe)
        assert tat.autotune(torch.from_numpy(X), fmt, b, cache_path=cache) \
            == name
    got = ternary_spgemm(torch.from_numpy(X), fmt, torch.from_numpy(b),
                         kernel=name)
    assert reference.compare_results(got, reference.dense_gemm(X, W, b))


def _no_probe(*a, **k):
    raise AssertionError("probed where the memo or the file should answer")


def test_jax_file_read_by_the_port(tmp_path, monkeypatch):
    W, X, b = _setup()
    cache = str(tmp_path / "jax.json")
    skey = "|".join(map(str, jat._key(jf.TiledBitplane.from_dense(W), 8,
                                      512.0, True, False)))
    jat._write_disk(cache, skey, "PallasTiledBitplane_i8")
    monkeypatch.setattr(tat, "time_call", _no_probe)
    got = tat.autotune(torch.from_numpy(X), tf.TiledBitplane.from_dense(W), b,
                       cache_path=cache)
    assert got == "CudaTiledBitplane_i8"


def test_port_file_read_by_jax(tmp_path, monkeypatch):
    W, X, b = _setup()
    cache = str(tmp_path / "port.json")
    name = tat.autotune(torch.from_numpy(X), tf.TiledBitplane.from_dense(W),
                        b, min_seconds=TINY, cache_path=cache)

    def no_jax_probe(*a, **k):
        raise AssertionError("JAX probed where the file should answer")

    monkeypatch.setattr("ternary_spgemm_tpu.bench.timing.time_device_loop",
                        no_jax_probe)
    assert jat.autotune(X, jf.TiledBitplane.from_dense(W), b,
                        cache_path=cache) == api.jax_name(name)


def test_serving_flag_keys_shared(tmp_path, monkeypatch):
    """The serving flags' key string is the JAX package's, and each
    package reads the other's entry without probing."""
    cfg = BitTransformerConfig(**SHAPE)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    cache = str(tmp_path / "flags.json")
    jat._write_disk(cache, "cpu|servingflags|TiledBitplane|64|4|128|4|True",
                    "qkv")
    monkeypatch.setattr(tat, "time_call", _no_probe)
    assert autotune_serving_flags(cfg, None, rows=4, cache_path=cache,
                                  device="cpu") == {"fused_ffn": False,
                                                    "fused_qkv": True}
    tat.write_cache(cache, "cpu|servingflags|TiledBitplane|64|4|128|2|True",
                    "ffn_qkv")
    monkeypatch.setattr("ternary_spgemm_tpu.bench.timing.time_device_loop",
                        _no_probe)
    assert jgen.autotune_serving_flags(
        jcfg, None, jf.TiledBitplane, rows=2, cache_path=cache) == {
        "fused_ffn": True, "fused_qkv": True}


def test_serving_flag_key_holds_kv_heads_and_kernel(tmp_path, monkeypatch):
    """A pick stored under the JAX key (MHA, no kernel) does not answer a
    GQA model of the same widths or a caller's kernel: each probes and is
    stored under its own key."""
    cache = str(tmp_path / "flags.json")
    base = "cpu|servingflags|TiledBitplane|64|4|128|1|True"
    tat.write_cache(cache, base, "qkv")
    probed = []

    def probe(fn, x, **k):
        probed.append(1)
        return 1.0

    monkeypatch.setattr(tat, "time_call", probe)
    for kv, kernel, extra in ((2, None, "|kv_heads=2"),
                              (0, "CudaTiledBitplane_i8",
                               "|kernel=PallasTiledBitplane_i8")):
        cfg = BitTransformerConfig(n_kv_heads=kv, **SHAPE)
        probed.clear()
        autotune_serving_flags(cfg, _tree(cfg)["blocks"][0], kernel=kernel,
                               cache_path=cache, device="cpu")
        assert probed, (kv, kernel)
        assert (base + extra) in json.load(open(cache))
    assert json.load(open(cache))[base] == "qkv"


def test_kernel_auto_dispatch():
    W, X, b = _setup()
    fmt = tf.TiledBitplane.from_dense(W)
    y = ternary_spgemm(torch.from_numpy(X), fmt, torch.from_numpy(b),
                       kernel="auto")
    assert len(tat._CACHE) == 1
    assert reference.compare_results(y, reference.dense_gemm(X, W, b))


def test_failed_candidate_is_skipped_with_a_warning(monkeypatch):
    W, X, b = _setup()
    spec = api.get_kernel("CudaTiledBitplane_i8")

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setitem(api._KERNEL_REGISTRY, spec.name,
                        dataclasses.replace(spec, fn=broken))
    X = np.clip(X, -127, 127)          # three candidates: x8, bf16 and i8
    with pytest.warns(UserWarning, match="CudaTiledBitplane_i8 failed.*"
                                         "launch failed"):
        name = tat.autotune(torch.from_numpy(X),
                            tf.TiledBitplane.from_dense(W), b,
                            min_seconds=TINY)
    assert name != "CudaTiledBitplane_i8"


def test_exported_layer_kernel_auto(tmp_path):
    W, X, b = _setup()
    want = reference.dense_gemm(X, W, b)
    layer = ExportedBitLinear.from_dense(W, tf.TiledBitplane, bias=b,
                                         kernel="auto")
    got = layer(torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert layer.kernel not in (None, "auto")
    # A8: measured on the requantized activations the kernel receives
    a8 = ExportedBitLinear.from_dense(W, tf.TiledBitplane, bias=b,
                                      kernel="auto", a8=True)
    ref = ExportedBitLinear.from_dense(W, tf.TiledBitplane, bias=b, a8=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 64)).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y = a8(x)
    assert a8.kernel in {s.name for s in tat.candidates_for(
        a8.fmt, 127.0, True)}
    torch.testing.assert_close(y, ref(x), rtol=0, atol=0)
    # a whole model, through the JSON file
    picks = autotune_exported(torch.nn.Sequential(layer, a8), 8,
                              cache_path=str(tmp_path / "serve.json"))
    assert picks == {(64, 128): a8.kernel} and layer.kernel == a8.kernel
    assert (tmp_path / "serve.json").exists()


@pytest.mark.xfail(strict=True, raises=TypeError, reason=(
    "ternary_spgemm_tpu/models/exported.py:137: an A8 layer with "
    "kernel='auto' measures the raw activations, not the requantized ones "
    "its kernel receives, so over TiledBitplane (integer kernels only) it "
    "finds no candidate for non-integer x"))
def test_jax_a8_layer_kernel_auto():
    from ternary_spgemm_tpu.models import ExportedBitLinear as JLinear

    W, _, b = _setup()
    layer = JLinear.from_dense(W, jf.TiledBitplane, bias=b, kernel="auto",
                               a8=True, with_transpose=False)
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    assert np.asarray(layer(x)).shape == (8, 128)


def _tree(cfg, seed=0):
    """A JAX ``BitTransformerLM.init``-shaped tree, numpy, FFN biasless."""
    params = BitTransformerLM(JConfig(**dataclasses.asdict(cfg))).init(
        jax.random.key(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    for blk in tree["blocks"]:
        for n in ("w_gate", "w_up", "w_down"):
            blk[n]["b"] = np.zeros_like(blk[n]["b"])
    return tree


@pytest.mark.parametrize("kv", [0, 2], ids=["mha", "gqa"])
def test_serving_flags_and_from_params_auto(tmp_path, kv):
    cfg = BitTransformerConfig(n_kv_heads=kv, **SHAPE)
    tree = _tree(cfg)
    cache = str(tmp_path / "serve.json")
    picks = autotune_serving_flags(cfg, tree["blocks"][0], min_seconds=TINY,
                                   repeats=1, cache_path=cache, device="cpu",
                                   kernel="auto")
    assert set(picks) == {"fused_ffn", "fused_qkv"}
    assert all(isinstance(v, bool) for v in picks.values())
    disk = json.load(open(cache))
    # the JAX key; K/V heads other than n_heads and the caller's kernel
    # appended (JAX's probe has no GQA and takes no kernel)
    assert list(disk) == ["cpu|servingflags|TiledBitplane|64|4|128|1|True"
                          + ("|kv_heads=2" if kv else "") + "|kernel=auto"]
    assert list(disk.values()) == [tgen.FLAG_NAMES[(picks["fused_ffn"],
                                                    picks["fused_qkv"])]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tat, "time_call", _no_probe)
        lm = ExportedTransformerLM.from_params(
            cfg, tree, a8=True, auto=True, cache_path=cache, device="cpu",
            kernel="auto")
    blk = lm.blocks[0]
    assert blk.fused_ffn == picks["fused_ffn"]
    assert (blk.qkv is not None) == picks["fused_qkv"]
    toks = torch.randint(0, cfg.vocab, (1, 4),
                         generator=torch.Generator().manual_seed(1))
    logits = lm(toks)
    assert bool(torch.isfinite(logits).all())
    # the layers that ran resolved "auto" on their first call
    assert blk.linears["wo"].kernel not in (None, "auto")
    if blk.qkv is not None:
        assert blk.kernel not in (None, "auto")
    fixed = ExportedTransformerLM.from_params(
        cfg, tree, a8=True, fused_ffn=picks["fused_ffn"],
        fused_qkv=picks["fused_qkv"], device="cpu")
    torch.testing.assert_close(logits, fixed(toks), rtol=2e-3, atol=2e-3)


def test_serving_flags_passes_the_callers_kernel(monkeypatch):
    seen = {}

    def record(*a, **k):
        seen.update(k)
        return {"fused_ffn": False, "fused_qkv": False}

    monkeypatch.setattr(tgen, "autotune_serving_flags", record)
    cfg = BitTransformerConfig(**SHAPE)
    ExportedTransformerLM.from_params(cfg, _tree(cfg), a8=True, auto=True,
                                      kernel="CudaTiledBitplane_i8",
                                      device="cpu")
    assert seen["kernel"] == "CudaTiledBitplane_i8"


@pytest.mark.xfail(strict=True, reason=(
    "ternary_spgemm_tpu/models/generate.py:417: from_params(auto=True) does "
    "not pass the caller's kernel on to autotune_serving_flags"))
def test_jax_serving_flags_passes_the_callers_kernel(monkeypatch):
    seen = {}

    def record(*a, **k):
        seen.update(k)
        return {"fused_ffn": False, "fused_qkv": False}

    monkeypatch.setattr(jgen, "autotune_serving_flags", record)
    jcfg = JConfig(**SHAPE)
    model = BitTransformerLM(jcfg)
    jgen.ExportedTransformerLM.from_params(
        model, model.init(jax.random.key(0)), jf.DenseTernary,
        kernel="DenseMXU_x8", a8=True, with_transpose=False, auto=True)
    assert seen.get("kernel") == "DenseMXU_x8"


@pytest.mark.xfail(strict=True, reason=(
    "ternary_spgemm_tpu/models/generate.py:580: the probe passes "
    "cfg.n_heads, not cfg.head_tuple, so a GQA block's decode fails"))
def test_jax_serving_flags_gqa(tmp_path):
    jcfg = JConfig(n_kv_heads=2, **SHAPE)
    params = BitTransformerLM(jcfg).init(jax.random.key(0))
    picks = jgen.autotune_serving_flags(
        jcfg, params["blocks"][0], jf.DenseTernary, min_seconds=TINY,
        repeats=1)
    assert set(picks) == {"fused_ffn", "fused_qkv"}


def test_autotune_refuses_no_exact_kernel():
    W, _, b = _setup()
    x = torch.full((4, 64), 0.5)
    with pytest.raises(TypeError, match="no exact kernel"):
        tat.autotune(x, tf.TiledBitplane.from_dense(W), b)
