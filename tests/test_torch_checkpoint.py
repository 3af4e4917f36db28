"""The port's checkpoint files against the JAX package's: a container file,
a serving bundle and an ``.npz`` pytree written by either package load in
the other with the same array bytes.

* Containers: each of the 18 containers, both ways, every array
  byte for byte (against the JAX package's device arrays: its packer keeps
  column sums as int64 on the host, which both packages' kernels see as
  int32) and the static fields equal.
* Bundles: JAX ``from_params(..., a8=True, fused_qkv=True,
  fused_ffn=True)``, with and without the transposed containers, saved by
  JAX and loaded by the port: re-saved, every array and the header are
  the JAX file's (``fmt_t`` included; kernel names mapped both ways); the
  port's LM gives JAX's logits within ``TOL`` and its greedy tokens. The
  port's export saved and loaded by JAX: the same.
* The A8 trap: a bundle of ``build_serving_lm`` (merged QKV, no
  ``wq``/``wk``/``wv``) runs A8 in JAX, which reads the regime from
  ``wq``, and JAX's logits are the port's.
* The bf16 head: the raw bits both ways; logits within ``TOL`` of JAX's
  bf16 head; within 0.05 of the f32 head (JAX's own tolerance, at its own
  test's model: d = 32, DenseTernary, no A8), and the head alone within
  0.05 on the A8 model's hidden states (the A8 requantize turns the bf16
  rounding of the looked-up rows into int8 steps, so the whole A8 model
  moves further than the head).
* ``save_pytree``: JAX's flatten order (sorted keys, None no leaf) both
  ways; an orbax directory is refused.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ternary_spgemm_tpu.formats as jformats
from ternary_spgemm_tpu import checkpoint as jck
from ternary_spgemm_tpu.formats import TiledBitplane as JTiledBitplane
from ternary_spgemm_tpu.models import BitTransformerConfig as JConfig
from ternary_spgemm_tpu.models import BitTransformerLM
from ternary_spgemm_tpu.models import ExportedTransformerLM as JLM
from ternary_spgemm_tpu.models.generate import generate as jgenerate
from ternary_spgemm_tpu_torch import checkpoint as tck
from ternary_spgemm_tpu_torch.formats import DenseTernary, all_formats
from ternary_spgemm_tpu_torch.models import (
    BitTransformerConfig,
    ExportedTransformerLM,
    build_serving_lm,
    generate,
    lm_from_jax_params,
)

SHAPE = dict(vocab=48, d_model=64, n_heads=4, d_ff=128, n_layers=2)
#: (n_kv_heads, window) of each model: MHA, GQA, sliding window
CONFIGS = {"mha": (0, 0), "gqa": (2, 0), "window": (0, 3)}
#: the port's model tolerance (``tests/test_torch_model.py``)
TOL = dict(rtol=2e-3, atol=2e-3)
#: the bf16 head against the f32 head (``tests/test_decode.py``)
BF16_TOL = dict(rtol=0.05, atol=0.05)
N_NEW = 4


def _bytes_equal(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _files_equal(a: str, b: str) -> None:
    """Two ``.npz`` files hold the same arrays, byte for byte, and the same
    decoded header."""
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            if k == "header":
                assert tck._decode(x) == tck._decode(y)
            else:
                assert _bytes_equal(x[k], y[k]), k


# ------------------------------------------------------------ containers


def test_format_registry_names_the_ported_containers():
    names = set(all_formats())
    assert len(names) == 18
    assert names == set(jformats.all_formats())
    for name, cls in all_formats().items():
        assert cls.ARRAY_FIELDS == jformats.all_formats()[name].ARRAY_FIELDS


def test_config_fields_are_jax_config_fields():
    """A bundle's ``cfg`` is ``dataclasses.asdict`` of one package's config
    and builds the other's."""
    names = [f.name for f in dataclasses.fields(BitTransformerConfig)]
    assert names == [f.name for f in dataclasses.fields(JConfig)]
    cfg = BitTransformerConfig(n_kv_heads=2, window=3, **SHAPE)
    assert dataclasses.asdict(JConfig(**dataclasses.asdict(cfg))) == \
        dataclasses.asdict(cfg)


def _pair(name: str):
    """One ternary matrix packed by both packages (TCSC with its gather
    tables, without which the JAX loader cannot read it back; the blocked
    containers at 128-row blocks, which K = 256 holds)."""
    W = jformats.generate_ternary(256, 384, 3, seed=1)
    kw = {"block_size": 128} if name in ("BlockedTCSC",
                                         "InterleavedBlockedTCSC") else {}
    j = jformats.all_formats()[name].from_dense(W, **kw)
    t = all_formats()[name].from_dense(W, **kw)
    if name == "TCSC":
        j, t = j.with_ell_tables(), t.with_ell_tables()
    return j, t


def _jax_static(fmt) -> dict:
    return {f.name: getattr(fmt, f.name) for f in dataclasses.fields(fmt)
            if f.name not in fmt.ARRAY_FIELDS}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", sorted(all_formats()))
def test_container_file_both_ways(tmp_path, name, direction):
    j, t = _pair(name)
    rng = np.random.default_rng(0)
    bias = rng.standard_normal(384).astype(np.float32)
    alpha = rng.standard_normal(384).astype(np.float32)
    path = str(tmp_path / "c.npz")
    if direction == "jax_to_port":
        jck.save_container(path, j, gamma=0.25, bias=bias, alpha=alpha)
        fmt, gamma, b, a = tck.load_container(path, device="cpu")
        assert type(fmt) is type(t) and fmt.meta() == _jax_static(j)
        for f in fmt.ARRAY_FIELDS:
            assert _bytes_equal(getattr(fmt, f), jnp.asarray(getattr(j, f))), f
            assert _bytes_equal(getattr(fmt, f), getattr(t, f)), f
    else:
        tck.save_container(path, t, gamma=0.25, bias=bias, alpha=alpha)
        fmt, gamma, b, a = jck.load_container(path)
        assert type(fmt) is type(j) and _jax_static(fmt) == t.meta()
        for f in t.ARRAY_FIELDS:
            assert _bytes_equal(getattr(fmt, f), getattr(t, f)), f
    assert gamma == 0.25
    assert _bytes_equal(b, bias) and _bytes_equal(a, alpha)


def test_legacy_leaf_layout_and_jax_none_fields(tmp_path):
    """The round-1 ``leaf_<i>`` layout loads; a TCSC the JAX package saves
    without its gather tables (pickled Nones, which its own loader cannot
    read back) loads with None tables, and the port writes no such field."""
    j, t = _pair("TiledBitplane")
    path = str(tmp_path / "legacy.npz")
    np.savez(path, leaf_0=np.asarray(j.plane), leaf_1=np.asarray(t.wsum),
             header=tck._encode({"format": "TiledBitplane",
                                 "static": _jax_static(j), "gamma": 2.0}))
    fmt, gamma, bias, alpha = tck.load_container(path, device="cpu")
    assert gamma == 2.0 and bias is None and alpha is None
    assert _bytes_equal(fmt.plane, t.plane) and _bytes_equal(fmt.wsum, t.wsum)

    W = jformats.generate_ternary(64, 32, 4, seed=2)
    jck.save_container(str(tmp_path / "tcsc.npz"),
                       jformats.TCSC.from_dense(W))
    fmt, _, _, _ = tck.load_container(str(tmp_path / "tcsc.npz"),
                                      device="cpu")
    assert fmt.ell_pos is None and fmt.ell_neg is None
    assert torch.equal(fmt.to_dense(), torch.from_numpy(W.astype(np.int8)))
    tck.save_container(str(tmp_path / "t2.npz"), fmt)
    with np.load(str(tmp_path / "t2.npz")) as data:
        assert "field_ell_pos" not in data.files


# --------------------------------------------------------------- bundles


def _params(kv: int, window: int, seed: int = 3):
    jcfg = JConfig(n_kv_heads=kv, window=window, **SHAPE)
    return jcfg, BitTransformerLM(jcfg).init(jax.random.key(seed))


@pytest.fixture(scope="module", params=[
    ("mha", True, None), ("gqa", False, "PallasTiledBitplane_x8"),
    ("window", True, None)], ids=lambda p: f"{p[0]}-t{int(p[1])}")
def bundle(request, tmp_path_factory):
    """A JAX export (with or without its transposed containers; one with
    an explicit kernel), its bundle, the port's export of the same tree
    and a prompt."""
    name, with_t, kernel = request.param
    kv, window = CONFIGS[name]
    jcfg, params = _params(kv, window)
    jlm = JLM.from_params(BitTransformerLM(jcfg), params, JTiledBitplane,
                          a8=True, fused_qkv=True, fused_ffn=True,
                          with_transpose=with_t, kernel=kernel)
    d = tmp_path_factory.mktemp(f"bundle_{name}")
    path = str(d / "jax.npz")
    jck.save_lm_bundle(path, jlm)
    tlm = lm_from_jax_params(
        BitTransformerConfig(n_kv_heads=kv, window=window, **SHAPE),
        jax.tree_util.tree_map(np.asarray, params), a8=True, fused_qkv=True,
        fused_ffn=True, device="cpu",
        kernel=None if kernel is None else "CudaTiledBitplane_x8")
    prompt = np.random.default_rng(kv + window).integers(
        0, SHAPE["vocab"], (2, 6)).astype(np.int32)
    tokens = np.asarray(jgenerate(jlm, jnp.asarray(prompt), N_NEW,
                                  cache_dtype=jnp.int8))
    return jlm, path, tlm, prompt, d, tokens


def test_jax_bundle_loads_and_resaves_byte_identical(bundle):
    jlm, path, _, _, d, _ = bundle
    lm = tck.load_lm_bundle(path, device="cpu")
    blk = lm.blocks[0]
    assert set(blk.linears) == set(jlm.blocks[0].linears)
    assert blk.a8 and blk.qkv is not None and blk.fused_ffn
    assert (blk.linears["wq"].fmt_t is not None) == \
        (jlm.blocks[0].linears["wq"].fmt_t is not None)
    if jlm.blocks[0].kernel is not None:
        assert blk.kernel == "CudaTiledBitplane_x8"
        assert blk.linears["wo"].kernel == "CudaTiledBitplane_x8"
    out = str(d / "port_resave.npz")
    tck.save_lm_bundle(out, lm)
    _files_equal(path, out)


def test_jax_bundle_serves_as_jax(bundle):
    jlm, path, _, prompt, _, tokens = bundle
    lm = tck.load_lm_bundle(path, device="cpu")
    p = torch.from_numpy(prompt).long()
    np.testing.assert_allclose(lm(p).numpy(), np.asarray(jlm(prompt)), **TOL)
    got = generate(lm, p, N_NEW, cache_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), tokens)


def _jax_lm_arrays(lm) -> dict:
    """Every array and scalar a JAX ``ExportedTransformerLM`` serves from,
    by path (the transposed containers left out)."""
    out = {"embed": lm.embed, "norm_out": lm.norm_out}
    for i, b in enumerate(lm.blocks):
        out.update({f"b{i}.norm_attn": b.norm_attn,
                    f"b{i}.norm_ffn": b.norm_ffn, f"b{i}.kernel": b.kernel,
                    f"b{i}.a8": b._a8, f"b{i}.fused_ffn": b.fused_ffn})
        for n, lin in b.linears.items():
            out.update({f"b{i}.{n}.{k}": getattr(lin, k)
                        for k in ("bias", "gamma", "kernel", "a8")})
            out.update({f"b{i}.{n}.fmt.{f}": getattr(lin.fmt, f)
                        for f in lin.fmt.ARRAY_FIELDS})
        out.update({f"b{i}.qkv.{k}": b.qkv[k] for k in ("scale", "bias")})
        out.update({f"b{i}.qkv.fmt.{f}": getattr(b.qkv["fmt"], f)
                    for f in b.qkv["fmt"].ARRAY_FIELDS})
    return out


def test_port_bundle_loads_in_jax(bundle):
    """The port's export of the same tree, saved by the port and loaded by
    JAX: every container, bias, norm and the embedding are JAX's own
    export's, byte for byte (the gammas and the merged QKV's scale within
    1e-6: the port's absmean sums in another order); JAX's logits are the
    port's within ``TOL`` and its greedy tokens the port's."""
    jlm, _, tlm, prompt, d, _ = bundle
    path = str(d / "port.npz")
    tck.save_lm_bundle(path, tlm)
    back = jck.load_lm_bundle(path)
    want, got = _jax_lm_arrays(jlm), _jax_lm_arrays(back)
    assert list(got) == list(want)
    for k, v in want.items():
        if k.endswith((".gamma", ".scale")):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
        elif isinstance(v, (str, bool, type(None))):
            assert got[k] == v, k
        else:
            assert _bytes_equal(got[k], v), k
    assert all(lin.fmt_t is None for b in back.blocks
               for lin in b.linears.values())
    p = torch.from_numpy(prompt).long()
    np.testing.assert_allclose(np.asarray(back(prompt)), tlm(p).numpy(),
                               **TOL)
    want = np.asarray(jgenerate(back, jnp.asarray(prompt), N_NEW,
                                cache_dtype=jnp.int8))
    got = generate(tlm, p, N_NEW, cache_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_bundle_runs_a8_in_jax(tmp_path):
    """The A8 trap: ``build_serving_lm`` holds the merged QKV and no
    ``wq``/``wk``/``wv``; its bundle carries them as the JAX export would
    (the merged container's segments re-packed), so JAX runs it A8 with
    the port's logits, and the port reloads exactly what it saved."""
    cfg = BitTransformerConfig(n_kv_heads=2, **SHAPE)
    lm = build_serving_lm(cfg, s=2, seed=5, device="cpu")
    assert "wq" not in lm.blocks[0].linears
    path = str(tmp_path / "serve.npz")
    tck.save_lm_bundle(path, lm)
    jlm = jck.load_lm_bundle(path)
    d, kvw = cfg.d_model, cfg.kv_width
    for bj, bt in zip(jlm.blocks, lm.blocks):
        assert bj._a8
        W = bt.qkv.fmt.to_dense().numpy()
        for n, lo, hi in (("wq", 0, d), ("wk", d, d + kvw),
                          ("wv", d + kvw, d + 2 * kvw)):
            seg = JTiledBitplane.from_dense(W[:, lo:hi])
            lin = bj.linears[n]
            assert lin.a8 and lin.gamma == float(bt.qkv.scale[lo])
            for f in ("plane", "wsum"):
                assert _bytes_equal(getattr(lin.fmt, f),
                                    jnp.asarray(getattr(seg, f))), (n, f)
    prompt = np.random.default_rng(1).integers(0, SHAPE["vocab"], (2, 6))
    np.testing.assert_allclose(np.asarray(jlm(jnp.asarray(prompt))),
                               lm(torch.from_numpy(prompt)).numpy(), **TOL)
    back = tck.load_lm_bundle(path, device="cpu")
    assert list(back.blocks[0].linears) == list(lm.blocks[0].linears)
    a, b = back.state_dict(), lm.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    lm.blocks[0].qkv.scale[1] *= 2.0
    with pytest.raises(ValueError, match="not one value"):
        tck.save_lm_bundle(str(tmp_path / "bad.npz"), lm)


def test_bf16_head_matches_jax_and_round_trips(tmp_path):
    jcfg, params = _params(2, 0, seed=4)
    jlm = JLM.from_params(BitTransformerLM(jcfg), params, JTiledBitplane,
                          a8=True, fused_qkv=True, fused_ffn=True,
                          with_transpose=False, head_dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = BitTransformerConfig(n_kv_heads=2, **SHAPE)
    kw = dict(a8=True, fused_qkv=True, fused_ffn=True, device="cpu")
    tlm = ExportedTransformerLM.from_params(cfg, tree,
                                            head_dtype=torch.bfloat16, **kw)
    f32 = ExportedTransformerLM.from_params(cfg, tree, **kw)
    assert tlm.embed.dtype == torch.bfloat16
    prompt = np.random.default_rng(2).integers(0, SHAPE["vocab"], (2, 6))
    p = torch.from_numpy(prompt)
    logits = tlm(p)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlm(prompt)), **TOL)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 6, SHAPE["d_model"])).astype(np.float32))
    np.testing.assert_allclose(tlm._head(x).numpy(), f32._head(x).numpy(),
                               **BF16_TOL)

    # the JAX test's own model (tests/test_decode.py): the whole forward
    small = dict(vocab=48, d_model=32, n_heads=2, d_ff=64, n_layers=2)
    sparams = BitTransformerLM(JConfig(**small)).init(jax.random.key(3))
    stree = jax.tree_util.tree_map(np.asarray, sparams)
    heads = [ExportedTransformerLM.from_params(
        BitTransformerConfig(**small), stree, DenseTernary, head_dtype=h,
        device="cpu") for h in (None, torch.bfloat16)]
    want, got = (lm(p) for lm in heads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), **BF16_TOL)

    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_lm_bundle(jpath, jlm)
    loaded = tck.load_lm_bundle(jpath, device="cpu")
    assert loaded.embed.dtype == torch.bfloat16
    bits = np.asarray(jlm.embed).view(np.uint16)
    assert _bytes_equal(loaded.embed.view(torch.int16).numpy().view(np.uint16),
                        bits)
    tck.save_lm_bundle(tpath, tlm)
    back = jck.load_lm_bundle(tpath)
    assert back.embed.dtype == jnp.bfloat16
    assert _bytes_equal(np.asarray(back.embed).view(np.uint16), bits)
    with np.load(tpath) as data:
        assert tck._decode(data)["embed_dtype"] == "bfloat16"
        assert data["embed"].dtype == np.uint16


def test_moe_bundle_is_refused(tmp_path):
    """A JAX MoE bundle loads (its experts, byte for byte, in
    ``tests/test_torch_moe.py``); one whose blocks hold another number of
    experts than its ``cfg.moe_experts`` is refused."""
    jcfg = JConfig(moe_experts=2, **dict(SHAPE, n_layers=1))
    params = BitTransformerLM(jcfg).init(jax.random.key(0))
    jlm = JLM.from_params(BitTransformerLM(jcfg), params, JTiledBitplane,
                          with_transpose=False)
    path = str(tmp_path / "moe.npz")
    jck.save_lm_bundle(path, jlm)
    assert len(tck.load_lm_bundle(path, device="cpu").blocks[0].moe.experts) \
        == 2
    with np.load(path) as data:
        arrays = dict(data)
    header = tck._decode(arrays)
    header["cfg"]["moe_experts"] = 3
    arrays["header"] = tck._encode(header)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="2 experts; its cfg has "
                                         "moe_experts=3"):
        tck.load_lm_bundle(bad, device="cpu")


# --------------------------------------------------------------- pytrees


def _tree():
    """Keys inserted out of order, nested lists and tuples, None leaves."""
    rng = np.random.default_rng(9)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"zeta": [arr(2), None, arr(3, 2)], "alpha": arr(4),
            "mid": {"y": (arr(1), np.arange(5, dtype=np.int32)), "b": None,
                    "a": arr(2, 2)}}


def _tensors(tree):
    """``tree`` with its arrays as tensors, keys in their insertion order
    (``jax.tree_util.tree_map`` would sort them)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return None if tree is None else torch.from_numpy(tree)


def test_pytree_port_to_jax(tmp_path):
    tree = _tree()
    tt = _tensors(tree)
    assert list(tt) == ["zeta", "alpha", "mid"]
    path = str(tmp_path / "p")
    tck.save_pytree(path, tt)
    got = jck.restore_pytree(path, tree)
    want_leaves = jax.tree_util.tree_leaves(tree)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves) == 6
    assert all(_bytes_equal(a, b) for a, b in zip(got_leaves, want_leaves))


def test_pytree_jax_to_port(tmp_path, monkeypatch):
    """The JAX package writes its ``.npz`` where orbax is not importable
    (hidden here); the port restores it into a tree of tensors."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    tree = _tree()
    path = str(tmp_path / "p")
    jck.save_pytree(path, tree)
    like = _tensors(tree)
    got = tck.restore_pytree(path, like)
    assert list(got) == list(like) and list(got["mid"]) == ["y", "b", "a"]
    assert got["zeta"][1] is None and got["mid"]["b"] is None
    assert isinstance(got["mid"]["y"], tuple)
    for a, b in zip(tck._leaves(got), jax.tree_util.tree_leaves(tree)):
        assert isinstance(a, torch.Tensor) and _bytes_equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_pytree(path, {"only": like["alpha"]})


def test_pytree_refuses_orbax_directory(tmp_path):
    """Where orbax is importable the JAX package writes a directory, which
    the port cannot read: a clear error, never a silent skip."""
    pytest.importorskip("orbax.checkpoint")
    tree = {"a": np.zeros(3, np.float32)}
    path = str(tmp_path / "orbax_ckpt")
    jck.save_pytree(path, tree)
    with pytest.raises(ValueError, match="orbax"):
        tck.restore_pytree(path, tree)
