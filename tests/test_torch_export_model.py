"""The port's deployment CLI (``ternary_spgemm_tpu_torch.tools.
export_model``) against the JAX package's (``tools/export_model.py``).

One seeded JAX training state (the params under ``params`` beside
``optax.adam``'s moments, saved as the ``.npz`` the JAX ``save_pytree``
writes where orbax is not importable) goes through both CLIs at the tiny
configs of ``tests/test_aux.py``'s CLI tests:

* the bundles hold the same arrays, byte for byte, and the same header,
  but for the absmean scales (each linear's ``gamma`` and the merged QKV's
  ``scale``), within rtol 1e-6: the two packages sum ``mean|W|`` in
  another order (``tests/test_torch_checkpoint.py`` holds in-process
  exports so);
* ``generate`` prints the JAX CLI's greedy tokens, and at ``--temperature
  0.8 --top-k 8 --seed 3`` its sampled tokens (the port draws JAX's noise,
  ``models/threefry.py``), each CLI on its own bundle and the JAX CLI on
  the port's;
* ``--state-key`` reads only the params; a bare params file falls back, as
  the JAX CLI does; ``--auto`` writes a valid flag combination; without
  ``--device cpu`` the CLI raises where there is no card.
"""

import contextlib
import io
import json
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from ternary_spgemm_tpu import checkpoint as jck
from ternary_spgemm_tpu.models import BitTransformerConfig as JConfig
from ternary_spgemm_tpu.models import BitTransformerLM as JLM
from tools import export_model as jcli
from ternary_spgemm_tpu_torch import checkpoint as tck
from ternary_spgemm_tpu_torch.models import threefry
from ternary_spgemm_tpu_torch.tools import export_model as pcli

#: ``tests/test_aux.py:259`` and ``:304``: (cfg, JAX seed, export flags)
CASES = {
    "dense": (dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2), 5,
              ["--format", "DenseTernary"]),
    "a8_serving": (dict(vocab=32, d_model=64, n_heads=2, d_ff=128,
                        n_layers=1), 6,
                   ["--format", "TiledBitplane", "--a8", "--serving-only",
                    "--fused-ffn", "--fused-qkv", "--head-dtype", "bf16"]),
}
SCALE_TOL = 1e-6
GENERATE = ["--prompt", "1 2 3", "--new-tokens", "6", "--int8-kv"]
SAMPLED = ["--temperature", "0.8", "--top-k", "8", "--seed", "3"]


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _state(cfg_kw, seed):
    params = JLM(JConfig(**cfg_kw)).init(jax.random.key(seed))
    return params, {"params": params, "opt": optax.adam(1e-3).init(params),
                    "step": 0}


@pytest.fixture(scope="module", params=sorted(CASES))
def exported(request, tmp_path_factory):
    """Both CLIs' bundles of one case's saved training state."""
    cfg_kw, seed, flags = CASES[request.param]
    d = tmp_path_factory.mktemp(request.param)
    _, state = _state(cfg_kw, seed)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "orbax.checkpoint", None)
    try:
        jck.save_pytree(str(d / "state"), state)
    finally:
        mp.undo()
    (d / "cfg.json").write_text(json.dumps(cfg_kw))
    common = ["export", "--checkpoint", str(d / "state"), "--cfg",
              str(d / "cfg.json"), *flags]
    _run(jcli.main, [*common, "--out", str(d / "jax.npz")])
    _run(pcli.main, [*common, "--out", str(d / "port.npz"), "--device",
                     "cpu"])
    return d


def _header(data) -> dict:
    return json.loads(bytes(data["header"]).decode())


def _split_scales(node, path=""):
    """The header without its ``gamma`` values, and the gammas by path."""
    if isinstance(node, dict):
        out, gammas = {}, {}
        for k, v in node.items():
            if k == "gamma":
                gammas[path] = v
                continue
            out[k], g = _split_scales(v, f"{path}.{k}")
            gammas.update(g)
        return out, gammas
    if isinstance(node, list):
        parts = [_split_scales(v, f"{path}.{i}") for i, v in enumerate(node)]
        return ([p for p, _ in parts],
                {k: v for _, g in parts for k, v in g.items()})
    return node, {}


def test_bundles_are_the_jax_clis(exported):
    with np.load(exported / "jax.npz") as j, \
            np.load(exported / "port.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            if k == "header":
                continue
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
            if k.endswith(".qkv.scale"):
                np.testing.assert_allclose(p[k], j[k], rtol=SCALE_TOL,
                                           err_msg=k)
            else:
                assert j[k].tobytes() == p[k].tobytes(), k
        hj, gj = _split_scales(_header(j))
        hp, gp = _split_scales(_header(p))
    assert hj == hp
    assert list(gj) == list(gp)
    np.testing.assert_allclose(list(gp.values()), list(gj.values()),
                               rtol=SCALE_TOL)


@pytest.mark.parametrize("sampling", [[], SAMPLED], ids=["greedy", "sampled"])
def test_generate_prints_the_jax_clis_tokens(exported, sampling):
    argv = ["generate", *GENERATE, *sampling]
    want = _run(jcli.main, [*argv, "--bundle", str(exported / "jax.npz")])
    got = _run(pcli.main, [*argv, "--bundle", str(exported / "port.npz"),
                           "--device", "cpu"])
    assert got.split() == want.split() and len(want.split()) == 6
    # the port's bundle in the JAX CLI, the JAX bundle in the port's
    assert _run(jcli.main, [*argv, "--bundle",
                            str(exported / "port.npz")]) == want
    assert _run(pcli.main, [*argv, "--bundle", str(exported / "jax.npz"),
                            "--device", "cpu"]) == got


def test_state_key_reads_only_the_params(tmp_path, monkeypatch):
    """``restore_pytree_key`` picks the params out of the saved state (the
    moments left unread), a bare params file falls back, and the two give
    JAX's params."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    cfg_kw, seed, _ = CASES["dense"]
    params, state = _state(cfg_kw, seed)
    jck.save_pytree(str(tmp_path / "state"), state)
    jck.save_pytree(str(tmp_path / "bare"), params)
    cfg = pcli.BitTransformerConfig(**cfg_kw)
    want = jax.tree_util.tree_leaves(params)
    for path, key in (("state", "params"), ("bare", "params"), ("bare", "")):
        got = pcli.read_params(str(tmp_path / path), cfg, key)
        leaves = tck._leaves(got)
        assert len(leaves) == len(want)
        assert all(np.array_equal(a, np.asarray(b))
                   for a, b in zip(leaves, want)), (path, key)
    like = pcli.params_like(cfg)
    skeleton = {"params": like, "opt": ((0, like, like), ()), "step": 0}
    with pytest.raises(KeyError):
        tck.restore_pytree_key(str(tmp_path / "state"), skeleton, "moments")
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_pytree_key(str(tmp_path / "bare"), skeleton, "params")


def test_auto_writes_a_valid_flag_combination(exported, tmp_path):
    """``--auto`` times the serving flags on the host clock here: which
    combination wins is not held, only that the bundle carries one the
    block can run, and that it serves."""
    out = str(tmp_path / "auto.npz")
    _run(pcli.main, ["export", "--checkpoint", str(exported / "state"),
                     "--cfg", str(exported / "cfg.json"), "--format",
                     "TiledBitplane", "--a8", "--serving-only", "--auto",
                     "--out", out, "--device", "cpu"])
    lm = tck.load_lm_bundle(out, device="cpu")
    for blk in lm.blocks:
        assert isinstance(blk.fused_ffn, bool)
        assert not blk.fused_ffn or blk._fused_ffn_applicable()
    toks = _run(pcli.main, ["generate", "--bundle", out, *GENERATE,
                            "--device", "cpu"]).split()
    assert len(toks) == 6


def test_several_prompts_a_line_each(exported):
    got = _run(pcli.main, ["generate", "--bundle",
                           str(exported / "port.npz"), "--prompt",
                           "1 2 3,4 5 6", "--new-tokens", "3", "--device",
                           "cpu"]).splitlines()
    assert len(got) == 2 and all(len(line.split()) == 3 for line in got)


def test_the_cli_runs_on_the_card_by_default(exported):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["generate", "--bundle", str(exported / "port.npz"),
                   *GENERATE])


@pytest.mark.parametrize("seed,pos", [(0, 0), (3, 2), (7, 127)])
def test_key_stream_is_jax_random(seed, pos):
    """``models/threefry.py`` draws ``jax.random``'s bits: the uniform of
    ``fold_in(key(seed), pos)`` over a (3, 1001) shape."""
    want = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.key(seed), pos), (3, 1001)))
    stream = threefry.KeyStream(seed, pos)
    got = stream.fill_(torch.empty((3, 1001))).numpy()
    assert np.array_equal(got, want) and stream.t == pos + 1
