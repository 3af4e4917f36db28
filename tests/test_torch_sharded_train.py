"""The port's sharded train steps, spec functions and sharded checkpoints
against the JAX package's, on the CPU.

The JAX side runs here on conftest's 8-device CPU mesh, jitted, as
``tests/test_sequence_parallel.py``, ``test_train_features.py:90-150``,
``test_models.py:216`` and ``test_transformer.py:65`` run it; the port's
runs the same configurations from the same (JAX-initialised) weights in one
gloo group of 8 processes over localhost (``tests/torch_mp_worker.py``,
suite ``train``): a data x model mesh of 2 x 4 (4 x 2 for ZeRO-1), DTensor
parameters, ``torch.optim`` steps. Held at JAX's tolerances: losses rtol
1e-5, parameters after SGD steps rtol 1e-4 / atol 1e-6, the MoE forward
under sequence parallelism 2e-4. The collectives of sequence parallelism
are counted with ``CommDebugMode``. The sharded checkpoint files are
compared with the JAX package's, record for record.
"""

import json
import os
import re

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

import torch_mp_worker as mpw
from test_torch_pipeline import flat
from ternary_spgemm_tpu import checkpoint as jckpt
from ternary_spgemm_tpu.models import (
    BitTransformerConfig,
    BitTransformerLM,
    TernaryMLP,
    make_sharded_lm_train_step as jlm_step,
    make_sharded_train_step as jmlp_step,
)
from ternary_spgemm_tpu.models.moe import moe_param_shardings as jmoe_shardings
from ternary_spgemm_tpu.models.train import param_shardings as jparam_shardings
from ternary_spgemm_tpu.models.transformer import (
    lm_param_shardings as jlm_shardings,
)
from ternary_spgemm_tpu.parallel import make_mesh
from ternary_spgemm_tpu_torch import checkpoint as pckpt
from ternary_spgemm_tpu_torch.models import (
    BitTransformerConfig as PConfig,
    BitTransformerLM as PLM,
    TernaryMLP as PMLP,
)
from ternary_spgemm_tpu_torch.models.moe import moe_param_specs
from ternary_spgemm_tpu_torch.models.train import param_specs
from ternary_spgemm_tpu_torch.models.transformer import lm_param_specs

BASE = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2)
MOE = dict(BASE, moe_experts=4, moe_capacity_factor=4.0)
TLM = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=2)
GQA = dict(vocab=32, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
           n_layers=2)
LOSS = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-6)


def _lm(kw, key, toks):
    model = BitTransformerLM(BitTransformerConfig(**kw))
    return model, model.init(jax.random.key(key)), toks


def _steps(model, params, toks, opt, mesh, steps, **kw):
    step, place = jlm_step(model, opt, mesh, **kw)
    p, s, t = place(params, opt.init(params), toks)
    losses = []
    for _ in range(steps):
        p, s, loss = step(p, s, t)
        losses.append(float(loss))
    return losses, p


@pytest.fixture(scope="module")
def jax_side():
    m24 = make_mesh({"data": 2, "model": 4})
    m42 = make_mesh({"data": 4, "model": 2})
    rand = lambda k, B, T, V: jax.random.randint(jax.random.key(k), (B, T),
                                                 0, V)
    cases = {"sp": (BASE, *_lm(BASE, 0, rand(1, 4, 8, 32))[1:]),
             "moe": (MOE, *_lm(MOE, 2, rand(3, 4, 8, 32))[1:]),
             "tlm": (TLM, *_lm(TLM, 4, rand(5, 4, 16, 64))[1:]),
             "gqa": (GQA, *_lm(GQA, 0, np.zeros((4, 8), np.int32))[1:])}
    out = {"cases": cases}
    sgd = optax.sgd(1e-2)
    model = lambda kw: BitTransformerLM(BitTransformerConfig(**kw))
    for sp in (False, True):
        out[f"sp/{sp}"] = _steps(model(BASE), cases["sp"][1], cases["sp"][2],
                                 sgd, m24, 2, sequence_parallel=sp)
        out[f"moe_sgd/{sp}"] = _steps(model(MOE), cases["moe"][1],
                                      cases["moe"][2], sgd, m24, 2,
                                      sequence_parallel=sp)
    out["tlm"] = _steps(model(TLM), cases["tlm"][1], cases["tlm"][2], sgd,
                        m24, 1)
    out["gqa"] = _steps(model(GQA), cases["gqa"][1], cases["gqa"][2], sgd,
                        m24, 1, sequence_parallel=True)
    adam = optax.adam(1e-2)
    for z in (False, True):
        out[f"zero1/{z}"] = _steps(model(BASE), cases["sp"][1],
                                   cases["sp"][2], adam, m42, 3, zero1=z)
    out["moe_logits"] = np.asarray(jax.jit(model(MOE).apply)(
        cases["moe"][1], cases["moe"][2]))
    mlp = TernaryMLP([16, 32, 16])
    mparams = mlp.init(jax.random.key(6))
    step, place = jmlp_step(mlp, optax.adam(1e-3), m24)
    p, s, x, y = place(mparams, optax.adam(1e-3).init(mparams),
                       np.ones((8, 16), np.float32),
                       np.zeros((8, 16), np.float32))
    out["mlp"] = (mparams, float(step(p, s, x, y)[2]))
    out["m24"] = m24
    return out


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    inputs = {}
    for name, (kw, params, toks) in jax_side["cases"].items():
        inputs.update(flat(params, f"{name}/params"))
        inputs[f"{name}/toks"] = np.asarray(toks)
        inputs[f"{name}/cfg"] = np.asarray(json.dumps(kw))
    inputs.update(flat({"layers": jax_side["mlp"][0]}, "mlp/params"))
    np.savez(tmp / "in_train.npz", **inputs)
    arrays, record = mpw.spawn("train", 8, tmp)
    return arrays, record, tmp


def _ok(port, case):
    rec = port[1].get(case, {})
    assert "raised" not in rec, rec.get("trace")
    return rec


def test_sharded_mlp_train_step(port, jax_side):
    """``make_sharded_train_step`` (test_models.py:216): the loss JAX's,
    the parameters' placements kept through the step."""
    rec = _ok(port, "mlp")
    assert rec["loss"] == pytest.approx(jax_side["mlp"][1], rel=1e-5)
    assert rec["kept"] and rec["placements"] == "(Replicate(), Shard(dim=1))"


def test_sharded_lm_step(port, jax_side):
    """The TP x DP LM step (test_transformer.py:65)."""
    rec = _ok(port, "lm_step")
    np.testing.assert_allclose(rec["losses"], jax_side["tlm"][0], **LOSS)


@pytest.mark.parametrize("sp", [False, True])
def test_sp_step_matches_jax_sharded_step(port, jax_side, sp):
    """Two SGD steps with and without sequence parallelism: the losses and
    every parameter JAX's (test_sequence_parallel.py:39-43)."""
    rec = _ok(port, f"sp/{sp}")
    losses, params = jax_side[f"sp/{sp}"]
    np.testing.assert_allclose(rec["losses"], losses, **LOSS)
    want = {k[2:].replace("/", "."): v for k, v in flat(params, "p").items()}
    for k, v in want.items():
        np.testing.assert_allclose(port[0][f"sp/{sp}/{k}"], v, err_msg=k,
                                   **PARAMS)


@pytest.mark.parametrize("sp", [False, True])
def test_moe_step_matches_jax_sharded_step(port, jax_side, sp):
    """Two SGD steps of the MoE LM with its experts split over the model
    axis (one a rank), with and without sequence parallelism: the losses
    and every parameter JAX's, the router's and the expert stacks'
    included (each rank combines every expert, so the route's gradient is
    whole on every rank)."""
    rec = _ok(port, f"moe_sgd/{sp}")
    losses, params = jax_side[f"moe_sgd/{sp}"]
    np.testing.assert_allclose(rec["losses"], losses, **LOSS)
    want = {k[2:].replace("/", "."): v for k, v in flat(params, "p").items()}
    assert any(k.endswith("moe.router") for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(port[0][f"moe_sgd/{sp}/{k}"], v,
                                   err_msg=k, **PARAMS)


def test_sp_step_has_sequence_collectives(port):
    """The sequence-parallel step all-gathers the T-split activations and
    reduce-scatters after the row-parallel projections: counted by
    ``CommDebugMode`` against the step without it."""
    rec = _ok(port, "counts")
    plain, sp = rec["False"], rec["True"]
    gathers = lambda c: c.get("all_gather_into_tensor", 0)
    scatters = lambda c: c.get("reduce_scatter_tensor", 0)
    assert gathers(sp) > 0 and scatters(sp) > 0, (plain, sp)
    assert scatters(plain) == 0, plain


def test_sp_works_with_moe(port, jax_side):
    """SP with expert parallelism: the forward under the sequence-split
    constraint is the unsharded one, and the step runs."""
    rec = _ok(port, "sp_moe")
    np.testing.assert_allclose(port[0]["sp_moe"], jax_side["moe_logits"],
                               rtol=2e-4, atol=2e-4)
    assert np.isfinite(rec["loss"])


def test_gqa_sharded_lm_train_step(port, jax_side):
    """GQA's narrower K/V projections split over the model axis like any
    column-parallel projection (two KV heads over four ranks: attention
    gathers them)."""
    rec = _ok(port, "gqa")
    np.testing.assert_allclose(rec["losses"], jax_side["gqa"][0], **LOSS)


def test_zero1_shards_moments_and_matches_jax(port, jax_side):
    """ZeRO-1: the Adam moments split over data (placed and after the
    steps) and the losses JAX's, with and without ZeRO-1."""
    rec = _ok(port, "zero1")
    np.testing.assert_allclose(rec["losses"], jax_side["zero1/True"][0],
                               **LOSS)
    np.testing.assert_allclose(rec["losses"], jax_side["zero1/False"][0],
                               **LOSS)
    assert "Shard(dim=0)" in rec["placed"] and "Shard(dim=0)" in \
        rec["stepped"]


def test_zero1_respects_param_sharding(port):
    """The column-parallel wq (None, model) gets data on dim 0: (data,
    model), as JAX's P("data", "model")."""
    rec = _ok(port, "zero1")
    assert rec["placed"] == rec["want"] == rec["stepped"]


def test_zero1_with_moe_experts(port):
    """An expert stack's moment keeps its leading-E model split and gains
    a data split."""
    rec = _ok(port, "zero1_moe")
    pl = re.findall(r"Shard\(dim=(\d)\)", rec["placements"])
    data_dim, model_dim = pl
    assert rec["mesh"] == ["data", "model"] and model_dim == "0" \
        and data_dim != "0"
    assert np.isfinite(rec["losses"][0])


# ---------------------------------------------------------------------------
# spec functions: no group needed
# ---------------------------------------------------------------------------


def _spec_items(tree, prefix=""):
    """A tree of NamedShardings -> ``{"a.0.b": spec tuple}``."""
    if isinstance(tree, NamedSharding):
        return {prefix[1:]: tuple(tree.spec)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items
            for k, v in _spec_items(sub, f"{prefix}.{key}").items()}


@pytest.mark.parametrize("kw", [BASE, MOE, GQA], ids=["dense", "moe", "gqa"])
def test_lm_param_specs_match_jax(jax_side, kw):
    want = _spec_items(jlm_shardings(
        BitTransformerLM(BitTransformerConfig(**kw)), jax_side["m24"]))
    lm = PLM(PConfig(**kw), device="cpu")
    got = lm_param_specs(lm)
    assert got == want
    assert sorted(got) == sorted(n for n, _ in lm.named_parameters())


def test_mlp_and_moe_param_specs_match_jax(jax_side):
    mesh = jax_side["m24"]
    want = {f"layers.{k}": v for k, v in _spec_items(jparam_shardings(
        TernaryMLP([16, 32, 32, 16]), mesh)).items()}
    assert param_specs(PMLP([16, 32, 32, 16], device="cpu")) == want
    want = _spec_items(jmoe_shardings(make_mesh({"expert": 4})))
    assert moe_param_specs() == want


# ---------------------------------------------------------------------------
# sharded checkpoints, across packages
# ---------------------------------------------------------------------------


def _records(path):
    with np.load(path) as data:
        header = json.loads(bytes(data["header"]).decode())
        return header, {(i, key): data[f"l{i}s{j}"].tobytes()
                        for i, h in enumerate(header)
                        for j, key in enumerate(h["indices"])}


def test_sharded_checkpoint_files_match_jax(port, jax_side, tmp_path):
    """The 8 ranks' shard files hold, together, the blocks of the JAX
    package's single-process file for the same layout: the same index keys
    and bytes, the same shapes and dtypes; a rank's restore gives its
    blocks back byte for byte."""
    rec = _ok(port, "ckpt")
    assert rec["restored_equal"]
    model = BitTransformerLM(BitTransformerConfig(**BASE))
    params = jax.device_put(jax_side["cases"]["sp"][1],
                            jlm_shardings(model, jax_side["m24"]))
    jckpt.save_sharded_pytree(str(tmp_path / "jax_ckpt"), params)
    jhead, jrec = _records(tmp_path / "jax_ckpt.shard0.npz")
    merged = {}
    for r in range(8):
        head, recs = _records(port[2] / f"port_ckpt.shard{r}.npz")
        assert [(h["shape"], h["dtype"]) for h in head] == \
            [(h["shape"], h["dtype"]) for h in jhead]
        merged.update(recs)
    assert merged == jrec


@pytest.mark.parametrize("case,text", [
    ("err/ckpt_shape", "checkpoint shape"),
    ("err/ckpt_index", "no saved shard covers index")])
def test_sharded_restore_errors(port, case, text):
    """JAX's two errors: a target shape unlike the saved one, and a layout
    whose blocks the rank's file does not hold."""
    rec = port[1][case]
    assert rec["raised"] == "ValueError" and text in rec["message"]


def test_world1_restores_jax_file(tmp_path):
    """A one-rank port group restores a JAX single-process file into
    DTensor and plain targets."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from ternary_spgemm_tpu_torch.parallel import (
        init_distributed, make_mesh as pmesh)

    tree = {"a": np.arange(32, dtype=np.float32).reshape(4, 8),
            "b": np.int32(7), "c": np.linspace(0, 1, 5, dtype=np.float32)}
    jckpt.save_sharded_pytree(str(tmp_path / "j"), jax.device_put(tree))
    init_distributed(0, 1, f"tcp://127.0.0.1:{mpw.free_port()}", "cpu")
    try:
        mesh = pmesh({"model": 1}, device_type="cpu")
        like = {"a": distribute_tensor(torch.zeros(4, 8), mesh, [Shard(0)]),
                "b": torch.tensor(0, dtype=torch.int32),
                "c": torch.zeros(5)}
        back = pckpt.restore_sharded_pytree(str(tmp_path / "j"), like)
        assert back["a"].placements == (Shard(0),)
        np.testing.assert_array_equal(back["a"].to_local().numpy(), tree["a"])
        assert int(back["b"]) == 7 and back["b"].dtype == torch.int32
        np.testing.assert_array_equal(back["c"].numpy(), tree["c"])
        pckpt.save_sharded_pytree(str(tmp_path / "p"), back)
        assert _records(tmp_path / "p.shard0.npz") == \
            _records(tmp_path / "j.shard0.npz")
    finally:
        dist.destroy_process_group()
    assert not os.path.exists(tmp_path / "p.shard1.npz")
