"""The port's GPipe pipeline (``ternary_spgemm_tpu_torch.parallel.
pipeline``) against the JAX package's forward and gradients, on the CPU.

As ``tests/test_pipeline.py``: the pipelined LM forward equals the plain
forward (2e-4), the generic stage core runs any stage function (1e-5), the
gradients through the schedule equal the plain forward's (5e-4; in the port
the stage-to-stage hop is an autograd function whose backward sends the
cotangent one hop back), MoE and bf16 blocks pipeline too (2e-4, 0.05).
The JAX side runs here from JAX-initialised weights, which the port's
ranks load (one gloo group of 4 processes, ``tests/torch_mp_worker.py``,
suite ``pipeline``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mp_worker as mpw
from ternary_spgemm_tpu.models import BitTransformerConfig, BitTransformerLM
from ternary_spgemm_tpu.parallel import make_mesh
from ternary_spgemm_tpu.parallel.pipeline import (
    lm_stage_params,
    pipeline_lm_apply,
)

BASE = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=4)
VARIANTS = {"lm": (BASE, 0, 8), "grad": (BASE, 5, 8),
            "moe": (dict(BASE, moe_experts=2, moe_capacity_factor=8.0), 11, 4),
            "bf16": (dict(BASE, compute_dtype="bfloat16"), 13, 4)}


def flat(tree, prefix):
    """A nested dict / list tree -> ``{prefix/a/0/b: numpy}``."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, c in enumerate(tree)
                for k, v in flat(c, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for name, (kw, seed, B) in VARIANTS.items():
        model = BitTransformerLM(BitTransformerConfig(**kw))
        params = model.init(jax.random.key(seed))
        toks = jax.random.randint(jax.random.key(seed + 1), (B, 8), 0,
                                  kw["vocab"])
        out[name] = (kw, model, params, toks)
    return out


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = {}
    for name, (kw, _, params, toks) in jax_side.items():
        inputs.update(flat(params, f"{name}/params"))
        inputs[f"{name}/toks"] = np.asarray(toks)
        inputs[f"{name}/cfg"] = np.asarray(json.dumps(kw))
    mats = [np.asarray(jax.random.normal(k, (8, 8))) * 0.5
            for k in jax.random.split(jax.random.key(3), 4)]
    inputs["generic/mats"] = np.stack(mats)
    inputs["generic/x"] = np.asarray(jax.random.normal(jax.random.key(4),
                                                       (6, 8)))
    np.savez(tmp / "in_pipeline.npz", **inputs)
    return mpw.spawn("pipeline", 4, tmp)


def _ok(port, case):
    rec = port[1].get(case, {})
    assert "raised" not in rec, rec.get("trace")


@pytest.mark.parametrize("stages,n_micro", [(4, 2), (2, 4), (4, 8)])
def test_pipeline_lm_matches_plain_forward(port, jax_side, stages, n_micro):
    _ok(port, f"lm/{stages}/{n_micro}")
    _, model, params, toks = jax_side["lm"]
    want = np.asarray(jax.jit(model.apply)(params, toks))
    np.testing.assert_allclose(port[0][f"lm/{stages}/{n_micro}"], want,
                               rtol=2e-4, atol=2e-4)


def test_pipeline_generic_stage_fn(port):
    """y = ((x @ A0) @ A1) @ ... @ A3 through four stages."""
    _ok(port, "generic")
    want = np.asarray(jax.random.normal(jax.random.key(4), (6, 8)))
    for k in jax.random.split(jax.random.key(3), 4):
        want = want @ (np.asarray(jax.random.normal(k, (8, 8))) * 0.5)
    np.testing.assert_allclose(port[0]["generic"], want, rtol=1e-5,
                               atol=1e-5)


def test_pipeline_stage_drops_the_branch_it_does_not_read(port):
    """An inf in the last microbatch reaches only its own rows: the stages
    after the first, which hold that feed as the branch they drop, keep
    the other microbatches finite and exact (JAX's where, not a sum with
    weight 0)."""
    _ok(port, "generic_inf")
    want = np.asarray(jax.random.normal(jax.random.key(4), (6, 8)))
    for k in jax.random.split(jax.random.key(3), 4):
        want = want @ (np.asarray(jax.random.normal(k, (8, 8))) * 0.5)
    got = port[0]["generic_inf"]
    assert not np.isfinite(got[4]).all()
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_plain(port, jax_side):
    """The grads through the schedule (P = 2, 4 microbatches) equal JAX's
    plain-forward grads, leaf for leaf."""
    _ok(port, "grad")
    _, model, params, toks = jax_side["grad"]
    g = jax.jit(jax.grad(lambda p: jnp.mean(model.apply(p, toks) ** 2)))(
        params)
    want = {k[len("g/"):].replace("/", "."): v
            for k, v in flat(g, "g").items()}
    got = {k[len("grad/"):]: v for k, v in port[0].items()
           if k.startswith("grad/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=5e-4,
                                   err_msg=k)


def test_pipeline_rejects_bad_split(port, jax_side):
    _, model, params, toks = jax_side["lm"]
    mesh = make_mesh({"pipe": 4})
    for case, fn in (
            ("err/micro", lambda: pipeline_lm_apply(model, params, toks[:6],
                                                    mesh, n_micro=4)),
            ("err/stages", lambda: lm_stage_params(model, params, 3))):
        with pytest.raises(ValueError) as e:
            fn()
        rec = port[1][case]
        assert (rec["raised"], rec["message"]) == ("ValueError",
                                                   str(e.value)), case


@pytest.mark.parametrize("name,tol", [("moe", 2e-4), ("bf16", 0.05)])
def test_pipeline_composes_with_moe_and_bf16(port, jax_side, name, tol):
    """MoE blocks (capacity never binding) and bf16-compute blocks
    pipeline like the dense f32 ones."""
    _ok(port, name)
    _, model, params, toks = jax_side[name]
    want = np.asarray(jax.jit(model.apply)(params, toks), np.float32)
    np.testing.assert_allclose(port[0][name], want, rtol=tol, atol=tol)
