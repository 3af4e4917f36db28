"""Port parity: the stacked marginal (``bench/stacked.py``) and the serving
tool (``tools/serving_bench.py``, with ``models/serving.py``'s presets and
fast-path options) against the JAX package's, on the CPU.

* ``measure_stacked_marginal`` runs at a small size and returns the JAX
  function's keys (read from its source: running it would time Pallas
  kernels in interpret mode), its GFLOP/s by the JAX formula.
* ``PRESETS`` are the JAX tool's; the tool runs end to end on the CPU at
  the ``test`` preset for all four ``--fast-paths`` and with GQA, its
  record has the JAX tool's keys; the LM it serves, built by
  ``build_serving_lm`` with those options and carried to the JAX package
  through a serving bundle (``checkpoint.py``), gives JAX's logits within
  ``TOL`` and its greedy tokens.
* The variants hold one weight draw: the unfused QKV's projections are
  the merged container's column segments, and each variant's first block
  is JAX's own fused-against-unfused tolerance from the merged one
  (``tests/test_fused_ffn.py::test_exported_block_fused_qkv``: rtol=1e-5,
  atol=1e-4).
"""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import checkpoint as jck
from ternary_spgemm_tpu.models.generate import generate as jgenerate
from ternary_spgemm_tpu_torch import checkpoint as tck
from ternary_spgemm_tpu_torch.bench import headline
from ternary_spgemm_tpu_torch.bench.stacked import measure_stacked_marginal
from ternary_spgemm_tpu_torch.models import generate, serving
from ternary_spgemm_tpu_torch.tools import serving_bench as sb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's model tolerance (``tests/test_torch_model.py``)
TOL = dict(rtol=2e-3, atol=2e-3)


def _dict_keys(path: str, func: str, var=None) -> set:
    """The string keys of the dict literal that ``func`` in ``path``
    returns (``var=None``) or assigns to ``var``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if var is None and isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Dict):
            d = node.value
        elif var is not None and isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Dict) and \
                getattr(node.targets[0], "id", None) == var:
            d = node.value
        else:
            continue
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}
    raise AssertionError(f"no dict in {func}")


def test_stacked_marginal_on_cpu():
    got = measure_stacked_marginal(4, 64, 256, 4, depths=(1, 3), repeats=2,
                                   device="cpu")
    assert set(got) == _dict_keys("ternary_spgemm_tpu/bench/stacked.py",
                                  "measure_stacked_marginal")
    assert got["stacked_kernel"] == "CudaTiledBitplane_i8"
    assert got["stacked_depths"] == [1, 3]
    assert set(got["stacked_rows"]) == {"1", "3"}
    rows = got["stacked_rows"]
    assert got["stacked_marginal_seconds"] == pytest.approx(
        (rows["3"]["seconds"] - rows["1"]["seconds"]) / 2)
    assert got["stacked_roofline_fraction"] is None   # no device bandwidth
    if got["stacked_marginal_seconds"] > 0:
        assert got["stacked_gflops"] == round(
            4 * 256 * (1 + 64 / 4) / got["stacked_marginal_seconds"] / 1e9, 3)
    json.dumps(got)


def test_stacked_marginal_refuses_other_families():
    with pytest.raises(ValueError, match="TiledBitplane"):
        measure_stacked_marginal(4, 64, 256, 4, kernel="CudaDense",
                                 device="cpu")
    with pytest.raises(ValueError, match="N=32 < K=64"):
        measure_stacked_marginal(4, 64, 32, 4, device="cpu")


def test_headline_carries_stacked_keys(capsys):
    rc = headline.main(["--M", "3", "--K", "64", "--N", "128", "--repeats",
                        "1", "--device", "cpu", "--kernels",
                        "CudaTiledBitplane_i8", "--stacked", "on"])
    out = capsys.readouterr().out
    assert rc == 0, out
    rec = json.loads(out.strip().splitlines()[-1])
    want = _dict_keys("ternary_spgemm_tpu/bench/stacked.py",
                      "measure_stacked_marginal") - {"stacked_rows"}
    assert want <= set(rec) and "stacked_error" not in rec


def test_presets_are_the_jax_tools():
    from tools import serving_bench as jtool

    assert serving.PRESETS == jtool.PRESETS
    cfg = serving.preset_config("bitnet3b")
    assert (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_ff, cfg.n_layers,
            cfg.vocab) == (3200, 32, 32, 8640, 26, 32000)
    assert cfg.d_model // cfg.n_heads == 100


@pytest.mark.parametrize("fast", ["both", "ffn", "qkv", "none"])
def test_builder_variants_share_one_draw(fast):
    cfg = serving.preset_config("test")
    ffn, qkv = sb.FAST_PATHS[fast]
    base = serving.build_serving_lm(cfg, seed=3, device="cpu")
    lm = serving.build_serving_lm(cfg, seed=3, device="cpu", fused_ffn=ffn,
                                  fused_qkv=qkv)
    for b0, b1 in zip(base.blocks, lm.blocks):
        assert b1.fused_ffn == ffn and (b1.qkv is not None) == qkv
        assert b1._fused_ffn_applicable()
        for n in ("wo", "w_gate", "w_up", "w_down"):
            assert torch.equal(b0.linears[n].fmt.to_dense(),
                               b1.linears[n].fmt.to_dense())
        if not qkv:
            W = torch.cat([b1.linears[n].fmt.to_dense()
                           for n in ("wq", "wk", "wv")], dim=1)
            assert torch.equal(W, b0.qkv.fmt.to_dense())
    assert torch.equal(base.embed, lm.embed)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32))
    np.testing.assert_allclose(lm.blocks[0](x).numpy(),
                               base.blocks[0](x).numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("args", [
    ["--fast-paths", "both"], ["--fast-paths", "ffn"],
    ["--fast-paths", "qkv"], ["--fast-paths", "none"],
    ["--kv-heads", "2", "--batch", "2"]],
    ids=["both", "ffn", "qkv", "none", "gqa"])
def test_serving_tool_on_cpu(capsys, args):
    rc = sb.main(["--preset", "test", "--device", "cpu", "--repeats", "1",
                  *args])
    out = capsys.readouterr().out
    assert rc == 0, out
    rec = json.loads(out.strip().splitlines()[-1])
    jax_keys = _dict_keys("tools/serving_bench.py", "main", "out")
    assert jax_keys <= set(rec)
    fast = args[1] if args[0] == "--fast-paths" else "both"
    ffn, qkv = sb.FAST_PATHS[fast]
    assert rec["fast_paths"] == {"fused_ffn": ffn, "fused_qkv": qkv,
                                 "a8": True}
    assert rec["ffn_branch"] == ("fused" if ffn else "unfused")
    assert rec["kv_heads"] == (2 if "--kv-heads" in args else 4)
    assert rec["config"] == serving.PRESETS["test"]
    for part in ("prefill", "decode"):
        assert rec[part]["n_estimates"] == 1
    assert rec["decode"]["scan_length"] == 4
    assert rec["prefill"]["seconds"] > 0 and \
        rec["decode"]["seconds_per_token"] > 0
    a = rec["attribution_us"]
    assert a["blocks_total"] == pytest.approx(2 * a["per_block"])
    assert a["glue"] == pytest.approx(a["step"] - a["blocks_total"]
                                      - a["head"])
    assert rec["peak_memory_bytes"] is None and not rec["plain_on_cuda"]
    assert "build:" in out and "FFN " + rec["ffn_branch"] in out


def test_serving_tool_output_file(tmp_path, capsys):
    path = tmp_path / "serve.json"
    assert sb.main(["--preset", "test", "--device", "cpu", "--repeats", "1",
                    "--output", str(path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(path.read_text()) == line
    with pytest.raises(ValueError, match="bench_artifacts"):
        sb.main(["--preset", "test", "--device", "cpu", "--repeats", "1",
                 "--output", os.path.join(ROOT, "bench_artifacts", "x.json")])


@pytest.mark.parametrize("fast,kv", [("both", 0), ("ffn", 0), ("qkv", 0),
                                     ("none", 0), ("both", 2)],
                         ids=["both", "ffn", "qkv", "none", "gqa"])
def test_served_lm_matches_jax(tmp_path, fast, kv):
    """The tool's LM carried to the JAX package through a serving bundle:
    JAX's logits within ``TOL`` and its greedy tokens."""
    ffn, qkv = sb.FAST_PATHS[fast]
    lm = serving.build_serving_lm(serving.preset_config("test"), seed=7,
                                  device="cpu", fused_ffn=ffn, fused_qkv=qkv,
                                  n_kv_heads=kv)
    cfg = lm.cfg
    assert cfg.kv_heads == (kv or cfg.n_heads)
    path = str(tmp_path / "lm.npz")
    tck.save_lm_bundle(path, lm)
    jlm = jck.load_lm_bundle(path)
    assert [b.fused_ffn for b in jlm.blocks] == [ffn] * cfg.n_layers
    assert [b.qkv is not None for b in jlm.blocks] == [qkv] * cfg.n_layers
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 6))
    np.testing.assert_allclose(np.asarray(jlm(jnp.asarray(prompt))),
                               lm(torch.from_numpy(prompt)).numpy(), **TOL)
    want = np.asarray(jgenerate(jlm, jnp.asarray(prompt), 3,
                                cache_dtype=jnp.int8))
    got = generate(lm, torch.from_numpy(prompt), 3, cache_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
