"""The port's block benchmarks against the JAX package's
(``tools/model_bench.py``, ``tools/fused_block_bench.py``).

* ``model_bench --preset test --device cpu`` gives the JAX tool's result
  keys (``tests/test_sweep.py`` runs it so), each kernel by its
  counterpart, every one timed (seconds > 0). The JAX tool's
  ``exported/fused_block_decode`` records an error at this commit (it
  calls ``_fused_ffn_applicable`` with an argument the method does not
  take); the port's is timed.
* ``fused_block_bench``'s ``build_block`` from the same seeds as the JAX
  ``build_block`` (the JAX package's numpy generator; its native one
  switched off) gives the JAX block's decode output within 1e-5 in each
  of the four configurations, on one seeded input against a zero cache.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import native
from ternary_spgemm_tpu.models import BitTransformerConfig as JConfig
from ternary_spgemm_tpu.models.generate import _block_decode as j_decode
from ternary_spgemm_tpu.models.generate import _fused_hooks as j_hooks
from ternary_spgemm_tpu.models.generate import init_cache as j_init_cache
from ternary_spgemm_tpu.ops import stack_mode
from tools import fused_block_bench as jfbb
from tools import model_bench as jmb
from ternary_spgemm_tpu_torch.models import BitTransformerConfig
from ternary_spgemm_tpu_torch.models.generate import init_cache
from ternary_spgemm_tpu_torch.ops import REFERENCE_KERNELS
from ternary_spgemm_tpu_torch.tools import fused_block_bench, model_bench

TOL = dict(rtol=1e-5, atol=1e-5)


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_model_bench_gives_the_jax_tools_results(tmp_path):
    argv = ["--preset", "test", "--format", "TiledBitplane",
            "--min-seconds", "0.01", "--kernels", "PallasTiledBitplane_i8"]
    jout = tmp_path / "jax.json"
    _run(jmb.main, [*argv, "--platform", "cpu", "--output", str(jout)])
    want = json.loads(jout.read_text())
    out = _run(model_bench.main, [*argv, "--device", "cpu"])
    got = json.loads(out.strip().splitlines()[-1])
    rename = lambda k: k.replace("PallasTiledBitplane_i8",
                                 REFERENCE_KERNELS["PallasTiledBitplane_i8"])
    assert list(got["results"]) == [rename(k) for k in want["results"]]
    assert got["shape"] == want["shape"] == model_bench.PRESETS["test"]
    for name, rec in got["results"].items():
        assert rec["seconds"] > 0, (name, rec)
    assert set(got["results"]["exported/auto_decode"]["picks"]) == \
        set(want["results"]["exported/auto_decode"]["picks"])


def test_model_bench_presets_are_the_jax_tools():
    assert model_bench.PRESETS == jmb.PRESETS
    assert fused_block_bench.PRESETS == jfbb.PRESETS


@pytest.mark.parametrize("variant", sorted(fused_block_bench.VARIANTS))
def test_fused_block_decode_is_the_jax_blocks(variant, monkeypatch):
    monkeypatch.setattr(native, "native_available", lambda: False)
    ffn, qkv = fused_block_bench.VARIANTS[variant]
    shape = fused_block_bench.PRESETS["test"]
    kw = dict(vocab=64, d_model=shape["d_model"], n_heads=shape["n_heads"],
              d_ff=shape["d_ff"], n_layers=1)
    T, d = shape["T"], shape["d_model"]
    x = np.random.default_rng(23).standard_normal((1, 1, d)).astype(
        np.float32)

    jcfg = JConfig(**kw)
    jblk = jfbb.build_block(jcfg, s=2, fused_ffn=ffn, fused_qkv=qkv)
    jcache = j_init_cache(jcfg, 1, T + 8)[0]

    @jax.jit
    def jdecode(blk, z, cache):
        with stack_mode():
            lin = lambda n, h: blk.linears[n](h.reshape(1, -1))[:, None, :]
            f, q = j_hooks(blk, 1, lambda h: (1, 1))
            return j_decode(jcfg.head_tuple, lin, blk.norm_attn,
                            blk.norm_ffn, z, cache, jnp.int32(T), ffn=f,
                            qkv=q)[0]

    want = np.asarray(jdecode(jblk, jnp.asarray(x), jcache))

    cfg = BitTransformerConfig(**kw)
    blk = fused_block_bench.build_block(cfg, s=2, fused_ffn=ffn,
                                        fused_qkv=qkv, device="cpu")
    cache = init_cache(cfg, 1, T + 8, device="cpu")[0]
    with torch.no_grad():
        got = fused_block_bench.decode_fn(blk, cache, T)(torch.from_numpy(x))
    assert blk.fused_ffn == ffn and (blk.qkv is not None) == qkv
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_block_bench_runs_every_variant():
    out = _run(fused_block_bench.main, ["--preset", "test", "--repeats",
                                        "2", "--device", "cpu"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert set(rec["variants"]) == set(fused_block_bench.VARIANTS)
    for v in rec["variants"].values():
        assert v["us"] > 0 and v["n_estimates"] == 2
    assert rec["auto_equivalent_variant"] in rec["variants"]
    assert isinstance(rec["win_resolvable"], bool)
