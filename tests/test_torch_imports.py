"""The port imports no JAX: every module of ``ternary_spgemm_tpu_torch`` and
``chip_smoke.py`` load in a fresh interpreter that never sees ``jax``,
``orbax``, ``ml_dtypes`` or the JAX package (the checkpoint module reads
and writes the JAX package's files without any of them)."""

import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    import ternary_spgemm_tpu_torch as pkg
    names = [pkg.__name__]
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(m.name)
    return sorted(names)


def test_every_module_is_listed():
    names = _modules()
    for must in ("ternary_spgemm_tpu_torch.checkpoint",
                 "ternary_spgemm_tpu_torch.ops.cuda_kernels",
                 "ternary_spgemm_tpu_torch.ops.xla_kernels",
                 "ternary_spgemm_tpu_torch.ops.fused_ffn",
                 "ternary_spgemm_tpu_torch.ops.autotune",
                 "ternary_spgemm_tpu_torch.formats.blocked",
                 "ternary_spgemm_tpu_torch.formats.interleaved",
                 "ternary_spgemm_tpu_torch.formats.ell",
                 "ternary_spgemm_tpu_torch.bench.stacked",
                 "ternary_spgemm_tpu_torch.tools.serving_bench",
                 "ternary_spgemm_tpu_torch.formats.tcsc",
                 "ternary_spgemm_tpu_torch.formats.tiled",
                 "ternary_spgemm_tpu_torch.formats.packed",
                 "ternary_spgemm_tpu_torch.bench.harness",
                 "ternary_spgemm_tpu_torch.bench.headline",
                 "ternary_spgemm_tpu_torch.__main__",
                 "ternary_spgemm_tpu_torch.models.generate",
                 "ternary_spgemm_tpu_torch.models.bitlinear",
                 "ternary_spgemm_tpu_torch.models.train",
                 "ternary_spgemm_tpu_torch.models.convert",
                 "ternary_spgemm_tpu_torch.models.exported",
                 "ternary_spgemm_tpu_torch.models.transformer",
                 "ternary_spgemm_tpu_torch.models.moe",
                 "ternary_spgemm_tpu_torch.models.graphs",
                 "ternary_spgemm_tpu_torch.models.serving",
                 "ternary_spgemm_tpu_torch.utils.device",
                 "ternary_spgemm_tpu_torch.tools",
                 "ternary_spgemm_tpu_torch.tools.ffn_bench",
                 "ternary_spgemm_tpu_torch.tools.membench",
                 "ternary_spgemm_tpu_torch.tools.decode_roofline",
                 "ternary_spgemm_tpu_torch.tools.deposit_study",
                 "ternary_spgemm_tpu_torch.tools.ragged_probe",
                 "ternary_spgemm_tpu_torch.tools.serve_trace",
                 "ternary_spgemm_tpu_torch.parallel",
                 "ternary_spgemm_tpu_torch.parallel.ring_kernel",
                 "ternary_spgemm_tpu_torch.parallel.sharding",
                 "ternary_spgemm_tpu_torch.parallel.spgemm",
                 "ternary_spgemm_tpu_torch.parallel.ffn",
                 "ternary_spgemm_tpu_torch.parallel.pipeline"):
        assert must in names


@pytest.mark.parametrize("extra", [[], ["chip_smoke"], ["torch_mp_worker"]],
                         ids=["package", "smoke", "worker"])
def test_no_jax_import(extra):
    mods = _modules() + extra
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'orbax', 'ml_dtypes', 'ternary_spgemm_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_ops_exports_the_autotune_function():
    """``ternary_spgemm_tpu_torch.ops.autotune`` is the function after
    ``import ternary_spgemm_tpu_torch.ops``, whichever module was imported
    first, and ``ops.kernels_for_format`` exists, as in the JAX package's
    ``ops`` (``ternary_spgemm_tpu/ops/__init__.py:9,14``)."""
    code = ("import importlib, inspect, sys\n"
            "first = sys.argv[1]\n"
            "if first:\n"
            "    importlib.import_module(first)\n"
            "import ternary_spgemm_tpu_torch.ops as ops\n"
            "mod = importlib.import_module("
            "'ternary_spgemm_tpu_torch.ops.autotune')\n"
            "assert inspect.isfunction(ops.autotune), ops.autotune\n"
            "assert ops.autotune is mod.autotune\n"
            "from ternary_spgemm_tpu_torch.ops import kernels_for_format\n"
            "assert kernels_for_format is ops.api.kernels_for_format\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    for first in ("", "ternary_spgemm_tpu_torch.ops.autotune",
                  "ternary_spgemm_tpu_torch.models"):
        out = subprocess.run([sys.executable, "-c", code, first], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=240)
        assert out.returncode == 0, (first, out.stderr)
        assert out.stdout.startswith("ok")


def test_mesh_and_group_raise_without_a_card():
    """``make_mesh`` and ``init_distributed`` on their default ``"cuda"``
    raise where torch sees no card, rather than building a CPU mesh or a
    gloo group; a CPU mesh needs a process group first."""
    import torch

    from ternary_spgemm_tpu_torch.parallel import init_distributed, make_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"model": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(0, 1, "tcp://127.0.0.1:1")
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh({"model": 1}, device_type="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        make_mesh({"model": 1}, device_type="tpu")
