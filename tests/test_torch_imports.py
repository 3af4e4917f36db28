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
                 "ternary_spgemm_tpu_torch.parallel.ring_kernel"):
        assert must in names


@pytest.mark.parametrize("extra", [[], ["chip_smoke"]], ids=["package", "smoke"])
def test_no_jax_import(extra):
    mods = _modules() + extra
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'orbax', 'ml_dtypes', 'ternary_spgemm_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
