"""Every script of ``examples_torch/`` runs end to end with ``--device
cpu`` and the fast arguments of ``tests/test_examples.py``, each in a
process of its own, as a user would run it, and imports neither JAX, the
JAX package nor the repository's ``tools/``; every JAX example has a twin
there; example 03 runs as two gloo processes; without ``--device cpu`` an
example raises where there is no card."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")

#: ``tests/test_examples.py``'s fast arguments, and example 03's ranks
FAST_ARGS = {
    "02_train_export_serve.py": ["--steps", "40"],
    "03_sharded_training.py": ["--steps", "2", "--devices", "2"],
    "04_generate.py": ["--new-tokens", "4"],
}
#: runs a script as ``__main__``, then fails if it imported what the port
#: never imports
RUNNER = (
    "import runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
    "                 ('jax', 'ternary_spgemm_tpu', 'tools'))\n"
    "    assert not bad, bad\n")


def _scripts():
    return sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))


def _run(script, args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "-c", RUNNER, os.path.join(EXAMPLES, script),
         *args], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)


def test_every_jax_example_has_a_twin():
    jax_examples = sorted(f for f in os.listdir(os.path.join(ROOT,
                                                             "examples"))
                          if f.endswith(".py"))
    assert _scripts() == jax_examples
    assert set(FAST_ARGS) <= set(_scripts())
    assert os.path.exists(os.path.join(EXAMPLES, "README.md"))


@pytest.mark.parametrize("script", _scripts())
def test_example_runs_on_the_cpu(script):
    proc = _run(script, ["--device", "cpu", *FAST_ARGS.get(script, [])])
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}")


def test_sharded_example_reports_its_mesh():
    proc = _run("03_sharded_training.py",
                ["--device", "cpu", "--devices", "2", "--steps", "1"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "mesh: {'data': 1, 'model': 2} on cpu" in proc.stdout
    assert "per-rank shard (128, 64) of global (128, 128)" in proc.stdout


def test_example_needs_a_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = _run("01_spmm_quickstart.py", [])
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
