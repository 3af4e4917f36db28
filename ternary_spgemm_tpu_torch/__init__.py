"""ternary_spgemm_tpu_torch — the PyTorch + CUDA port of ``ternary_spgemm_tpu``.

Same module layout and public names as the JAX package, which stays in the
repository as the reference each part of the port is tested against. Plain
tensor code is PyTorch; every kernel the JAX package wrote in Pallas for the
TPU is a CUDA C++ kernel written for Hopper (``csrc/``), built on first use
by :mod:`ternary_spgemm_tpu_torch.ops._build`. On a CPU tensor each kernel
wrapper runs its plain PyTorch version instead, so the package runs (and is
tested) without a GPU.

This package never imports ``jax`` or ``ternary_spgemm_tpu``.
"""

__version__ = "0.1.0"

from ternary_spgemm_tpu_torch import reference  # noqa: E402,F401


def __getattr__(name):
    import importlib
    if name in ("formats", "ops", "models", "utils", "bench"):
        return importlib.import_module(f"ternary_spgemm_tpu_torch.{name}")
    raise AttributeError(
        f"module 'ternary_spgemm_tpu_torch' has no attribute {name!r}")
