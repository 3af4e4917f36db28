"""Kernel registry and dispatch — counterpart of ``ternary_spgemm_tpu/ops/api.py``.

Each kernel is registered once with its name, the container format it
consumes and its activation domain; :func:`ternary_spgemm` dispatches to it.
Kernel signature::

    kernel(X: f32[M, K], fmt: TernaryFormat, bias: f32[N],
           alpha: Optional[f32[N]]) -> f32[M, N]
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Type

import torch

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat

_KERNEL_REGISTRY: Dict[str, "KernelSpec"] = {}

#: The speedup denominator of the benchmark harness (``main.cpp:10``).
BASELINE_KERNEL_NAME = "BaseTCSC"

#: The JAX package's kernel registry (``ternary_spgemm_tpu.ops.all_kernels()``,
#: in its order), each name with its counterpart in this registry (a name
#: maps to None where a kernel is not ported; none is now, so
#: :func:`unported` is empty and the port's benchmark sweeps all 31).
REFERENCE_KERNELS: Dict[str, Optional[str]] = {
    "BaseTCSC": "BaseTCSC",
    "BaseTCSR": "BaseTCSR",
    "BlockedTCSC": "BlockedTCSC",
    "InterleavedTCSC": "InterleavedTCSC",
    "InterleavedBlockedTCSC": "InterleavedBlockedTCSC",
    "EllTCSC": "EllTCSC",
    "BlockedEllTCSC": "BlockedEllTCSC",
    "DenseMXU": "DenseMXU",
    "DenseMXU_bf16": "DenseMXU_bf16",
    "DenseMXU_x8": "DenseMXU_x8",
    "PackedMXU_2bit": "PackedMXU_2bit",
    "PackedMXU_base3": "PackedMXU_base3",
    "PackedCSC": "PackedCSC",
    "PallasDense": "CudaDense",
    "PallasDense_bf16": "CudaDense_bf16",
    "PallasPacked2Bit": "CudaPacked2Bit",
    "PallasPacked53": "CudaPacked53",
    "PallasDense_i8": "CudaDense_i8",
    "PallasPacked2Bit_i8": "CudaPacked2Bit_i8",
    "PallasPacked53_i8": "CudaPacked53_i8",
    "PallasBlockPacked_i8": "CudaBlockPacked_i8",
    "PallasTiledDense_i8": "CudaTiledDense_i8",
    "PallasTiledDense_x8": "CudaTiledDense_x8",
    "PallasTiledBlockPacked_i8": "CudaTiledBlockPacked_i8",
    "PallasTiledBitplane_i8": "CudaTiledBitplane_i8",
    "PallasTiledNibblePair_i8": "CudaTiledNibblePair_i8",
    "PallasTiledBitplane_x8": "CudaTiledBitplane_x8",
    "PallasTiledBitplane_bf16": "CudaTiledBitplane_bf16",
    "PallasEllDeposit_i8": "CudaEllDeposit_i8",
    "PallasTiledEllGather": "CudaTiledEllGather",
    "PallasEllGather": "CudaEllGather",
}


def jax_name(name: Optional[str]) -> Optional[str]:
    """A kernel name of this port -> the JAX registry's (None and
    ``"auto"``, the measured choice, stay): the name files store."""
    if name is None or name == "auto":
        return name
    for jax, port in REFERENCE_KERNELS.items():
        if port == name:
            return jax
    raise ValueError(f"kernel {name!r} has no counterpart in the JAX "
                     "registry, so a file cannot name it")


def port_name(name: Optional[str]) -> Optional[str]:
    """A JAX registry name read from a file -> this port's kernel (None and
    ``"auto"`` stay)."""
    if name is None or name == "auto":
        return name
    if name not in REFERENCE_KERNELS:
        raise ValueError(f"kernel {name!r} is not in the JAX registry")
    return REFERENCE_KERNELS[name]


def unported(names: Optional[Iterable[str]] = None) -> List[str]:
    """The JAX registry's kernels among ``names`` (default: all of them)
    that have no counterpart here."""
    names = REFERENCE_KERNELS if names is None else names
    return [n for n in names if REFERENCE_KERNELS.get(n, "") is None]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    fn: Callable                      # (X, fmt, bias, alpha=None) -> Y
    format_cls: Type[TernaryFormat]
    description: str = ""
    #: the TPU kernel (file:line of the JAX package) this kernel replaces
    reference: str = ""
    #: True if results are inexact vs the f32 reference
    approximate: bool = False
    #: Largest |x| for which the kernel is exact on integer-valued
    #: activations: 512 for the _i8 kernels (which floor non-integer X),
    #: 256 for the _bf16 kernel (which rounds X to bf16), 127 for the
    #: int8-native _x8 kernels (which round and clamp). None = any float.
    x_absmax: Optional[int] = None
    #: Activation bytes per X element the kernel reads from device memory
    #: (the own-bytes roofline input). Every kernel here reads f32 X: 4,
    #: where the JAX registrations give 2 or 1 for kernels whose TPU
    #: wrapper narrows X before the call.
    x_bytes: float = 4.0
    #: a hand-written kernel's CUDA source (path in the repository); ""
    #: for the kernels written as torch ops
    source: str = ""
    #: a hand-written kernel's plain PyTorch version (what its wrapper runs
    #: on a CPU tensor, and what ``chip_smoke.py`` holds it against)
    plain: Optional[Callable] = None

    def __call__(self, X, fmt, bias, alpha=None):
        return self.fn(X, fmt, bias, alpha)


def register_kernel(name: str, format_cls: Type[TernaryFormat], *,
                    description: str = "", reference: str = "",
                    approximate: bool = False,
                    x_absmax: Optional[int] = None, x_bytes: float = 4.0,
                    source: str = "", plain: Optional[Callable] = None):
    """Decorator: register a kernel under ``name``."""

    def deco(fn):
        if name in _KERNEL_REGISTRY:
            raise ValueError(f"kernel {name!r} already registered")
        _KERNEL_REGISTRY[name] = KernelSpec(
            name=name, fn=fn, format_cls=format_cls, description=description,
            reference=reference, approximate=approximate,
            x_absmax=x_absmax, x_bytes=x_bytes, source=source, plain=plain)
        return fn

    return deco


def all_kernels() -> Dict[str, KernelSpec]:
    return dict(_KERNEL_REGISTRY)


def get_kernel(name: str) -> KernelSpec:
    try:
        return _KERNEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(_KERNEL_REGISTRY)}") from None


def dispatch_rank(spec: KernelSpec) -> tuple:
    """The order in which default dispatch takes equally good candidates: a
    hand-written kernel (one with a CUDA ``source``) before a torch-op
    formulation, as JAX takes Pallas on its accelerator; then the name."""
    return (not spec.source, spec.name)


def to_f32(X: torch.Tensor) -> torch.Tensor:
    """X as it is, in f32 (the exact f32 kernels)."""
    return X.to(torch.float32)


def to_x8(X: torch.Tensor) -> torch.Tensor:
    """``_to_x8``: round half to even, clamp to [-127, 127] (f32 values)."""
    return torch.clamp(torch.round(X.to(torch.float32)), -127.0, 127.0)


def to_i8(X: torch.Tensor) -> torch.Tensor:
    """The value the TPU's int8 split ``x = 8a + r - 512`` represents:
    ``floor(x + 512) - 512`` in f32 (= floor(x) for |x| <= 512)."""
    return torch.floor(X.to(torch.float32) + 512.0) - 512.0


def to_bf16(X: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(X, bfloat16)`` (round to nearest even), widened back
    to f32 values."""
    return X.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def matmul_dense(Xv: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """f32 ``Xv (M, K)`` times a dense ternary ``W (K, N)``, in full f32 —
    exact while ``Xv`` is integer-valued and every partial sum stays below
    2**24."""
    if Xv.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain ternary matmul needs full f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return Xv @ W.to(torch.float32)


def matmul_plain(Xv: torch.Tensor, fmt: TernaryFormat) -> torch.Tensor:
    """f32 ``Xv (M, K)`` times the decoded container (:func:`matmul_dense`)."""
    return matmul_dense(Xv, fmt.to_dense())


def finish(Y: torch.Tensor, bias, alpha=None) -> torch.Tensor:
    """Shared epilogue: bias add + optional per-column PReLU."""
    Y = Y + torch.as_tensor(bias, dtype=Y.dtype, device=Y.device)[None, :]
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=Y.dtype, device=Y.device)[None, :]
        Y = torch.where(Y > 0, Y, a * Y)
    return Y


def ternary_spgemm(X, fmt: TernaryFormat, bias, alpha=None, *,
                   kernel: Optional[str] = None):
    """Compute ``Y = X @ W + b`` (optionally PReLU'd) from a ternary container.

    ``kernel=None`` picks a fully-exact kernel for ``type(fmt)``; where the
    format has only restricted-domain kernels it takes the widest domain
    (_i8 over _x8) and warns that non-integer X is rounded — the JAX
    package's default dispatch (``ops/api.py:130-158`` there). Among the
    candidates :func:`dispatch_rank` decides. ``kernel="auto"`` measures
    the candidates once for this (shape, container, activation domain) and
    memoizes the winner (``ops/autotune.py``; not while a CUDA stream is
    capturing)."""
    if kernel == "auto":
        from ternary_spgemm_tpu_torch.ops.autotune import autotune
        kernel = autotune(X, fmt, bias, alpha)
    if kernel is not None:
        spec = get_kernel(kernel)
        if not isinstance(fmt, spec.format_cls):
            raise TypeError(
                f"kernel {kernel!r} expects {spec.format_cls.__name__}, "
                f"got {type(fmt).__name__}")
        return spec.fn(X, fmt, bias, alpha)
    candidates = [s for s in _KERNEL_REGISTRY.values()
                  if isinstance(fmt, s.format_cls) and not s.approximate
                  and s.x_absmax is None]
    if not candidates:
        candidates = [s for s in _KERNEL_REGISTRY.values()
                      if isinstance(fmt, s.format_cls) and not s.approximate]
        if candidates:
            widest = max(s.x_absmax for s in candidates)
            candidates = [s for s in candidates if s.x_absmax == widest]
            warnings.warn(
                f"{type(fmt).__name__}'s only exact kernels are integer-"
                "activation (_i8) paths: non-integer X is ROUNDED. Pass an "
                "integer-valued X, or use a container with a fully-exact "
                "f32 kernel.",
                stacklevel=3)
    if not candidates:
        raise TypeError(f"no registered kernel for format {type(fmt).__name__}")
    spec = min(candidates, key=dispatch_rank)
    return spec.fn(X, fmt, bias, alpha)
