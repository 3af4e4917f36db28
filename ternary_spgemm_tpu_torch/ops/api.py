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
#: in its order), each name with its counterpart in this registry, or None
#: where that kernel is not ported yet (``ROADMAP.md`` queues A and B). The
#: port's benchmark sweeps only the counterparts; :func:`unported` names the
#: rest.
REFERENCE_KERNELS: Dict[str, Optional[str]] = {
    "BaseTCSC": "BaseTCSC",
    "BaseTCSR": None,
    "BlockedTCSC": None,
    "InterleavedTCSC": None,
    "InterleavedBlockedTCSC": None,
    "EllTCSC": None,
    "BlockedEllTCSC": None,
    "DenseMXU": None,
    "DenseMXU_bf16": None,
    "DenseMXU_x8": None,
    "PackedMXU_2bit": None,
    "PackedMXU_base3": None,
    "PackedCSC": None,
    "PallasDense": None,
    "PallasDense_bf16": None,
    "PallasPacked2Bit": None,
    "PallasPacked53": None,
    "PallasDense_i8": None,
    "PallasPacked2Bit_i8": None,
    "PallasPacked53_i8": None,
    "PallasBlockPacked_i8": None,
    "PallasTiledDense_i8": "CudaTiledDense_i8",
    "PallasTiledDense_x8": "CudaTiledDense_x8",
    "PallasTiledBlockPacked_i8": None,
    "PallasTiledBitplane_i8": "CudaTiledBitplane_i8",
    "PallasTiledNibblePair_i8": "CudaTiledNibblePair_i8",
    "PallasTiledBitplane_x8": "CudaTiledBitplane_x8",
    "PallasTiledBitplane_bf16": "CudaTiledBitplane_bf16",
    "PallasEllDeposit_i8": None,
    "PallasTiledEllGather": None,
    "PallasEllGather": None,
}


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

    def __call__(self, X, fmt, bias, alpha=None):
        return self.fn(X, fmt, bias, alpha)


def register_kernel(name: str, format_cls: Type[TernaryFormat], *,
                    description: str = "", reference: str = "",
                    approximate: bool = False,
                    x_absmax: Optional[int] = None, x_bytes: float = 4.0):
    """Decorator: register a kernel under ``name``."""

    def deco(fn):
        if name in _KERNEL_REGISTRY:
            raise ValueError(f"kernel {name!r} already registered")
        _KERNEL_REGISTRY[name] = KernelSpec(
            name=name, fn=fn, format_cls=format_cls, description=description,
            reference=reference, approximate=approximate,
            x_absmax=x_absmax, x_bytes=x_bytes)
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
    package's default dispatch (``ops/api.py:130-158`` there)."""
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
    return min(candidates, key=lambda s: s.name).fn(X, fmt, bias, alpha)
