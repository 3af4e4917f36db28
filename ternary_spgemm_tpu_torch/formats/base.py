"""Abstract interface for ternary sparse containers.

Counterpart of ``ternary_spgemm_tpu/formats/base.py``. A container is a
frozen dataclass whose array fields (``ARRAY_FIELDS``) are torch tensors and
whose other fields are static shape metadata (an optional derived tensor,
such as TCSC's gather tables, may be None). :func:`register_format`
records each container by class name (:func:`all_formats`, what the
checkpoint loader looks names up in). There is no pytree registration:
:meth:`TernaryFormat.to` moves the tensors, and modules that
hold a container keep its tensors as registered buffers
(:func:`register_format_buffers`) so that ``module.to(device)`` moves them.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar, Dict, Type

import numpy as np
import torch

_FORMAT_REGISTRY: Dict[str, Type["TernaryFormat"]] = {}


def register_format(cls):
    """Class decorator: make a container class a frozen dataclass and
    register it by class name (a base whose name starts with ``_`` is not
    registered)."""
    cls = dataclasses.dataclass(frozen=True, eq=False)(cls)
    if not cls.__name__.startswith("_"):
        _FORMAT_REGISTRY[cls.__name__] = cls
    return cls


def all_formats() -> Dict[str, Type["TernaryFormat"]]:
    """Class name -> container class, for every registered container: the
    names the JAX package's ``all_formats()`` gives the same containers,
    which the checkpoint files record."""
    return dict(_FORMAT_REGISTRY)


class TernaryFormat(abc.ABC):
    """Base class for ternary sparse containers."""

    ARRAY_FIELDS: ClassVar[tuple] = ()

    @classmethod
    @abc.abstractmethod
    def from_dense(cls, W, **kwargs) -> "TernaryFormat":
        """Build the container from a dense ``(K, N)`` matrix in {-1,0,1}."""

    @abc.abstractmethod
    def to_dense(self) -> torch.Tensor:
        """Reconstruct the dense ``(K, N)`` int8 matrix (round-trip check)."""

    @abc.abstractmethod
    def size_bytes(self) -> int:
        """Byte footprint of the container."""

    @property
    @abc.abstractmethod
    def shape(self) -> tuple:
        """Logical dense shape ``(K, N)``."""

    def arrays(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in self.ARRAY_FIELDS}

    def meta(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in self.ARRAY_FIELDS}

    @property
    def nnz(self) -> int:
        """Nonzero weights, counted on the container's device."""
        return int(torch.count_nonzero(self.to_dense()))

    def prepare(self, M: int) -> "TernaryFormat":
        """Materialize any M-dependent derived views a kernel will need,
        outside timed regions. Default: nothing to do (TCSC builds its
        padded gather tables when the M-chunked path will run)."""
        return self

    @property
    def device(self) -> torch.device:
        return getattr(self, self.ARRAY_FIELDS[0]).device

    def to(self, device) -> "TernaryFormat":
        """A copy with every tensor on ``device`` (optional tensors that are
        None stay None)."""
        return dataclasses.replace(
            self, **{k: None if v is None else v.to(device)
                     for k, v in self.arrays().items()})


def register_format_buffers(module: torch.nn.Module, fmt: TernaryFormat,
                            prefix: str = "fmt") -> None:
    """Keep ``fmt``'s tensors as buffers ``<prefix>_<field>`` of ``module``
    (so ``module.to(device)`` moves them); :func:`format_from_buffers`
    rebuilds the container from them."""
    for name, t in fmt.arrays().items():
        module.register_buffer(f"{prefix}_{name}", t)
    module._format_meta = getattr(module, "_format_meta", {})
    module._format_meta[prefix] = (type(fmt), fmt.meta())


def format_from_buffers(module: torch.nn.Module,
                        prefix: str = "fmt") -> TernaryFormat:
    cls, meta = module._format_meta[prefix]
    return cls(**{f: getattr(module, f"{prefix}_{f}") for f in cls.ARRAY_FIELDS},
               **meta)


def as_f32(x, device=None) -> torch.Tensor:
    """numpy or torch -> a float32 tensor on ``device`` (read-only numpy
    arrays, such as views of JAX arrays, are copied)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    x = torch.as_tensor(x, dtype=torch.float32)
    return x.to(device).contiguous() if device is not None else x.contiguous()


def _as_int8_dense(W, device=None) -> torch.Tensor:
    """A dense ternary matrix (numpy or torch) as an int8 tensor."""
    if isinstance(W, np.ndarray):
        W = torch.from_numpy(np.array(W))
    W = W.to(device) if device is not None else W
    if W.dtype != torch.int8:
        if not bool(((W == -1) | (W == 0) | (W == 1)).all()):
            raise ValueError("dense ternary matrix must only contain {-1, 0, +1}")
        W = W.to(torch.int8)
    elif bool(((W < -1) | (W > 1)).any()):
        raise ValueError("dense ternary matrix must only contain {-1, 0, +1}")
    return W
