"""The device an entry point of the port runs on."""

from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``: the card unless the caller asks for
    the CPU. Raises for ``cuda`` when torch sees no card (an entry point
    never carries on on the CPU in its place) and for any other type."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA "
            "device; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The streaming multiprocessors of the card ``dev`` (132 on an H100
    SXM)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count
