"""Profiling and memory accounting — counterpart of
``ternary_spgemm_tpu/profiling.py``.

The JAX package's tiers and their forms here:

1/2. :func:`trace` — a ``torch.profiler`` trace written as a Chrome trace
     under ``log_dir`` (open it in Perfetto or ``chrome://tracing``): the
     card's kernels, copies and memsets with their device time where a
     card is visible, host ops everywhere; :func:`device_memory_stats` for
     live device-memory accounting; :func:`annotate` names a region in
     the trace (and as an NVTX range on the card).
3.   Analytic instrumentation lives in ``bench/instrument.py`` (the same
     formulas as the JAX package's).
4.   :func:`hlo_cost` and :func:`compiled_memory` asked XLA's compiler.
     PyTorch has no such compiler here: :func:`hlo_cost` raises and points
     to the analytic count, and :func:`compiled_memory` measures one call
     instead of reading a compiled program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import tempfile
from typing import Any, Dict, List

import torch

@dataclasses.dataclass
class Trace:
    """What :func:`trace` yields: ``path`` is the Chrome-trace file, written
    when the ``with`` block ends."""
    path: str


@contextlib.contextmanager
def trace(log_dir: str, *, device=None):
    """Trace the ``with`` block with ``torch.profiler`` and write it as a
    Chrome trace, a new file ``log_dir/trace_*.json``.

    CUDA activity (each kernel, copy and memset with its device time) is
    recorded when a card is visible, or where ``device`` names a CUDA
    device; host activity always. On the card the block's work is
    synchronised before the trace stops, so its kernels are in it.

    Example::

        with profiling.trace("/tmp/trace") as t:
            kernel(X, fmt, b)
        events = profiling.trace_events(t.path)
    """
    from torch.profiler import ProfilerActivity, profile

    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    os.makedirs(log_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=log_dir)
    os.close(fd)
    out = Trace(path)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        yield out
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(out.path)


def trace_events(path: str) -> List[dict]:
    """The events of a Chrome trace that :func:`trace` wrote."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_memory_stats(device=None) -> Dict[str, Any]:
    """Live device-memory statistics under the JAX package's key names:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, now and at their peak since the last
    ``torch.cuda.reset_peak_memory_stats``), ``bytes_limit`` (the card's
    memory) and ``bytes_reserved`` (what the allocator holds from the
    driver). ``{}`` on the CPU, as the JAX function gives where a backend
    has none."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0)}


def hlo_cost(fn, *args) -> Dict[str, float]:
    """XLA's cost analysis of ``jit(fn)(*args)`` in the JAX package.

    PyTorch has no compiler whose cost model could be asked, and a counter
    of dispatched ops (``FlopCounterMode``) cannot see the port's CUDA
    kernels, which would count 0 flops. Raises :class:`NotImplementedError`:
    use ``ternary_spgemm_tpu_torch.bench.instrument.instrument(M, fmt)``,
    the analytic flop and byte count of an SpMM."""
    raise NotImplementedError(
        "hlo_cost asks XLA's compiler, which PyTorch does not have; use "
        "ternary_spgemm_tpu_torch.bench.instrument.instrument(M, fmt), the "
        "analytic flop and byte count")


def _tensors(obj):
    """The tensors in ``obj``: a tensor, a container (a dataclass of
    tensors), a module's parameters and buffers, or lists, tuples and dicts
    of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from itertools.chain(obj.parameters(), obj.buffers())
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _tensor_bytes(obj) -> int:
    return sum(t.nelement() * t.element_size() for t in _tensors(obj))


def compiled_memory(fn, *args) -> Dict[str, int]:
    """Where the bytes of ``fn(*args)`` live — measured over one call, not
    read from a compiled program (the JAX function asks XLA's): the bytes
    of the arguments' tensors (``argument_size_in_bytes``) and of the
    result's (``output_size_in_bytes``) and, on the card, the peak the
    call allocated beyond its result (``temp_size_in_bytes``, from
    ``torch.cuda.max_memory_allocated`` around the call, whose peak
    statistic it resets). On the CPU there is no allocator to read, so the
    temporary bytes are left out."""
    args_bytes = _tensor_bytes(args)
    on_card = any(t.is_cuda for t in _tensors(args))
    if not on_card:
        out = fn(*args)
        return {"argument_size_in_bytes": args_bytes,
                "output_size_in_bytes": _tensor_bytes(out)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    out_bytes = _tensor_bytes(out)
    temp = torch.cuda.max_memory_allocated() - base - out_bytes
    return {"argument_size_in_bytes": args_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": max(0, temp)}


@contextlib.contextmanager
def annotate(name: str):
    """Name a region in profiler traces: a ``torch.profiler``
    ``record_function`` range, and an NVTX range where a card is
    visible."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
