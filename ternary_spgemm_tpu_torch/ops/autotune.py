"""Measured kernel selection — counterpart of
``ternary_spgemm_tpu/ops/autotune.py``: time the registered candidates
once per (device type, container, M/K/N, activation domain, PReLU) and
remember the winner, in-process and optionally in a JSON file.

The cache file is the JAX package's: the key string is its ``_key`` joined
by ``|``, with the device type the port ran on (``cuda`` or ``cpu``) in
the place of JAX's backend, so a winner measured on one backend never
applies on another; the kernel is stored under its JAX registry name
(``ops.api.REFERENCE_KERNELS``, as ``checkpoint.py`` stores names). Either
package reads the other's file.

On the card each candidate is timed with CUDA events, the L2 evicted
before each launch (``bench.timing.time_cuda_events``); on the CPU on the
host clock. The probe reads X's domain back to the host and times
kernels, so it cannot run while a stream is capturing a CUDA graph: it
raises there (the JAX package refuses a tracer the same way), and the
callers resolve ``"auto"`` on an eager call before a capture (the
captured generate loop's warm-ups do). A candidate that raises is
skipped, as in the JAX package, but with a warning that names it and its
error; on a CUDA tensor only a candidate that refuses the shape (its
precondition's ``ValueError``) is skipped so, and any other error (a
kernel that does not build or launch) is raised with the kernel's name.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Optional

import torch

from ternary_spgemm_tpu_torch.ops.api import all_kernels, jax_name, port_name

#: the in-process memo: key tuple -> this port's kernel name (or, for the
#: serving flags, their choice)
_CACHE: dict = {}
_LOCK = threading.Lock()

#: the registered kernels' ``x_absmax`` tiers: the memo buckets the
#: activation absmax by the next tier up, so every batch in the same
#: exactness domain reuses one probe
_DOMAIN_TIERS = (127.0, 256.0, 512.0)


def _refuse_capture(X: torch.Tensor) -> None:
    if X.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "autotune cannot measure while a CUDA stream is capturing: "
            "resolve kernel='auto' on an eager call first (or pass the "
            "kernel autotune chose)")


def _domain(X: torch.Tensor):
    """(absmax, integer_valued) of X: two reductions on its device and two
    scalar readbacks."""
    if X.numel() == 0:
        return 0.0, True
    absmax = float(torch.amax(torch.abs(X)))
    integer = bool(torch.all(X == torch.round(X)))
    return absmax, integer


def _domain_bucket(absmax: float, integer: bool) -> float:
    if not integer:
        return float("inf")
    for t in _DOMAIN_TIERS:
        if absmax <= t:
            return t
    return float("inf")


def _key(fmt, M: int, absmax: float, integer: bool, prelu: bool,
         backend: str) -> tuple:
    """The JAX package's memo key, ``backend`` the device type."""
    return (backend, type(fmt).__name__, M, fmt.K, fmt.N,
            _domain_bucket(absmax, integer), integer, prelu)


def _skey(key: tuple) -> str:
    """The key string of the JSON file."""
    return "|".join(map(str, key))


def candidates_for(fmt, absmax: float, integer: bool):
    """Registered kernels usable for this container and activation domain:
    not approximate, and a restricted-domain kernel (``x_absmax``) only for
    integer-valued X within its bound (the exactness contract)."""
    out = []
    for spec in all_kernels().values():
        if not isinstance(fmt, spec.format_cls) or spec.approximate:
            continue
        if spec.x_absmax is not None:
            if not integer or absmax > spec.x_absmax:
                continue
        out.append(spec)
    return out


def read_cache(skey: str, cache_path: Optional[str]):
    """The value ``cache_path`` holds under ``skey`` (None: no file, no
    entry, or a file that does not parse)."""
    if not cache_path or not os.path.exists(cache_path):
        return None
    try:
        with open(cache_path) as f:
            return json.load(f).get(skey)
    except (OSError, ValueError):
        return None


def write_cache(cache_path: str, skey: str, value: str) -> None:
    """Write ``value`` under ``skey`` into the JSON file (read, updated and
    replaced whole)."""
    disk = {}
    if os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                disk = json.load(f)
        except (OSError, ValueError):
            disk = {}
    if disk.get(skey) == value:
        return
    disk[skey] = value
    tmp = cache_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(disk, f, indent=1)
    os.replace(tmp, cache_path)


def memoized(key: tuple, cache_path: Optional[str], to_disk, from_disk):
    """The memo's value for ``key``, else the file's (memoized), else None;
    a memo hit is written through to the file. ``to_disk`` / ``from_disk``
    map a value between the memo's form and the file's."""
    skey = _skey(key)
    with _LOCK:
        if key in _CACHE:
            if cache_path:
                write_cache(cache_path, skey, to_disk(_CACHE[key]))
            return _CACHE[key]
        stored = read_cache(skey, cache_path)
        if stored is not None:
            _CACHE[key] = from_disk(stored)
            return _CACHE[key]
    return None


def remember(key: tuple, value, cache_path: Optional[str], to_disk) -> None:
    with _LOCK:
        _CACHE[key] = value
        if cache_path:
            write_cache(cache_path, _skey(key), to_disk(value))


def time_call(fn, x: torch.Tensor, *, aux=(), min_seconds: float,
              repeats: int = 1, graph: bool = False) -> float:
    """Seconds of ``fn(x, *aux)`` on x's device: CUDA events on the card
    (around one replay of a CUDA graph with ``graph=True``), the host
    clock on the CPU."""
    from ternary_spgemm_tpu_torch.bench.timing import (
        time_cuda_events, time_cuda_graph, time_wall)

    if x.is_cuda:
        t = time_cuda_graph if graph else time_cuda_events
    else:
        t = time_wall
    return t(fn, x, aux=aux, min_seconds=min_seconds,
             repeats=repeats).seconds


def autotune(X, fmt, bias=None, alpha=None, *, min_seconds: float = 0.02,
             cache_path: Optional[str] = None,
             verbose: bool = False) -> str:
    """The fastest registered kernel (this port's name) for ``X @ fmt``,
    measured on X's device. Memoized under (device type, container, M, K,
    N, activation domain, PReLU); ``cache_path`` persists and reuses the
    winners across processes (the JAX package's file format)."""
    from ternary_spgemm_tpu_torch.formats.generate import generate_bias

    X = torch.as_tensor(X, dtype=torch.float32)
    _refuse_capture(X)
    absmax, integer = _domain(X)
    key = _key(fmt, X.shape[0], absmax, integer, alpha is not None,
               X.device.type)
    hit = memoized(key, cache_path, jax_name, port_name)
    if hit is not None:
        return hit

    cands = candidates_for(fmt, absmax, integer)
    if not cands:
        raise TypeError(f"no exact kernel for {type(fmt).__name__} on this "
                        f"activation domain (absmax={absmax}, int={integer})")
    dev = X.device
    b = (torch.as_tensor(bias, dtype=torch.float32, device=dev)
         if bias is not None else torch.from_numpy(generate_bias(fmt.N)).to(dev))
    al = (None if alpha is None
          else torch.as_tensor(alpha, dtype=torch.float32, device=dev))
    fmt = fmt.prepare(X.shape[0])

    best, best_t = None, float("inf")
    for spec in cands:
        try:
            t = time_call(lambda x, f, bb, _s=spec: _s(x, f, bb, al), X,
                          aux=(fmt, b), min_seconds=min_seconds)
        except Exception as e:
            if X.is_cuda and not isinstance(e, ValueError):
                # a kernel that fails to build or launch on the card is a
                # fault, never a reason to hand the call to another kernel
                raise RuntimeError(f"autotune: candidate {spec.name} failed "
                                   f"on the card: {type(e).__name__}: {e}"
                                   ) from e
            warnings.warn(f"autotune: candidate {spec.name} failed and is "
                          f"skipped: {type(e).__name__}: {e}", stacklevel=2)
            continue
        if verbose:
            print(f"autotune {spec.name}: {t * 1e6:.1f} us", flush=True)
        if t < best_t:
            best, best_t = spec.name, t
    if best is None:
        raise RuntimeError("every candidate kernel failed to run")
    remember(key, best, cache_path, jax_name)
    return best


def resolve(owner, x, fmt, bias, alpha=None) -> Optional[str]:
    """``owner.kernel``, measured on ``x`` (what the kernel receives) and
    kept there when it is ``"auto"``: the first call of a layer or of the
    merged QKV resolves it once."""
    if owner.kernel == "auto":
        owner.kernel = autotune(x, fmt, bias, alpha)
    return owner.kernel
