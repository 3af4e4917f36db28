"""Analytic flops/bytes instrumentation and the roofline model —
counterpart of ``ternary_spgemm_tpu/bench/instrument.py``.

The reference counts useful adds and container bytes
(``cpp_impl/comp.h:8-21,48-50``); the quantities here are computed from the
container: ``flops = M*(nnz + N)`` and operational intensity =
flops / (4*(M*K + M*N + N [+N]) + container bytes) (``main.cpp:264-271``).
These formulas are device-free and identical to the JAX package's.

The roofline's bandwidth is the card's: :func:`advertised_hbm_bandwidth`
knows only NVIDIA cards, by ``torch.cuda.get_device_name``, and raises for
any other device; :func:`measure_hbm_bandwidth` times a streaming pass.
"""

from __future__ import annotations

import dataclasses

import torch

from ternary_spgemm_tpu_torch.formats.base import TernaryFormat


@dataclasses.dataclass(frozen=True)
class Instrumentation:
    flops: int                  # useful adds (reference convention)
    nnz: int
    total_input_bytes: int      # 4*(M*K + M*N + N [+N]) + container bytes
    container_bytes: int
    operational_intensity: float  # flops / total_input_bytes
    #: the kernel's own minimum traffic: X at the registered ``x_bytes`` per
    #: element + container + f32 output + bias (+alpha)
    own_bytes: int = 0

    @property
    def dense_equiv_flops(self) -> int:
        """2*M*N*K — what a dense matmul would be billed."""
        return self._dense_flops

    _dense_flops: int = 0


def instrument(M: int, fmt: TernaryFormat, *, prelu: bool = False,
               x_bytes: float = 4.0) -> Instrumentation:
    K, N = fmt.shape
    nnz = fmt.nnz
    flops = M * (nnz + N)
    ds = fmt.size_bytes()
    total = 4 * (M * K + M * N + N + (N if prelu else 0)) + ds
    own = int(x_bytes * M * K) + 4 * (M * N + N + (N if prelu else 0)) + ds
    return Instrumentation(
        flops=flops, nnz=nnz, total_input_bytes=total, container_bytes=ds,
        operational_intensity=flops / total if total else 0.0,
        own_bytes=own, _dense_flops=2 * M * N * K)


#: Advertised device-memory bandwidth of NVIDIA cards (GB/s; NVIDIA's data
#: sheets), matched by substring of ``torch.cuda.get_device_name``.
ADVERTISED_HBM_GBPS = {
    "H100 80GB HBM3": 3350.0,    # H100 SXM5
    "H100 PCIe": 2000.0,
    "H100 NVL": 3900.0,
    "H200": 4800.0,
}


#: The H100 SXM's int8 tensor-core peak at its 700 W limit (operations a
#: second, dense; NVIDIA's data sheet): the fastest rate the card computes
#: at, which bounds any kernel's operations.
INT8_OPS_PER_S = 1979e12


def advertised_hbm_bandwidth(device=None) -> float:
    """Bytes/s of the card ``device`` (default: the current one); raises
    for a device the table does not know — pass ``bandwidth=`` then."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"no advertised memory bandwidth for device {dev}: pass "
            "bandwidth= (or measure it with measure_hbm_bandwidth on a card)")
    kind = torch.cuda.get_device_name(dev)
    for name, gbps in ADVERTISED_HBM_GBPS.items():
        if name.lower() in kind.lower():
            return gbps * 1e9
    raise RuntimeError(
        f"no advertised memory bandwidth for {kind!r}: pass bandwidth= (or "
        "measure it with measure_hbm_bandwidth)")


def measure_hbm_bandwidth(nbytes: int = 1 << 28, device=None) -> float:
    """Measured streaming bandwidth (bytes/s) of the card: the median CUDA
    event time of ``x + 1`` over an ``nbytes`` f32 buffer, which reads and
    writes ``nbytes`` each (far above the 50 MB L2)."""
    from ternary_spgemm_tpu_torch.bench.timing import event_ms

    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_hbm_bandwidth runs on a card; got {dev}")
    x = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    ms = event_ms(lambda: x + 1.0, reps=20, warmup=3)
    return 2 * nbytes / (ms / 1e3)


def roofline_fraction(inst: Instrumentation, seconds: float,
                      bandwidth_bytes_per_s: float) -> float:
    """Achieved fraction of the bandwidth roofline (reference byte formula:
    X and Y at 4 B/element plus the container bytes)."""
    ideal = inst.total_input_bytes / bandwidth_bytes_per_s
    return ideal / seconds if seconds > 0 else 0.0


def own_roofline_fraction(inst: Instrumentation, seconds: float,
                          bandwidth_bytes_per_s: float) -> float:
    """Fraction of the kernel's own-bytes roofline (``own_bytes`` over the
    bandwidth)."""
    ideal = inst.own_bytes / bandwidth_bytes_per_s
    return ideal / seconds if seconds > 0 else 0.0
