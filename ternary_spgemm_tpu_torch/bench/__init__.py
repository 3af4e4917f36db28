"""Benchmarking, timing and instrumentation harness — counterpart of
``ternary_spgemm_tpu/bench`` (the stacked marginal: ``bench/stacked.py``).

``python -m ternary_spgemm_tpu_torch`` (the CLI) and
``python -m ternary_spgemm_tpu_torch.bench.headline`` (the one-line
headline) drive :func:`run_config`.
"""

from ternary_spgemm_tpu_torch.bench.harness import (
    BenchConfig,
    KernelResult,
    dump_json,
    run_config,
    to_reference_json,
)
from ternary_spgemm_tpu_torch.bench.instrument import (
    Instrumentation,
    advertised_hbm_bandwidth,
    instrument,
    measure_hbm_bandwidth,
    roofline_fraction,
)
from ternary_spgemm_tpu_torch.bench.stacked import measure_stacked_marginal
from ternary_spgemm_tpu_torch.bench.timing import (
    TIMERS,
    TimingResult,
    time_cuda_events,
    time_wall,
)

__all__ = [
    "BenchConfig", "KernelResult", "run_config", "to_reference_json", "dump_json",
    "Instrumentation", "instrument", "advertised_hbm_bandwidth",
    "measure_hbm_bandwidth", "roofline_fraction", "measure_stacked_marginal",
    "TIMERS", "TimingResult", "time_cuda_events", "time_wall",
]
