"""``ternary_spgemm_tpu_torch.profiling`` against the JAX package's
``profiling`` (``tests/test_aux.py`` holds the JAX functions so): a trace
writes files, here a Chrome trace that names the annotated region;
``device_memory_stats`` is ``{}`` without a device's allocator;
``hlo_cost`` has no compiler to ask and points to the analytic count;
``compiled_memory`` counts at least the argument's bytes, as the JAX
function's compiled figure does for the same argument."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_spgemm_tpu import profiling as jprofiling
from ternary_spgemm_tpu_torch import profiling
from ternary_spgemm_tpu_torch.formats import TiledBitplane, generate_ternary
from ternary_spgemm_tpu_torch.ops import ternary_spgemm


def test_trace_writes_a_chrome_trace_with_the_region(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d, device="cpu") as t:
        with profiling.annotate("port/region"):
            torch.ones((64, 64)) * 3
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert files == [t.path]
    events = profiling.trace_events(t.path)
    assert any(e.get("name") == "port/region" for e in events)
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_traces_do_not_overwrite(tmp_path):
    paths = []
    for _ in range(2):
        with profiling.trace(str(tmp_path), device="cpu") as t:
            torch.zeros(4) + 1
        paths.append(t.path)
    assert len(set(paths)) == 2 and all(os.path.exists(p) for p in paths)


def test_device_memory_stats_on_the_cpu():
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_hlo_cost_points_to_the_analytic_count():
    with pytest.raises(NotImplementedError, match="bench.instrument"):
        profiling.hlo_cost(lambda a: a * 2.0, torch.ones(4))


@pytest.mark.parametrize("shape", [(128, 128), (32, 1000)])
def test_compiled_memory_counts_the_arguments(shape):
    """As ``tests/test_aux.py`` holds the JAX function: the argument bytes
    at least the argument's; the JAX figure for the same array equal."""
    m = profiling.compiled_memory(lambda a: a * 2.0, torch.ones(shape))
    nbytes = int(np.prod(shape)) * 4
    assert m["argument_size_in_bytes"] >= nbytes
    assert m["output_size_in_bytes"] == nbytes
    want = jprofiling.compiled_memory(lambda a: a * 2.0, jnp.ones(shape))
    if want:
        assert m["argument_size_in_bytes"] == want["argument_size_in_bytes"]
        assert m["output_size_in_bytes"] == want["output_size_in_bytes"]


def test_compiled_memory_counts_a_container():
    W = torch.from_numpy(generate_ternary(64, 128, 4, seed=0))
    fmt = TiledBitplane.from_dense(W)
    x = torch.ones((4, 64))
    m = profiling.compiled_memory(
        lambda a, f: ternary_spgemm(a, f, torch.zeros(128),
                                    kernel="CudaTiledBitplane_i8"), x, fmt)
    assert m["argument_size_in_bytes"] >= x.nbytes + fmt.size_bytes()
    assert m["output_size_in_bytes"] == 4 * 128 * 4
