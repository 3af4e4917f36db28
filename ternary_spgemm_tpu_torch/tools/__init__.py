"""On-card study and benchmark tools — counterparts of the repository's
``tools/`` scripts that hold kernels, each a module with ``main(argv) ->
int``::

    python -m ternary_spgemm_tpu_torch.tools.ffn_bench        [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.membench         [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.decode_roofline  [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.deposit_study    [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.serve_trace      [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.sass_compare     PARENT_CSRC

Each runs on the card by default (and raises without one); ``--device
cpu`` runs the plain versions, with host-clock times. ``sass_compare``
needs the CUDA toolkit, not a card: it holds two trees' compiled kernel
bodies against each other. Each prints its rows
and one JSON object, and writes a file only when given ``--out``, never
under the repository's ``bench_artifacts/`` (the JAX tools' TPU records).
"""

from __future__ import annotations

import json
import os

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the JAX tools' records, which no tool of the port writes
TPU_RECORDS = os.path.join(_REPO, "bench_artifacts")


def write_json(path: str, obj) -> None:
    """Write ``obj`` to ``path`` as JSON; refuses a path under
    :data:`TPU_RECORDS`."""
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(TPU_RECORDS)]) == \
            os.path.realpath(TPU_RECORDS):
        raise ValueError(f"{path} lies in bench_artifacts/, the JAX tools' "
                         "TPU records; give another --out")
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def timer(dev: torch.device, *, graph: bool = False):
    """``bench.timing``'s timer for ``dev``: CUDA events with the L2
    evicted before each launch on the card (around one replay of a captured
    CUDA graph with ``graph=True``, for a callable of several ops), the host
    clock on the CPU (a CPU number, never a device one). Called as
    ``timer(dev)(fn, x, aux=(...), repeats=...)``; it times ``fn(x,
    *aux)``."""
    from ternary_spgemm_tpu_torch.bench.timing import TIMERS, time_cuda_graph
    if dev.type == "cuda" and graph:
        return time_cuda_graph
    return TIMERS["cuda_events" if dev.type == "cuda" else "wall"]


def emit(obj, out: str = None) -> None:
    """Print ``obj`` as one JSON line; write it to ``out`` when given."""
    print(json.dumps(obj), flush=True)
    if out:
        write_json(out, obj)
