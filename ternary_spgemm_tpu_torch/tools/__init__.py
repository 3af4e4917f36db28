"""On-card study and benchmark tools — counterparts of the repository's
``tools/`` scripts that hold kernels, each a module with ``main(argv) ->
int``::

    python -m ternary_spgemm_tpu_torch.tools.ffn_bench        [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.swiglu_bench     [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.membench         [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.decode_roofline  [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.deposit_study    [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.serve_trace      [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.sass_compare     PARENT_CSRC
    python -m ternary_spgemm_tpu_torch.tools.serving_bench    [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.export_model     export|generate ...
    python -m ternary_spgemm_tpu_torch.tools.sweep            [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.sweep_remeasure  SWEEP.json --kernels ...
    python -m ternary_spgemm_tpu_torch.tools.sweep_sanitize   SWEEP.json
    python -m ternary_spgemm_tpu_torch.tools.grid_summary     SWEEP.json
    python -m ternary_spgemm_tpu_torch.tools.plot_perf        SWEEP.json
    python -m ternary_spgemm_tpu_torch.tools.plot_speedup     SWEEP.json
    python -m ternary_spgemm_tpu_torch.tools.plot_roofline    SWEEP.json
    python -m ternary_spgemm_tpu_torch.tools.model_bench      [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.fused_block_bench [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.chipgate         [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.run_all          --out DIR [--limit N]
    python -m ternary_spgemm_tpu_torch.tools.bytes_validation [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.chain_bench      [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.trace_validation [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.kernel_v4b_study [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.compiler_sweep   [--sets a,b]
    python -m ternary_spgemm_tpu_torch.tools.scaling_bench    [--scheme ...]
    python -m ternary_spgemm_tpu_torch.tools.scaling_projection [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.overlap_evidence [--device cpu]
    python -m ternary_spgemm_tpu_torch.tools.format_diagram   --outdir DIR

Each runs on the card by default (and raises without one); ``--device
cpu`` runs the plain versions, with host-clock times (``scaling_bench``
and ``overlap_evidence`` over gloo processes, ``format_diagram`` packing
its figures' matrices on the host). ``sass_compare``
needs the CUDA toolkit, not a card: it holds two trees' compiled kernel
bodies against each other; ``sweep_sanitize``, ``grid_summary`` and the
plots read a sweep's JSON on the host. Each writes a file only where its
``--out`` / ``--output`` says, never under the repository's
``bench_artifacts/`` (the JAX tools' TPU records).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the JAX tools' records, which no tool of the port writes
TPU_RECORDS = os.path.join(_REPO, "bench_artifacts")


def check_out(path: str) -> str:
    """``path``, refused when it lies under :data:`TPU_RECORDS`."""
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(TPU_RECORDS)]) == \
            os.path.realpath(TPU_RECORDS):
        raise ValueError(f"{path} lies in bench_artifacts/, the JAX tools' "
                         "TPU records; give another --out")
    return path


def write_json(path: str, obj) -> None:
    """Write ``obj`` to ``path`` as JSON, atomically (a temporary file
    renamed over it, so that a reader never sees a torn file); refuses a
    path under :data:`TPU_RECORDS`."""
    tmp = check_out(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


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


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a process group's store."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def card_line(dev: torch.device):
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the first card's), the
    line every measurement stands beside; None on the CPU."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]
