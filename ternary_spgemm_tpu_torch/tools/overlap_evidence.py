"""Transfer windows of the ring-overlapped SpMM and the compute inside them
— counterpart of the repository's ``tools/overlap_evidence.py``.

The JAX tool reads XLA's scheduled HLO for ``collective-permute-start`` /
``-done`` pairs with compute between them. Here each rank of a group of d
processes traces one call of ``parallel.overlapped_gather_spgemm`` with
``profiling.trace`` (``torch.profiler``), and :func:`analyze_trace` reads
the rank's host timeline: a step's window opens at its posts
(``batch_isend_irecv``: the ``c10d::send`` / ``c10d::recv_`` ops,
``parallel/spgemm.py``) and closes where its waits begin (the
``overlapped_gather/wait`` range, ``parallel.spgemm.WAIT_RANGE``); the
compute inside is every op of the step's SpMM issued in between (``aten``
ops of the plain versions, kernel launches on the card). The keys are the
JAX tool's: ``async_pairs`` (windows) and ``pairs_with_compute_inside``.
A ring of d ranks has d - 1 windows a rank (the last step sends nothing).

Over gloo CPU processes (``--device cpu``) this shows the program's
shape, as the JAX tool's ``--cpu`` mode does: the SpMM is issued while
the transfer is in flight, not that the card runs both at once. That
evidence, NCCL's kernels beside the SpMM's on the card, needs two or more
cards; on one card (d = 1, the default there) there is no transfer.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.overlap_evidence
        [--devices D] [--M 32 --K 256 --n-per-device 512] [--out PATH]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

#: the ops that post a step's sends and receives
POST_OPS = ("c10d::send", "c10d::recv_")
#: allocations, which compute nothing
ALLOC_OPS = ("aten::empty", "aten::empty_like", "aten::empty_strided",
             "aten::zeros", "aten::resize_")
#: the runtime calls that launch a kernel on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _is_compute(e) -> bool:
    name, cat = e.get("name", ""), e.get("cat")
    if cat == "cuda_runtime":
        return name in LAUNCH_CALLS
    return (cat == "cpu_op" and name.startswith("aten::")
            and name not in ALLOC_OPS)


def analyze_trace(events, wait_range: str = None) -> dict:
    """Count the transfer windows of a rank's Chrome trace and the compute
    issued inside each (module docstring). ``wait_range`` defaults to
    ``parallel.spgemm.WAIT_RANGE``."""
    if wait_range is None:
        from ternary_spgemm_tpu_torch.parallel.spgemm import WAIT_RANGE
        wait_range = WAIT_RANGE
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") not in ("kernel", "gpu_memcpy",
                                            "gpu_memset")),
                  key=lambda e: float(e["ts"]))
    pairs, opened, comps, unmatched = [], None, [], 0
    for e in host:
        ts = float(e["ts"])
        if e["name"] in POST_OPS:
            if opened is None:
                opened, comps = ts, []
        elif e["name"] == wait_range:
            if opened is None:
                unmatched += 1
                continue
            pairs.append({"start_us": opened, "done_us": ts,
                          "compute_ops_in_window": len(comps),
                          "ops": comps[:4]})
            opened = None
        elif opened is not None and _is_compute(e):
            comps.append(e["name"])
    return {"async_pairs": len(pairs),
            "pairs_with_compute_inside": sum(
                1 for q in pairs if q["compute_ops_in_window"] > 0),
            "unclosed_windows": int(opened is not None),
            "waits_without_post": unmatched, "pairs": pairs}


def rank_main(rank: int, d: int, port: int, device: str, args) -> dict:
    """One rank: join the group, trace one call, analyze its trace."""
    import torch.distributed as dist

    from ternary_spgemm_tpu_torch import profiling
    from ternary_spgemm_tpu_torch.formats import (
        BlockPackedTernary, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.parallel import (
        init_distributed, make_mesh, overlapped_gather_spgemm)

    init_distributed(rank, d, f"tcp://127.0.0.1:{port}", device)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device("cpu"))
        mesh = make_mesh({"model": d}, device_type=device)
        N = args.n_per_device * d
        fmt = BlockPackedTernary.from_dense(
            generate_ternary(args.K, N, 4, seed=0), device=dev)
        b = torch.from_numpy(generate_bias(N)).to(dev)
        X = torch.from_numpy(generate_x(max(args.M, d), args.K,
                                        seed=1)).to(dev)
        call = lambda: overlapped_gather_spgemm(X, fmt, b, mesh=mesh,
                                                axis="model")
        call()
        dist.barrier()
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp, device=dev) as t:
                call()
            events = profiling.trace_events(t.path)
        return analyze_trace(events)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.overlap_evidence")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks (default: the cards here; 2 on the CPU)")
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--K", type=int, default=256)
    p.add_argument("--n-per-device", type=int, default=512)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.tools import (
        card_line, free_port, write_json)
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    d = args.devices or (torch.cuda.device_count() if dev.type == "cuda"
                         else 2)
    if args.rank is not None:
        print("RESULT " + json.dumps(rank_main(args.rank, d, args.port,
                                               args.device, args)),
              flush=True)
        return 0
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [q for q in [os.environ.get("PYTHONPATH")] if q]),
        OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "ternary_spgemm_tpu_torch.tools."
           "overlap_evidence", "--devices", str(d), "--port", str(port),
           "--M", str(args.M), "--K", str(args.K), "--n-per-device",
           str(args.n_per_device), "--device", args.device]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(d)]
    try:
        outs = [q.communicate(timeout=600)[0] for q in procs]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    for r, (q, o) in enumerate(zip(procs, outs)):
        if q.returncode != 0:
            raise RuntimeError(f"rank {r} exited {q.returncode}:\n"
                               f"{o[-3000:]}")
    ranks = [json.loads([ln for ln in o.splitlines()
                         if ln.startswith("RESULT ")][0].split(" ", 1)[1])
             for o in outs]
    want = d - 1
    full = all(r["async_pairs"] == want
               and r["pairs_with_compute_inside"] == want for r in ranks)
    if d == 1:
        verdict = ("NO TRANSFER: one rank; the evidence needs two or more "
                   "ranks")
    elif full:
        verdict = ("OVERLAPPED (program shape): every rank issues its SpMM "
                   "inside each of its d - 1 transfer windows")
    else:
        verdict = "NOT OVERLAPPED: a window without compute, or missing"
    result = {"backend": ("nccl" if dev.type == "cuda" else "gloo"),
              "devices": d, "N": args.n_per_device * d, "K": args.K,
              "device": device_name(args.device), "card": card_line(dev),
              "verdict": verdict, "ranks": ranks,
              "caveat": ("host timeline: the SpMM is issued between the "
                         "posts and the waits; that the card runs it while "
                         "NCCL moves the chunk needs two or more cards")}
    if args.out:
        write_json(args.out, result)
    print(json.dumps({"overlap_evidence": verdict, "devices": d,
                      "windows": [r["async_pairs"] for r in ranks],
                      "with_compute": [r["pairs_with_compute_inside"]
                                       for r in ranks],
                      "device": result["device"], "card": result["card"]}),
          flush=True)
    return 0 if d == 1 or full else 1


if __name__ == "__main__":
    sys.exit(main())
