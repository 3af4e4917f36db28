"""Device-side durations against CUDA-event times — counterpart of the
repository's ``tools/trace_validation.py``.

Each target is traced with ``profiling.trace`` (``torch.profiler``; its
Chrome trace's kernel, memcpy and memset records carry the card's own
durations) over ``--runs`` calls, and timed three ways in the same
process:

* ``device_us`` — the trace's device records a call (every kernel the call
  ran, summed);
* ``event_us`` — CUDA events around one call behind a 1 GiB L2 flush (the
  card, busy with the flush, stays behind the host, so no host path lands
  between the events), median of ``--runs``: the call's span on the card,
  as every kernel time of ``chip_smoke.py`` is taken;
* ``loop_us`` — CUDA events around ``--runs`` calls issued back to back
  (``bench.timing.time_calls``): what a caller that launches call after
  call sees, host gaps included;
* ``graph_us`` — one replay of the call captured as a CUDA graph
  (``bench.timing.time_cuda_graph``), the way ``tools.chain_bench`` times
  its stacks.

``floor_us = event_us - device_us`` is the part of a call's span that no
kernel record covers (the launch and the gaps between a call's kernels).
The targets: ``bare_add`` (``t + 1`` on 8 x 128 floats: the card's least
kernel), ``flagship`` (``CudaTiledBitplane_i8`` at the north star,
32x1024x4096 s=4, its decode body since 32 rows), ``flagship_qkv`` (the
x8 decode call at the bitnet7b merged QKV, 4x4096x12288, in place of the
JAX tool's ``flagship_fullwidth``: the CUDA kernels take no ``tns``), and
``chain8`` / ``chain16`` (8 and 16 chained i8 layers,
``bench.stacked.make_chain``). The verdicts: each decode call's split into
kernel and floor, and the chains' traced marginal a layer, ``(device(16) -
device(8)) / 8``, against the replayed one (``chain_bench``'s slope).

The traces run in a child process (``--child``): late in a long process
``torch.profiler`` (2.11) has delivered traces without their kernel
records; a trace that holds none is taken again, up to 3 times.
``--device cpu`` runs the plain versions, host clock only (no device
record, no event time).

Usage::

    python -m ternary_spgemm_tpu_torch.tools.trace_validation
        [--output PATH] [--runs 100] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

TRACE_RUNS = 100
NS = (32, 1024, 4096, 4)
QKV = (4, 4096, 12288, 2)
CHAINS = (8, 16)
#: Chrome-trace categories of the card's own records
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FLUSH_BYTES = 1 << 30


def parse_trace(events) -> dict:
    """Split a Chrome trace's complete (``ph == "X"``) events into the
    card's records (``DEVICE_CATS``) and the host's (every other category:
    ops, runtime calls, annotations): ``{"device": {name: [us, ...]},
    "host": {name: [us, ...]}}``."""
    out = {"device": {}, "host": {}}
    for e in events:
        if e.get("ph") != "X":
            continue
        side = "device" if e.get("cat") in DEVICE_CATS else "host"
        out[side].setdefault(e["name"], []).append(float(e["dur"]))
    return out


def summarize(parsed: dict, runs: int, top: int = 8) -> dict:
    """A traced target's device time a call (None with no device record)
    and its device records by name: median us and count, the largest total
    first."""
    dev = parsed["device"]
    if not dev:
        return {"device_us": None, "n_events": 0, "ops_us": {}}
    total = sum(sum(v) for v in dev.values())
    ops = sorted(dev.items(), key=lambda kv: -sum(kv[1]))[:top]
    return {"device_us": total / runs,
            "n_events": sum(len(v) for v in dev.values()),
            "ops_us": {k: {"median_us": statistics.median(v),
                           "count": len(v)} for k, v in ops}}


def build_targets(dev) -> dict:
    """name -> a call with no arguments, on ``dev``."""
    from ternary_spgemm_tpu_torch.bench.stacked import make_chain
    from ternary_spgemm_tpu_torch.formats import (
        TiledBitplane, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu_torch.ops import all_kernels

    i8 = all_kernels()["CudaTiledBitplane_i8"]
    x8 = all_kernels()["CudaTiledBitplane_x8"]
    M, K, N, s = NS
    fmts = [TiledBitplane.from_dense(generate_ternary(K, N, s, seed=300 + i),
                                     device=dev) for i in range(max(CHAINS))]
    biases = [torch.from_numpy(generate_bias(N)).to(dev) for _ in fmts]
    X = torch.from_numpy(generate_x(M, K, seed=1)).to(dev)
    qm, qk, qn, qs = QKV
    fq = TiledBitplane.from_dense(generate_ternary(qk, qn, qs, seed=7),
                                  device=dev)
    xq = torch.from_numpy(generate_x(qm, qk, value_range=127,
                                     seed=8)).to(dev)
    bq = torch.zeros(qn, device=dev)
    tiny = torch.ones((8, 128), device=dev)
    targets = {"bare_add": lambda: tiny + 1.0,
               "flagship": lambda: i8.fn(X, fmts[0], biases[0], None),
               "flagship_qkv": lambda: x8.fn(xq, fq, bq, None)}
    for L in CHAINS:
        chain = make_chain(i8, fmts[:L], biases[:L], K)
        targets[f"chain{L}"] = lambda chain=chain: chain(X)
    return targets


def traced(fn, dev, runs: int, log_dir: str) -> dict:
    """:func:`summarize` of ``runs`` calls of ``fn`` under
    ``profiling.trace`` (taken again, up to 3 times, while a card's trace
    holds no device record); ``traces`` counts the traces taken."""
    from ternary_spgemm_tpu_torch import profiling

    for tries in range(1, 4):
        with profiling.trace(log_dir, device=dev) as t:
            for _ in range(runs):
                fn()
        row = summarize(parse_trace(profiling.trace_events(t.path)), runs)
        os.remove(t.path)
        if row["device_us"] is not None or dev.type != "cuda":
            break
    return {**row, "traces": tries}


def measure(dev, runs: int) -> dict:
    """Every target traced and timed in this process (module docstring)."""
    from ternary_spgemm_tpu_torch.bench.timing import (
        event_ms, time_calls, time_cuda_graph)

    flush = (torch.empty(FLUSH_BYTES // 4, device=dev) if dev.type == "cuda"
             else None)
    rows = {}
    with tempfile.TemporaryDirectory() as log_dir:
        for name, fn in build_targets(dev).items():
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            row = traced(fn, dev, runs, log_dir)
            row["loop_us"] = time_calls(fn, dev, runs).seconds * 1e6
            if dev.type == "cuda":
                row["event_us"] = 1e3 * event_ms(fn, reps=runs, flush=flush)
                row["graph_us"] = 1e6 * time_cuda_graph(
                    lambda _x: fn(), flush, min_seconds=0.05).seconds
                if row["device_us"] is not None:
                    row["floor_us"] = row["event_us"] - row["device_us"]
            rows[name] = row
            print(f"{name}: device {row['device_us']} us, event "
                  f"{row.get('event_us')} us, loop {row['loop_us']:.3f} us, "
                  f"graph {row.get('graph_us')} us", flush=True)
    return rows


def verdicts(t: dict) -> dict:
    """The floor and the chains' marginal from the targets' rows (keys
    where their inputs were measured)."""
    out = {}
    for name in ("bare_add", "flagship", "flagship_qkv"):
        row = t.get(name, {})
        if row.get("floor_us") is not None:
            out[f"{name}_kernel_us"] = row["device_us"]
            out[f"{name}_floor_us"] = row["floor_us"]
            out[f"{name}_floor_share"] = row["floor_us"] / row["event_us"]
    lo, hi = (t.get(f"chain{L}", {}) for L in CHAINS)
    span = CHAINS[1] - CHAINS[0]
    if lo.get("device_us") is not None and hi.get("device_us") is not None:
        out["trace_stacked_marginal_us"] = (
            hi["device_us"] - lo["device_us"]) / span
    if "graph_us" in lo and "graph_us" in hi:
        out["graph_stacked_marginal_us"] = (
            hi["graph_us"] - lo["graph_us"]) / span
    if {"trace_stacked_marginal_us", "graph_stacked_marginal_us"} <= set(out):
        out["marginal_gap_us"] = (out["graph_stacked_marginal_us"]
                                  - out["trace_stacked_marginal_us"])
    return out


def run_child(device: str, runs: int) -> dict:
    """:func:`measure` in a child process -> its targets' rows."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "ternary_spgemm_tpu_torch.tools."
         "trace_validation", "--child", "--device", device, "--runs",
         str(runs)], capture_output=True, text=True, env=env, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the traced child exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    (line,) = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("RESULT ")]
    return json.loads(line.split(" ", 1)[1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.trace_validation")
    p.add_argument("--runs", type=int, default=TRACE_RUNS)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--child", action="store_true",
                   help="trace and time in this process, print RESULT json")
    args = p.parse_args(argv)

    from ternary_spgemm_tpu_torch.bench.harness import device_name
    from ternary_spgemm_tpu_torch.tools import card_line, write_json
    from ternary_spgemm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.child:
        print("RESULT " + json.dumps(measure(dev, args.runs)), flush=True)
        return 0
    targets = run_child(args.device, args.runs)
    out = {"config": {"ns": NS, "qkv": QKV, "chains": CHAINS},
           "device": device_name(args.device), "card": card_line(dev),
           "trace_runs": args.runs, "targets": targets,
           "verdicts": verdicts(targets)}
    if args.output:
        write_json(args.output, out)
    keys = ("device_us", "event_us", "loop_us", "graph_us", "traces")
    print(json.dumps({"trace_validation": out["verdicts"],
                      "targets": {k: {q: v.get(q) for q in keys}
                                  for k, v in targets.items()},
                      "device": out["device"], "card": out["card"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
