"""Where the A8 serve's time goes on the card: one ``torch.profiler`` trace
of a prefill and one of a decode step.

It builds a preset of ``models.serving.PRESETS`` (``bitnet7b``: all 32
layers, random ternary weights of density 1/2 from seed 0, as
``chip_smoke.py`` phase 5 builds it), runs one prefill of 4 prompts of 128
tokens (phase 5's) and one decode step into an int8 KV cache untraced (the
warm-up), then each once more under the profiler, synchronised, and
reports for each call:

* ``wall_ms``: the host clock around the traced call (the profiler's own
  cost included);
* ``device_busy_ms``: the union of the intervals in which a kernel, memset
  or memcpy ran on the card, and ``device_busy_share`` = busy / wall (the
  rest is the card idle, waiting for the host);
* ``kernel_ms`` (the kernels' summed durations), ``ternary_ms`` (the part
  in the port's own kernels, the ``ternary::`` namespace of ``csrc/``) and
  ``kernels`` (their count);
* ``host_ops``: the aten ops the call issued;
* ``top``: the kernels with the most device time, by name.

With ``--graph`` it traces one replay of the captured prefill and one
of the captured decode step (``models/graphs.py``, captured and replayed
once each before the traced replays) in place of the eager calls: what
share of the step the card is busy once the host no longer issues each
op. A replay is one host call, so its ``host_ops`` count only what the
profiler records around the graph launch.

Usage::

    python -m ternary_spgemm_tpu_torch.tools.serve_trace [--preset bitnet7b]
        [--device cuda|cpu] [--graph] [--out PATH]

On the CPU there is no device: the busy figures are None and the times
are the plain versions' host time; ``--graph`` raises there.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

from ternary_spgemm_tpu_torch import profiling
from ternary_spgemm_tpu_torch.bench.harness import device_name
from ternary_spgemm_tpu_torch.models import serving
from ternary_spgemm_tpu_torch.models.generate import init_cache
from ternary_spgemm_tpu_torch.models.graphs import captured
from ternary_spgemm_tpu_torch.tools import emit
from ternary_spgemm_tpu_torch.utils.device import resolve_device

#: chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
#: names of the port's own kernels contain this (``csrc/``'s namespace)
PORT_NAMESPACE = "ternary::"
TOP = 12
#: the serve's requests and prompt tokens (``chip_smoke.py`` phase 5)
BATCH, PROMPT = 4, 128


def busy_union(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarize(events, wall_s: float, on_device: bool) -> dict:
    """A traced call's figures (module docstring) from its chrome-trace
    events (``ts`` and ``dur`` in microseconds)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name = {}
    for e in kernels:
        n, ms = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    busy = busy_union((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e3
    wall_ms = wall_s * 1e3
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy if on_device else None,
        "device_busy_share": busy / wall_ms if on_device else None,
        "kernel_ms": sum(ms for _, ms in by_name.values()),
        "ternary_ms": sum(ms for n, (_, ms) in by_name.items()
                          if PORT_NAMESPACE in n),
        "kernels": len(kernels),
        "host_ops": sum(1 for e in events if e.get("ph") == "X"
                        and e.get("cat") == "cpu_op"),
        "top": [{"name": n[:120], "count": c, "ms": ms}
                for n, (c, ms) in sorted(by_name.items(),
                                         key=lambda kv: -kv[1][1])[:TOP]],
    }


def traced(fn, dev) -> dict:
    """One call of ``fn`` under the profiler, synchronised on the card ->
    :func:`summarize`'s figures. On the card a trace that holds no kernel
    record at all is taken once more (``fn`` called again): the profiler
    (torch 2.11 on an H100) delivers fewer kernel records than launches in
    some traces, and a short trace can lose all of them."""
    on_device = dev.type == "cuda"
    for _ in range(2 if on_device else 1):
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp, device=dev) as t:
                t0 = time.perf_counter()
                fn()
                if on_device:
                    torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
            events = profiling.trace_events(t.path)
        if any(e.get("cat") == "kernel" for e in events):
            break
    return summarize(events, wall, on_device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ternary_spgemm_tpu_torch.tools.serve_trace")
    p.add_argument("--preset", default="bitnet7b",
                   choices=sorted(serving.PRESETS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--graph", action="store_true",
                   help="trace replays of the captured prefill and decode "
                        "step (models/graphs.py)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = serving.preset_config(args.preset)
    lm = serving.build_serving_lm(cfg, s=2, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    B, T0 = BATCH, PROMPT
    prompt = torch.randint(0, cfg.vocab, (B, T0), generator=gen, device=dev)
    result = {"device": device_name(dev), "preset": args.preset,
              "layers": cfg.n_layers, "batch": B, "prompt": T0,
              "graph": args.graph}
    if args.graph:
        # the prefill writes cache positions [0, T0), the step T0
        loop = captured(lm, B, T0, T0 + 2, cache_dtype=torch.int8,
                        prefill=True, temperature=0.0, top_k=0, top_p=1.0,
                        device=dev)
        start = lambda: loop.load(prompt)
        prefill = lambda: loop.call("prefill")
        decode_step = lambda: loop.call("step")
    else:
        # each prefill writes cache positions [0, T0), the decode step T0
        caches = init_cache(cfg, B, T0 + 1, torch.int8, device=dev)
        state = {}
        start = lambda: None

        def prefill():
            logits, state["caches"] = lm.prefill(prompt, caches)
            state["cur"] = torch.argmax(logits[:, -1], dim=-1)

        def decode_step():
            lm.decode_step(state["cur"], state["caches"], T0)

    with torch.no_grad():
        start()
        prefill()                          # the warm-up
        decode_step()
        start()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result["prefill"] = traced(prefill, dev)
        result["decode_step"] = traced(decode_step, dev)
    for call in ("prefill", "decode_step"):
        r = result[call]
        busy = ("no device" if r["device_busy_ms"] is None else
                f"device busy {r['device_busy_ms']:.3f} ms "
                f"({r['device_busy_share']:.1%})")
        print(f"{call}: wall {r['wall_ms']:.3f} ms, {busy}; kernels "
              f"{r['kernel_ms']:.3f} ms ({r['kernels']}), the port's "
              f"{r['ternary_ms']:.3f} ms; {r['host_ops']} host ops"
              f"{' (captured)' if args.graph else ''} [{result['device']}]",
              flush=True)
    emit(result, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
