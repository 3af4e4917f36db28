"""One run of one cell: the program built from the seed, its captured
generate loop driven for the window, the trace of a slice of it, the
check against the reference, and the result.

Everything that belongs to a cell is found by name from
``BENCHMARK.json``: the configuration's file (``configs/``), whose
``program`` key names the module of this folder that builds the model and
counts its work; the traffic mix (``traffic/<name>.json``); the limits of
the comparison (``limits/<cell>.json``); a reader for each metric
(``metrics/<metric>.py``, a function ``read(run)`` that returns the value,
or None where the run has nothing to read).

The window is a closed loop of ``batch`` clients: a batch of requests is
issued, and the next when it has finished. A request is the prompt's
load, one prefill replay, then decode replays; after every replay the
step's tokens are read back to the host, as a streaming server reads them,
and the host clock stamps each token there. The window closes at the
first token read at or after ``--seconds``; the rates count what the host
received up to then, over the window's length, and the tails take every
request and every gap between a request's tokens in it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import random
import statistics
import sys
import tempfile
import time

import torch

from benchmark import compare, inputs, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FOLDER = os.path.basename(HERE)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Cell:
    """A workload of ``BENCHMARK.json`` under ``root`` and the files it
    names."""

    def __init__(self, workload: str, root: str = ROOT):
        bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise ValueError(f"no workload {workload!r} in BENCHMARK.json; "
                             f"there are {sorted(cells)}")
        w = cells[workload]
        entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        here = os.path.join(root, FOLDER)
        self.name, self.root, self.chips = workload, root, w["chips"]
        self.config = _json(os.path.join(root, entry["file"]))
        self.traffic = _json(os.path.join(here, "traffic",
                                          w["traffic"] + ".json"))
        self.traffic.setdefault("max_t", self.traffic["prompt_len"]
                                + self.traffic["new_tokens"])
        self.limits = _json(os.path.join(here, "limits",
                                         workload + ".json"))["limits"]
        self.model = inputs.sizes(self.config)
        self.program = importlib.import_module(
            f"{FOLDER}.{self.config['program']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, workload)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, workload)]

    def reader(self, metric: str):
        path = os.path.join(self.root, FOLDER, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            f"_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    @property
    def sampler(self) -> tuple:
        """The traffic's ``(temperature, top_k, top_p)``."""
        t = self.traffic
        return (float(t["temperature"]), int(t["top_k"]), float(t["top_p"]))


class Profiler:
    """``torch.profiler`` over the slice of calls the traffic's ``trace``
    plan names (its ``batch``, from its ``call``, for ``calls`` calls;
    call 0 is the prefill, traced from the batch's load), with the
    harness's spans; off when there is no plan."""

    def __init__(self, plan, dev: torch.device):
        self.plan, self.dev = plan, dev
        self.prof, self.active, self.left = None, False, 0
        self.calls = []

    def before(self, b: int, c: int) -> None:
        p = self.plan
        if p and self.prof is None and (b, c) == (p["batch"], p["call"]):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            _sync(self.dev)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.active, self.left = True, p["calls"]

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def after(self, kind: str, seen: int) -> None:
        if not self.active:
            return
        self.calls.append((kind, seen))
        self.left -= 1
        if self.left == 0:
            self.stop()

    def stop(self) -> None:
        if self.active:
            _sync(self.dev)
            self.prof.__exit__(None, None, None)
            self.active = False

    def events(self):
        if self.prof is None:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            return _json(path)["traceEvents"]


class Run:
    """What the metrics' readers read: the window's host-clock record and,
    in a traced run, its traced calls."""

    def __init__(self, setup_s: float, batches: list, start: float,
                 close: float, batch: int, prompt_len: int):
        self.setup_s = setup_s
        self.window_s = close - start
        self.tokens = self.prompt_tokens = 0
        self.gaps_s, self.ttfts_s = [], []
        self.attempted = self.failed = 0
        for rec in batches:
            if rec["issue"] > close:
                continue
            self.attempted += batch
            self.failed += rec["failed"]
            times = [t for t in rec["times"] if t <= close]
            self.tokens += batch * len(times)
            if times:
                self.prompt_tokens += batch * prompt_len
                self.ttfts_s += [times[0] - rec["issue"]] * batch
            for a, b in zip(times, times[1:]):
                self.gaps_s += [b - a] * batch
        #: per traced call: kind, span_s, busy_s, ternary_s, glue_s,
        #: bound_model_s, bound_kernel_s
        self.calls = []

    def phase(self, kind: str) -> list:
        return [c for c in self.calls if c["kind"] == kind]


def drive(cell: Cell, loop, seed: int, seconds: float, dev, noise,
          prof: Profiler):
    """The window (module docstring). Returns ``(batches, start, close,
    checked)``: each batch's issue time, token times and requests served a
    token outside the vocabulary (failed), and the checked
    batches, a reservoir of ``check_batches`` of the finished ones drawn
    from the seed, each ``(batch, prompts, served tokens, kept logits)``.
    Where fewer have finished when the window closes, batches run on past
    it, untimed, until that many have. Sampled traffic draws each call's
    noise from a generator of its own (``inputs.Noise.seek``)."""
    model, traffic = cell.model, cell.traffic
    n, k = traffic["new_tokens"], traffic["check_batches"]
    V = model["vocab"]
    rng = random.Random(inputs.sub_seed(seed, "check"))
    batches, checked = [], []
    finished = 0
    _sync(dev)
    start = time.perf_counter()
    deadline, close = start + seconds, None
    b = 0
    while close is None or finished < k:
        prompt = inputs.prompts(model, traffic, seed, b, dev)
        prof.before(b, 0)
        with prof.span("load"):
            issue = time.perf_counter()
            loop.load(prompt)
        times, toks, bad = [], [], set()
        for c in range(n):
            if c:
                prof.before(b, c)
            kind = "prefill" if c == 0 else "step"
            if noise is not None:
                noise.seek(b, c)
            with prof.span(kind):
                loop.call(kind, noise)
            with prof.span("readback"):
                toks.append(loop.cur.tolist())
            times.append(time.perf_counter())
            bad.update(r for r, t in enumerate(toks[-1]) if not 0 <= t < V)
            prof.after(kind, traffic["prompt_len"] + c)
            if close is None and times[-1] >= deadline:
                close = times[-1]
            if close is not None and finished >= k:
                break
        batches.append({"issue": issue, "times": times, "failed": len(bad)})
        if len(times) == n:
            finished += 1
            slot = len(checked) if len(checked) < k else rng.randrange(
                finished)
            if slot < k:
                entry = (b, prompt.cpu(),
                         torch.tensor(toks).t().contiguous(),
                         loop.kept.clone())
                if slot == len(checked):
                    checked.append(entry)
                else:
                    checked[slot] = entry
        b += 1
    prof.stop()
    return batches, start, close, checked


def check(cell: Cell, seed: int, checked: list, dev, noise,
          lower=()) -> dict:
    """The numbers compared (``compare.py``) for the checked batches,
    against the reference run over their prompts and served tokens; for
    each of ``lower`` (``reference.LOWER``, the controls alone) also
    ``control.<name>``: that variant of the reference in the program's
    place, its own tokens chosen from the same draws."""
    T0, B = cell.traffic["prompt_len"], cell.traffic["batch"]
    V, n = cell.model["vocab"], cell.traffic["new_tokens"]
    served = torch.cat([s for _, _, s, _ in checked])
    if bool(torch.any((served < 0) | (served >= V))):
        return {"logit_gap": float("inf")}
    tokens = torch.cat([torch.cat([p, s[:, :-1]], dim=1)
                        for _, p, s, _ in checked])
    program = torch.cat([lg for _, _, _, lg in checked])
    u = (None if noise is None else
         torch.cat([noise.draws(b, n, B, V, dev) for b, _, _, _ in checked]))
    ref = cell.program.reference_logits(cell.model, seed, tokens, T0 - 1,
                                        dev)
    sampler = cell.sampler
    out = {"logit_gap": compare.logit_gap(program, ref, served, sampler, u)}
    del program
    for name in lower:
        low = cell.program.reference_logits(cell.model, seed, tokens,
                                            T0 - 1, dev, lower=name)
        picked = torch.stack([
            compare.choose(low[r], sampler, None if u is None else u[r])
            for r in range(low.shape[0])])
        out["control." + name] = compare.logit_gap(low, ref, picked,
                                                   sampler, u)
        del low
    return out


def warm_up(cell: Cell, loop, seed: int, dev, noise) -> None:
    """One prefill and two steps of every body the window replays, and the
    host's readback, on a prompt no request uses."""
    loop.load(inputs.prompts(cell.model, cell.traffic, seed, -1, dev))
    for c, kind in enumerate(("prefill", "step", "step")):
        if noise is not None:
            noise.seek(-1, c)
        loop.call(kind, noise)
        loop.cur.tolist()
    loop.kept.clone()
    _sync(dev)


#: the program's own lower-precision paths, for the controls alone: its
#: bf16 head (which also holds the embedding in bf16), and its f32
#: matrix products in TF32, switched on before the capture
CONTROLS = ("bf16_head", "tf32")


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control=None, lower=()) -> dict:
    """One run (module docstring) -> the result's fields. ``control``, one
    of :data:`CONTROLS`, and ``lower`` (``check``) for the controls
    alone."""
    if control not in (None, *CONTROLS):
        raise ValueError(f"no control {control!r}; there are {CONTROLS}")
    dev = torch.device(device)
    traffic, prog = cell.traffic, cell.program
    B, T0 = traffic["batch"], traffic["prompt_len"]
    with torch.no_grad():
        lm = prog.build_lm(cell.model, seed, dev, head_dtype=(
            torch.bfloat16 if control == "bf16_head" else None))
        torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
        loop = prog.generate_loop(lm, traffic, dev)
        noise = (inputs.Noise(seed, traffic["greedy_rows"], dev)
                 if traffic["temperature"] > 0.0 else None)
        warm_up(cell, loop, seed, dev, noise)
        setup_s = time.perf_counter() - t_start
        prof = Profiler(traffic["trace"] if traced else None, dev)
        batches, start, close, checked = drive(cell, loop, seed, seconds,
                                               dev, noise, prof)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del loop, lm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    record = Run(setup_s, batches, start, close, B, T0)
    print("batches, first token / median gap ms: " + ", ".join(
        f"{1e3 * (r['times'][0] - r['issue']):.2f}/"
        f"{1e3 * statistics.median(
            b - a for a, b in zip(r['times'], r['times'][1:])):.3f}"
        for r in batches if len(r["times"]) > 1), file=sys.stderr)
    out = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    if traced:
        events = prof.events()
        if events is not None:
            calls = trace.calls(events)
            if [c["kind"] for c in calls] == [k for k, _ in prof.calls]:
                for c, (kind, seen) in zip(calls, prof.calls):
                    rows = B * T0 if kind == "prefill" else B
                    work = (prog.prefill_work(cell.model, B, T0)
                            if kind == "prefill"
                            else prog.decode_work(cell.model, B, seen))
                    c["bound_model_s"] = work.seconds()
                    c["bound_kernel_s"] = prog.kernel_seconds(cell.model,
                                                              rows)
                record.calls = calls
                device_info.update(trace.device(events))
                out["breakdown"] = trace.breakdown(events)
            else:
                print(f"trace: {len(calls)} segments for "
                      f"{len(prof.calls)} traced calls; no per-layer "
                      "metric read", file=sys.stderr)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = cell.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    with torch.no_grad():
        numbers = check(cell, seed, checked, dev, noise, lower)
    print(f"seconds: set-up {setup_s:.2f}, window {record.window_s:.2f}, "
          f"check {time.perf_counter() - t_check:.2f}", file=sys.stderr)
    correct, checks = compare.judge(numbers, cell.limits)
    if lower:
        out["controls"] = {k: v for k, v in numbers.items()
                           if k.startswith("control.")}
    # the numbers compared come last
    return {"correct": correct and record.failed == 0,
            "attempted": record.attempted, "failed": record.failed,
            "metrics": metrics, "device": device_info, **out,
            "checks": checks}
