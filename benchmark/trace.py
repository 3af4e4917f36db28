"""The reduction of a ``torch.profiler`` trace of a slice of the window to
per-call figures.

``busy_union`` and the ``ternary::`` split compute what
``ternary_spgemm_tpu_torch/tools/serve_trace.py``'s ``busy_union`` and
``summarize`` do: the device's busy time is the union of the intervals in
which a kernel, a memset or a copy ran, and the port's own kernels are
those in the ``ternary::`` namespace of its ``csrc/``; everything else on
the device is glue.

The harness marks each call with a span of its own (``record_function``):
``load`` (a batch's prompts in, the caches emptied), ``prefill``,
``step`` and ``readback`` (the tokens to the host, which waits for them).
A call's segment runs from its first span (a prefill's ``load``) to the
next call's; since every call ends in a readback, all of a call's device
work falls inside its segment.
"""

from __future__ import annotations

import collections

#: chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
#: names of the port's own kernels contain this
PORT_NAMESPACE = "ternary::"
#: the harness's spans
SPANS = ("load", "prefill", "step", "readback")
TOP = 10


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_union(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in merged(intervals))


def spans(events):
    """The harness's spans, in order: ``(name, start, end)`` in µs."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in SPANS), key=lambda s: s[1])


def segments(events):
    """Each call's ``(kind, start, end)`` (µs): kind ``prefill`` or
    ``step``."""
    out = []
    opened = None
    for name, a, b in spans(events):
        if name == "load":
            opened = a
        elif name in ("prefill", "step"):
            out.append([name, a if opened is None else opened, b])
            opened = None
        elif out:
            out[-1][2] = max(out[-1][2], b)
    for i in range(len(out) - 1):
        out[i][2] = out[i + 1][1]
    return [tuple(s) for s in out]


def device_events(events):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS]


def calls(events) -> list:
    """Per traced call: kind, wall ``span_s`` of its segment, ``busy_s``
    (the union of device intervals within it), ``ternary_s`` (the port's
    kernels' summed time) and ``glue_s`` (all other device time)."""
    dev = sorted(device_events(events), key=lambda e: e["ts"])
    out = []
    i = 0
    for kind, a, b in segments(events):
        while i < len(dev) and dev[i]["ts"] < a:
            i += 1
        mine = []
        while i < len(dev) and dev[i]["ts"] < b:
            mine.append(dev[i])
            i += 1
        ternary = sum(e["dur"] for e in mine if e["cat"] == "kernel"
                      and PORT_NAMESPACE in e["name"])
        busy = busy_union((e["ts"], min(e["ts"] + e["dur"], b))
                          for e in mine)
        out.append({"kind": kind, "span_s": (b - a) / 1e6,
                    "busy_s": busy / 1e6, "ternary_s": ternary / 1e6,
                    "glue_s": (sum(e["dur"] for e in mine) - ternary) / 1e6})
    return out


def window(events):
    """``(start, end)`` µs of the traced calls."""
    seg = segments(events)
    return (seg[0][1], seg[-1][2]) if seg else None


def device(events) -> dict:
    """``busy_s`` and ``window_s`` of the traced calls."""
    w = window(events)
    if w is None:
        return {}
    a, b = w
    busy = busy_union((max(e["ts"], a), min(e["ts"] + e["dur"], b))
                      for e in device_events(events)
                      if e["ts"] + e["dur"] > a and e["ts"] < b)
    return {"busy_s": busy / 1e6, "window_s": (b - a) / 1e6}


def breakdown(events) -> dict:
    """The device operations that took most time, ``[name, seconds]``, and
    the idle time between device operations by the span the host was in
    when the device went idle, ``[span, seconds]`` summed; at most
    :data:`TOP` each."""
    w = window(events)
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    a, b = w
    dev = [e for e in device_events(events) if a <= e["ts"] < b]
    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"][:160]] += e["dur"] / 1e6
    busy = merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
    edges = [a] + [x for iv in busy for x in iv] + [b]
    host = spans(events)
    idle = collections.Counter()
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        inside = [s for s in host if s[1] <= lo < s[2]]
        label = max(inside, key=lambda s: s[1])[0] if inside else "between"
        idle[label] += (hi - lo) / 1e6
    return {"device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}
