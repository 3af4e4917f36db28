"""Device ms a prefill call in everything but the port's own kernels (the
``ternary::`` namespace): norms, rotary, requantize, attention, cache
writes, head, sampler, copies."""


def read(run):
    calls = run.phase("prefill")
    if not calls:
        return None
    return 1e3 * sum(c["glue_s"] for c in calls) / len(calls)
