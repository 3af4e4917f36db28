"""The share of the traced decode calls' wall time in which nothing ran on
the device, in %."""


def read(run):
    calls = run.phase("step")
    if not calls:
        return None
    span = sum(c["span_s"] for c in calls)
    return 100.0 * (1.0 - sum(c["busy_s"] for c in calls) / span)
