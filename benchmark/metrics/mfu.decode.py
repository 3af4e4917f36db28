"""The whole decode call against the model's bound: the bound of the work
the request needs (``bounds.py``: every projection, attention over the
visible positions, the head, the cache) over the call's wall time, in %."""


def read(run):
    calls = run.phase("step")
    if not calls:
        return None
    span = sum(c["span_s"] for c in calls)
    return 100.0 * sum(c["bound_model_s"] for c in calls) / span
