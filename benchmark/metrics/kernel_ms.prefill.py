"""Device ms a prefill call in the port's own kernels (the ``ternary::``
namespace of ``csrc/``)."""


def read(run):
    calls = run.phase("prefill")
    if not calls:
        return None
    return 1e3 * sum(c["ternary_s"] for c in calls) / len(calls)
