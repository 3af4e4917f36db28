"""The port's kernels in the traced prefill calls against their bound: the
sum of each kernel call's bound (``bounds.py``) over the time its
kernels took on the device, in %."""


def read(run):
    calls = run.phase("prefill")
    took = sum(c["ternary_s"] for c in calls)
    if not took:
        return None
    return 100.0 * sum(c["bound_kernel_s"] for c in calls) / took
