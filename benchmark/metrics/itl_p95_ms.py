"""The 95th percentile of the gaps between consecutive tokens of a request,
over all gaps of all requests in the window, in ms."""

from benchmark.stats import percentile


def read(run):
    p = percentile(run.gaps_s, 95)
    return None if p is None else 1e3 * p
