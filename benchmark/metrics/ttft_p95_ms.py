"""The 95th percentile over all requests in the window of the time from
the batch's issue to the request's first token on the host, in ms."""

from benchmark.stats import percentile


def read(run):
    p = percentile(run.ttfts_s, 95)
    return None if p is None else 1e3 * p
