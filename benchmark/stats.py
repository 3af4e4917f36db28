"""Percentiles, as the end-to-end metrics take them."""

from __future__ import annotations

import statistics


def percentile(values, q: int):
    """The ``q``-th percentile of all ``values`` (linear between the two
    nearest ranks, as ``statistics.quantiles(method="inclusive")``); None
    for fewer than two."""
    values = list(values)
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
