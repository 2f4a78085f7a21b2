"""Percentiles over all requests, and the spread of a set of runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear interpolation
    between closest ranks (numpy's default rule). Values may be ``inf`` (a
    request that never got what is timed): a percentile that falls on or
    next to one is ``inf``. Empty input gives ``nan``."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    if frac == 0.0:
        return xs[lo]
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def median(values) -> float:
    return percentile(values, 50.0)


def spread(values) -> float:
    """Distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
