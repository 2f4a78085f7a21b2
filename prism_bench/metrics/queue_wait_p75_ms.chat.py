"""Time from a request being due to its admission (its ADMITTED event, seen
after the tick), the 75th percentile over the requests due in the window;
one never admitted counts as infinitely late."""

import math

from pbench.stats import percentile


def read(run):
    due = run.due_in_window()
    if not due:
        return None
    lat = [r.admit_t - r.due_abs if r.admit_t is not None else math.inf
           for r in due]
    return percentile(lat, 75.0) * 1e3
