"""Time to first token: from a request being due to its first token being
visible, the 75th percentile over every request due in the window; one
that never got a first token counts as infinitely late."""

import math

from pbench.stats import percentile


def read(run):
    due = run.due_in_window()
    if not due:
        return None
    lat = [r.token_t[0] - r.due_abs if r.token_t else math.inf for r in due]
    return percentile(lat, 75.0) * 1e3
