"""Gap between consecutive visible tokens of a request, the 95th percentile
over every gap that closes in the window."""

from pbench.stats import percentile


def read(run):
    gaps = [b - a for r in run.recs for a, b in zip(r.token_t, r.token_t[1:])
            if run.in_window(b)]
    return percentile(gaps, 95.0) * 1e3 if gaps else None
