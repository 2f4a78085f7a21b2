"""Median wall time of the harness's span around the cluster's step, over
the window's ticks that launched a decode round (under chat traffic
nearly every such tick also carries a prefill chunk)."""

from pbench.stats import median


def read(run):
    xs = [t.t1 - t.t0 for t in run.window_ticks() if t.decode]
    return median(xs) * 1e3 if xs else None
