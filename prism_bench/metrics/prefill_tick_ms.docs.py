"""Median wall time of the window's ticks that issued a prefill chunk."""

from pbench.stats import median


def read(run):
    xs = [t.t1 - t.t0 for t in run.window_ticks() if t.prefill]
    return median(xs) * 1e3 if xs else None
