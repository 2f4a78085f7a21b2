"""Total wall time of the window's ticks in which a placement was applied
to the engine (the cluster's applied migrations grew)."""


def read(run):
    spans = [t.t1 - t.t0 for t in run.window_ticks() if t.migrated]
    return sum(spans) * 1e3 if spans else None
