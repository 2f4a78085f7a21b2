"""Share of the traced window in which no kernel, memcpy or memset ran on
the device."""


def read(run):
    tr = run.trace
    if tr is None or tr["t1"] <= tr["t0"]:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / (tr["t1"] - tr["t0"]))
