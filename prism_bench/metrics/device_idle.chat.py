"""Share of the traced decode ticks' wall time (ticks that launched a
decode round) in which no kernel, memcpy or memset ran on the device."""

from pbench.readers import idle_in_ticks


def read(run):
    return idle_in_ticks(run, lambda t: t.decode)
