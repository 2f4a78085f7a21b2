"""Share of the marked calls' busy device time in the traced window that
lies in attention phases (each attention block, its paged gather
included)."""

from pbench.phases import phase_share


def read(run):
    return phase_share(run, "attention")
