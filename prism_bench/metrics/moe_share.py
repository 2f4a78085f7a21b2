"""Share of the marked calls' busy device time in the traced window that
lies in MoE phases (router, dispatch, ``moe_gmm``, combine)."""

from pbench.phases import phase_share


def read(run):
    return phase_share(run, "moe")
