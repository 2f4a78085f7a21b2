"""Share of the traced window's busy device time spent in the paged MLA
kernels and their combine (``pbench.mla``)."""

from pbench.mla import share


def read(run):
    return share(run)
