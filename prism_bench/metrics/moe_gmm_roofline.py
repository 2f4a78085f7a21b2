"""Least time the chip could take for the traced ticks' expert work
(``pbench.model.gmm_least_seconds`` of the rows the routing sent) over the
device time of ``moe_gmm``'s kernels in the trace."""

from pbench.readers import gmm_roofline


def read(run):
    return gmm_roofline(run)
