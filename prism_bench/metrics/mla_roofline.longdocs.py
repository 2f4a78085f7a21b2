"""Least time of the paged MLA reads that the traced ticks launched,
counted from the harness's records (``pbench.mla``: 2 x heads x (576 +
512) FLOPs a (query, key) pair, each read latent row's 1,152 bytes once a
call, q and the output; the larger of FLOPs over 989 TFLOP/s and bytes
over 3.35 TB/s, per call and layer) over the device time of the
``paged_mla`` kernels and their combine in the traced window."""

from pbench.mla import roofline


def read(run):
    return roofline(run)
