"""Model FLOPs of every token the window processed over 989 TFLOP/s times
the window (``pbench.readers.step_mfu``)."""

from pbench.readers import step_mfu


def read(run):
    return step_mfu(run)
