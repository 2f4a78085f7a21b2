"""Median busy device time of a decode round's step graph, from its first
phase mark to its end mark, over the rounds inside the traced window."""

from pbench.phases import call_device_ms


def read(run):
    return call_device_ms(run, "decode")
