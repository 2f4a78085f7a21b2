"""Median over the traced ticks of the program's ``STEP`` span less the
``DEVICE_WAIT`` spans inside it: host time per tick not spent waiting for
the device."""

from pbench.phases import host_tick_ms


def read(run):
    return host_tick_ms(run)
