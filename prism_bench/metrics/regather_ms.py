"""Summed duration of the program's ``MIGRATE`` spans in the window's
ticks: the table copy and the re-gather of a landed placement, not the
whole tick (``migration_tick_ms``)."""

from pbench.phases import regather_ms


def read(run):
    return regather_ms(run)
