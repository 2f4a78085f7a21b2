"""Share of the window's routed (token, expert) rows whose expert has a slot
on the token's origin server (``pbench.readers.local_ratio``)."""

from pbench.readers import local_ratio


def read(run):
    return local_ratio(run)
