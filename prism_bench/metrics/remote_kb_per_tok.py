"""Bytes that would cross between the edge servers per token through the
model (``pbench.readers.remote_kb_per_tok``)."""

from pbench.readers import remote_kb_per_tok


def read(run):
    return remote_kb_per_tok(run)
