"""Prompt tokens per task.

Each task draws its tokens from a Zipf unigram over its own permutation of
the vocabulary, and after each token prefers one of a few fixed successors
(with probability ``bigram``). Different tasks therefore use different
tokens, which is what gives expert routing its input locality even with
random weights. The arithmetic follows the program's ``TaskTokenSource``;
the seed is stable across processes (a hash of the task name and the seed,
not Python's salted ``hash``) and ``sample`` draws a whole prompt in a
handful of vector operations.
"""

from __future__ import annotations

import hashlib

import numpy as np


def stable_seed(*parts) -> int:
    """A 64-bit seed from ``parts``, equal in every process."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


class TaskTokens:
    """The token distribution of one task over a ``vocab``-token vocabulary."""

    def __init__(self, name: str, vocab: int, seed: int, zipf: float = 1.1,
                 successors: int = 4, bigram: float = 0.7):
        rng = np.random.default_rng(stable_seed("task", name, seed))
        base = 1.0 / (np.arange(vocab) + 1.0) ** zipf
        unigram = base[np.argsort(rng.permutation(vocab))]
        self.cdf = np.cumsum(unigram / unigram.sum())
        self.succ = rng.integers(0, vocab, size=(vocab, successors))
        self.vocab = vocab
        self.bigram = bigram

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` tokens: a fresh unigram draw wherever the chain does not
        take a successor, else a successor of the previous token."""
        if n <= 0:
            return np.zeros(0, np.int32)
        fresh = np.minimum(np.searchsorted(self.cdf, rng.random(n),
                                           side="right"), self.vocab - 1)
        take = rng.random(n) < self.bigram
        take[0] = False
        pick = rng.integers(0, self.succ.shape[1], n)
        idx = np.arange(n)
        # depth of each position inside its run of successor steps
        depth = idx - np.maximum.accumulate(np.where(take, 0, idx))
        out = fresh.astype(np.int64)
        for d in range(1, int(depth.max()) + 1):
            at = np.nonzero(depth == d)[0]
            out[at] = self.succ[out[at - 1], pick[at]]
        return out.astype(np.int32)
