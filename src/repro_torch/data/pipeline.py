"""Synthetic data pipeline: task-conditioned token streams for training and
serving experiments (no external datasets in this offline environment).

Each task draws tokens from its own Zipf-permuted unigram+bigram process, so
(i) models can actually learn structure (loss decreases), and (ii) different
tasks induce different routing distributions — the property the placement
algorithms exploit."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TaskTokenSource:
    name: str
    vocab_size: int
    seed: int = 0
    zipf: float = 1.1

    def __post_init__(self):
        rng = np.random.default_rng(abs(hash((self.name, self.seed)))
                                    % (2 ** 31))
        V = self.vocab_size
        base = 1.0 / (np.arange(V) + 1.0) ** self.zipf
        self.unigram = base[np.argsort(rng.permutation(V))]
        self.unigram /= self.unigram.sum()
        # sparse bigram preference: each token has a few likely successors
        self.succ = rng.integers(0, V, size=(V, 4))
        self.rng = rng

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        cur = self.rng.choice(self.vocab_size, size=batch, p=self.unigram)
        for t in range(seq_len):
            out[:, t] = cur
            use_bigram = self.rng.random(batch) < 0.7
            succ_pick = self.succ[cur, self.rng.integers(0, 4, batch)]
            fresh = self.rng.choice(self.vocab_size, size=batch,
                                    p=self.unigram)
            cur = np.where(use_bigram, succ_pick, fresh).astype(np.int32)
        return out


def train_batches(vocab_size: int, batch: int, seq_len: int, steps: int,
                  tasks: tuple[str, ...] = ("code", "math", "chat"),
                  seed: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens, targets) with examples drawn from a task mixture."""
    sources = [TaskTokenSource(t, vocab_size, seed) for t in tasks]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        parts = []
        split = np.sort(rng.integers(0, batch + 1, size=len(sources) - 1))
        sizes = np.diff(np.concatenate([[0], split, [batch]]))
        for src, m in zip(sources, sizes):
            if m > 0:
                parts.append(src.sample(int(m), seq_len + 1))
        full = np.concatenate(parts, axis=0)
        rng.shuffle(full)
        yield full[:, :-1], full[:, 1:]


def request_batches(task: str, vocab_size: int, batch: int, prompt_len: int,
                    n_batches: int, seed: int = 0
                    ) -> Iterator[np.ndarray]:
    """Serving-side prompt batches for one task (one edge server's
    traffic)."""
    src = TaskTokenSource(task, vocab_size, seed)
    for _ in range(n_batches):
        yield src.sample(batch, prompt_len)
