"""Activation statistics: the scheduler-side view of f_n^l(e).

``ActivationStats`` accumulates per-(layer, server, expert) activation
counts — fed either by the serving runtime (``counts_per_rank`` emitted by the
MoE layer) or by the event-driven simulator — and exposes the normalized
frequencies and Shannon entropies that drive Algorithms 1 and 2.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def entropy(p: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    """Shannon entropy (bits) of distributions along `axis`."""
    p = np.asarray(p, np.float64)
    s = p.sum(axis=axis, keepdims=True)
    q = p / np.maximum(s, eps)
    h = -(q * np.log2(np.maximum(q, eps))).sum(axis=axis)
    return np.where(s.squeeze(axis) > eps, h, 0.0)


def lemma1_coverage_bound(h_bits: float, num_experts: int,
                          delta: float) -> float:
    """Lemma 1: k_delta > 2^{H(p) - delta * log2 E}."""
    return 2.0 ** (h_bits - delta * np.log2(max(num_experts, 2)))


def coverage_count(p: np.ndarray, delta: float) -> int:
    """Smallest k with top-k mass >= 1 - delta (used to check Lemma 1)."""
    q = np.sort(np.asarray(p, np.float64))[::-1]
    q = q / max(q.sum(), 1e-12)
    cum = np.cumsum(q)
    return int(np.searchsorted(cum, 1.0 - delta) + 1)


@dataclasses.dataclass
class ActivationStats:
    """EMA-tracked activation counts, shape [L, N, E]."""
    num_layers: int
    num_servers: int
    num_experts: int
    decay: float = 0.0            # 0 = plain accumulation; >0 = EMA

    def __post_init__(self):
        self.counts = np.zeros(
            (self.num_layers, self.num_servers, self.num_experts), np.float64)
        self.total_updates = 0

    def update(self, layer_counts: np.ndarray) -> None:
        """layer_counts: [L, N, E] new activation counts."""
        lc = np.asarray(layer_counts, np.float64)
        if self.decay > 0:
            self.counts = self.decay * self.counts + lc
        else:
            self.counts = self.counts + lc
        self.total_updates += 1

    def update_server(self, server: int, layer_counts: np.ndarray) -> None:
        """layer_counts: [L, E] counts for one server (no allocation)."""
        if self.decay > 0:
            self.counts *= self.decay
        self.counts[:, server, :] += layer_counts
        self.total_updates += 1

    def reset(self) -> None:
        self.counts[:] = 0.0
        self.total_updates = 0

    def freqs(self) -> np.ndarray:
        """Normalized f_n^l(e): [L, N, E], each (l, n) row sums to 1
        (uniform if no data observed)."""
        s = self.counts.sum(-1, keepdims=True)
        uniform = np.full_like(self.counts, 1.0 / self.num_experts)
        return np.where(s > 0, self.counts / np.maximum(s, 1e-12), uniform)

    def entropies(self) -> np.ndarray:
        """v_{n,l}: [L, N] Shannon entropy of each server/layer distribution.
        Unobserved (l, n) pairs get maximum entropy (log2 E) — the most
        conservative assumption for count allocation."""
        h = entropy(self.counts, axis=-1)
        unseen = self.counts.sum(-1) <= 0
        return np.where(unseen, np.log2(max(self.num_experts, 2)), h)
