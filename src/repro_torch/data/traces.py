"""Workload traces: task-conditioned expert-activation patterns and Poisson
request arrivals.

Models the paper's Sec. II-A observations: activation distributions are
(i) heavily skewed *per task* (Fig. 2 — arithmetic vs ASCII-recognition
activate different dominant experts) and (ii) layer-dependent within a task
(Fig. 3 — layer 0 skewed, layer 1 near-uniform). We realize this as
Zipf-shaped distributions whose permutation is task-seeded and whose
exponent varies per (task, layer).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# named after the paper's BIG-bench server specialisations + MultiData setup
BIGBENCH_TASKS = ("abstract_narrative", "arithmetic", "ascii_recognition")
MULTIDATA_TASKS = ("mmlu_pro", "wikitext", "tako")


@dataclasses.dataclass(frozen=True)
class TaskProfile:
    """Per-task activation distributions p[l, e]."""
    name: str
    probs: np.ndarray  # [L, E]


def make_task_profile(name: str, num_layers: int, num_experts: int,
                      seed: int, skew_lo: float = 0.3,
                      skew_hi: float = 1.6) -> TaskProfile:
    rng = np.random.default_rng(abs(hash((name, seed))) % (2 ** 31))
    probs = np.zeros((num_layers, num_experts))
    for l in range(num_layers):
        # layer-dependent skew (Fig. 3): alternate strongly/weakly skewed
        a = skew_lo + (skew_hi - skew_lo) * rng.random()
        z = 1.0 / (np.arange(num_experts) + 1.0) ** a
        perm = rng.permutation(num_experts)
        probs[l] = z[np.argsort(perm)] / z.sum()
    return TaskProfile(name=name, probs=probs)


@dataclasses.dataclass(frozen=True)
class Request:
    arrival: float
    server: int
    task: str
    prompt_tokens: int
    decode_tokens: int


@dataclasses.dataclass
class Workload:
    requests: list[Request]
    tasks: dict[str, TaskProfile]
    duration: float

    def freqs_by_server(self, num_servers: int) -> np.ndarray:
        """Expected f_n^l(e) [L, N, E] implied by the request mix (ground
        truth the scheduler tries to estimate)."""
        any_task = next(iter(self.tasks.values()))
        L, E = any_task.probs.shape
        out = np.zeros((L, num_servers, E))
        for r in self.requests:
            w = r.prompt_tokens + r.decode_tokens
            out[:, r.server, :] += w * self.tasks[r.task].probs
        s = out.sum(-1, keepdims=True)
        return np.where(s > 0, out / np.maximum(s, 1e-12), 1.0 / E)


def poisson_workload(task_per_server: list[str], *, num_layers: int,
                     num_experts: int, mean_interarrival: float = 10.0,
                     duration: float = 1800.0, prompt_tokens: int = 128,
                     decode_tokens: int = 20, seed: int = 0,
                     task_mix: dict[int, dict[str, float]] | None = None
                     ) -> Workload:
    """Poisson arrivals per server; each server draws tasks from its own mix
    (default: the single task assigned to it — the paper's specialised
    setup; pass `task_mix` for heterogeneous mixes)."""
    rng = np.random.default_rng(seed)
    names = sorted(set(task_per_server) |
                   (set().union(*[set(m) for m in task_mix.values()])
                    if task_mix else set()))
    tasks = {t: make_task_profile(t, num_layers, num_experts, seed)
             for t in names}
    reqs: list[Request] = []
    for server, task in enumerate(task_per_server):
        t = 0.0
        while True:
            t += rng.exponential(mean_interarrival)
            if t >= duration:
                break
            if task_mix and server in task_mix:
                mix = task_mix[server]
                choice = rng.choice(list(mix), p=np.array(list(mix.values()))
                                    / sum(mix.values()))
            else:
                choice = task
            pt = max(8, int(rng.normal(prompt_tokens, prompt_tokens / 4)))
            reqs.append(Request(arrival=t, server=server, task=str(choice),
                                prompt_tokens=pt,
                                decode_tokens=decode_tokens))
    reqs.sort(key=lambda r: r.arrival)
    return Workload(requests=reqs, tasks=tasks, duration=duration)


def sample_expert_counts(rng, probs_l: np.ndarray, tokens: int,
                         top_k: int) -> np.ndarray:
    """Sample the number of token-assignments each expert receives in one
    layer for a batch of `tokens` tokens with top_k routing."""
    return rng.multinomial(tokens * top_k, probs_l)
