"""Baseline expert-placement strategies from the paper's evaluation:

* Uniform     — Megatron-style expert parallelism: expert e on server e % N.
* Redundance  — uniform coverage + random duplication up to capacity.
* SmartMoE    — load-balancing placement module (workload-balanced, no
                replication), re-implemented after SmartMoE [ATC'23].
* EPLB        — DeepSeek-V3's Expert Parallelism Load Balancer: replicate
                high-load experts proportionally to load, then
                longest-processing-time bin packing onto servers;
                re-implemented for heterogeneous capacities as in the paper.

All return ``PlacementPlan`` so they are drop-in interchangeable with
``dancemoe_placement`` for the runtime, the simulator and the benchmarks.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.placement import PlacementPlan


def _layer_caps(capacity: np.ndarray, L: int,
                slots_cap: np.ndarray | None) -> np.ndarray:
    """Per-(server, layer) slot caps [N]: either the SPMD cap or an even
    split of the server budget across layers."""
    cap = np.asarray(capacity, int)
    if slots_cap is not None:
        return np.asarray(slots_cap, int)
    return np.maximum(cap // L, 1)


def uniform_plan(L: int, N: int, E: int, capacity=None,
                 slots_cap=None) -> PlacementPlan:
    assign = [[[e for e in range(E) if e % N == n] for n in range(N)]
              for _ in range(L)]
    counts = np.array([[len(assign[l][n]) for n in range(N)]
                       for l in range(L)])
    return PlacementPlan(assign=assign, counts=counts, num_experts=E)


def redundance_plan(L: int, N: int, E: int, capacity: np.ndarray,
                    slots_cap=None, seed: int = 0) -> PlacementPlan:
    """Uniform coverage, then random duplication until capacity is full."""
    rng = np.random.default_rng(seed)
    caps = _layer_caps(capacity, L, slots_cap)
    assign = []
    for l in range(L):
        layer = [[e for e in range(E) if e % N == n] for n in range(N)]
        for n in range(N):
            room = int(caps[n]) - len(layer[n])
            if room > 0:
                pool = [e for e in range(E) if e not in layer[n]]
                extra = rng.choice(pool, size=min(room, len(pool)),
                                   replace=False)
                layer[n] += [int(e) for e in extra]
        assign.append(layer)
    counts = np.array([[len(assign[l][n]) for n in range(N)]
                       for l in range(L)])
    return PlacementPlan(assign=assign, counts=counts, num_experts=E)


def smartmoe_plan(freqs: np.ndarray, capacity: np.ndarray,
                  slots_cap=None) -> PlacementPlan:
    """Workload-balanced placement: experts sorted by global load, each
    assigned (one copy) to the least-loaded feasible server."""
    L, N, E = freqs.shape
    caps = _layer_caps(capacity, L, slots_cap)
    assign = []
    for l in range(L):
        load_e = freqs[l].sum(0)                    # global per-expert load
        server_load = np.zeros(N)
        layer = [[] for _ in range(N)]
        for e in np.argsort(-load_e, kind="stable"):
            order = np.argsort(server_load, kind="stable")
            placed = False
            for n in order:
                if len(layer[n]) < caps[n]:
                    layer[n].append(int(e))
                    server_load[n] += load_e[e]
                    placed = True
                    break
            if not placed:
                raise RuntimeError("smartmoe: insufficient capacity")
        assign.append(layer)
    counts = np.array([[len(assign[l][n]) for n in range(N)]
                       for l in range(L)])
    return PlacementPlan(assign=assign, counts=counts, num_experts=E)


def eplb_plan(freqs: np.ndarray, capacity: np.ndarray,
              slots_cap=None) -> PlacementPlan:
    """EPLB: replicate high-load experts and balance via LPT packing.

    Replica counts: each expert gets >= 1; the spare slot budget is spread
    proportionally to global load. Instances (expert, load/replicas) are
    then packed longest-first onto the least-loaded server with room.
    """
    L, N, E = freqs.shape
    caps = _layer_caps(capacity, L, slots_cap)
    budget = int(caps.sum())                       # slots per layer
    assign = []
    for l in range(L):
        load_e = freqs[l].sum(0)
        load_e = load_e / max(load_e.sum(), 1e-12)
        spare = max(budget - E, 0)
        extra = np.floor(load_e * spare).astype(int)
        # distribute remaining spare greedily by fractional part
        rem = spare - extra.sum()
        if rem > 0:
            frac = load_e * spare - extra
            for e in np.argsort(-frac, kind="stable")[:rem]:
                extra[e] += 1
        replicas = 1 + extra
        inst_load = load_e / replicas
        instances = [(e, inst_load[e]) for e in range(E)
                     for _ in range(replicas[e])]
        instances.sort(key=lambda t: -t[1])        # LPT
        server_load = np.zeros(N)
        layer = [[] for _ in range(N)]
        for e, w in instances:
            order = np.argsort(server_load, kind="stable")
            for n in order:
                if len(layer[n]) < caps[n] and e not in layer[n]:
                    layer[n].append(int(e))
                    server_load[n] += w
                    break
        assign.append(layer)
    counts = np.array([[len(assign[l][n]) for n in range(N)]
                       for l in range(L)])
    return PlacementPlan(assign=assign, counts=counts, num_experts=E)
