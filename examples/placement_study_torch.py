"""Ablation study: which parts of DanceMoE's placement matter? (The
counterpart of ``examples/placement_study.py`` on the PyTorch port's
numpy-only modules; it needs neither torch nor a device.)

Compares, on the same skewed workload:
  - full DanceMoE (entropy counts + greedy assignment + spare-slot fill),
  - flat counts (skip Algorithm 1: equal slots per layer),
  - no spare-fill (coverage only, no extra replication),
  - no activation awareness (random assignment within the same counts).

Run:  PYTHONPATH=src python examples/placement_study_torch.py
"""
import numpy as np

from repro_torch.core.placement import (PlacementPlan,
                                        allocate_expert_counts,
                                        assign_experts_layer, remote_cost)
from repro_torch.core.policies import ClusterView, get_policy
from repro_torch.core.stats import entropy
from repro_torch.data.traces import BIGBENCH_TASKS, poisson_workload
from repro_torch.serving.cluster import (DEEPSEEK_V2_LITE_PROFILE,
                                         EdgeCluster, paper_testbed,
                                         requests_from_workload)


def flat_counts_plan(freqs, capacity, slots):
    L, N, E = freqs.shape
    counts = np.minimum(np.broadcast_to(capacity // L, (L, N)).copy(),
                        np.minimum(slots, E))
    # raise per-layer totals to E where needed
    assign = [assign_experts_layer(counts[l], freqs[l]) for l in range(L)]
    return PlacementPlan(assign=assign, counts=counts, num_experts=E)


def random_assignment_plan(freqs, capacity, slots, seed=0):
    rng = np.random.default_rng(seed)
    L, N, E = freqs.shape
    v = entropy(freqs, axis=-1)
    counts = allocate_expert_counts(np.full(L, E), capacity, v,
                                    max_per_layer=slots)
    assign = []
    for l in range(L):
        layer = []
        remaining = list(range(E))
        rng.shuffle(remaining)
        for n in range(N):
            take = [remaining.pop() for _ in range(min(counts[l, n],
                                                       len(remaining)))]
            while len(take) < counts[l, n]:
                take.append(int(rng.integers(0, E)))
            layer.append(sorted(set(take)) or [0])
        placed = set(e for a in layer for e in a)
        for e in range(E):
            if e not in placed:
                layer[int(np.argmax(counts[l]))].append(e)
        assign.append(layer)
    return PlacementPlan(assign=assign, counts=counts, num_experts=E)


def main():
    pf = DEEPSEEK_V2_LITE_PROFILE
    cl = paper_testbed(0.3)
    wl = poisson_workload(list(BIGBENCH_TASKS), num_layers=pf.num_layers,
                          num_experts=pf.num_experts,
                          mean_interarrival=10.0, duration=900.0)
    cap = cl.expert_capacity(pf.expert_bytes)
    slots = np.minimum(np.maximum(cap // pf.num_layers, 1), pf.num_experts)
    freqs = wl.freqs_by_server(cl.n)
    cluster = ClusterView(capacity=cap, slots_cap=slots)
    variants = {
        "DanceMoE (full)": get_policy("dancemoe").propose(freqs, cluster),
        "w/o Alg.1 (flat counts)": flat_counts_plan(freqs, cap, slots),
        "w/o spare-fill": get_policy(
            "dancemoe", fill_spare=False).propose(freqs, cluster),
        "w/o activation awareness": random_assignment_plan(freqs, cap,
                                                           slots),
    }
    # every variant rides the serving API v1 sim backend: one typed
    # request stream, one EdgeCluster per candidate placement
    reqs = requests_from_workload(wl)
    print(f"{'variant':26s} {'Eq.2 proxy':>11s} {'sim latency':>12s}")
    for name, plan in variants.items():
        ec = EdgeCluster("sim", spec=cl, profile=pf, plan=plan,
                         tasks=wl.tasks, seed=1)
        for r in reqs:
            ec.submit(r)
        handles = ec.run()
        lat = float(np.mean([h.metrics["latency"] for h in handles]))
        print(f"{name:26s} {remote_cost(plan, freqs):11.2f} "
              f"{lat:11.3f}s")


if __name__ == "__main__":
    main()
