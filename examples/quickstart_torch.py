"""Quickstart: the DanceMoE placement pipeline end-to-end in 60 seconds,
on the PyTorch port's numpy-only modules (the counterpart of
``examples/quickstart.py``; it needs neither torch nor a device).

1. Build a task-skewed workload for 3 heterogeneous edge servers.
2. Run Algorithm 1 (entropy-based layer-wise counts) + Algorithm 2
   (greedy assignment with coverage repair).
3. Compare the Eq.-2 communication proxy and simulated latency against the
   paper's four baselines.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""
import numpy as np

from repro_torch.core.baselines import (eplb_plan, redundance_plan,
                                        smartmoe_plan, uniform_plan)
from repro_torch.core.placement import dancemoe_placement, remote_cost
from repro_torch.data.traces import BIGBENCH_TASKS, poisson_workload
from repro_torch.serving.cluster import DEEPSEEK_V2_LITE_PROFILE, paper_testbed
from repro_torch.serving.simulator import EdgeSimulator


def main():
    pf = DEEPSEEK_V2_LITE_PROFILE
    cluster = paper_testbed(mem_fraction=0.3)   # the paper's 30% constraint
    workload = poisson_workload(
        list(BIGBENCH_TASKS), num_layers=pf.num_layers,
        num_experts=pf.num_experts, mean_interarrival=10.0, duration=900.0)

    capacity = cluster.expert_capacity(pf.expert_bytes)
    slots = np.minimum(np.maximum(capacity // pf.num_layers, 1),
                       pf.num_experts)
    freqs = workload.freqs_by_server(cluster.n)   # f_n^l(e)

    print(f"cluster: {cluster.n} servers, capacity={capacity} expert slots")
    print(f"model: {pf.num_experts} experts x {pf.num_layers} layers, "
          f"top-{pf.top_k}\n")

    plans = {
        "Uniform (Megatron EP)": uniform_plan(pf.num_layers, cluster.n,
                                              pf.num_experts),
        "Redundance": redundance_plan(pf.num_layers, cluster.n,
                                      pf.num_experts, capacity, slots),
        "SmartMoE": smartmoe_plan(freqs, capacity, slots),
        "EPLB (DeepSeek-V3)": eplb_plan(freqs, capacity, slots),
        "DanceMoE (ours)": dancemoe_placement(freqs, capacity, slots),
    }
    print(f"{'method':22s} {'Eq.2 proxy':>11s} {'sim latency':>12s} "
          f"{'local %':>8s}")
    for name, plan in plans.items():
        r = EdgeSimulator(cluster, pf, workload, plan=plan, seed=1).run()
        local = np.mean([x[1] for x in r.local_ratio_t]) * 100
        print(f"{name:22s} {remote_cost(plan, freqs):11.2f} "
              f"{r.avg_latency:11.3f}s {local:7.1f}%")


if __name__ == "__main__":
    main()
