"""The paper's headline scenario on the PyTorch port: THREE edge servers
cooperatively serve one MoE model through the ``EdgeCluster`` façade,
against BOTH execution backends, from the *same* typed ``Request`` stream
(the port's counterpart of ``examples/serve_edge.py``).

* ``backend="runtime"`` — one engine whose EP spec spans the 3 servers
  (three virtual EP ranks in one process, built by
  ``launch.serve.build_engine(n_ep=3)``), origin-tagged continuous
  batching, the shared ``PlacementController`` reviewing live gating
  statistics on the tick clock. On the CUDA device the MoE layers run the
  hand-written ``moe_gmm`` kernel. Outputs are token-identical to
  ``generate()``, and the per-origin gating statistics land in the
  ``[n_ep, E]`` attribution matrix (Algorithm 1's f_n(e)).
* ``backend="sim"`` — the event-driven time model of the paper's testbed
  (Sec. IV), seconds clock, same request objects, same handle/event/metric
  surface.

Run:  PYTHONPATH=src python examples/serve_edge_torch.py [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.baselines import uniform_plan
from repro_torch.core.policies import (ClusterView, PlacementController,
                                       get_policy)
from repro_torch.data.pipeline import TaskTokenSource
from repro_torch.data.traces import BIGBENCH_TASKS
from repro_torch.launch.serve import build_engine
from repro_torch.serving.api import EventType, Request
from repro_torch.serving.cluster import EdgeCluster, MoEProfile
from repro_torch.serving.net import CommCostModel, ServerProfile, Topology

N_SERVERS = 3
PROMPT, STEPS, N_REQUESTS = 16, 6, 6


def build_topology() -> Topology:
    """Non-uniform 3-server interconnect: two LAN-linked servers plus one
    behind a slow WAN-ish hop, and one memory-poor box."""
    profiles = (ServerProfile("edge0", mem_bytes=8e9),
                ServerProfile("edge1", mem_bytes=8e9),
                ServerProfile("edge2", mem_bytes=2e9))   # memory-poor
    bw = np.full((3, 3), 500e6 / 8)
    lat = np.full((3, 3), 2e-3)
    bw[0, 2] = bw[2, 0] = bw[1, 2] = bw[2, 1] = 25e6 / 8   # WAN-ish link
    lat[0, 2] = lat[2, 0] = lat[1, 2] = lat[2, 1] = 40e-3
    np.fill_diagonal(lat, 0.0)
    return Topology(profiles, bw, lat)


def build_requests(cfg) -> list:
    """One typed stream, consumed by both backends: token prompts for the
    runtime, arrival times + task profiles for the simulator."""
    reqs = []
    for k in range(N_REQUESTS):
        n = k % N_SERVERS
        prompt = TaskTokenSource(f"edge{k}", cfg.vocab_size,
                                 seed=10 + k).sample(1, PROMPT)[0]
        reqs.append(Request(prompt=prompt, max_new_tokens=STEPS, origin=n,
                            arrival=4.0 * k, task=BIGBENCH_TASKS[n]))
    return reqs


def show(m: dict) -> None:
    ps = m["per_server"]
    print(f"  [{m['backend']}] clock={m['clock']} "
          f"servers={m['n_servers']} redirected={m['redirected_total']}")
    for n in range(m["n_servers"]):
        print(f"    server{n}: submitted={ps['submitted'][n]} "
              f"served={ps['served'][n]} finished={ps['finished'][n]} "
              f"mean_latency={ps['mean_latency'][n]:.4g} "
              f"local_ratio={ps['local_ratio'][n]:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run the plain versions on the CPU)")

    cfg = get_config("mixtral-8x7b").reduced()  # 4 experts, top-2, 2 layers
    engine, _ = build_engine(cfg, device=args.device, dtype=torch.float32,
                             max_len=48, policy="dancemoe",
                             review_rounds=STEPS, n_ep=N_SERVERS, slots=2)
    spec = engine.rt.ep_spec
    n_groups = engine.n_groups
    requests = build_requests(cfg)
    topo = build_topology()

    print(f"== runtime backend: {N_SERVERS}-server EdgeCluster over "
          f"{N_SERVERS} virtual EP ranks on {args.device} ==")
    cm = CommCostModel(topology=topo,
                       expert_bytes=3 * cfg.d_model * cfg.d_ff * 2,
                       activation_bytes=cfg.d_model * 2,
                       tokens_per_horizon=1e5)
    controller = PlacementController(
        policy=get_policy("dancemoe"), cost=cm,
        cluster=ClusterView.from_ep_spec(spec, n_groups),
        interval=STEPS,  # one live review mid-stream
        topology=topo)   # bandwidth-aware staged migration
    # the incumbent is the uniform layout the engine boots with: the
    # mid-stream review *stages* the move to the activation-aware plan
    controller.plan = uniform_plan(n_groups, N_SERVERS, cfg.num_experts)
    cluster = EdgeCluster("runtime", engine=engine, n_servers=N_SERVERS,
                          controller=controller, topology=topo,
                          runtime_opts=dict(max_slots=4, prefix_cache=False),
                          trace=True)      # span tracing on the tick clock
    handles = [cluster.submit(r) for r in requests]
    cluster.run()
    counts = engine.stats.counts.copy()          # [n_groups, n_ep, E]
    show(cluster.metrics())
    print(f"  migrations: {len(cluster.migrations)}")
    assert len(cluster.migrations) >= 1, "no live placement review ran"

    ev = cluster.events
    starts = [e for e in ev if e.type == EventType.MIGRATION_STARTED]
    dones = [e for e in ev if e.type == EventType.MIGRATION_COMPLETED]
    assert starts and dones and starts[0].time < dones[0].time
    net = cluster.metrics()["net"]
    print(f"  staged migrations: {len(starts)} started, {len(dones)} "
          f"completed ({net['migrations']['transfer_seconds']:.3g}s modeled "
          "transfer)")
    print(f"  cross-server dispatch: {net['cross_server_bytes']:.3g} bytes "
          f"over {net['rounds']} metered rounds")
    assert net["cross_server_bytes"] > 0

    obs = cluster.metrics()["obs"]
    assert obs["dropped_events"] == 0
    assert obs["span_counts"].get("PLACEMENT_REVIEW", 0) >= 1
    tpath = os.path.join(tempfile.gettempdir(), "serve_edge_torch_trace.json")
    cluster.export_trace(tpath)
    print(f"  trace: {obs['events']} spans -> {tpath}")

    # 1) outputs are token-identical to generate() per request
    ref, _ = engine.generate(np.stack([r.prompt for r in requests]),
                             steps=STEPS)
    for k, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(), ref[k])
    print("  runtime outputs token-identical to generate(): OK")

    # 2) per-origin gating stats: each origin's row carries exactly its
    #    own prompts + decodes
    per_origin = counts.sum(axis=(0, 2))         # [n_ep]
    expect = np.zeros(N_SERVERS)
    for r in requests:
        expect[r.origin] += cfg.top_k * n_groups * (len(r.prompt) + STEPS - 1)
    np.testing.assert_allclose(per_origin, expect, rtol=0.01)
    print(f"  per-origin gating mass {per_origin} matches the "
          "[n_ep, E] attribution path: OK")

    print("\n== sim backend: same Request stream, same topology ==")
    profile = MoEProfile.from_config(cfg)
    sim_ctrl = PlacementController(
        policy=get_policy("dancemoe"), cost=None,
        cluster=ClusterView.from_topology(topo, profile), interval=10.0,
        topology=topo)
    sim = EdgeCluster("sim", topology=topo, profile=profile,
                      controller=sim_ctrl, seed=0, trace=True)
    sim_handles = [sim.submit(r) for r in requests]
    sim.run()
    show(sim.metrics())
    assert all(h.done for h in sim_handles)
    assert all(h.metrics["latency"] > 0 for h in sim_handles)

    # one contract, two worlds: identical metric surface
    assert set(cluster.metrics()["per_server"]) == \
        set(sim.metrics()["per_server"])
    assert set(cluster.metrics()["net"]) == set(sim.metrics()["net"])
    assert {e.type for h in handles for e in h.events} >= \
        {"ADMITTED", "TOKEN", "FINISHED"}
    print("\nOK: both backends served the same typed stream")


if __name__ == "__main__":
    main()
