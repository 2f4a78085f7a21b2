"""Failover on the port's 3-server cluster: one server crashes mid-stream
and every request still completes (the port's counterpart of
``examples/serve_edge_failover.py``).

The same topology and typed ``Request`` stream as ``serve_edge_torch.py``,
plus a deterministic ``FaultSchedule``: the memory-poor WAN server (edge2)
goes down while it has requests in flight. With ``failover=True`` (the
default) the cluster

1. evicts edge2's in-flight requests and re-routes them to the survivors,
   where they re-prefill under their original handles (token-identical
   to ``generate()``: the crash changes no output token),
2. force-reviews expert placement around the lost capacity (a recovery
   migration staged over the surviving links).

The crash-oblivious baseline (``failover=False``) drops the victims and
counts every token they owed as lost. Both legs run on the runtime backend
(three virtual EP ranks of one engine, built by
``launch.serve.build_engine(n_ep=3)``; on the CUDA device the MoE layers
run the hand-written ``moe_gmm`` kernel); then the sim backend runs the
reference example's crash-and-rejoin schedule on the seconds clock.

Run:  PYTHONPATH=src python examples/serve_edge_failover_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.baselines import uniform_plan
from repro_torch.core.policies import (ClusterView, PlacementController,
                                       get_policy)
from repro_torch.data.pipeline import TaskTokenSource
from repro_torch.launch.serve import build_engine
from repro_torch.serving.api import EventType, Request
from repro_torch.serving.cluster import EdgeCluster, MoEProfile
from repro_torch.serving.faults import FaultEvent, FaultSchedule
from repro_torch.serving.net import CommCostModel, ServerProfile, Topology

N_SERVERS, PROMPT, STEPS, N_REQUESTS = 3, 16, 6, 6
CRASH_TICK, DEAD = 4.0, 2


def build_topology() -> Topology:
    """Two LAN-linked servers plus one memory-poor box behind a WAN-ish
    hop — the box that crashes. With 2 slots a rank the survivors' 4 slots
    still cover the 4 experts, so recovery is feasible."""
    profiles = (ServerProfile("edge0", mem_bytes=8e9),
                ServerProfile("edge1", mem_bytes=8e9),
                ServerProfile("edge2", mem_bytes=2e9))
    bw = np.full((3, 3), 500e6 / 8)
    lat = np.full((3, 3), 2e-3)
    for a, b in ((0, 2), (1, 2)):
        bw[a, b] = bw[b, a] = 25e6 / 8
        lat[a, b] = lat[b, a] = 40e-3
    np.fill_diagonal(lat, 0.0)
    return Topology(profiles, bw, lat)


def run_runtime(cfg, device: str, prompts, failover: bool):
    """One crash on a freshly built engine (weights from seed 0)."""
    engine, _ = build_engine(cfg, device=device, dtype=torch.float32,
                             max_len=48, policy="dancemoe",
                             review_rounds=1000, n_ep=N_SERVERS, slots=2)
    topo = build_topology()
    cm = CommCostModel(topology=topo,
                       expert_bytes=3 * cfg.d_model * cfg.d_ff * 2,
                       activation_bytes=cfg.d_model * 2,
                       tokens_per_horizon=1e5)
    ctrl = PlacementController(
        policy=get_policy("dancemoe"), cost=cm,
        cluster=ClusterView.from_ep_spec(engine.rt.ep_spec, engine.n_groups),
        interval=1000.0,     # only the fault review re-places
        topology=topo)
    ctrl.plan = uniform_plan(engine.n_groups, N_SERVERS, cfg.num_experts)
    cluster = EdgeCluster(
        "runtime", engine=engine, n_servers=N_SERVERS, controller=ctrl,
        topology=topo,
        fault_schedule=FaultSchedule.server_crash(CRASH_TICK, DEAD),
        failover=failover,
        runtime_opts=dict(max_slots=4, prefix_cache=False))
    handles = [cluster.submit(Request(prompt=p, max_new_tokens=STEPS,
                                      origin=k % N_SERVERS))
               for k, p in enumerate(prompts)]
    cluster.run()
    return engine, cluster, handles


def run_sim(failover: bool):
    """The reference example's schedule on the sim backend: edge2 down at
    t = 40 s, back at t = 90 s, 30 Poisson arrivals."""
    profile = MoEProfile(num_layers=4, num_experts=8, top_k=2, d_model=256,
                         d_ff=512)
    base = 16 * profile.expert_bytes
    profiles = (ServerProfile("edge0", mem_bytes=base),
                ServerProfile("edge1", mem_bytes=base),
                ServerProfile("edge2", mem_bytes=base / 2))
    links = build_topology()
    topo = Topology(profiles, links.bandwidth, links.latency)
    ctrl = PlacementController(
        policy=get_policy("dancemoe"), cost=None,
        cluster=ClusterView.from_topology(topo, profile), interval=25.0,
        topology=topo)
    sched = FaultSchedule([FaultEvent(40.0, "SERVER_DOWN", server=DEAD),
                           FaultEvent(90.0, "SERVER_JOINED", server=DEAD)])
    ec = EdgeCluster("sim", topology=topo, profile=profile, controller=ctrl,
                     seed=0, fault_schedule=sched, failover=failover)
    rng = np.random.default_rng(0)
    t = 0.0
    handles = []
    for k in range(30):
        t += float(rng.exponential(4.0))
        handles.append(ec.submit(Request(
            prompt=np.zeros(64, np.int32), max_new_tokens=20,
            origin=k % N_SERVERS, arrival=t, task=f"task{k % N_SERVERS}")))
    ec.run()
    return ec, handles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run the plain versions on the CPU)")

    cfg = get_config("mixtral-8x7b").reduced()
    prompts = [TaskTokenSource(f"edge{k}", cfg.vocab_size,
                               seed=10 + k).sample(1, PROMPT)[0]
               for k in range(N_REQUESTS)]
    print(f"== runtime backend on {args.device}: edge{DEAD} crashes at tick "
          f"{CRASH_TICK:.0f} ==")
    engine, cl, handles = run_runtime(cfg, args.device, prompts, True)
    f = cl.metrics()["faults"]
    down = next(e for e in cl.events if e.type == EventType.SERVER_DOWN)
    print(f"  victims={down.data['victims']} reassigned to "
          f"{down.data['reassigned']}; completed "
          f"{sum(h.done for h in handles)}/{len(handles)} "
          f"recovered={f['recovered']} tokens_lost={f['tokens_lost']} "
          f"migrations={len(cl.migrations)}")
    assert down.data["victims"] >= 1, "the crash caught no request in flight"
    assert all(h.done for h in handles) and f["requests_dropped"] == 0
    assert any(e.get("fault_review") for e in cl.controller.events)
    ref, _ = engine.generate(np.stack(prompts), steps=STEPS)
    for k, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(), ref[k])
    print("  every stream token-identical to generate() across the crash: OK")

    _, clb, hb = run_runtime(cfg, args.device, prompts, False)
    fb = clb.metrics()["faults"]
    print(f"  no-failover baseline: completed {sum(h.done for h in hb)}/"
          f"{len(hb)} dropped={fb['requests_dropped']} "
          f"tokens_lost={fb['tokens_lost']}")
    assert fb["requests_dropped"] >= 1
    assert fb["tokens_lost"] >= fb["requests_dropped"] * STEPS

    print(f"\n== sim backend: edge{DEAD} down at t=40s, rejoins at t=90s ==")
    ec, hs = run_sim(True)
    fs = ec.metrics()["faults"]
    print(f"  completed {sum(h.done for h in hs)}/{len(hs)} "
          f"recovered={fs['recovered']} "
          f"recovery={fs['recovery_seconds']:.3g}s")
    assert all(h.done for h in hs) and ec.topology.state.up.all()
    ecb, hsb = run_sim(False)
    fsb = ecb.metrics()["faults"]
    print(f"  no-failover baseline: dropped={fsb['requests_dropped']} "
          f"tokens_lost={fsb['tokens_lost']}")
    assert fsb["tokens_lost"] > fs["tokens_lost"]
    print("\nOK: failover served the full stream through the crash on both "
          "backends")


if __name__ == "__main__":
    main()
