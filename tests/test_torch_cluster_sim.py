"""The cluster layer's numpy modules in the port against the reference, in
process: the simulator over a Poisson workload, ``EdgeCluster("sim")`` on
the paper's testbed with a DanceMoE controller, crashes with failover on
and off, expert tiers with prefetch on and off, a flash-crowd
``WorkloadStream`` driven with and without SLO-aware admission, and
``Topology.to_cluster_spec``. Each scenario is built in both packages from
the same seeds; ``metrics()``, the merged event stream as (type name, time,
seq, data), the controller's decisions and the scenario's own results must
be equal, bit for bit (the tracer's wall-clock overhead aside).

``make_task_profile`` seeds from ``hash()`` of the task name, which Python
randomises per process; the scenarios hand both packages activation
profiles drawn from fixed seeds instead, so each scenario's own checks
(a migration ran, a request was shed) hold in every process."""

import dataclasses
import importlib
import json
import types
import zlib

import numpy as np
import pytest

from tests._torch_parity import event_stream, jsonable

# the fault testbed of tests/test_faults.py: a small model on 3 servers
SMALL = dict(num_layers=4, num_experts=8, top_k=2, d_model=256, d_ff=512)


def _pkg(name: str) -> types.SimpleNamespace:
    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    return types.SimpleNamespace(
        api=mod("serving.api"), cluster=mod("serving.cluster"),
        faults=mod("serving.faults"), net=mod("serving.net"),
        sim=mod("serving.simulator"), workload=mod("serving.workload"),
        traces=mod("data.traces"), pol=mod("core.policies"),
        mig=mod("core.migration"), stats=mod("core.stats"),
        baselines=mod("core.baselines"))


def _profiles(p, names, num_layers: int, num_experts: int) -> dict:
    """{name: TaskProfile} with skewed per-layer expert distributions drawn
    from a seed fixed by the name."""
    out = {}
    for name in names:
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        out[name] = p.traces.TaskProfile(name, rng.dirichlet(
            np.full(num_experts, 0.5), size=num_layers))
    return out


def _record(ec, handles, **extra) -> dict:
    m = ec.metrics()
    if "obs" in m:
        m["obs"].pop("overhead_ms")          # wall-clock self-accounting
    ctrl = ec.controller
    return jsonable(dict(
        extra, metrics=m, events=event_stream(ec, handles),
        controller=ctrl.events if ctrl is not None else None,
        migrations=ec.migrations,
        handles=[[h.rid, h.server, h.done, h.metrics] for h in handles]))


def _testbed_controller(p, spec, profile, interval):
    cm = p.mig.CostModel(expert_bytes=profile.expert_bytes,
                         activation_bytes=128 * profile.hidden_bytes_per_token,
                         bandwidth=spec.bandwidth,
                         io_speed=np.array([s.io_speed for s in spec.servers]),
                         tokens_per_horizon=2e4)
    return p.pol.PlacementController(
        policy=p.pol.get_policy("dancemoe"), cost=cm,
        cluster=p.pol.ClusterView.from_cluster(spec, profile),
        interval=interval)


def _workload(p, profile):
    wl = p.traces.poisson_workload(
        list(p.traces.BIGBENCH_TASKS), num_layers=profile.num_layers,
        num_experts=profile.num_experts, mean_interarrival=10.0,
        duration=600.0, seed=0)
    return dataclasses.replace(wl, tasks=_profiles(
        p, wl.tasks, profile.num_layers, profile.num_experts))


def simulator(p):
    """``poisson_workload`` through ``EdgeSimulator`` with live reviews."""
    pf, spec = p.cluster.MIXTRAL_PROFILE, p.cluster.paper_testbed(0.7)
    wl = _workload(p, pf)
    ctrl = _testbed_controller(p, spec, pf, interval=120.0)
    res = p.sim.EdgeSimulator(spec, pf, wl, controller=ctrl, seed=1).run()
    assert res.migrations
    return jsonable(dict(
        latencies=res.latencies, servers=res.servers,
        finish=res.finish_times, ratio=res.local_ratio_t,
        migrations=res.migrations, counts=res.stats.counts,
        routed=res.routed, hits=res.hits_by_server, tot=res.tot_by_server,
        controller=ctrl.events))


def cluster_testbed(p):
    """``EdgeCluster("sim")`` over ``paper_testbed(0.7)`` with
    ``MIXTRAL_PROFILE``, a DanceMoE controller, per-request SLOs and the
    span tracer on."""
    pf, spec = p.cluster.MIXTRAL_PROFILE, p.cluster.paper_testbed(0.7)
    wl = _workload(p, pf)
    ec = p.cluster.EdgeCluster(
        "sim", spec=spec, profile=pf,
        controller=_testbed_controller(p, spec, pf, interval=120.0),
        tasks=wl.tasks, seed=0, trace=True)
    reqs = p.cluster.requests_from_workload(wl)
    handles = [ec.submit(r if k % 4 else dataclasses.replace(r, slo=30.0))
               for k, r in enumerate(reqs)]
    ec.run()
    assert ec.migrations and handles[0].done
    return _record(ec, handles)


def _fault_topology(p, tiered=False):
    pf = p.cluster.MoEProfile(**SMALL)
    eb, L = pf.expert_bytes, pf.num_layers
    if tiered:   # 2 GPU slots a layer each (6 < 8 experts), all in host RAM
        profiles = tuple(p.net.ServerProfile(
            n, mem_bytes=2 * L * eb, host_mem_bytes=8 * L * eb, host_bw=2e9,
            compute_speed=50e12) for n in ("lan0", "lan1", "wan2"))
    else:        # 4 slots a layer; server 2 half of that
        profiles = tuple(p.net.ServerProfile(n, mem_bytes=m * 16 * eb,
                                             compute_speed=50e12)
                         for n, m in (("lan0", 1), ("lan1", 1),
                                      ("wan2", 0.5)))
    bw = np.full((3, 3), 500e6 / 8)
    lat = np.full((3, 3), 2e-3)
    for a, b in ((0, 2), (1, 2)):
        bw[a, b] = bw[b, a] = 25e6 / 8
        lat[a, b] = lat[b, a] = 40e-3
    np.fill_diagonal(lat, 0.0)
    return pf, p.net.Topology(profiles, bw, lat)


def _fault_cluster(p, topo, pf, schedule, *, failover=True, prefetch=True,
                   tiered=False):
    cm = p.net.CommCostModel(topology=topo, expert_bytes=pf.expert_bytes,
                             activation_bytes=pf.hidden_bytes_per_token,
                             tokens_per_horizon=1e5)
    stats = p.stats.ActivationStats(pf.num_layers, topo.n, pf.num_experts,
                                    decay=0.9)
    tasks = _profiles(p, [f"task{n}" for n in range(topo.n)], pf.num_layers,
                      pf.num_experts)
    for n in range(topo.n):
        stats.update_server(n, tasks[f"task{n}"].probs * 500.0 * pf.top_k)
    ctrl = p.pol.PlacementController(
        policy=p.pol.get_policy("dancemoe"), cost=cm,
        cluster=p.pol.ClusterView.from_topology(topo, pf, tiered=tiered),
        interval=20.0, topology=topo, stats=stats)
    ec = p.cluster.EdgeCluster("sim", topology=topo, profile=pf,
                               controller=ctrl, tasks=tasks, seed=0,
                               fault_schedule=schedule, failover=failover,
                               prefetch=prefetch)
    rng = np.random.default_rng(0)
    handles, t = [], 0.0
    for k in range(30):
        t += float(rng.exponential(4.0))
        handles.append(ec.submit(p.api.Request(
            prompt=np.zeros(64, np.int32), max_new_tokens=20, origin=k % 3,
            arrival=t, task=f"task{k % 3}")))
    ec.run()
    return ec, handles


def faults(p, failover):
    """A crash of server 2 at t = 60 s that rejoins at t = 100 s."""
    pf, topo = _fault_topology(p)
    sched = p.faults.FaultSchedule.server_crash(60.0, 2, rejoin_at=100.0)
    ec, handles = _fault_cluster(p, topo, pf, sched, failover=failover)
    m = ec.metrics()["faults"]
    assert m["injected"] == 2 and (m["recovered"] == 1) == failover
    return _record(ec, handles)


def tiers(p, prefetch):
    """The tiered testbed under a link brownout and a crash."""
    pf, topo = _fault_topology(p, tiered=True)
    F = p.faults
    sched = F.FaultSchedule([
        F.FaultEvent(40.0, F.LINK_DEGRADED, src=0, dst=1, factor=0.5),
        F.FaultEvent(60.0, F.SERVER_DOWN, server=2),
        F.FaultEvent(80.0, F.LINK_RESTORED, src=0, dst=1)])
    ec, handles = _fault_cluster(p, topo, pf, sched, prefetch=prefetch,
                                 tiered=True)
    assert ec.metrics()["tiers"]["promotions"] >= (1 if prefetch else 0)
    return _record(ec, handles)


def workload(p, slo_aware):
    """A flash crowd at server 2 through ``drive`` and ``goodput_report``
    over a 25 Mbps, plan-based cluster (no controller)."""
    W = p.workload
    pf = p.cluster.MoEProfile(num_layers=8, num_experts=16, top_k=2,
                              d_model=512, d_ff=1024)
    spec = W.WorkloadSpec(
        duration=80.0, base_rate=2.0, n_origins=3, origin_skew=0.8,
        diurnal_period=60.0, diurnal_amplitude=0.4,
        crowds=(W.FlashCrowd(start=25.0, duration=20.0, multiplier=6.0,
                             origin=2, fraction=0.9, task="flashtask"),),
        prompt_len=(96.0, 0.6, 8, 384), output_len=(16.0, 0.5, 4, 48),
        slo=6.0, seed=0)
    cspec = p.cluster.ClusterSpec(servers=tuple(
        p.cluster.ServerSpec(f"s{k}", mem_bytes=64 * pf.expert_bytes)
        for k in range(3)), bandwidth=25e6 / 8)
    ec = p.cluster.EdgeCluster(
        "sim", spec=cspec, profile=pf,
        plan=p.baselines.uniform_plan(pf.num_layers, 3, pf.num_experts),
        tasks=_profiles(p, ["task0", "task1", "task2", "flashtask"],
                        pf.num_layers, pf.num_experts),
        slo_aware=slo_aware)
    handles = W.drive(ec, W.WorkloadStream(spec), max_pending=32)
    report = W.goodput_report(handles, phase_of=spec.phase_of)
    assert (report["sheds"] > 0) == slo_aware
    return _record(ec, handles, goodput=report)


def to_cluster_spec(p):
    _, topo = _fault_topology(p)
    _, tiered = _fault_topology(p, tiered=True)
    one = p.net.Topology.uniform((p.net.ServerProfile("solo"),))
    return jsonable([t.to_cluster_spec() for t in (topo, tiered, one)])


SCENARIOS = {
    "simulator": simulator,
    "testbed": cluster_testbed,
    "faults-failover": lambda p: faults(p, True),
    "faults-no-failover": lambda p: faults(p, False),
    "tiers-prefetch": lambda p: tiers(p, True),
    "tiers-frozen": lambda p: tiers(p, False),
    "workload-fifo": lambda p: workload(p, False),
    "workload-slo-aware": lambda p: workload(p, True),
    "to-cluster-spec": to_cluster_spec,
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_port_matches_reference(case):
    want = SCENARIOS[case](_pkg("repro"))
    got = SCENARIOS[case](_pkg("repro_torch"))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
