"""Shared builders for the port's parity tests: the same model built in the
JAX reference (``repro``) and in the PyTorch port (``repro_torch``), with
the reference's weights carried across as numpy arrays."""

import dataclasses
import importlib
import json
import pathlib

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import moe as JM
from repro.models import transformer as jtr
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as ttr
from repro_torch.serving.engine import ServingEngine as TEngine

# EP geometry of the reference's serving equivalence suite
CAPACITY = 4096
SLOT_CAPACITY = 8192


def to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def build_pair(arch: str, moe_impl: str = "ep", max_len: int = 64,
               capacity: int = CAPACITY, slot_capacity: int = SLOT_CAPACITY):
    """(reference engine, port engine on the CPU) over identical fp32
    weights: the reference's ``init_params(PRNGKey(0))``; MoE configs get
    the dense master copy and a uniform EP placement, as the reference's
    serving launcher builds them."""
    cfg = get_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    mesh = make_test_mesh(1, 1)
    _, n_groups = cfg.layer_pattern()
    if cfg.is_moe and moe_impl == "ep":
        spec = JM.EPSpec.build(mesh, cfg, ep_axes=("model",),
                               slots=cfg.num_experts, capacity=capacity,
                               slot_capacity=slot_capacity)
        jrt = jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl="ep", ep_spec=spec)
        dense = jtr.init_params(
            jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl="dense"),
            jax.random.PRNGKey(0))
        pl = JM.uniform_placement(1, spec.slots, cfg.num_experts)
        pls = jtr.stack_placement(pl, n_groups)
        params = dict(dense)
        params["groups"] = JM.regather_ep_groups(dense["groups"], pls,
                                                 n_groups)
        jeng = JEngine(rt=jrt, params=params, placement=pls,
                       dense_master=dense["groups"], max_len=max_len)
        tspec = TM.EPSpec(1, spec.slots, spec.capacity, spec.slot_capacity)
        trt = ttr.Runtime(cfg=tcfg, moe_impl="ep", ep_spec=tspec,
                          device="cpu")
        tparams = params_from_numpy(to_numpy(params), "cpu")
        teng = TEngine(rt=trt, params=tparams, placement=to_numpy(pls),
                       dense_master=params_from_numpy(
                           to_numpy(dense["groups"]), "cpu"),
                       max_len=max_len)
        return jeng, teng
    jrt = jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl=moe_impl)
    params = jtr.init_params(jrt, jax.random.PRNGKey(0))
    jeng = JEngine(rt=jrt, params=params, placement=None, max_len=max_len)
    trt = ttr.Runtime(cfg=tcfg, moe_impl=moe_impl, device="cpu")
    teng = TEngine(rt=trt, params=params_from_numpy(to_numpy(params), "cpu"),
                   placement=None, max_len=max_len)
    return jeng, teng


def prompts(vocab: int, n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def build_train_pair(arch: str):
    """The JAX trainer's runtime (``moe_impl="dense"``, no mesh) and the
    port's on the CPU, for ``arch``'s reduced config, over the reference's
    ``init_params(PRNGKey(0))``. Returns (jrt, jparams, trt, tparams); the
    port gets its own copy of the weights as numpy arrays."""
    cfg = get_config(arch).reduced()
    jrt = jtr.Runtime(cfg=cfg, moe_impl="dense")
    jparams = jtr.init_params(jrt, jax.random.PRNGKey(0))
    trt = ttr.Runtime(cfg=tget_config(arch).reduced(), moe_impl="dense",
                      device="cpu")
    return jrt, jparams, trt, params_from_numpy(to_numpy(jparams), "cpu")


# ---------------------------------------------------------------------------
# The edge cluster: the failover scenario of tests/md_scripts/
# failover_runtime.py on either package's EdgeCluster("runtime"), three
# servers as three EP ranks of one engine
# ---------------------------------------------------------------------------

N_SERVERS, PROMPT, STEPS, N_REQUESTS = 3, 16, 6, 6
CRASH_TICK, DEAD = 4.0, 2
SLOTS = 2    # per rank: the survivors' 4 slots still cover the 4 experts
# (failover, shared_runtime, controller) of each leg; the controller-less
# leg meters its dispatch against the engine's own placement tables
LEGS = [(True, True, True), (False, True, True), (True, False, True),
        (False, False, True), (True, True, False)]
# one paged KV block of the reduced model in fp32: 16 positions x k and v
# x 2 layers x d_model 256 x 4 bytes; per-server runtimes size their pools
# from each server's KV budget
KV_BLOCK_BYTES = 16 * 2 * 2 * 256 * 4


def jsonable(x):
    """``x`` as plain JSON types (numpy arrays and scalars, tuples and
    dataclasses unpacked); anything else is an error, so that a comparison
    never silently drops a field."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return jsonable(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return jsonable(dataclasses.asdict(x))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"not JSON-able: {type(x).__name__}")


def event_stream(cluster, handles) -> list:
    """The cluster's events merged with every handle's, as (type name,
    time, seq, data), in the cluster's (time, seq) total order."""
    evs = list(cluster.events) + [e for h in handles for e in h.events]
    evs.sort(key=lambda e: (e.time, e.seq))
    return [[e.type, e.time, e.seq, jsonable(e.data)] for e in evs]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def cluster_topology(pkg: str):
    """Three servers; server 2 is memory-poor behind a 25 Mbps / 40 ms hop,
    the others share a 500 Mbps link."""
    net = _mod(pkg, "serving.net")
    profiles = (
        net.ServerProfile("e0", mem_bytes=8e9, kv_mem_bytes=24 * KV_BLOCK_BYTES),
        net.ServerProfile("e1", mem_bytes=8e9, kv_mem_bytes=24 * KV_BLOCK_BYTES),
        net.ServerProfile("e2", mem_bytes=2e9, kv_mem_bytes=12 * KV_BLOCK_BYTES))
    bw = np.full((3, 3), 500e6 / 8)
    lat = np.full((3, 3), 2e-3)
    bw[0, 2] = bw[2, 0] = bw[1, 2] = bw[2, 1] = 25e6 / 8
    lat[0, 2] = lat[2, 0] = lat[1, 2] = lat[2, 1] = 40e-3
    np.fill_diagonal(lat, 0.0)
    return net.Topology(profiles, bw, lat)


def cluster_prompts(vocab: int) -> list:
    """One prompt per request, each from its own task's token source (input
    locality per server). ``TaskTokenSource`` seeds from ``hash()`` of its
    name, which differs between processes, so the reference's process draws
    them and the port is handed the same arrays."""
    from repro.data.pipeline import TaskTokenSource

    return [TaskTokenSource(f"edge{k}", vocab, seed=10 + k).sample(
                1, PROMPT)[0] for k in range(N_REQUESTS)]


def run_cluster_leg(pkg: str, engine, prompts, *, failover: bool,
                    shared: bool, controller: bool = True,
                    interval: float = 2.0):
    """One run of the scenario on ``engine`` (either package's): greedy
    requests for ``prompts`` with origins round-robin, a DanceMoE
    controller (unless ``controller`` is False) starting from the uniform
    plan and reviewing every ``interval`` ticks, server ``DEAD`` crashing
    at ``CRASH_TICK``. Returns (cluster, handles)."""
    pol = _mod(pkg, "core.policies")
    net = _mod(pkg, "serving.net")
    cfg = engine.rt.cfg
    _, n_groups = cfg.layer_pattern()
    topo = cluster_topology(pkg)
    ctrl = None
    if controller:
        cm = net.CommCostModel(topology=topo,
                               expert_bytes=3 * cfg.d_model * cfg.d_ff * 2,
                               activation_bytes=cfg.d_model * 2,
                               tokens_per_horizon=1e5)
        ctrl = pol.PlacementController(
            policy=pol.get_policy("dancemoe"), cost=cm,
            cluster=pol.ClusterView.from_ep_spec(engine.rt.ep_spec,
                                                 n_groups),
            interval=interval, topology=topo)
        ctrl.plan = _mod(pkg, "core.baselines").uniform_plan(
            n_groups, N_SERVERS, cfg.num_experts)
    faults = _mod(pkg, "serving.faults")
    cluster = _mod(pkg, "serving.cluster").EdgeCluster(
        "runtime", engine=engine, n_servers=N_SERVERS, controller=ctrl,
        topology=topo,
        fault_schedule=faults.FaultSchedule.server_crash(CRASH_TICK, DEAD),
        failover=failover, shared_runtime=shared,
        runtime_opts=dict(max_slots=4, prefix_cache=False))
    Request = _mod(pkg, "serving.api").Request
    handles = [cluster.submit(Request(prompt=np.asarray(p, np.int32),
                                      max_new_tokens=STEPS,
                                      origin=k % N_SERVERS))
               for k, p in enumerate(prompts)]
    cluster.run()
    return cluster, handles


def cluster_record(cluster, handles) -> dict:
    """What the two packages must agree on: token streams, the merged event
    stream, the controller's decision log, ``metrics()`` without the
    wall-time ``perf`` values (their keys only) and the engine's
    activation counts."""
    metrics = cluster.metrics()
    perf = metrics.pop("perf")
    return jsonable({
        "tokens": [h.result().tolist() if h.done else None for h in handles],
        "events": event_stream(cluster, handles),
        "controller": (cluster.controller.events
                       if cluster.controller is not None else None),
        "metrics": metrics,
        "perf_keys": sorted(f"{k}.{j}" if isinstance(v, dict) else k
                            for k, v in perf.items()
                            for j in (v if isinstance(v, dict) else [None])),
        "counts": cluster.backend.engine.stats.counts,
    })


def reference_cluster_engine():
    """The reference engine of the scenario on a (1, 3) mesh (the calling
    process must have 3 CPU devices): uniform EP placement of ``SLOTS``
    slots per rank over the dense ``init_params(PRNGKey(0))``. Returns
    (engine, dense params)."""
    cfg = get_config("mixtral-8x7b").reduced()
    mesh = make_test_mesh(1, N_SERVERS)
    spec = JM.EPSpec.build(mesh, cfg, ep_axes=("model",), slots=SLOTS,
                           capacity=CAPACITY, slot_capacity=SLOT_CAPACITY)
    _, n_groups = cfg.layer_pattern()
    dense = jtr.init_params(jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl="dense"),
                            jax.random.PRNGKey(0))
    pls = jtr.stack_placement(
        JM.uniform_placement(spec.n_ep, spec.slots, cfg.num_experts), n_groups)
    params = dict(dense)
    params["groups"] = JM.regather_ep_groups(dense["groups"], pls, n_groups)
    engine = JEngine(rt=jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl="ep",
                                    ep_spec=spec),
                     params=params, placement=pls,
                     dense_master=dense["groups"], max_len=48)
    return engine, dense


def port_cluster_engine(ckpt, device="cpu"):
    """The port's engine of the scenario over the reference's weights, read
    from the npz that ``save_checkpoint`` wrote at ``ckpt``."""
    from repro_torch.checkpoint.io import load_npz

    cfg = tget_config("mixtral-8x7b").reduced()
    spec = TM.EPSpec(N_SERVERS, SLOTS, CAPACITY, SLOT_CAPACITY)
    _, n_groups = cfg.layer_pattern()
    dense = load_npz(ckpt, device)
    pls = ttr.stack_placement(
        TM.uniform_placement(N_SERVERS, SLOTS, cfg.num_experts), n_groups)
    params = dict(dense)
    params["groups"] = TM.regather_ep_groups(dense["groups"], pls, n_groups)
    return TEngine(rt=ttr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec,
                                  device=device),
                   params=params, placement=pls, dense_master=dense["groups"],
                   max_len=48)


def run_reference_cluster(out_dir: str) -> None:
    """Subprocess entry point (3 CPU devices): save the reference engine's
    weights to ``out_dir/dense.npz`` and write the prompts and the record
    of every leg, each on a fresh engine, to ``out_dir/reference.json``."""
    from repro.checkpoint.io import save_checkpoint

    out = pathlib.Path(out_dir)
    records = []
    for failover, shared, controller in LEGS:
        engine, dense = reference_cluster_engine()
        if not records:
            save_checkpoint(out / "dense", dense)
            prompts = cluster_prompts(engine.rt.cfg.vocab_size)
        records.append(cluster_record(*run_cluster_leg(
            "repro", engine, prompts, failover=failover, shared=shared,
            controller=controller)))
    (out / "reference.json").write_text(json.dumps(
        {"prompts": jsonable(prompts), "legs": records}, sort_keys=True))
