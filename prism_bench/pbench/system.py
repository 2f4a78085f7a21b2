"""The system under test: the PyTorch port's ``EdgeCluster("runtime")`` over
one engine whose virtual EP ranks are the edge servers.

Set-up hands the port the benchmark's own weights (``pbench.weights``) in
the layouts it serves them in, boots it on the uniform expert layout, and
puts a DanceMoE ``PlacementController`` with staged migration over the
paper's three-server testbed beside it. What the deployment fixes comes
from the configuration and mix files; the runtime's own defaults decide
the rest (block size, chunks per tick, page-table width, compaction).
"""

from __future__ import annotations

import numpy as np
import torch

from pbench import weights as W

# the launcher's EP geometry (``repro_torch.launch.serve.build_engine``):
# tokens a rank may send to one other rank per step, rows a slot may hold
EP_CAPACITY, EP_SLOT_CAPACITY = 8192, 16384


def model_config(conf: dict):
    from repro_torch.configs.base import ModelConfig

    s = W.sizes(conf)
    return ModelConfig(
        name=conf["name"], family="moe", num_layers=s["layers"],
        d_model=s["d"], num_heads=s["heads"], num_kv_heads=s["kv_heads"],
        d_ff=s["ff"], vocab_size=s["vocab"], head_dim=s["hd"],
        num_experts=s["experts"], top_k=s["top_k"], moe_every=1,
        rope_theta=s["theta"], norm_eps=s["eps"],
        source=conf["source"])


def padded_head_index(s: dict, hp: int) -> torch.Tensor:
    """Where each published q head sits among the program's ``hp`` padded
    heads. The program groups padded head ``h`` with kv head
    ``h // (hp // kv_heads)``, so each kv head's published q heads go to
    the front of its padded group and the rest of the group is padding."""
    per_pub = s["heads"] // s["kv_heads"]
    per_pad = hp // s["kv_heads"]
    h = torch.arange(s["heads"])
    return (h // per_pub) * per_pad + h % per_pub


def _attention_params(s, seed, device, dtype, hp: int, n_layers: int):
    """Stacked attention weights in the program's padded layout: the
    published q heads at ``padded_head_index``, zero columns of ``wq`` and
    zero rows of ``wo`` at the padded heads, which therefore add nothing:
    the program computes the published model."""
    d, hd = s["d"], s["hd"]
    kv = s["kv_heads"] * hd
    cols = (padded_head_index(s, hp)[:, None] * hd
            + torch.arange(hd)[None, :]).reshape(-1).to(device)
    out = {
        "norm": torch.ones((n_layers, d), dtype=dtype, device=device),
        "wq": torch.zeros((n_layers, d, hp * hd), dtype=dtype, device=device),
        "wk": torch.empty((n_layers, d, kv), dtype=dtype, device=device),
        "wv": torch.empty((n_layers, d, kv), dtype=dtype, device=device),
        "wo": torch.zeros((n_layers, hp * hd, d), dtype=dtype, device=device),
    }
    for layer in range(n_layers):
        out["wq"][layer][:, cols] = W.draw(s, seed, "layer{l}.wq", device,
                                           dtype, layer)
        out["wk"][layer] = W.draw(s, seed, "layer{l}.wk", device, dtype, layer)
        out["wv"][layer] = W.draw(s, seed, "layer{l}.wv", device, dtype, layer)
        out["wo"][layer][cols] = W.draw(s, seed, "layer{l}.wo", device, dtype,
                                        layer)
    return out


def _moe_params(s, seed, device, dtype, n_layers: int):
    """Stacked dense-master MoE weights ``[L, E, ...]`` and routers."""
    d = s["d"]
    out = {"norm": torch.ones((n_layers, d), dtype=dtype, device=device),
           "router": torch.empty((n_layers, d, s["experts"]), dtype=dtype,
                                 device=device)}
    for n in ("w1", "w3", "w2"):
        shape, _ = W.shapes(s)[f"layer{{l}}.{n}"]
        out[n] = torch.empty((n_layers,) + shape, dtype=dtype, device=device)
    for layer in range(n_layers):
        for n in ("router", "w1", "w3", "w2"):
            out[n][layer] = W.draw(s, seed, f"layer{{l}}.{n}", device, dtype,
                                   layer)
    return out


def build_engine(conf: dict, seed: int, max_len: int, device: str):
    """The port's serving engine over the benchmark's weights: EP over
    ``servers`` virtual ranks of ``slots_per_server`` slots, booted on the
    uniform layout, with the dense master copy that live migration
    re-gathers slots from."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import ServingEngine

    cfg = model_config(conf)
    dep = conf["deployment"]
    s = W.sizes(conf)
    dtype = s["dtype"]
    spec = M.EPSpec.build(dep["servers"], cfg, slots=dep["slots_per_server"],
                          capacity=EP_CAPACITY,
                          slot_capacity=EP_SLOT_CAPACITY)
    rt = tr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec, dtype=dtype,
                    device=device)
    n_layers = s["layers"]
    dense = {"b0": _attention_params(s, seed, device, dtype,
                                     cfg.padded_heads(rt.ep), n_layers),
             "b1": _moe_params(s, seed, device, dtype, n_layers)}
    pls = tr.stack_placement(M.uniform_placement(spec.n_ep, spec.slots,
                                                 s["experts"]), n_layers)
    params = {"embed": W.draw(s, seed, "embed", device, dtype),
              "final_norm": torch.ones((s["d"],), dtype=dtype,
                                       device=device),
              "lm_head": W.draw(s, seed, "lm_head", device, dtype),
              "groups": M.regather_ep_groups(dense, pls, n_layers)}
    return ServingEngine(rt=rt, params=params, placement=pls,
                         dense_master=dense, max_len=max_len)


def build_cluster(engine, conf: dict, mix: dict, s: dict):
    """``EdgeCluster("runtime")``: one shared origin-tagged runtime on the
    warmed zero-stall loop, paged pool and radix prefix cache (the
    runtime's defaults), a DanceMoE controller with staged migration over
    the paper's testbed, greedy requests. An expert is priced from the
    sizes ``s`` (the system module's): its three d x ff matrices. Returns
    (cluster, controller). The controller's first review is left to the
    caller (``open_reviews``)."""
    from repro_torch.core.baselines import uniform_plan
    from repro_torch.core.policies import (ClusterView, PlacementController,
                                           get_policy)
    from repro_torch.serving.cluster import EdgeCluster, paper_testbed
    from repro_torch.serving.net import CommCostModel, Topology

    cfg = engine.rt.cfg
    dep = conf["deployment"]
    pol = mix["placement"]
    itemsize = engine.rt.dtype.itemsize
    topo = Topology.from_cluster_spec(paper_testbed(dep["mem_fraction"]))
    cost = CommCostModel(topology=topo,
                         expert_bytes=3 * s["d"] * s["ff"] * itemsize,
                         activation_bytes=cfg.d_model * itemsize,
                         tokens_per_horizon=pol["tokens_per_horizon"])
    ctrl = PlacementController(
        policy=get_policy(pol["policy"]), cost=cost,
        cluster=ClusterView.from_ep_spec(engine.rt.ep_spec, engine.n_groups),
        interval=float(pol["review_ticks"]), topology=topo,
        clock_rate=float(pol["clock_s_per_tick"]))
    ctrl.plan = uniform_plan(engine.n_groups, dep["servers"], cfg.num_experts)
    ctrl.last_review = float("inf")  # no review until open_reviews
    cluster = EdgeCluster(
        "runtime", engine=engine, n_servers=dep["servers"], controller=ctrl,
        topology=topo,
        runtime_opts=dict(max_slots=mix["max_slots"], warmup=True,
                          warmup_origins="tagged"))
    return cluster, ctrl


def open_reviews(cluster, ctrl) -> None:
    """Let the controller review from the next tick on, every
    ``interval`` ticks after."""
    ctrl.last_review = float(cluster.backend.rounds) - ctrl.interval


def engine_residency(engine) -> np.ndarray:
    """[L, servers, E] 0/1: which experts the engine's slot tables hold."""
    s2e = engine.placement.slot_to_expert.cpu().numpy()  # [L, n, S]
    L, n, _ = s2e.shape
    res = np.zeros((L, n, engine.rt.cfg.num_experts))
    for layer in range(L):
        for r in range(n):
            for e in s2e[layer, r]:
                if e >= 0:
                    res[layer, r, int(e)] = 1.0
    return res


def runtime(cluster):
    return cluster.backend.runtimes[0]
