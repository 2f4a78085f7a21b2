"""Dry run of every (architecture x input shape) on one H100 (PyTorch port
of ``repro.launch.dryrun``).

The reference lowers and compiles each step on a 256-chip TPU mesh from
``ShapeDtypeStruct`` inputs. Here the port's own step runs on ``meta``
tensors (shapes and types, no data, no device): parameters, optimizer
state, caches and inputs at full size, every layer group walked by
Python, so no depth differencing is needed. What the step dispatches is
counted (``roofline.count_step``: matmul FLOPs and the virtual-rank
collectives); the argument and output bytes are the sums of the meta
leaves' sizes. Records go to ``results/torch/dryrun/`` (never the
reference's ``results/dryrun/``), named by mesh:

- ``1xH100``: the step on one card, as it runs there (no mesh; MoE EP over
  one virtual rank);
- ``16x16`` and ``2x16x16`` (``--multi-pod``, ``--both-meshes``): the
  step on the reference's production mesh of virtual devices
  (``launch.mesh.make_production_mesh``), every device's work run on
  meta. The argument bytes are one device's (``models.sharding``: each
  leaf's block under the reference's specs); the FLOPs, the collectives
  and the output bytes are the whole mesh's divided evenly over its
  chips, which the record's ``per_device`` says.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]

Not ported: ``scan_layers`` (Python walks the groups) and the compiled
HLO's figures (``hlo_bytes``, ``temp_size_in_bytes``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.core.placement import build_ep_placement, dancemoe_placement
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.roofline import count_step, roofline_report
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as sh
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import adafactor, tree_leaves
from repro_torch.training.train_loop import make_train_step

ASSIGNED_ARCHS = [
    "starcoder2-3b", "qwen2-vl-72b", "tinyllama-1.1b", "falcon-mamba-7b",
    "zamba2-2.7b", "musicgen-large", "command-r-plus-104b",
    "llama4-maverick-400b-a17b", "yi-6b", "phi3.5-moe-42b-a6.6b",
]
MESH = "1xH100"
MESHES = {"1xH100": None,
          "16x16": lambda: mesh_lib.make_production_mesh(),
          "2x16x16": lambda: mesh_lib.make_production_mesh(multi_pod=True)}
OUT_DIR = "results/torch/dryrun"


def ep_axes_for(cfg: ModelConfig) -> tuple:
    """MoE archs shard experts over the full in-pod device set."""
    return ("data", "model")


def make_runtime(cfg: ModelConfig, shape: InputShape, mesh=None, *,
                 n_ep: int = 1, device="meta", dtype=torch.bfloat16,
                 moe_overrides: dict | None = None, layout: str = "tp",
                 remat_policy: str = "none",
                 kv_quant: bool = False) -> tr.Runtime:
    """The reference's ``make_runtime``: ``mesh`` a ``VirtualMesh``, or
    None for one card taken as a (1, n_ep) mesh (data = pod = 1, model =
    n_ep; the runtime then has no mesh). MoE configs run EP over
    ``ep_axes_for(cfg)`` with the reference's row, capacity and decode
    slot capacity formulas."""
    window = cfg.sliding_window if shape.name == "long_500k" else 0
    if cfg.family in ("ssm",):
        window = 0
    ep_mesh = mesh if mesh is not None else mesh_lib.make_test_mesh(1, n_ep)
    sizes = ep_mesh.shape
    ep_spec = None
    if cfg.is_moe:
        n_batch = int(np.prod([v for a, v in sizes.items() if a != "model"]))
        if shape.kind in ("train", "prefill"):
            rows = shape.global_batch * shape.seq_len // (
                sizes["data"] * sizes["model"] * sizes.get("pod", 1))
        else:
            rows = max(shape.global_batch // max(n_batch, 1), 1)
        kw = dict(ep_axes=ep_axes_for(cfg), rows_per_rank=max(rows, 1),
                  capacity_factor=2.0)
        if shape.kind == "decode":
            btok = max(shape.global_batch // sizes.get("pod", 1), 1)
            kw["slot_capacity"] = max(
                16, int(np.ceil(btok * cfg.top_k / cfg.num_experts * 8)))
        if moe_overrides:
            kw.update(moe_overrides)
        ep_spec = moe_mod.EPSpec.build(ep_mesh, cfg, **kw)
    return tr.Runtime(cfg=cfg, moe_impl="ep" if cfg.is_moe else "dense",
                      ep_spec=ep_spec, dtype=dtype, device=device,
                      window=window, remat_policy=remat_policy,
                      kv_quant=kv_quant, mesh=mesh, layout=layout,
                      cache_seq_sharded=(shape.name == "long_500k"
                                         and window == 0
                                         and cfg.has_attention))


def placement_specs(cfg: ModelConfig, rt: tr.Runtime):
    """Stacked per-layer placement tables (numpy int32; tiny)."""
    spec = rt.ep_spec
    E = cfg.num_experts
    _, n_groups = cfg.layer_pattern()
    freqs = np.random.default_rng(0).dirichlet(
        np.full(E, 0.5), size=(n_groups, spec.n_ep))
    cap = np.full(spec.n_ep, spec.slots * n_groups)
    plan = dancemoe_placement(freqs, cap, np.full(spec.n_ep, spec.slots))
    return build_ep_placement(plan, spec.slots)


def input_specs(cfg: ModelConfig, shape: InputShape, rt: tr.Runtime,
                seed: int = 0) -> dict:
    """Every model input of this shape on ``rt.device``: empty on meta,
    else drawn from ``seed`` (tokens uniform over the vocabulary,
    embeddings N(0, 0.02^2), a zero cache, decode at its last
    position)."""
    B, T = shape.global_batch, shape.seq_len
    dev = rt.device
    meta = torch.device(dev).type == "meta"
    rng = np.random.default_rng(seed)

    def tokens(shp):
        if meta:
            return torch.empty(shp, dtype=torch.int32, device=dev)
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, shp),
                               dtype=torch.int32, device=dev)

    out = {}
    if shape.kind == "train":
        out["tokens"] = tokens((B, T))
        out["targets"] = (torch.empty_like(out["tokens"]) if meta
                          else torch.roll(out["tokens"], -1, 1))
    elif shape.kind == "prefill":
        if cfg.frontend != "none":
            # modality stub: precomputed patch/frame embeddings
            shp = (B, T, cfg.d_model)
            out["embeds"] = (
                torch.empty(shp, dtype=torch.bfloat16, device=dev) if meta
                else torch.as_tensor(rng.normal(0, 0.02, shp),
                                     dtype=torch.bfloat16, device=dev))
        else:
            out["tokens"] = tokens((B, T))
    else:  # decode: one token against a seq_len cache
        out["cache"] = tr.init_cache(rt, B, T, dtype=torch.bfloat16)
        out["tokens"] = tokens((B, 1))
        out["pos"] = (torch.empty((), dtype=torch.int32, device=dev) if meta
                      else torch.tensor(T - 1, dtype=torch.int32, device=dev))
    return out


def arg_pspecs(shape: InputShape, rt: tr.Runtime, kwargs: dict) -> dict:
    """The reference's sharding of every argument of the step
    (``input_specs``, ``build_lowerable``): a spec tree mirroring
    ``kwargs`` (``build_step``'s) on ``rt.mesh``. The factored optimizer
    states inherit the leading entries of their parameter's spec; the
    placement tables are replicated. What the step never reads has the
    spec None (``sharding.device_bytes`` counts none of it, as jit drops
    it): ``slot_to_expert`` (routing reads the other two tables) and an
    attention-free model's decode position."""
    b = sh.batch_axes(rt.mesh)
    seq_ax = "model" if rt.layout in ("sp", "cp", "fsdp") else None
    pspec = sh.pspecs_for(rt, kwargs["params"])
    out = {"params": pspec, "placement": [None, (), ()]}
    if shape.kind == "train":
        out["tokens"] = out["targets"] = (b, seq_ax)

        def fact_spec(st, psp):
            if "vr" in st:
                return {"vr": psp[:-1], "vc": psp[:-2] + psp[-1:]}
            return {"v": psp}
        flat = [s for _, s in sh._pairs(kwargs["params"], pspec)]
        out["opt_state"] = {"f": [fact_spec(s, p) for s, p in
                                  zip(kwargs["opt_state"]["f"], flat)],
                            "step": ()}
    elif shape.kind == "prefill":
        out["embeds"] = (b, None, None)
        out["tokens"] = (b, None)
    else:
        out["cache"] = sh.cache_pspecs(rt, seq_sharded=rt.cache_seq_sharded)
        out["tokens"] = (b, None)
        out["pos"] = () if rt.cfg.has_attention else None
    return {k: out[k] for k in kwargs}


def build_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
               n_ep: int = 1, device="meta", layout: str = "tp",
               remat_policy: str = "none", moe_overrides: dict | None = None,
               kv_quant: bool = False, seed: int = 0):
    """The reference's ``build_lowerable``: returns ``(fn, kwargs)``, the
    step and its arguments on ``device`` — parameters, the Adafactor state
    (train), the cache (decode), the inputs and the placement tables
    (int32, as the placement algorithms give them; the step moves them to
    int64 index tensors). On meta every leaf is empty; elsewhere the
    weights are ``init_params(seed)``."""
    rt = make_runtime(cfg, shape, mesh, n_ep=n_ep, device=device,
                      layout=layout, remat_policy=remat_policy,
                      moe_overrides=moe_overrides, kv_quant=kv_quant)
    kwargs = {"params": tr.init_params(rt, seed)}
    kwargs.update(input_specs(cfg, shape, rt, seed))
    if cfg.is_moe:
        kwargs["placement"] = moe_mod.EPPlacement(*(
            torch.as_tensor(a, device="cpu").to(device)
            for a in placement_specs(cfg, rt)))

    def tables(placement):
        return (moe_mod.placement_to(placement, device)
                if placement is not None else None)

    if shape.kind == "train":
        opt = adafactor(schedule=None)
        step = make_train_step(rt, opt)
        kwargs = {"params": kwargs["params"],
                  "opt_state": opt.init(kwargs["params"]),
                  "tokens": kwargs["tokens"], "targets": kwargs["targets"],
                  "placement": kwargs.get("placement")}

        def fn(params, opt_state, tokens, targets, placement=None):
            new_p, new_s, metrics = step(params, opt_state, tokens, targets,
                                         tables(placement))
            return new_p, new_s, metrics["loss"]
        return fn, kwargs

    if shape.kind == "prefill":
        def fn(params, tokens=None, embeds=None, placement=None):
            logits, cache, _ = tr.prefill(rt, params, tokens=tokens,
                                          embeds=embeds,
                                          placement=tables(placement))
            return logits, cache
        return fn, kwargs

    def fn(params, cache, tokens, pos, placement=None):
        logits, new_cache, _ = tr.decode_step(rt, params, cache, tokens, pos,
                                              tables(placement))
        return logits, new_cache
    return fn, kwargs


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf (dicts, lists, tuples; other leaves, such
    as the optimizer's host step counter, hold no device bytes)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def _unit_layers(cfg: ModelConfig) -> int:
    """Layers in one scan group (the depth-differencing unit)."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family == "moe":
        return cfg.moe_every
    return 1


def depth_variant(cfg: ModelConfig, n_units: int) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=_unit_layers(cfg) * n_units)


def best_layout(cfg: ModelConfig, shape: InputShape) -> dict:
    """The reference's best-known configuration per (arch, shape): cp for
    small models, fsdp for large ones on train and prefill, ``dots+kv``
    remat for training and capacity factor 1 for MoE; decode and the SSM /
    hybrid archs keep the defaults."""
    if shape.kind == "decode" or cfg.family in ("ssm", "hybrid"):
        return {}
    kw: dict = {"layout": "cp" if cfg.param_count() < 4e9 else "fsdp"}
    if shape.kind == "train":
        kw["remat_policy"] = "dots+kv"
    if cfg.is_moe:
        kw["moe_overrides"] = {"capacity_factor": 1.0}
    return kw


def analyse(cfg: ModelConfig, shape: InputShape, mesh=None,
            **build_kw) -> dict:
    """The meta step's record fields, for all of it as it runs on one
    card: argument and output bytes, counted FLOPs and collectives, and
    (decode) ``donated_cache``, since the port writes its cache in place.
    On a ``mesh`` also ``device_argument_size_in_bytes``, one device's
    block of every argument (``models.sharding``)."""
    fn, kwargs = build_step(cfg, shape, mesh, device="meta", **build_kw)
    counted = count_step(fn, kwargs)
    rec = {"argument_size_in_bytes": tree_bytes(kwargs),
           "output_size_in_bytes": tree_bytes(counted["outputs"]),
           "temp_size_in_bytes": None,
           "hlo_flops": counted["flops"],
           "collectives": counted["collectives"]}
    if mesh is not None:
        rt = make_runtime(cfg, shape, mesh, **build_kw)
        rec["device_argument_size_in_bytes"] = sh.device_bytes(
            kwargs, arg_pspecs(shape, rt, kwargs), mesh)
    if shape.kind == "decode":
        rec["donated_cache"] = True
    return rec


def per_device(rec: dict, n_chips: int) -> dict:
    """``analyse``'s record on a mesh as one device's: its own argument
    bytes, and the FLOPs, output bytes and collective bytes of the whole
    mesh divided evenly over its chips (``per_device`` says which). The
    whole mesh's argument bytes stay as ``global_argument_size_in_bytes``."""
    coll = {k: {"bytes": v["bytes"] // n_chips, "count": v["count"]}
            for k, v in rec["collectives"].items() if k != "total_bytes"}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    return {
        "global_argument_size_in_bytes": rec["argument_size_in_bytes"],
        "argument_size_in_bytes": rec["device_argument_size_in_bytes"],
        "output_size_in_bytes": rec["output_size_in_bytes"] // n_chips,
        "hlo_flops": rec["hlo_flops"] / n_chips,
        "collectives": coll,
        "per_device": {
            "argument_size_in_bytes": "one device's block of every leaf "
                                      "(models.sharding specs)",
            "hlo_flops": f"whole mesh / {n_chips} chips",
            "output_size_in_bytes": f"whole mesh / {n_chips} chips",
            "collectives": f"bytes: whole mesh / {n_chips} chips; count: "
                           "the mesh's exchanges"}}


def run_one(arch: str, shape_name: str, *, mesh: str = MESH,
            out_dir: str = OUT_DIR, optimized: bool = False,
            reduced: bool = False) -> dict:
    """One pair's record on ``mesh`` (a name of ``MESHES``), written to
    ``out_dir``. ``reduced``: the arch's ``.reduced()`` config (a quick
    check of the tooling), recorded as ``<arch>-smoke``."""
    cfg = get_config(arch)
    if reduced:
        cfg, arch = cfg.reduced(), arch + "-smoke"
    shape = INPUT_SHAPES[shape_name]
    build_kw = best_layout(cfg, shape) if optimized else {}
    vmesh = MESHES[mesh]() if MESHES[mesh] is not None else None
    chips = vmesh.size if vmesh is not None else mesh_lib.CHIPS
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "chips": chips, "ok": False, "build_kw": str(build_kw)}
    t0 = time.time()
    try:
        rec.update(analyse(cfg, shape, vmesh, **build_kw))
        if vmesh is not None:
            rec.update(per_device(rec, chips))
        rec["roofline"] = roofline_report(rec, cfg, shape, n_chips=chips)
        rec["ok"] = True
    except Exception as e:  # record failures — they are bugs to fix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    Path(out_dir, f"{arch}__{shape_name}__{mesh}.json").write_text(
        json.dumps(rec, indent=1, default=str))
    return rec


def run_all(pairs, *, workers: int = 1, **kw) -> list:
    """``run_one`` over ``(arch, shape)`` or ``(arch, shape, mesh)``
    tuples, in ``workers`` spawned processes when more than one (a meta
    step is single-threaded Python: a full training pair takes several
    seconds of meta ops, the Mamba prefill at 32k tokens about a minute).
    Records in the tuples' order."""
    calls = [(p[:2], dict(kw, **({"mesh": p[2]} if len(p) > 2 else {})))
             for p in pairs]
    if workers <= 1:
        return [run_one(*a, **k) for a, k in calls]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = [pool.submit(run_one, *a, **k) for a, k in calls]
        return [f.result() for f in futs]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh of virtual devices")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16x16 and 2x16x16 production meshes")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the best-known remat policy and capacity "
                         "factor per pair (best_layout)")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's .reduced() config (seconds a pair)")
    ap.add_argument("--workers", type=int, default=1,
                    help="pairs run in this many processes at once")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = (["16x16", "2x16x16"] if args.both_meshes
              else ["2x16x16"] if args.multi_pod else [MESH])
    pairs = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                name = arch + ("-smoke" if args.reduced else "")
                done = Path(args.out, f"{name}__{shape}__{mesh}.json")
                if args.skip_done and done.exists():
                    if json.loads(done.read_text()).get("ok"):
                        print(f"[skip] {name} {shape} {mesh}")
                        continue
                pairs.append((arch, shape, mesh))
    for rec in run_all(pairs, workers=args.workers, out_dir=args.out,
                       optimized=args.optimized, reduced=args.reduced):
        status = "OK" if rec["ok"] else f"FAIL {rec.get('error')}"
        print(f"[{status}] {rec['arch']} {rec['shape']} {rec['mesh']} "
              f"({rec['total_s']}s)", flush=True)


if __name__ == "__main__":
    main()
