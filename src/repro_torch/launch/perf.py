"""Perf-iteration tool (PyTorch port of ``repro.launch.perf``): run an
(arch, shape) pair under a named variant (layout, remat policy, MoE
capacity override, int8 KV) and append the record to
``results/torch/perf/<arch>__<shape>.jsonl``.

On ``meta`` the record is the dry run's on the reference's 16x16
production mesh of virtual devices (``dryrun.analyse`` and
``dryrun.per_device``: one device's argument bytes, the mesh's counted
FLOPs and collectives over its chips, roofline). On ``cuda`` the step runs
for real on the card, by default on a virtual (1, 8) mesh (``CARD_MESH``:
MoE EP over 8 virtual ranks, so a layout changes which rank owns which
rows and, at a tight capacity, which rows are dropped), at 1 and 2 depth
units with random weights and a batch that fits (the cut is recorded as
``reduced``): one warm-up step, then the step timed with CUDA events, its
peak memory read, and its FLOPs counted by the meta pass at the same
shapes (the hand kernels are invisible to ``FlopCounterMode``, so the
card's run is never counted). Time, FLOPs and bytes are the whole card's,
extrapolated to full depth with the reference's depth differencing; the
record gets the roofline at full depth and ``mfu = model_flops /
(PEAK_FLOPS x step_s)``.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch mixtral-8x7b \\
      --shape train_4k --variant sp+cf05 --device cuda [--mesh 1xH100]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import (MESHES, analyse, build_step,
                                       depth_variant, make_runtime,
                                       per_device, tree_bytes)
from repro_torch.launch.roofline import model_flops, roofline_report
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tr
from repro_torch.optim.adamw import tree_leaves

VARIANTS = {
    # name -> build_step keyword arguments (the reference's)
    "baseline": {},
    "sp": {"layout": "sp"},
    "cp": {"layout": "cp"},
    "sp+dots": {"layout": "sp", "remat_policy": "dots"},
    "cp+dots": {"layout": "cp", "remat_policy": "dots"},
    "tp+dots": {"remat_policy": "dots"},
    "cp+dots+kv": {"layout": "cp", "remat_policy": "dots+kv"},
    "sp+dots+kv": {"layout": "sp", "remat_policy": "dots+kv"},
    "sp+cf1": {"layout": "sp", "moe_overrides": {"capacity_factor": 1.0}},
    "sp+cf05": {"layout": "sp", "moe_overrides": {"capacity_factor": 0.5}},
    "cf1": {"moe_overrides": {"capacity_factor": 1.0}},
    "fsdp": {"layout": "fsdp"},
    "kv8": {"kv_quant": True},
    "fsdp+dots+kv+cf1": {"layout": "fsdp", "remat_policy": "dots+kv",
                         "moe_overrides": {"capacity_factor": 1.0}},
    "fsdp+cf1": {"layout": "fsdp", "moe_overrides": {"capacity_factor": 1.0}},
    "fsdp+dots+kv": {"layout": "fsdp", "remat_policy": "dots+kv"},
}
META_MESH = "16x16"  # the meta leg's mesh (the reference's)
# the card leg's mesh: 8 virtual devices on the model axis ("1xH100": one
# card without a mesh, MoE EP over one virtual rank)
CARD_MESH = "1x8"
MESHES = dict(MESHES, **{CARD_MESH: lambda: mesh_lib.make_test_mesh(1, 8)})
# the batch each kind runs at on the card (the published batches do not
# fit one card: decode_32k's 128 rows would expand k and v to the q heads
# in two 68.7 GB fp32 temporaries a layer at Mixtral's width)
CARD_BATCH = {"train": 1, "prefill": 1, "decode": 8}
OUT_DIR = "results/torch/perf"
REPS = 3  # timed steps after the warm-up step


def extrap(x1: float, x2: float, n_groups: int) -> float:
    """Full depth from 1 and 2 depth units: what lies outside the groups
    plus ``n_groups`` times one group."""
    per = max(x2 - x1, 0.0)
    return max(x1 - per, 0.0) + per * n_groups


def _peak_above(run) -> tuple:
    """(what ``run()`` returns, the peak bytes it allocated above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def remat_bytes(rt, kwargs) -> dict:
    """One forward and backward of the train step's loss on the card,
    outside the step: the bytes the forward leaves allocated for the
    backward (``saved_bytes``), the forward's peak and the forward and
    backward's peak (``fwd_peak_bytes``, ``fwd_bwd_bytes``), each above
    what was allocated before it. The step's own peak is the optimizer's
    update, which no remat policy changes."""
    params, pl = kwargs["params"], kwargs["placement"]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    gc.collect()  # what an earlier step's reference cycles still hold
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        loss, _ = tr.loss_fn(rt, params, kwargs["tokens"], kwargs["targets"],
                             placement=(moe_mod.placement_to(pl, "cuda")
                                        if pl is not None else None))
    torch.cuda.synchronize()
    out = {"saved_bytes": torch.cuda.memory_allocated() - base,
           "fwd_peak_bytes": torch.cuda.max_memory_allocated() - base}
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    out["fwd_bwd_bytes"] = torch.cuda.max_memory_allocated() - base
    del grads, loss
    return out


def time_step(cfg, shape, mesh=None, *, reps: int = REPS, **kw) -> dict:
    """Build the step on the card, run it once to warm up, then ``reps``
    times between CUDA events. Returns the mean step seconds, the bytes
    the step's arguments hold, the warm-up step's peak above them
    (``temp_size_in_bytes``), the warm-up step's loss (train) or logits'
    checksum (``first``) and, for train, what a remat policy changes
    (``remat_bytes``)."""
    torch.cuda.empty_cache()
    fn, kwargs = build_step(cfg, shape, mesh, device="cuda", **kw)
    out, temp = _peak_above(lambda: fn(**kwargs))
    rec = {"argument_size_in_bytes": tree_bytes(kwargs),
           "temp_size_in_bytes": temp,
           "first": float(out[-1] if shape.kind == "train"
                          else out[0].float().sum())}
    del out
    if shape.kind == "train":
        rec.update(remat_bytes(make_runtime(cfg, shape, mesh, device="cuda",
                                            **kw), kwargs))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn(**kwargs)
    end.record()
    torch.cuda.synchronize()
    rec["step_s"] = start.elapsed_time(end) / reps / 1e3
    return rec


def run_variant(arch: str, shape_name: str, variant: str, *,
                device: str = "meta", mesh: str | None = None,
                note: str = "", out_dir: str = OUT_DIR) -> dict:
    """One record, appended to ``out_dir/<arch>__<shape>.jsonl``.
    ``mesh``: a name of ``MESHES`` (default ``META_MESH`` on meta,
    ``CARD_MESH`` on the card)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    kw = VARIANTS[variant]
    mesh = mesh or (META_MESH if device == "meta" else CARD_MESH)
    vmesh = MESHES[mesh]() if MESHES[mesh] is not None else None
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "device": device, "mesh": mesh, "note": note, "ok": False}
    t0 = time.time()
    try:
        if device == "meta":
            rec.update(analyse(cfg, shape, vmesh, **kw))
            chips = mesh_lib.CHIPS
            if vmesh is not None:
                chips = vmesh.size
                rec.update(per_device(rec, chips))
            rec["roofline"] = roofline_report(rec, cfg, shape, n_chips=chips)
        else:
            rec.update(_card_record(cfg, shape, kw, vmesh))
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["total_s"] = round(time.time() - t0, 1)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(out_dir, f"{arch}__{shape_name}.jsonl"), "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
    return rec


def _card_record(cfg, shape, kw, mesh) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("perf --device cuda: no CUDA device")
    B = min(CARD_BATCH[shape.kind], shape.global_batch)
    cut = dataclasses.replace(shape, global_batch=B)
    _, n_groups = cfg.layer_pattern()
    depth = []
    for n in (1, 2):
        c = depth_variant(cfg, n)
        d = analyse(c, cut, mesh, **kw)
        d.update(time_step(c, cut, mesh, **kw))
        depth.append(d)
    d1, d2 = depth
    rec = {"reduced": {"global_batch": [shape.global_batch, B],
                       "num_layers": [cfg.num_layers,
                                      [depth_variant(cfg, n).num_layers
                                       for n in (1, 2)]]},
           "card": torch.cuda.get_device_name(0), "depth": depth}
    for k in ("step_s", "hlo_flops"):
        rec[k] = extrap(d1[k], d2[k], n_groups)
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "saved_bytes"):
        if k in d1:
            rec[k] = int(extrap(d1[k], d2[k], n_groups))
    coll = {}
    for k, v in d1["collectives"].items():
        if k == "total_bytes":
            continue
        coll[k] = {n: int(extrap(v[n], d2["collectives"][k][n], n_groups))
                   for n in ("bytes", "count")}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    rec["collectives"] = coll
    if shape.kind == "decode":
        rec["donated_cache"] = True
    rec["roofline"] = roofline_report(rec, cfg, cut)
    rec["mfu"] = model_flops(cfg, cut) / (mesh_lib.PEAK_FLOPS * rec["step_s"])
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--device", default="meta", choices=("meta", "cuda"))
    ap.add_argument("--mesh", default=None, choices=list(MESHES),
                    help=f"default {META_MESH} on meta, {CARD_MESH} on cuda")
    ap.add_argument("--note", default="")
    args = ap.parse_args()
    rec = run_variant(args.arch, args.shape, args.variant, device=args.device,
                      mesh=args.mesh, note=args.note)
    if rec["ok"]:
        ro = rec["roofline"]
        line = (f"[OK] {args.arch} {args.shape} {args.variant} "
                f"({args.device}): compute={ro['compute_s'] * 1e3:.1f}ms "
                f"memory={ro['memory_s'] * 1e3:.1f}ms "
                f"collective={ro['collective_s'] * 1e3:.1f}ms "
                f"dominant={ro['dominant']} "
                f"coll_GB={rec['collectives']['total_bytes'] / 1e9:.1f}")
        if "mfu" in rec:
            line += (f" step={rec['step_s'] * 1e3:.1f}ms (full depth) "
                     f"mfu={rec['mfu']:.4f}")
        print(line)
    else:
        print(f"[FAIL] {rec.get('error')}\n{rec.get('traceback', '')[-1500:]}")


if __name__ == "__main__":
    main()
