"""Roofline analysis of one step on one H100 (PyTorch port of
``repro.launch.roofline``). Three terms per (arch x shape), in seconds per
step:

  compute    = counted FLOPs / peak bf16 FLOP/s
  memory     = structural bytes (arguments x passes + outputs) / HBM rate
  collective = collective bytes / (HBM rate / 2)

The FLOPs are those of the aten matmul ops (mm, bmm, addmm, baddbmm,
convolution, attention) the port's step dispatches, counted by
``torch.utils.flop_counter.FlopCounterMode`` on ``meta`` tensors
(``count_step``); elementwise work is not counted. The collective bytes
are ``models.moe``'s counters of its virtual-rank exchanges.

Not ported: ``collective_bytes_from_hlo`` and the ``hlo_bytes`` it feeds
(``memory_s_hlo``). The port compiles no HLO to parse, and torch counts no
bytes accessed; ``memory_s_hlo`` stays ``None``.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as moe_mod


def model_flops(cfg, shape) -> float:
    """6·N_active·D per processed token (2·N·D for pure inference steps)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq


def roofline_report(rec: dict, cfg, shape, *, n_chips: int = 1) -> dict:
    """Three-term roofline, per device per step, with the reference's keys.

    compute_s    — counted FLOPs / peak.
    memory_s     — structural HBM traffic: argument bytes (weights +
                   optimizer state + KV cache) x passes + outputs (less
                   the arguments when the cache is written in place).
    collective_s — counted collective bytes / ``mesh.COLLECTIVE_BW``.
    """
    compute_t = rec["hlo_flops"] / mesh_lib.PEAK_FLOPS
    passes = 3.0 if shape.kind == "train" else 1.0
    out_bytes = rec.get("output_size_in_bytes", 0)
    if rec.get("donated_cache"):
        out_bytes = max(out_bytes - rec.get("argument_size_in_bytes", 0), 0)
    struct_bytes = passes * rec.get("argument_size_in_bytes", 0) + out_bytes
    memory_t = struct_bytes / mesh_lib.HBM_BW
    collective_t = rec["collectives"]["total_bytes"] / mesh_lib.COLLECTIVE_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": collective_t}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / max(rec["hlo_flops"] * n_chips, 1.0)
    return {
        **terms,
        "memory_s_hlo": None,
        "dominant": dominant.removesuffix("_s"),
        "model_flops_global": mf,
        "useful_flops_ratio": useful,
        "step_time_lower_bound_s": max(terms.values()),
        "mfu_bound": mf / max(n_chips * mesh_lib.PEAK_FLOPS
                              * max(terms.values()), 1e-30),
    }


def count_step(fn, kwargs) -> dict:
    """Run ``fn(**kwargs)`` on ``meta`` tensors (``ops.shape_only``) under
    ``FlopCounterMode``: the counterpart of the reference's
    ``dryrun._analyse`` of a compiled step. Returns ``{"flops": counted
    FLOPs, "collectives": the collectives it ran, in the reference's form,
    "outputs": what ``fn`` returned}``."""
    before = moe_mod.collective_counts()
    with ops.shape_only(), FlopCounterMode(display=False) as fc:
        outputs = fn(**kwargs)
    after = moe_mod.collective_counts()
    coll = {k: {n: after[k][n] - before[k][n] for n in ("bytes", "count")}
            for k in after if k != "total_bytes"}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    return {"flops": float(fc.get_total_flops()), "collectives": coll,
            "outputs": outputs}
