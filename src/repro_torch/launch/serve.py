"""Serving launcher of the PyTorch port: continuous-batching runtime for a
selected architecture (the reduced variant unless ``--full``), with the
placement control plane active for MoE architectures. Mirrors
``repro.launch.serve``, plus ``--device`` and ``--dtype``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --device cpu

Requests are submitted as a stream and served by ``ServingRuntime``:
chunked prefill interleaved with decode rounds over a paged KV block pool
(``--block-size`` / ``--blocks``; ``--dense-pool`` restores the fixed-row
pool), with the ``--policy`` placement policy reviewed periodically by the
``PlacementController`` (Eq.-4 adopt decision). On the CUDA device the MoE
expert FFN and prefill attention run the hand-written kernels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core.migration import CostModel
from repro_torch.core.policies import (ClusterView, PlacementController,
                                       get_policy, list_policies)
from repro_torch.data.pipeline import TaskTokenSource
from repro_torch.models import moe as M
from repro_torch.models import transformer as tr
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.obs import Tracer
from repro_torch.serving.runtime import ServingRuntime

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_engine(cfg, *, device: str, dtype, max_len: int, policy: str,
                 review_rounds: int, seed: int = 0, n_ep: int = 1,
                 slots: int | None = None):
    """Engine (+ placement controller for MoE configs) at the launcher's
    geometry: capacity 8192 and slot capacity 16384, random weights from
    ``seed``, experts laid out uniformly over ``n_ep`` virtual EP ranks (one
    per edge server) of ``slots`` slots each. The defaults give one rank
    holding every expert; with ``n_ep > 1`` ``slots`` defaults to
    ``EPSpec.build``'s. Returns (engine, controller or None)."""
    controller = None
    if cfg.is_moe:
        if slots is None and n_ep == 1:
            slots = cfg.num_experts
        spec = M.EPSpec.build(n_ep, cfg, slots=slots, capacity=8192,
                              slot_capacity=16384)
        rt = tr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec, dtype=dtype,
                        device=device)
        pl = M.uniform_placement(spec.n_ep, spec.slots, cfg.num_experts)
        _, n_groups = cfg.layer_pattern()
        pls = tr.stack_placement(pl, n_groups)
        cm = CostModel(expert_bytes=3 * cfg.d_model * cfg.d_ff * 2,
                       activation_bytes=cfg.d_model * 2, bandwidth=62.5e6,
                       tokens_per_horizon=1e5)
        controller = PlacementController(
            policy=get_policy(policy), cost=cm,
            cluster=ClusterView.from_ep_spec(spec, n_groups),
            interval=review_rounds)
        # dense master copy: live migration re-gathers expert slots from it.
        # It carries the EP spec for the attention heads' padding to a
        # multiple of the rank count, as the reference's mesh pads them.
        rt_dense = tr.Runtime(cfg=cfg, moe_impl="dense", ep_spec=spec,
                              dtype=dtype, device=device)
        params_dense = tr.init_params(rt_dense, seed)
        params = dict(params_dense)
        params["groups"] = M.regather_ep_groups(params_dense["groups"], pls,
                                                n_groups)
        dense_master = params_dense["groups"]
    else:
        rt = tr.Runtime(cfg=cfg, dtype=dtype, device=device)
        pls = None
        params = tr.init_params(rt, seed)
        dense_master = None
    engine = ServingEngine(rt=rt, params=params, placement=pls,
                           dense_master=dense_master, max_len=max_len)
    return engine, controller


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(list_configs()))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (dense mode: also the KV rows)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV pool: positions per physical block")
    ap.add_argument("--blocks", type=int, default=None,
                    help="paged KV pool: physical blocks incl. the null "
                    "block (default: match the dense pool's KV memory)")
    ap.add_argument("--dense-pool", action="store_true",
                    help="dense per-slot KV pool (no paging / chunked "
                    "prefill)")
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="radix prefix cache: reuse KV pages across "
                    "requests sharing a prompt prefix (paged pool only; "
                    "--no-prefix-cache disables)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt shared by all requests "
                    "(demonstrates prefix-cache hits; 0 = disjoint prompts)")
    ap.add_argument("--policy", default="dancemoe", choices=list_policies())
    ap.add_argument("--review-rounds", type=int, default=16,
                    help="placement review period in decode rounds")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-request/system spans and export the "
                    "Chrome-trace JSON here")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    if args.shared_prefix and args.shared_prefix >= args.prompt:
        ap.error(f"--shared-prefix ({args.shared_prefix}) must be smaller "
                 f"than --prompt ({args.prompt}): the shared system prompt "
                 "is part of the per-request prompt budget")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run the plain versions on the CPU)")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    engine, controller = build_engine(
        cfg, device=args.device, dtype=DTYPES[args.dtype],
        max_len=args.prompt + args.steps + 8, policy=args.policy,
        review_rounds=args.review_rounds)
    tracer = Tracer(clock="ticks") if args.trace_out else None
    if controller is not None and tracer is not None:
        controller.tracer = tracer          # PLACEMENT_REVIEW decisions
    runtime = ServingRuntime(engine, max_slots=args.slots,
                             controller=controller,
                             paged=False if args.dense_pool else None,
                             block_size=args.block_size,
                             n_blocks=args.blocks,
                             prefix_cache=args.prefix_cache,
                             tracer=tracer)
    src = TaskTokenSource("serve", cfg.vocab_size, seed=0)
    if cfg.frontend != "none":
        print(f"{cfg.name}: modality frontend is stubbed; serving over "
              "token prompts against the decoder backbone")
    shared = (src.sample(1, args.shared_prefix)[0]
              if args.shared_prefix else None)
    t0 = time.time()
    handles = []
    for _ in range(args.requests):
        tail = src.sample(1, max(args.prompt - args.shared_prefix, 1))[0]
        prompt = tail if shared is None else np.concatenate([shared, tail])
        handles.append(runtime.enqueue(Request(prompt=prompt,
                                               max_new_tokens=args.steps)))
    runtime.run()
    dt = time.time() - t0
    n_tok = sum(len(h.result()) for h in handles)
    pool = (f"paged[{runtime.allocator.n_blocks}x{runtime.block_size}]"
            if runtime.paged else f"dense[{args.slots}x{engine.max_len}]")
    cache = ("off" if runtime.prefix_cache is None else
             f"hit_rate={runtime.prefix_hit_rate:.2f} "
             f"tokens_skipped={runtime.prefix_tokens_skipped} "
             f"cow={runtime.cow_copies}")
    p = runtime.perf_metrics()
    print(f"{cfg.name} [{args.device} {args.dtype}]: served {len(handles)} "
          f"requests / {n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s) "
          f"pool={pool} peak_batch={runtime.max_concurrency} "
          f"peak_admitted={runtime.max_admitted} "
          f"deferrals={runtime.deferrals} "
          f"prefix_cache[{cache}] "
          f"migrations={len(runtime.migrations)} "
          f"decode_round_ms p50={p['decode_round_ms']['p50']:.2f} "
          f"p99={p['decode_round_ms']['p99']:.2f} "
          f"ttft_ms p50={p['ttft_ms']['p50']:.2f}")
    if tracer is not None:
        obs = tracer.summary()
        tracer.export(args.trace_out)
        print(f"trace: {obs['events']} spans "
              f"(dropped={obs['dropped_events']}, "
              f"overhead={obs['overhead_ms']:.2f}ms) -> {args.trace_out}")


if __name__ == "__main__":
    main()
