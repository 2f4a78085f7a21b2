"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. build   — compile the hand-written CUDA kernels from
             ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
             parallel) into ``build/kernels/``;
2. kernels — call each kernel at the main path's shapes, fp32 and bf16,
             hold it against its plain PyTorch version (tolerances below)
             and time it beside the plain version and a PyTorch library
             yardstick;
3. serve   — ``ServingRuntime`` at full Mixtral-8x7B width (depth cut to
             4 layers, bf16, random weights from a seed): paged KV pool
             with the radix prefix cache, the DanceMoE placement
             controller, 4 greedy requests of 32 prompt tokens (16 shared)
             and 16 new tokens each; then the same workload once more
             under ``torch.profiler`` for the device's busy share;
4. generate — ``ServingEngine.generate`` on 2 prompts of 200 tokens at the
             same width (the flash-attention prefill path);
5. reference — the reduced Mixtral config in fp32: the port on the card
             (kernels) against the port on the CPU (plain versions), same
             weights — identical greedy tokens, logits within 1e-4.

Kernel launch counts are set to 0 just before the serve and generate
phases and read just after; each phase fails if its kernel never ran.
Output: the card's name and power limit (as nvidia-smi reports them),
per-phase lines, one JSON line of kernel figures, and as the last line
``{"ok": true, "device": {...}}``. It imports neither JAX nor ``repro``.

Tolerances (max |kernel - plain| <= rel * max |plain|): fp32 1e-4, because
the kernels sum over D = 4096 and F = 14336 (resp. the keys) in another
order than the library products of the plain versions; bf16 3e-2, because
bf16 rounds the gated intermediate (resp. the softmax weights) at a
different point.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as Fn

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, want, dtype_name):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = REL_TOL[dtype_name] * scale
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} > tol {tol:.3e}")
    return err, tol


# moe_gmm at the serve phase's shapes: 8 expert slots of capacity 16384 at
# D = 4096, F = 14336. (label, C, fill per slot, max_fill): a 4-request
# decode step routes 8 rows, a 64-token prefill chunk 128, and one case
# fills every row of a smaller capacity.
GMM_CASES = [
    ("decode", 16384, [1, 2, 0, 2, 1, 0, 1, 1], 4),
    ("chunk", 16384, [40, 12, 0, 30, 22, 8, 16, 0], 64),
    ("full-tile", 128, [128] * 8, 128),
]
# flash attention at the generate phase's shapes: (B, T, H, KVH, hd, window)
FLASH_CASES = [(2, 128, 32, 8, 128, 0), (2, 200, 32, 8, 128, 0),
               (2, 200, 32, 8, 128, 64)]


def run_kernel_checks(results):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def gmm_library(x, w1, w3, w2, m):
        xs = x[:, :m]
        mid = (Fn.silu(torch.bmm(xs, w1).float())
               * torch.bmm(xs, w3).float()).to(x.dtype)
        y = torch.zeros_like(x)
        y[:, :m] = torch.bmm(mid, w2)
        return y

    for dname, dt in dtypes.items():
        elt = torch.finfo(dt).bits // 8
        w1 = (torch.randn(8, 4096, 14336, generator=gen, device=dev)
              / 64.0).to(dt)
        w3 = (torch.randn(8, 4096, 14336, generator=gen, device=dev)
              / 64.0).to(dt)
        w2 = (torch.randn(8, 14336, 4096, generator=gen, device=dev)
              / 14336**0.5).to(dt)
        S, D, F = w1.shape
        for label, C, fill, m in GMM_CASES:
            x = torch.zeros((S, C, D), dtype=dt, device=dev)
            for s, n in enumerate(fill):
                x[s, :n] = torch.randn(n, D, generator=gen, device=dev).to(dt)
            fl = torch.tensor(fill, dtype=torch.int32, device=dev)
            y = gmm.launch(x, w1, w3, w2, fl, m)
            torch.cuda.synchronize()
            want = gmm.plain(x, w1, w3, w2, fl, m)
            err, tol = check_close(f"moe_gmm {label} {dname}", y, want, dname)
            if bool(y[0, fill[0]:].any()) or bool(y[2, fill[2]:].any()):
                raise AssertionError(f"moe_gmm {label}: rows past fill not 0")
            reps = 3 if label == "full-tile" else 10
            ms = time_ms(lambda: gmm.launch(x, w1, w3, w2, fl, m), reps)
            plain_ms = time_ms(lambda: gmm.plain(x, w1, w3, w2, fl, m),
                               reps)
            lib_ms = time_ms(lambda: gmm_library(x, w1, w3, w2, m), reps)
            filled = sum(min(n, m, C) for n in fill)
            occupied = sum(1 for n in fill if min(n, m) > 0)
            nbytes = (occupied * 3 * D * F * elt + filled * D * elt
                      + S * C * D * elt + 4 * S)
            flops = 6 * D * F * filled
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            results.append({
                "kernel": "moe_gmm", "case": label, "dtype": dname,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"kernels: moe_gmm {label:9s} {dname:8s} S,C,D,F={S},{C},{D},"
                  f"{F} fill={fill} err={err:.3e} (tol {tol:.3e}) "
                  f"kernel={ms:.3f}ms plain={plain_ms:.3f}ms "
                  f"bmm-chain={lib_ms:.3f}ms bound={max(t_bytes, t_ops):.3f}ms",
                  flush=True)
            del x, y, want
        del w1, w3, w2
        torch.cuda.empty_cache()

        for B, T, H, KVH, hd, window in FLASH_CASES:
            q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
            k = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(dt)
            v = torch.randn(B, T, KVH, hd, generator=gen, device=dev).to(dt)
            o = fa.launch(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            want = fa.plain(q, k, v, causal=True, window=window)
            label = f"T={T}" + (f" window={window}" if window else "")
            err, tol = check_close(f"flash_attention {label} {dname}", o,
                                   want, dname)
            qp = torch.arange(T, device=dev)[:, None]
            kp = torch.arange(T, device=dev)[None, :]
            mask = kp <= qp
            if window:
                mask &= kp > qp - window
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

            def sdpa():
                return Fn.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask if window else None,
                    is_causal=not window, enable_gqa=True)

            ms = time_ms(lambda: fa.launch(q, k, v, causal=True,
                                                  window=window), 20)
            plain_ms = time_ms(lambda: fa.plain(q, k, v, causal=True,
                                                       window=window), 20)
            lib_ms = time_ms(sdpa, 20)
            pairs = int(mask.sum())
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * dt.itemsize
            flops = 4 * B * H * hd * pairs
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            results.append({
                "kernel": "flash_attention", "case": label, "dtype": dname,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"kernels: flash_attention {label:16s} {dname:8s} "
                  f"B,T,H,KVH,hd={B},{T},{H},{KVH},{hd} err={err:.3e} "
                  f"(tol {tol:.3e}) kernel={ms:.3f}ms plain={plain_ms:.3f}ms "
                  f"sdpa={lib_ms:.3f}ms bound={max(t_bytes, t_ops):.4f}ms",
                  flush=True)


def run_serve(cfg):
    """Phase 3. Returns (engine, prompts, launch counts)."""
    from repro_torch.data.pipeline import TaskTokenSource
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    t0 = time.perf_counter()
    engine, controller = build_engine(cfg, device="cuda", dtype=torch.bfloat16,
                                      max_len=32 + 16 + 8, policy="dancemoe",
                                      review_rounds=8)
    torch.cuda.synchronize()
    print(f"serve: built {cfg.name} x{cfg.num_layers} layers (d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_experts} experts top-"
          f"{cfg.top_k}, {cfg.num_heads}/{cfg.num_kv_heads} heads) in "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    runtime = ServingRuntime(engine, max_slots=4, controller=controller,
                             block_size=16, prefix_cache=True)
    finite = []
    chunk_fn = runtime._chunk_fn

    def checked_chunk(*args):
        out = chunk_fn(*args)
        finite.append(bool(torch.isfinite(out[2]).all()))
        return out

    runtime._chunk_fn = checked_chunk
    src = TaskTokenSource("serve", cfg.vocab_size, seed=0)
    shared = src.sample(1, 16)[0]
    prompts = [np.concatenate([shared, src.sample(1, 16)[0]]) for _ in range(4)]

    gmm.launches = 0
    fa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [runtime.enqueue(Request(prompt=prompts[0], max_new_tokens=16))]
    runtime.step()
    runtime.step()  # the shared prefix is in the radix cache from here on
    handles += [runtime.enqueue(Request(prompt=p, max_new_tokens=16))
                for p in prompts[1:]]
    runtime.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"moe_gmm": gmm.launches, "flash_attention": fa.launches}
    toks = [h.result() for h in handles]
    if any(len(t) != 16 for t in toks):
        raise AssertionError(f"serve: token counts {[len(t) for t in toks]}")
    if not finite or not all(finite):
        raise AssertionError("serve: non-finite prefill logits")
    if counts["moe_gmm"] <= 0:
        raise AssertionError("serve: moe_gmm never launched")
    runtime.check_invariants()
    p = runtime.perf_metrics()
    n_tok = sum(len(t) for t in toks)
    print(f"serve: {len(toks)} requests / {n_tok} tokens in {wall:.3f}s "
          f"({n_tok / wall:.1f} tok/s) ttft p50={p['ttft_ms']['p50']:.2f}ms "
          f"decode-round p50={p['decode_round_ms']['p50']:.2f}ms "
          f"p99={p['decode_round_ms']['p99']:.2f}ms "
          f"migrations={len(runtime.migrations)} "
          f"prefix_hits={runtime.prefix_hits} launches={counts}", flush=True)
    return engine, prompts, counts


def run_profile(engine, prompts):
    """Phase 3b: the serve workload once more (fresh runtime, no placement
    controller) under ``torch.profiler``: the device's busy share of the
    wall time (union of kernel / memcpy / memset intervals) and the
    kernels that take most of it. The profiler's own host cost inflates
    the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    rt = ServingRuntime(engine, max_slots=4, block_size=16, prefix_cache=True)
    handles = [rt.enqueue(Request(prompt=prompts[0], max_new_tokens=16))]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.step()
        rt.step()
        handles += [rt.enqueue(Request(prompt=p, max_new_tokens=16))
                    for p in prompts[1:]]
        rt.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print("profile: no device events recorded (busy share not measured)")
        return
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_name: dict = {}
    for s0, e0, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile: serve workload {wall_us / 1e3:.1f} ms wall, device busy "
          f"{busy / 1e3:.1f} ms ({busy / wall_us:.0%}), {len(spans)} device "
          "events; top: "
          + "; ".join(f"{n[:60]} {t / 1e3:.1f} ms" for n, t in top), flush=True)


def run_generate(engine):
    """Phase 4: generate() on 2 x 200-token prompts; the runtime's tokens
    for the same prompts are printed beside it (bf16 flash prefill and the
    chunked paged prefill round differently, so they may differ)."""
    from repro_torch.data.pipeline import TaskTokenSource
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.runtime import ServingRuntime

    eng = ServingEngine(rt=engine.rt, params=engine.params,
                        placement=engine.placement,
                        dense_master=engine.dense_master, max_len=200 + 16 + 8)
    prompts = TaskTokenSource("generate", engine.rt.cfg.vocab_size,
                              seed=1).sample(2, 200)
    gmm.launches = 0
    fa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, _ = eng.generate(prompts, steps=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"moe_gmm": gmm.launches, "flash_attention": fa.launches}
    if counts["flash_attention"] <= 0:
        raise AssertionError("generate: flash_attention never launched")
    if gen.shape != (2, 16):
        raise AssertionError(f"generate: shape {gen.shape}")
    logits, _, _ = eng._prefill(eng.params, prompts, eng.placement)
    if tuple(logits.shape) != (2, eng.rt.cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("generate: bad prefill logits")
    rt = ServingRuntime(eng, max_slots=2, block_size=16, prefix_cache=False)
    hs = [rt.enqueue(Request(prompt=p, max_new_tokens=16)) for p in prompts]
    rt.run()
    agree = float(np.mean([np.mean(h.result() == g) for h, g in zip(hs, gen)]))
    print(f"generate: 2 x 200-token prompts, 16 steps in {wall:.3f}s "
          f"launches={counts}; runtime tokens agree with generate on "
          f"{agree:.0%} (printed only: the random weights give nearly flat "
          "logits, so the bf16 rounding differences between flash prefill "
          "and chunked paged prefill flip greedy tokens)", flush=True)
    return counts


def run_reference():
    """Phase 5: small model, fp32, port on the card vs port on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("mixtral-8x7b").reduced()
    eng, _ = build_engine(cfg, device="cuda", dtype=torch.float32, max_len=48,
                          policy="dancemoe", review_rounds=8, seed=5)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.cpu()

    cpu_rt = dataclasses.replace(eng.rt, device="cpu")
    cpu_eng = ServingEngine(rt=cpu_rt, params=cpu(eng.params),
                            placement=type(eng.placement)(
                                *(a.cpu() for a in eng.placement)),
                            max_len=48)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 21))
    lg, _, _ = eng._prefill(eng.params, prompts, eng.placement)
    lc, _, _ = cpu_eng._prefill(cpu_eng.params, prompts, cpu_eng.placement)
    err = float((lg.cpu() - lc).abs().max())
    scale = float(lc.abs().max())
    if not err <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"reference: logits differ by {err:.3e}")
    a, _ = eng.generate(prompts, steps=12)
    b, _ = cpu_eng.generate(prompts, steps=12)
    if not np.array_equal(a, b):
        raise AssertionError("reference: card and CPU greedy tokens differ")
    print(f"reference: {cfg.name} fp32, card vs CPU plain versions: logits "
          f"max err {err:.3e}, 3 x 12 greedy tokens identical", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    info = build.build_all()
    print(f"build: {', '.join(info)} in {time.perf_counter() - t0:.1f}s "
          f"(cached: {[n for n, v in info.items() if v['cached']]})", flush=True)
    for name, v in info.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    results: list = []
    run_kernel_checks(results)

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=4)
    engine, prompts, serve_counts = run_serve(cfg)
    run_profile(engine, prompts)
    gen_counts = run_generate(engine)
    del engine
    torch.cuda.empty_cache()
    run_reference()

    main_case = {"moe_gmm": ("decode", "bfloat16"),
                 "flash_attention": ("T=200", "bfloat16")}
    meta = {"moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                        "src/repro/kernels/moe_gmm.py:45"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:77")}
    kernels = []
    for name, (case, dname) in main_case.items():
        r = next(x for x in results if x["kernel"] == name
                 and x["case"] == case and x["dtype"] == dname)
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": serve_counts[name] + gen_counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
