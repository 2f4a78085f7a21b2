"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. build   — compile the hand-written CUDA kernels from
             ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
             parallel) into ``build/kernels/``;
2. kernels — call each kernel at the main paths' shapes, fp32 and bf16,
             hold it against its plain PyTorch version (tolerances below)
             and time it beside the plain version and a PyTorch library
             yardstick (none for the selective scan: no single PyTorch
             call computes one); the scan's backward also beside autograd
             through the plain forward, its time per step and its share
             of the exp and byte bounds printed; two bf16 ``moe_gmm`` runs
             and two scan backward runs must give the same bits (their
             sums use no float atomics);
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
             weights — identical greedy tokens, logits within 1e-4;
6. train   — ``make_train_step`` (via ``launch.train.build_trainer``) at
             full Falcon-Mamba-7B width (d_model 4096, d_inner 8192,
             state 16, dt_rank 512, vocab 65024, untied head; depth cut to
             8 of 64 layers), fp32 without TF32, B = 2, T = 2048 from
             ``train_batches``, 4 AdamW steps: loss, grad norm, ms per
             step, tokens/s, peak memory; it fails unless the scan's
             forward ran twice per layer and step and its backward once;
             then one more forward and
             backward under ``torch.profiler`` for the device time by
             kernel;
7. train-reference — reduced Falcon-Mamba in fp32, same weights: loss
             (1e-5 relative), every gradient leaf (1e-4 of its largest
             value) and the parameters after one AdamW step (2 x the
             step's learning rate: AdamW's first step moves each weight by
             lr * g / (|g| + eps), so only a near-zero gradient whose sign
             differs moves it differently) on the card against the CPU.

Kernel launch counts are set to 0 just before the serve, generate,
reference and train phases and read just after; each phase fails if its
kernel never ran. ``moe_gmm`` and ``flash_attention`` also count by variant
(``launches_by_variant``: ``tc`` on the tensor cores, ``simt`` on the CUDA
cores): the bf16 serve and generate phases fail unless the tensor-core
variants ran, the fp32 reference phase unless the CUDA-core ones did.
Output: the card's name and power limit (as nvidia-smi reports them),
per-phase lines, one JSON line of kernel figures, and as the last line
``{"ok": true, "device": {...}}``. It imports neither JAX nor ``repro``.

Tolerances (max |kernel - plain| <= rel * max |plain|): fp32 1e-4, because
the kernels sum over D = 4096 and F = 14336 (resp. the keys) in another
order than the library products of the plain versions; bf16 3e-2, because
bf16 rounds the gated intermediate (resp. the softmax weights) at a
different point. The selective scan (forward, and each of its six
gradients): fp32 1e-4, because the sums over N, T and d = 8192 run in
another order; bf16 1e-2, because the kernel and the plain version both
compute in fp32 from the same bf16 inputs and differ only in the final
rounding of each output (one bf16 ulp).
"""

from __future__ import annotations

import dataclasses
import json
import re
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
SLEEP_CYCLES_PER_S = 1.98e9  # torch.cuda._sleep counts SM clocks (boost)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SSM_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# exp results per second: 16 per clock per SM on the special function units
# (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``reps`` calls, CUDA events.
    The timed calls queue behind a sleep kernel that outlasts their host
    time (at most 50 ms of it), so a kernel shorter than its wrapper's
    Python is timed on the device, back to back, and not at the rate the
    host enqueues it."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * min(1.5 * host_s * reps, 0.05)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, want, dtype_name, rel=REL_TOL):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = rel[dtype_name] * scale
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} > tol {tol:.3e}")
    return err, tol


# moe_gmm at the serve phase's shapes: 8 expert slots of capacity 16384 at
# D = 4096, F = 14336. (label, C, fill per slot, max_fill): a 4-request
# decode step routes 8 rows, a 64-token prefill chunk 128, and one case
# fills every row of a smaller capacity.
# generate()'s prefill of 2 x 200 prompt tokens routes 800 rows (top-2)
# with max_fill 400; "decode-C8" is the decode step at a capacity of 8
# rows, the same weight stream without the 1 GiB of zero rows.
GMM_CASES = [
    ("decode", 16384, [1, 2, 0, 2, 1, 0, 1, 1], 4),
    ("decode-C8", 8, [1, 2, 0, 2, 1, 0, 1, 1], 4),
    ("chunk", 16384, [40, 12, 0, 30, 22, 8, 16, 0], 64),
    ("full-tile", 128, [128] * 8, 128),
    ("prefill", 16384, [130, 95, 88, 110, 70, 120, 102, 85], 400),
]
# flash attention at the generate phase's shapes, a long prompt, and the
# long prompt at Zamba2-2.7B's heads (hd 80: the mma.sync kernel; hd 64 and
# 128 take the wgmma one): (B, T, H, KVH, hd, window)
FLASH_CASES = [(2, 128, 32, 8, 128, 0), (2, 200, 32, 8, 128, 0),
               (2, 200, 32, 8, 128, 64), (1, 2048, 32, 8, 128, 0),
               (1, 2048, 32, 32, 80, 0)]


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
            variant = gmm.select_variant(dt, D, F)
            y = gmm.launch(x, w1, w3, w2, fl, m)
            torch.cuda.synchronize()
            want = gmm.plain(x, w1, w3, w2, fl, m)
            err, tol = check_close(f"moe_gmm {label} {dname}", y, want, dname)
            if bool(y[0, min(fill[0], m):].any()) or bool(y[2, fill[2]:].any()):
                raise AssertionError(f"moe_gmm {label}: rows past fill not 0")
            if dt == torch.bfloat16 and not torch.equal(
                    y, gmm.launch(x, w1, w3, w2, fl, m)):
                raise AssertionError(f"moe_gmm {label}: two runs differ")
            reps = 3 if label in ("full-tile", "prefill") else 10
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
                "variant": variant, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"kernels: moe_gmm {label:9s} {dname:8s} {variant:4s} "
                  f"S,C,D,F={S},{C},{D},{F} fill={fill} max_fill={m} "
                  f"err={err:.3e} (tol {tol:.3e}) "
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
            variant = fa.select_variant(dt, hd)
            o = fa.launch(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            want = fa.plain(q, k, v, causal=True, window=window)
            label = (f"B={B} T={T}" + (f" hd={hd}" if hd != 128 else "")
                     + (f" window={window}" if window else ""))
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
                "variant": variant, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"kernels: flash_attention {label:20s} {dname:8s} {variant:4s} "
                  f"B,T,H,KVH,hd={B},{T},{H},{KVH},{hd} err={err:.3e} "
                  f"(tol {tol:.3e}) kernel={ms:.3f}ms plain={plain_ms:.3f}ms "
                  f"sdpa={lib_ms:.3f}ms bound={max(t_bytes, t_ops):.4f}ms",
                  flush=True)


# the selective scan at the train phase's shapes, plus a ragged T:
# (label, B, T, d, N)
SSM_CASES = [("train", 2, 2048, 8192, 16), ("ragged", 2, 200, 8192, 16)]


def run_ssm_checks(results):
    """The scan's forward and backward kernels against ``plain`` /
    ``plain_bwd``; inputs drawn like Falcon-Mamba's at init (dt = softplus
    of about -4, A = -[1 .. N])."""
    from repro_torch.kernels import ssm_scan as ssm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for dname, dt_ in {"float32": torch.float32,
                       "bfloat16": torch.bfloat16}.items():
        elt = dt_.itemsize
        for label, B, T, d, N in SSM_CASES:
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device=dev) * scale

            x = rnd(B, T, d, scale=0.5).to(dt_)
            dt = Fn.softplus(rnd(B, T, d) - 4).to(dt_)
            Bs = rnd(B, T, N, scale=0.3).to(dt_)
            Cs = rnd(B, T, N, scale=0.3).to(dt_)
            A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32
                              ).expand(d, N) * torch.exp(rnd(d, 1, scale=0.1))
            A = A.contiguous()
            D = 1 + rnd(d, scale=0.1)
            dy = rnd(B, T, d).to(dt_)
            args = (x, dt, Bs, Cs, A, D)
            y, states = ssm.launch(*args, save_states=True)
            grads = ssm.launch_bwd(*args, dy, states)
            torch.cuda.synchronize()
            err_f, _ = check_close(f"ssm_scan {label} {dname}", y,
                                   ssm.plain(*args), dname, SSM_REL_TOL)
            want = ssm.plain_bwd(*args, dy)
            err_b = 0.0
            for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dD"),
                                  grads, want):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"ssm_scan_bwd {label}: {name} "
                                         "not finite")
                e, _ = check_close(f"ssm_scan_bwd {label} {dname} {name}", g,
                                   w, dname, SSM_REL_TOL)
                err_b = max(err_b, e)
            again = ssm.launch_bwd(*args, dy, states)
            for name, g, g2 in zip(("dx", "ddt", "dB", "dC", "dA", "dD"),
                                   grads, again):
                if not torch.equal(g, g2):
                    raise AssertionError(f"ssm_scan_bwd {label} {dname}: two "
                                         f"runs give different {name}")
            del want, grads, again
            reps = 2 if T > 1024 else 5
            ms_f = time_ms(lambda: ssm.launch(*args, save_states=True), 20)
            plain_f = time_ms(lambda: ssm.plain(*args), reps, warmup=1)
            ms_b = time_ms(lambda: ssm.launch_bwd(*args, dy, states), 10)
            part = torch.empty(ssm.partials_shape(B, T, d), device=dev)
            sum_ms = time_ms(lambda: part.sum(1), 10)
            del part
            plain_b = time_ms(lambda: ssm.plain_bwd(*args, dy), reps,
                              warmup=1)
            leaves = [a.detach().requires_grad_(True) for a in args]
            auto_b = time_ms(lambda: torch.autograd.grad(
                ssm.plain(*leaves), leaves, dy), reps, warmup=1)
            del leaves
            torch.cuda.empty_cache()
            exps = B * T * d * N  # a_t = exp(dt_t A), once each
            io_f = elt * (3 * B * T * d + 2 * B * T * N) + 4 * (d * N + d)
            io_b = elt * (5 * B * T * d + 4 * B * T * N) + 8 * (d * N + d)
            for kname, err, ms, plain_ms, io in (
                    ("ssm_scan", err_f, ms_f, plain_f, io_f),
                    ("ssm_scan_bwd", err_b, ms_b, plain_b, io_b)):
                t_bytes = io / HBM_BYTES_PER_S * 1e3
                t_ops = exps / SFU_PER_S * 1e3
                results.append({
                    "kernel": kname, "case": label, "dtype": dname,
                    "variant": "simt", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            fwd, bwd = results[-2], results[-1]
            t_exp = exps / SFU_PER_S * 1e3
            shares = {k: (ms * 1e3 / T, t_exp / ms,
                          io / HBM_BYTES_PER_S * 1e3 / ms)
                      for k, ms, io in (("fwd", ms_f, io_f),
                                        ("bwd", ms_b, io_b))}
            print(f"kernels: ssm_scan {label:6s} {dname:8s} B,T,d,N={B},{T},{d},"
                  f"{N} fwd err={err_f:.3e} kernel={ms_f:.3f}ms plain="
                  f"{plain_f:.3f}ms bound={fwd['bound_ms']:.4f}ms "
                  f"({fwd['bound_by']}) library_ms=null | bwd err={err_b:.3e} "
                  f"kernel={ms_b:.3f}ms plain_bwd={plain_b:.3f}ms "
                  f"autograd-through-plain={auto_b:.3f}ms "
                  f"bound={bwd['bound_ms']:.4f}ms ({bwd['bound_by']}) "
                  "library_ms=null (no PyTorch call computes a selective "
                  "scan); two backward runs identical", flush=True)
            print(f"kernels: ssm_scan {label:6s} {dname:8s} "
                  + "; ".join(f"{k} {us:.3f} us/step, exp bound / time "
                              f"{e:.1%}, byte bound / time {by:.1%}"
                              for k, (us, e, by) in shares.items())
                  + "; the bwd time is launch_bwd's: the kernel plus the "
                  f"wrapper's torch.sum over the {ssm.partials_shape(B, T, d)}"
                  f" fp32 partials ({sum_ms:.4f} ms alone) and over dA, dD",
                  flush=True)
            del x, dt, Bs, Cs, A, D, dy, y, states, args
            torch.cuda.empty_cache()


def reset_counts():
    """Every launch count of ``moe_gmm`` and ``flash_attention`` to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm

    for mod in (gmm, fa):
        mod.launches = 0
        for k in mod.launches_by_variant:
            mod.launches_by_variant[k] = 0


def read_counts():
    """(launches per kernel, launches per kernel and variant)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm

    return ({"moe_gmm": gmm.launches, "flash_attention": fa.launches},
            {"moe_gmm": dict(gmm.launches_by_variant),
             "flash_attention": dict(fa.launches_by_variant)})


def run_serve(cfg):
    """Phase 3. Returns (engine, prompts, launch counts)."""
    from repro_torch.data.pipeline import TaskTokenSource
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

    reset_counts()
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
    counts, variants = read_counts()
    toks = [h.result() for h in handles]
    if any(len(t) != 16 for t in toks):
        raise AssertionError(f"serve: token counts {[len(t) for t in toks]}")
    if not finite or not all(finite):
        raise AssertionError("serve: non-finite prefill logits")
    if variants["moe_gmm"]["tc"] <= 0:
        raise AssertionError("serve: the tensor-core moe_gmm never launched")
    runtime.check_invariants()
    p = runtime.perf_metrics()
    n_tok = sum(len(t) for t in toks)
    print(f"serve: {len(toks)} requests / {n_tok} tokens in {wall:.3f}s "
          f"({n_tok / wall:.1f} tok/s) ttft p50={p['ttft_ms']['p50']:.2f}ms "
          f"decode-round p50={p['decode_round_ms']['p50']:.2f}ms "
          f"p99={p['decode_round_ms']['p99']:.2f}ms "
          f"migrations={len(runtime.migrations)} "
          f"prefix_hits={runtime.prefix_hits} launches={counts} "
          f"by variant={variants}", flush=True)
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
    gmm_us = sum(t for n, t in by_name.items()
                 if re.search(r"gmm_|gate_reduce|down_reduce", n))
    flash_us = sum(t for n, t in by_name.items() if "flash_fwd" in n)
    print(f"profile: serve workload {wall_us / 1e3:.1f} ms wall, device busy "
          f"{busy / 1e3:.1f} ms ({busy / wall_us:.0%}), {len(spans)} device "
          f"events; moe_gmm kernels {gmm_us / 1e3:.1f} ms, flash_attention "
          f"{flash_us / 1e3:.1f} ms; top: "
          + "; ".join(f"{n[:60]} {t / 1e3:.1f} ms" for n, t in top), flush=True)


def run_generate(engine):
    """Phase 4: generate() on 2 x 200-token prompts; the runtime's tokens
    for the same prompts are printed beside it (bf16 flash prefill and the
    chunked paged prefill round differently, so they may differ)."""
    from repro_torch.data.pipeline import TaskTokenSource
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.runtime import ServingRuntime

    eng = ServingEngine(rt=engine.rt, params=engine.params,
                        placement=engine.placement,
                        dense_master=engine.dense_master, max_len=200 + 16 + 8)
    prompts = TaskTokenSource("generate", engine.rt.cfg.vocab_size,
                              seed=1).sample(2, 200)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, _ = eng.generate(prompts, steps=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = read_counts()
    for name in ("flash_attention", "moe_gmm"):
        if variants[name]["tc"] <= 0:
            raise AssertionError(f"generate: the tensor-core {name} never "
                                 "launched")
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
          f"launches={counts} by variant={variants}; runtime tokens agree "
          f"with generate on "
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
    reset_counts()
    lg, _, _ = eng._prefill(eng.params, prompts, eng.placement)
    lc, _, _ = cpu_eng._prefill(cpu_eng.params, prompts, cpu_eng.placement)
    err = float((lg.cpu() - lc).abs().max())
    scale = float(lc.abs().max())
    if not err <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"reference: logits differ by {err:.3e}")
    a, _ = eng.generate(prompts, steps=12)
    counts, variants = read_counts()
    b, _ = cpu_eng.generate(prompts, steps=12)
    if not np.array_equal(a, b):
        raise AssertionError("reference: card and CPU greedy tokens differ")
    for name in ("flash_attention", "moe_gmm"):
        if variants[name]["simt"] <= 0:
            raise AssertionError(f"reference: the CUDA-core {name} never "
                                 "launched in fp32")
    print(f"reference: {cfg.name} fp32, card vs CPU plain versions: logits "
          f"max err {err:.3e}, 3 x 12 greedy tokens identical; launches="
          f"{counts} by variant={variants}", flush=True)


def run_train():
    """Phase 6. Returns (ssm launch counts, per-step ms)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import train_batches
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), num_layers=8)
    B, T, steps = 2, 2048, 4
    t0 = time.perf_counter()
    batches = list(train_batches(cfg.vocab_size, B, T, steps))
    data_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt, params, state, step_fn = build_trainer(
        cfg, device="cuda", dtype=torch.float32, lr=3e-4, steps=steps)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"train: built {cfg.name} x{cfg.num_layers} layers (d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, state {cfg.ssm_state}, "
          f"dt_rank {cfg.d_inner // 16}, vocab {cfg.vocab_size}) = "
          f"{n_params / 1e9:.3f} B params fp32 in "
          f"{time.perf_counter() - t0:.1f}s; batches made in {data_s:.1f}s",
          flush=True)
    ssm.launches = 0
    ssm.bwd_launches = 0
    step_ms = []
    for i, (tok, tgt) in enumerate(batches):
        f0, b0 = ssm.launches, ssm.bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, tok, tgt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"train: step {i} loss {loss} grad norm {gnorm}")
        print(f"train: step {i} loss={loss:.5f} grad_norm={gnorm:.5f} "
              f"{step_ms[-1]:.1f} ms ssm launches fwd={ssm.launches - f0} "
              f"bwd={ssm.bwd_launches - b0}", flush=True)
    counts = {"ssm_scan": ssm.launches, "ssm_scan_bwd": ssm.bwd_launches}
    # per layer and step: the forward twice (once more when the checkpointed
    # group is recomputed for the backward), the backward once
    want = {"ssm_scan": 2 * cfg.num_layers * steps,
            "ssm_scan_bwd": cfg.num_layers * steps}
    if counts != want:
        raise AssertionError(f"train: ssm launches {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(step_ms[1:]))
    print(f"train: {steps} steps of {B}x{T} tokens, steady step (steps 1-3) "
          f"{steady:.1f} ms = {B * T / steady * 1e3:.0f} tokens/s, first step "
          f"{step_ms[0]:.1f} ms; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{counts}", flush=True)
    profile_train_step(rt, params, batches[0])
    return counts, step_ms


def profile_train_step(rt, params, batch):
    """One more forward and backward (no update) under ``torch.profiler``:
    device time by kernel, grouped into matrix products, the scan kernels
    and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.train_loop import loss_and_grads

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss_and_grads(rt, params, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
    if not by_name:
        print("train-profile: no device events recorded (not measured)")
        return
    total = sum(by_name.values())
    groups = {"gemm": 0.0, "ssm_fwd": 0.0, "ssm_bwd": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "ssm_fwd" in low:
            groups["ssm_fwd"] += ms
        elif "ssm_bwd" in low:
            groups["ssm_bwd"] += ms
        elif "gemm" in low or "sgemm" in low or "cutlass" in low:
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"train-profile: forward+backward {wall_ms:.1f} ms wall, device "
          f"kernels {total:.1f} ms: "
          + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})"
                      for k, v in groups.items())
          + "; top: " + "; ".join(f"{n[:50]} {t:.1f} ms" for n, t in top),
          flush=True)


def run_train_reference():
    """Phase 7: reduced Falcon-Mamba, fp32, one train step on the card
    against the CPU over the same weights (T = 200: ragged against the
    scan's 64-step chunks)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_and_grads

    cfg = get_config("falcon-mamba-7b").reduced()
    lr = 1e-2  # warmup of 10 steps: the first step's rate is 1e-3
    rt, params, state, step = build_trainer(cfg, device="cpu",
                                            dtype=torch.float32, lr=lr,
                                            steps=4, seed=3)
    grt = dataclasses.replace(rt, device="cuda")
    gparams = tree_map(lambda a: a.cuda(), params)
    gstate = {k: tree_map(lambda a: a.cuda(), state[k]) for k in ("m", "v")}
    gstate["step"] = state["step"]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 200))
    tgt = np.roll(tok, -1, 1)
    loss, _, grads = loss_and_grads(rt, params, tok, tgt)
    gloss, _, ggrads = loss_and_grads(grt, gparams, tok, tgt)
    rel = abs(float(gloss) - float(loss)) / abs(float(loss))
    if not rel <= 1e-5:
        raise AssertionError(f"train-reference: loss differs by {rel:.3e}")
    worst = 0.0
    for g, w in zip(tree_leaves(ggrads), tree_leaves(grads)):
        e = float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, e)
    if not worst <= 1e-4:
        raise AssertionError(f"train-reference: gradient differs by {worst:.3e}")
    step(params, state, tok, tgt)
    step(gparams, gstate, tok, tgt)
    dp = max(float((g.detach().cpu() - w.detach()).abs().max())
             for g, w in zip(tree_leaves(gparams), tree_leaves(params)))
    if not dp <= 2 * lr / 10:
        raise AssertionError(f"train-reference: parameters after one AdamW "
                             f"step differ by {dp:.3e}")
    print(f"train-reference: {cfg.name} fp32 2x200 tokens, card vs CPU: loss "
          f"rel err {rel:.3e}, worst gradient leaf {worst:.3e} of its max, "
          f"parameters after one AdamW step within {dp:.3e}", flush=True)


def ptxas_report(log: str) -> list:
    """One line per kernel from nvcc's ``-Xptxas=-v`` output: its name
    (demangled where ``c++filt`` exists), registers, shared memory and
    spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, timeout=10).stdout.strip()
            except (OSError, subprocess.SubprocessError):
                pass
            name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
            name = name.split("(")[0]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


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
        for line in ptxas_report(v["log"]):
            print(f"build: {name}: {line}")

    results: list = []
    run_kernel_checks(results)
    run_ssm_checks(results)

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=4)
    engine, prompts, serve_counts = run_serve(cfg)
    run_profile(engine, prompts)
    gen_counts = run_generate(engine)
    del engine
    torch.cuda.empty_cache()
    run_reference()
    train_counts, step_ms = run_train()
    run_train_reference()

    main_case = {"moe_gmm": ("decode", "bfloat16"),
                 "flash_attention": ("B=2 T=200", "bfloat16"),
                 "ssm_scan": ("train", "float32"),
                 "ssm_scan_bwd": ("train", "float32")}
    scan = "src/repro_torch/kernels/csrc/ssm_scan.cu"
    meta = {"moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                        "src/repro/kernels/moe_gmm.py:45"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:77"),
            "ssm_scan": (scan, "src/repro/kernels/ssm_scan.py:53"),
            "ssm_scan_bwd": (scan, "no Pallas backward (the forward at "
                             "src/repro/kernels/ssm_scan.py:53 has none)")}
    launches = {n: serve_counts.get(n, 0) + gen_counts.get(n, 0)
                for n in ("moe_gmm", "flash_attention")}
    launches.update(train_counts)
    sel = {name: next(x for x in results if x["kernel"] == name
                      and x["case"] == case and x["dtype"] == dname)
           for name, (case, dname) in main_case.items()}
    scan_ms = (sel["ssm_scan"]["ms"] * train_counts["ssm_scan"]
               + sel["ssm_scan_bwd"]["ms"] * train_counts["ssm_scan_bwd"])
    print(f"train: the scan kernels' share of the steady step: "
          f"{scan_ms / len(step_ms):.2f} ms of {np.mean(step_ms[1:]):.1f} ms "
          f"({scan_ms / len(step_ms) / np.mean(step_ms[1:]):.2%}; kernel "
          "times from the kernels phase x launches per step)", flush=True)
    kernels = []
    for name, r in sel.items():
        kernels.append({
            "name": name, "route": "cuda", "variant": r["variant"],
            "source": meta[name][0], "replaces": meta[name][1],
            "launches": launches[name],
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
