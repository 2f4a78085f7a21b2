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
             sums use no float atomics); every bf16 ``moe_gmm`` row runs
             both forward designs (``stream``, ``rows``; the one
             ``select_design`` does not pick forced), each checked and
             timed, and past 128 rows a slot also a ``torch.mm`` chain
             over exactly the filled rows; then the flash-attention and
             ``moe_gmm`` backward kernels against ``plain_bwd`` (autograd
             through the plain forward) in fp32 and bf16 — flash at the
             Mixtral train shape (B = 2, T = 2048, 32/8 heads, hd 128,
             causal), at hd 80 with GQA, under a window shorter than T and
             at a ragged T; ``moe_gmm`` at the EP train step's shapes
             (ragged fills, one slot empty, max_fill < C) — each twice,
             bit for bit, timed beside its bound and, at the train shapes,
             beside autograd through the plain version and the library's
             backward (SDPA's; the bmm chain's);
3. serve   — ``ServingRuntime`` at full Mixtral-8x7B width (depth cut to
             4 layers, bf16, random weights from a seed): paged KV pool
             with the radix prefix cache, the DanceMoE placement
             controller, 4 greedy requests of 32 prompt tokens (16 shared)
             and 16 new tokens each, on the synchronous loop; then the
             same requests on the same engine through the warmed
             zero-stall loop (``warmup=True``: the 7-graph CUDA-graph
             ladder of 4 slots, untagged, and a fresh DanceMoE controller
             reviewing every 8 rounds, so that a migration lands in place
             under replay): it fails unless its tokens equal the
             synchronous ones, the ladder has 7 graphs, no round ran
             eagerly, the tensor-core ``moe_gmm`` ran through replays and
             a migration happened; then a prompt that is not
             block-aligned, twice on each loop (the second request a
             full prefix hit whose shared tail block is cloned, through
             the captured clone on the warmed loop): it fails unless
             each loop cloned a block, no round ran eagerly and the
             tokens agree; then each loop once more under ``torch.profiler``
             for the device's busy share (the warmed rerun replays the
             first one's graphs);
4. generate — ``ServingEngine.generate`` on 2 prompts of 200 tokens at the
             same width (the flash-attention prefill path);
4a. variants — on the serve phase's weights: the dense slot pool at
             Mixtral's 8192-token sliding window (a ring of 8192 positions
             per slot), two prompts of 8448 and 8320 tokens, each
             prefilled alone, 32 new tokens each (the ring wraps): it
             fails unless flash attention launched with the window at
             T > window and both requests finished; the serve phase's
             requests on an int8 paged KV pool, on the synchronous and the
             warmed loop: it fails unless the pool holds int8, the tokens
             agree and no round ran eagerly (the pool's bytes printed
             beside bf16's); the same requests at temperature 0.8, each
             with its own seed, on the synchronous loop and twice on the
             warmed one: it fails unless all three agree and differ from
             the greedy tokens;
4b. cluster — ``EdgeCluster("runtime")`` at the same width: three edge
             servers as three virtual EP ranks of 4 slots each (12 per
             layer), a DanceMoE controller with a live review at tick 4
             and staged migration over a 3-server topology, 12 greedy
             requests (32 prompt tokens, 16 new) with origins round-robin,
             server 2 crashing at tick 8 with failover on; it fails unless
             every request finishes with 16 tokens, the crash caught a
             victim, the faults section reads 1 injected, 1 recovered, 0
             dropped, a fault review re-placed the experts and the recovery
             placement landed, the KV pool's invariants hold and it drains
             to all-free; then the same schedule on an engine rebuilt from
             the same seed, under ``torch.profiler``, must give the same
             tokens, events, controller decisions, faults section and
             activation counts; then twice more, each on a rebuilt engine,
             through the warmed loop (``runtime_opts={"warmup": True,
             "warmup_origins": "tagged"}``: 11 graphs at 12 slots): the
             same checks, the synchronous run's tokens and victims, no
             eager round, and the two warmed runs (the second under the
             profiler) identical in tokens, events and faults; then the
             sim backend serves the same requests;
4c. cluster-reference — the same scenario on the reduced Mixtral config in
             fp32: the cluster on the card (kernels) against the cluster on
             the CPU (plain versions), same weights — identical tokens,
             events, controller decisions, faults section and counts;
4d. ssm-serve — Falcon-Mamba-7B (64 layers) and Zamba2-2.7B (54 layers) at
             full published width and depth, bf16, through
             ``ServingRuntime`` (the dense slot pool), 4 requests of 32
             prompt tokens and 16 new each: it fails unless every request
             finished and, for Zamba2, flash attention ran;
5. reference — the reduced Mixtral config in fp32: the port on the card
             (kernels) against the port on the CPU (plain versions), same
             weights — identical greedy tokens, logits within 1e-4; then
             the serving variants the same way (windowed Mixtral through
             the dense pool, int8 and sampled Mixtral on both loops,
             Falcon-Mamba and Zamba2 through the runtime): identical token
             streams, prefill logits within 1e-4, and the threefry keys,
             bits and uniforms on the card equal to the CPU's;
6. train   — ``make_train_step`` (via ``launch.train.build_trainer``) at
             full Falcon-Mamba-7B width (d_model 4096, d_inner 8192,
             state 16, dt_rank 512, vocab 65024, untied head; depth cut to
             8 of 64 layers), fp32 without TF32, B = 2, T = 2048 from
             ``train_batches``, 4 AdamW steps: loss, grad norm, ms per
             step, tokens/s, peak memory; it fails unless the scan's
             forward ran twice per layer and step and its backward once;
             then one more forward and
             backward under ``torch.profiler`` for the device time by
             kernel; then Mixtral-8x7B at full published width (d_model
             4096, 32/8 heads of 128, d_ff 14336, 8 experts top-2, vocab
             32000; depth cut to 2 of 32 layers), bf16 parameters with
             fp32 AdamW moments, dense MoE, B = 2, T = 2048, 4 steps: it
             fails unless loss and grad norm are finite and each step ran
             the flash forward twice per layer and its backward once; then
             one EP train step (one rank holding the 8 experts, the serve
             phase's capacities, B = 1, T = 2048): it fails unless the
             tensor-core ``moe_gmm`` forward ran twice per layer, on the
             row-tile design, and its backward once;
7. train-reference — reduced Falcon-Mamba, then reduced dense Mixtral,
             EP Mixtral over 3 virtual ranks and Zamba2 (shared attention),
             in fp32, same weights: loss
             (1e-5 relative), every gradient leaf (1e-4 of its largest
             value) and the parameters after one AdamW step (2 x the
             step's learning rate: AdamW's first step moves each weight by
             lr * g / (|g| + eps), so only a near-zero gradient whose sign
             differs moves it differently) on the card against the CPU;
8. launch  — the launch tooling (``repro_torch.launch.{dryrun,perf,
             roofline,mesh}``): ``dryrun.run_one`` for all 40 (assigned
             arch x input shape) pairs at full size on ``meta`` tensors,
             in spawned processes, one line a pair (the H100 roofline's
             compute, memory and collective seconds, the dominant term,
             the argument bytes against the card's 80 GiB); meanwhile the
             card leg, ``perf.run_variant`` on the card for Mixtral-8x7B
             at full published width, EP on one virtual rank, bf16, at 1
             and 2 of 32 layers: ``train_4k`` (B cut from 256 to 1) under
             ``baseline`` and ``tp+dots`` (the ``dots`` remat policy),
             ``prefill_32k`` (B 32 -> 1) and ``decode_32k`` (B 128 -> 8),
             each step ms, peak and the full-depth extrapolation with its
             MFU printed; it fails unless every pair is ``ok``, the flash
             and ``moe_gmm`` forward kernels (and in train their
             backwards) launched as often as the leg's steps need (on
             one rank ``moe_gmm``'s row tiles in train and prefill, its
             weight stream in decode),
             ``tp+dots``' loss equals ``baseline``'s and its forward
             leaves more bytes for the backward and peaks higher;
9. mesh    — reduced Mixtral in fp32 on a virtual 2x4 (data, model) mesh,
             EP over both axes: the sp+cf05 EP layer and prefill (drops,
             counts and local ratio exact), one fsdp train step (every
             gradient leaf within 1e-4 of its largest value) and
             ``cache_seq_sharded`` greedy decode, card against CPU.

Kernel launch counts are set to 0 just before the serve, generate, each
variant, cluster, cluster-reference, ssm-serve, reference, train,
launch and mesh phases and read just after; each phase fails if a kernel of its path never ran
(Falcon-Mamba's serving path runs none: its decode and prefill scans are
plain PyTorch, as the reference's are). A CUDA graph replay runs no
wrapper: each graph adds the launches its capture recorded on every replay
(the capture itself counts none), and the warmed runs set the counts to 0
after their warmup, so their counts are replays alone. ``moe_gmm`` and ``flash_attention`` also count by variant
(``launches_by_variant``: ``tc`` on the tensor cores, ``simt`` on the CUDA
cores): the bf16 serve, generate and cluster phases fail unless the
tensor-core variants ran, the fp32 reference phases unless the CUDA-core
ones did. ``moe_gmm``'s ``tc`` launches also count by design
(``launches_by_design``: ``stream``, ``rows``; printed with the variants,
``moe_gmm_rows`` among the launch counts).
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

import contextlib
import dataclasses
import gc
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

from repro_torch.launch import mesh  # noqa: E402  (the H100's constants)

HBM_BYTES_PER_S = mesh.HBM_BW
SLEEP_CYCLES_PER_S = 1.98e9  # torch.cuda._sleep counts SM clocks (boost)
PEAK_FLOPS = {"bfloat16": mesh.PEAK_FLOPS, "float32": mesh.PEAK_FLOPS_FP32}
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SSM_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# exp results per second: 16 per clock per SM on the special function units
# (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9


# the serve workload's ticks before the three requests that share the
# first one's prefix arrive (see serve_workload)
SERVE_HEAD_TICKS = 3
SAMPLE_SEED = 1000   # request k of a sampled workload draws with seed 1000+k


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
# "cluster" is the cluster phase's decode step (bf16 only): 3 ranks x 4
# slots, 12 requests route 24 rows (max_fill 12, the batch width) under the
# uniform layout, whose slots 3, 7, 10 and 11 are empty. "prefill-32k" is
# the launch phase's prefill_32k step on one rank (bf16 only): 32768
# tokens route 65536 rows (top-2) over 8 slots of capacity 16384, about
# 8192 a slot, max_fill 16384. "ep-train" is the EP train step's forward
# (bf16 only; GMM_BWD_CASE's fills): 4096 rows, max_fill 2048.
GMM_CASES = [
    ("decode", 16384, [1, 2, 0, 2, 1, 0, 1, 1], 4),
    ("decode-C8", 8, [1, 2, 0, 2, 1, 0, 1, 1], 4),
    ("chunk", 16384, [40, 12, 0, 30, 22, 8, 16, 0], 64),
    ("full-tile", 128, [128] * 8, 128),
    ("prefill", 16384, [130, 95, 88, 110, 70, 120, 102, 85], 400),
    ("cluster", 16384, [3, 2, 3, 0, 4, 2, 3, 0, 4, 3, 0, 0], 12),
    ("ep-train", 16384, [700, 420, 0, 610, 530, 480, 650, 706], 2048),
    ("prefill-32k", 16384, [8930, 7410, 8200, 8650, 7790, 8420, 8010, 8126],
     16384),
]
GMM_BF16_ONLY = {"cluster", "ep-train", "prefill-32k"}
GMM_DESIGNS = ("stream", "rows")  # the bf16 forward's two designs
# flash attention at the generate phase's shapes, a long prompt, the long
# prompt at Zamba2-2.7B's heads (hd 80: the mma.sync kernel; hd 64 and
# 128 take the wgmma one), and the ring phase's prefill: 8448 tokens past
# Mixtral's 8192-token window: (B, T, H, KVH, hd, window)
FLASH_CASES = [(2, 128, 32, 8, 128, 0), (2, 200, 32, 8, 128, 0),
               (2, 200, 32, 8, 128, 64), (1, 2048, 32, 8, 128, 0),
               (1, 2048, 32, 32, 80, 0), (1, 8448, 32, 8, 128, 8192)]


@contextlib.contextmanager
def forced_design(gmm, design):
    """Make ``moe_gmm`` run ``design`` for the tensor-core variant while
    the block runs (as the card tests force it; the CUDA cores' variant
    keeps ``"simt"``); the main path never forces one."""
    chosen = gmm.select_design
    gmm.select_design = lambda variant, m: (design if variant == "tc"
                                            else chosen(variant, m))
    try:
        yield
    finally:
        gmm.select_design = chosen


def gmm_library(x, w1, w3, w2, m):
    """The bmm chain: every row up to max_fill, in three library calls."""
    xs = x[:, :m]
    mid = (Fn.silu(torch.bmm(xs, w1).float())
           * torch.bmm(xs, w3).float()).to(x.dtype)
    y = torch.zeros_like(x)
    y[:, :m] = torch.bmm(mid, w2)
    return y


def gmm_filled_rows(x, w1, w3, w2, fill, m):
    """A per-slot ``torch.mm`` chain over exactly the filled rows: the
    work the kernel does, in library calls."""
    y = torch.zeros_like(x)
    for s, n in enumerate(fill):
        n = min(n, m, x.shape[1])
        if n:
            xs = x[s, :n]
            mid = (Fn.silu((xs @ w1[s]).float())
                   * (xs @ w3[s]).float()).to(x.dtype)
            y[s, :n] = mid @ w2[s]
    return y


def run_gmm_checks(results, dnames=("float32", "bfloat16"), labels=None):
    """``moe_gmm`` at GMM_CASES (``labels``: those only) against ``plain``,
    timed beside ``plain``, the bmm chain and, past 128 rows a slot, the
    filled-rows chain. In bf16 both designs run (the other one forced):
    each against ``plain``, twice bit for bit, zeros past the fill, timed;
    the row's ``ms`` is the design ``select_design`` picks."""
    from repro_torch.kernels import moe_gmm as gmm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for dname in dnames:
        dt = dtypes[dname]
        elt = torch.finfo(dt).bits // 8
        cases = [cs for cs in GMM_CASES
                 if (dt == torch.bfloat16 or cs[0] not in GMM_BF16_ONLY)
                 and (labels is None or cs[0] in labels)]
        if not cases:
            continue
        n_slots = max(len(cs[2]) for cs in cases)
        w1_all = (torch.randn(n_slots, 4096, 14336, generator=gen, device=dev)
                  / 64.0).to(dt)
        w3_all = (torch.randn(n_slots, 4096, 14336, generator=gen, device=dev)
                  / 64.0).to(dt)
        w2_all = (torch.randn(n_slots, 14336, 4096, generator=gen, device=dev)
                  / 14336**0.5).to(dt)
        for label, C, fill, m in cases:
            w1, w3, w2 = (w[:len(fill)] for w in (w1_all, w3_all, w2_all))
            S, D, F = w1.shape
            x = torch.zeros((S, C, D), dtype=dt, device=dev)
            for s, n in enumerate(fill):
                x[s, :n] = torch.randn(n, D, generator=gen, device=dev).to(dt)
            fl = torch.tensor(fill, dtype=torch.int32, device=dev)
            variant = gmm.select_variant(dt, D, F)
            design = gmm.select_design(variant, min(m, C))
            want = gmm.plain(x, w1, w3, w2, fl, m)
            past = (torch.arange(C, device=dev)[None, :]
                    >= torch.clamp(fl.long(), max=m)[:, None])
            reps = 3 if label in ("full-tile", "prefill", "prefill-32k") else 10
            runs = [design] + [d for d in GMM_DESIGNS
                               if variant == "tc" and d != design]
            errs, times = {}, {}
            for d in runs:
                with forced_design(gmm, d):
                    y = gmm.launch(x, w1, w3, w2, fl, m)
                    torch.cuda.synchronize()
                    errs[d], tol = check_close(
                        f"moe_gmm {label} {dname} {d}", y, want, dname)
                    if bool(y[past].any()):
                        raise AssertionError(
                            f"moe_gmm {label} {d}: rows past fill not 0")
                    if dt == torch.bfloat16 and not torch.equal(
                            y, gmm.launch(x, w1, w3, w2, fl, m)):
                        raise AssertionError(
                            f"moe_gmm {label} {d}: two runs differ")
                    del y
                    times[d] = time_ms(
                        lambda: gmm.launch(x, w1, w3, w2, fl, m), reps)
            ms, err = times[design], errs[design]
            plain_ms = time_ms(lambda: gmm.plain(x, w1, w3, w2, fl, m),
                               reps)
            lib_ms = time_ms(lambda: gmm_library(x, w1, w3, w2, m), reps)
            filled_ms = (time_ms(lambda: gmm_filled_rows(x, w1, w3, w2, fill,
                                                         m), reps)
                         if m > 128 else None)
            filled = sum(min(n, m, C) for n in fill)
            occupied = sum(1 for n in fill if min(n, m) > 0)
            nbytes = (occupied * 3 * D * F * elt + filled * D * elt
                      + S * C * D * elt + 4 * S)
            flops = 6 * D * F * filled
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            bound = max(t_bytes, t_ops)
            results.append({
                "kernel": "moe_gmm", "case": label, "dtype": dname,
                "variant": variant, "design": design, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "filled_rows_ms": filled_ms, "designs_ms": times,
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            both = " ".join(f"{d}={times[d]:.3f}ms" for d in runs)
            print(f"kernels: moe_gmm {label:11s} {dname:8s} {variant:4s} "
                  f"design={design} S,C,D,F={S},{C},{D},{F} fill={fill} "
                  f"max_fill={m} err={err:.3e} (tol {tol:.3e}; "
                  + ", ".join(f"{d} {errs[d]:.3e}" for d in runs) + ") "
                  f"kernel={ms:.3f}ms [{both}] plain={plain_ms:.3f}ms "
                  f"bmm-chain={lib_ms:.3f}ms"
                  + (f" filled-rows-chain={filled_ms:.3f}ms"
                     if filled_ms is not None else "")
                  + f" bound={bound:.3f}ms ({bound / ms:.1%} of it)",
                  flush=True)
            del x, want, w1, w3, w2, past
        del w1_all, w3_all, w2_all
        torch.cuda.empty_cache()


def run_kernel_checks(results):
    from repro_torch.kernels import flash_attention as fa

    run_gmm_checks(results)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    for dname, dt in dtypes.items():
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

            # the plain version holds [B*H, T, T] fp32 scores: few reps
            # at T = 8448 (9.1 GB a tensor)
            reps = 5 if T > 4096 else 20
            ms = time_ms(lambda: fa.launch(q, k, v, causal=True,
                                                  window=window), reps)
            plain_ms = time_ms(lambda: fa.plain(q, k, v, causal=True,
                                                       window=window), reps)
            lib_ms = time_ms(sdpa, reps)
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
            del q, k, v, o, want, mask, qp, kp, qt, kt, vt
            torch.cuda.empty_cache()
            print(f"kernels: flash_attention {label:20s} {dname:8s} {variant:4s} "
                  f"B,T,H,KVH,hd={B},{T},{H},{KVH},{hd} err={err:.3e} "
                  f"(tol {tol:.3e}) kernel={ms:.3f}ms plain={plain_ms:.3f}ms "
                  f"sdpa={lib_ms:.3f}ms bound={max(t_bytes, t_ops):.4f}ms",
                  flush=True)


# paged attention at the cells' shapes (48 padded q heads over 8 kv heads
# of 128, blocks of 16): (label, rows, Tq, pages a row, pool): a chat decode
# round at the widest bucket over 320 pages, a chat chunk call of 4
# prefilling rows, the docs chunk call of 16 rows over 528 pages, bf16;
# the chat decode round again over an int8 pool (bf16 queries) and in
# fp32; lengths drawn from the traffic files' distributions
# (paged_lengths). Pools by name: (query type, int8 codes)
PAGED_CASES = [("chat-decode", 32, 1, 320, "bfloat16"),
               ("chat-chunk", 4, 16, 320, "bfloat16"),
               ("docs-chunk", 16, 16, 528, "bfloat16"),
               ("chat-decode", 32, 1, 320, "int8"),
               ("chat-decode", 32, 1, 320, "float32")]
PAGED_POOLS = {"bfloat16": (torch.bfloat16, False),
               "int8": (torch.bfloat16, True),
               "float32": (torch.float32, False)}
# tests/test_torch_cuda.py's PAGED_TOL, by query type (there held per
# query; here, as for the other kernels, against the largest output)
PAGED_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def paged_lengths(label, B, rng):
    """Each row's live keys at the call (the last query's position + 1).
    Chat: a 128-token system prompt, a prompt lognormal 384 / 0.8 in
    64-2048, and a uniform share of an output lognormal 128 / 0.6 in
    16-512 (a decode row), or a block-aligned point inside the prompt (a
    chunk row); docs: a point inside a document lognormal 2048 / 0.5 in
    1024-4096, block-aligned."""
    def lognormal(median, sigma, lo, hi):
        return np.clip(rng.lognormal(np.log(median), sigma, B), lo, hi)

    if label == "chat-decode":
        out = lognormal(128, 0.6, 16, 512) * rng.random(B)
        return (128 + lognormal(384, 0.8, 64, 2048) + out).astype(int) + 1
    doc = (128 + lognormal(384, 0.8, 64, 2048) if label == "chat-chunk"
           else lognormal(2048, 0.5, 1024, 4096))
    return (doc * rng.random(B)).astype(int) // 16 * 16 + 16


def run_paged_checks(results):
    """The paged attention kernel at the cells' shapes against its plain
    version (the gathered read), its device time beside its byte bound
    (each live k/v byte read once, with an int8 pool's scales, q read and
    the output written once) and the plain version's."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention as TA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    H, KVH, hd, bs = 48, 8, 128, 16
    for label, B, Tq, P, pool in PAGED_CASES:
        dtype, int8 = PAGED_POOLS[pool]
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        ends = paged_lengths(label, B, rng)
        n_blocks = 1 + B * P
        perm = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)))
        table = torch.zeros((B, P), dtype=torch.int32)
        for b, end in enumerate(ends):
            n = -(-int(end) // bs)
            table[b, :n] = perm[b * P:b * P + n]
        table = table.to(dev)
        offs = torch.from_numpy(ends - Tq).to(dev, torch.int32)
        q = torch.randn(B, Tq, H, hd, generator=gen, device=dev).to(dtype)
        kp, vp = (torch.randn(n_blocks, bs, KVH, hd, generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        cache = {"k": kp, "v": vp}
        if int8:
            (k8, ks), (v8, vs) = TA.quantize_kv(kp), TA.quantize_kv(vp)
            cache = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
        args = (q, cache["k"], cache["v"], table, offs,
                cache.get("k_scale"), cache.get("v_scale"))
        o = pa.launch(*args)
        torch.cuda.synchronize()
        want = TA.gathered_attention(q, cache, table, offs)
        err, tol = check_close(f"paged_attention {label} {pool}", o, want,
                               dname, PAGED_TOL)
        ms = time_ms(lambda: pa.launch(*args), 50)
        plain_ms = time_ms(
            lambda: TA.gathered_attention(q, cache, table, offs), 3)
        keys = int(ends.sum())
        elem = cache["k"].element_size()
        per_key = KVH * (hd * elem + (2 if int8 else 0))  # codes + scale
        nbytes = 2 * keys * per_key + 2 * q.numel() * q.element_size()
        pairs = sum(int(e) - Tq + t + 1 for e in ends for t in range(Tq))
        flops = 4 * hd * H * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        splits = pa.plan(B, Tq, H, KVH, hd, P, bs, dtype, int8)["splits"]
        results.append({
            "kernel": "paged_attention", "case": label, "dtype": pool,
            "variant": f"splits={splits}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        print(f"kernels: paged_attention {label:12s} {pool:8s} B={B} "
              f"Tq={Tq} P={P} live keys={keys} (longest {int(ends.max())}) "
              f"splits={splits} err={err:.3e} (tol {tol:.3e}) "
              f"kernel={ms:.4f}ms plain={plain_ms:.3f}ms "
              f"bound={max(t_bytes, t_ops):.4f}ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{max(t_bytes, t_ops) / ms:.1%} of it)", flush=True)
        del args, q, kp, vp, cache, o, want, table, offs
        torch.cuda.empty_cache()


# the paged MLA read at the longdocs cell's shapes (16 heads over 576-value
# latent rows, blocks of 16, 32 rows over tables of 2060 pages: 32,960
# positions): (label, rows, Tq, pages a row, pool): the decode round and
# the chunk call in bf16, the decode round in fp32; lengths drawn from the
# traffic file (paged_mla_lengths)
PAGED_MLA_CASES = [("longdocs-decode", 32, 1, 2060, "bfloat16"),
                   ("longdocs-chunk", 32, 16, 2060, "bfloat16"),
                   ("longdocs-decode", 32, 1, 2060, "float32")]
MLA_SCALE = 0.1147213867929261  # DeepSeek-V2-Lite's softmax scale


def paged_mla_lengths(label, B, rng):
    """Each row's live rows at the call: a document lognormal 16384 / 0.4
    in 8192-32768 and a question of 32-64 tokens, then a uniform share of
    an output lognormal 64 / 0.5 in 16-128 (a decode row), or a
    block-aligned point inside the document (a chunk row)."""
    doc = np.clip(rng.lognormal(np.log(16384), 0.4, B), 8192, 32768)
    if label.endswith("decode"):
        out = np.clip(rng.lognormal(np.log(64), 0.5, B), 16, 128)
        return (doc + rng.integers(32, 65, B) + out * rng.random(B)).astype(
            int) + 1
    return (doc * rng.random(B)).astype(int) // 16 * 16 + 16


def run_paged_mla_checks(results):
    """The paged MLA kernel at the longdocs cell's shapes against its plain
    version (the gathered read), its device time beside its bound (the
    larger of 2 x 16 x (576 + 512) FLOPs a (query, key) pair over the peak
    and, over HBM bandwidth, each live latent row read once, q read and
    the output written once) and the plain version's."""
    from repro_torch.kernels import paged_mla as pm
    from repro_torch.models import mla

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    H, D, DV, bs = pm.HEADS, pm.LATENT, pm.VALUES, 16
    for label, B, Tq, P, dname in PAGED_MLA_CASES:
        dtype = torch.bfloat16 if dname == "bfloat16" else torch.float32
        ends = paged_mla_lengths(label, B, rng)
        n_blocks = 1 + B * P
        perm = torch.from_numpy(rng.permutation(np.arange(1, n_blocks)))
        table = torch.zeros((B, P), dtype=torch.int32)
        for b, end in enumerate(ends):
            n = -(-int(end) // bs)
            table[b, :n] = perm[b * P:b * P + n]
        table = table.to(dev)
        offs = torch.from_numpy(ends - Tq).to(dev, torch.int32)
        q = (torch.randn(B, Tq, H, D, generator=gen, device=dev) * 0.5).to(
            dtype)
        pool = torch.randn(n_blocks, bs, D, generator=gen, device=dev).to(
            dtype)
        o = pm.launch(q, pool, table, offs, MLA_SCALE, DV)
        torch.cuda.synchronize()
        want = mla.gathered_mla(q, {"ckv": pool}, table, offs, MLA_SCALE, DV)
        err, tol = check_close(f"paged_mla {label} {dname}", o, want, dname,
                               PAGED_TOL)
        ms = time_ms(lambda: pm.launch(q, pool, table, offs, MLA_SCALE, DV),
                     20)
        plain_ms = time_ms(lambda: mla.gathered_mla(
            q, {"ckv": pool}, table, offs, MLA_SCALE, DV), 2)
        keys = int(ends.sum())
        elem = pool.element_size()
        nbytes = keys * D * elem + B * Tq * H * (D + DV) * elem
        pairs = sum(int(e) - Tq + t + 1 for e in ends for t in range(Tq))
        flops = 2 * H * (D + DV) * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        splits = pm.plan(B, Tq, P, bs, dtype)["splits"]
        results.append({
            "kernel": "paged_mla", "case": label, "dtype": dname,
            "variant": f"splits={splits}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        print(f"kernels: paged_mla {label:16s} {dname:8s} B={B} Tq={Tq} "
              f"P={P} live rows={keys} (longest {int(ends.max())}) "
              f"splits={splits} err={err:.3e} (tol {tol:.3e}) "
              f"kernel={ms:.4f}ms plain={plain_ms:.3f}ms "
              f"bound={max(t_bytes, t_ops):.4f}ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{max(t_bytes, t_ops) / ms:.1%} of it)", flush=True)
        del q, pool, o, want, table, offs
        torch.cuda.empty_cache()


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


# the backward kernels (phase 2). flash: the train phase's attention (B = 2,
# T = 2048, 32 q heads over 8 KV heads, hd 128, causal), GQA at hd 80
# (Zamba2-2.7B's head size), a window shorter than T, and a ragged T:
# (label, B, T, H, KVH, hd, window); the plain version and SDPA's backward
# are timed at the train shape only. moe_gmm: the EP train step's expert
# FFN (B = 1, T = 2048, top-2: 4096 routed rows over 8 slots of capacity
# 16384, max_fill 2048 < C), ragged, one slot empty.
FLASH_BWD_CASES = [("train", 2, 2048, 32, 8, 128, 0),
                   ("hd80-gqa", 1, 1024, 32, 8, 80, 0),
                   ("window", 1, 2048, 32, 8, 128, 512),
                   ("ragged", 2, 200, 32, 8, 128, 0)]
GMM_BWD_CASE = ("ep-train", 16384, [700, 420, 0, 610, 530, 480, 650, 706],
                2048)


def grad_of(fn, inputs, dout):
    """A function that runs the backward of ``fn`` alone: the forward is
    recorded once, and each call takes the gradients of ``inputs`` through
    the kept graph (``retain_graph``)."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def bwd_record(results, kernel, case, dname, variant, design, err, ms,
               plain_ms, lib_ms, nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    results.append({
        "kernel": kernel, "case": case, "dtype": dname, "variant": variant,
        "design": design, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return results[-1]


def run_bwd_checks(results):
    """Each backward kernel against its ``plain_bwd`` (autograd through the
    plain forward), in fp32 and bf16: errors, two runs bit for bit, device
    time beside the bound, the plain version's time and the library's
    (SDPA's backward; the bmm chain's autograd backward)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for dname, dt in {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}.items():
        elt = dt.itemsize
        for label, B, T, H, KVH, hd, window in FLASH_BWD_CASES:
            q, do = (torch.randn(B, T, H, hd, generator=gen, device=dev).to(dt)
                     for _ in range(2))
            k, v = (torch.randn(B, T, KVH, hd, generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            lse = torch.empty(fa.stats_shape(B, T, H), device=dev)
            o = fa.launch(q, k, v, causal=True, window=window, lse=lse)
            got = fa.launch_bwd(q, k, v, o, lse, do, causal=True,
                                window=window)
            again = fa.launch_bwd(q, k, v, o, lse, do, causal=True,
                                  window=window)
            torch.cuda.synchronize()
            want = fa.plain_bwd(q, k, v, do, causal=True, window=window)
            err = 0.0
            for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
                if not torch.equal(g, g2):
                    raise AssertionError(f"flash_attention_bwd {label} "
                                         f"{dname}: two runs give different "
                                         f"{name}")
                e, tol = check_close(f"flash_attention_bwd {label} {dname} "
                                     f"{name}", g, w, dname)
                err = max(err, e)
            del got, again, want
            ms = time_ms(lambda: fa.launch_bwd(q, k, v, o, lse, do,
                                               causal=True, window=window), 5)
            qp = torch.arange(T, device=dev)[:, None]
            kp = torch.arange(T, device=dev)[None, :]
            mask = kp <= qp
            if window:
                mask &= kp > qp - window
            pairs = int(mask.sum())
            plain_ms = lib_ms = None
            if label == "train":
                plain_ms = time_ms(grad_of(
                    lambda a, b, c: fa.plain(a, b, c, causal=True,
                                             window=window), (q, k, v), do), 3)
                lib_ms = time_ms(grad_of(
                    lambda a, b, c: Fn.scaled_dot_product_attention(
                        a.transpose(1, 2), b.transpose(1, 2),
                        c.transpose(1, 2), is_causal=True,
                        enable_gqa=True).transpose(1, 2), (q, k, v), do), 5)
                torch.cuda.empty_cache()
            # read q, k, v, o, dO and lse once, write dq, dk, dv once; five
            # products of 2 hd flops per visible (query, key) pair
            nbytes = (4 * q.numel() + 4 * k.numel()) * elt + 4 * lse.numel()
            flops = 10 * B * H * hd * pairs
            variant = fa.select_variant(dt, hd)
            design = fa.bwd_design(dt, hd)
            r = bwd_record(results, "flash_attention_bwd", label, dname,
                           variant, design, err, ms, plain_ms, lib_ms, nbytes,
                           flops)
            print(f"kernels: flash_attention_bwd {label:8s} {dname:8s} "
                  f"{variant:4s} {design:4s} "
                  f"B,T,H,KVH,hd={B},{T},{H},{KVH},{hd}"
                  + (f" window={window}" if window else "")
                  + f" err={err:.3e} kernel={ms:.3f}ms plain="
                  + ("not timed" if plain_ms is None else f"{plain_ms:.3f}ms")
                  + " sdpa-bwd="
                  + ("not timed" if lib_ms is None else f"{lib_ms:.3f}ms")
                  + f" bound={r['bound_ms']:.4f}ms ({r['bound_by']}); two "
                  "runs identical", flush=True)
            del q, k, v, o, do, lse, mask, qp, kp
            torch.cuda.empty_cache()

        label, C, fill, m = GMM_BWD_CASE
        S, D, F = len(fill), 4096, 14336
        w1, w3 = ((torch.randn(S, D, F, generator=gen, device=dev) / 64.0)
                  .to(dt) for _ in range(2))
        w2 = (torch.randn(S, F, D, generator=gen, device=dev)
              / F**0.5).to(dt)
        x = torch.zeros((S, C, D), dtype=dt, device=dev)
        for s, n in enumerate(fill):
            x[s, :n] = torch.randn(n, D, generator=gen, device=dev).to(dt)
        dy = torch.randn(S, C, D, generator=gen, device=dev).to(dt)
        fl = torch.tensor(fill, dtype=torch.int32, device=dev)
        # what one backward allocates beyond its four gradients: the
        # scratch of its design (wg: g = {da, db, mid}; simt: also the fp32
        # x w1, x w3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        got = gmm.launch_bwd(x, w1, w3, w2, fl, m, dy)
        torch.cuda.synchronize()
        grads = sum(g.numel() * g.element_size() for g in got)
        scratch = torch.cuda.max_memory_allocated() - held - grads
        variant = gmm.select_variant(dt, D, F)
        design = "wg" if variant == "tc" else "simt"  # the wgmma kernels
        shapes = gmm.bwd_scratch_shapes(S, D, F, m, variant)
        want_bytes = sum(int(np.prod(v)) * (4 if k == "ab" else elt)
                         for k, v in shapes.items())
        if not want_bytes <= scratch <= want_bytes + 2**22:
            raise AssertionError(f"moe_gmm_bwd {label} {dname}: scratch "
                                 f"{scratch} bytes, expected {shapes} = "
                                 f"{want_bytes} bytes")
        again = gmm.launch_bwd(x, w1, w3, w2, fl, m, dy)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, g2 in zip(("dx", "dw1", "dw3", "dw2"), got, again):
            if not torch.equal(g, g2):
                raise AssertionError(f"moe_gmm_bwd {label} {dname}: two runs "
                                     f"give different {name}")
        del again
        want = gmm.plain_bwd(x, w1, w3, w2, fl, m, dy)
        for name, g, w in zip(("dx", "dw1", "dw3", "dw2"), got, want):
            e, tol = check_close(f"moe_gmm_bwd {label} {dname} {name}", g, w,
                                 dname)
            err = max(err, e)
        if any(bool(g[2].any()) for g in got):
            raise AssertionError(f"moe_gmm_bwd {label}: the empty slot got a "
                                 "gradient")
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: gmm.launch_bwd(x, w1, w3, w2, fl, m, dy), 3)
        plain_ms = time_ms(grad_of(lambda *a: gmm.plain(*a, fl, m),
                                   (x, w1, w3, w2), dy), 3)
        torch.cuda.empty_cache()

        def bmm_chain(xs, a1, a3, a2):
            mid = (Fn.silu(torch.bmm(xs, a1).float())
                   * torch.bmm(xs, a3).float()).to(xs.dtype)
            return torch.bmm(mid, a2)

        lib_ms = time_ms(grad_of(bmm_chain, (x[:, :m], w1, w3, w2),
                                 dy[:, :m].contiguous()), 3)
        torch.cuda.empty_cache()
        rows = sum(min(n, m) for n in fill)
        occupied = sum(1 for n in fill if min(n, m) > 0)
        # weights of the occupied slots read, every weight gradient written,
        # the filled rows of x and dy read, dx written; the recompute of
        # x w1 and x w3 and five products: 16 D F flops per routed row
        nbytes = elt * (3 * occupied * D * F + 3 * S * D * F + 2 * rows * D
                        + S * C * D) + 4 * S
        flops = 16 * D * F * rows
        r = bwd_record(results, "moe_gmm_bwd", label, dname, variant, design,
                       err, ms, plain_ms, lib_ms, nbytes, flops)
        print(f"kernels: moe_gmm_bwd {label} {dname:8s} {variant:4s} "
              f"{design:4s} S,C,D,F={S},{C},"
              f"{D},{F} fill={fill} max_fill={m} err={err:.3e} "
              f"kernel={ms:.3f}ms plain={plain_ms:.3f}ms "
              f"bmm-chain-bwd={lib_ms:.3f}ms bound={r['bound_ms']:.3f}ms "
              f"({r['bound_by']}); scratch {scratch / 2**30:.3f} GiB "
              f"({', '.join(shapes)}); two runs identical", flush=True)
        del x, w1, w3, w2, dy, fl
        torch.cuda.empty_cache()


def reset_counts():
    """Every launch count of ``moe_gmm``, ``flash_attention`` and
    ``paged_attention`` to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import paged_attention as pa

    for mod in (gmm, fa):
        mod.launches = 0
        for k in mod.launches_by_variant:
            mod.launches_by_variant[k] = 0
    for k in gmm.launches_by_design:
        gmm.launches_by_design[k] = 0
    pa.launches = 0
    for k in pa.launches_by_call:
        pa.launches_by_call[k] = 0


def read_counts():
    """(launches per kernel, the row-tile design's ``moe_gmm_rows``
    among them; launches per kernel and variant, ``moe_gmm``'s also by
    design: ``stream`` and ``rows`` of its ``tc``; ``paged_attention``'s
    by call: ``decode`` and ``chunk``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import paged_attention as pa

    return ({"moe_gmm": gmm.launches, "flash_attention": fa.launches,
             "moe_gmm_rows": gmm.launches_by_design["rows"],
             "paged_attention": pa.launches},
            {"moe_gmm": {**gmm.launches_by_variant, **gmm.launches_by_design},
             "flash_attention": dict(fa.launches_by_variant),
             "paged_attention": dict(pa.launches_by_call)})


def serve_workload(runtime, prompts, temperature=0.0):
    """The serve workload on ``runtime``: the first request, three ticks,
    the other three, served to the end. After three ticks the first
    request's shared prefix is in the radix cache in either loop (the
    warmed loop inserts it when it drains the final chunk, a tick after
    the synchronous loop), so both loops run the same batches: the same
    prefix hits, the same chunk and decode widths on every tick. (After
    two ticks the warmed loop's three would miss the cache
    and prefill in other batch shapes, whose bf16 rounding flips greedy
    tokens of these nearly flat random-weight logits.) Every prefill's
    final-position logits (read from the chunk graph's output on the
    warmed loop) must be finite. At a ``temperature`` above 0 every
    request samples, each with its own seed. Returns (token arrays, wall
    seconds, launch counts, counts by variant)."""
    from repro_torch.serving.api import Request

    finite = []
    finish = runtime._finish_prefill

    def checked(i, rid, logits_row, first_tok):
        finite.append(bool(np.isfinite(logits_row).all()))
        return finish(i, rid, logits_row, first_tok)

    runtime._finish_prefill = checked
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [Request(prompt=p, max_new_tokens=16, temperature=temperature,
                    seed=SAMPLE_SEED + k) for k, p in enumerate(prompts)]
    handles = [runtime.enqueue(reqs[0])]
    for _ in range(SERVE_HEAD_TICKS):
        runtime.step()
    handles += [runtime.enqueue(r) for r in reqs[1:]]
    runtime.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = read_counts()
    toks = [h.result() for h in handles]
    if any(len(t) != 16 for t in toks):
        raise AssertionError(f"serve: token counts {[len(t) for t in toks]}")
    if len(finite) < len(prompts) or not all(finite):
        raise AssertionError(f"serve: non-finite prefill logits {finite}")
    if variants["moe_gmm"]["tc"] <= 0:
        raise AssertionError("serve: the tensor-core moe_gmm never launched")
    runtime.check_invariants()
    return toks, wall, counts, variants


def check_paged_calls(label, runtime, variants) -> None:
    """Every decode round and chunk call of a paged runtime (any pool
    layout) ran the paged attention kernel once per layer (the counts were
    reset before the workload)."""
    layers = runtime.engine.rt.cfg.num_layers
    want = {"decode": runtime.rounds * layers,
            "chunk": runtime.prefill_calls * layers}
    if variants["paged_attention"] != want:
        raise AssertionError(f"{label}: paged_attention launches "
                             f"{variants['paged_attention']}, expected {want}")


def run_mla_serve():
    """The MLA serve phase: reduced DeepSeek-V2-Lite (one dense and two MoE
    layers at the paged MLA kernel's latent widths, bf16, three virtual EP
    ranks) serves the same requests on the synchronous and the warmed loop.
    Fails unless the tokens agree and every decode round and chunk call
    launched the paged MLA kernel once per MLA layer (the dense layer's
    included) and the GQA paged kernel never. Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_mla as pm
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    cfg = get_config("deepseek-v2-lite-mla").reduced()
    eng, _ = build_engine(cfg, device="cuda", dtype=torch.bfloat16,
                          max_len=160, policy="dancemoe", review_rounds=8,
                          n_ep=3, slots=4)
    # one chunk each, all due at once: both loops run the same batches (a
    # timeline that differs may flip bf16 greedy tokens of random weights)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
               for _ in range(4)]
    toks, launches = [], 0
    for warmup in (False, True):
        rt = ServingRuntime(eng, max_slots=4, block_size=16, warmup=warmup,
                            warmup_origins="untagged")
        before = dict(pm.launches_by_call), pa.launches, pm.launches
        hs = [rt.enqueue(Request(prompt=p, max_new_tokens=12))
              for p in prompts]
        rt.run()
        toks.append([list(h.tokens) for h in hs])
        got = {k: pm.launches_by_call[k] - before[0][k] for k in before[0]}
        want = {"decode": rt.rounds * cfg.num_layers,
                "chunk": rt.prefill_calls * cfg.num_layers}
        if got != want or pa.launches != before[1]:
            raise AssertionError(f"mla serve (warmup={warmup}): paged_mla "
                                 f"{got}, expected {want}; paged_attention "
                                 f"{pa.launches - before[1]}")
        launches += pm.launches - before[2]
        print(f"mla serve: warmup={warmup} rounds={rt.rounds} chunk calls="
              f"{rt.prefill_calls} paged_mla launches {got}", flush=True)
    if toks[0] != toks[1]:
        raise AssertionError("mla serve: the warmed loop's tokens differ "
                             "from the synchronous loop's")
    del eng
    torch.cuda.empty_cache()
    return {"paged_mla": launches}


def perf_line(runtime, toks, wall) -> str:
    p = runtime.perf_metrics()
    n_tok = sum(len(t) for t in toks)
    return (f"{len(toks)} requests / {n_tok} tokens in {wall:.3f}s "
            f"({n_tok / wall:.1f} tok/s) ttft p50={p['ttft_ms']['p50']:.2f}ms "
            f"decode-round p50={p['decode_round_ms']['p50']:.2f}ms "
            f"p99={p['decode_round_ms']['p99']:.2f}ms over "
            f"{p['rounds_timed']} rounds, host_syncs={p['host_syncs']}")


def run_serve(cfg):
    """Phase 3. Returns (engine, prompts, the synchronous loop's tokens,
    launch counts of both loops)."""
    from repro_torch.data.pipeline import TaskTokenSource
    from repro_torch.launch.serve import build_controller, build_engine
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
    src = TaskTokenSource("serve", cfg.vocab_size, seed=0)
    shared = src.sample(1, 16)[0]
    prompts = [np.concatenate([shared, src.sample(1, 16)[0]]) for _ in range(4)]

    runtime = ServingRuntime(engine, max_slots=4, controller=controller,
                             block_size=16, prefix_cache=True)
    toks, wall, counts, variants = serve_workload(runtime, prompts)
    check_paged_calls("serve: sync loop", runtime, variants)
    print(f"serve: sync loop {perf_line(runtime, toks, wall)} "
          f"migrations={len(runtime.migrations)} "
          f"prefix_hits={runtime.prefix_hits} launches={counts} "
          f"by variant={variants}", flush=True)
    del runtime

    torch.cuda.reset_peak_memory_stats()
    warm = ServingRuntime(
        engine, max_slots=4, block_size=16, prefix_cache=True, warmup=True,
        warmup_origins="untagged",
        controller=build_controller(cfg, engine.rt.ep_spec, "dancemoe", 8))
    wtoks, wwall, wcounts, wvariants = serve_workload(warm, prompts)
    check_paged_calls("serve: warmed loop", warm, wvariants)
    peak = torch.cuda.max_memory_allocated()
    if [t.tolist() for t in wtoks] != [t.tolist() for t in toks]:
        raise AssertionError(
            "serve: the warmed loop's tokens differ from the synchronous "
            f"loop's (prefix hits {warm.prefix_hits}): "
            f"{[int(np.sum(a != b)) for a, b in zip(wtoks, toks)]} of 16 "
            "differ per request")
    if warm.executables_compiled != 7:
        raise AssertionError(f"serve: {warm.executables_compiled} graphs, "
                             "expected 7")
    if warm.traces_after_warmup != 0:
        raise AssertionError(f"serve: {warm.traces_after_warmup} rounds ran "
                             "eagerly after warmup")
    if not warm.migrations:
        raise AssertionError("serve: no migration happened under replay")
    print(f"serve: warmed loop {perf_line(warm, wtoks, wwall)} rounds="
          f"{warm.rounds}, prefill drains={warm.prefill_calls}; "
          f"{warm.executables_compiled} graphs captured in "
          f"{warm.warmup_seconds:.3f}s, traces_after_warmup="
          f"{warm.traces_after_warmup}, migrations={len(warm.migrations)} "
          f"(in place, under replay), peak memory {peak / 2**30:.2f} GiB; "
          f"tokens equal the sync loop's; replayed launches={wcounts} by "
          f"variant={wvariants}", flush=True)
    del warm
    gc.collect()
    serve_cow(engine, prompts[0][:24].copy())
    return engine, prompts, toks, {k: counts[k] + wcounts[k] for k in counts}


def serve_cow(engine, prompt):
    """Phase 3, copy-on-write: ``prompt`` (24 tokens, not a multiple of the
    16-token block) served twice, one request after the other, on the
    synchronous loop and then on a warmed runtime that leases the serve
    phase's graphs. The second request is a full prefix hit: its shared
    tail block is cloned before its first decode write (through the
    captured clone on the warmed loop). Fails unless each loop cloned a
    block, the warmed loop ran no round eagerly and its tokens equal the
    synchronous loop's."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    got = {}
    for warmup in (False, True):
        rt = ServingRuntime(engine, max_slots=4, block_size=16,
                            prefix_cache=True, warmup=warmup,
                            warmup_origins="untagged")
        toks = []
        for _ in range(2):
            h = rt.enqueue(Request(prompt=prompt, max_new_tokens=16))
            rt.run()
            toks.append(h.result().tolist())
        if rt.cow_copies < 1:
            raise AssertionError(f"serve cow: no block cloned (warmup="
                                 f"{warmup}, prefix hits {rt.prefix_hits})")
        if warmup and rt.traces_after_warmup != 0:
            raise AssertionError(f"serve cow: {rt.traces_after_warmup} "
                                 "steps ran eagerly after warmup")
        rt.check_invariants()
        got[warmup] = toks, rt.cow_copies
        del rt
        gc.collect()
    if got[True][0] != got[False][0]:
        raise AssertionError(
            "serve cow: the warmed loop's tokens differ from the "
            f"synchronous loop's: {got[True][0]} vs {got[False][0]}")
    print(f"serve: copy-on-write, a {len(prompt)}-token prompt twice: "
          f"{got[True][1]} block clone(s) replayed (sync loop "
          f"{got[False][1]}), 0 eager steps, tokens equal the sync loop's",
          flush=True)


def run_profile(engine, prompts, warmup: bool):
    """Phase 3b: the serve workload once more (fresh runtime, no placement
    controller) under ``torch.profiler``: the device's busy share of the
    wall time (union of kernel / memcpy / memset intervals) and the
    kernels that take most of it. The profiler's own host cost inflates
    the wall time, so the busy share is a lower bound. The warmed rerun
    leases the warmed run's graphs (its warmup only allocates the pinned
    rings)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    rt = ServingRuntime(engine, max_slots=4, block_size=16, prefix_cache=True,
                        warmup=warmup, warmup_origins="untagged")
    handles = [rt.enqueue(Request(prompt=prompts[0], max_new_tokens=16))]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_HEAD_TICKS):
            rt.step()
        handles += [rt.enqueue(Request(prompt=p, max_new_tokens=16))
                    for p in prompts[1:]]
        rt.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    loop = (f"warmed loop (warmup {rt.warmup_seconds:.3f}s, "
            f"traces_after_warmup={rt.traces_after_warmup})"
            if warmup else "sync loop")
    print(f"profile: serve workload, {loop}, {device_busy(prof, wall_us)}",
          flush=True)


def device_busy(prof, wall_us: float) -> str:
    """The device's busy share of ``wall_us`` from a ``torch.profiler``
    trace (the union of kernel / memcpy / memset intervals), the time of
    the ``moe_gmm`` and ``flash_attention`` kernels and the kernels that
    take most of it, as one line."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return (f"{wall_us / 1e3:.1f} ms wall; no device events recorded "
                "(busy share not measured)")
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
    return (f"{wall_us / 1e3:.1f} ms wall, device busy {busy / 1e3:.1f} ms "
            f"({busy / wall_us:.0%}), {len(spans)} device events; moe_gmm "
            f"kernels {gmm_us / 1e3:.1f} ms, flash_attention "
            f"{flash_us / 1e3:.1f} ms; top: "
            + "; ".join(f"{n[:60]} {t / 1e3:.1f} ms" for n, t in top))


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


# The serving variants (phase 4a): a sliding-window ring, the int8 KV pool
# and seeded temperature sampling, at the serve phase's full Mixtral width;
# then the SSM and hybrid architectures through ServingRuntime (phase 4d)
RING_PROMPTS = (8448, 8320)   # both past the 8192-token window, each a
#   length of its own, so that each prefills alone
RING_NEW = 32                 # decode positions past the prompt: the ring
#   has wrapped from the first one on
SAMPLE_TEMPERATURE = 0.8
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
SSM_PROMPT, SSM_NEW, SSM_REQUESTS = 32, 16, 4


@contextlib.contextmanager
def flash_calls():
    """Record ``(T, window)`` of every ``flash_attention`` kernel launch
    made inside the block (the wrapper itself runs unchanged)."""
    from repro_torch.kernels import flash_attention as fa

    calls, launch = [], fa.launch

    def recording(q, k, v, *, causal=True, window=0):
        calls.append((int(q.shape[1]), int(window)))
        return launch(q, k, v, causal=causal, window=window)

    fa.launch = recording
    try:
        yield calls
    finally:
        fa.launch = launch


def engine_variant(engine, max_len=None, **changes):
    """``engine``'s weights and placement under a runtime changed by
    ``changes`` (``window``, ``kv_quant``): a new engine, sharing the
    weight tensors."""
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(rt=dataclasses.replace(engine.rt, **changes),
                         params=engine.params, placement=engine.placement,
                         dense_master=engine.dense_master,
                         max_len=max_len or engine.max_len)


def pool_bytes(pool) -> int:
    return sum(a.numel() * a.element_size() for layer in pool.values()
               for a in layer.values())


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def run_ring(engine):
    """Phase 4a (ring): the dense slot pool at Mixtral's 8192-token window
    (a ring of 8192 positions per slot), two prompts past the window, each
    prefilled alone, 32 new tokens each. Fails unless flash attention
    launched with the window at T > window and every request finished.
    Returns the launch counts."""
    from repro_torch.data.pipeline import TaskTokenSource
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    cfg = engine.rt.cfg
    window = cfg.sliding_window
    eng = engine_variant(engine, window=window,
                         max_len=max(RING_PROMPTS) + RING_NEW + 8)
    src = TaskTokenSource("ring", cfg.vocab_size, seed=2)
    prompts = [src.sample(1, n)[0] for n in RING_PROMPTS]
    rt = ServingRuntime(eng, max_slots=2)
    ring_len = next(iter(rt.pool.values()))["k"].shape[2]
    if rt.paged or ring_len != window:
        raise AssertionError(f"ring: paged={rt.paged}, {ring_len} slots")
    reset_counts()
    torch.cuda.synchronize()
    with flash_calls() as calls:
        t0 = time.perf_counter()
        handles = [rt.enqueue(Request(prompt=p, max_new_tokens=RING_NEW))
                   for p in prompts]
        rt.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, variants = read_counts()
    toks = [h.result() for h in handles]
    if any(len(t) != RING_NEW for t in toks):
        raise AssertionError(f"ring: token counts {[len(t) for t in toks]}")
    past = [c for c in calls if c[1] == window and c[0] > window]
    if not past:
        raise AssertionError(f"ring: no flash_attention launch at T > "
                             f"window {window}: {sorted(set(calls))}")
    if variants["moe_gmm"]["tc"] <= 0 or variants["flash_attention"]["tc"] <= 0:
        raise AssertionError(f"ring: tensor-core kernels missing: {variants}")
    print(f"ring: window {window}, dense pool of 2 slots x {ring_len} ring "
          f"positions, prompts {list(RING_PROMPTS)} (each prefilled alone; "
          f"flash_attention at (T, window) {sorted(set(past))}), "
          f"{RING_NEW} new tokens each, decoded to position "
          f"{max(RING_PROMPTS) + RING_NEW - 1} (the ring wrapped): "
          f"{perf_line(rt, toks, wall)}; launches={counts} by variant="
          f"{variants}", flush=True)
    return counts


def run_int8(engine, prompts):
    """Phase 4a (int8): the serve phase's requests on an int8 paged KV pool
    (codes and bf16 scales; the serve-consistent prefill), on the
    synchronous loop and then on the warmed loop (7 graphs). Fails unless
    the pool holds int8, the two loops' tokens agree and no round ran
    eagerly. Returns the launch counts of both loops."""
    from repro_torch.serving.runtime import ServingRuntime

    eng = engine_variant(engine, kv_quant=True)
    rt = ServingRuntime(eng, max_slots=4, block_size=16, prefix_cache=True)
    leaf = next(iter(rt.pool.values()))
    if leaf["k"].dtype != torch.int8 or "k_scale" not in leaf:
        raise AssertionError(f"int8: pool holds {leaf['k'].dtype}")
    q_bytes = pool_bytes(rt.pool)
    bf16_bytes = sum(layer[n].numel() * 2 for layer in rt.pool.values()
                     for n in ("k", "v"))
    toks, wall, counts, variants = serve_workload(rt, prompts)
    check_paged_calls("int8: sync loop", rt, variants)
    print(f"int8: sync loop {perf_line(rt, toks, wall)}; launches={counts} "
          f"by variant={variants}", flush=True)
    del rt
    warm = ServingRuntime(eng, max_slots=4, block_size=16, prefix_cache=True,
                          warmup=True, warmup_origins="untagged")
    wtoks, wwall, wcounts, wvariants = serve_workload(warm, prompts)
    check_paged_calls("int8: warmed loop", warm, wvariants)
    if [t.tolist() for t in wtoks] != [t.tolist() for t in toks]:
        raise AssertionError("int8: the warmed loop's tokens differ from the "
                             "synchronous loop's")
    if warm.executables_compiled != 7 or warm.traces_after_warmup != 0:
        raise AssertionError(f"int8: {warm.executables_compiled} graphs, "
                             f"{warm.traces_after_warmup} eager rounds")
    print(f"int8: warmed loop {perf_line(warm, wtoks, wwall)}; "
          f"{warm.executables_compiled} graphs in {warm.warmup_seconds:.3f}s, "
          f"traces_after_warmup=0, tokens equal the sync loop's; pool "
          f"{q_bytes / 2**20:.2f} MiB int8 codes + bf16 scales against "
          f"{bf16_bytes / 2**20:.2f} MiB for the same blocks in bf16; "
          f"replayed launches={wcounts} by variant={wvariants}", flush=True)
    del warm, eng
    gc.collect()
    return {k: counts[k] + wcounts[k] for k in counts}


def run_sampled(engine, prompts, greedy):
    """Phase 4a (sampled): the serve phase's requests at temperature 0.8,
    each with its own seed, on the synchronous loop, then twice on the
    warmed loop (leasing the serve phase's graphs). Fails unless all three
    give the same tokens and these differ from the greedy ones. Returns
    the launch counts."""
    from repro_torch.serving.runtime import ServingRuntime

    total: dict = {}
    runs = []
    for warmup in (False, True, True):
        rt = ServingRuntime(engine, max_slots=4, block_size=16,
                            prefix_cache=True, warmup=warmup,
                            warmup_origins="untagged")
        toks, wall, counts, variants = serve_workload(
            rt, prompts, temperature=SAMPLE_TEMPERATURE)
        if warmup and rt.traces_after_warmup != 0:
            raise AssertionError(f"sampled: {rt.traces_after_warmup} eager "
                                 "rounds")
        runs.append([t.tolist() for t in toks])
        add_counts(total, counts)
        print(f"sampled: {'warmed' if warmup else 'sync'} loop "
              f"{perf_line(rt, toks, wall)}; launches={counts}", flush=True)
        del rt
        gc.collect()
    if not runs[0] == runs[1] == runs[2]:
        raise AssertionError("sampled: the loops or the rerun disagree")
    if runs[0] == [t.tolist() for t in greedy]:
        raise AssertionError("sampled: the tokens are the greedy ones")
    differ = sum(a != b for r, g in zip(runs[0], greedy)
                 for a, b in zip(r, g.tolist()))
    print(f"sampled: temperature {SAMPLE_TEMPERATURE}, seeds "
          f"{SAMPLE_SEED}..{SAMPLE_SEED + len(prompts) - 1}: sync, warmed "
          f"and warmed rerun identical; {differ} of "
          f"{sum(len(t) for t in greedy)} tokens differ from greedy",
          flush=True)
    return total


def run_serve_variants(engine, prompts, greedy):
    """Phase 4a on the serve phase's engine. Returns the launch counts."""
    total: dict = {}
    for name, run in (("ring", lambda: run_ring(engine)),
                      ("int8", lambda: run_int8(engine, prompts)),
                      ("sampled", lambda: run_sampled(engine, prompts,
                                                      greedy))):
        t0 = time.perf_counter()
        add_counts(total, run())
        free_device_memory()
        print(f"{name}: phase took {time.perf_counter() - t0:.1f}s",
              flush=True)
    return total


def run_ssm_serve():
    """Phase 4d: Falcon-Mamba-7B (64 layers) and Zamba2-2.7B (54 layers)
    at full published width and depth, bf16, random weights from a seed,
    through ``ServingRuntime`` (the dense slot pool; no placement
    controller for a model without MoE layers): 4 requests of 32 prompt
    tokens and 16 new. Fails unless every request finished and, for
    Zamba2, flash attention ran. Each model is freed before the next.
    Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TaskTokenSource
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    total: dict = {}
    for arch in SSM_ARCHS:
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        eng, controller = build_engine(
            cfg, device="cuda", dtype=torch.bfloat16,
            max_len=SSM_PROMPT + SSM_NEW + 8, policy="dancemoe",
            review_rounds=8)
        torch.cuda.synchronize()
        n_params = sum(v.numel() for v in _leaves(eng.params))
        built = time.perf_counter() - t_phase
        rt = ServingRuntime(eng, max_slots=SSM_REQUESTS)
        if rt.paged or controller is not None:
            raise AssertionError(f"{arch}: paged={rt.paged}, controller="
                                 f"{controller}")
        prompts = TaskTokenSource(arch, cfg.vocab_size, seed=3).sample(
            SSM_REQUESTS, SSM_PROMPT)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [rt.enqueue(Request(prompt=p, max_new_tokens=SSM_NEW))
                   for p in prompts]
        rt.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, variants = read_counts()
        toks = [h.result() for h in handles]
        if any(len(t) != SSM_NEW for t in toks):
            raise AssertionError(f"{arch}: token counts "
                                 f"{[len(t) for t in toks]}")
        if cfg.family == "hybrid" and counts["flash_attention"] <= 0:
            raise AssertionError(f"{arch}: flash_attention never launched")
        add_counts(total, counts)
        print(f"ssm-serve: {arch} x{cfg.num_layers} layers (d_model "
              f"{cfg.d_model}, {n_params / 1e9:.2f} B parameters, "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
              f"built in {built:.1f}s), dense pool: "
              f"{perf_line(rt, toks, wall)}; launches={counts} by variant="
              f"{variants}; phase took {time.perf_counter() - t_phase:.1f}s",
              flush=True)
        del rt, eng, handles
        free_device_memory()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


# The edge cluster (phases 4b and 4c): three edge servers as three virtual
# EP ranks of one engine, the failover scenario of
# tests/md_scripts/failover_runtime.py
N_SERVERS, CLUSTER_REQUESTS, CLUSTER_PROMPT, CLUSTER_NEW = 3, 12, 32, 16
CRASH_TICK, DEAD = 8.0, 2
REVIEW_TICKS = 4.0   # one live review lands before the crash
# modeled seconds of the edge testbed per scheduler tick: at full width one
# expert takes 5.6 s over a 500 Mbps link, so the recovery placement's
# transfers land within the run's ~25 ticks
TICK_SECONDS = 10.0


def cluster_topology(expert_bytes: float, n_layers: int):
    """Three servers on 500 Mbps links, server 2 behind a 25 Mbps / 40 ms
    hop. Expert memory as the uniform layout fills it: 3 experts a layer on
    servers 0 and 1, 2 on server 2."""
    from repro_torch.serving.net import ServerProfile, Topology

    column = n_layers * expert_bytes     # one expert in every layer
    profiles = (ServerProfile("e0", mem_bytes=3 * column),
                ServerProfile("e1", mem_bytes=3 * column),
                ServerProfile("e2", mem_bytes=2 * column))
    bw = np.full((3, 3), 500e6 / 8)
    lat = np.full((3, 3), 2e-3)
    bw[0, 2] = bw[2, 0] = bw[1, 2] = bw[2, 1] = 25e6 / 8
    lat[0, 2] = lat[2, 0] = lat[1, 2] = lat[2, 1] = 40e-3
    np.fill_diagonal(lat, 0.0)
    return Topology(profiles, bw, lat)


def cluster_requests(cfg) -> list:
    """12 greedy requests, origins round-robin; each server's prompts come
    from its own task's token source (input locality per server)."""
    from repro_torch.data.pipeline import TaskTokenSource
    from repro_torch.data.traces import BIGBENCH_TASKS
    from repro_torch.serving.api import Request

    srcs = [TaskTokenSource(f"server{n}", cfg.vocab_size, seed=n)
            for n in range(N_SERVERS)]
    return [Request(prompt=srcs[k % N_SERVERS].sample(1, CLUSTER_PROMPT)[0],
                    max_new_tokens=CLUSTER_NEW, origin=k % N_SERVERS,
                    arrival=float(k), task=BIGBENCH_TASKS[k % N_SERVERS])
            for k in range(CLUSTER_REQUESTS)]


def free_device_memory() -> None:
    """Release what a finished phase held: a cluster and its registry
    refer to each other, so its engine goes only when the cycle is
    collected."""
    gc.collect()
    torch.cuda.empty_cache()


def run_cluster_once(engine, requests, finite=None, warmup=False,
                     during=None):
    """One run of the scenario: a DanceMoE controller (staged migration
    over the topology) starting from the uniform plan the engine boots
    with, server ``DEAD`` crashing at ``CRASH_TICK`` with failover on, one
    shared runtime of 12 slots (``warmup``: the warmed loop, 11 graphs).
    ``finite`` collects whether each finished prefill's final-position
    logits were finite. A warmed run sets the launch counts to 0 once its
    warmup is done, so that they count replays alone. ``during`` (a
    context manager, e.g. a profiler) is entered once the cluster is built
    and exited after the run. Returns (cluster, handles, wall seconds)."""
    from repro_torch.core.baselines import uniform_plan
    from repro_torch.core.policies import (ClusterView, PlacementController,
                                           get_policy)
    from repro_torch.serving.cluster import EdgeCluster
    from repro_torch.serving.faults import FaultSchedule
    from repro_torch.serving.net import CommCostModel

    cfg = engine.rt.cfg
    elt = engine.rt.dtype.itemsize
    expert_bytes = 3 * cfg.d_model * cfg.d_ff * elt
    topo = cluster_topology(expert_bytes, engine.n_groups)
    cm = CommCostModel(topology=topo, expert_bytes=expert_bytes,
                       activation_bytes=cfg.d_model * elt,
                       tokens_per_horizon=1e5)
    ctrl = PlacementController(
        policy=get_policy("dancemoe"), cost=cm,
        cluster=ClusterView.from_ep_spec(engine.rt.ep_spec, engine.n_groups),
        interval=REVIEW_TICKS, topology=topo, clock_rate=TICK_SECONDS)
    ctrl.plan = uniform_plan(engine.n_groups, N_SERVERS, cfg.num_experts)
    cluster = EdgeCluster(
        "runtime", engine=engine, n_servers=N_SERVERS, controller=ctrl,
        topology=topo,
        fault_schedule=FaultSchedule.server_crash(CRASH_TICK, DEAD),
        failover=True,
        runtime_opts=dict(max_slots=CLUSTER_REQUESTS, block_size=16,
                          prefix_cache=True, warmup=warmup,
                          warmup_origins="tagged"))
    if finite is not None:
        rt = cluster.backend.runtimes[0]
        finish = rt._finish_prefill

        def checked(i, rid, logits_row, first_tok):
            finite.append(bool(np.isfinite(logits_row).all()))
            return finish(i, rid, logits_row, first_tok)

        rt._finish_prefill = checked
    if warmup:
        reset_counts()
    sync = torch.cuda.synchronize if engine.rt.device == "cuda" else None
    if sync:
        sync()
    with during if during is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        handles = [cluster.submit(r) for r in requests]
        cluster.run()
        if sync:
            sync()
        wall = time.perf_counter() - t0
    return cluster, handles, wall


def cluster_perf_line(cluster, handles, wall) -> str:
    """The pooled ``metrics()["perf"]`` figures of one cluster run."""
    p = cluster.metrics()["perf"]
    n_tok = sum(len(h.result()) for h in handles)
    return (f"{len(handles)} requests / {n_tok} tokens in {wall:.3f}s "
            f"({n_tok / wall:.1f} tok/s) ttft p50={p['ttft_ms']['p50']:.2f}ms "
            f"decode-round p50={p['decode_round_ms']['p50']:.2f}ms "
            f"p99={p['decode_round_ms']['p99']:.2f}ms over "
            f"{p['rounds_timed']} rounds, host_syncs={p['host_syncs']}")


def cluster_victims(cluster, handles) -> tuple:
    """The crash's victims: the indices of the requests served away from
    their origin, and the SERVER_DOWN event's count."""
    down = [e.data["victims"] for e in cluster.events
            if e.type == "SERVER_DOWN"]
    return (tuple(k for k, h in enumerate(handles)
                  if h.server != h.request.origin), tuple(down))


def _plain(x):
    """``x`` as JSON types, for comparing event payloads bit for bit."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return _plain(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def cluster_record(cluster, handles) -> dict:
    """Token streams, the merged event stream as (type, time, seq, data),
    the controller's decisions, the ``faults`` section and the engine's
    activation counts of one run."""
    evs = list(cluster.events) + [e for h in handles for e in h.events]
    evs.sort(key=lambda e: (e.time, e.seq))
    return _plain({
        "tokens": [h.result().tolist() if h.done else None for h in handles],
        "events": [[e.type, e.time, e.seq, e.data] for e in evs],
        "controller": cluster.controller.events,
        "faults": cluster.metrics()["faults"],
        "counts": cluster.backend.engine.stats.counts})


def check_cluster(cluster, handles, finite) -> None:
    """The phase's pass conditions on one run."""
    toks = [h.result() if h.done else None for h in handles]
    if any(t is None or len(t) != CLUSTER_NEW for t in toks):
        raise AssertionError(f"cluster: token counts "
                             f"{[None if t is None else len(t) for t in toks]}")
    if not finite or not all(finite):
        raise AssertionError("cluster: non-finite prefill logits")
    downs = [e for e in cluster.events if e.type == "SERVER_DOWN"]
    if len(downs) != 1 or downs[0].data["victims"] < 1:
        raise AssertionError(f"cluster: the crash caught no victim: {downs}")
    f = cluster.metrics()["faults"]
    if (f["injected"], f["recovered"], f["requests_dropped"]) != (1, 1, 0):
        raise AssertionError(f"cluster: faults section {f}")
    ctrl = cluster.controller.events
    if not any(e.get("adopted") and e["time"] < CRASH_TICK for e in ctrl):
        raise AssertionError("cluster: no live review adopted a plan before "
                             "the crash")
    review = [e for e in ctrl if e.get("fault_review") and e.get("adopted")]
    if not review:
        raise AssertionError("cluster: no fault review re-placed the experts")
    # a recovery plan that moves no expert is applied at once; one that
    # does lands when its staged transfers complete
    if review[0].get("staged") and not any(
            e.type == "MIGRATION_COMPLETED" and e.time >= CRASH_TICK
            for e in cluster.events):
        raise AssertionError("cluster: the recovery placement never landed")
    for rtm in cluster.backend.runtimes:
        rtm.check_invariants()
        rtm.drop_prefix_cache()      # the cache's pages are held, not leaked
        if rtm.allocator.n_free != rtm.allocator.capacity_blocks:
            raise AssertionError("cluster: KV pages leaked: "
                                 f"{rtm.allocator.n_free} of "
                                 f"{rtm.allocator.capacity_blocks} free")


def run_cluster(cfg):
    """Phase 4b: the failover scenario at full width. Returns the launch
    counts of its first run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.cluster import EdgeCluster, MoEProfile
    from repro_torch.core.policies import (ClusterView, PlacementController,
                                           get_policy)

    def build():
        return build_engine(cfg, device="cuda", dtype=torch.bfloat16,
                            max_len=CLUSTER_PROMPT + CLUSTER_NEW + 8,
                            policy="dancemoe", review_rounds=1000,
                            n_ep=N_SERVERS, seed=0)[0]

    t0 = time.perf_counter()
    engine = build()
    torch.cuda.synchronize()
    spec = engine.rt.ep_spec
    print(f"cluster: built {cfg.name} x{cfg.num_layers} layers over "
          f"{spec.n_ep} virtual EP ranks x {spec.slots} slots "
          f"({spec.n_ep * spec.slots} per layer; capacity {spec.capacity}, "
          f"slot capacity {spec.slot_capacity}) in "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    requests = cluster_requests(cfg)
    finite: list = []
    reset_counts()
    cluster, handles, wall = run_cluster_once(engine, requests, finite)
    counts, variants = read_counts()
    check_cluster(cluster, handles, finite)
    if variants["moe_gmm"]["tc"] <= 0:
        raise AssertionError("cluster: the tensor-core moe_gmm never launched")
    m = cluster.metrics()
    net = m["net"]
    down = next(e for e in cluster.events if e.type == "SERVER_DOWN")
    migs = [(e["time"], e.get("reason", "review"), e.get("transfers"),
             round(e.get("eta", e["time"]), 3))
            for e in cluster.controller.events if e.get("adopted")]
    print(f"cluster: sync loop {cluster_perf_line(cluster, handles, wall)}",
          flush=True)
    print(f"cluster: crash of server {DEAD} at tick {CRASH_TICK:.0f}: "
          f"victims={down.data['victims']} reassigned to "
          f"{down.data['reassigned']}, tokens lost {down.data['tokens_lost']}; "
          f"recovery {cluster.backend.recovery_ticks:.0f} ticks; faults="
          f"{m['faults']}; adopted placements (tick, cause, transfers, eta): "
          f"{migs}", flush=True)
    print(f"cluster: local ratio per server {m['per_server']['local_ratio']}; "
          f"dispatch bytes {net['cross_server_bytes']:.0f} over "
          f"{net['rounds']} rounds, per link {net['link_bytes']}; migration "
          f"transfers {net['migrations']}; launches={counts} by variant="
          f"{variants}", flush=True)
    first = cluster_record(cluster, handles)
    victims = cluster_victims(cluster, handles)
    del cluster, handles, engine
    free_device_memory()

    # the replay, on an engine rebuilt from the same seed, under the
    # profiler: the same bits, and the device's busy share of one run
    engine = build()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    cluster, handles, wall = run_cluster_once(engine, requests, during=prof)
    again = cluster_record(cluster, handles)
    for key in first:
        if first[key] != again[key]:
            raise AssertionError(f"cluster: the replay differs in {key}")
    print(f"cluster: replay on a rebuilt engine identical (tokens, "
          f"{len(first['events'])} events, controller decisions, faults, "
          f"activation counts); profiled replay "
          f"{device_busy(prof, wall * 1e6)}", flush=True)
    del prof, cluster, handles, engine
    free_device_memory()

    # the warmed loop, twice, each on a rebuilt engine (the second under
    # the profiler): the sync run's tokens and victims, no eager round, and
    # the same bits both times (the drain is tick-driven)
    warm = []
    for k in range(2):
        engine = build()
        torch.cuda.reset_peak_memory_stats()
        finite = []
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) if k else None)
        cluster, handles, wall = run_cluster_once(
            engine, requests, finite, warmup=True, during=prof)
        wcounts, wvariants = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_cluster(cluster, handles, finite)
        rec = cluster_record(cluster, handles)
        p = cluster.metrics()["perf"]
        rtm = cluster.backend.runtimes[0]
        if rec["tokens"] != first["tokens"]:
            raise AssertionError(
                "cluster: the warmed loop's tokens differ from the "
                "synchronous loop's: "
                f"{[sum(x != y for x, y in zip(a, b)) for a, b in zip(rec['tokens'], first['tokens'])]}"
                f" of {CLUSTER_NEW} differ per request; adopted plans "
                f"{[(e['time'], e.get('transfers')) for e in cluster.controller.events if e.get('adopted')]}"
                f" (sync: {[(e['time'], e.get('transfers')) for e in first['controller'] if e.get('adopted')]})")
        if cluster_victims(cluster, handles) != victims:
            raise AssertionError("cluster: the warmed loop's crash caught "
                                 "other victims than the synchronous loop's")
        if (p["executables_compiled"], p["traces_after_warmup"]) != (11, 0):
            raise AssertionError(f"cluster: warmed loop perf {p}")
        if wvariants["moe_gmm"]["tc"] <= 0:
            raise AssertionError("cluster: the tensor-core moe_gmm never ran "
                                 "in a replay")
        if k == 0:
            counts = {n: counts[n] + wcounts[n] for n in counts}
            print(f"cluster: warmed loop "
                  f"{cluster_perf_line(cluster, handles, wall)} "
                  f"rounds={rtm.rounds}; "
                  f"{p['executables_compiled']} graphs "
                  f"captured in {p['warmup_seconds']:.3f}s, "
                  f"traces_after_warmup={p['traces_after_warmup']}, peak "
                  f"memory {peak / 2**30:.2f} GiB; tokens and victims equal "
                  f"the sync loop's; faults={cluster.metrics()['faults']}; "
                  f"replayed launches={wcounts} by variant={wvariants}",
                  flush=True)
        else:
            for key in ("tokens", "events", "faults"):
                if rec[key] != warm[0][key]:
                    raise AssertionError(f"cluster: the two warmed runs "
                                         f"differ in {key}")
            print(f"cluster: second warmed run on a rebuilt engine identical "
                  f"(tokens, {len(rec['events'])} events, faults); "
                  f"{cluster_perf_line(cluster, handles, wall)}; profiled "
                  f"{device_busy(prof, wall * 1e6)}", flush=True)
        warm.append(rec)
        del prof, cluster, handles, engine, rtm
        free_device_memory()

    # the sim backend on the same Request stream
    profile_ = MoEProfile.from_config(cfg)
    topo = cluster_topology(profile_.expert_bytes, profile_.num_layers)
    sim = EdgeCluster("sim", topology=topo, profile=profile_, seed=0,
                      controller=PlacementController(
                          policy=get_policy("dancemoe"), cost=None,
                          cluster=ClusterView.from_topology(topo, profile_),
                          interval=10.0, topology=topo))
    t0 = time.perf_counter()
    hs = [sim.submit(r) for r in requests]
    sim.run()
    sim_s = time.perf_counter() - t0
    if not all(h.done for h in hs):
        raise AssertionError("cluster: the sim backend left requests open")
    ps = sim.metrics()["per_server"]
    print(f"cluster: sim backend, same {len(hs)} requests in {sim_s:.3f}s: "
          + "; ".join(f"server{n} served={ps['served'][n]} mean_latency="
                      f"{ps['mean_latency'][n]:.4g}s local_ratio="
                      f"{ps['local_ratio'][n]:.3f}" for n in range(N_SERVERS)),
          flush=True)
    return counts


def engine_on(engine, device: str):
    """A copy of ``engine`` on ``device``: the same weights, placement
    tables and dense master, fresh activation statistics."""
    from repro_torch.serving.engine import ServingEngine

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        return tree.to(device)

    return ServingEngine(
        rt=dataclasses.replace(engine.rt, device=device),
        params=move(engine.params),
        placement=(type(engine.placement)(*(a.to(device)
                                            for a in engine.placement))
                   if engine.placement is not None else None),
        dense_master=(move(engine.dense_master)
                      if engine.dense_master is not None else None),
        max_len=engine.max_len)


def run_cluster_reference():
    """Phase 4c: the same scenario on the reduced Mixtral config in fp32 (3
    ranks of 3 slots over its 4 experts), the cluster on the card (kernels)
    against the cluster on the CPU (plain versions) with the same weights:
    identical token streams, event timelines, controller decisions, faults
    section and activation counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine

    cfg = get_config("mixtral-8x7b").reduced()
    cpu_eng, _ = build_engine(cfg, device="cpu", dtype=torch.float32,
                              max_len=CLUSTER_PROMPT + CLUSTER_NEW + 8,
                              policy="dancemoe", review_rounds=1000,
                              n_ep=N_SERVERS, seed=5)
    gpu_eng = engine_on(cpu_eng, "cuda")
    requests = cluster_requests(cfg)
    reset_counts()
    finite: list = []
    card = run_cluster_once(gpu_eng, requests, finite)
    counts, variants = read_counts()
    check_cluster(*card[:2], finite)
    cpu = run_cluster_once(cpu_eng, requests)
    want, got = cluster_record(*cpu[:2]), cluster_record(*card[:2])
    for key in want:
        if want[key] != got[key]:
            raise AssertionError(f"cluster-reference: card and CPU differ in "
                                 f"{key}")
    if variants["moe_gmm"]["simt"] <= 0:
        raise AssertionError("cluster-reference: the CUDA-core moe_gmm never "
                             "launched in fp32")
    print(f"cluster-reference: {cfg.name} fp32 over {N_SERVERS} ranks x "
          f"{gpu_eng.rt.ep_spec.slots} slots, {CLUSTER_REQUESTS} requests "
          f"through a crash, card vs CPU plain versions: tokens, "
          f"{len(want['events'])} events, controller decisions, faults and "
          f"activation counts identical; launches={counts} by variant="
          f"{variants}", flush=True)


def run_reference():
    """Phase 5: small model, fp32, port on the card vs port on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine

    cfg = get_config("mixtral-8x7b").reduced()
    eng, _ = build_engine(cfg, device="cuda", dtype=torch.float32, max_len=48,
                          policy="dancemoe", review_rounds=8, seed=5)
    cpu_eng = engine_on(eng, "cpu")
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


def run_reference_variants():
    """Phase 5, the serving variants: the reduced configs in fp32, the
    port on the card (kernels) against the port on the CPU (plain
    versions), same weights and requests. Windowed Mixtral (window 16,
    prompts of 24: a ring) through the dense pool; int8 Mixtral on the
    paged pool, synchronous and warmed; sampled Mixtral (temperature 0.8
    on every other request), synchronous and warmed; Falcon-Mamba and
    Zamba2 through the dense pool. Fails unless every variant's prefill
    logits agree within 1e-4 and its token streams are identical on both
    devices and loops, and the threefry keys, bits and uniforms on the card
    equal the CPU's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import sampling
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    t_phase = time.perf_counter()
    seeds = np.array([0, 1, 2**31 - 1, 2**32 - 1], np.uint32)
    pos = np.array([0, 5, 2**20, 77], np.uint32)
    k_cpu, k_gpu = sampling.keys(seeds, pos), sampling.keys(seeds, pos, "cuda")
    bits_cpu = sampling.random_bits(*k_cpu, 32000)
    bits_gpu = sampling.random_bits(*k_gpu, 32000)
    if not (all(torch.equal(a, b.cpu()) for a, b in zip(k_cpu, k_gpu))
            and torch.equal(bits_cpu, bits_gpu.cpu())
            and all(torch.equal(sampling.uniform(bits_cpu, dt),
                                sampling.uniform(bits_gpu, dt).cpu())
                    for dt in (torch.float32, torch.bfloat16))):
        raise AssertionError("reference: threefry on the card differs from "
                             "the CPU")

    def serve(engine, prompts, temperature=0.0, **kw):
        rt = ServingRuntime(engine, max_slots=4, block_size=8, **kw)
        hs = [rt.enqueue(Request(prompt=p, max_new_tokens=8,
                                 temperature=temperature if k % 2 else 0.0,
                                 seed=SAMPLE_SEED + k))
              for k, p in enumerate(prompts)]
        rt.run()
        if rt.warmup and rt.traces_after_warmup:
            raise AssertionError(f"reference: {rt.traces_after_warmup} "
                                 "eager rounds on the warmed loop")
        return [h.result().tolist() for h in hs]

    mix = get_config("mixtral-8x7b").reduced()
    base, _ = build_engine(mix, device="cuda", dtype=torch.float32,
                           max_len=48, policy="dancemoe", review_rounds=1000,
                           seed=5)
    cases = [("window", base, dict(window=16), {}, 0.0),
             ("int8", base, dict(kv_quant=True), {"warmup": True}, 0.0),
             ("sampled", base, {}, {"warmup": True}, SAMPLE_TEMPERATURE)]
    for arch in SSM_ARCHS:
        eng, _ = build_engine(get_config(arch).reduced(), device="cuda",
                              dtype=torch.float32, max_len=48,
                              policy="dancemoe", review_rounds=1000, seed=5)
        cases.append((arch, eng, {}, {}, 0.0))
    reset_counts()
    lines = []
    for name, eng0, changes, loops, temperature in cases:
        card = engine_variant(eng0, **changes)
        cpu = engine_on(card, "cpu")
        prompts = np.random.default_rng(1).integers(
            0, card.rt.cfg.vocab_size, (4, 24)).astype(np.int32)
        lg, _, _ = card._prefill(card.params, prompts, card.placement)
        lc, _, _ = cpu._prefill(cpu.params, prompts, cpu.placement)
        err = float((lg.cpu() - lc).abs().max())
        if not err <= 1e-4 * max(float(lc.abs().max()), 1.0):
            raise AssertionError(f"reference {name}: logits differ by "
                                 f"{err:.3e}")
        want = serve(cpu, prompts, temperature)
        got = {"sync": serve(card, prompts, temperature)}
        if loops.get("warmup"):
            got["warmed"] = serve(card, prompts, temperature, warmup=True,
                                  warmup_origins="untagged")
        for loop, toks in got.items():
            if toks != want:
                raise AssertionError(f"reference {name}: the card's {loop} "
                                     "loop's tokens differ from the CPU's")
        lines.append(f"{name} (logits max err {err:.3e}; "
                     f"{'/'.join(got)} loops)")
        del card, cpu
    counts, variants = read_counts()
    for kname in ("flash_attention", "moe_gmm"):
        if variants[kname]["simt"] <= 0:
            raise AssertionError(f"reference: the CUDA-core {kname} never "
                                 "launched in fp32")
    # the int8 and sampled Mixtral serve on the paged pool
    if min(variants["paged_attention"].values()) <= 0:
        raise AssertionError("reference: the paged attention kernel never "
                             f"ran in fp32: {variants['paged_attention']}")
    print(f"reference: serving variants, card vs CPU plain versions, fp32: "
          f"threefry keys, bits and uniforms identical; "
          + "; ".join(lines) + f"; token streams identical; launches="
          f"{counts} by variant={variants}; phase took "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)


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


# the profile's kernel groups: (group, name substrings), first match wins
# (flash_bwd_{delta,dq,dkdv}{,_tc,_wg}; gmm_tc, gmm_rows,
# gmm_bwd_{gate,dx,dw13,dw2} and the CUDA cores' gmm_up, gmm_down,
# bwd::gemm)
PROFILE_GROUPS = [("ssm_fwd", ("ssm_fwd",)), ("ssm_bwd", ("ssm_bwd",)),
                  ("flash_fwd", ("flash_fwd",)),
                  ("flash_bwd", ("flash_bwd",)),
                  ("moe_gmm", ("gmm_", "bwd::gemm", "gate_reduce",
                               "down_reduce")),
                  ("gemm", ("gemm", "cutlass", "xmma", "nvjet"))]


def profile_train_step(rt, params, batch, label="train-profile",
                       placement=None):
    """One more forward and backward (no update) under ``torch.profiler``:
    device time by kernel, grouped into the library's matrix products, the
    hand-written kernels (``PROFILE_GROUPS``) and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.train_loop import loss_and_grads

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss_and_grads(rt, params, *batch, placement=placement)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
    if not by_name:
        print(f"{label}: no device events recorded (not measured)")
        return
    total = sum(by_name.values())
    groups = dict.fromkeys([g for g, _ in PROFILE_GROUPS] + ["other"], 0.0)
    for name, ms in by_name.items():
        low = name.lower()
        hit = next((g for g, keys in PROFILE_GROUPS
                    if any(k in low for k in keys)), "other")
        groups[hit] += ms
    groups = {k: v for k, v in groups.items() if v > 0}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label}: forward+backward {wall_ms:.1f} ms wall, device "
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


# Mixtral-8x7B at full published width (arXiv:2401.04088: d_model 4096,
# 32 q heads over 8 KV heads of 128, d_ff 14336, 8 experts top-2, vocab
# 32000), depth cut to 2 of 32 layers, bf16 parameters with fp32 AdamW
# moments
MIXTRAL_TRAIN_LAYERS = 2


def run_train_mixtral():
    """Phase 6, attention and MoE: 4 dense-MoE AdamW steps of B = 2,
    T = 2048 through ``launch.train.build_trainer``, then one EP train step
    (``moe_impl="ep"``, one rank holding the 8 experts, the serve phase's
    capacities) of B = 1, T = 2048. Returns the launch counts of both."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import train_batches
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import adamw, cosine_schedule, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=MIXTRAL_TRAIN_LAYERS)
    L = cfg.num_layers
    B, T, steps = 2, 2048, 4
    batches = list(train_batches(cfg.vocab_size, B, T, steps))
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt, params, state, step_fn = build_trainer(
        cfg, device="cuda", dtype=torch.bfloat16, lr=3e-4, steps=steps)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"train-mixtral: built {cfg.name} x{L} layers (d_model "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.num_experts} experts top-"
          f"{cfg.top_k}, vocab {cfg.vocab_size}) = {n_params / 1e9:.3f} B "
          f"params bf16, fp32 AdamW moments, dense MoE, in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    reset_counts()
    fa.bwd_launches = 0
    step_ms = []
    for i, (tok, tgt) in enumerate(batches):
        f0, b0 = fa.launches, fa.bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, tok, tgt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"train-mixtral: step {i} loss {loss} grad "
                                 f"norm {gnorm}")
        got = (fa.launches - f0, fa.bwd_launches - b0)
        # per layer: the forward, its recompute under checkpointing, and
        # the backward
        if got != (2 * L, L):
            raise AssertionError(f"train-mixtral: step {i} flash launches "
                                 f"fwd/bwd {got}, expected {(2 * L, L)}")
        print(f"train-mixtral: step {i} loss={loss:.5f} grad_norm="
              f"{gnorm:.5f} {step_ms[-1]:.1f} ms flash launches fwd="
              f"{got[0]} bwd={got[1]}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(step_ms[1:]))
    counts = {"flash_attention_bwd": fa.bwd_launches}
    print(f"train-mixtral: {steps} steps of {B}x{T} tokens, steady step "
          f"(steps 1-3) {steady:.1f} ms = {B * T / steady * 1e3:.0f} "
          f"tokens/s, first step {step_ms[0]:.1f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    profile_train_step(rt, params, batches[0], "train-mixtral-profile")
    del params, state, step_fn, rt
    free_device_memory()

    # one EP train step: the expert FFN on moe_gmm, forward and backward
    B = 1
    tok, tgt = next(iter(train_batches(cfg.vocab_size, B, T, 1)))
    spec = M.EPSpec.build(1, cfg, slots=cfg.num_experts, capacity=8192,
                          slot_capacity=16384)
    rt = tr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec,
                    dtype=torch.bfloat16, device="cuda")
    params = tr.init_params(rt, 0)
    placement = M.placement_to(tr.stack_placement(
        M.uniform_placement(1, spec.slots, cfg.num_experts),
        cfg.layer_pattern()[1]), "cuda")
    opt = adamw(schedule=cosine_schedule(3e-4, 10, 4))
    state = opt.init(params)
    step_fn = make_train_step(rt, opt)
    reset_counts()
    f0, fb0, gb0 = fa.launches, fa.bwd_launches, gmm.bwd_launches
    # the step's own peak: the counter starts at what the model and the
    # optimizer state hold before it
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, m = step_fn(params, state, tok, tgt, placement)
    torch.cuda.synchronize()
    ep_ms = (time.perf_counter() - t0) * 1e3
    ep_peak = torch.cuda.max_memory_allocated()
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"train-mixtral: EP step loss {loss} grad norm "
                             f"{gnorm}")
    _, variants = read_counts()
    # 4096 routed rows (max_fill above the crossover): the row tiles
    got = {"moe_gmm.tc": variants["moe_gmm"]["tc"],
           "moe_gmm.rows": variants["moe_gmm"]["rows"],
           "moe_gmm_bwd": gmm.bwd_launches - gb0,
           "flash_attention_bwd": fa.bwd_launches - fb0}
    want = {"moe_gmm.tc": 2 * L, "moe_gmm.rows": 2 * L, "moe_gmm_bwd": L,
            "flash_attention_bwd": L}
    if got != want:
        raise AssertionError(f"train-mixtral: EP step launches {got}, "
                             f"expected {want}")
    print(f"train-mixtral: one EP train step (1 rank x {spec.slots} slots, "
          f"capacity {spec.capacity}, slot capacity {spec.slot_capacity}) of "
          f"{B}x{T} tokens: loss={loss:.5f} grad_norm={gnorm:.5f} "
          f"local_frac={float(m['local_frac']):.3f} {ep_ms:.1f} ms; the "
          f"step's peak memory {ep_peak / 2**30:.2f} GiB "
          f"({(ep_peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held before it); launches {got}",
          flush=True)
    profile_train_step(rt, params, (tok, tgt), "train-mixtral-ep-profile",
                       placement)
    counts["flash_attention_bwd"] += got["flash_attention_bwd"]
    counts["moe_gmm_bwd"] = got["moe_gmm_bwd"]
    counts["moe_gmm"] = counts["moe_gmm_rows"] = got["moe_gmm.rows"]
    del rt, params, state, step_fn, placement
    free_device_memory()
    return counts, step_ms


def train_reference_pair(arch, n_ep, seed=3, lr=1e-2):
    """One reduced model on the CPU and its copy on the card, with AdamW
    states and train steps: the dense-MoE trainer of ``launch.train``, or
    (``n_ep``) the EP model of ``launch.serve.build_engine`` over ``n_ep``
    virtual ranks, uniform placement, capacities cut to a train batch's.
    Returns ((rt, params, state, step, placement) on the CPU, the same on
    the card)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import moe as M
    from repro_torch.optim.adamw import adamw, cosine_schedule, tree_map
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(arch).reduced()
    if n_ep:
        eng, _ = build_engine(cfg, device="cpu", dtype=torch.float32,
                              max_len=8, policy="uniform", review_rounds=1000,
                              seed=seed, n_ep=n_ep)
        spec = dataclasses.replace(eng.rt.ep_spec, capacity=256,
                                   slot_capacity=512)
        rt = dataclasses.replace(eng.rt, ep_spec=spec)
        params, placement = eng.params, eng.placement
        opt = adamw(schedule=cosine_schedule(lr, 10, 4))
        state, step = opt.init(params), make_train_step(rt, opt)
    else:
        rt, params, state, step = build_trainer(
            cfg, device="cpu", dtype=torch.float32, lr=lr, steps=4, seed=seed)
        placement = None
    gparams = tree_map(lambda a: a.cuda(), params)
    gstate = {k: tree_map(lambda a: a.cuda(), state[k]) for k in ("m", "v")}
    gstate["step"] = state["step"]
    gplacement = (M.EPPlacement(*(a.cuda() for a in placement))
                  if placement is not None else None)
    return ((rt, params, state, step, placement),
            (dataclasses.replace(rt, device="cuda"), gparams, gstate, step,
             gplacement))


# (arch, EP ranks or 0 for the dense MoE, tokens per row, gradient
# tolerance). Zamba2's fp32 gradients are not reproducible to 1e-4 of a
# leaf's largest value on any device: against the CPU's float64 gradients,
# over four seeds and lengths, the CPU's own fp32 run reached 3.1e-4, the
# card with the plain attention 2.2e-4, the card with the kernels 5.6e-4
# (and 4.0e-4 against the CPU's fp32), on Mamba-2 leaves such as the
# 16-element D (``python3 tools/train_checks.py grads``); so Zamba2 is held
# to 1e-3
TRAIN_REFERENCE_CASES = [("mixtral-8x7b", 0, 200, 1e-4),
                         ("mixtral-8x7b", 3, 200, 1e-4),
                         ("zamba2-2.7b", 0, 48, 1e-3)]


def run_train_reference_attn():
    """Phase 7, attention and MoE: reduced dense Mixtral, EP Mixtral over 3
    virtual ranks and Zamba2 (shared attention) in fp32, one train step on
    the card against the CPU over the same weights (2 rows of T tokens,
    ragged against the flash backward's 32-row tiles): loss 1e-5 relative,
    every gradient leaf within 1e-4 of its largest value (Zamba2: 1e-3, see
    ``TRAIN_REFERENCE_CASES``), the parameters after one AdamW step within
    2 x its learning rate."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.train_loop import loss_and_grads

    lr = 1e-2  # warmup of 10 steps: the first step's rate is 1e-3
    for arch, n_ep, T, grad_tol in TRAIN_REFERENCE_CASES:
        t0 = time.perf_counter()
        cpu, card = train_reference_pair(arch, n_ep, lr=lr)
        rng = np.random.default_rng(0)
        tok = rng.integers(0, cpu[0].cfg.vocab_size, (2, T))
        tgt = np.roll(tok, -1, 1)
        loss, _, grads = loss_and_grads(cpu[0], cpu[1], tok, tgt,
                                        placement=cpu[4])
        before = (fa.bwd_launches, gmm.bwd_launches)
        gloss, _, ggrads = loss_and_grads(card[0], card[1], tok, tgt,
                                          placement=card[4])
        ran = (fa.bwd_launches - before[0], gmm.bwd_launches - before[1])
        if ran[0] <= 0 or (n_ep and ran[1] <= 0):
            raise AssertionError(f"train-reference {arch}: backward launches "
                                 f"(flash, moe_gmm) {ran}")
        rel = abs(float(gloss) - float(loss)) / abs(float(loss))
        if not rel <= 1e-5:
            raise AssertionError(f"train-reference {arch}: loss differs by "
                                 f"{rel:.3e}")
        worst = max(float((g.cpu() - w).abs().max())
                    / max(float(w.abs().max()), 1e-30)
                    for g, w in zip(tree_leaves(ggrads), tree_leaves(grads)))
        if not worst <= grad_tol:
            raise AssertionError(f"train-reference {arch}: gradient differs "
                                 f"by {worst:.3e}")
        cpu[3](cpu[1], cpu[2], tok, tgt, cpu[4])
        card[3](card[1], card[2], tok, tgt, card[4])
        dp = max(float((g.detach().cpu() - w.detach()).abs().max())
                 for g, w in zip(tree_leaves(card[1]), tree_leaves(cpu[1])))
        if not dp <= 2 * lr / 10:
            raise AssertionError(f"train-reference {arch}: parameters after "
                                 f"one AdamW step differ by {dp:.3e}")
        print(f"train-reference: {arch}" + (f" EP x{n_ep}" if n_ep else "")
              + f" fp32 2x{T} tokens, card vs CPU: loss rel err {rel:.3e}, "
              f"worst gradient leaf {worst:.3e} of its max (tol "
              f"{grad_tol:g}), parameters after "
              f"one AdamW step within {dp:.3e}; backward launches (flash, "
              f"moe_gmm) {ran}; {time.perf_counter() - t0:.1f}s", flush=True)


# Phase 8, the launch tooling: the meta dry run of every assigned arch at
# every input shape in spawned processes (single-threaded Python each; the
# card's machine has 8 cores), while the main process runs the card leg
LAUNCH_WORKERS = 6
# the card leg: Mixtral-8x7B at full published width, bf16, at 1 and 2 of
# its 32 layers (perf.run_variant: batch cut to perf.CARD_BATCH, train 1
# of 256, prefill 1 of 32, decode 8 of 128): on one card without a mesh
# (EP on one virtual rank) the four cases of earlier runs; then every one
# of the reference's 16 variants on perf.CARD_MESH, a virtual (1, 8) mesh
# (EP over 8 virtual ranks of 2 slots), train_4k but kv8 at decode_32k:
# (shape, variant, mesh)
LAUNCH_ARCH = "mixtral-8x7b"
LAUNCH_CARD_CASES = [("train_4k", "baseline", "1xH100"),
                     ("train_4k", "tp+dots", "1xH100"),
                     ("prefill_32k", "baseline", "1xH100"),
                     ("decode_32k", "baseline", "1xH100")]
# variants whose first train loss must equal the first one's of their
# group: a remat policy changes what is kept, not what is computed
LAUNCH_SAME_LOSS = [("baseline", "tp+dots"), ("sp", "sp+dots", "sp+dots+kv"),
                    ("cp", "cp+dots", "cp+dots+kv"), ("fsdp", "fsdp+dots+kv"),
                    ("fsdp+cf1", "fsdp+dots+kv+cf1")]


def launch_card_cases() -> list:
    from repro_torch.launch import perf

    return LAUNCH_CARD_CASES + [
        ("decode_32k" if v == "kv8" else "train_4k", v, perf.CARD_MESH)
        for v in perf.VARIANTS]


def launch_pairs() -> list:
    """Every (arch, shape), the longest first: the Mamba and hybrid
    prefills at 32k tokens (about a minute of meta ops each), Zamba2's
    train step, then every train step (512 loss chunks each)."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.dryrun import ASSIGNED_ARCHS

    slow = [("falcon-mamba-7b", "prefill_32k"), ("zamba2-2.7b", "prefill_32k"),
            ("zamba2-2.7b", "train_4k")]
    rest = [(a, s) for s in INPUT_SHAPES for a in ASSIGNED_ARCHS
            if (a, s) not in slow]
    return slow + rest


def run_launch_card() -> tuple:
    """The card leg of phase 8. Returns (the records by case, the launch
    counts of the leg)."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch import perf

    reset_counts()
    fa.bwd_launches = gmm.bwd_launches = 0
    recs, total = {}, {}
    for shape, variant, mesh_name in launch_card_cases():
        before = (fa.launches, fa.bwd_launches, gmm.launches,
                  gmm.bwd_launches)
        designs = dict(gmm.launches_by_design)
        free_device_memory()
        t0 = time.perf_counter()
        rec = perf.run_variant(LAUNCH_ARCH, shape, variant, device="cuda",
                               mesh=mesh_name)
        if not rec["ok"]:
            raise AssertionError(f"launch-card {shape} {variant}: "
                                 f"{rec['error']}\n{rec['traceback']}")
        ran = [a - b for a, b in zip((fa.launches, fa.bwd_launches,
                                      gmm.launches, gmm.bwd_launches), before)]
        kind = INPUT_SHAPES[shape].kind
        # each depth (1 and 2 layers: 3 layers in all) runs a warm-up step,
        # perf.REPS timed steps and, in train, one forward and backward
        # alone; a train layer runs each forward kernel twice (once more
        # when its checkpointed group is recomputed) and each backward once
        passes = 3 * (1 + perf.REPS + (kind == "train"))
        fwd = 2 * passes if kind == "train" else passes
        bwd = passes if kind == "train" else 0
        want = [0 if kind == "decode" else fwd, bwd, fwd, bwd]
        if ran != want:
            raise AssertionError(f"launch-card {shape} {variant}: launches "
                                 f"(flash fwd, bwd, moe_gmm fwd, bwd) {ran}, "
                                 f"expected {want}")
        by_design = {k: v - designs[k]
                     for k, v in gmm.launches_by_design.items()}
        # on one rank decode routes 16 rows (the stream), train and
        # prefill thousands (max_fill above the crossover: the row tiles);
        # on the (1, 8) mesh a capacity factor sets max_fill
        want_design = {"stream": 0, "rows": fwd}
        if kind == "decode":
            want_design = {"stream": passes, "rows": 0}
        if mesh_name == "1xH100" and by_design != want_design:
            raise AssertionError(f"launch-card {shape} {variant}: moe_gmm "
                                 f"launches by design {by_design}, expected "
                                 f"{want_design}")
        for k, v in zip(("flash_attention", "flash_attention_bwd", "moe_gmm",
                         "moe_gmm_bwd", "moe_gmm_rows"),
                        ran + [by_design["rows"]]):
            total[k] = total.get(k, 0) + v
        tag = f"{LAUNCH_ARCH} {shape} {variant} on {mesh_name}"
        for n, d in zip((1, 2), rec["depth"]):
            print(f"launch-card: {tag} x{n} "
                  f"layer(s), B={rec['reduced']['global_batch'][1]}: step "
                  f"{d['step_s'] * 1e3:.2f} ms, arguments "
                  f"{d['argument_size_in_bytes'] / 2**30:.2f} GiB, step peak "
                  f"{(d['argument_size_in_bytes'] + d['temp_size_in_bytes']) / 2**30:.2f}"
                  " GiB" + (f"; forward: {d['saved_bytes'] / 2**30:.3f} GiB "
                            f"left for the backward, peak "
                            f"{d['fwd_peak_bytes'] / 2**30:.3f} GiB; forward "
                            f"and backward peak "
                            f"{d['fwd_bwd_bytes'] / 2**30:.3f} GiB (each "
                            "above the arguments)" if "saved_bytes" in d
                            else "")
                  + f"; first {d['first']:.6f}", flush=True)
        ro = rec["roofline"]
        print(f"launch-card: {tag} at 32 layers (extrapolated): step {rec['step_s'] * 1e3:.1f} ms, mfu "
              f"{rec['mfu']:.4f}; roofline compute {ro['compute_s'] * 1e3:.1f}"
              f" ms, memory {ro['memory_s'] * 1e3:.1f} ms, collective "
              f"{ro['collective_s'] * 1e3:.2f} ms ({ro['dominant']}); "
              f"arguments {rec['argument_size_in_bytes'] / 2**30:.1f} GiB; "
              f"launches {ran}, moe_gmm by design {by_design}; "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        recs[shape, variant, mesh_name] = rec
    base = recs["train_4k", "baseline", "1xH100"]
    dots = recs["train_4k", "tp+dots", "1xH100"]
    for n, (b, d) in enumerate(zip(base["depth"], dots["depth"]), 1):
        if d["first"] != b["first"]:
            raise AssertionError(f"launch-card: x{n} tp+dots loss "
                                 f"{d['first']} != baseline {b['first']}")
        for k in ("saved_bytes", "fwd_peak_bytes"):
            if not d[k] > b[k]:
                raise AssertionError(f"launch-card: x{n} tp+dots {k} {d[k]} "
                                     f"not above baseline's {b[k]}")
    b2, d2 = base["depth"][1], dots["depth"][1]
    print(f"launch-card: tp+dots at 32 layers (extrapolated): "
          f"{(dots['saved_bytes'] - base['saved_bytes']) / 2**30:+.3f} GiB "
          f"left for the backward, step "
          f"{(dots['step_s'] - base['step_s']) * 1e3:+.1f} ms, counted FLOPs "
          f"{dots['hlo_flops'] / base['hlo_flops'] - 1:+.2%}; at 2 layers "
          f"the forward peak {(d2['fwd_peak_bytes'] - b2['fwd_peak_bytes']) / 2**30:+.3f}"
          f" GiB, the forward and backward peak "
          f"{(d2['fwd_bwd_bytes'] - b2['fwd_bwd_bytes']) / 2**30:+.3f} GiB; "
          "the same loss at 1 and 2 layers", flush=True)
    check_mesh_variants(recs)
    return recs, total


def check_mesh_variants(recs) -> None:
    """The 16 variants on the (1, 8) mesh: a remat policy keeps the first
    loss of its layout (``LAUNCH_SAME_LOSS``), ``dots+kv`` under cp leaves
    more for the backward than ``dots`` (the gathered k/v it keeps), and
    capacity factor 0.5 under sp drops rows that sp keeps (another loss)."""
    from repro_torch.launch import perf

    on = {v: recs[s, v, perf.CARD_MESH] for s, v, m in launch_card_cases()
          if m == perf.CARD_MESH}
    for group in LAUNCH_SAME_LOSS:
        for v in group[1:]:
            for n, (a, b) in enumerate(zip(on[group[0]]["depth"],
                                           on[v]["depth"]), 1):
                if a["first"] != b["first"]:
                    raise AssertionError(
                        f"launch-card (1, 8): x{n} {v} loss {b['first']} != "
                        f"{group[0]}'s {a['first']}")
    for n, (a, b) in enumerate(zip(on["cp+dots"]["depth"],
                                   on["cp+dots+kv"]["depth"]), 1):
        if not b["saved_bytes"] > a["saved_bytes"]:
            raise AssertionError(
                f"launch-card (1, 8): x{n} cp+dots+kv keeps "
                f"{b['saved_bytes']} bytes, cp+dots {a['saved_bytes']}")
    if on["sp+cf05"]["depth"][0]["first"] == on["sp"]["depth"][0]["first"]:
        raise AssertionError("launch-card (1, 8): sp+cf05 loss equals sp's")
    for v, r in on.items():
        d1 = r["depth"][0]
        print(f"launch-card (1, 8) {v:17s}: first {d1['first']:.6f}; step at "
              f"32 layers (extrapolated) {r['step_s'] * 1e3:.1f} ms, mfu "
              f"{r['mfu']:.4f}" + (
                  f"; at 1 layer {d1['saved_bytes'] / 2**30:.3f} GiB left for "
                  "the backward" if "saved_bytes" in d1 else ""), flush=True)


def run_launch():
    """Phase 8: the meta dry run of all 40 (arch, shape) pairs (in
    ``LAUNCH_WORKERS`` processes) and the card leg (main process) at the
    same time. Fails unless every pair is ``ok`` and the card leg's checks
    hold. Returns the card leg's launch counts."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    pool = ProcessPoolExecutor(
        LAUNCH_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        futs = [(p, pool.submit(dryrun.run_one, *p)) for p in launch_pairs()]
        _, counts = run_launch_card()
        t_card = time.perf_counter() - t_phase
        sweep = [(p, f.result()) for p, f in futs]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    bad = [(p, r.get("error")) for p, r in sweep if not r["ok"]]
    if bad:
        raise AssertionError(f"launch-meta: pairs failed: {bad}")
    for (arch, shape), r in sweep:
        ro = r["roofline"]
        print(f"launch-meta: {arch} {shape}: compute {ro['compute_s']:.4g} s,"
              f" memory {ro['memory_s']:.4g} s, collective "
              f"{ro['collective_s']:.4g} s, dominant {ro['dominant']}; "
              f"arguments {r['argument_size_in_bytes'] / 2**30:.1f} GiB of "
              f"the card's {mesh.HBM_BYTES / 2**30:.0f} GiB; FLOPs "
              f"{r['hlo_flops']:.4g}, useful {ro['useful_flops_ratio']:.3f}; "
              f"{r['total_s']}s", flush=True)
    print(f"launch: {len(sweep)} meta pairs ok ({LAUNCH_WORKERS} processes), "
          f"card leg {t_card:.1f}s, phase took "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    return counts


# Phase 9, the mesh: reduced Mixtral (d_model 256, 4 experts top-2, 2
# layers) in fp32 on a virtual 2x4 (data, model) mesh with EP over both
# axes (8 virtual ranks of 2 slots; ``dryrun.make_runtime``'s geometry at
# 4 x 128 tokens), the card against the CPU over the same weights
MESH_B, MESH_T = 4, 128
MESH_LR = 1e-2  # warmup of 10 steps: the first step's rate is 1e-3


def mesh_runtimes(shape_name, layout, cf, **changes):
    """(CPU runtime, card runtime) of reduced Mixtral on the 2x4 mesh at a
    cut shape, fp32, capacity factor ``cf``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun

    shape = dataclasses.replace(INPUT_SHAPES[shape_name],
                                global_batch=MESH_B, seq_len=MESH_T)
    rt = dryrun.make_runtime(get_config("mixtral-8x7b").reduced(), shape,
                             mesh.make_test_mesh(2, 4), device="cpu",
                             dtype=torch.float32, layout=layout,
                             moe_overrides={"capacity_factor": cf})
    rt = dataclasses.replace(rt, **changes)
    return rt, dataclasses.replace(rt, device="cuda")


def run_mesh():
    """Phase 9: on the 2x4 mesh, the EP layer of the sp+cf05 geometry
    (sequence blocks, capacity factor 0.5: the rows it drops, its counts
    and local ratio exactly; outputs within fp32's 1e-4), the sp+cf05
    prefill (logits within 1e-4; per-origin counts and local ratio
    exactly), one fsdp train step (AdamW; loss and gradient norm 1e-5
    relative, the local ratio exactly, every gradient leaf within 1e-4 of
    its largest value, and a negated gradient must fail that reading) and
    greedy decode with ``cache_seq_sharded`` (the cache placed
    over all 8 devices; identical tokens, logits within 1e-4): the card
    (kernels) against the CPU (plain versions). Fails unless the card ran
    ``moe_gmm`` and flash attention forward and backward. Returns the
    phase's launch counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch import dryrun
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import (adamw, cosine_schedule, tree_leaves,
                                         tree_map)
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)

    t_phase = time.perf_counter()
    reset_counts()
    bwd0 = (fa.bwd_launches, gmm.bwd_launches)
    rng = np.random.default_rng(0)
    cpu_rt, card_rt = mesh_runtimes("prefill_32k", "sp", 0.5)
    cfg = cpu_rt.cfg
    params = tr.init_params(cpu_rt, seed=5)
    pl_np = dryrun.placement_specs(cfg, cpu_rt)
    both = ((cpu_rt, params, M.placement_to(pl_np, "cpu")),
            (card_rt, tree_map(lambda a: a.cuda(), params),
             M.placement_to(pl_np, "cuda")))
    tok = rng.integers(0, cfg.vocab_size, (MESH_B, MESH_T))

    # the EP layer alone: the drops of each device's sequence block
    blk = next(k for k, v in params["groups"].items() if "router" in v)
    h = torch.from_numpy(rng.standard_normal(
        (MESH_B, MESH_T, cfg.d_model)).astype(np.float32))
    spec = cpu_rt.ep_spec
    uncapped = dataclasses.replace(spec, capacity=4096, slot_capacity=4096)
    layer = []
    for rt, p, pl in both:
        p0 = {k: v[0] for k, v in p["groups"][blk].items()}
        pl0 = M.EPPlacement(*(a[0] for a in pl))
        outs = [M.moe_apply_ep(p0, cfg, h.to(rt.device), spec=sp_,
                               placement=pl0, mode="prefill", mesh=rt.mesh,
                               seq_sharded_out=True) for sp_ in (spec, uncapped)]
        dropped = (outs[0][0] - outs[1][0]).abs().amax(-1).cpu() > 1e-4
        layer.append((outs[0][0].cpu(), outs[0][1], dropped))
    err, _ = check_close("mesh: EP layer sp+cf05", layer[1][0], layer[0][0],
                         "float32")
    if not torch.equal(layer[0][2], layer[1][2]) or not layer[0][2].any():
        raise AssertionError(f"mesh: dropped rows differ or none: card "
                             f"{int(layer[1][2].sum())}, CPU "
                             f"{int(layer[0][2].sum())}")
    for k in ("counts_per_rank", "local_frac"):
        if not torch.equal(layer[1][1][k].cpu(), layer[0][1][k]):
            raise AssertionError(f"mesh: EP layer {k} differs")
    print(f"mesh: EP layer sp+cf05 on 2x4 (8 ranks x {spec.slots} slots, C "
          f"{spec.capacity}, C2 {spec.slot_capacity}), card vs CPU: "
          f"{int(layer[0][2].sum())} of {MESH_B * MESH_T} rows dropped on "
          f"both, out err {err:.3e}, local_frac "
          f"{float(layer[0][1]['local_frac']):.6f} on both", flush=True)

    # sp+cf05 prefill through the entry point
    pre = [tr.prefill(rt, p, tokens=tok, placement=pl) for rt, p, pl in both]
    err, _ = check_close("mesh: sp+cf05 prefill logits", pre[1][0].cpu(),
                         pre[0][0], "float32")
    for k in ("counts_per_rank", "local_frac"):
        if not torch.equal(pre[1][2][k].cpu(), pre[0][2][k]):
            raise AssertionError(f"mesh: sp+cf05 prefill {k} differs")
    print(f"mesh: sp+cf05 prefill {MESH_B}x{MESH_T}, card vs CPU: logits err "
          f"{err:.3e}, counts_per_rank and local_frac "
          f"{[round(float(x), 6) for x in pre[0][2]['local_frac']]} equal",
          flush=True)

    # one fsdp train step: its gradients leaf by leaf, then the step
    f_cpu, f_card = mesh_runtimes("train_4k", "fsdp", 2.0)
    tgt = np.roll(tok, -1, 1)
    grads, stepped = [], []
    for rt, (_, p, pl) in zip((f_cpu, f_card), both):
        p = tree_map(lambda a: a.detach().clone(), p)
        grads.append(loss_and_grads(rt, p, tok, tgt, pl)[2])
        opt = adamw(schedule=cosine_schedule(MESH_LR, 10, 4))
        stepped.append(make_train_step(rt, opt)(p, opt.init(p), tok, tgt,
                                                pl)[2])
    (m_c, m_g), (g_c, g_g) = stepped, grads

    def worst_leaf(card):
        """The largest |card - CPU| of a gradient leaf over the leaf's
        largest |CPU| value."""
        return max(float((g.cpu() - w).abs().max())
                   / max(float(w.abs().max()), 1e-30)
                   for g, w in zip(card, tree_leaves(g_c)))

    worst = worst_leaf(tree_leaves(g_g))
    # the control: the same reading of a negated gradient must fail
    control = worst_leaf([-g for g in tree_leaves(g_g)])
    rel = {k: abs(float(m_g[k]) - float(m_c[k])) / abs(float(m_c[k]))
           for k in ("loss", "grad_norm")}
    if not max(rel.values()) <= 1e-5:
        raise AssertionError(f"mesh: fsdp train step differs: {rel}")
    if not torch.equal(m_g["local_frac"].cpu(), m_c["local_frac"]):
        raise AssertionError("mesh: fsdp train local_frac differs")
    if not worst <= 1e-4 < control:
        raise AssertionError(f"mesh: fsdp gradients differ by {worst:.3e} "
                             f"of a leaf's max (negated control "
                             f"{control:.3e})")
    print(f"mesh: fsdp train step {MESH_B}x{MESH_T}, card vs CPU: loss "
          f"{float(m_c['loss']):.6f} rel err {rel['loss']:.3e}, grad norm "
          f"rel err {rel['grad_norm']:.3e}, local_frac "
          f"{float(m_c['local_frac']):.6f} equal, worst gradient leaf "
          f"{worst:.3e} of its max (tol 1e-4; negated card gradients, the "
          f"control: {control:.3e})", flush=True)

    # greedy decode against a cache split over all 8 devices
    d_cpu, d_card = mesh_runtimes("decode_32k", "tp", 2.0,
                                  cache_seq_sharded=True)
    streams, worst = [], 0.0
    for rt, (_, p, pl) in zip((d_cpu, d_card), both):
        lg, cache, _ = tr.prefill(rt, p, tokens=tok[:1, :24], placement=pl,
                                  cache_len=32)
        toks, logits = [], []
        for pos in range(24, 28):
            nxt = lg.argmax(-1, keepdim=True)
            toks.append(int(nxt))
            lg, cache, _ = tr.decode_step(rt, p, cache, nxt, pos,
                                          placement=pl)
            logits.append(lg.cpu())
        streams.append((toks, logits))
    if streams[0][0] != streams[1][0]:
        raise AssertionError(f"mesh: cache_seq_sharded tokens differ: "
                             f"{streams}")
    for a, b in zip(streams[1][1], streams[0][1]):
        worst = max(worst, check_close("mesh: cache_seq_sharded decode",
                                       a, b, "float32")[0])
    counts, variants = read_counts()
    counts["flash_attention_bwd"] = fa.bwd_launches - bwd0[0]
    counts["moe_gmm_bwd"] = gmm.bwd_launches - bwd0[1]
    # the mesh steps are fp32 on dense caches: no paged read
    if min(v for k, v in counts.items()
           if k not in ("moe_gmm_rows", "paged_attention")) <= 0:
        raise AssertionError(f"mesh: a kernel never ran: {counts}")
    print(f"mesh: cache_seq_sharded decode (32 positions over 8 devices), "
          f"card vs CPU: tokens {streams[0][0]} equal, logits err "
          f"{worst:.3e}; card launches {counts} by variant={variants}; "
          f"phase took {time.perf_counter() - t_phase:.1f}s", flush=True)
    return counts


def ptxas_report(log: str) -> list:
    """One line per kernel from nvcc's ``-Xptxas=-v`` output: its name
    (demangled where ``c++filt`` exists), registers, shared memory and
    spills; and every warning line as it is (a ``wgmma`` serialization
    note, C7515, is one)."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "warning" in line.lower():
            out.append(line.strip())
            continue
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
    run_paged_checks(results)
    run_paged_mla_checks(results)
    mla_counts = run_mla_serve()
    run_ssm_checks(results)
    run_bwd_checks(results)

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=4)
    engine, prompts, greedy, serve_counts = run_serve(cfg)
    run_profile(engine, prompts, warmup=False)
    run_profile(engine, prompts, warmup=True)
    gen_counts = run_generate(engine)
    variant_counts = run_serve_variants(engine, prompts, greedy)
    del engine
    torch.cuda.empty_cache()
    cluster_counts = run_cluster(cfg)
    run_cluster_reference()
    free_device_memory()
    print(f"cluster: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
          "allocated after the cluster phases", flush=True)
    ssm_counts = run_ssm_serve()
    run_reference()
    run_reference_variants()
    train_counts, step_ms = run_train()
    mix_counts, mix_step_ms = run_train_mixtral()
    run_train_reference()
    run_train_reference_attn()
    free_device_memory()
    mesh_counts = run_mesh()
    free_device_memory()
    launch_counts = run_launch()

    main_case = {"moe_gmm": ("decode", "bfloat16"),
                 "moe_gmm_rows": ("prefill-32k", "bfloat16"),
                 "flash_attention": ("B=2 T=200", "bfloat16"),
                 "paged_attention": ("chat-decode", "bfloat16"),
                 "paged_mla": ("longdocs-decode", "bfloat16"),
                 "ssm_scan": ("train", "float32"),
                 "ssm_scan_bwd": ("train", "float32"),
                 "flash_attention_bwd": ("train", "bfloat16"),
                 "moe_gmm_bwd": ("ep-train", "bfloat16")}
    scan = "src/repro_torch/kernels/csrc/ssm_scan.cu"
    meta = {"moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                        "src/repro/kernels/moe_gmm.py:45"),
            "moe_gmm_rows": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                             "src/repro/kernels/moe_gmm.py:45"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:77"),
            "paged_attention": (
                "src/repro_torch/kernels/csrc/paged_attention.cu",
                "no TPU kernel (the JAX package leaves the paged read to "
                "XLA: src/repro/models/attention.py paged_gather)"),
            "paged_mla": (
                "src/repro_torch/kernels/csrc/paged_mla.cu",
                "no TPU kernel (the JAX package has no MLA)"),
            "ssm_scan": (scan, "src/repro/kernels/ssm_scan.py:53"),
            "ssm_scan_bwd": (scan, "no Pallas backward (the forward at "
                             "src/repro/kernels/ssm_scan.py:53 has none)"),
            "flash_attention_bwd": (
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "no Pallas backward (the forward at "
                "src/repro/kernels/flash_attention.py:77 has none)"),
            "moe_gmm_bwd": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                            "no Pallas backward (the forward at "
                            "src/repro/kernels/moe_gmm.py:45 has none)")}
    launches: dict = {}
    for phase in (serve_counts, gen_counts, cluster_counts, variant_counts,
                  ssm_counts, train_counts, mix_counts, launch_counts,
                  mesh_counts, mla_counts):
        add_counts(launches, phase)
    # the row-tile design is a row of moe_gmm's results (case prefill-32k)
    sel = {name: next(x for x in results
                      if x["kernel"] == name.removesuffix("_rows")
                      and x["case"] == case and x["dtype"] == dname)
           for name, (case, dname) in main_case.items()}
    if sel["moe_gmm_rows"]["design"] != "rows":
        raise AssertionError("kernels: the 32k fill did not select the row "
                             "tiles")
    scan_ms = (sel["ssm_scan"]["ms"] * train_counts["ssm_scan"]
               + sel["ssm_scan_bwd"]["ms"] * train_counts["ssm_scan_bwd"])
    print(f"train: the scan kernels' share of the steady step: "
          f"{scan_ms / len(step_ms):.2f} ms of {np.mean(step_ms[1:]):.1f} ms "
          f"({scan_ms / len(step_ms) / np.mean(step_ms[1:]):.2%}; kernel "
          "times from the kernels phase x launches per step)", flush=True)
    flash_ms = sel["flash_attention_bwd"]["ms"] * MIXTRAL_TRAIN_LAYERS
    mix_steady = float(np.mean(mix_step_ms[1:]))
    print(f"train-mixtral: the flash backward's share of the steady step: "
          f"{flash_ms:.2f} ms of {mix_steady:.1f} ms ({flash_ms / mix_steady:.2%}"
          "; kernel time from the kernels phase x launches per step)",
          flush=True)
    kernels = []
    for name, r in sel.items():
        kernels.append({
            "name": name, "route": "cuda", "variant": r["variant"],
            **({"design": r["design"]} if "design" in r else {}),
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
