"""One run of one cell: set-up, the measured window, the metrics, the check
of what the timed path produced, and the result line."""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pbench import check, loop, record, refs, system, traffic
from pbench import trace as T
from pbench.stats import median, percentile

BANNED = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 20.0  # the traced part: the window's last seconds


def load_cell(root: Path, name: str) -> dict:
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
    conf = json.loads((root.parent / conf_entry["file"]).read_text())
    mix = traffic.load_mix(root, cell["traffic"])

    def listed(m):
        return name in m.get("workloads", [name])

    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return dict(cell=cell, conf=conf, mix=mix, units=units,
                system=refs.system_for(root, conf),
                end_to_end=[m["name"] for m in bench["end_to_end"]
                            if listed(m)],
                per_layer=[m["name"] for m in bench["per_layer"] if listed(m)])


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(root: Path, spec: dict, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda", dump: Path | None = None,
             log=print) -> dict:
    """Serve the cell and return its result object (the last line)."""
    conf, mix, sysmod = spec["conf"], spec["mix"], spec["system"]
    s = sysmod.sizes(conf)
    clock = time.perf_counter
    if device == "cuda":
        log(f"card: {card_line()}")
    log(f"system: systems/{Path(sysmod.__file__).name}")
    t = clock()
    engine = sysmod.build_engine(conf, seed, mix["max_len"], device)
    _sync(device)
    t_weights = clock() - t
    t = clock()
    cluster, ctrl = system.build_cluster(engine, conf, mix, s)
    rt = system.runtime(cluster)
    _sync(device)
    t_ladder = clock() - t
    t = clock()
    poisson = mix["arrivals"] == "poisson"
    tail_s = mix.get("tail_s", 0.0)
    reqs = traffic.build(mix, seed, s["vocab"],
                         mix["warmup_s"] + seconds + tail_s)
    t_prompts = clock() - t
    counts0 = engine.stats.counts.copy()
    if trace:
        # the profiler's first start loads and sets up CUPTI, which takes
        # seconds: pay it in set-up, not inside the window
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.zeros(1, device=device).add_(1)
            _sync(device)

    from repro_torch.serving.api import Request

    def make_request(q):
        return Request(prompt=q.prompt, max_new_tokens=q.max_new,
                       origin=q.origin, task=f"task{q.task}")

    t_traffic = clock()
    recs = [loop.ReqRec(q, t_traffic + q.due) for q in reqs]
    drv = loop.Driver(cluster, recs, make_request, clock)
    drv.run(t_traffic + mix["warmup_s"])
    ws = clock()
    we = ws + seconds
    setup_s = ws - t_process
    system.open_reviews(cluster, ctrl)
    prof = None
    if trace:
        drv.run(we - min(TRACE_SECONDS, seconds))
        t = clock()
        prof = profile(activities=acts)
        prof.start()
        log(f"profiler started in {clock() - t:.3f}s")
        drv.tracing = True
        with torch.profiler.record_function("pbench.traced"):
            drv.run(we)
    else:
        drv.run(we)
    due = [r for r in recs if ws <= r.due_abs < we]
    if prof is not None:
        _sync(device)
        prof.stop()
        drv.tracing = False
    # serve on past the window (arrivals continuing) until what the
    # window's metrics time has come: the first token of every request due
    # in the window (open loop), or of every request admitted before its
    # end, whose prompt the window served in part (backlog)
    if poisson:
        waited = due
    else:
        waited = [r for r in recs if r.admit_t is not None and r.admit_t < we]
    drv.run(we + tail_s, stop=lambda: all(
        r.token_t and r.admit_t is not None for r in waited))
    drv.finish()
    counts1 = engine.stats.counts.copy()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    ladder = (rt.executables_compiled, rt.warmup_seconds,
              rt.traces_after_warmup)
    migrations = [(m.get("time"), m.get("reason"), m.get("transfers"))
                  for m in ctrl.events if m.get("adopted")
                  or m.get("reason") == "migration-complete"]

    run = record.Run(sizes=s, mix=mix, recs=recs, ticks=drv.ticks,
                     window=(ws, we), seconds=seconds, setup_s=setup_s,
                     system=sysmod)
    if prof is not None:
        dev, host = T.collect(prof)
        del prof
        run.trace = record.traced(dev, host)

    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    units = spec.get("units", {})
    for name in names:
        value = record.load_reader(root, name)(run)
        if value is not None and not (isinstance(value, float)
                                      and math.isnan(value)):
            metrics[name] = {"value": float(value),
                             "unit": units.get(name, "")}

    # -- what the timed path produced: gather, then free the program ------
    bad_len = check.wrong_lengths(recs)
    count_bad, per_origin = check.count_faults(
        drv.ticks, counts1 - counts0, recs, s["top_k"])
    res_bad = check.residency_mismatch(ctrl.plan.residency(),
                                       system.engine_residency(engine))
    chosen = check.sample(recs, seed, mix.get("check_tokens", 400))
    seqs = [np.concatenate([r.req.prompt, r.handle.tokens]) for r in chosen]
    wanted = [range(len(r.req.prompt) - 1,
                    len(r.req.prompt) + len(r.token_t) - 1) for r in chosen]
    served = [np.asarray(r.handle.tokens) for r in chosen]
    del drv, cluster, ctrl, engine, rt
    for r in recs:
        r.handle = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t = clock()
    from pbench.refs import reference_for

    ref = reference_for(root, conf)
    per_req, all_gaps = [], []
    if seqs:
        logits = ref.logits_at(conf, seed, seqs, wanted, device)
        for r, lg, tok in zip(chosen, logits, served):
            g = ref.gaps(lg, tok).cpu()
            all_gaps.append(g)
            per_req.append((len(r.req.prompt), len(tok), float(g.max()),
                            int(g.argmax()), float((g == 0).float().mean())))
        del logits
    gap, limit, gap_ok = gap_check(conf, all_gaps)
    t_ref = clock() - t
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        np.savez(dump / f"{spec['cell']['name']}-{seed}.npz",
                 seed=seed, cell=spec["cell"]["name"],
                 lens=np.array([len(x) for x in seqs]),
                 tokens=np.concatenate(seqs) if seqs else np.zeros(0),
                 prompt=np.array([len(r.req.prompt) for r in chosen]))

    checks = {
        "mean_gap": [gap["mean"], limit],
        "wrong_lengths": [bad_len, 0],
        "count_faults": [count_bad, 0],
        "residency_mismatch": [res_bad, 0],
    }
    correct = (bool(seqs) and gap_ok and bad_len == 0
               and count_bad == 0 and res_bad == 0)

    # -- earlier lines: what the numbers rest on ---------------------------
    win = run.window_ticks()
    late = [r.submit_t - r.due_abs for r in due if r.submit_t is not None]
    served_in = sum(1 for r in due if r.token_t)
    unserved = sum(1 for r in waited if not r.token_t)
    log(f"set-up: {setup_s:.3f}s (weights {t_weights:.3f}s, cluster and "
        f"graph ladder {t_ladder:.3f}s: {ladder[0]} graphs captured in "
        f"{ladder[1]:.3f}s, prompts {t_prompts:.3f}s, traffic warm-up "
        f"{mix['warmup_s']}s); eager steps after warm-up {ladder[2]}")
    log(f"window: {seconds}s, {len(win)} ticks (median "
        f"{median([k.t1 - k.t0 for k in win]) * 1e3 if win else 0:.3f} ms), "
        f"{len(due)} requests due, {served_in} with a first token by the "
        f"end; {unserved} of the {len(waited)} requests waited for past "
        f"the window without a first token; generator lateness p50 "
        f"{percentile(late, 50) * 1e3 if late else 0:.3f} ms max "
        f"{max(late) * 1e3 if late else 0:.3f} ms; placement decisions "
        f"(tick, reason, transfers) {migrations}")
    submitted = sum(1 for r in recs if r.submit_t is not None)
    log(f"requests: {len(recs)} scheduled, {submitted} submitted, "
        f"{sum(1 for r in recs if r.done_t is not None)} finished; routed "
        f"tokens per origin (counted low, engine, high) {per_origin}")
    log(f"gaps: widest {gap['widest']:.4f}, mean {gap['mean']:.5f}, share "
        f"of served tokens not the reference's best {gap['mismatch']:.4f}")
    log(f"reference: {len(seqs)} requests, {sum(len(x) for x in served)} "
        f"served tokens over {sum(len(x) for x in seqs)} positions in "
        f"{t_ref:.3f}s; per request (prompt, served, widest gap, at "
        f"token, share where the served token is the reference's best) "
        f"{[(p, n, round(g, 4), at, round(a, 3)) for p, n, g, at, a in per_req]}")
    for name, (value, lim) in checks.items():
        log(f"check {name}: {value} (limit {lim})")

    result = {"correct": correct,
              "attempted": len(due) if poisson else sum(
                  1 for r in recs if run.in_window(r.admit_t)),
              "failed": unserved + bad_len,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": (torch.cuda.get_device_name()
                                  if device == "cuda" else device),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        tr = run.trace
        result["device"]["busy_s"] = tr["busy_us"] / 1e6
        result["device"]["window_s"] = (tr["t1"] - tr["t0"]) / 1e6
        labels = T.label_gaps(T.gaps(tr["busy"], tr["t0"], tr["t1"]),
                              tr["host"], run.tick_kind)
        result["breakdown"] = {
            "device_ops": T.top_ops(tr["dev"], tr["t0"], tr["t1"]),
            "idle_gaps": [[k, v / 1e6] for k, v in sorted(
                labels.items(), key=lambda kv: -kv[1])[:10]]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def gap_check(conf: dict, gaps: list) -> tuple[dict, float, bool]:
    """The logit comparison that ``correct`` rests on, for the program and
    for its control alike: the summary of ``gaps`` (one tensor of gaps per
    compared request), the configuration's limit on the mean gap, and
    whether the mean lies within it."""
    gap = gap_summary(gaps)
    limit = float(conf["check"]["mean_gap"])
    return gap, limit, gap["mean"] <= limit


def gap_summary(gaps: list) -> dict:
    """Widest and mean gap over every compared position, and the share of
    positions where the served token is not the reference's best."""
    if not gaps:
        return {"widest": math.inf, "mean": math.inf, "mismatch": 1.0}
    g = torch.cat(gaps)
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "mismatch": float((g > 0).float().mean())}

