"""Run one cell's traced run with the program's own tracer on, and read the
per-layer metrics that need it (``pbench/phases.py``):

    python3 prism_bench/program_trace.py --workload mixtral-edge3-chat \\
        --seed 7 --seconds 51 [--program 0]

The cell runs as ``run.py --trace 1`` runs it, except that the port's
``EdgeCluster`` is built with ``trace=True`` (its captured step graphs then
hold the phase marks, and its runtime records wall-clock spans) and the run
carries the program's spans (``run.program``); ``--program 0`` builds it as
the benchmark does, for the tracer's cost. Progress goes to standard error;
standard output gets a line of checks, then the result line with the
readers of ``program_metrics`` added to its metrics. The checks: the share
of the traced window's busy device time inside marked calls, the largest
distance by which a program ``STEP`` leaves the harness's ``step#k`` span,
the marks and calls in the trace, and the re-gather's device time.

The benchmark's own traced run reads these metrics once
``pbench/system.build_cluster`` passes ``trace`` on to ``EdgeCluster`` and
``pbench/bench.run_cell`` leaves the program's spans on the run.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
CHAT = ["chunk_device_ms.chat", "decode_device_ms.chat",
        "attention_share.chat", "moe_share.chat", "host_tick_ms.chat",
        "regather_ms.chat"]
DOCS = ["chunk_device_ms.docs", "attention_share.docs", "moe_share.docs",
        "host_tick_ms.docs"]


def program_metrics(spec: dict) -> list[str]:
    """The metrics of the program's tracer that the cell would report."""
    return DOCS if "tokens_s" in spec["end_to_end"] else CHAT


def run_traced(spec: dict, seed: int, seconds: float, t_process: float,
               program: bool = True, device: str = "cuda", log=print):
    """``bench.run_cell`` with ``trace`` on, the program's tracer on (or,
    with ``program`` False, off) and ``program_metrics`` read. Returns
    (result, the run the readers read)."""
    import repro_torch.serving.cluster as C
    from pbench import bench, phases, record

    held = {}
    base_cluster, base_run, base_load = (C.EdgeCluster, record.Run,
                                         record.load_reader)

    class Cluster(base_cluster):
        def __init__(self, *args, trace=False, **kwargs):
            super().__init__(*args, trace=program, **kwargs)
            held["tracer"] = self.tracer   # not the cluster: the run frees
            #   its engine before the reference runs

    class Run(base_run):
        program = None

    def load_reader(root, name):
        read = base_load(root, name)

        def with_spans(run):
            tracer = held["tracer"]
            if tracer.enabled and run.program is None:
                run.program = phases.program_spans(tracer)
            held["run"] = run
            return read(run)

        return with_spans

    C.EdgeCluster, record.Run, record.load_reader = (Cluster, Run,
                                                     load_reader)
    try:
        spec = dict(spec, per_layer=spec["per_layer"] + program_metrics(spec))
        result = bench.run_cell(ROOT, spec, seed, seconds, True, t_process,
                                device=device, log=log)
    finally:
        C.EdgeCluster, record.Run, record.load_reader = (base_cluster,
                                                         base_run, base_load)
    return result, held.get("run")


def checks(run) -> dict:
    """What the new metrics rest on, from one traced run (see the module)."""
    from pbench import phases
    from pbench import trace as T
    from pbench.stats import median

    tr = run.trace
    t0, t1 = tr["t0"], tr["t1"]
    calls = phases.calls(tr["dev"])
    covered = regather = 0.0
    for c in calls:
        a, b = max(c.start, t0), min(c.end if c.end is not None else t1, t1)
        if b > a:
            busy = T.busy_in(tr["busy"], a, b, tr["starts"])
            covered += busy
            if c.kind == "regather":
                regather += busy
    # a tick launches its chunk calls, then its decode round: the device
    # time of each whole round with the calls launched since the last one
    ticks, since = [], 0.0
    for c in calls:
        if c.whole and t0 <= c.start and c.end <= t1 and c.kind != "regather":
            since += T.busy_in(tr["busy"], c.start, c.end, tr["starts"])
            if c.kind == "decode":
                ticks.append(since / 1e3)
        if c.kind == "decode":
            since = 0.0
    walls = [(e - s) / 1e3 for k, (s, e) in tr["steps"].items()
             if t0 <= s and e <= t1 and k < len(run.ticks)
             and run.ticks[k].decode]
    out = {"tick_device_ms_median": median(ticks) if ticks else None,
           "tick_device_ms_mean": sum(ticks) / len(ticks) if ticks else None,
           "traced_decode_tick_ms_median": median(walls) if walls else None,
           "traced_decode_tick_ms_mean": (sum(walls) / len(walls) if walls
                                          else None),
           "marks": sum(1 for name, _, _ in tr["dev"]
                        if name.startswith(phases.MARK)),
           "calls": {k: sum(1 for c in calls if c.kind == k)
                     for k in phases.STARTS},
           "marked_busy_share": (100.0 * covered / tr["busy_us"]
                                 if tr["busy_us"] else None),
           "regather_device_ms": regather / 1e3,
           "busy_s": tr["busy_us"] / 1e6, "window_s": (t1 - t0) / 1e6}
    # device seconds by phase and kernel name (a kernel's phase: the last
    # mark before its start), the largest five of each phase
    dev = sorted((s, e, n) for n, s, e in tr["dev"]
                 if not n.startswith(phases.MARK))
    starts = [d[0] for d in dev]
    by_phase: dict = {}
    for c in calls:
        for p, a, b in phases.phase_spans(c, t1):
            i = bisect.bisect_left(starts, max(a, t0))
            while i < len(dev) and dev[i][0] < min(b, t1):
                s, e, name = dev[i]
                ops = by_phase.setdefault(p, {})
                ops[name[:120]] = ops.get(name[:120], 0.0) + min(e, t1) - s
                i += 1
    out["phase_ops_s"] = {
        p: [[n, us / 1e6] for n, us in sorted(ops.items(),
                                              key=lambda kv: -kv[1])[:5]]
        for p, ops in by_phase.items()}
    if run.program:
        steps = phases.steps_by_tick(run.program)
        out_us = [max(s - st["start"], st["end"] - e)
                  for k, (s, e) in tr["steps"].items()
                  if (st := steps.get(k + 1)) is not None]
        out["steps_compared"] = len(out_us)
        out["step_excursion_max_us"] = max(out_us) if out_us else None
        out["program_spans"] = len(run.program)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(CHECKOUT / "src")]

    import torch

    from pbench import bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    spec = bench.load_cell(ROOT, args.workload)
    result, run = run_traced(
        spec, args.seed, args.seconds, T_PROCESS, program=bool(args.program),
        log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps({"checks": checks(run)}), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
