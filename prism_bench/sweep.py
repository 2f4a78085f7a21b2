"""Find the knee of an open-loop cell: serve its traffic at several rates on
one engine and print, per rate, whether the backlog grows.

    python3 prism_bench/sweep.py --workload mixtral-edge3-chat \\
        --rates 0.6,0.8,1.0,1.2,1.5 --seconds 40 --seed 11

Each rate gets a fresh cluster (the engine, its weights and its captured
graph ladder are kept; the placement is reset to the uniform layout), the
mix's warm-up, then ``--seconds`` of measurement. A rate is sustained when
the queue of requests waiting for admission does not grow over the
measurement and every request due in its first half got its first token.
The knee is written into the mix file by hand, with the cell's rate at
about four fifths of it.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(CHECKOUT / "src")]

    import torch

    from pbench import bench, loop, system, traffic
    from pbench.stats import median, percentile
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as tr
    from repro_torch.serving.api import Request

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    spec = bench.load_cell(ROOT, args.workload)
    conf, mix0, sysmod = spec["conf"], spec["mix"], spec["system"]
    s = sysmod.sizes(conf)
    log(f"card: {bench.card_line()}")
    log(f"system: systems/{Path(sysmod.__file__).name}")
    engine = sysmod.build_engine(conf, args.seed, mix0["max_len"], "cuda")
    spec_ep = engine.rt.ep_spec
    uniform = tr.stack_placement(M.uniform_placement(
        spec_ep.n_ep, spec_ep.slots, s["experts"]), engine.n_groups)

    def make_request(q):
        return Request(prompt=q.prompt, max_new_tokens=q.max_new,
                       origin=q.origin, task=f"task{q.task}")

    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(mix0, rate_per_s=rate)
        engine.migrate(uniform)
        cluster, ctrl = system.build_cluster(engine, conf, mix, s)
        rt = system.runtime(cluster)
        reqs = traffic.build(mix, args.seed, s["vocab"],
                             mix["warmup_s"] + args.seconds)
        t0 = time.perf_counter()
        recs = [loop.ReqRec(q, t0 + q.due) for q in reqs]
        drv = loop.Driver(cluster, recs, make_request)
        drv.run(t0 + mix["warmup_s"])
        system.open_reviews(cluster, ctrl)
        ws = time.perf_counter()
        we = ws + args.seconds
        queue = []
        for k in range(1, 5):
            drv.run(ws + k * args.seconds / 4)
            queue.append(len(rt.queue))
        due = [r for r in recs if ws <= r.due_abs < we]
        first_half = [r for r in due if r.due_abs < ws + args.seconds / 2]
        ttft = [r.token_t[0] - r.due_abs for r in due if r.token_t]
        gaps = [b - a for r in recs for a, b in zip(r.token_t, r.token_t[1:])
                if ws <= b < we]
        ticks = [t.t1 - t.t0 for t in drv.ticks if ws <= t.t1 < we]
        done = sum(1 for r in recs if r.done_t is not None
                   and ws <= r.done_t < we)
        log(f"rate {rate}/s: {len(due)} due, {done} finished in the window; "
            f"queue at each quarter {queue}; first half served "
            f"{sum(1 for r in first_half if r.token_t)}/{len(first_half)}; "
            f"ttft p50 {percentile(ttft, 50) * 1e3:.0f} p75 "
            f"{percentile(ttft, 75) * 1e3:.0f} ms (of {len(ttft)}); itl p50 "
            f"{percentile(gaps, 50) * 1e3:.1f} p95 "
            f"{percentile(gaps, 95) * 1e3:.1f} ms; tick median "
            f"{median(ticks) * 1e3:.1f} ms over {len(ticks)}; active "
            f"{rt.active}; placements applied {len(cluster.migrations)}")
        del drv, cluster, ctrl, rt, recs
        gc.collect()
    log(f"sweep took {time.perf_counter() - T_PROCESS:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
