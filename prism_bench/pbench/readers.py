"""Reductions that more than one metric reader uses."""

from __future__ import annotations

import bisect

from pbench import model
from pbench import trace as T
from pbench.record import traced_ticks


def gmm_roofline(run) -> float | None:
    """``moe_gmm``'s least time (the run's system module's
    ``gmm_least_seconds``) over its device time in the traced ticks, in
    percent. A tick's rows are drained by the next tick, so the rows of
    tick ``k`` are the next tick's counts."""
    tr = run.trace
    if tr is None:
        return None
    least = 0.0
    for t in traced_ticks(run):
        if t.k + 1 < len(run.ticks):
            least += run.system.gmm_least_seconds(run.sizes,
                                                  run.ticks[t.k + 1].delta)
    dev = T.gmm_us(tr["dev"], tr["t0"], tr["t1"]) / 1e6
    return 100.0 * least / dev if dev > 0 and least > 0 else None


def idle_in_ticks(run, keep) -> float | None:
    """Idle share of the traced ticks that ``keep`` selects, in percent,
    over each tick's step span on the trace's clock."""
    tr = run.trace
    if tr is None:
        return None
    total = busy = 0.0
    for t in traced_ticks(run):
        if keep(t):
            s, e = tr["steps"][t.k]
            total += e - s
            busy += T.busy_in(tr["busy"], s, e, tr["starts"])
    return 100.0 * (total - busy) / total if total > 0 else None


def tick_shares(run) -> tuple[list, list]:
    """(end of each tick, share of its wall time that lies in the window):
    a tick that the window's end cuts counts in part, so that what the
    window's ticks did is counted by the time, not in whole ticks."""
    lo, hi = run.window
    ends, shares = [], []
    for t in run.ticks:
        ends.append(t.t1)
        span = t.t1 - t.t0
        inside = min(t.t1, hi) - max(t.t0, lo)
        if span > 0:
            shares.append(min(max(inside / span, 0.0), 1.0))
        else:
            shares.append(float(run.in_window(t.t1)))
    return ends, shares


def seen_share(run, ends: list, shares: list, t: float) -> float:
    """Share in the window of what became visible at ``t``: that of the tick
    after which it was seen, or 1 or 0 for a time that ends no tick."""
    i = bisect.bisect_left(ends, t)
    if i < len(ends) and ends[i] == t:
        return shares[i]
    return float(run.in_window(t))


def prompt_in_window(run) -> list:
    """(request, share of its prompt served in the window) for every request
    that has a first token. A prompt is served over the ticks from the one
    after which its request was seen admitted to the one after which its
    first token was seen, in equal parts a tick (chunked prefill advances
    each slot by the same chunk a tick): the share is the sum of those
    ticks' shares in the window (``tick_shares``) over their number."""
    ends, shares = tick_shares(run)
    out = []
    for r in run.recs:
        if r.admit_t is None or not r.token_t:
            continue
        first = r.token_t[0]
        a = bisect.bisect_left(ends, r.admit_t)
        b = bisect.bisect_right(ends, first)
        if b > a:
            share = sum(shares[a:b]) / (b - a)
        else:  # seen admitted and answered outside any tick's end
            share = seen_share(run, ends, shares, first)
        if share:
            out.append((r, share))
    return out


def tokens_in_window(run) -> float:
    """Output tokens visible in the window, each weighted by the share of
    the tick after which it was seen (``seen_share``)."""
    ends, shares = tick_shares(run)
    return sum(seen_share(run, ends, shares, t)
               for r in run.recs for t in r.token_t)


def step_mfu(run) -> float | None:
    """Model FLOPs of every token the window processed over 989 TFLOP/s
    times the window, in percent: computed prompt tokens in the share of
    their prefill that lies in the window (``prompt_in_window``), decode
    tokens in the share of the tick after which they were seen. FLOPs: 2 x active parameters per token
    and layer, plus attention over the token's own context at the
    published head count, as the run's system module counts them
    (``pbench.model`` by default). None where the window processed
    nothing."""
    flops = 0.0
    for r, share in prompt_in_window(run):
        if not r.full_hit:
            flops += share * run.system.prompt_flops(
                run.sizes, len(r.req.prompt), r.skipped)
    ends, shares = tick_shares(run)
    for r in run.recs:
        n = len(r.req.prompt)
        for k, t in enumerate(r.token_t[1:], 1):
            share = seen_share(run, ends, shares, t)
            if share:
                flops += share * run.system.decode_flops(run.sizes, n, k)
    if flops <= 0:
        return None
    return 100.0 * flops / (model.PEAK_BF16_FLOPS * run.seconds)


def local_ratio(run) -> float | None:
    """Share of the window's routed (token, expert) rows whose expert has a
    slot on the token's origin server, under the placement in force when
    they were launched, in percent."""
    rows, local = run.lagged(run.window_ticks())
    total = rows.sum()
    return 100.0 * local.sum() / total if total > 0 else None


def remote_kb_per_tok(run) -> float | None:
    """Expert dispatch and combine bytes that would cross between edge
    servers per token through the model: 2 x d_model x 2 bytes for each
    routed row whose expert has no slot on the token's origin server, over
    the tokens through the model (routed rows of one layer over top_k), in
    the window; KB = 1000 bytes."""
    rows, local = run.lagged(run.window_ticks())
    tokens = rows[0].sum() / run.sizes["top_k"]
    if tokens <= 0:
        return None
    return (rows - local).sum() * 2 * run.sizes["d"] * 2 / tokens / 1e3
