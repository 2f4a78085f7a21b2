"""The paged MLA read's work in the traced window, counted from the
harness's own records (as ``step_mfu`` counts FLOPs), and the readers'
reductions over the device trace.

A call is one launch of the paged MLA kernel in one layer: a tick's chunk
call (every prefilling request's next ``BLOCK``-token chunk) or its decode
round (one query for every decoding request). Per request:

* its prompt's computed positions, from ``skipped`` on, in the runtime's
  chunks (``BLOCK`` positions, the last one short), spread in order over
  the ticks from the one after which the request was seen admitted (its
  first chunk's) to the one before its first token was seen (the last
  chunk's token is drained a tick later): a chunk of ``q`` queries from
  offset ``c0`` reads ``c0 + q`` latent rows and scores ``q c0 + q (q +
  1) / 2`` (query, key) pairs;
* each later output token, launched the tick before the one after which
  it was seen: one query at position ``prompt + k - 1`` reading ``prompt
  + k`` rows.

A call's FLOPs are ``2 x heads x (latent + kv_lora)`` a pair (QK^T over
the 576-value row, PV over its 512 values); its bytes each row it reads
once (1,152 bytes in bf16), plus q (576 values a head) and the output
(512 a head) of each query. Its least time is the larger of FLOPs over
989 TFLOP/s and bytes over 3.35 TB/s, in every layer that has the read.
"""

from __future__ import annotations

import bisect
import re

from pbench import model
from pbench.record import traced_ticks

BLOCK = 16  # the runtime's block size: a chunk call's queries a request
MLA_KERNELS = re.compile(r"paged_mla")  # the kernel and its combine


def call_work(run) -> dict:
    """``{(tick, "chunk" | "decode"): [flops, bytes]}`` of one layer's
    calls, by the tick that launched them."""
    s = run.sizes
    latent = s["kv_lora"] + s["rope"]
    pair = 2.0 * s["heads"] * (latent + s["kv_lora"])
    row_bytes = latent * model.BF16
    io = s["heads"] * (latent + s["kv_lora"]) * model.BF16  # q in, out
    ends = [t.t1 for t in run.ticks]
    out: dict = {}

    def add(k, kind, queries, keys, pairs):
        w = out.setdefault((k, kind), [0.0, 0.0])
        w[0] += pair * pairs
        w[1] += row_bytes * keys + io * queries

    for r in run.recs:
        n = len(r.req.prompt)
        if r.admit_t is not None and r.token_t and not r.full_hit:
            chunks, c0 = [], r.skipped
            while c0 < n:
                q = min(BLOCK, n - c0)
                chunks.append((c0, q))
                c0 += q
            a = bisect.bisect_left(ends, r.admit_t)
            span = max(bisect.bisect_left(ends, r.token_t[0]) - a, 1)
            for i, (c0, q) in enumerate(chunks):
                add(a + i * span // len(chunks), "chunk", q, c0 + q,
                    q * c0 + q * (q + 1) // 2)
        for k, t in enumerate(r.token_t[1:], 1):
            add(bisect.bisect_left(ends, t) - 1, "decode", 1, n + k, n + k)
    return out


def least_seconds(run, ticks) -> float:
    """The least time of the calls launched in ``ticks``, every layer."""
    keep = {t.k for t in ticks}
    total = 0.0
    for (k, _), (flops, nbytes) in call_work(run).items():
        if k in keep:
            total += max(flops / model.PEAK_BF16_FLOPS,
                         nbytes / model.PEAK_HBM_BYTES)
    return run.sizes["layers"] * total


def device_us(run) -> float | None:
    """Device microseconds of the paged MLA kernels (and their combine) in
    the traced window; None without a trace."""
    tr = run.trace
    if tr is None:
        return None
    return sum(max(0.0, min(e, tr["t1"]) - max(s, tr["t0"]))
               for name, s, e in tr["dev"] if MLA_KERNELS.search(name))


def roofline(run) -> float | None:
    """The traced ticks' least MLA time over the kernels' device time in the
    traced window, in percent; None where the trace holds no such kernel."""
    dev = device_us(run)
    if not dev:
        return None
    least = least_seconds(run, traced_ticks(run))
    return 100.0 * least / (dev / 1e6) if least > 0 else None


def share(run) -> float | None:
    """The kernels' device time over the traced window's busy time, in
    percent; None where the trace holds no such kernel."""
    dev = device_us(run)
    if not dev or run.trace["busy_us"] <= 0:
        return None
    return 100.0 * dev / run.trace["busy_us"]
