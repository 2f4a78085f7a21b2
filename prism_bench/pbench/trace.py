"""Reduction of a ``torch.profiler`` trace of the measured window.

The device is busy where any kernel, memcpy or memset runs: the union of
those intervals (the arithmetic of ``chip_smoke.device_busy``). Idle gaps
are labelled by the harness's own span that the host was in at the gap's
middle (``pbench.<name>`` user annotations, recorded in the same trace).
Times are microseconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import re

SPAN_PREFIX = "pbench."
GMM_KERNELS = re.compile(r"gmm_|gate_reduce|down_reduce")


def collect(prof) -> tuple[list, list]:
    """(device intervals, harness spans) as ``(name, start_us, end_us)``
    from a stopped profiler."""
    from torch.autograd import DeviceType

    dev, host = [], []
    try:
        events = prof.profiler.kineto_results.events()
        rows = []
        for e in events:
            if hasattr(e, "start_ns"):
                s0 = e.start_ns() / 1e3
                s1 = s0 + e.duration_ns() / 1e3
            else:
                s0 = float(e.start_us())
                s1 = s0 + float(e.duration_us())
            rows.append((e.name(), e.device_type(), s0, s1))
    except AttributeError:
        rows = [(e.name, e.device_type, float(e.time_range.start),
                 float(e.time_range.end)) for e in prof.events()]
    for name, kind, s0, s1 in rows:
        if name.startswith(SPAN_PREFIX):
            if kind != DeviceType.CUDA:
                host.append((name[len(SPAN_PREFIX):], s0, s1))
        elif kind == DeviceType.CUDA:
            dev.append((name, s0, s1))
    return dev, host


def merged(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The union of ``(name, start, end)`` intervals, clipped to [t0, t1]."""
    out: list[list[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_in(busy: list, a: float, b: float, starts=None) -> float:
    """Busy microseconds of the merged ``busy`` intervals inside [a, b]
    (``starts``: their start times, to spare rebuilding them per call)."""
    if starts is None:
        starts = [s for s, _ in busy]
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    for s, e in busy[i:]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def gaps(busy: list, t0: float, t1: float) -> list[tuple[float, float]]:
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def label_gaps(gap_list, spans, kind_of) -> dict[str, float]:
    """Idle microseconds by what the host was doing at each gap's middle:
    the name of the innermost harness span there (``step#k`` becomes
    ``step.<kind_of(k)>``), or ``harness`` between spans."""
    spans = sorted(spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    out: dict[str, float] = {}
    for a, b in gap_list:
        mid = 0.5 * (a + b)
        label = "harness"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            name, s, e = spans[i]
            if s <= mid < e:
                label = name
                break
            if mid - s > 600e6:
                break
            i -= 1
        if label.startswith("step#"):
            label = "step." + kind_of(int(label[5:]))
        elif label == "traced":
            label = "harness"
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def top_ops(intervals, t0: float, t1: float, n: int = 10) -> list:
    """Device seconds by operation name inside [t0, t1], the largest ``n``."""
    by: dict[str, float] = {}
    for name, s, e in intervals:
        d = min(e, t1) - max(s, t0)
        if d > 0:
            by[name] = by.get(name, 0.0) + d
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]


def gmm_us(intervals, t0: float, t1: float) -> float:
    """Device microseconds of ``moe_gmm``'s kernels inside [t0, t1]."""
    return sum(max(0.0, min(e, t1) - max(s, t0))
               for name, s, e in intervals if GMM_KERNELS.search(name))
