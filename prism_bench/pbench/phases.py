"""Reductions of what the program records about itself when its tracer is
on (``EdgeCluster(trace=True)``): the phase marks in the device trace and
the wall-clock spans of its runtime.

Phase marks are kernels that do nothing, named ``phase_mark_<phase>``,
which a traced program captures into its step graphs and launches around
a migration's re-gather. A call runs from its first mark (``chunk``,
``decode`` or ``regather``) to its ``end`` mark; a kernel's phase is the
last mark before it on the stream, so a phase runs from its mark's start
to the next mark's. Marks before the trace's first call mark belong to a
call that started before the trace and are dropped; a call whose ``end``
mark the trace does not hold runs to the next call's first mark or to the
trace's end, and is not whole.

Program spans are dicts (``program_spans``): ``kind``, ``start`` and
``end`` in microseconds on the trace's clock (the program stamps them
with ``time.time_ns()``, the clock ``torch.profiler`` stamps its events
with), ``seq``, ``parent`` (the enclosing span's ``seq``), ``tick`` (the
cluster tick: the harness's tick ``k`` is the ``STEP`` of tick ``k + 1``)
and ``args``. A run carries them as ``run.program`` (None where the
program's tracer was off). Every reader returns None where it finds
nothing to read.
"""

from __future__ import annotations

import dataclasses

from pbench import trace as T
from pbench.record import traced_ticks
from pbench.stats import median

MARK = "phase_mark_"
STARTS = ("chunk", "decode", "regather")


@dataclasses.dataclass
class Call:
    kind: str  # chunk, decode or regather
    start: float  # its first mark's start (us)
    end: float | None = None  # its end mark's end; None: past the trace
    whole: bool = False  # its end mark is in the trace
    phases: list = dataclasses.field(default_factory=list)  # (phase, from)


def calls(dev: list) -> list[Call]:
    """The marked calls of a trace's device intervals, in order."""
    marks = sorted((s, e, name[len(MARK):]) for name, s, e in dev
                   if name.startswith(MARK))
    out: list[Call] = []
    cur = None
    for s, e, phase in marks:
        if phase in STARTS:
            if cur is not None and cur.end is None:
                cur.end = s  # no end mark: cut at the next call
            cur = Call(phase, s)
            out.append(cur)
            cur.phases.append((phase, s))
        elif cur is None or cur.end is not None:
            continue  # a call that began before the trace, or after an end
        elif phase == "end":
            cur.end, cur.whole = e, True
        else:
            cur.phases.append((phase, s))
    return out


def phase_spans(call: Call, t1: float) -> list[tuple[str, float, float]]:
    """``(phase, from, to)`` of one call; a call the trace cuts runs to
    ``t1``."""
    end = call.end if call.end is not None else t1
    bounds = [p[1] for p in call.phases[1:]] + [end]
    return [(p, a, b) for (p, a), b in zip(call.phases, bounds)]


def call_device_ms(run, kind: str) -> float | None:
    """Median busy device time of the ``kind`` calls that lie whole inside
    the traced window, from the first mark to the end mark, in ms."""
    tr = run.trace
    if tr is None:
        return None
    xs = [T.busy_in(tr["busy"], c.start, c.end, tr["starts"]) / 1e3
          for c in calls(tr["dev"]) if c.kind == kind and c.whole
          and c.start >= tr["t0"] and c.end <= tr["t1"]]
    return median(xs) if xs else None


def phase_share(run, phase: str) -> float | None:
    """Share of the busy device time of the traced window's marked chunk
    calls and decode rounds that lies in ``phase``, in percent (calls the
    window's edges cut count by their part inside)."""
    tr = run.trace
    if tr is None:
        return None
    t0, t1 = tr["t0"], tr["t1"]
    total = part = 0.0
    for c in calls(tr["dev"]):
        if c.kind == "regather":
            continue
        for p, a, b in phase_spans(c, t1):
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            busy = T.busy_in(tr["busy"], a, b, tr["starts"])
            total += busy
            if p == phase:
                part += busy
    return 100.0 * part / total if total > 0 else None


def program_spans(tracer) -> list[dict]:
    """The program tracer's wall-clock spans in the form the readers take
    (see the module)."""
    return [dict(kind=s.kind, start=s.start / 1e3, end=s.end / 1e3,
                 seq=s.seq, parent=s.parent, tick=s.tick, rid=s.rid,
                 args=s.args or {}) for s in tracer.spans]


def _program(run) -> list | None:
    return getattr(run, "program", None) or None


def steps_by_tick(spans: list) -> dict:
    """``{tick: STEP span}``."""
    return {s["tick"]: s for s in spans if s["kind"] == "STEP"}


def _children(spans: list) -> dict:
    """``{seq: the spans whose parent it is}``."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    return kids


def _inside(kids: dict, root: dict) -> list:
    """The spans nested, at any depth, inside ``root``."""
    out, todo = [], [root["seq"]]
    while todo:
        for s in kids.get(todo.pop(), []):
            out.append(s)
            todo.append(s["seq"])
    return out


def host_tick_ms(run) -> float | None:
    """Median, over the traced ticks, of the program's ``STEP`` less the
    ``DEVICE_WAIT`` spans inside it: host time per tick not spent waiting
    for the device, in ms."""
    spans = _program(run)
    if spans is None or run.trace is None:
        return None
    steps, kids = steps_by_tick(spans), _children(spans)
    xs = []
    for t in traced_ticks(run):
        st = steps.get(t.k + 1)
        if st is None:
            continue
        wait = sum(s["end"] - s["start"] for s in _inside(kids, st)
                   if s["kind"] == "DEVICE_WAIT")
        xs.append((st["end"] - st["start"] - wait) / 1e3)
    return median(xs) if xs else None


def regather_ms(run) -> float | None:
    """Summed duration of the program's ``MIGRATE`` spans (the placement
    tables' copy and the re-gather of the expert slots) in the window's
    ticks, in ms."""
    spans = _program(run)
    if spans is None:
        return None
    ticks = {t.k + 1 for t in run.window_ticks()}
    xs = [s["end"] - s["start"] for s in spans
          if s["kind"] == "MIGRATE" and s["tick"] in ticks]
    return sum(xs) / 1e3 if xs else None
