"""Unified observability: span tracer, metrics registry, Chrome-trace
export (``repro_torch.serving.obs``).

Every subsystem — runtime, cluster, net, tiers, faults, workload —
exposes its own ``metrics()`` dict; this module adds the layer that says
*where one request's or one tick's time went* and *why the controller
adopted a plan* (the Eq.-4 trade of ``C(P') + T_mig`` against
``C(P)``), in three parts:

* :class:`Tracer` — a span recorder on the owning backend's clock:
  modeled seconds for the simulator (``clock="seconds"``), the wall
  clock for the runtime backend (``clock="wall"``: integer nanoseconds
  of ``time.time_ns()``, the clock ``torch.profiler`` stamps its own
  events with, so a runtime span and the kernels it launched lie on one
  timeline). Emission sites guard on ``tracer.enabled``, so a disabled
  tracer costs one attribute check and allocates nothing;
  :data:`NULL_TRACER` is the shared always-off instance every subsystem
  defaults to. The span vocabulary is :class:`SpanKind`.

  **Determinism contract (sim backend).** Sim spans carry model-clock
  times and a monotonic sequence number only, so a traced rerun of a
  ``FaultSchedule`` scenario exports byte-identical JSON; wall time
  appears only as the aggregate ``overhead_ms`` of ``summary()``.
  **Runtime backend.** Spans are wall-clock intervals, so no two runs
  export the same bytes; each span keeps the cluster tick it belongs to
  and its parent span's ``seq`` (spans nest: a ``STEP`` holds that
  tick's ``ADMIT``, launches and ``DRAIN``). Records of the shared
  control plane that know only model time (``PLACEMENT_REVIEW``
  decisions, ``TRANSFER_TASK``, ``FAULT``, ``PREFETCH``) are stamped at
  the wall instant they were emitted and keep their model times in
  args. Tracing adds no host sync to the zero-stall loop: it records
  host-side intervals, and the device side is marked inside the
  captured step graphs (``kernels.ops.phase_mark``).

* :class:`Registry` — namespaced metric **providers**: each subsystem
  registers a callable producing its section (``per_server``, ``perf``,
  ``net``, ``tiers``, ``faults``, ``obs``) and :meth:`Registry.collect`
  assembles the one namespaced tree of ``EdgeCluster.metrics()``.

* :meth:`Tracer.export` — Chrome trace-event JSON (the format Perfetto
  and ``chrome://tracing`` load): one track per server plus a
  control-plane track, complete ("X") events in microseconds, sorted
  keys and a stable event order. ``tools/trace_view.py`` prints the
  textual per-phase breakdown of an exported file.

This module is dependency-light (numpy only), like ``api.py``: both
execution worlds import it, never the other way around.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np


class SpanKind:
    """Span vocabulary (plain strings, mirroring ``api.EventType``)."""

    # per-request phases (rid >= 0)
    QUEUE_WAIT = "QUEUE_WAIT"  # submit/enqueue -> admission (or shed)
    PREFILL_CHUNK = "PREFILL_CHUNK"  # runtime backend: the host side of
    #   one batched chunk call, from packing its inputs to its launch
    #   (rid = -1; args rows, batch = the bucket width, graph = replayed
    #   a captured graph, False for an eager call at a width the ladder
    #   lacks; with EP, ep_send_rows and ep_slot_rows = the capacities in
    #   force at that width, ``moe.ep_call_capacities``); sim backend: the
    #   modeled prefill phase of one request
    DECODE_ROUND = "DECODE_ROUND"  # runtime backend: the host side of one
    #   decode round, packing to launch (args as PREFILL_CHUNK's); sim:
    #   the modeled decode phase of one request (rid >= 0)
    PREFIX_HIT = "PREFIX_HIT"  # instant: admission reused cached pages
    SHED = "SHED"  # instant: SLO-aware admission dropped the request
    FAILOVER_REPREFILL = "FAILOVER_REPREFILL"  # instant: crash victim
    #   re-enqueued on a surviving server (re-prefills from scratch)
    COLD_FETCH_STALL = "COLD_FETCH_STALL"  # a back-tier expert was
    #   invoked before any prefetch landed it (modeled stall span)

    # control-plane / system spans (rid = -1)
    PLACEMENT_REVIEW = "PLACEMENT_REVIEW"  # one controller decision
    #   record (adopt/reject reason + Eq.-4 cost breakdown): an instant
    #   on the sim clock; on the wall clock the span of the review that
    #   made it (the re-gather of an applied plan, MIGRATE, inside)
    TRANSFER_TASK = "TRANSFER_TASK"  # one staged-migration transfer
    #   occupying one link (span = its slice of the schedule)
    FAULT = "FAULT"  # instant: one consumed FaultEvent
    PREFETCH = "PREFETCH"  # one tier promotion fetch that landed

    # runtime backend, wall clock only (rid = -1)
    STEP = "STEP"  # one cluster tick (``_RuntimeBackend.step``; a
    #   standalone runtime's ``step``)
    ADMIT = "ADMIT"  # admission: queue -> slots and pages
    DRAIN = "DRAIN"  # draining launched rounds' outputs (args records)
    DEVICE_WAIT = "DEVICE_WAIT"  # the host blocked on a round's output
    #   copies (only when they had not finished)
    MIGRATE = "MIGRATE"  # ``engine.migrate``: the table copy and the
    #   eager re-gather of the EP expert slots

    REQUEST = (QUEUE_WAIT, PREFILL_CHUNK, DECODE_ROUND, PREFIX_HIT, SHED,
               FAILOVER_REPREFILL, COLD_FETCH_STALL)
    SYSTEM = (PLACEMENT_REVIEW, TRANSFER_TASK, FAULT, PREFETCH, STEP, ADMIT,
              DRAIN, DEVICE_WAIT, MIGRATE)
    ALL = REQUEST + SYSTEM


_REQUEST_KINDS = frozenset(SpanKind.REQUEST)
CLOCKS = ("seconds", "wall")


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded span on the tracer's clock.

    ``start == end`` marks an instant event. ``rid`` is -1 for system
    and batch-level spans; ``server`` is -1 for cluster-wide ones (the
    control-plane track). ``seq`` is the tracer-assigned monotonic
    index (on the wall clock assigned when the span opens, so a parent's
    is below its children's). ``parent`` (the enclosing span's ``seq``)
    and ``tick`` (the cluster tick) are kept on the wall clock, -1
    elsewhere.
    """

    kind: str
    start: float
    end: float
    rid: int = -1
    server: int = -1
    seq: int = -1
    args: dict | None = None
    parent: int = -1
    tick: int = -1

    @property
    def duration(self) -> float:
        return max(self.end - self.start, 0.0)


def _jsonable(v):
    """Coerce a span-args value into plain JSON types (numpy scalars and
    arrays appear in controller diags and fault payloads)."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


class Tracer:
    """Span recorder on one clock.

    clock:      ``"seconds"`` (sim backend: modeled seconds) or
                ``"wall"`` (runtime backend: ``time.time_ns()``).
    max_events: hard cap on retained spans; further emissions are
                counted in ``dropped`` instead of growing without bound
                (the bench gate asserts ``dropped_events == 0``).

    ``span`` / ``instant`` take times on the model clock of the shared
    emitters. On the wall clock the runtime opens nested spans with
    ``begin`` / ``end`` and records known intervals with ``record``;
    a model-clock emission is stamped at the wall instant it happens,
    with its model times in args (``model_start``, ``model_end``; an
    instant's ``model_time``), and one of the same kind as the
    innermost open span annotates that span instead (the controller's
    decision record inside the review the runtime times).
    ``overhead_s`` meters the wall cost of recording itself.
    """

    enabled = True

    def __init__(self, clock: str = "wall", max_events: int = 1_000_000):
        if clock not in CLOCKS:
            raise ValueError(f"clock must be one of {CLOCKS}, got {clock!r}")
        self.clock = clock
        self.max_events = int(max_events)
        self.spans: list[Span] = []
        self.dropped = 0
        self.overhead_s = 0.0
        self._counts: dict[str, int] = {}
        self._seq = 0
        self._open: list[Span] = []   # wall clock: the open spans (their
        #   ends not yet known)
        self.tick = -1                 # wall clock: the current tick

    # -- recording -----------------------------------------------------
    def _keep(self, sp: Span) -> Span | None:
        if len(self.spans) >= self.max_events:
            self.dropped += 1
            return None
        self.spans.append(sp)
        self._counts[sp.kind] = self._counts.get(sp.kind, 0) + 1
        return sp

    def span(self, kind: str, start: float, end: float, rid: int = -1,
             server: int = -1, **args) -> Span | None:
        """Record one completed span on the model clock (emission sites
        know both endpoints by the time they emit). Returns the record,
        or None when the ``max_events`` cap dropped it (or, on the wall
        clock, when it annotated the open span of its kind)."""
        t0 = time.perf_counter()
        if self.clock == "wall":
            if start == end:
                args["model_time"] = start
            else:
                args.update(model_start=start, model_end=end)
            top = self._open[-1] if self._open else None
            if top is not None and top.kind == kind:
                top.args.update(args)
                sp = None
            else:
                now = time.time_ns()
                sp = self._keep(self._closed(kind, now, now, rid, server,
                                             args))
        else:
            sp = self._keep(Span(kind, float(start), float(end), int(rid),
                                 int(server), self._seq, args or None))
            if sp is not None:
                self._seq += 1
        self.overhead_s += time.perf_counter() - t0
        return sp

    def instant(self, kind: str, t: float, rid: int = -1, server: int = -1,
                **args) -> Span | None:
        """Record a zero-duration event on the model clock."""
        return self.span(kind, t, t, rid=rid, server=server, **args)

    # -- the wall clock --------------------------------------------------
    @staticmethod
    def now() -> int:
        """The wall clock: nanoseconds of ``time.time_ns()``."""
        return time.time_ns()

    def _closed(self, kind, start, end, rid, server, args) -> Span:
        top = self._open[-1] if self._open else None
        sp = Span(kind, start, end, int(rid), int(server), self._seq,
                  args or None, top.seq if top else -1,
                  top.tick if top else self.tick)
        self._seq += 1
        return sp

    def begin(self, kind: str, rid: int = -1, server: int = -1,
              tick: int | None = None, **args) -> Span:
        """Open a wall-clock span inside the innermost open one (its
        parent); ``tick`` defaults to the parent's, else the last tick
        a span was opened with. Close it with :meth:`end`."""
        t0 = time.perf_counter()
        top = self._open[-1] if self._open else None
        if tick is None:
            tick = top.tick if top else self.tick
        else:
            self.tick = int(tick)
        op = Span(kind, time.time_ns(), -1, int(rid), int(server),
                  self._seq, args, top.seq if top else -1, int(tick))
        self._seq += 1
        self._open.append(op)
        self.overhead_s += time.perf_counter() - t0
        return op

    def end(self, op: Span, keep: bool = True, **args) -> Span | None:
        """Close ``op`` (and any span opened inside it and left open),
        adding ``args``. ``keep=False`` discards it: a span that timed
        nothing worth a record (spans opened inside it must have been
        discarded too)."""
        t0 = time.perf_counter()
        end = time.time_ns()
        while self._open:
            top = self._open.pop()
            if top is op:
                break
        sp = None
        if keep:
            op.args.update(args)
            sp = self._keep(dataclasses.replace(op, end=end,
                                                args=op.args or None))
        elif self._seq == op.seq + 1:
            self._seq = op.seq     # nothing was numbered after it
        self.overhead_s += time.perf_counter() - t0
        return sp

    def record(self, kind: str, start: int, end: int, rid: int = -1,
               server: int = -1, **args) -> Span | None:
        """Record a wall-clock interval whose endpoints the caller took
        with :meth:`now` (a request's queue wait; ``start == end``: an
        instant), inside the innermost open span."""
        t0 = time.perf_counter()
        sp = self._keep(self._closed(kind, int(start), int(end), rid, server,
                                     args))
        self.overhead_s += time.perf_counter() - t0
        return sp

    @property
    def depth(self) -> int:
        """How many wall-clock spans are open."""
        return len(self._open)

    # -- reading -------------------------------------------------------
    def by_kind(self, kind: str) -> list[Span]:
        return [s for s in self.spans if s.kind == kind]

    def request_spans(self, rid: int) -> list[Span]:
        """One request's spans, in emission order."""
        return [s for s in self.spans if s.rid == rid]

    def summary(self) -> dict:
        """The ``metrics.obs`` section of ``bench-serving/v8``: span
        counts by kind, the drop counter (gated == 0) and the tracer's
        wall-clock recording overhead."""
        return {
            "enabled": int(self.enabled),
            "clock": self.clock,
            "events": len(self.spans),
            "dropped_events": int(self.dropped),
            "overhead_ms": round(self.overhead_s * 1e3, 6),
            "span_counts": {k: self._counts[k] for k in sorted(self._counts)},
        }

    # -- Chrome-trace / Perfetto export --------------------------------
    def to_trace_doc(self) -> dict:
        """The trace as a Chrome trace-event document (one dict per
        event; load the exported file at https://ui.perfetto.dev or
        ``chrome://tracing``). Tracks: ``tid = server + 1`` per server,
        ``tid 0`` = the control plane (and any span without a server).
        Times are microseconds (on the wall clock, since the Unix
        epoch, as ``torch.profiler``'s traces have them; wall spans add
        ``parent`` and ``tick`` to their args). Field values are plain
        JSON and the event order is (ts, seq) — deterministic, so two
        runs of the same sim ``FaultSchedule`` scenario serialize to
        identical bytes."""
        wall = self.clock == "wall"
        scale = 1e-3 if wall else 1e6
        events = []
        tids = set()
        for sp in self.spans:
            tid = sp.server + 1
            tids.add(tid)
            args = {"rid": sp.rid, "seq": sp.seq}
            if wall:
                args.update(parent=sp.parent, tick=sp.tick)
            if sp.args:
                args.update(_jsonable(sp.args))
            events.append({
                "ph": "X",
                "name": sp.kind,
                "cat": "request" if sp.kind in _REQUEST_KINDS else "system",
                "pid": 0,
                "tid": tid,
                "ts": round(sp.start * scale, 3),
                "dur": round(sp.duration * scale, 3),
                "args": args,
            })
        events.sort(key=lambda e: (e["ts"], e["args"]["seq"]))
        meta = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "repro-serving"},
        }]
        for tid in sorted(tids):
            meta.append({
                "ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                "args": {"name": ("control-plane" if tid == 0
                                  else f"server{tid - 1}")},
            })
        return {
            "displayTimeUnit": "ms",
            "otherData": {"clock": self.clock, "spans": len(self.spans),
                          "dropped": int(self.dropped)},
            "traceEvents": meta + events,
        }

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (sorted keys +
        trailing newline: the byte-stable form the determinism tests and
        the CI artifact gate compare). Returns ``path``."""
        doc = self.to_trace_doc()
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True, indent=1)
            f.write("\n")
        return path


class _NullTracer(Tracer):
    """The shared always-off tracer: every record call is a no-op and
    ``enabled`` is False, so hot paths guarded on it skip argument
    construction entirely (zero allocation when disabled)."""

    enabled = False

    def __init__(self):
        super().__init__(max_events=0)

    def span(self, kind, start, end, rid=-1, server=-1, **args):
        return None

    def instant(self, kind, t, rid=-1, server=-1, **args):
        return None

    def begin(self, kind, rid=-1, server=-1, tick=None, **args):
        return None

    def end(self, op, keep=True, **args):
        return None

    def record(self, kind, start, end, rid=-1, server=-1, **args):
        return None

    def export(self, path: str) -> str:
        raise RuntimeError(
            "tracing is disabled: construct the runtime/cluster with a "
            "Tracer (e.g. EdgeCluster(..., trace=True)) before exporting")


NULL_TRACER = _NullTracer()


def as_tracer(trace, clock: str) -> Tracer:
    """Normalize the ``trace=`` knob: a Tracer instance is used as-is
    (its clock must match the backend's), truthy builds one on the
    backend's clock, falsy is :data:`NULL_TRACER`."""
    if isinstance(trace, Tracer):
        if trace.enabled and trace.clock != clock:
            raise ValueError(
                f"tracer records the {trace.clock!r} clock but this "
                f"backend runs on {clock!r}")
        return trace
    return Tracer(clock=clock) if trace else NULL_TRACER


# ---------------------------------------------------------------------------
# The namespaced metrics registry
# ---------------------------------------------------------------------------

class Registry:
    """Namespaced metrics tree assembled from per-subsystem providers.

    Each subsystem registers a zero-argument callable producing its
    section dict (or ``None`` to omit it this collection — e.g. no
    fault schedule attached). :meth:`collect` calls them in
    registration order, so the assembled tree is deterministic and
    always reflects live state — the pattern ``EdgeCluster.metrics()``
    is rebuilt on.
    """

    def __init__(self):
        self._providers: dict = {}

    def register(self, namespace: str, provider) -> None:
        """Register (or replace) the provider for ``namespace``."""
        if not callable(provider):
            raise TypeError(
                f"provider for {namespace!r} must be callable, got "
                f"{provider!r}")
        self._providers[namespace] = provider

    @property
    def namespaces(self) -> tuple:
        return tuple(self._providers)

    def collect(self) -> dict:
        """One namespaced tree: ``{namespace: provider()}`` in
        registration order, omitting providers that returned None."""
        out = {}
        for ns, provider in self._providers.items():
            v = provider()
            if v is not None:
                out[ns] = v
        return out

