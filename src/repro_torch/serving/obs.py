"""Unified observability: span tracer, metrics registry, Chrome-trace
export (``repro_torch.serving.obs``).

Every subsystem grown so far — runtime, cluster, net, tiers, faults,
workload — exposes its own ad-hoc ``metrics()`` dict, but none of them
can answer *where one request's time went* (queue wait vs prefill vs
decode vs cold-expert stalls) or *why the controller adopted a plan*
(the Eq.-4 trade of ``C(P') + T_mig`` against ``C(P)``). This module
adds the missing layer, in three parts:

* :class:`Tracer` — a span recorder on the owning backend's **model
  clock** (scheduler ticks for the runtime backend, modeled seconds for
  the simulator). Emission sites guard on ``tracer.enabled``, so a
  disabled tracer allocates nothing on the hot path; :data:`NULL_TRACER`
  is the shared always-off instance every subsystem defaults to. The
  span vocabulary (:class:`SpanKind`): per-request ``QUEUE_WAIT`` /
  ``PREFILL_CHUNK`` / ``DECODE_ROUND`` / ``PREFIX_HIT`` / ``SHED`` /
  ``FAILOVER_REPREFILL`` / ``COLD_FETCH_STALL``, and control-plane
  ``PLACEMENT_REVIEW`` (the full decision diag, Eq.-4 numbers included)
  / ``TRANSFER_TASK`` (per-link staged-migration transfers) / ``FAULT``
  / ``PREFETCH`` (tier promotions).

  **Determinism contract.** Span records carry model-clock times and a
  monotonic sequence number only — never the wall clock — so a traced
  rerun of a ``FaultSchedule`` scenario exports byte-identical JSON.
  Wall time appears exactly once, as the aggregate ``overhead_ms`` the
  ``obs`` metrics namespace reports (the analogue of the document's
  ``elapsed_s``, equally replay-exempt). The runtime backend records
  launch-side metadata only (tick, batch rows — host-known at launch),
  and completion data rides the existing async drain backlog, so
  tracing adds **zero host syncs** to the warmed zero-stall loop.

* :class:`Registry` — metric primitives (:class:`Counter`,
  :class:`Gauge`, :class:`Histogram`) plus namespaced **providers**:
  each subsystem registers a callable producing its section
  (``per_server``, ``perf``, ``net``, ``tiers``, ``faults``, ``obs``)
  and :meth:`Registry.collect` assembles the one namespaced tree that
  ``EdgeCluster.metrics()`` used to hand-merge from six call sites.
  :func:`snapshot_diff` turns two collected trees into a windowed
  reading (the registry-level analogue of ``TrafficMeter``'s
  cumulative-counts diff).

* :meth:`Tracer.export` — Chrome trace-event JSON (the format Perfetto
  and ``chrome://tracing`` load): one track per server plus a
  control-plane track, complete ("X") events in microseconds (1 tick
  renders as 1 ms), sorted keys and a stable event order — byte-stable
  across reruns. ``tools/trace_view.py`` prints the textual per-phase
  latency breakdown of an exported file.

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
    PREFILL_CHUNK = "PREFILL_CHUNK"  # one batched chunk call (runtime
    #   backend; rid = -1, args.rows requests rode it) / the modeled
    #   prefill phase of one request (sim backend; rid >= 0)
    DECODE_ROUND = "DECODE_ROUND"  # one decode round (runtime backend;
    #   rid = -1, batch-level) / the modeled decode phase (sim; rid >= 0)
    PREFIX_HIT = "PREFIX_HIT"  # instant: admission reused cached pages
    SHED = "SHED"  # instant: SLO-aware admission dropped the request
    FAILOVER_REPREFILL = "FAILOVER_REPREFILL"  # instant: crash victim
    #   re-enqueued on a surviving server (re-prefills from scratch)
    COLD_FETCH_STALL = "COLD_FETCH_STALL"  # a back-tier expert was
    #   invoked before any prefetch landed it (modeled stall span)

    # control-plane / system spans (rid = -1)
    PLACEMENT_REVIEW = "PLACEMENT_REVIEW"  # instant: one controller
    #   decision record (adopt/reject reason + Eq.-4 cost breakdown)
    TRANSFER_TASK = "TRANSFER_TASK"  # one staged-migration transfer
    #   occupying one link (span = its slice of the schedule)
    FAULT = "FAULT"  # instant: one consumed FaultEvent
    PREFETCH = "PREFETCH"  # one tier promotion fetch that landed

    REQUEST = (QUEUE_WAIT, PREFILL_CHUNK, DECODE_ROUND, PREFIX_HIT, SHED,
               FAILOVER_REPREFILL, COLD_FETCH_STALL)
    SYSTEM = (PLACEMENT_REVIEW, TRANSFER_TASK, FAULT, PREFETCH)
    ALL = REQUEST + SYSTEM


_REQUEST_KINDS = frozenset(SpanKind.REQUEST)


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded span on the tracer's model clock.

    ``start == end`` marks an instant event. ``rid`` is -1 for system
    and batch-level spans; ``server`` is -1 for cluster-wide ones (the
    control-plane track). ``seq`` is the tracer-assigned monotonic
    emission index — the rerun-stable total order within equal times.
    """

    kind: str
    start: float
    end: float
    rid: int = -1
    server: int = -1
    seq: int = -1
    args: dict | None = None

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
    """Deterministic dual-clock span recorder.

    clock:      the model clock spans are stamped with — ``"ticks"``
                (runtime backend: scheduler ticks) or ``"seconds"``
                (sim backend: modeled seconds). Export renders one tick
                as one millisecond.
    max_events: hard cap on retained spans; further emissions are
                counted in ``dropped`` instead of growing without bound
                (the bench gate asserts ``dropped_events == 0``).

    The wall clock is deliberately absent from span records (reruns
    must export byte-identical traces); it is metered only into
    ``overhead_s`` — the cumulative wall cost of recording itself.
    """

    enabled = True

    def __init__(self, clock: str = "ticks", max_events: int = 1_000_000):
        if clock not in ("ticks", "seconds"):
            raise ValueError(
                f"clock must be 'ticks' or 'seconds', got {clock!r}")
        self.clock = clock
        self.max_events = int(max_events)
        self.spans: list[Span] = []
        self.dropped = 0
        self.overhead_s = 0.0
        self._counts: dict[str, int] = {}
        self._seq = 0

    # -- recording -----------------------------------------------------
    def span(self, kind: str, start: float, end: float, rid: int = -1,
             server: int = -1, **args) -> Span | None:
        """Record one completed span (emission sites know both endpoints
        on the model clock by the time they emit). Returns the record,
        or None when the ``max_events`` cap dropped it."""
        t0 = time.perf_counter()
        if len(self.spans) >= self.max_events:
            self.dropped += 1
            self.overhead_s += time.perf_counter() - t0
            return None
        sp = Span(kind, float(start), float(end), int(rid), int(server),
                  self._seq, args or None)
        self._seq += 1
        self.spans.append(sp)
        self._counts[kind] = self._counts.get(kind, 0) + 1
        self.overhead_s += time.perf_counter() - t0
        return sp

    def instant(self, kind: str, t: float, rid: int = -1, server: int = -1,
                **args) -> Span | None:
        """Record a zero-duration event."""
        return self.span(kind, t, t, rid=rid, server=server, **args)

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
        Times are microseconds; the tick clock renders 1 tick = 1 ms so
        a decode round is a legible 1 ms block. Field values are plain
        JSON and the event order is (ts, seq) — deterministic, so two
        runs of the same ``FaultSchedule`` scenario serialize to
        identical bytes."""
        scale = 1e3 if self.clock == "ticks" else 1e6
        events = []
        tids = set()
        for sp in self.spans:
            tid = sp.server + 1
            tids.add(tid)
            args = {"rid": sp.rid, "seq": sp.seq}
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
        super().__init__(clock="ticks", max_events=0)

    def span(self, kind, start, end, rid=-1, server=-1, **args):
        return None

    def instant(self, kind, t, rid=-1, server=-1, **args):
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
# Metric primitives + the namespaced registry
# ---------------------------------------------------------------------------

class Counter:
    """A monotonic counter."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value


class Gauge:
    """A last-value-wins scalar."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """A bounded value distribution: a deterministic systematic 1-in-2^k
    subsample (no RNG — replays stay bit-identical), the same scheme the
    runtime's latency reservoirs use. ``count`` is the total number of
    observations, not the retained sample size."""

    def __init__(self, max_items: int = 4096):
        self.max_items = int(max_items)
        self.count = 0
        self._stride = 1
        self._items: list[float] = []

    def observe(self, x: float) -> None:
        if self.count % self._stride == 0:
            self._items.append(float(x))
            if len(self._items) >= self.max_items:
                self._items = self._items[::2]
                self._stride *= 2
        self.count += 1

    def __iter__(self):
        return iter(self._items)

    def percentiles(self, qs=(50, 99)) -> dict:
        if not self._items:
            return {f"p{int(q)}": 0.0 for q in qs}
        return {f"p{int(q)}": float(np.percentile(self._items, q))
                for q in qs}


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


def snapshot_diff(before: dict, after: dict) -> dict:
    """Windowed reading of two collected trees: numeric leaves become
    ``after - before``, non-numeric and newly-appeared leaves pass
    through from ``after``. Both inputs are left untouched."""
    out = {}
    for k, v in after.items():
        prev = before.get(k)
        if isinstance(v, dict) and isinstance(prev, dict):
            out[k] = snapshot_diff(prev, v)
        elif (isinstance(v, (int, float)) and not isinstance(v, bool)
                and isinstance(prev, (int, float))
                and not isinstance(prev, bool)):
            out[k] = v - prev
        else:
            out[k] = v
    return out
