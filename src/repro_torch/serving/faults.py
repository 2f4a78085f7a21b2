"""Deterministic fault injection for the cluster backends.

Edge deployments churn: servers crash and rejoin, links sag under
cross-traffic. The cluster backends consume a :class:`FaultSchedule` — a
fixed list of timed :class:`FaultEvent`s — from their own clock (scheduler
ticks for the runtime backend, seconds for the simulator), so a fault run
is exactly as reproducible as a fault-free one: no RNG, no wall clock,
and two runs of the same schedule produce bit-identical event timelines.

The schedule only *describes* faults. Applying one mutates the shared
:class:`~repro_torch.serving.net.Topology`'s :class:`~repro_torch.serving.net.LinkState`
(:func:`apply_fault`); the failover response — re-routing in-flight
requests off a dead server, force-reviewing placement around the lost
capacity, aborting in-flight migrations whose source died — lives in the
backends and the :class:`~repro_torch.core.policies.PlacementController`.

Event kinds (mirrored as ``EventType.SERVER_DOWN`` etc. in the serving
API so cluster consumers see one event vocabulary):

* ``SERVER_DOWN(server)``    — the server vanishes: capacity, resident
  experts, KV pages and in-flight work are lost.
* ``SERVER_JOINED(server)``  — the server (re)joins empty; placement may
  expand onto it at the next review.
* ``LINK_DEGRADED(src, dst, factor)`` — the src->dst link's bandwidth is
  multiplied by ``factor`` (0 < factor < 1).
* ``LINK_RESTORED(src, dst)`` — the link returns to its profiled
  bandwidth.
"""

from __future__ import annotations

import dataclasses

SERVER_DOWN = "SERVER_DOWN"
SERVER_JOINED = "SERVER_JOINED"
LINK_DEGRADED = "LINK_DEGRADED"
LINK_RESTORED = "LINK_RESTORED"

KINDS = (SERVER_DOWN, SERVER_JOINED, LINK_DEGRADED, LINK_RESTORED)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed fault. ``time`` is in the consuming backend's clock
    (ticks or seconds). Server events use ``server``; link events use
    ``src``/``dst`` (+ ``factor`` for degradation)."""

    time: float
    kind: str
    server: int | None = None
    src: int | None = None
    dst: int | None = None
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {KINDS}"
            )
        if self.time < 0:
            raise ValueError(f"fault time must be >= 0 (got {self.time})")
        if self.kind in (SERVER_DOWN, SERVER_JOINED):
            if self.server is None or self.server < 0:
                raise ValueError(f"{self.kind} requires server >= 0")
        else:
            if (
                self.src is None
                or self.dst is None
                or self.src < 0
                or self.dst < 0
                or self.src == self.dst
            ):
                raise ValueError(f"{self.kind} requires distinct src/dst >= 0")
        if self.kind == LINK_DEGRADED and not (0.0 < self.factor < 1.0):
            raise ValueError(
                f"LINK_DEGRADED factor must be in (0, 1), got {self.factor}"
            )

    def payload(self) -> dict:
        """JSON-able event payload (for cluster Event records)."""
        out = {"kind": self.kind, "time": self.time}
        if self.server is not None:
            out["server"] = self.server
        if self.src is not None:
            out["src"] = self.src
            out["dst"] = self.dst
        if self.kind == LINK_DEGRADED:
            out["factor"] = self.factor
        return out


class FaultSchedule:
    """An ordered, replayable fault timeline.

    Events are consumed in (time, insertion-order) order via :meth:`due`
    as the owning backend's clock advances. ``reset()`` rewinds for a
    bit-identical rerun; the event list itself is never mutated.
    """

    def __init__(self, events=()):
        evs = list(events)
        for ev in evs:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"not a FaultEvent: {ev!r}")
        # stable sort: same-time events keep insertion order
        self.events: tuple[FaultEvent, ...] = tuple(sorted(evs, key=lambda e: e.time))
        self._next = 0

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def remaining(self) -> int:
        return len(self.events) - self._next

    def due(self, now: float) -> list[FaultEvent]:
        """Pop every event with ``time <= now``, in schedule order."""
        out = []
        while self._next < len(self.events) and self.events[self._next].time <= now:
            out.append(self.events[self._next])
            self._next += 1
        return out

    def peek(self) -> FaultEvent | None:
        """Next un-consumed event (None when exhausted)."""
        if self._next < len(self.events):
            return self.events[self._next]
        return None

    def reset(self) -> "FaultSchedule":
        self._next = 0
        return self

    def copy(self) -> "FaultSchedule":
        """Fresh un-consumed schedule over the same events."""
        return FaultSchedule(self.events)

    # -- convenience constructors -------------------------------------
    @staticmethod
    def server_crash(
        time: float, server: int, rejoin_at: float | None = None
    ) -> "FaultSchedule":
        """One server dies at ``time`` (and optionally rejoins later)."""
        events = [FaultEvent(time, SERVER_DOWN, server=server)]
        if rejoin_at is not None:
            if rejoin_at <= time:
                raise ValueError("rejoin_at must be after the crash time")
            events.append(FaultEvent(rejoin_at, SERVER_JOINED, server=server))
        return FaultSchedule(events)

    @staticmethod
    def link_brownout(
        time: float, src: int, dst: int, factor: float, restore_at: float | None = None
    ) -> "FaultSchedule":
        """The src->dst link degrades to ``factor`` of its bandwidth at
        ``time`` (and optionally recovers later)."""
        events = [FaultEvent(time, LINK_DEGRADED, src=src, dst=dst, factor=factor)]
        if restore_at is not None:
            if restore_at <= time:
                raise ValueError("restore_at must be after the fault time")
            events.append(FaultEvent(restore_at, LINK_RESTORED, src=src, dst=dst))
        return FaultSchedule(events)


def apply_fault(event: FaultEvent, topology, tracer=None, now: float = 0.0) -> None:
    """Mutate ``topology.state`` (the shared :class:`LinkState`) to
    reflect ``event``. The placement/failover *response* is the caller's
    job; this only flips the liveness/bandwidth switches every cost
    primitive reads. A ``tracer`` (``repro_torch.serving.obs.Tracer``) records
    the consumption as a ``FAULT`` instant at ``now`` on the caller's
    clock, carrying the full :meth:`FaultEvent.payload`."""
    if tracer is not None and tracer.enabled:
        tracer.instant(
            "FAULT",
            now,
            server=event.server if event.server is not None else -1,
            fault=event.payload(),
        )
    state = topology.state
    if event.kind == SERVER_DOWN:
        state.up[event.server] = False
    elif event.kind == SERVER_JOINED:
        state.up[event.server] = True
    elif event.kind == LINK_DEGRADED:
        state.bw_factor[event.src, event.dst] = event.factor
    elif event.kind == LINK_RESTORED:
        state.bw_factor[event.src, event.dst] = 1.0
