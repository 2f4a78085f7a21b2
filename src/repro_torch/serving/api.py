"""Serving API v1: the typed request/event contract shared by every serving
surface in the repo.

One request shape — :class:`Request` — and one observable lifecycle —
:class:`RequestHandle` emitting structured :class:`Event` records — replace
the positional ``submit(prompt, max_new_tokens, origin=...)`` call and the
raw ``{rid: tokens}`` result dicts. Both execution worlds consume it
identically:

* the **runtime** backend (``ServingRuntime`` over the serving engines,
  clock = scheduler ticks / decode rounds), and
* the **sim** backend (the event-driven ``EdgeSimulator`` time model,
  clock = seconds),

selected via ``EdgeCluster(backend=...)`` (see ``repro_torch.serving.cluster``),
so a policy, benchmark or example written against this contract runs
unchanged against either.

Event lifecycle of one request::

    submit ──► ADMITTED ──► TOKEN* ──► FINISHED
        │          ▲                      ▲
        ├─ DEFERRED┘   (+ PREFIX_HIT at admission when cached pages matched)
        └─ SHED ──────────────────────────┘

``FINISHED`` carries the per-request metrics (latency in the backend's
clock, queue wait, locality, SLO verdict). The sim backend does not emit
``TOKEN`` events (it models time, not tokens). Under SLO-aware scheduling
(``EdgeCluster(slo_aware=True)`` / ``ServingRuntime(slo_aware=True)``) a
request whose deadline has become unmeetable is *shed*: it gets a ``SHED``
event followed immediately by a terminal ``FINISHED`` with ``tokens=0``,
``shed=True`` and ``slo_met=False`` — shed requests still resolve, they
just resolve empty.

This module is dependency-light (numpy only) on purpose: it is the contract
both backends import, never the other way around.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


class EventType:
    """Lifecycle event names (plain strings for cheap logging/JSON)."""
    ADMITTED = "ADMITTED"        # assigned a slot / started service
    DEFERRED = "DEFERRED"        # admission deferred (pool pressure); FIFO
    PREFIX_HIT = "PREFIX_HIT"    # admission reused cached prefix pages
    TOKEN = "TOKEN"              # one generated token (runtime backend)
    SHED = "SHED"                # dropped by SLO-aware admission: the
    #                              deadline became unmeetable; a terminal
    #                              FINISHED(tokens=0, shed=True) follows
    FINISHED = "FINISHED"        # done; carries the per-request metrics

    ALL = (ADMITTED, DEFERRED, PREFIX_HIT, TOKEN, SHED, FINISHED)

    # cluster-level events (rid = -1): the staged-migration lifecycle of
    # the shared placement control plane, surfaced by
    # ``EdgeCluster.events`` (payload: eta, transfer count/bytes/seconds)
    MIGRATION_STARTED = "MIGRATION_STARTED"      # plan adopted, transfers
    #                                              scheduled on the links
    MIGRATION_COMPLETED = "MIGRATION_COMPLETED"  # transfers done, plan live
    MIGRATION_ABORTED = "MIGRATION_ABORTED"      # in-flight transfers lost a
    #                                              source/link; plan dropped

    # fault-injection lifecycle (rid = -1): one record per consumed
    # FaultSchedule event (payload: the FaultEvent fields), plus the
    # failover bookkeeping the backends attach (victims re-routed,
    # tokens lost)
    SERVER_DOWN = "SERVER_DOWN"          # server crashed; experts/KV lost
    SERVER_JOINED = "SERVER_JOINED"      # server (re)joined empty
    LINK_DEGRADED = "LINK_DEGRADED"      # link bandwidth multiplied down
    LINK_RESTORED = "LINK_RESTORED"      # link back to profiled bandwidth

    CLUSTER = (MIGRATION_STARTED, MIGRATION_COMPLETED, MIGRATION_ABORTED,
               SERVER_DOWN, SERVER_JOINED, LINK_DEGRADED, LINK_RESTORED)


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured lifecycle event.

    ``time`` is in the emitting backend's clock (scheduler ticks for the
    runtime backend, seconds for the simulator); ``data`` is the typed
    payload (token id, deferral depth, the FINISHED metrics dict, ...).
    ``seq`` is the emitting backend's monotonic emission index — the
    tie-breaker that makes merged event streams (``EdgeCluster.events``
    interleaves per-request, migration and fault events) a *stable total
    order*: sort by ``(time, seq)``, never by insertion. -1 marks events
    from legacy emitters that predate sequencing.
    """
    type: str
    rid: int
    time: float
    data: dict = dataclasses.field(default_factory=dict)
    seq: int = -1


class SeqCounter:
    """Shared monotonic event-sequence source. One counter per backend
    (``EdgeCluster`` threads a single instance through its servers and
    its own fault/migration emitters), so equal-time events still have
    one deterministic order on rerun."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def __call__(self) -> int:
        v = self.value
        self.value += 1
        return v


@dataclasses.dataclass
class Request:
    """One typed generation request.

    prompt:          [T] int token ids (coerced to a 1-D int32 array).
    max_new_tokens:  tokens to generate (>= 1).
    origin:          edge server the request *arrived* at — drives routing
                     and the per-origin gating-stats attribution
                     (Algorithm 1's f_n(e)). ``None`` = unattributed.
    temperature:     sampling temperature (>= 0). 0.0 = greedy argmax
                     (bit-identical to serving API v1); > 0 = Gumbel-max
                     temperature sampling keyed by ``seed`` and the token
                     position, so reruns of the same request are
                     bit-identical (top-k/top-p are follow-up work).
    slo:             optional latency budget in the serving backend's clock
                     (ticks or seconds); FINISHED reports ``slo_met``
                     against the backend clock (FINISHED.time - submit
                     time). Under SLO-aware scheduling the backends also
                     *act* on it: deadline-ordered admission and
                     shed-on-overload (see :class:`EventType.SHED`).
    arrival:         arrival time in seconds (sim backend; the runtime
                     backend serves in submission order).
    task:            task-profile name (sim backend: selects the activation
                     distribution its time model samples from).
    eos:             optional stop-token id: generation ends early when the
                     model emits it (the EOS token itself is kept in the
                     output, matching ``max_new_tokens`` truncation of the
                     same stream). Under the runtime's zero-stall loop the
                     stop is detected at most one decode round late — the
                     token stream is unaffected.
    seed:            per-request PRNG seed for temperature sampling
                     (ignored at temperature 0.0). Two requests with the
                     same prompt, temperature and seed draw identical
                     token streams; distinct seeds decorrelate them.
    """
    prompt: np.ndarray
    max_new_tokens: int
    origin: int | None = None
    temperature: float = 0.0
    slo: float | None = None
    arrival: float | None = None
    task: str | None = None
    eos: int | None = None
    seed: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if len(self.prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (got {self.temperature}); "
                "0.0 means greedy argmax")
        if not 0 <= int(self.seed) < 2 ** 31:
            raise ValueError(f"seed must be in [0, 2**31) (got {self.seed})")
        if self.slo is not None and self.slo <= 0:
            raise ValueError(f"slo must be positive (got {self.slo})")
        if self.origin is not None and self.origin < 0:
            raise ValueError(f"origin must be >= 0 (got {self.origin})")
        if self.eos is not None and self.eos < 0:
            raise ValueError(f"eos must be >= 0 (got {self.eos})")


class RequestHandle:
    """Observable lifecycle of one submitted :class:`Request`.

    Backends append :class:`Event` records via :meth:`_emit`; consumers read
    ``events``, ``tokens`` (runtime backend), ``done`` and ``metrics`` (the
    FINISHED payload), or call :meth:`result` for the generated tokens.
    """

    def __init__(self, rid: int, request: Request, clock: str = "ticks",
                 seq: "SeqCounter | None" = None):
        self.rid = rid
        self.request = request
        self.clock = clock                 # "ticks" | "seconds"
        self._seqc = seq                   # shared backend event sequencer
        self.events: list[Event] = []
        self.server: int | None = None     # server the request was routed to
        self.submitted_at: float | None = None
        self.admitted_at: float | None = None
        self.deferred_ticks = 0            # scheduler ticks spent deferred
        self._tokens: list[int] = []
        self._finished: dict | None = None

    # -- backend side ------------------------------------------------------
    def _emit(self, type_: str, time: float, **data) -> Event:
        ev = Event(type_, self.rid, time, data,
                   self._seqc() if self._seqc is not None else -1)
        self.events.append(ev)
        if type_ == EventType.ADMITTED:
            self.admitted_at = time
            # first writer wins: a cluster router assigns the serving
            # server at submit time; the runtime's ADMITTED event (which
            # reports the *origin*) must not clobber that routing decision
            if self.server is None and data.get("server") is not None:
                self.server = int(data["server"])
        elif type_ == EventType.TOKEN:
            self._tokens.append(int(data["token"]))
        elif type_ == EventType.FINISHED:
            self._finished = data
        return ev

    # -- consumer side -----------------------------------------------------
    @property
    def done(self) -> bool:
        """True once the FINISHED event has been recorded."""
        return self._finished is not None

    @property
    def tokens(self) -> np.ndarray:
        """Generated tokens so far ([0] before any TOKEN event; the sim
        backend never emits tokens — use ``metrics`` there)."""
        return np.asarray(self._tokens, np.int32)

    @property
    def metrics(self) -> dict:
        """The FINISHED payload (latency, wait, locality, slo_met, ...);
        empty until the request finishes."""
        return dict(self._finished) if self._finished is not None else {}

    def result(self) -> np.ndarray:
        """The full generated token array; raises if not ``done`` yet."""
        if not self.done:
            raise RuntimeError(
                f"request {self.rid} has not finished; drive the runtime or "
                "cluster (step()/run()) before reading the result")
        return self.tokens

    def __repr__(self) -> str:  # debugging aid, not a stable format
        state = "done" if self.done else (
            "active" if self.admitted_at is not None else "queued")
        return (f"RequestHandle(rid={self.rid}, {state}, "
                f"events={len(self.events)}, clock={self.clock!r})")


# ---------------------------------------------------------------------------
# Routing: server selection, lifted out of the simulator so both backends
# (and EdgeCluster) share one pluggable policy
# ---------------------------------------------------------------------------

@runtime_checkable
class Router(Protocol):
    """Pick the serving server for a request.

    ``origin`` is the arrival server (or None); ``loads`` is a [N] array of
    earliest-start estimates — ``max(timeline.free, arrival)`` in the
    simulator, queue+active backlog in the runtime backend.
    """

    def route(self, origin: int | None, loads: np.ndarray) -> int:
        ...


@dataclasses.dataclass(frozen=True)
class HomeRouter:
    """Serve at the arrival server (the paper's default); requests without
    an origin fall back to the least-loaded server."""

    def route(self, origin: int | None, loads: np.ndarray) -> int:
        if origin is not None:
            return int(origin)
        return int(np.argmin(loads))


@dataclasses.dataclass(frozen=True)
class LeastLoadedRouter:
    """Redirect every request to the server that can start it earliest
    (the simulator's ``redirect=True`` baseline)."""

    def route(self, origin: int | None, loads: np.ndarray) -> int:
        return int(np.argmin(loads))


def as_router(router: "Router | str | None") -> Router:
    """Normalize: Router object | name ("home" / "least-loaded") | None."""
    if router is None:
        return HomeRouter()
    if isinstance(router, str):
        try:
            return {"home": HomeRouter,
                    "least-loaded": LeastLoadedRouter}[router]()
        except KeyError:
            raise KeyError(f"unknown router {router!r}; "
                           "available: 'home', 'least-loaded'") from None
    if isinstance(router, Router):
        return router
    raise TypeError(f"not a router: {router!r}")
