"""The harness's loop around the system under test.

Between ticks it submits every request that has fallen due; it ticks the
cluster while there is work, and sleeps until the next arrival when there
is none. After each tick it reads every live request's new events: a token
becomes visible to the client at the end of the tick that emitted it.
Requests are timed from when they were due, not from when they were
submitted. Each tick keeps its wall time, whether it issued a prefill
chunk or a decode round, whether a placement was applied in it, the
engine's per-origin routing counts it added and the placement residency
in force when it started.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

ADMITTED, PREFIX_HIT, TOKEN, FINISHED = ("ADMITTED", "PREFIX_HIT", "TOKEN",
                                         "FINISHED")


@dataclasses.dataclass
class ReqRec:
    req: object  # traffic.Req
    due_abs: float
    handle: object = None
    submit_t: float | None = None
    admit_t: float | None = None
    skipped: int = 0
    full_hit: bool = False
    token_t: list = dataclasses.field(default_factory=list)
    done_t: float | None = None
    ev_i: int = 0


@dataclasses.dataclass
class Tick:
    k: int
    t0: float
    t1: float
    prefill: bool
    decode: bool
    migrated: bool
    delta: np.ndarray  # [L, servers, E] routed (token, expert) rows drained
    res: np.ndarray  # [L, servers, E] residency when the tick started


class Driver:
    def __init__(self, cluster, recs: list, make_request,
                 clock=time.perf_counter):
        self.cluster = cluster
        self.backend = cluster.backend
        self.rt = cluster.backend.runtimes[0]
        self.engine = cluster.backend.engine
        self.ctrl = cluster.controller
        self.recs = recs
        self.make_request = make_request
        self.clock = clock
        self.next = 0
        self.live: list[ReqRec] = []
        self.ticks: list[Tick] = []
        self._counts = self.engine.stats.counts.copy()
        self._migs = len(self.backend.migrations)
        self._calls = (self.rt.prefill_calls, self.rt.decode_rows)
        self._res = (None, None)
        self.tracing = False

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("pbench." + name)

    def residency(self) -> np.ndarray:
        plan = self.ctrl.plan
        if self._res[0] is not plan:
            self._res = (plan, (plan.residency() > 0).astype(np.float64))
        return self._res[1]

    def submit_due(self, now: float) -> None:
        recs = self.recs
        while self.next < len(recs) and recs[self.next].due_abs <= now:
            r = recs[self.next]
            r.handle = self.cluster.submit(self.make_request(r.req))
            r.submit_t = self.clock()
            self.live.append(r)
            self.next += 1

    def tick(self) -> None:
        res = self.residency()
        k = len(self.ticks)
        t0 = self.clock()
        with self.span(f"step#{k}"):
            self.cluster.step()
        t1 = self.clock()
        counts = self.engine.stats.counts
        delta = counts - self._counts
        self._counts = counts.copy()
        calls = (self.rt.prefill_calls, self.rt.decode_rows)
        migs = len(self.backend.migrations)
        self.ticks.append(Tick(k, t0, t1, calls[0] != self._calls[0],
                               calls[1] != self._calls[1], migs != self._migs,
                               delta, res))
        self._calls, self._migs = calls, migs
        self.scan(t1)

    def scan(self, t: float) -> None:
        """Read each live request's new events as seen at time ``t``."""
        still = []
        for r in self.live:
            evs = r.handle.events
            for ev in evs[r.ev_i:]:
                kind = ev.type
                if kind == TOKEN:
                    r.token_t.append(t)
                elif kind == ADMITTED:
                    r.admit_t = t
                elif kind == PREFIX_HIT:
                    r.skipped = int(ev.data["tokens_skipped"])
                    r.full_hit = bool(ev.data["full_hit"])
                elif kind == FINISHED:
                    r.done_t = t
            r.ev_i = len(evs)
            if r.done_t is None:
                still.append(r)
        self.live = still

    def run(self, until: float, stop=None) -> None:
        """Serve until the clock reaches ``until`` or ``stop()`` holds."""
        while True:
            now = self.clock()
            if now >= until or (stop is not None and stop()):
                return
            with self.span("submit"):
                self.submit_due(now)
            if self.backend.pending:
                self.tick()
                continue
            nxt = (self.recs[self.next].due_abs
                   if self.next < len(self.recs) else until)
            with self.span("wait"):
                time.sleep(max(0.0, min(nxt, until) - self.clock()))

    def finish(self) -> None:
        """Drain the runtime's in-flight rounds and read what they emitted."""
        self.rt.flush()
        self.scan(self.clock())
