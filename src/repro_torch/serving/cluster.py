"""Edge-cluster description and the multi-server serving façade.

Two layers live here:

* the faithful testbed model of the paper (Sec. IV): ``ServerSpec`` /
  ``ClusterSpec`` / ``MoEProfile`` — N servers with different GPU
  counts/memory/compute, linked by rate-limited networking (testbed:
  500 Mbps via Linux tc). The event-driven simulator consumes it.
* ``EdgeCluster`` — the serving-API-v1 façade over the paper's headline
  scenario: N edge servers cooperatively serving one MoE model, one
  pluggable router, one shared ``PlacementController``, and **two
  interchangeable backends** selected by ``backend=``:

  - ``"runtime"`` — the PyTorch serving engines (``ServingRuntime``),
    clock = scheduler ticks; the N servers are virtual EP ranks of one
    engine, and on the card its MoE layers run the hand-written kernels.
    Either one shared runtime with origin-tagged slots (default — one KV
    pool, the EP spec already spans the N servers) or N per-server
    runtimes (``shared_runtime=False``, per-server KV pools and decode
    batches, where memory allows).
  - ``"sim"`` — the event-driven ``EdgeSimulator`` time model, clock =
    seconds.

  Both consume the same typed ``repro_torch.serving.api.Request`` stream and
  emit the same ``RequestHandle`` events, so policies, benchmarks and
  examples run identically against either world.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.serving.api import (Event, EventType, Request,
                                     RequestHandle, SeqCounter, as_router)
from repro_torch.serving.faults import (FaultSchedule, SERVER_DOWN,
                                        SERVER_JOINED, LINK_DEGRADED,
                                        apply_fault)
from repro_torch.serving.net import Topology, TrafficMeter
from repro_torch.serving.obs import NULL_TRACER, Registry, SpanKind, as_tracer


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """One simulated edge server's resource envelope (legacy scalar-link
    form; ``repro_torch.serving.net.ServerProfile`` is the topology-aware
    successor). All fields are absolute units, not GB/GHz:
    ``mem_bytes`` is usable GPU memory for expert weights in **bytes**,
    ``compute_speed`` effective expert-matmul throughput in **FLOP/s**,
    ``io_speed`` local weight-load bandwidth in **bytes/s**."""

    name: str
    gpus: int = 1
    mem_bytes: float = 16e9            # usable GPU memory for experts
    compute_speed: float = 60e12       # effective FLOP/s for expert matmuls
    io_speed: float = 8e9              # weight-load bytes/s (PCIe/NVMe)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A uniform-interconnect cluster: N ``ServerSpec``s joined by one
    scalar link (``bandwidth`` in **bytes/s**, ``rtt`` per remote call in
    **seconds**). ``Topology.from_cluster_spec`` lifts this into the
    per-link matrix form the net subsystem uses."""

    servers: tuple[ServerSpec, ...]
    bandwidth: float = 500e6 / 8       # bytes/s between servers (500 Mbps)
    rtt: float = 2e-3                  # per-remote-call latency (s)

    @property
    def n(self) -> int:
        return len(self.servers)

    def expert_capacity(self, expert_bytes: float) -> np.ndarray:
        """Per-server total expert-slot budget (M_n / m_e of Algorithm 1)."""
        return np.array([int(s.mem_bytes // expert_bytes)
                         for s in self.servers])


@dataclasses.dataclass(frozen=True)
class MoEProfile:
    """Analytic per-token costs for one MoE model (drives the time model).

    Dimensionless architecture counts plus ``bytes_per_param`` (bytes per
    weight, 2.0 = bf16); everything derived is in absolute bytes/FLOPs so
    it divides cleanly by ``ServerProfile`` bandwidths (bytes/s) and
    compute speeds (FLOP/s)."""

    num_layers: int
    num_experts: int
    top_k: int
    d_model: int
    d_ff: int
    bytes_per_param: float = 2.0

    @property
    def expert_bytes(self) -> float:
        """Weight bytes of ONE expert FFN (gate/up/down projections)."""
        return 3 * self.d_model * self.d_ff * self.bytes_per_param

    @property
    def expert_flops_per_token(self) -> float:
        """FLOPs one token costs in one expert (fwd matmuls only)."""
        return 2 * 3 * self.d_model * self.d_ff

    @property
    def dense_flops_per_token(self) -> float:
        # attention projections + attention math approximation per layer
        return 2 * 4 * self.d_model * self.d_model

    @property
    def hidden_bytes_per_token(self) -> float:
        """Bytes of one token's hidden-state activation (one link leg)."""
        return self.d_model * self.bytes_per_param

    @staticmethod
    def from_config(cfg) -> "MoEProfile":
        """Derive the profile from a ``repro_torch.configs`` model config."""
        return MoEProfile(num_layers=cfg.num_layers,
                          num_experts=cfg.num_experts, top_k=cfg.top_k,
                          d_model=cfg.d_model, d_ff=cfg.d_ff)


def paper_testbed(mem_fraction: float = 1.0) -> ClusterSpec:
    """The paper's testbed: 3 simulated edge servers with GPU allocations
    1/1/2 (A100-40G), 500 Mbps interconnect. ``mem_fraction`` reproduces the
    paper's artificial memory constraint (0.7 for Mixtral, 0.3 for
    DeepSeek-V2-Lite)."""
    return ClusterSpec(servers=(
        ServerSpec("server1", gpus=1, mem_bytes=mem_fraction * 40e9,
                   compute_speed=50e12),
        ServerSpec("server2", gpus=1, mem_bytes=mem_fraction * 40e9,
                   compute_speed=50e12),
        ServerSpec("server3", gpus=2, mem_bytes=mem_fraction * 2 * 40e9,
                   compute_speed=100e12),
    ))


MIXTRAL_PROFILE = MoEProfile(num_layers=32, num_experts=8, top_k=2,
                             d_model=4096, d_ff=14336)
DEEPSEEK_V2_LITE_PROFILE = MoEProfile(num_layers=26, num_experts=64, top_k=8,
                                      d_model=2048, d_ff=1408)


# ---------------------------------------------------------------------------
# EdgeCluster: the serving-API-v1 façade over both execution worlds
# ---------------------------------------------------------------------------

class _RuntimeBackend:
    """N edge servers over the PyTorch serving stack (clock = ticks).

    One shared ``ServingRuntime`` with origin-tagged slots (default: one KV
    pool — the engine's EP spec already spans the N servers), or N
    per-server runtimes (own pools and decode batches) when memory allows.
    The router picks the serving runtime in per-server mode; in shared
    mode admission is cluster-wide, so requests are recorded at their
    origin (round-robin for origin-less ones) and never redirected.
    The shared ``PlacementController`` is reviewed on the *cluster* tick
    clock, so per-server runtimes do not double-count reviews.
    """
    clock = "ticks"

    def __init__(self, engine, n_servers: int, router, controller,
                 shared_runtime: bool, runtime_opts: dict,
                 topology: Topology | None = None,
                 fault_schedule: FaultSchedule | None = None,
                 failover: bool = True, prefetch: bool = True,
                 slo_aware: bool = False, tracer=None, seq=None):
        from repro_torch.serving.runtime import ServingRuntime   # lazy: keeps
        #   the sim world (simulator.py imports this module) free of torch
        self.engine = engine
        self.n = n_servers
        self.router = router
        self.controller = controller
        self.shared = shared_runtime
        self.topology = topology
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.seqc = seq if seq is not None else SeqCounter()
        if controller is not None and getattr(controller, "tracer",
                                              None) is None:
            controller.tracer = self.tracer
        n_ep = engine.rt.ep_spec.n_ep if engine.rt.ep_spec is not None else 1
        # per-origin stats attribution needs one EP rank per server; when
        # the engine cannot represent every origin, serve untagged (the
        # positional fallback) rather than mis-crediting traffic
        self.tag_origins = n_ep >= n_servers
        if controller is not None:
            if controller.stats is None:
                controller.stats = engine.stats
            if controller.last_review is None:
                controller.last_review = 0.0       # full first interval
            controller.attach_topology(topology,
                                       expert_bytes=self._expert_bytes())
        # -- expert tier hierarchy (host-RAM / modeled disk) ------------
        self.tiers = None
        if (topology is not None and topology.tiered
                and controller is not None):
            from repro_torch.serving.tiers import TierManager
            eb = getattr(controller.cost, "expert_bytes", None)
            self.tiers = TierManager(
                topology, float(eb) if eb else self._expert_bytes(),
                prefetch=prefetch, clock_rate=controller.clock_rate,
                tracer=self.tracer)
            controller.tiers = self.tiers
            if controller.plan is not None:
                self.tiers.bind(controller.plan)   # pre-set plans (e.g.
                #   ctrl.plan = uniform_plan(...)) bypass _set_plan
        itemsize = engine.rt.dtype.itemsize        # a torch dtype
        self.meter = (TrafficMeter(topology,
                                   engine.rt.cfg.d_model * itemsize)
                      if topology is not None else None)
        if self.meter is not None:
            # the engine may have served before this cluster existed
            # (warmup generate(), a previous cluster): its lifetime stats
            # are not this cluster's dispatch traffic
            self.meter.seed(engine.stats.counts)
        opts = [dict(runtime_opts)
                for _ in range(1 if shared_runtime else n_servers)]
        if slo_aware:
            # every member runtime schedules deadline-first and sheds
            # unmeetable requests (an explicit runtime_opts wins)
            for o in opts:
                o.setdefault("slo_aware", True)
        if (not shared_runtime and topology is not None
                and "n_blocks" not in runtime_opts):
            # heterogeneous KV budgets: each server's paged pool is sized
            # by its own ServerProfile cap (per-position bytes estimated
            # as k+v full-width rows across the layers)
            bs = runtime_opts.get("block_size", 16)
            pos_bytes = (2.0 * engine.rt.cfg.num_layers
                         * engine.rt.cfg.d_model * itemsize)
            budgets = topology.kv_block_budgets(bs * pos_bytes)
            for s, o in enumerate(opts):
                o["n_blocks"] = 1 + int(budgets[s])
        self.runtimes = [
            ServingRuntime(engine, controller=None, tracer=self.tracer,
                           seq_counter=self.seqc,
                           tracer_server=(-1 if shared_runtime else s), **o)
            for s, o in enumerate(opts)]
        self.rounds = 0
        self._rr = 0                 # round-robin cursor (shared mode)
        self._res_cache = (None, None)   # (placement, its [L, N, E] view)
        self.migrations: list = []
        # -- satellite: metering must never fail silently --------------
        self.meter_skips = 0         # observe() calls skipped on a shape
        #   mismatch between the residency view and the engine's counts
        self._meter_skip_streak = 0
        self._meter_ok = 0           # successful observe() calls
        # -- fault injection / failover --------------------------------
        self.faults = fault_schedule
        self.failover = failover
        self.fault_events: list[Event] = []
        self.faults_injected = 0
        self.faults_recovered = 0    # crashes whose victims all finished
        self.tokens_lost = 0         # emitted tokens discarded (+ undelivered
        #                              remainder of dropped requests)
        self.requests_dropped = 0    # victims abandoned (failover=False)
        self.recovery_ticks = 0.0    # crash -> last-victim-finished, summed
        self._recovering: list[tuple[float, list[RequestHandle]]] = []

    @property
    def sheds(self) -> int:
        """Requests shed by the members' SLO-aware admission (0 unless
        ``slo_aware``)."""
        return sum(r.sheds for r in self.runtimes)

    def _alive(self) -> np.ndarray:
        """[N] bool liveness (all-up without a topology)."""
        if self.topology is None:
            return np.ones(self.n, bool)
        return np.asarray(self.topology.state.up, bool)

    def _next_live_rr(self, alive: np.ndarray) -> int:
        """Advance the shared-mode round-robin cursor to the next live
        server (identical to the plain cursor while every server is up)."""
        for _ in range(self.n):
            s = self._rr
            self._rr = (self._rr + 1) % self.n
            if alive[s]:
                return s
        raise RuntimeError("no live servers in the cluster")

    def _expert_bytes(self) -> float:
        cfg = self.engine.rt.cfg
        return float(3 * cfg.d_model * cfg.d_ff
                     * self.engine.rt.dtype.itemsize)

    def _residency(self) -> np.ndarray | None:
        """[L, N, E] residency for the traffic meter: the controller's
        active plan, falling back to the engine's live placement tables
        (controller-less clusters still meter their dispatch traffic)."""
        ctrl = self.controller
        if ctrl is not None and ctrl.plan is not None:
            return ctrl.plan.residency()
        pl = self.engine.placement
        if pl is None:
            return None
        if self._res_cache[0] is pl:
            return self._res_cache[1]
        # the engine holds its tables as device tensors: one copy to the
        # host per adopted placement, not one per tick
        s2e = pl.slot_to_expert
        s2e = (s2e.cpu().numpy() if hasattr(s2e, "cpu")
               else np.asarray(s2e))                 # [G, n_ep, S]
        G, N, _ = s2e.shape
        E = self.engine.rt.cfg.num_experts
        res = np.zeros((G, N, E))
        for l in range(G):
            for n in range(N):
                for e in s2e[l, n]:
                    if e >= 0:
                        res[l, n, int(e)] = 1.0
        self._res_cache = (pl, res)
        return res

    def loads(self) -> np.ndarray:
        """[N] backlog estimate (queued + active) per server."""
        return np.array([len(r.queue) + r.active for r in self.runtimes],
                        float)

    def submit(self, req: Request) -> RequestHandle:
        if req.origin is not None and not 0 <= req.origin < self.n:
            # fail at the submit site (the sim backend's contract too) —
            # not as an IndexError in routing or metrics()
            raise ValueError(
                f"origin {req.origin} out of range for {self.n} server(s)")
        alive = self._alive()
        if self.shared:
            # one pool serves the whole cluster: there is no routing
            # decision to make, so record the origin (round-robin for
            # origin-less requests) rather than reporting a degenerate
            # argmin-of-equal-loads that would pin metrics to server 0;
            # a crashed origin falls back to the live round-robin
            if req.origin is not None and alive[req.origin]:
                server = req.origin
            else:
                server = self._next_live_rr(alive)
            rtm = self.runtimes[0]
        else:
            loads = np.where(alive, self.loads(), np.inf)
            origin = (req.origin
                      if req.origin is not None and alive[req.origin]
                      else None)
            server = self.router.route(origin, loads)
            if not alive[server]:
                # a custom router ignored the inf load; never enqueue
                # onto a dead server
                server = int(np.argmin(loads))
            rtm = self.runtimes[server]
        if self.tag_origins:
            origin = (req.origin
                      if req.origin is not None and alive[req.origin]
                      else server)
        else:
            origin = None
        handle = rtm.enqueue(dataclasses.replace(req, origin=origin))
        handle.request = req      # keep the caller's origin for metrics
        handle.server = server
        return handle

    @property
    def pending(self) -> bool:
        return any(r.queue or r.active or r._pending
                   for r in self.runtimes)

    def step(self) -> bool:
        had = self.pending
        now = self.rounds + 1          # the tick this call serves
        if self.faults is not None:
            for ev in self.faults.due(now):
                self._apply_fault(ev, now)
        # residency BEFORE the round: this tick's dispatch rides the
        # incumbent tables even when the review below completes a staged
        # migration, so its bytes meter against the old links
        res_before = self._residency() if self.meter is not None else None
        for rtm in self.runtimes:
            rtm.step()
        self.rounds += 1
        ctrl = self.controller
        if ctrl is not None:
            dec = ctrl.review_and_apply(self.rounds, self.engine)
            if dec is not None and dec.applied:
                self.migrations.append(dec.diag)
        tm = self.tiers
        if tm is not None:
            landed = tm.promotions
            tm.poll(self.rounds)
            if (tm.promotions != landed and ctrl is not None
                    and ctrl.plan is not None):
                # promotions change which experts are GPU-resident: refresh
                # the engine's slot tables under the new tier priority
                ctrl._apply_plan(self.engine)
            tm.observe(self.engine.stats.counts, now=self.rounds)
            tm.prefetch_step(self.rounds)
        if self.meter is not None and res_before is not None:
            if res_before.shape == self.engine.stats.counts.shape:
                # engine.stats is the engine's own plain accumulator (the
                # meter needs true cumulative volumes, never a
                # user-supplied EMA-decayed tracker)
                self.meter.observe(self.engine.stats.counts, res_before)
                self._meter_ok += 1
                self._meter_skip_streak = 0
            else:
                # previously a silent pass: a persistently mismatched
                # residency view meant metrics()["net"] reported zero
                # dispatch bytes with no hint anything was wrong
                self.meter_skips += 1
                self._meter_skip_streak += 1
                if self._meter_ok == 0 and self._meter_skip_streak >= 32:
                    raise RuntimeError(
                        f"traffic metering skipped {self._meter_skip_streak}"
                        " consecutive ticks and never once succeeded: the "
                        f"residency view {res_before.shape} cannot match "
                        "the engine's activation counts "
                        f"{self.engine.stats.counts.shape} — the "
                        "controller's plan granularity does not fit this "
                        "engine (metrics()['net'] would silently read 0)")
        self._check_recovered()
        return had

    # -- fault injection / failover ------------------------------------
    def _apply_fault(self, ev, now: float) -> None:
        """Consume one due ``FaultEvent``: flip the shared link state,
        evict + re-route (or drop) the victims of a crash, and trigger
        the controller's fault review around the capacity change."""
        apply_fault(ev, self.topology, tracer=self.tracer, now=now)
        self.faults_injected += 1
        ctrl = self.controller
        data = ev.payload()
        if ev.kind == SERVER_DOWN:
            data.update(self._fail_server(ev.server, now))
            if self.tiers is not None:
                # the crash loses the server's host/disk tiers too; the
                # fault review below rebinds tiered residency on survivors
                self.tiers.drop_server(ev.server)
            if ctrl is not None and self.failover:
                dec = ctrl.fault_review_and_apply(now, self.engine,
                                                  cause="server-down")
                if dec.applied:
                    self.migrations.append(dec.diag)
        elif ev.kind == SERVER_JOINED:
            # capacity appeared: re-review (gated on no in-flight
            # migration — the next periodic review will expand otherwise)
            if ctrl is not None and self.failover and ctrl.pending is None:
                dec = ctrl.review(now, force=True)
                if dec.adopted and not dec.staged:
                    if ctrl._apply_plan(self.engine):
                        self.migrations.append(dec.diag)
        elif ev.kind == LINK_DEGRADED:
            # an in-flight migration priced on the old bandwidth has a
            # stale eta (or a dead link): abort and re-plan immediately
            if (ctrl is not None and ctrl.pending is not None
                    and ctrl.pending_affected()):
                dec = ctrl.fault_review_and_apply(now, self.engine,
                                                  cause="link-degraded")
                if dec.applied:
                    self.migrations.append(dec.diag)
        self.fault_events.append(
            Event(getattr(EventType, ev.kind), -1, now, data, self.seqc()))

    def _fail_server(self, server: int, now: float) -> dict:
        """Evict every request the crashed server was serving. With
        failover, victims re-route through the router (dead servers at
        inf load) and re-prefill from scratch under their original
        handles — cheap when the radix cache still holds their prefix
        pages elsewhere; without it they are dropped (the no-failover
        baseline). Returns the crash event's bookkeeping payload."""
        victims: list[tuple] = []      # (runtime, rid, handle)
        rtms = self.runtimes if self.shared else [self.runtimes[server]]
        for rtm in rtms:
            for rid, h in list(rtm.handles.items()):
                if h.done or h.server != server:
                    continue
                victims.append((rtm, rid, h))
        alive = self._alive()
        lost = 0
        reassigned: list[int] = []
        recovering: list[RequestHandle] = []
        for rtm, rid, h in victims:
            done_tokens = rtm.evict(rid)
            lost += done_tokens
            req = h.request
            if not self.failover:
                self.requests_dropped += 1
                lost += req.max_new_tokens - done_tokens   # never delivered
                continue
            loads = np.where(alive, self.loads(), np.inf)
            origin = (req.origin
                      if req.origin is not None and alive[req.origin]
                      else None)
            new_server = self.router.route(origin, loads)
            if not alive[new_server]:
                new_server = int(np.argmin(loads))
            h._tokens.clear()          # the stream restarts from scratch
            h.server = new_server
            tagged = new_server if self.tag_origins else None
            target = (self.runtimes[0] if self.shared
                      else self.runtimes[new_server])
            target.enqueue(dataclasses.replace(req, origin=tagged),
                           handle=h)
            h.request = req            # keep the caller's origin for metrics
            reassigned.append(new_server)
            recovering.append(h)
            if self.tracer.enabled:
                # h.rid is the fresh re-admit rid the victim's remaining
                # spans will carry on the surviving server
                self.tracer.instant(SpanKind.FAILOVER_REPREFILL, now,
                                    rid=h.rid, server=new_server,
                                    from_server=server,
                                    tokens_lost=done_tokens)
        self.tokens_lost += lost
        if recovering:
            self._recovering.append((now, recovering))
        return {"victims": len(victims), "tokens_lost": lost,
                "reassigned": reassigned, "failover": self.failover}

    def _check_recovered(self) -> None:
        """A crash counts as recovered once every re-routed victim has
        finished; the elapsed ticks are the crash's recovery time."""
        for rec in self._recovering[:]:
            t0, victims = rec
            if all(h.done for h in victims):
                self.faults_recovered += 1
                self.recovery_ticks += self.rounds - t0
                self._recovering.remove(rec)

    def faults_metrics(self) -> dict | None:
        """The ``metrics()["faults"]`` section (None without a schedule).
        ``recovery_seconds`` converts ticks via the controller's
        ``clock_rate`` (seconds per tick, default 1.0)."""
        if self.faults is None:
            return None
        rate = (self.controller.clock_rate
                if self.controller is not None else 1.0)
        return {"injected": self.faults_injected,
                "recovered": self.faults_recovered,
                "tokens_lost": int(self.tokens_lost),
                "recovery_seconds": round(self.recovery_ticks * rate, 6),
                "requests_dropped": self.requests_dropped,
                "failover": self.failover}

    def run(self) -> None:
        while self.pending:
            self.step()
        for rtm in self.runtimes:
            rtm.flush()

    def perf(self) -> dict:
        """Cluster-wide ``metrics.perf`` section: warmup cost and retrace/
        stall counters summed over the member runtimes, decode-round and
        TTFT wall-time percentiles pooled over every round they served."""
        rounds: list[float] = []
        ttft: list[float] = []
        for r in self.runtimes:
            rounds.extend(r.decode_round_s)
            ttft.extend(r.ttft_s)

        def pct(xs):
            if not xs:
                return {"p50": 0.0, "p99": 0.0}
            return {"p50": round(float(np.percentile(xs, 50)) * 1e3, 6),
                    "p99": round(float(np.percentile(xs, 99)) * 1e3, 6)}
        return {
            "warmup_seconds": round(sum(r.warmup_seconds
                                        for r in self.runtimes), 6),
            "executables_compiled": sum(r.executables_compiled
                                        for r in self.runtimes),
            "traces_after_warmup": sum(r.traces_after_warmup
                                       for r in self.runtimes),
            "host_syncs": sum(r.host_syncs for r in self.runtimes),
            "rounds_timed": sum(r.decode_round_s.count
                                for r in self.runtimes),
            "decode_round_ms": pct(rounds),
            "ttft_ms": pct(ttft),
        }

    def local_ratio(self) -> np.ndarray:
        """[N] observed local-compute ratio per origin server: activation
        mass that landed on experts resident at the origin, under the
        controller's active plan."""
        ctrl = self.controller
        if (not self.tag_origins or ctrl is None or ctrl.plan is None
                or self.engine.rt.ep_spec is None):
            return np.ones(self.n)
        counts = self.engine.stats.counts          # [L, n_ep, E]
        res = ctrl.plan.residency() > 0            # [L, N, E]
        if res.shape != counts.shape:
            return np.ones(self.n)
        out = np.ones(self.n)
        for s in range(self.n):
            tot = counts[:, s, :].sum()
            if tot > 0:
                out[s] = (counts[:, s, :] * res[:, s, :]).sum() / tot
        return out


class _SimBackend:
    """N edge servers over the event-driven time model (clock = seconds).

    Typed requests become simulator arrivals: ``len(prompt)`` prompt
    tokens, ``max_new_tokens`` decode tokens, ``task`` selecting the
    activation profile, ``arrival``/``origin`` the arrival process. The
    simulator models time, not tokens, so handles get ADMITTED/FINISHED
    events (with latency + locality metrics) but no TOKEN events.
    """
    clock = "seconds"

    def __init__(self, spec: ClusterSpec, profile: MoEProfile, plan,
                 controller, router, tasks: dict | None, seed: int,
                 ratio_bucket: float, topology: Topology | None = None,
                 fault_schedule: FaultSchedule | None = None,
                 failover: bool = True, prefetch: bool = True,
                 slo_aware: bool = False, tracer=None, seq=None):
        from repro_torch.data.traces import Workload     # numpy-only
        from repro_torch.serving.simulator import EdgeSimulator   # lazy: this
        #   module is imported by simulator.py (no import cycle at load)
        self.profile = profile
        self.seed = seed
        self.topology = topology
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.seqc = seq if seq is not None else SeqCounter()
        if controller is not None and getattr(controller, "tracer",
                                              None) is None:
            controller.tracer = self.tracer
        self.workload = Workload(requests=[], tasks=dict(tasks or {}),
                                 duration=0.0)
        self.sim = EdgeSimulator(spec, profile, self.workload, plan=plan,
                                 controller=controller, router=router,
                                 seed=seed, ratio_bucket=ratio_bucket,
                                 topology=topology)
        self.controller = controller
        # -- expert tier hierarchy (host-RAM / modeled disk) ------------
        self.tiers = None
        if (topology is not None and topology.tiered
                and controller is not None):
            from repro_torch.serving.tiers import TierManager
            eb = getattr(controller.cost, "expert_bytes", None)
            self.tiers = TierManager(
                topology, float(eb) if eb else profile.expert_bytes,
                prefetch=prefetch, clock_rate=1.0,   # seconds clock
                tracer=self.tracer)
            controller.tiers = self.tiers
            if controller.plan is not None:
                self.tiers.bind(controller.plan)
            self.sim.time_model.tiers = self.tiers   # fetch-stall pricing
        self.meter = (TrafficMeter(topology, profile.hidden_bytes_per_token)
                      if topology is not None else None)
        self.n = spec.n
        self._pending: list = []       # heap of (arrival, seq, sim_req, h)
        self._seq = 0
        self.faults = fault_schedule
        self.failover = failover
        # the no-failover baseline keeps serving survivors under the
        # pre-crash time model (dead residency unmasked): its cost is the
        # dropped requests, not an unserviceable-expert stall
        self.sim.mask_dead_residency = failover
        self.fault_events: list[Event] = []
        self.faults_injected = 0
        self.faults_recovered = 0      # crashes whose recovery plan landed
        self.tokens_lost = 0           # undelivered tokens of dropped reqs
        self.requests_dropped = 0
        self.recovery_seconds = 0.0    # crash -> recovery-migration eta
        # -- SLO-aware admission (the time model's slo_admission rule) --
        self.slo_aware = bool(slo_aware)
        self.sheds = 0                 # requests shed (no server in time)
        self.deadline_redirects = 0    # served elsewhere to make the SLO

    def _task_probs(self, name: str) -> None:
        from repro_torch.data.traces import make_task_profile
        if name not in self.workload.tasks:
            self.workload.tasks[name] = make_task_profile(
                name, self.profile.num_layers, self.profile.num_experts,
                seed=self.seed)

    def submit(self, req: Request) -> RequestHandle:
        from repro_torch.data.traces import Request as SimRequest
        if req.origin is not None and not 0 <= req.origin < self.n:
            # fail at the submit site, not as an IndexError mid-simulation
            raise ValueError(
                f"origin {req.origin} out of range for {self.n} server(s)")
        task = req.task if req.task is not None else "default"
        self._task_probs(task)
        arrival = float(req.arrival) if req.arrival is not None else 0.0
        # origin-less requests get their server at *serve* time (step()),
        # when the router can see the live timeline; -1 marks them here
        sim_req = SimRequest(arrival=arrival,
                             server=req.origin if req.origin is not None
                             else -1,
                             task=task, prompt_tokens=len(req.prompt),
                             decode_tokens=req.max_new_tokens)
        handle = RequestHandle(self._seq, req, clock="seconds",
                               seq=self.seqc)
        handle.submitted_at = arrival
        heapq.heappush(self._pending, (arrival, self._seq, sim_req, handle))
        self._seq += 1
        return handle

    @property
    def pending(self) -> bool:
        return bool(self._pending)

    def _alive(self) -> np.ndarray:
        if self.topology is None:
            return np.ones(self.n, bool)
        return np.asarray(self.topology.state.up, bool)

    def step(self) -> bool:
        """Serve the earliest pending arrival (event-driven: one request is
        one event). Faults due at or before the arrival are applied first,
        so a crash mid-workload re-routes (or drops) everything that
        arrives after it."""
        if not self._pending:
            return False
        self.sim.start()
        arrival, _, sim_req, handle = heapq.heappop(self._pending)
        if self.faults is not None:
            for ev in self.faults.due(arrival):
                self._apply_fault(ev, ev.time)
        ctrl = self.controller
        if (ctrl is not None and ctrl.pending is not None
                and self.sim.uncovered_live_experts()):
            # a crash left experts with no live replica: requests stall
            # until the recovery migration's transfers land (the modeled
            # analogue of re-prefilling after the failover re-placement)
            arrival = max(arrival, ctrl.pending.eta)
            self.sim.poll_migration(arrival)
            sim_req = dataclasses.replace(sim_req, arrival=arrival)
        # residency BEFORE this event: the request's dispatch is routed
        # under the incumbent plan even when serving it completes a staged
        # migration, so its bytes must meter against the old links
        res_before = (None if self.sim._res is None
                      else self.sim._res.copy())
        alive = self._alive()
        if sim_req.server >= 0 and not alive[sim_req.server]:
            if not self.failover:
                # no-failover baseline: the dead server's arrivals are
                # abandoned — every token they owed is lost
                self.requests_dropped += 1
                self.tokens_lost += sim_req.decode_tokens
                return True
            sim_req = dataclasses.replace(sim_req, server=-1)
        if sim_req.server < 0:
            # origin-less (or failed-over): the router assigns the server
            # against the live timeline, dead servers at inf load
            loads = np.where(alive, self.sim.loads(arrival), np.inf)
            n = self.sim.router.route(None, loads)
            if not alive[n]:
                n = int(np.argmin(loads))
            sim_req = dataclasses.replace(sim_req, server=n)
        slo = handle.request.slo
        # submit-time arrival, NOT the (possibly fault-fast-forwarded)
        # local `arrival`: the SLO verdict and the handle-facing latency
        # are measured on the backend clock the caller submitted on
        sub = (handle.submitted_at if handle.submitted_at is not None
               else arrival)
        if self.slo_aware and slo is not None:
            from repro_torch.serving.simulator import slo_admission
            deadline = sub + slo
            loads = np.where(alive, self.sim.loads(arrival), np.inf)
            verdict, n = slo_admission(sim_req.server, loads, deadline)
            if verdict == "shed":
                # no live server can even *start* by the deadline —
                # admitting would burn timeline another request could use
                self.sheds += 1
                if self.tracer.enabled:
                    self.tracer.span(SpanKind.QUEUE_WAIT, sub, arrival,
                                     rid=handle.rid, shed=True)
                    self.tracer.instant(
                        SpanKind.SHED, arrival, rid=handle.rid,
                        deadline=deadline,
                        earliest_start=float(loads.min()))
                handle._emit(EventType.SHED, arrival, deadline=deadline,
                             earliest_start=float(loads.min()))
                handle._emit(
                    EventType.FINISHED, arrival,
                    tokens=0, origin=handle.request.origin, server=None,
                    latency=arrival - sub, wait=None, deferred_ticks=0,
                    prefix_tokens_skipped=0, local_frac=None,
                    slo=slo, slo_met=False, shed=True)
                return True
            if verdict == "redirect":
                self.deadline_redirects += 1
                sim_req = dataclasses.replace(sim_req, server=n)
        rec = self.sim.serve_request(sim_req)
        handle._emit(EventType.ADMITTED, rec["start"], server=rec["server"])
        if self.tracer.enabled:
            # phase split mirroring workload._ttft_itl: the modeled
            # latency spreads uniformly over prompt + decode tokens, so
            # prefill covers the first prompt_tokens shares of service
            rid, srv = handle.rid, int(rec["server"])
            T = sim_req.prompt_tokens
            toks = sim_req.decode_tokens
            itl = max(rec["done"] - rec["start"], 0.0) / max(T + toks, 1)
            split = rec["start"] + itl * T
            self.tracer.span(SpanKind.QUEUE_WAIT, sub, rec["start"],
                             rid=rid, server=srv)
            self.tracer.span(SpanKind.PREFILL_CHUNK, rec["start"], split,
                             rid=rid, server=srv, prompt_tokens=T)
            self.tracer.span(SpanKind.DECODE_ROUND, split, rec["done"],
                             rid=rid, server=srv, tokens=toks)
        latency = rec["done"] - sub
        handle._emit(
            EventType.FINISHED, rec["done"],
            tokens=handle.request.max_new_tokens, origin=handle.request.origin,
            server=rec["server"], latency=latency,
            wait=rec["start"] - sub, deferred_ticks=0,
            prefix_tokens_skipped=0,
            local_frac=(rec["hits"] / rec["tot"] if rec["tot"] else None),
            slo=slo,
            slo_met=(bool(latency <= slo)
                     if slo is not None else None),
            shed=False)
        if self.meter is not None and res_before is not None:
            # _dispatch_counts, not the controller's (possibly EMA-decayed,
            # possibly pre-primed) ActivationStats: metering needs the true
            # cumulative per-origin volumes
            self.meter.observe(self.sim._dispatch_counts, res_before)
        if self.tiers is not None:
            done = rec["done"]
            self.tiers.poll(done)
            self.tiers.observe(self.sim._dispatch_counts, now=done)
            self.tiers.prefetch_step(done)
        return True

    def run(self) -> None:
        while self.step():
            pass

    # -- fault injection / failover ------------------------------------
    def _apply_fault(self, ev, now: float) -> None:
        """Consume one due ``FaultEvent``: flip the shared link state and
        trigger the controller's recovery response. The no-failover
        baseline skips the recovery (and the simulator keeps serving the
        survivors under the pre-crash time model — only the dead server's
        arrivals are lost)."""
        apply_fault(ev, self.topology, tracer=self.tracer, now=now)
        self.faults_injected += 1
        ctrl = self.controller
        data = ev.payload()
        data["failover"] = self.failover
        if ev.kind == SERVER_DOWN and self.failover and self.tiers is not None:
            # host/disk tiers die with the box (the crash-oblivious
            # no-failover baseline keeps its pre-crash model instead)
            self.tiers.drop_server(ev.server)
        if ev.kind == SERVER_DOWN and self.failover and ctrl is not None:
            dec = ctrl.fault_review(now, cause="server-down")
            self._note_decision(dec, now)
            if dec.staged:
                self.recovery_seconds += float(dec.diag["eta"]) - now
            if dec.adopted:
                self.faults_recovered += 1
        elif ev.kind == SERVER_JOINED and self.failover and ctrl is not None:
            if ctrl.pending is None:
                self._note_decision(ctrl.review(now, force=True), now)
        elif ev.kind == LINK_DEGRADED and ctrl is not None:
            if ctrl.pending is not None and ctrl.pending_affected():
                self._note_decision(
                    ctrl.fault_review(now, cause="link-degraded"), now)
        self.fault_events.append(
            Event(getattr(EventType, ev.kind), -1, now, data, self.seqc()))

    def _note_decision(self, dec, now: float) -> None:
        if not dec.adopted:
            return
        if dec.staged:
            self.sim._migrations.append({
                "time": now, "staged": True, "eta": dec.diag["eta"],
                "transfers": dec.diag["transfers"],
                "transfer_bytes": dec.diag["transfer_bytes"]})
        else:
            self.sim.adopt_plan(dec.plan)

    def faults_metrics(self) -> dict | None:
        if self.faults is None:
            return None
        return {"injected": self.faults_injected,
                "recovered": self.faults_recovered,
                "tokens_lost": int(self.tokens_lost),
                "recovery_seconds": round(self.recovery_seconds, 6),
                "requests_dropped": self.requests_dropped,
                "failover": self.failover}

    @property
    def migrations(self) -> list:
        self.sim.start()
        return self.sim._migrations

    def local_ratio(self) -> np.ndarray:
        return self.sim.local_ratio_by_server()

    def _expert_bytes(self) -> float:
        return self.profile.expert_bytes


class EdgeCluster:
    """Serving API v1 façade: N edge servers, one router, one shared
    placement control plane, two interchangeable backends.

    backend:        ``"runtime"`` (PyTorch engines, tick clock) or
                    ``"sim"`` (event-driven time model, seconds clock).
    n_servers:      cluster size (runtime backend: defaults to the engine's
                    EP rank count; sim backend: ``spec.n``).
    router:         ``repro_torch.serving.api.Router`` instance or name
                    (``"home"`` / ``"least-loaded"``); default home-server
                    routing (the paper's arrival semantics).
    controller:     the shared ``PlacementController`` (optional for the
                    runtime backend; the sim backend needs it or ``plan``).
    engine:         runtime backend — the ``ServingEngine`` the cluster
                    serves with.
    shared_runtime: runtime backend — one origin-tagged runtime (default)
                    vs one ``ServingRuntime`` (own KV pool/decode batch)
                    per server.
    runtime_opts:   runtime backend — kwargs forwarded to each
                    ``ServingRuntime`` (max_slots, block_size, ...;
                    ``warmup=True`` is not ported yet and raises);
                    ``metrics()["perf"]`` aggregates the members'
                    warmup/retrace/stall/latency counters (the warmup
                    figures stay 0 on the synchronous loop).
    spec/profile:   sim backend — ``ClusterSpec`` + ``MoEProfile``.
    plan:           sim backend — static ``PlacementPlan`` (alternative to
                    a controller).
    tasks:          sim backend — {name: TaskProfile} activation profiles
                    (unknown task names get a generated profile).
    topology:       optional ``repro_torch.serving.net.Topology`` — one shared
                    link-cost model for both backends: per-(src, dst)
                    dispatch byte metering (``metrics()["net"]``),
                    bandwidth-aware *staged* migration on the shared
                    controller, per-link comm pricing in the sim time
                    model, and (``shared_runtime=False``) per-server KV
                    pools sized by each ``ServerProfile``'s memory cap.
                    The sim backend can derive ``spec`` from it. Defaults
                    to the controller's topology when it carries one. The
                    runtime backend's tick clock converts modeled transfer
                    *seconds* via ``controller.clock_rate`` (seconds per
                    tick, default 1.0) — set it on the controller when a
                    decode round is far from one second.
    fault_schedule: optional ``repro_torch.serving.faults.FaultSchedule`` —
                    deterministic timed server crashes / rejoins and link
                    degradations, consumed from the backend's own clock
                    (requires ``topology=``: faults mutate its shared
                    ``LinkState``). ``metrics()["faults"]`` reports
                    injected/recovered counts, tokens lost and recovery
                    time; ``events`` carries one record per consumed
                    fault. Two runs of the same schedule (``.copy()`` it —
                    consumption advances a cursor) are bit-identical.
    failover:       fault response (default True): a crashed server's
                    in-flight requests re-route through the router and
                    re-prefill under their original handles, and the
                    controller force-reviews placement around the lost
                    capacity. ``failover=False`` is the measurement
                    baseline — victims are dropped and every token they
                    owed counts as lost.
    slo_aware:      SLO-aware scheduling (default False). Runtime backend:
                    every member ``ServingRuntime`` admits
                    earliest-deadline-first instead of FIFO and *sheds*
                    requests whose ``slo`` deadline became unmeetable
                    (``SHED`` event, then a terminal
                    ``FINISHED(tokens=0, shed=True, slo_met=False)``).
                    Sim backend: the time model's ``slo_admission`` rule —
                    shed when no live server can start by the deadline,
                    redirect to the earliest-start server when the routed
                    one would start too late. Off by default: the
                    scheduling-oblivious FIFO baseline the goodput
                    benchmark compares against.
    prefetch:       expert-tier prefetching (default True). When the
                    topology carries tiered ``ServerProfile``s (host-RAM /
                    modeled-disk capacities behind the GPU) and a
                    controller is attached, a ``repro_torch.serving.tiers
                    .TierManager`` splits each server's assigned experts
                    across its tiers and — with ``prefetch=True`` —
                    promotes hot back-tier experts into GPU residency
                    overlapped with decode. ``prefetch=False`` freezes the
                    bind-time split (cold experts keep paying on-demand
                    fetch stalls — the baseline leg of the oversized-model
                    benchmark). Surfaced as ``metrics()["tiers"]``.
    trace:          unified span tracing (default False — a no-op
                    ``NULL_TRACER``; the serving hot path pays one
                    attribute check). ``trace=True`` builds a
                    ``repro_torch.serving.obs.Tracer`` on the backend's clock
                    and threads it through every emitter: per-request
                    spans (QUEUE_WAIT / PREFILL_CHUNK / DECODE_ROUND /
                    PREFIX_HIT / SHED / FAILOVER_REPREFILL /
                    COLD_FETCH_STALL), control-plane PLACEMENT_REVIEW
                    decisions with the full Eq.-4 cost breakdown,
                    per-link TRANSFER_TASK spans, FAULT consumptions and
                    tier PREFETCH promotions. Export with
                    ``export_trace(path)`` (Chrome-trace/Perfetto JSON);
                    self-accounting in ``metrics()["obs"]``. A
                    pre-built ``Tracer`` is accepted (its clock must
                    match the backend).
    """

    def __init__(self, backend: str = "runtime", *,
                 n_servers: int | None = None, router=None, controller=None,
                 engine=None, shared_runtime: bool = True,
                 runtime_opts: dict | None = None,
                 spec: ClusterSpec | None = None,
                 profile: MoEProfile | None = None, plan=None,
                 tasks: dict | None = None, seed: int = 0,
                 ratio_bucket: float = 60.0,
                 topology: Topology | None = None,
                 fault_schedule: FaultSchedule | None = None,
                 failover: bool = True, prefetch: bool = True,
                 slo_aware: bool = False, trace=False):
        router = as_router(router)
        # one cluster-wide event sequencer + span tracer, threaded through
        # every emitter (member runtimes / the simulator, the fault
        # injector, the controller, tiers), so merged streams have a
        # stable total order and one trace covers the whole cluster.
        # trace= takes False (default, the zero-overhead NULL_TRACER),
        # True (build a Tracer on the backend's clock) or a Tracer.
        self.seq = SeqCounter()
        self.tracer = as_tracer(
            trace, "ticks" if backend == "runtime" else "seconds")
        if controller is not None:
            topology = controller.attach_topology(topology)   # one shared
            #   link model between the cluster and the control plane
        if fault_schedule is not None and topology is None:
            # liveness/bandwidth state lives on the shared Topology; a
            # schedule without one would silently do nothing
            raise ValueError(
                "fault_schedule= needs a topology= (the faults mutate the "
                "shared Topology's LinkState)")
        if backend == "runtime":
            if engine is None:
                raise ValueError("runtime backend needs engine=")
            if n_servers is None:
                n_servers = (engine.rt.ep_spec.n_ep
                             if engine.rt.ep_spec is not None else 1)
            if topology is not None and topology.n != n_servers:
                raise ValueError(
                    f"topology has {topology.n} servers, cluster has "
                    f"{n_servers}")
            self.backend = _RuntimeBackend(engine, n_servers, router,
                                           controller, shared_runtime,
                                           dict(runtime_opts or {}),
                                           topology=topology,
                                           fault_schedule=fault_schedule,
                                           failover=failover,
                                           prefetch=prefetch,
                                           slo_aware=slo_aware,
                                           tracer=self.tracer,
                                           seq=self.seq)
        elif backend == "sim":
            if spec is None and topology is not None:
                spec = topology.to_cluster_spec()
            if spec is None or profile is None:
                raise ValueError(
                    "sim backend needs spec= (or topology=) and profile=")
            if n_servers is not None and n_servers != spec.n:
                raise ValueError(
                    f"n_servers={n_servers} != spec.n={spec.n}")
            if topology is not None and topology.n != spec.n:
                raise ValueError(
                    f"topology has {topology.n} servers, spec has {spec.n}")
            n_servers = spec.n
            self.backend = _SimBackend(spec, profile, plan, controller,
                                       router, tasks, seed, ratio_bucket,
                                       topology=topology,
                                       fault_schedule=fault_schedule,
                                       failover=failover,
                                       prefetch=prefetch,
                                       slo_aware=slo_aware,
                                       tracer=self.tracer,
                                       seq=self.seq)
        else:
            raise ValueError(
                f"unknown backend {backend!r}: expected 'runtime' or 'sim'")
        self.backend_name = backend
        self.n_servers = n_servers
        self.controller = controller
        self.topology = topology
        self.handles: list[RequestHandle] = []
        # controller decision records are drained into seq-stamped cluster
        # Events eagerly (each step) so the merged event stream keeps one
        # stable total order under (time, seq)
        self._ctrl_cursor = 0
        self._cluster_events: list[Event] = []
        # metrics() is assembled from one namespaced registry instead of
        # hand-merged dicts; a provider returning None drops its section
        self.registry = Registry()
        self.registry.register("cluster", self._cluster_metrics)
        self.registry.register(
            "perf", getattr(self.backend, "perf", None) or (lambda: None))
        self.registry.register("net", self._net_metrics)
        self.registry.register("tiers", self._tiers_metrics)
        self.registry.register("faults", self._faults_metrics)
        self.registry.register("obs", self._obs_metrics)

    # -- the portable surface ------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        """Route a typed ``Request`` to a server and enqueue it; returns
        its ``RequestHandle`` (events, tokens, per-request metrics)."""
        h = self.backend.submit(request)
        self.handles.append(h)
        return h

    def step(self) -> bool:
        """Advance the cluster one unit of its backend clock."""
        more = self.backend.step()
        self._drain_ctrl_events()
        return more

    def run(self) -> list[RequestHandle]:
        """Serve until every submitted request finished; returns all
        handles in submission order."""
        self.backend.run()
        self._drain_ctrl_events()
        return self.handles

    def export_trace(self, path: str) -> str:
        """Write this run's span trace as Chrome-trace/Perfetto JSON
        (requires ``trace=``); returns ``path``. Deterministic: two runs
        of the same inputs (``.copy()`` the fault schedule) produce
        byte-identical files."""
        return self.tracer.export(path)

    @property
    def migrations(self) -> list:
        """Adopted-plan records from the shared controller, oldest first
        (each: the review time on the backend clock plus the Eq.-4 diag)."""
        return self.backend.migrations

    @property
    def events(self) -> list[Event]:
        """Cluster-level structured events (``rid = -1``) in clock order:
        the staged migration lifecycle of the shared control plane —
        ``MIGRATION_STARTED`` when a review adopts a plan and schedules
        its transfers, ``MIGRATION_COMPLETED`` when the transfers finish,
        ``MIGRATION_ABORTED`` when a fault invalidated them in flight —
        merged with the consumed fault-injection events
        (``SERVER_DOWN``/``SERVER_JOINED``/``LINK_DEGRADED``/
        ``LINK_RESTORED``, payload: the fault fields plus the failover
        bookkeeping — victims, tokens lost, reassignments).

        Ordering contract: every event carries the cluster-wide monotonic
        ``seq`` stamp, and the merged list is sorted by ``(time, seq)`` —
        a *stable total order* that is identical on a deterministic
        rerun, even when control-plane and fault events coincide in
        time."""
        self._drain_ctrl_events()
        out = list(self._cluster_events)
        out.extend(getattr(self.backend, "fault_events", []))
        out.sort(key=lambda e: (e.time, e.seq))
        return out

    def _drain_ctrl_events(self) -> None:
        """Convert controller decision records appended since the last
        drain into cluster ``Event``s, stamping the cluster-wide sequence
        number. Plain reviews (no adoption) are skipped — they stay
        visible in ``controller.events`` and the trace."""
        ctrl = self.controller
        if ctrl is None:
            return
        recs = ctrl.events
        while self._ctrl_cursor < len(recs):
            e = recs[self._ctrl_cursor]
            self._ctrl_cursor += 1
            if e.get("staged"):
                t = EventType.MIGRATION_STARTED
            elif e.get("reason") == "migration-complete":
                t = EventType.MIGRATION_COMPLETED
            elif e.get("reason") == "migration-aborted":
                t = EventType.MIGRATION_ABORTED
            else:
                continue
            self._cluster_events.append(
                Event(t, -1, e["time"], dict(e), self.seq()))

    def _net_metrics(self) -> dict | None:
        """The ``metrics()["net"]`` payload: per-link dispatch bytes from
        the traffic meter, staged-migration totals from the controller's
        event log, and the heterogeneous per-server budget caps."""
        meter = getattr(self.backend, "meter", None)
        if meter is None:
            return None
        out = meter.summary()
        # observe() calls skipped on a residency/counts shape mismatch
        # (runtime backend; persistent mismatch raises in step())
        out["meter_skips"] = int(getattr(self.backend, "meter_skips", 0))
        eb = self.backend._expert_bytes()
        out["per_server_mem_gb"] = [
            round(p.mem_bytes / 1e9, 3) for p in self.topology.profiles]
        out["per_server_expert_budget"] = [
            int(b) for b in self.topology.expert_budgets(eb)]
        ctrl_events = (self.controller.events
                       if self.controller is not None else [])
        staged = [e for e in ctrl_events if e.get("staged")]
        comp = [e for e in ctrl_events
                if e.get("reason") == "migration-complete"]
        out["migrations"] = {
            "staged": len(staged),
            "completed": len(comp),
            "transfer_seconds": round(
                sum(e["transfer_seconds"] for e in comp), 6),
            "transfer_bytes": round(
                sum(e["transfer_bytes"] for e in comp), 3),
        }
        return out

    def _tiers_metrics(self) -> dict | None:
        """``metrics()["tiers"]``: per-server per-tier residency,
        promotion/demotion counts, prefetch-hit ratio and on-demand-fetch
        stalls (None without a tier hierarchy)."""
        tm = getattr(self.backend, "tiers", None)
        return tm.summary() if tm is not None else None

    def _faults_metrics(self) -> dict | None:
        """``metrics()["faults"]``: injected/recovered counts, tokens
        lost and recovery time (None without a fault schedule)."""
        fm = getattr(self.backend, "faults_metrics", None)
        return fm() if fm is not None else None

    def _obs_metrics(self) -> dict | None:
        """``metrics()["obs"]``: tracer self-accounting — span counts by
        kind, dropped-event count and recording overhead (None when
        tracing is off)."""
        return self.tracer.summary() if self.tracer.enabled else None

    def _cluster_metrics(self) -> dict:
        """The registry's ``cluster`` namespace: the backend-agnostic
        per-server serving metrics (splatted at the top level of
        ``metrics()`` for compatibility)."""
        N = self.n_servers
        submitted = np.zeros(N, int)
        served = np.zeros(N, int)
        finished = np.zeros(N, int)
        redirected = np.zeros(N, int)
        lat_sum = np.zeros(N)
        lat_n = np.zeros(N, int)
        for h in self.handles:
            o = h.request.origin
            s = h.server if h.server is not None else (o if o is not None
                                                       else 0)
            oo = o if o is not None else s
            submitted[oo] += 1
            served[s] += 1
            if o is not None and s != o:
                redirected[oo] += 1
            if h.done:
                finished[s] += 1
                if h.metrics.get("shed"):
                    # shed requests resolve without service: their
                    # (near-zero) latency is not a serving latency
                    continue
                lat = h.metrics.get("latency")
                if lat is not None:
                    lat_sum[oo] += lat
                    lat_n[oo] += 1
        mean_lat = np.where(lat_n > 0, lat_sum / np.maximum(lat_n, 1), 0.0)
        out = {
            "backend": self.backend_name,
            "clock": self.backend.clock,
            "n_servers": N,
            "per_server": {
                "submitted": submitted.tolist(),
                "served": served.tolist(),
                "finished": finished.tolist(),
                "redirected": redirected.tolist(),
                "mean_latency": [round(float(v), 6) for v in mean_lat],
                "local_ratio": [round(float(v), 6)
                                for v in self.backend.local_ratio()],
            },
            "redirected_total": int(redirected.sum()),
            "sheds": int(getattr(self.backend, "sheds", 0)),
        }
        return out

    def metrics(self) -> dict:
        """Per-server serving metrics in one backend-agnostic shape:
        submitted/served/finished/redirected request counts, mean latency
        by origin (backend clock units) and the local-compute ratio.
        Assembled from ``self.registry`` (one namespaced provider tree —
        ``cluster``/``perf``/``net``/``tiers``/``faults``/``obs``); the
        ``cluster`` namespace is splatted at the top level, providers
        returning None drop their section. With a topology attached the
        ``net`` section adds per-link dispatch bytes, staged-migration
        totals and per-server budget caps; ``trace=`` adds ``obs``."""
        tree = self.registry.collect()
        out = tree.pop("cluster")
        out.update(tree)
        return out


def requests_from_workload(workload) -> list[Request]:
    """Convert a ``repro_torch.data.traces.Workload`` into the equivalent typed
    API request stream (synthetic prompts of the right length — the sim
    backend models time from token *counts*). Pass ``tasks=workload.tasks``
    to ``EdgeCluster`` so the activation profiles carry over too."""
    return [Request(prompt=np.zeros(max(r.prompt_tokens, 1), np.int32),
                    max_new_tokens=r.decode_tokens, origin=r.server,
                    arrival=r.arrival, task=r.task)
            for r in workload.requests]
