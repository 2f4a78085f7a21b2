"""Event-driven multi-server MoE inference simulator (paper Sec. IV).

Decomposed into the paper's five components, each a small class that can be
reused or swapped independently:

  1. ``ArrivalSource``      — prompt sequence generator (Poisson arrivals +
     token volumes, from ``repro_torch.data.traces``).
  2. request routing        — per-layer expert activations sampled from the
     request's task profile (``TimeModel.sample_layer_counts``) + server
     selection via the serving API's pluggable routers
     (``repro_torch.serving.api.HomeRouter`` / ``LeastLoadedRouter`` — the same
     objects the runtime-backed ``EdgeCluster`` uses; the simulator-local
     ``Router`` class survives only as a ``DeprecationWarning`` shim).
  3. ``TimeModel``          — linear comm/comp estimator from the cluster
     spec (bandwidth, RTT, FLOP rates, IO speed).
  4. Eq.-1 time stamps      — a layer completes when its slowest expert
     invocation returns (``TimeModel.collab_layer``), on top of the
     dense-path time.
  5. ``Timeline``           — per-server FIFO occupancy plus asynchronous
     remote-compute load on target servers; migration adds per-server
     weight-loading pauses (Eq. 3) — unless a ``repro_torch.serving.net
     .Topology`` is attached, in which case remote invocations price
     their actual (origin -> replica) link and adopted plans migrate via
     the bandwidth-aware *staged* executor (transfers scheduled over the
     modeled links, overlapped with serving; the plan switches only when
     they complete).

Placement and migration run through the unified control plane
(``repro_torch.core.policies.PlacementController``): the simulator feeds it
per-request activation counts and asks it to review periodically — exactly
the calls the serving runtime makes, so policy/controller behaviour is
identical in both worlds. A static ``PlacementPlan`` or the legacy
``MigrationController`` shim are still accepted.

Also implements the paper's Table-I baselines: single-server memory
offloading ("MoE-Infinity"-style), with and without request redirection.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core.migration import MigrationController
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.policies import PlacementController
from repro_torch.core.stats import ActivationStats
from repro_torch.data.traces import Request, Workload
from repro_torch.serving.api import HomeRouter, LeastLoadedRouter, as_router
from repro_torch.serving.cluster import ClusterSpec, MoEProfile


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArrivalSource:
    """Component 1: yields requests in arrival order.

    Accepts a materialized ``Workload`` or any iterable of requests in
    arrival order — a streaming generator (e.g.
    ``repro_torch.serving.workload.WorkloadStream``) is consumed lazily, so a
    million-request scenario never exists in memory at once."""

    workload: "Workload | object"

    def __iter__(self):
        reqs = getattr(self.workload, "requests", self.workload)
        return iter(reqs)


def slo_admission(server: int, loads: np.ndarray, deadline: float) -> tuple[str, int]:
    """The time model's SLO-aware admission rule, shared with the cluster
    sim backend (``EdgeCluster(slo_aware=True)``).

    ``loads`` is the [N] earliest-start estimate (``EdgeSimulator.loads``:
    ``max(timeline.free, arrival)``, ``inf`` for dead servers); ``server``
    the router's choice. Returns one of

    * ``("serve", server)`` — the chosen server can start by the deadline;
    * ``("redirect", n)`` — it cannot, but the earliest-start server ``n``
      can: serve there instead (deadline-aware deferral, the seconds-clock
      analogue of the runtime's deadline-ordered queue);
    * ``("shed", -1)`` — no live server can start by the deadline: the
      request is doomed and admitting it would only delay others.
    """
    best = int(np.argmin(loads))
    if float(loads[best]) > deadline:
        return ("shed", -1)
    if 0 <= server < len(loads) and float(loads[server]) <= deadline:
        return ("serve", server)
    return ("redirect", best)


@dataclasses.dataclass
class Timeline:
    """Component 5: per-server occupancy. ``free[n]`` is the time server n
    finishes its current FIFO backlog; remote expert calls add asynchronous
    compute load to their target server."""

    free: np.ndarray  # [N]

    @staticmethod
    def create(n: int) -> "Timeline":
        return Timeline(free=np.zeros(n))

    def start_time(self, server: int, arrival: float) -> float:
        return max(arrival, float(self.free[server]))

    def occupy(self, server: int, until: float) -> None:
        self.free[server] = until

    def add_async(self, targets: np.ndarray, comp: np.ndarray) -> None:
        np.add.at(self.free, targets, comp)

    def pause(self, delays: np.ndarray) -> None:
        """Stall every server (Eq.-3 weight loading)."""
        self.free += delays


@dataclasses.dataclass
class Router:
    """DEPRECATED simulator-local router — the routing policies now live in
    ``repro_torch.serving.api`` (``HomeRouter`` / ``LeastLoadedRouter``) so the
    runtime-backed ``EdgeCluster`` and the simulator share them. This shim
    keeps the old ``route(req, timeline)`` signature."""

    redirect: bool = False

    def __post_init__(self):
        warnings.warn(
            "serving.simulator.Router is deprecated: use "
            "repro_torch.serving.api.HomeRouter / LeastLoadedRouter (or pass "
            "router= to EdgeSimulator / EdgeCluster)",
            DeprecationWarning,
            stacklevel=3,
        )

    def route(self, req: Request, timeline: Timeline) -> int:
        loads = np.maximum(timeline.free, req.arrival)
        if self.redirect:
            return LeastLoadedRouter().route(req.server, loads)
        return HomeRouter().route(req.server, loads)


class TimeModel:
    """Components 3 + 4: the linear per-token-batch comm/comp estimator and
    the Eq.-1 per-layer completion semantics.

    ``topology`` (a ``repro_torch.serving.net.Topology``) replaces the uniform
    ``cluster.bandwidth``/``rtt`` interconnect with per-link costs: remote
    expert invocations price the actual (origin -> replica) link and the
    replica choice minimizes earliest completion (queue + link), so a slow
    WAN-ish link is avoided when a nearer replica exists. Without it the
    legacy uniform model is bit-identical to before."""

    def __init__(self, cluster: ClusterSpec, profile: MoEProfile, topology=None):
        self.cluster, self.profile = cluster, profile
        self.topology = topology
        self.speeds = np.array([s.compute_speed for s in cluster.servers])
        self.io = np.array([s.io_speed for s in cluster.servers])
        # optional repro_torch.serving.tiers.TierManager: experts parked in a
        # back tier pay a modeled host/disk fetch stall (locally and as a
        # surcharge on remote candidates). None = flat GPU pricing,
        # bit-identical to the pre-tier model.
        self.tiers = None

    def sample_layer_counts(self, rng, probs, tokens: int) -> np.ndarray:
        """Component 2: per-layer expert activations for one request."""
        return rng.multinomial(tokens * self.profile.top_k, probs)  # [L, E]

    def dense_time(self, tokens: int, server: int) -> float:
        return tokens * self.profile.dense_flops_per_token / self.speeds[server]

    def _tier_table(self, layer: int | None) -> np.ndarray | None:
        """[N, E] tier assignment for this layer, or None when no
        TierManager is attached (flat pricing)."""
        tm = self.tiers
        if tm is None or layer is None or tm.tier is None or layer >= tm.tier.shape[0]:
            return None
        return tm.tier[layer]

    def collab_layer(
        self,
        counts: np.ndarray,
        res_l: np.ndarray,
        server: int,
        timeline: Timeline,
        layer: int | None = None,
    ) -> tuple[float, float, float]:
        """Eq. 1 for one layer under a placement residency ``res_l``
        [N, E]: local experts compute at the home server; remote experts go
        to the nearest-idle replica (comm + comp, async load on the
        target). With a :class:`~repro_torch.serving.tiers.TierManager` attached
        (``layer=`` identifies the row of its tier table), an expert a
        server holds only in a back tier pays that tier's on-demand fetch
        stall before computing — locally and, as a surcharge, on remote
        replica candidates. Returns (layer time, local hits, total
        activations)."""
        pf = self.profile
        tier_l = self._tier_table(layer)
        active = counts > 0
        local = active & (res_l[server] > 0)
        remote = active & ~local
        comp_b = counts * pf.expert_flops_per_token
        worst = (
            float((comp_b * local).max() / self.speeds[server]) if local.any() else 0.0
        )
        if tier_l is not None and local.any():
            back = local & (tier_l[server] > 0)
            if back.any():
                if tier_l[server][back].max() > 1:
                    stall = self.topology.disk_fetch_seconds(server, pf.expert_bytes)
                else:
                    stall = self.topology.host_fetch_seconds(server, pf.expert_bytes)
                worst = max(
                    worst, float(comp_b[back].max() / self.speeds[server]) + stall
                )
        hits = float(counts[local].sum())
        tot = float(counts[active].sum())
        if remote.any():
            free_m = np.where(
                res_l.T[remote] > 0, timeline.free[None], np.inf
            )  # [R, N]
            if self.topology is not None:
                # per-link pricing: candidate replica n costs its queue
                # plus the (server -> n) dispatch and the (n -> server)
                # return for this batch — each leg at its own link (they
                # differ on asymmetric topologies)
                per_tok = (
                    pf.hidden_bytes_per_token / self.topology.bandwidth[server]
                    + pf.hidden_bytes_per_token / self.topology.bandwidth[:, server]
                )  # [N]
                lat2 = (
                    self.topology.latency[server] + self.topology.latency[:, server]
                )  # [N]
                comm_m = (
                    counts[remote][:, None] * per_tok[None, :] + lat2[None, :]
                )  # [R, N]
                if tier_l is not None:
                    # a candidate holding the expert only in a back tier
                    # must fetch it first — surcharge its column
                    t_re = tier_l.T[remote]  # [R, N]
                    fetch_n = np.array(
                        [
                            self.topology.host_fetch_seconds(i, pf.expert_bytes)
                            for i in range(res_l.shape[0])
                        ]
                    )
                    disk_n = np.array(
                        [
                            self.topology.disk_fetch_seconds(i, pf.expert_bytes)
                            for i in range(res_l.shape[0])
                        ]
                    )
                    comm_m = comm_m + np.where(
                        t_re == 1,
                        fetch_n[None, :],
                        np.where(t_re == 2, disk_n[None, :], 0.0),
                    )
                tgt = np.argmin(free_m + comm_m, axis=-1)
                comm = comm_m[np.arange(len(tgt)), tgt]
            else:
                tgt = np.argmin(free_m, axis=-1)
                comm = (
                    2 * counts[remote] * pf.hidden_bytes_per_token
                    / self.cluster.bandwidth
                    + self.cluster.rtt
                )
            comp = comp_b[remote] / self.speeds[tgt]
            timeline.add_async(tgt, comp)  # async load
            worst = max(worst, float((comm + comp).max()))
        return worst, hits, tot

    def offload_service(
        self, layer_counts: np.ndarray, server: int, cache_mask_n: np.ndarray
    ) -> tuple[float, float, float]:
        """Single-server offloading: cached experts compute locally, misses
        load weights from host RAM (MoE-Infinity baseline)."""
        pf = self.profile
        comp = layer_counts * pf.expert_flops_per_token / self.speeds[server]
        miss = (layer_counts > 0) & ~cache_mask_n
        t_le = comp + miss * (pf.expert_bytes / self.io[server])
        service = t_le.max(-1).sum()
        hits = float((layer_counts * cache_mask_n).sum())
        tot = float(layer_counts.sum())
        return service, hits, tot

    def migration_pause(
        self, old_res: np.ndarray, new_res: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Eq. 3: per-server stall for newly placed expert weights.
        Returns (delays [N] seconds, experts added per server [N])."""
        added = np.maximum(new_res - old_res, 0).sum(0).sum(-1)  # [N]
        return added * self.profile.expert_bytes / self.io, added


@dataclasses.dataclass
class LocalRatioTracker:
    """Bucketed local-compute-ratio time series."""

    bucket: float
    samples: list = dataclasses.field(default_factory=list)
    hits: float = 0.0
    tot: float = 0.0
    next_bucket: float = dataclasses.field(init=False)

    def __post_init__(self):
        self.next_bucket = self.bucket

    def add(self, hits: float, tot: float) -> None:
        self.hits += hits
        self.tot += tot

    def roll(self, now: float) -> None:
        while now >= self.next_bucket:
            self.samples.append((self.next_bucket, self.hits / max(self.tot, 1.0)))
            self.hits = self.tot = 0.0
            self.next_bucket += self.bucket

    def flush(self) -> None:
        """Emit the trailing partial bucket (previously dropped)."""
        if self.tot > 0:
            self.samples.append((self.next_bucket, self.hits / max(self.tot, 1.0)))
            self.hits = self.tot = 0.0


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    latencies: np.ndarray  # per request
    servers: np.ndarray  # per request (arrival/home server)
    finish_times: np.ndarray
    local_ratio_t: list  # (time, ratio) samples
    migrations: list  # diagnostics dicts
    stats: ActivationStats
    routed: np.ndarray | None = None  # per request: serving server
    hits_by_server: np.ndarray | None = None  # [N] local activations served
    tot_by_server: np.ndarray | None = None  # [N] total activations served

    def avg_latency_per_server(self, n: int) -> np.ndarray:
        return np.array(
            [
                self.latencies[self.servers == i].mean()
                if (self.servers == i).any()
                else 0.0
                for i in range(n)
            ]
        )

    @property
    def avg_latency(self) -> float:
        return float(self.latencies.mean())


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

class EdgeSimulator:
    def __init__(
        self,
        cluster: ClusterSpec,
        profile: MoEProfile,
        workload: Workload,
        plan: PlacementPlan | None = None,
        controller=None,
        mode: str = "collab",
        redirect: bool = False,
        seed: int = 0,
        ratio_bucket: float = 60.0,
        router=None,
        topology=None,
    ):
        """mode: 'collab' (distributed expert calls under `plan`) or
        'offload' (each server caches its own top experts; misses load
        weights from host RAM — the MoE-Infinity-style baseline).
        controller: a ``PlacementController`` (or the deprecated
        ``MigrationController`` shim).
        redirect: route each request to the least-loaded server first
        (sugar for ``router=LeastLoadedRouter()``).
        router: a ``repro_torch.serving.api.Router`` (overrides ``redirect``).
        topology: optional ``repro_torch.serving.net.Topology`` — per-link
        comm costs in the time model and bandwidth-aware *staged*
        migration (an adopted plan activates only after its modeled
        transfers finish, replacing the instantaneous Eq.-3 pause).
        Defaults to the controller's topology when it has one."""
        assert mode in ("collab", "offload")
        if mode == "collab" and plan is None and controller is None:
            raise ValueError("collab mode needs a plan or a controller")
        self.cluster, self.profile, self.workload = cluster, profile, workload
        self.plan = plan
        self.controller = self._unwrap(controller)
        if self.controller is not None:
            # one shared link model; the profile knows m_e for transfers
            topology = self.controller.attach_topology(
                topology, expert_bytes=profile.expert_bytes
            )
        self.topology = topology
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.source = ArrivalSource(workload)
        self.router = (
            as_router(router)
            if router is not None
            else LeastLoadedRouter()
            if redirect
            else HomeRouter()
        )
        self.time_model = TimeModel(cluster, profile, topology=topology)
        self.ratio_bucket = ratio_bucket
        self._started = False
        # fault model: with a topology attached, crashed servers (its
        # LinkState's ``up`` flags) are dropped from the serving residency
        # so their experts stop being dispatch targets. The no-failover
        # measurement baseline turns this off — it models a cluster
        # oblivious to the crash (see EdgeCluster ``failover=``).
        self.mask_dead_residency = True

    @staticmethod
    def _unwrap(controller) -> PlacementController | None:
        if controller is None:
            return None
        if isinstance(controller, MigrationController):
            return controller.ctrl
        return controller

    # ------------------------------------------------------------------
    def _offload_caches(self) -> list[list[set]]:
        """Per-server per-layer cached expert sets for offload mode (each
        server keeps its own most-frequent experts, split evenly across
        layers)."""
        cl, pf = self.cluster, self.profile
        exp_freq = self.workload.freqs_by_server(cl.n)  # [L, N, E]
        cap = cl.expert_capacity(pf.expert_bytes)
        per_layer = np.maximum(cap // pf.num_layers, 1)
        caches = []
        for n in range(cl.n):
            layers = []
            for l in range(pf.num_layers):
                k = min(int(per_layer[n]), pf.num_experts)
                layers.append(set(np.argsort(-exp_freq[l, n])[:k]))
            caches.append(layers)
        return caches

    # ------------------------------------------------------------------
    # Incremental core: ``start()`` -> ``serve_request()`` per request (in
    # arrival order) -> ``finish()``. ``run()`` composes them over the
    # workload; the EdgeCluster "sim" backend drives them request-by-
    # request from the typed serving API instead.
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Initialize the mutable run state (timeline, trackers, initial
        placement review, offload caches). Idempotent per run."""
        if self._started:
            return
        cl, pf = self.cluster, self.profile
        N, L, E = cl.n, pf.num_layers, pf.num_experts
        self._timeline = Timeline.create(N)
        self._ratio = LocalRatioTracker(self.ratio_bucket)
        ctrl = self.controller
        if ctrl is not None and ctrl.stats is None:
            ctrl.stats = ActivationStats(L, N, E)
        self._stats = ctrl.stats if ctrl is not None else ActivationStats(L, N, E)
        self._plan = self.plan
        if ctrl is not None:
            self._plan = ctrl.review(0.0).plan  # initial placement
        self._res = (
            self._plan.residency() if self._plan is not None else None
        )  # [L, N, E]
        if self.mode == "offload":
            caches = self._offload_caches()
            self._cache_mask = np.zeros((N, L, E), bool)
            for n in range(N):
                for l in range(L):
                    self._cache_mask[n, l, list(caches[n][l])] = True
        self._latencies: list = []
        self._servers: list = []
        self._routed: list = []
        self._finishes: list = []
        self._migrations: list = []
        self._hits_by_server = np.zeros(N)
        self._tot_by_server = np.zeros(N)
        # plain cumulative per-origin activation counts for the traffic
        # meter — deliberately NOT the controller's ActivationStats, which
        # may be EMA-decayed (metering needs true volumes, and must not
        # count pre-primed historical stats as dispatched traffic)
        self._dispatch_counts = np.zeros((L, N, E))
        self._started = True

    def serve_request(self, r: Request) -> dict:
        """Serve one request (callers must present requests in arrival
        order). Returns its timing/locality record — the payload the
        EdgeCluster sim backend turns into ADMITTED/FINISHED events."""
        self.start()
        cl, pf, tm = self.cluster, self.profile, self.time_model
        L = pf.num_layers
        timeline, ratio, ctrl = self._timeline, self._ratio, self.controller
        n = self.router.route(r.server, self.loads(r.arrival))
        start = timeline.start_time(n, r.arrival)
        tokens = r.prompt_tokens + r.decode_tokens
        probs = self.workload.tasks[r.task].probs
        layer_counts = tm.sample_layer_counts(self.rng, probs, tokens)
        dense_t = tm.dense_time(tokens, n)
        req_hits = req_tot = 0.0
        if self.mode == "offload":
            service, hits, tot = tm.offload_service(
                layer_counts, n, self._cache_mask[n]
            )
            service += L * dense_t
            ratio.add(hits, tot)
            req_hits, req_tot = hits, tot
        else:
            res = self._effective_res()
            service = 0.0
            for l in range(L):
                worst, hits, tot = tm.collab_layer(
                    layer_counts[l], res[l], n, timeline, layer=l
                )
                ratio.add(hits, tot)
                req_hits += hits
                req_tot += tot
                service += dense_t + worst
        done = start + service
        timeline.occupy(n, done)
        self._latencies.append(done - r.arrival)
        self._servers.append(r.server)
        self._routed.append(n)
        self._finishes.append(done)
        self._hits_by_server[n] += req_hits
        self._tot_by_server[n] += req_tot
        self._stats.update_server(r.server, layer_counts)
        self._dispatch_counts[:, r.server, :] += layer_counts
        ratio.roll(done)

        migrated = False
        if ctrl is not None:
            migrated = self.poll_migration(done)
            dec = ctrl.review(done)
            if dec.adopted and dec.staged:
                self._migrations.append(
                    {
                        "time": done,
                        "staged": True,
                        "eta": dec.diag["eta"],
                        "transfers": dec.diag["transfers"],
                        "transfer_bytes": dec.diag["transfer_bytes"],
                    }
                )
            elif dec.adopted and not dec.staged:
                new_res = dec.plan.residency()
                delays, added = tm.migration_pause(self._res, new_res)  # Eq.3
                timeline.pause(delays)
                self._migrations.append(
                    {"time": done, "added_per_server": added.tolist()}
                )
                self._plan, self._res = dec.plan, new_res
                migrated = True
        return {
            "origin": r.server,
            "server": n,
            "start": start,
            "done": done,
            "latency": done - r.arrival,
            "hits": req_hits,
            "tot": req_tot,
            "migrated": migrated,
        }

    def poll_migration(self, now: float) -> bool:
        """Complete the controller's in-flight staged migration once its
        transfers have landed (``now >= eta``): the pending plan becomes
        the serving residency with no stall — the link schedule already
        charged the move, overlapped with serving, replacing the
        instantaneous Eq.-3 pause. Called per served request and by the
        fault path (which fast-forwards stalled requests to the recovery
        plan's eta). Returns whether a switch happened."""
        ctrl = self.controller
        if ctrl is None:
            return False
        comp = ctrl.poll(now)
        if comp is None:
            return False
        new_res = comp.plan.residency()
        added = np.maximum(new_res - self._res, 0).sum(0).sum(-1)
        self._migrations.append(
            {
                "time": now,
                "completed": True,
                "staged_at": comp.started,
                "eta": comp.eta,
                "transfer_seconds": comp.seconds,
                "transfer_bytes": comp.nbytes,
                "added_per_server": added.tolist(),
            }
        )
        self._plan, self._res = comp.plan, new_res
        return True

    def adopt_plan(self, plan) -> None:
        """Switch the serving residency to ``plan`` immediately (the fault
        path's instant adoption, when recovery needs no transfers)."""
        self.start()
        self._plan, self._res = plan, plan.residency()

    def _effective_res(self) -> np.ndarray:
        """The serving residency minus crashed servers: a dead server's
        experts are not dispatch targets. Bit-identical to ``_res`` while
        every server is up (or without a topology / with
        ``mask_dead_residency`` off)."""
        res = self._res
        if res is None or not self.mask_dead_residency or self.topology is None:
            return res
        up = np.asarray(self.topology.state.up)
        if up.all():
            return res
        return res * up.astype(res.dtype)[None, :, None]

    def uncovered_live_experts(self) -> bool:
        """True when some expert has no replica on any live server — a
        crash amputated its only holder(s); requests stall until the
        recovery migration restores coverage."""
        res = self._effective_res()
        if res is None or res is self._res:
            return False
        return bool((res.sum(1) <= 0).any())

    def loads(self, arrival: float = 0.0) -> np.ndarray:
        """[N] earliest-start estimate per server (the router's input);
        crashed servers report ``inf`` so no router picks them."""
        self.start()
        loads = np.maximum(self._timeline.free, arrival)
        if self.topology is not None:
            up = np.asarray(self.topology.state.up)
            if not up.all():
                loads = np.where(up, loads, np.inf)
        return loads

    def local_ratio_by_server(self) -> np.ndarray:
        """[N] local-compute ratio of the traffic each server has served so
        far (live view; 1.0 for servers with no traffic yet)."""
        self.start()
        return np.where(
            self._tot_by_server > 0,
            self._hits_by_server / np.maximum(self._tot_by_server, 1.0),
            1.0,
        )

    def finish(self) -> SimResult:
        self.start()
        self._ratio.flush()
        return SimResult(
            latencies=np.array(self._latencies),
            servers=np.array(self._servers),
            finish_times=np.array(self._finishes),
            local_ratio_t=self._ratio.samples,
            migrations=self._migrations,
            stats=self._stats,
            routed=np.array(self._routed, int),
            hits_by_server=self._hits_by_server.copy(),
            tot_by_server=self._tot_by_server.copy(),
        )

    def run(self) -> SimResult:
        # a full pass always starts from a fresh timeline (run() was
        # reentrant before the incremental refactor and must stay so);
        # incremental callers drive start()/serve_request()/finish()
        self._started = False
        self.start()
        for r in self.source:
            self.serve_request(r)
        return self.finish()
