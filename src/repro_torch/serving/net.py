"""Heterogeneous topology + communication subsystem (``repro_torch.serving.net``).

Prism's headline claims are about *inter-server communication* over
*heterogeneous* edge hardware, so the interconnect and the per-server
budgets are first-class objects here instead of two scalars on
``ClusterSpec``:

* :class:`ServerProfile` — one edge server's memory/compute caps. The
  memory fields *bound* what the rest of the stack may allocate there:
  ``expert_budget(expert_bytes)`` caps the placement algorithms
  (Algorithm 1's M_n / m_e) and ``kv_block_budget(block_bytes)`` caps the
  serving runtime's paged KV pool on that server. Optional
  ``host_mem_bytes``/``disk_mem_bytes`` open a host-RAM (and modeled
  disk) **expert tier** behind the GPU residency, priced by
  ``host_bw``/``disk_bw`` (see ``repro_torch.serving.tiers``).
* :class:`Topology` — N profiles plus a per-link ``[N, N]`` bandwidth
  (bytes/s) and latency (seconds) matrix. Links may be asymmetric (an
  uplink-constrained WAN hop) and non-uniform (the testbed's 500 Mbps LAN
  next to a 25 Mbps WAN-ish link). ``transfer_seconds`` is the one cost
  primitive everything else prices with.
* :class:`TrafficMeter` — converts the per-origin ``[n_ep, E]`` gating
  attribution the MoE layer already produces into per-(src, dst)-link
  dispatch **bytes** each round: every activation a server routes to a
  remote replica pays ``hidden_bytes`` on the forward link and again on
  the return link. Both ``EdgeCluster`` backends feed it the same counts,
  so modeled cross-server traffic is comparable across worlds.
* :class:`CommCostModel` — the Eq.-4 cost model, link-aware: ``C(P)``
  prices each (origin, expert) activation at the *cheapest resident
  replica's link* instead of a uniform remote penalty, and ``T_mig``
  is the makespan of the staged transfer schedule below.
* :func:`plan_transfers` / :func:`schedule_transfers` — an adopted plan
  becomes per-expert :class:`TransferTask`s: each newly placed expert is
  fetched from its cheapest current holder (or loaded from local storage
  when nowhere resident), transfers on one link are serialized, distinct
  links proceed in parallel, and serving overlaps the whole schedule.
  :class:`StagedMigration` is the in-flight record the
  ``PlacementController`` polls — the plan switches only when the
  schedule's makespan has elapsed (no more instantaneous adoption).

Scheduling is deterministic by construction (tasks are ordered by
(layer, destination, expert); no RNG, no wall clock), so reruns of either
backend complete migrations at identical modeled times.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import PlacementPlan, iter_added_experts


# ---------------------------------------------------------------------------
# Server profiles and the link-cost topology
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServerProfile:
    """One edge server's capacity caps (the heterogeneity unit).

    ``mem_bytes`` is the GPU expert-weight budget in bytes (Algorithm 1's
    M_n); ``kv_mem_bytes`` the KV-cache budget (bytes) the serving runtime
    may page into; ``compute_speed`` effective FLOP/s; ``io_speed`` local
    weight-load bytes/s (NVMe/host RAM — the migration fallback when an
    expert is resident nowhere).

    **Expert tiers** (optional, all ``None`` = flat GPU-only server):
    ``host_mem_bytes`` / ``disk_mem_bytes`` open a host-RAM (and modeled
    disk) expert tier *behind* the GPU residency. Tier capacities are
    **inclusive**: host must be >= ``mem_bytes`` and disk >= host — the
    deeper tier always holds a superset, so demotion is free (the host
    copy still exists) and only promotion moves bytes. ``host_bw`` /
    ``disk_bw`` price the host<->device and disk<->host links in bytes/s
    (PCIe-ish vs NVMe-ish); a tiered server must carry them so the cost
    model can compare "fetch from my host tier" against "invoke the
    remote replica"."""
    name: str
    mem_bytes: float = 16e9
    kv_mem_bytes: float = 4e9
    compute_speed: float = 60e12
    io_speed: float = 8e9
    host_mem_bytes: float | None = None
    disk_mem_bytes: float | None = None
    host_bw: float | None = None
    disk_bw: float | None = None

    def __post_init__(self):
        for field in ("host_mem_bytes", "disk_mem_bytes"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{self.name}: {field}={v} — a tier is either absent "
                    "(None) or has positive capacity; zero-capacity tiers "
                    "are not allowed")
        if self.disk_mem_bytes is not None and self.host_mem_bytes is None:
            raise ValueError(
                f"{self.name}: a disk tier requires a host tier "
                "(disk_mem_bytes set but host_mem_bytes is None)")
        if (self.host_mem_bytes is not None
                and self.host_mem_bytes < self.mem_bytes):
            raise ValueError(
                f"{self.name}: tier capacities must nest — host_mem_bytes "
                f"({self.host_mem_bytes:.3g}) < GPU mem_bytes "
                f"({self.mem_bytes:.3g}); the host tier holds a superset "
                "of GPU residency")
        if (self.disk_mem_bytes is not None
                and self.disk_mem_bytes < self.host_mem_bytes):
            raise ValueError(
                f"{self.name}: tier capacities must nest — disk_mem_bytes "
                f"({self.disk_mem_bytes:.3g}) < host_mem_bytes "
                f"({self.host_mem_bytes:.3g})")

    @property
    def tiered(self) -> bool:
        """True when this server has a host-RAM expert tier."""
        return self.host_mem_bytes is not None

    def expert_budget(self, expert_bytes: float) -> int:
        """Expert slots this server's GPU weight memory can hold
        (M_n / m_e)."""
        return int(self.mem_bytes // expert_bytes)

    def tiered_expert_budget(self, expert_bytes: float) -> int:
        """Expert slots the *deepest* tier can hold. On a tiered server a
        placement plan may legally assign this many experts; only
        ``expert_budget`` of them are GPU-resident at any moment."""
        deepest = self.mem_bytes
        if self.host_mem_bytes is not None:
            deepest = self.host_mem_bytes
        if self.disk_mem_bytes is not None:
            deepest = self.disk_mem_bytes
        return int(deepest // expert_bytes)

    def tier_slots(self, expert_bytes: float) -> tuple[int, int, int]:
        """(gpu, host, disk) *cumulative* expert-slot capacities. Tiers
        are inclusive, so each entry is the total number of experts that
        tier and everything above it can hold (0-size for absent tiers
        means "same as the tier above")."""
        gpu = self.expert_budget(expert_bytes)
        host = (int(self.host_mem_bytes // expert_bytes)
                if self.host_mem_bytes is not None else gpu)
        disk = (int(self.disk_mem_bytes // expert_bytes)
                if self.disk_mem_bytes is not None else host)
        return gpu, host, disk

    def kv_block_budget(self, block_bytes: float) -> int:
        """Paged KV blocks this server's cache memory can hold (>= 1)."""
        return max(int(self.kv_mem_bytes // block_bytes), 1)


@dataclasses.dataclass
class LinkState:
    """Mutable liveness/degradation overlay on a frozen :class:`Topology`.

    The topology's profiled bandwidth/latency matrices describe the
    *healthy* fabric and never change; fault injection flips these
    switches instead (``repro_torch.serving.faults.apply_fault``). Every cost
    primitive below reads the overlay, so the controller, the transfer
    planner and both backends see one consistent view of the fabric the
    moment a fault lands.

    up:        [N] bool — server liveness (False = crashed).
    bw_factor: [N, N] in (0, 1] — per-link bandwidth multiplier
               (1 = healthy, < 1 = degraded).
    """
    up: np.ndarray
    bw_factor: np.ndarray

    @staticmethod
    def fresh(n: int) -> "LinkState":
        return LinkState(np.ones(n, bool), np.ones((n, n)))

    def copy(self) -> "LinkState":
        return LinkState(self.up.copy(), self.bw_factor.copy())


@dataclasses.dataclass(frozen=True)
class Topology:
    """N servers + a per-link cost model.

    bandwidth: [N, N] bytes/s; entry (i, j) is the i -> j link. The
               diagonal is ignored (local traffic never crosses a link).
    latency:   [N, N] seconds per transfer/invocation on the link.

    Both matrices may be asymmetric. Off-diagonal bandwidth must be finite
    and positive so every remote link costs strictly more than local
    compute (nearest-replica routing then never prefers a remote tie).

    ``state`` is the mutable :class:`LinkState` overlay (server liveness,
    link degradation). It is attached at construction and *shared*: the
    ``PlacementController`` enforces one Topology object per cluster, so
    a fault applied by a backend is immediately visible to every cost
    computation.
    """
    profiles: tuple[ServerProfile, ...]
    bandwidth: np.ndarray
    latency: np.ndarray

    def __post_init__(self):
        n = len(self.profiles)
        bw = np.asarray(self.bandwidth, float)
        lat = np.asarray(self.latency, float)
        if bw.shape != (n, n) or lat.shape != (n, n):
            raise ValueError(
                f"bandwidth/latency must be [{n}, {n}] matrices, got "
                f"{bw.shape} / {lat.shape}")
        off = ~np.eye(n, dtype=bool)
        if n > 1 and (~np.isfinite(bw[off]) | (bw[off] <= 0)).any():
            raise ValueError(
                "off-diagonal link bandwidth must be finite and positive")
        if (lat < 0).any():
            raise ValueError("link latency must be >= 0")
        for p in self.profiles:
            if p.tiered and not (p.host_bw is not None
                                 and np.isfinite(p.host_bw)
                                 and p.host_bw > 0):
                raise ValueError(
                    f"{p.name}: tiered profile must price the host<->device "
                    f"link — host_bw={p.host_bw} is not finite and positive")
            if p.disk_mem_bytes is not None and not (
                    p.disk_bw is not None and np.isfinite(p.disk_bw)
                    and p.disk_bw > 0):
                raise ValueError(
                    f"{p.name}: disk tier must price the disk<->host link — "
                    f"disk_bw={p.disk_bw} is not finite and positive")
        object.__setattr__(self, "bandwidth", bw)
        object.__setattr__(self, "latency", lat)
        object.__setattr__(self, "state", LinkState.fresh(n))

    @property
    def n(self) -> int:
        return len(self.profiles)

    @property
    def alive(self) -> np.ndarray:
        """[N] bool server-liveness view (the LinkState overlay)."""
        return self.state.up

    def effective_bandwidth(self) -> np.ndarray:
        """[N, N] profiled bandwidth x the degradation overlay."""
        return self.bandwidth * self.state.bw_factor

    # -- constructors --------------------------------------------------
    @staticmethod
    def uniform(profiles, bandwidth: float = 500e6 / 8,
                rtt: float = 2e-3) -> "Topology":
        """Every pair of servers linked at the same bandwidth/latency (the
        legacy ``ClusterSpec`` interconnect model). ``rtt`` is the
        *round-trip* latency (the legacy per-remote-call charge), split
        evenly across the two legs so ``round_trip_seconds`` reproduces
        it exactly. ``profiles`` is a sequence of :class:`ServerProfile`
        or an int server count."""
        if isinstance(profiles, int):
            profiles = tuple(ServerProfile(f"server{i}")
                             for i in range(profiles))
        profiles = tuple(profiles)
        n = len(profiles)
        bw = np.full((n, n), float(bandwidth))
        lat = np.full((n, n), float(rtt) / 2.0)
        np.fill_diagonal(lat, 0.0)
        return Topology(profiles, bw, lat)

    @staticmethod
    def from_cluster_spec(spec) -> "Topology":
        """Lift a simulator ``ClusterSpec`` (uniform interconnect) into a
        topology. The legacy spec has no separate KV budget, so the whole
        server memory doubles as the KV cap."""
        profiles = tuple(
            ServerProfile(s.name, mem_bytes=s.mem_bytes,
                          kv_mem_bytes=s.mem_bytes,
                          compute_speed=s.compute_speed, io_speed=s.io_speed)
            for s in spec.servers)
        return Topology.uniform(profiles, bandwidth=spec.bandwidth,
                                rtt=spec.rtt)

    # -- link costs ----------------------------------------------------
    # All three primitives price against the *effective* bandwidth
    # (profiled x degradation overlay), so a LINK_DEGRADED fault is
    # reflected in migration planning and Eq.-4 costs the moment it lands.
    def transfer_seconds(self, src: int, dst: int, nbytes: float) -> float:
        """Modeled seconds to move ``nbytes`` over the src -> dst link
        (0 for local)."""
        if src == dst:
            return 0.0
        bw = self.bandwidth[src, dst] * self.state.bw_factor[src, dst]
        return float(nbytes / bw + self.latency[src, dst])

    def link_seconds(self, nbytes: float) -> np.ndarray:
        """[N, N] one-way transfer seconds for ``nbytes`` on every link
        (diag 0) — bulk weight moves, which only ride the forward link."""
        out = nbytes / self.effective_bandwidth() + self.latency
        np.fill_diagonal(out, 0.0)
        return out

    def round_trip_seconds(self, nbytes: float) -> np.ndarray:
        """[N, N] request + response transfer seconds: entry (i, j) moves
        ``nbytes`` over the i -> j link and ``nbytes`` back over j -> i
        (diag 0). The invocation-cost primitive — on asymmetric
        topologies the slow return leg prices at ITS OWN link, not the
        forward one."""
        one_way = nbytes / self.effective_bandwidth() + self.latency
        out = one_way + one_way.T
        np.fill_diagonal(out, 0.0)
        return out

    def distance(self, nbytes: float = 1024.0) -> np.ndarray:
        """A link-cost matrix usable as ``mesh_distance`` for
        nearest-replica routing (``placement_from_tables``): relative
        round-trip ordering of links at a nominal per-invocation
        payload."""
        return self.round_trip_seconds(nbytes)

    # -- budgets -------------------------------------------------------
    def expert_budgets(self, expert_bytes: float) -> np.ndarray:
        """[N] per-server expert-slot budgets (Algorithm 1's capacity)."""
        return np.array([p.expert_budget(expert_bytes)
                         for p in self.profiles])

    def kv_block_budgets(self, block_bytes: float) -> np.ndarray:
        """[N] per-server paged-KV block budgets."""
        return np.array([p.kv_block_budget(block_bytes)
                         for p in self.profiles])

    @property
    def tiered(self) -> bool:
        """True when any profile carries a host-RAM expert tier."""
        return any(p.tiered for p in self.profiles)

    def tiered_expert_budgets(self, expert_bytes: float) -> np.ndarray:
        """[N] per-server deepest-tier expert budgets — what Algorithm 1
        may assign when the tier hierarchy backs GPU residency."""
        return np.array([p.tiered_expert_budget(expert_bytes)
                         for p in self.profiles])

    def tier_slot_capacities(self, expert_bytes: float) -> np.ndarray:
        """[N, 3] cumulative (gpu, host, disk) expert-slot capacities."""
        return np.array([p.tier_slots(expert_bytes)
                         for p in self.profiles])

    def host_fetch_seconds(self, server: int, nbytes: float) -> float:
        """Modeled seconds to pull ``nbytes`` from ``server``'s host tier
        into its GPU (the on-demand-fetch / promotion cost). Falls back to
        ``io_speed`` for untiered servers (plain local load)."""
        p = self.profiles[server]
        bw = p.host_bw if p.host_bw is not None else p.io_speed
        return float(nbytes / bw)

    def disk_fetch_seconds(self, server: int, nbytes: float) -> float:
        """Modeled seconds to stage ``nbytes`` disk -> host -> GPU on
        ``server`` (both legs, serialized)."""
        p = self.profiles[server]
        if p.disk_bw is None:
            return self.host_fetch_seconds(server, nbytes)
        return float(nbytes / p.disk_bw) + self.host_fetch_seconds(
            server, nbytes)


def route_targets(residency_l: np.ndarray, link_cost: np.ndarray
                  ) -> np.ndarray:
    """Cheapest resident replica per (origin server, expert) for one layer.

    residency_l: [N, E] (> 0 where the expert is resident).
    link_cost:   [N, N] per-invocation link cost (diagonal 0).
    Returns targets [N, E] int; an origin holding the expert always serves
    it locally. Raises when an expert is resident nowhere (coverage)."""
    res = np.asarray(residency_l) > 0
    N, E = res.shape
    uncovered = ~res.any(axis=0)
    if uncovered.any():
        raise ValueError(
            f"experts {np.where(uncovered)[0].tolist()} resident nowhere "
            "(placement coverage violated)")
    targets = np.empty((N, E), int)
    for src in range(N):
        masked = np.where(res, link_cost[src][:, None], np.inf)   # [N, E]
        targets[src] = np.argmin(masked, axis=0)
        targets[src] = np.where(res[src], src, targets[src])
    return targets


# ---------------------------------------------------------------------------
# Dispatch traffic metering
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrafficMeter:
    """Per-link dispatch byte accounting from the gating attribution.

    The MoE layer already attributes every gating decision to the server
    the request *originated* at (the ``[n_ep, E]``-per-layer counts both
    backends accumulate). The meter converts those counts into link
    traffic under the active placement: a token whose origin routes expert
    ``e`` to a remote replica sends one ``hidden_bytes`` activation over
    the (origin -> replica) link and receives one back on the (replica ->
    origin) link; local activations meter nothing. Replica choice is the
    cheapest resident link (:func:`route_targets`) — the same
    nearest-replica rule the runtime's ``expert_to_target`` tables encode.
    """
    topology: Topology
    hidden_bytes: float
    link_bytes: np.ndarray = None          # [N, N] cumulative bytes
    link_invocations: np.ndarray = None    # [N, N] forward remote dispatches
    rounds: int = 0
    _snapshot: np.ndarray | None = None    # last observed cumulative counts

    def __post_init__(self):
        n = self.topology.n
        if self.link_bytes is None:
            self.link_bytes = np.zeros((n, n))
        if self.link_invocations is None:
            self.link_invocations = np.zeros((n, n))

    def seed(self, total_counts: np.ndarray) -> None:
        """Set the ``observe`` baseline to an existing cumulative counts
        matrix, so activation history from before this meter existed
        (e.g. a warmed-up engine's lifetime stats) is not booked as
        dispatched traffic."""
        self._snapshot = np.asarray(total_counts, float).copy()

    def record(self, delta_counts: np.ndarray, residency: np.ndarray
               ) -> np.ndarray:
        """Meter one round of gating counts.

        delta_counts: [L, N, E] new activations per (layer, origin, expert).
        residency:    [L, N, E] the active plan's residency.
        Returns this round's [N, N] link-byte matrix (also accumulated)."""
        delta = np.asarray(delta_counts, float)
        res = np.asarray(residency)
        L, N, E = delta.shape
        if res.shape != delta.shape or N != self.topology.n:
            raise ValueError(
                f"counts {delta.shape} / residency {res.shape} do not match "
                f"the {self.topology.n}-server topology")
        tokens = np.zeros((N, N))
        src_idx = np.repeat(np.arange(N), E)
        # per-call, not cached at construction: the topology's LinkState
        # overlay is mutable (fault injection), and replica choice must
        # track the fabric the dispatch actually crossed
        cost = self.topology.round_trip_seconds(self.hidden_bytes)
        for l in range(L):
            tgt = route_targets(res[l], cost)                 # [N, E]
            np.add.at(tokens, (src_idx, tgt.reshape(-1)),
                      delta[l].reshape(-1))
        np.fill_diagonal(tokens, 0.0)                         # local = free
        round_bytes = (tokens + tokens.T) * self.hidden_bytes  # fwd + return
        self.link_bytes += round_bytes
        self.link_invocations += tokens
        self.rounds += 1
        return round_bytes

    def observe(self, total_counts: np.ndarray, residency: np.ndarray
                ) -> np.ndarray:
        """Meter the *delta* since the previous ``observe`` of a cumulative
        counts matrix. ``total_counts`` must be a plain (non-decayed)
        accumulator of true activation volumes — an EMA-tracked
        ``ActivationStats`` would systematically under-meter (the decay
        eats into every delta) and count any pre-primed history as
        dispatched traffic. Both backends keep a dedicated plain
        accumulator for exactly this call."""
        total = np.asarray(total_counts, float)
        if self._snapshot is None or self._snapshot.shape != total.shape:
            self._snapshot = np.zeros_like(total)
        delta = total - self._snapshot
        self._snapshot = total.copy()
        if not (delta > 0).any():
            self.rounds += 1
            return np.zeros_like(self.link_bytes)
        return self.record(np.maximum(delta, 0.0), residency)

    @property
    def cross_server_bytes(self) -> float:
        """Total bytes that crossed any inter-server link."""
        return float(self.link_bytes.sum())

    def summary(self) -> dict:
        """JSON-able metering snapshot (the ``metrics()['net']`` payload)."""
        return {
            "rounds": self.rounds,
            "link_bytes": [[round(float(v), 3) for v in row]
                           for row in self.link_bytes],
            "cross_server_bytes": round(self.cross_server_bytes, 3),
            "remote_invocations": round(float(
                self.link_invocations.sum()), 3),
        }


# ---------------------------------------------------------------------------
# Bandwidth-aware staged migration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransferTask:
    """One expert's weights moving to one server (src == dst: local IO
    load — the expert was resident nowhere). ``start``/``end`` are modeled
    seconds relative to the migration's adoption.

    ``via`` selects the link the bytes ride: ``None`` infers the classic
    behavior (inter-server link, or local ``io_speed`` load when
    src == dst); ``"host"`` is a tier promotion over the destination's
    host<->device link; ``"disk"`` stages disk -> host -> GPU."""
    layer: int
    expert: int
    src: int
    dst: int
    nbytes: float
    start: float = 0.0
    end: float = 0.0
    via: str | None = None


def plan_transfers(old: PlacementPlan, new: PlacementPlan,
                   topology: Topology, expert_bytes: float
                   ) -> list[TransferTask]:
    """Per-expert transfer tasks realizing ``new`` from ``old``: every
    newly placed (layer, server, expert) entry fetches the weights from
    the cheapest *live* current holder's link (local IO when no live
    holder exists — a crashed server cannot source a copy, and its
    resident replicas are lost with it). Degraded links are not excluded,
    but ``link_seconds`` prices them at effective bandwidth, so a healthy
    holder wins whenever one exists. Removals are free (weights are
    dropped, not moved)."""
    res_old = old.residency()                       # [L, N, E]
    cost = topology.link_seconds(expert_bytes)
    up = topology.state.up
    tasks: list[TransferTask] = []
    for l, n, e in iter_added_experts(old, new):
        holders = np.where((res_old[l, :, e] > 0) & up)[0]
        if len(holders):
            src = int(holders[np.argmin(cost[holders, n])])
        else:
            src = n                                  # local storage load
        tasks.append(TransferTask(l, e, src, n, expert_bytes))
    return tasks


def schedule_transfers(tasks: list[TransferTask], topology: Topology,
                       start: float = 0.0) -> float:
    """Schedule tasks over the modeled links: one link moves one expert at
    a time (serialized), distinct links (and local IO loads, serialized
    per destination) proceed in parallel, serving overlaps everything.
    Mutates each task's ``start``/``end``; returns the makespan's finish
    time. Deterministic: tasks are processed in (layer, dst, expert)
    order and nothing consults a clock or RNG."""
    link_free: dict[tuple, float] = {}
    finish = start
    for t in sorted(tasks, key=lambda t: (t.layer, t.dst, t.expert)):
        if t.via == "host":
            dur = topology.host_fetch_seconds(t.dst, t.nbytes)
            key = ("host", t.dst)
        elif t.via == "disk":
            dur = topology.disk_fetch_seconds(t.dst, t.nbytes)
            key = ("host", t.dst)
        elif t.src == t.dst:
            dur = t.nbytes / topology.profiles[t.dst].io_speed
            key = (t.src, t.dst)
        else:
            dur = topology.transfer_seconds(t.src, t.dst, t.nbytes)
            key = (t.src, t.dst)
        t.start = max(start, link_free.get(key, start))
        t.end = t.start + dur
        link_free[key] = t.end
        finish = max(finish, t.end)
    return finish


def trace_transfers(tracer, tasks: list[TransferTask], now: float = 0.0,
                    clock_rate: float = 1.0) -> None:
    """Record one ``TRANSFER_TASK`` span per scheduled transfer on
    ``tracer`` (``repro_torch.serving.obs.Tracer``). Tasks carry start/end in
    modeled seconds relative to the adoption instant
    (:func:`schedule_transfers`); ``now`` is the adoption time on the
    caller's clock and ``clock_rate`` its seconds-per-clock-unit, so the
    spans land on the owning backend's timeline (each on its destination
    server's track)."""
    if tracer is None or not tracer.enabled:
        return
    for t in tasks:
        tracer.span("TRANSFER_TASK", now + t.start / clock_rate,
                    now + t.end / clock_rate, server=t.dst,
                    layer=t.layer, expert=t.expert, src=t.src, dst=t.dst,
                    nbytes=t.nbytes, via=t.via)


@dataclasses.dataclass
class StagedMigration:
    """An adopted-but-not-yet-active plan in flight over the links.

    ``started``/``eta`` are in the owning controller's *clock* units
    (ticks or seconds); ``seconds`` is the modeled transfer makespan in
    seconds (identical across backends for the same plans + topology)."""
    plan: PlacementPlan
    tasks: list[TransferTask]
    started: float
    eta: float
    seconds: float

    @property
    def nbytes(self) -> float:
        """Bytes moved over inter-server links (local IO loads excluded)."""
        return float(sum(t.nbytes for t in self.tasks if t.src != t.dst))


# ---------------------------------------------------------------------------
# Link-aware Eq.-4 cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommCostModel:
    """Eq.-4 pricing over a real topology (drop-in for
    ``core.migration.CostModel`` wherever a ``PlacementController`` takes
    ``cost=``).

    ``C(P)``: each (origin, expert) activation pays the *cheapest resident
    replica's* per-invocation link cost (2 activation transfers + link
    latency + overhead) instead of a uniform remote penalty — a plan that
    keeps traffic off the slow WAN link now prices lower than one that
    merely keeps it off *any* link. ``T_mig``: the staged transfer
    schedule's makespan (:func:`schedule_transfers`), so Eq. 4 charges a
    migration exactly what the executor will spend."""
    topology: Topology
    expert_bytes: float
    activation_bytes: float
    per_call_overhead: float = 0.0
    tokens_per_horizon: float = 1e4

    def invocation_seconds(self) -> np.ndarray:
        """[N, N] cost of one remote expert invocation per link pair:
        the activation rides the forward link out and the *reverse* link
        back (each priced at its own bandwidth/latency), plus the fixed
        overhead (diag 0)."""
        out = (self.topology.round_trip_seconds(self.activation_bytes)
               + self.per_call_overhead)
        np.fill_diagonal(out, 0.0)
        return out

    def comm_cost_seconds(self, plan: PlacementPlan,
                          freqs: np.ndarray) -> float:
        """C(P) over the horizon: expected per-token-layer invocation cost
        under cheapest-replica routing x token-layer volume."""
        inv = self.invocation_seconds()
        res = plan.residency()
        L, N, _ = res.shape
        total = 0.0
        src = np.arange(N)[:, None]
        for l in range(L):
            tgt = route_targets(res[l], inv)         # [N, E]
            total += float((freqs[l] * inv[src, tgt]).sum())
        return total / L * self.tokens_per_horizon

    def migration_seconds(self, old: PlacementPlan,
                          new: PlacementPlan) -> float:
        """T_mig as the staged schedule's makespan (Eq. 3, link-aware)."""
        tasks = plan_transfers(old, new, self.topology, self.expert_bytes)
        return schedule_transfers(tasks, self.topology)
