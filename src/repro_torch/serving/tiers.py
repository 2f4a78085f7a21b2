"""Per-server expert tier hierarchy behind GPU residency
(``repro_torch.serving.tiers``).

The paper's headline constraint is that MoE footprints overwhelm edge
servers; every scenario served before this module assumed the full expert
set fits in aggregate GPU memory. A :class:`TierManager` lifts that
assumption: placement plans may legally assign a server as many experts
as its *deepest* tier holds (``ServerProfile.tiered_expert_budget``), and
the manager tracks which of them are GPU-resident (tier 0), parked in
host RAM (tier 1) or on modeled disk (tier 2).

Three mechanisms, all deterministic (no RNG, no wall clock):

* **bind(plan)** — whenever the controller adopts a plan, each server's
  assigned experts are split across its tiers hottest-first (by the
  accumulated gating heat; expert id breaks ties), so the GPU tier holds
  the historically hottest subset.
* **prefetch** — ``observe()`` folds the same per-origin ``[n_ep, E]``
  cumulative gating counts the ``TrafficMeter`` consumes into a per-
  (layer, expert) heat table; ``prefetch_step(now)`` swaps the hottest
  back-tier expert with the coldest GPU-resident one whenever it is
  strictly hotter, as a :class:`~repro_torch.serving.net.TransferTask` over the
  server's host<->device link (``via="host"``/``"disk"``) priced by
  :func:`~repro_torch.serving.net.schedule_transfers` and overlapped with
  decode; ``poll(now)`` flips the tiers once the modeled fetch lands.
  Demotion is free — tiers are inclusive, the host copy still exists.
* **accounting** — every observed activation on an expert its origin
  holds GPU-resident is a *prefetch hit*; one parked in a back tier books
  an *on-demand fetch* (one per (layer, origin, expert) cell per round)
  with a modeled stall of the tier's fetch time. ``summary()`` is the
  ``metrics.tiers`` payload (schema ``bench-serving/v6``).

A ``SERVER_DOWN`` fault calls ``drop_server``: the crashed server's
entire tier table is wiped and its in-flight promotions abort, so the
fault review re-plans tiered residency deterministically (the
fault-determinism contract extends to tiers — see ``tests/test_faults.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import PlacementPlan
from repro_torch.serving.net import Topology, TransferTask, schedule_transfers

TIER_GPU = 0
TIER_HOST = 1
TIER_DISK = 2


@dataclasses.dataclass
class _Promotion:
    """One in-flight host->GPU fetch (promote ``expert``, demote
    ``evict``); ``eta`` is in the owner's clock units."""

    layer: int
    server: int
    expert: int
    evict: int
    eta: float
    seconds: float


@dataclasses.dataclass
class TierManager:
    """Owns the per-server expert-tier tables and the activation-aware
    prefetcher.

    topology:     the cluster fabric (tier capacities + fetch pricing).
    expert_bytes: one expert's weights in bytes (the promotion payload).
    prefetch:     False freezes residency at the bind-time split — cold
                  experts keep paying on-demand fetches (the baseline leg
                  of the oversized-model benchmark).
    clock_rate:   modeled seconds per unit of the owner's clock (1.0 for
                  the seconds-clock sim backend; the runtime backend's
                  tick length), mirroring ``PlacementController``.
    """

    topology: Topology
    expert_bytes: float
    prefetch: bool = True
    clock_rate: float = 1.0

    tier: np.ndarray | None = None  # [L, N, E] int8, -1 = unplaced
    events: list = dataclasses.field(default_factory=list)
    # optional span tracer (repro_torch.serving.obs.Tracer): PREFETCH spans for
    # landed promotions, COLD_FETCH_STALL spans for on-demand fetches —
    # duck-typed so this module stays importable without obs
    tracer: "object | None" = None

    def __post_init__(self):
        self._heat: np.ndarray | None = None  # [L, E] accumulated
        self._snapshot: np.ndarray | None = None  # last cumulative counts
        self._inflight: list[_Promotion] = []
        self.promotions = 0
        self.demotions = 0
        self.gpu_hit_tokens = 0.0
        self.fetch_tokens = 0.0
        self.on_demand_fetches = 0
        self.on_demand_stall_seconds = 0.0

    # -- residency ----------------------------------------------------
    def bind(self, plan: PlacementPlan) -> None:
        """Split ``plan``'s per-server expert assignments across tiers,
        hottest-first. Called on every plan switch (initial adoption,
        staged-migration completion, fault review); re-binding counts
        GPU-residents pushed to a back tier as demotions."""
        L = len(plan.assign)
        N, E = self.topology.n, plan.num_experts
        old = self.tier
        # whole-server byte budgets split evenly across layers (the same
        # heuristic ClusterView uses for its per-layer slot caps)
        caps = self.topology.tier_slot_capacities(self.expert_bytes) // L
        tier = np.full((L, N, E), -1, np.int8)
        for l in range(L):
            heat = self._heat[l] if self._heat is not None else np.zeros(E)
            for n in range(N):
                order = sorted(plan.assign[l][n], key=lambda e: (-heat[e], e))
                gpu, host, _ = caps[n]
                for rank, e in enumerate(order):
                    if rank < gpu:
                        tier[l, n, e] = TIER_GPU
                    elif rank < host:
                        tier[l, n, e] = TIER_HOST
                    else:
                        tier[l, n, e] = TIER_DISK
        if old is not None and old.shape == tier.shape:
            self.demotions += int(((old == TIER_GPU) & (tier > TIER_GPU)).sum())
        self.tier = tier
        self._inflight = [
            p
            for p in self._inflight
            if tier[p.layer, p.server, p.expert] > TIER_GPU
            and tier[p.layer, p.server, p.evict] == TIER_GPU
        ]

    def gpu_residency(self) -> np.ndarray | None:
        """[L, N, E] 0/1 — which assigned experts are GPU-resident now."""
        if self.tier is None:
            return None
        return (self.tier == TIER_GPU).astype(np.int8)

    def slot_priority(self) -> np.ndarray | None:
        """[L, N, E] sort key for engine slot tables: GPU-tier experts
        fill the (scarce) physical slots before back-tier ones."""
        return self.tier

    # -- stats ingestion + hit/stall accounting ------------------------
    def observe(self, total_counts: np.ndarray, now: float = 0.0) -> None:
        """Fold a cumulative per-origin ``[L, N, E]`` gating-counts matrix
        (the same accumulator the ``TrafficMeter`` observes) into the
        prefetch heat table, and book this round's hits/fetches against
        the current tier residency. ``now`` (owner's clock) anchors the
        traced ``COLD_FETCH_STALL`` spans; it never affects the
        accounting itself."""
        total = np.asarray(total_counts, float)
        if self._snapshot is None or self._snapshot.shape != total.shape:
            self._snapshot = np.zeros_like(total)
        delta = np.maximum(total - self._snapshot, 0.0)
        self._snapshot = total.copy()
        if not delta.any():
            return
        if self._heat is None or self._heat.shape != total.shape[::2]:
            self._heat = np.zeros((total.shape[0], total.shape[2]))
        self._heat += delta.sum(axis=1)
        if self.tier is None:
            return
        eb = self.expert_bytes
        n_srv = self.topology.n
        L = min(self.tier.shape[0], delta.shape[0])
        for l in range(L):
            t_l = self.tier[l]  # [N, E]
            d_l = delta[l][:n_srv]
            self.gpu_hit_tokens += float(d_l[t_l == TIER_GPU].sum())
            for n, e in zip(*np.nonzero((t_l > TIER_GPU) & (d_l > 0))):
                self.fetch_tokens += float(d_l[n, e])
                self.on_demand_fetches += 1
                if t_l[n, e] == TIER_DISK:
                    stall = self.topology.disk_fetch_seconds(int(n), eb)
                else:
                    stall = self.topology.host_fetch_seconds(int(n), eb)
                self.on_demand_stall_seconds += stall
                if self.tracer is not None and self.tracer.enabled:
                    self.tracer.span(
                        "COLD_FETCH_STALL",
                        now,
                        now + stall / self.clock_rate,
                        server=int(n),
                        layer=int(l),
                        expert=int(e),
                        tier=int(t_l[n, e]),
                        stall_seconds=stall,
                    )

    def fetch_stall_seconds(self, layer: int, server: int, expert: int) -> float:
        """Modeled stall for invoking ``expert`` on ``server`` right now:
        0 when GPU-resident, the tier's fetch time when parked behind, inf
        when not assigned there at all. On-demand fetches are transient —
        they never mutate the tier table (determinism: latency pricing
        stays a pure function of the tier state)."""
        if self.tier is None:
            return 0.0
        t = self.tier[layer, server, expert]
        if t < 0:
            return float("inf")
        if t == TIER_GPU:
            return 0.0
        if t == TIER_DISK:
            return self.topology.disk_fetch_seconds(server, self.expert_bytes)
        return self.topology.host_fetch_seconds(server, self.expert_bytes)

    # -- the prefetcher ------------------------------------------------
    def prefetch_step(self, now: float) -> None:
        """Promote the hottest back-tier expert per (server, layer) when
        it is strictly hotter than the coldest GPU-resident one, as a
        host-link :class:`TransferTask` overlapped with decode."""
        if not self.prefetch or self.tier is None or self._heat is None:
            return
        busy = {(p.layer, p.server) for p in self._inflight}
        L, N, _ = self.tier.shape
        tasks, promos = [], []
        for l in range(L):
            heat = self._heat[l]
            for n in range(N):
                if (l, n) in busy or not self.topology.profiles[n].tiered:
                    continue
                back = np.nonzero(self.tier[l, n] > TIER_GPU)[0]
                res = np.nonzero(self.tier[l, n] == TIER_GPU)[0]
                if not len(back) or not len(res):
                    continue
                hot = int(min(back, key=lambda e: (-heat[e], e)))
                cold = int(min(res, key=lambda e: (heat[e], e)))
                if heat[hot] <= heat[cold]:
                    continue
                via = "disk" if self.tier[l, n, hot] == TIER_DISK else "host"
                tasks.append(TransferTask(l, hot, n, n, self.expert_bytes, via=via))
                promos.append((l, n, hot, cold))
        if not tasks:
            return
        # one shared schedule: fetches on one server's host link
        # serialize, distinct servers proceed in parallel
        schedule_transfers(tasks, self.topology)
        for t, (l, n, hot, cold) in zip(tasks, promos):
            eta = now + t.end / self.clock_rate
            self._inflight.append(_Promotion(l, n, hot, cold, eta=eta, seconds=t.end))

    def poll(self, now: float) -> None:
        """Land every promotion whose modeled fetch has finished: the
        promoted expert becomes GPU-resident, the evicted one drops to
        the host tier (free — its host copy never left)."""
        if not self._inflight:
            return
        landed = [p for p in self._inflight if now >= p.eta]
        if not landed:
            return
        self._inflight = [p for p in self._inflight if now < p.eta]
        for p in landed:
            if (
                self.tier[p.layer, p.server, p.expert] <= TIER_GPU
                or self.tier[p.layer, p.server, p.evict] != TIER_GPU
            ):
                continue  # a rebind overtook this fetch
            self.tier[p.layer, p.server, p.expert] = TIER_GPU
            self.tier[p.layer, p.server, p.evict] = TIER_HOST
            self.promotions += 1
            self.demotions += 1
            if self.tracer is not None and self.tracer.enabled:
                # the fetch occupied the host link for p.seconds modeled
                # seconds ending at its eta (poll may run late; the span
                # records the modeled transfer window, not the poll time)
                self.tracer.span(
                    "PREFETCH",
                    p.eta - p.seconds / self.clock_rate,
                    p.eta,
                    server=p.server,
                    layer=p.layer,
                    expert=p.expert,
                    evict=p.evict,
                    seconds=p.seconds,
                )
            self.events.append(
                {
                    "type": "tier-promotion",
                    "time": now,
                    "layer": p.layer,
                    "server": p.server,
                    "expert": p.expert,
                    "evict": p.evict,
                    "seconds": p.seconds,
                }
            )

    # -- faults --------------------------------------------------------
    def drop_server(self, server: int) -> None:
        """A crash loses every tier on the server (host RAM and modeled
        disk die with the box); in-flight promotions there abort."""
        if self.tier is not None:
            self.tier[:, server, :] = -1
        self._inflight = [p for p in self._inflight if p.server != server]

    # -- metrics -------------------------------------------------------
    def summary(self) -> dict:
        """The ``metrics.tiers`` section of ``bench-serving/v6``."""
        N = self.topology.n
        caps = self.topology.tier_slot_capacities(self.expert_bytes)
        gpu_res = [0] * N
        host_res = [0] * N
        if self.tier is not None:
            gpu_res = (self.tier == TIER_GPU).sum(axis=(0, 2)).tolist()
            host_res = (self.tier > TIER_GPU).sum(axis=(0, 2)).tolist()
        served = self.gpu_hit_tokens + self.fetch_tokens
        hit_ratio = self.gpu_hit_tokens / served if served else 0.0
        return {
            "n_servers": N,
            "per_server_gpu_slots": [int(c[0]) for c in caps],
            "per_server_host_slots": [int(c[2]) for c in caps],
            "per_server_gpu_resident": [int(v) for v in gpu_res],
            "per_server_host_resident": [int(v) for v in host_res],
            "promotions": self.promotions,
            "demotions": self.demotions,
            "prefetch_hit_ratio": round(hit_ratio, 6),
            "on_demand_fetches": self.on_demand_fetches,
            "on_demand_stall_seconds": round(self.on_demand_stall_seconds, 6),
        }
