"""Unified placement control plane.

Two pieces, consumed identically by the serving stack and the
event-driven simulator:

* ``PlacementPolicy`` — one interface (``propose(freqs, cluster) ->
  PlacementPlan``) over every placement strategy in the repo: the DanceMoE
  pipeline (Algorithms 1+2) and the paper's baselines (Uniform, Redundance,
  SmartMoE, EPLB). Policies are registered by name so launchers, benchmarks
  and the simulator select them with a string.

* ``PlacementController`` — the single owner of the observe -> place ->
  adopt loop: it ingests activation statistics, periodically asks its
  policy for a candidate plan, applies the Eq.-4 adopt decision
  (``should_migrate``), and records migration events. It absorbs the review
  logic that used to be duplicated between ``serving.scheduler
  .GlobalScheduler`` (batch-clocked, serving engine) and ``core.migration
  .MigrationController`` (wall-clock, simulator); both survive as thin
  deprecated shims over this class.

The controller is clock-agnostic: ``now`` is any monotonically increasing
scalar (seconds in the simulator, decode rounds in the serving runtime) and
``interval`` is measured in the same units.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.placement import (PlacementPlan, build_ep_placement,
                                  dancemoe_placement)
from repro_torch.core.stats import ActivationStats


# ---------------------------------------------------------------------------
# Cluster view: what a policy is allowed to know about the hardware
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterView:
    """Capacity summary a placement policy consumes (decoupled from both
    ``ClusterSpec`` and ``EPSpec`` so the same policy object serves the
    simulator and the SPMD runtime)."""
    capacity: np.ndarray                 # [N] total expert-slot budget
    slots_cap: np.ndarray | None = None  # [N] per-(server, layer) slot cap

    @property
    def n(self) -> int:
        return len(self.capacity)

    @staticmethod
    def from_cluster(cluster, profile) -> "ClusterView":
        """From a simulator ``ClusterSpec`` + ``MoEProfile``."""
        cap = cluster.expert_capacity(profile.expert_bytes)
        slots = np.minimum(np.maximum(cap // profile.num_layers, 1),
                           profile.num_experts)
        return ClusterView(capacity=cap, slots_cap=slots)

    @staticmethod
    def from_ep_spec(spec, n_groups: int) -> "ClusterView":
        """From the SPMD runtime's ``EPSpec`` (n_ep ranks x S slots over
        ``n_groups`` MoE layers)."""
        return ClusterView(
            capacity=np.full(spec.n_ep, spec.slots * n_groups),
            slots_cap=np.full(spec.n_ep, spec.slots))

    @staticmethod
    def from_topology(topology, profile, tiered: bool = False
                      ) -> "ClusterView":
        """From a ``repro_torch.serving.net.Topology`` + ``MoEProfile``: each
        server's expert budget comes from its own :class:`ServerProfile`
        memory cap (the heterogeneous analogue of ``from_cluster``).

        ``tiered=True`` budgets each server at its *deepest* expert tier
        (host RAM / modeled disk) instead of its GPU memory, so Algorithm
        1 may legally assign more experts than the GPU holds — the
        ``repro_torch.serving.tiers.TierManager`` decides which subset is
        GPU-resident at any moment."""
        if tiered:
            cap = topology.tiered_expert_budgets(profile.expert_bytes)
        else:
            cap = topology.expert_budgets(profile.expert_bytes)
        slots = np.minimum(np.maximum(cap // profile.num_layers, 1),
                           profile.num_experts)
        return ClusterView(capacity=cap, slots_cap=slots)


# ---------------------------------------------------------------------------
# Policy protocol + registry
# ---------------------------------------------------------------------------

@runtime_checkable
class PlacementPolicy(Protocol):
    """What every placement strategy implements: a pure function from
    observed activation statistics + cluster budgets to a plan."""

    def propose(self, freqs: np.ndarray,
                cluster: ClusterView) -> PlacementPlan:
        """freqs: [L, N, E] normalized activation frequencies."""
        ...


_REGISTRY: dict[str, type] = {}


def register_policy(name: str):
    """Class decorator: register a policy under ``name`` (its
    ``get_policy`` / ``as_policy`` lookup key) and set ``cls.name``."""
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_policy(name: str, **kwargs) -> PlacementPolicy:
    """Instantiate the registered policy ``name`` (kwargs go to its
    constructor); raises ``KeyError`` listing the known names."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown placement policy {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_policies() -> tuple[str, ...]:
    """All registered policy names, sorted."""
    return tuple(sorted(_REGISTRY))


@register_policy("dancemoe")
@dataclasses.dataclass
class DanceMoEPolicy:
    """Algorithm 1 + Algorithm 2 (+ spare-slot replication)."""
    fill_spare: bool = True

    def propose(self, freqs, cluster):
        return dancemoe_placement(freqs, cluster.capacity,
                                  cluster.slots_cap,
                                  fill_spare=self.fill_spare)


@register_policy("uniform")
@dataclasses.dataclass
class UniformPolicy:
    """Megatron-style expert parallelism: expert e on server e % N."""

    def propose(self, freqs, cluster):
        from repro_torch.core.baselines import uniform_plan
        L, N, E = freqs.shape
        return uniform_plan(L, N, E, cluster.capacity, cluster.slots_cap)


@register_policy("redundance")
@dataclasses.dataclass
class RedundancePolicy:
    """Uniform coverage + random duplication up to capacity."""
    seed: int = 0

    def propose(self, freqs, cluster):
        from repro_torch.core.baselines import redundance_plan
        L, N, E = freqs.shape
        return redundance_plan(L, N, E, cluster.capacity, cluster.slots_cap,
                               seed=self.seed)


@register_policy("smartmoe")
@dataclasses.dataclass
class SmartMoEPolicy:
    """SmartMoE [ATC'23]-style workload-balanced placement."""

    def propose(self, freqs, cluster):
        from repro_torch.core.baselines import smartmoe_plan
        return smartmoe_plan(freqs, cluster.capacity, cluster.slots_cap)


@register_policy("eplb")
@dataclasses.dataclass
class EPLBPolicy:
    """DeepSeek-V3 Expert Parallelism Load Balancer."""

    def propose(self, freqs, cluster):
        from repro_torch.core.baselines import eplb_plan
        return eplb_plan(freqs, cluster.capacity, cluster.slots_cap)


@dataclasses.dataclass
class FnPolicy:
    """Adapter: a bare ``freqs -> PlacementPlan`` callable as a policy
    (the legacy ``placement_fn`` convention)."""
    fn: Callable[[np.ndarray], PlacementPlan]
    name: str = "fn"

    def propose(self, freqs, cluster):
        return self.fn(freqs)


def as_policy(policy) -> PlacementPolicy:
    """Normalize: policy object | registered name | bare callable."""
    if isinstance(policy, str):
        return get_policy(policy)
    if hasattr(policy, "propose"):
        return policy
    if callable(policy):
        return FnPolicy(policy)
    raise TypeError(f"not a placement policy: {policy!r}")


# ---------------------------------------------------------------------------
# The controller: observe -> place -> adopt (Eq. 4) -> record
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlacementDecision:
    """One review's outcome: the candidate ``plan``, whether Eq. (4)
    ``adopted`` it, and the pricing diagnostics (``diag``: modeled costs
    in seconds, or ``{"infeasible": ...}`` when Algorithm 1 had no
    feasible assignment)."""

    plan: PlacementPlan
    adopted: bool
    diag: dict
    applied: bool = False     # set by review_and_apply when the adopted
    #                           plan was actually pushed into an engine
    staged: bool = False      # adopted but still transferring over the
    #                           modeled links; ``plan`` is the incumbent


@dataclasses.dataclass
class PlacementController:
    """Single system-wide placement brain (paper Fig. 4, left).

    ``review(now, freqs)`` runs at most once per ``interval`` of the
    caller's clock: it asks the policy for a candidate plan and adopts it
    iff Eq. (4) holds (``C(P') + T_mig < C(P)``). The first review always
    adopts (there is no incumbent to defend) and records an
    ``{"reason": "initial"}`` event — the one code path for what
    ``GlobalScheduler`` and ``MigrationController`` previously each
    implemented with different bookkeeping.

    ``cost=None`` disables the Eq.-4 gate (every review adopts) — useful
    for always-follow policies in ablations.

    **Staged migration** (``topology=`` a ``repro_torch.serving.net.Topology``):
    adopting a plan no longer switches it instantly. The changed experts
    become per-link transfer tasks (serialized per link, overlapped with
    serving — ``net.plan_transfers``/``schedule_transfers``); the
    candidate sits in ``pending`` until ``poll(now)`` observes the
    schedule's makespan elapsed, and only then does ``plan`` change.
    Reviews pause while a migration is in flight. ``clock_rate`` converts
    modeled transfer *seconds* into the caller's clock units (seconds per
    tick; the simulator's seconds clock keeps the default 1.0). The
    initial adoption (no incumbent → nothing to transfer off a live
    server) stays instantaneous.
    """
    policy: PlacementPolicy | Callable | str
    cost: "CostModel | None" = None          # repro_torch.core.migration.CostModel
    #                                          or repro_torch.serving.net
    #                                          .CommCostModel (link-aware)
    cluster: ClusterView | None = None
    interval: float = 300.0                  # caller clock units between
    #                                          reviews: seconds on the sim
    #                                          clock, decode rounds (ticks)
    #                                          on the runtime clock
    stats: ActivationStats | None = None
    plan: PlacementPlan | None = None
    last_review: float | None = None
    events: list = dataclasses.field(default_factory=list)
    topology: "object | None" = None         # repro_torch.serving.net.Topology
    clock_rate: float = 1.0                  # seconds per caller clock unit
    expert_bytes: float | None = None        # transfer sizing fallback when
    #                                          cost= carries no expert_bytes
    pending: "object | None" = None          # net.StagedMigration in flight
    tiers: "object | None" = None            # serving.tiers.TierManager —
    #                                          rebinds tier residency on
    #                                          every plan switch
    tracer: "object | None" = None           # serving.obs.Tracer — every
    #                                          events record doubles as a
    #                                          PLACEMENT_REVIEW instant
    #                                          (full Eq.-4 diag) and staged
    #                                          transfers as TRANSFER_TASK
    #                                          spans; duck-typed so core
    #                                          stays import-free of serving

    def __post_init__(self):
        self.policy = as_policy(self.policy)

    def _record(self, diag: dict) -> None:
        """The one decision-record point: append to ``events`` and mirror
        the full diag (reason, adopted, Eq.-4 cost numbers, staging
        payload) as a control-plane ``PLACEMENT_REVIEW`` trace instant."""
        self.events.append(diag)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant("PLACEMENT_REVIEW", diag.get("time", 0.0),
                                **{k: v for k, v in diag.items()
                                   if k != "time"})

    def _set_plan(self, plan: PlacementPlan) -> None:
        """The one plan-switch point: every adoption path (instant,
        staged completion, fault review) funnels through here so an
        attached :class:`~repro_torch.serving.tiers.TierManager` re-splits the
        new assignments across its tiers in lockstep."""
        self.plan = plan
        if self.tiers is not None:
            self.tiers.bind(plan)

    def _expert_bytes(self) -> float:
        b = self.expert_bytes
        if b is None:
            b = getattr(self.cost, "expert_bytes", None)
        if b is None:
            raise ValueError(
                "staged migration needs the expert weight size: pass "
                "expert_bytes= (or a cost model carrying it) alongside "
                "topology=")
        return float(b)

    def attach_topology(self, topology=None, expert_bytes=None):
        """Reconcile a caller-supplied topology with this controller's —
        the one code path behind ``EdgeCluster``, ``EdgeSimulator`` and
        the runtime backend: adopt the caller's topology when the
        controller has none, hand the controller's back when the caller
        has none, and default the staged-transfer sizing when neither
        ``expert_bytes`` nor the cost model carries it yet. Returns the
        topology in effect."""
        if topology is None:
            topology = self.topology
        elif self.topology is None:
            self.topology = topology
        elif self.topology is not topology:
            # two divergent link models in one run (metering on one,
            # staging/Eq.-4 on the other) would disagree silently
            raise ValueError(
                "controller already has a different topology attached; "
                "share one Topology object between the controller and "
                "the cluster")
        if (self.topology is not None and expert_bytes is not None
                and self.expert_bytes is None
                and getattr(self.cost, "expert_bytes", None) is None):
            self.expert_bytes = float(expert_bytes)
        return topology

    # -- stats ingestion ---------------------------------------------------
    def observe(self, layer_counts: np.ndarray) -> None:
        """layer_counts: [L, N, E] activation counts (serving engine path)."""
        self._stats().update(np.asarray(layer_counts, np.float64))

    def observe_server(self, server: int, layer_counts: np.ndarray) -> None:
        """layer_counts: [L, E] counts for one server (simulator path)."""
        self._stats().update_server(server, layer_counts)

    def freqs(self) -> np.ndarray:
        return self._stats().freqs()

    def _stats(self) -> ActivationStats:
        if self.stats is None:
            raise ValueError(
                "PlacementController has no ActivationStats attached; pass "
                "stats= at construction or supply freqs= to review()")
        return self.stats

    # -- review ------------------------------------------------------------
    def _effective_cluster(self) -> ClusterView | None:
        """The policy's capacity view minus crashed servers: a dead
        server's expert budget is 0, so no candidate plan places anything
        there. With every server up (or no topology) this is ``cluster``
        itself, so fault-free behavior is bit-identical."""
        cv = self.cluster
        if cv is None or self.topology is None:
            return cv
        up = np.asarray(self.topology.state.up)
        if up.all():
            return cv
        slots = (None if cv.slots_cap is None
                 else np.where(up, cv.slots_cap, 0))
        return ClusterView(capacity=np.where(up, cv.capacity, 0),
                           slots_cap=slots)

    def propose(self, freqs: np.ndarray) -> PlacementPlan:
        return self.policy.propose(freqs, self._effective_cluster())

    def review_due(self, now: float) -> bool:
        if self.pending is not None:        # one migration in flight at a
            return False                    # time; reviews resume after it
        return (self.last_review is None
                or now - self.last_review >= self.interval)

    def _stage(self, now: float, candidate: PlacementPlan):
        """Turn an adopted candidate into an in-flight staged migration
        (returns it; ``poll`` completes it). No transfers needed → adopt
        instantly and return None."""
        from repro_torch.serving import net as _net
        tasks = _net.plan_transfers(self.plan, candidate, self.topology,
                                    self._expert_bytes())
        if not tasks:
            self._set_plan(candidate)
            return None
        seconds = _net.schedule_transfers(tasks, self.topology)
        _net.trace_transfers(self.tracer, tasks, now, self.clock_rate)
        staged = _net.StagedMigration(
            plan=candidate, tasks=tasks, started=now,
            eta=now + seconds / self.clock_rate, seconds=seconds)
        self.pending = staged
        return staged

    def review(self, now: float, freqs: np.ndarray | None = None, *,
               force: bool = False) -> PlacementDecision:
        """One control-loop tick. Returns the (possibly unchanged) active
        plan; ``adopted`` says whether a migration was decided at this
        tick (with a topology attached, the switch itself lands later —
        see ``poll``)."""
        if self.pending is not None:
            # one migration in flight at a time — even a forced review
            # must not overwrite the pending plan (its transfers would be
            # dropped mid-flight and MIGRATION_COMPLETED never emitted)
            return PlacementDecision(self.plan, False,
                                     {"reason": "migration-in-flight"})
        if not force and not self.review_due(now):
            return PlacementDecision(self.plan, False, {"reason": "interval"})
        if freqs is None:
            freqs = self.freqs()
        self.last_review = now
        candidate = self.propose(freqs)
        if self.plan is None:
            adopt, diag = True, {"reason": "initial"}
        elif self.cost is None:
            adopt, diag = True, {"reason": "no-cost-model"}
        else:
            from repro_torch.core.migration import should_migrate
            adopt, diag = should_migrate(self.plan, candidate, freqs,
                                         self.cost)
        diag = dict(diag)
        diag["time"] = now
        diag["adopted"] = adopt
        staged = None
        if adopt:
            if self.plan is not None and self.topology is not None:
                staged = self._stage(now, candidate)
                if staged is not None:
                    diag["staged"] = True
                    diag["eta"] = staged.eta
                    diag["transfers"] = len(staged.tasks)
                    diag["transfer_seconds"] = staged.seconds
                    diag["transfer_bytes"] = staged.nbytes
            else:
                self._set_plan(candidate)
        self._record(diag)
        return PlacementDecision(self.plan, adopt, diag,
                                 staged=staged is not None)

    # -- fault handling ----------------------------------------------------
    def pending_affected(self) -> bool:
        """True when the in-flight staged migration can no longer complete
        as scheduled: a transfer task's source or destination server died,
        or an inter-server task's link degraded after the schedule was
        priced (its eta is now a lie). Such a migration must be aborted
        and re-planned, never completed on a ghost server."""
        p = self.pending
        if p is None or self.topology is None:
            return False
        st = self.topology.state
        for t in p.tasks:
            if not st.up[t.src] or not st.up[t.dst]:
                return True
            if t.src != t.dst and st.bw_factor[t.src, t.dst] < 1.0:
                return True
        return False

    def abort_pending(self, now: float, cause: str = "fault"):
        """Drop the in-flight staged migration (its transfers are lost;
        the incumbent plan stays active) and record a
        ``migration-aborted`` event. Returns the aborted
        ``net.StagedMigration`` (or None when nothing was pending)."""
        p = self.pending
        if p is None:
            return None
        self.pending = None
        self._record({
            "reason": "migration-aborted", "time": now, "adopted": False,
            "abort_cause": cause, "staged_at": p.started, "eta": p.eta,
            "transfers": len(p.tasks), "transfer_seconds": p.seconds,
            "transfer_bytes": p.nbytes,
        })
        return p

    def fault_review(self, now: float, freqs: np.ndarray | None = None, *,
                     cause: str = "fault") -> PlacementDecision:
        """Immediate, ungated re-placement after a capacity-changing
        fault. Unlike ``review(force=True)`` this (a) aborts any pending
        migration first — its candidate was computed against the
        pre-fault fabric — and (b) skips the Eq.-4 gate: after a crash
        the incumbent references capacity that no longer exists, so
        ``should_migrate`` would be defending a ghost. The candidate is
        proposed against the liveness-masked capacity view and staged
        over the surviving links as usual."""
        if self.pending is not None:
            self.abort_pending(now, cause=cause)
        if freqs is None:
            freqs = self.freqs()
        self.last_review = now
        try:
            candidate = self.propose(freqs)
        except RuntimeError as e:
            # the surviving capacity cannot cover every expert (Algorithm
            # 1 coverage is infeasible): keep the incumbent plan rather
            # than crash the control plane mid-failover — the uncovered
            # experts stay unservable until capacity returns
            diag = {"reason": cause, "time": now, "adopted": False,
                    "fault_review": True, "infeasible": str(e)}
            self._record(diag)
            return PlacementDecision(self.plan, False, diag, staged=False)
        diag = {"reason": cause, "time": now, "adopted": True,
                "fault_review": True}
        staged = None
        if self.plan is not None and self.topology is not None:
            staged = self._stage(now, candidate)
            if staged is not None:
                diag["staged"] = True
                diag["eta"] = staged.eta
                diag["transfers"] = len(staged.tasks)
                diag["transfer_seconds"] = staged.seconds
                diag["transfer_bytes"] = staged.nbytes
        else:
            self._set_plan(candidate)
        self._record(diag)
        return PlacementDecision(self.plan, True, diag,
                                 staged=staged is not None)

    def poll(self, now: float):
        """Complete the in-flight staged migration once its modeled
        transfers have finished: the pending plan becomes the active plan
        and a ``migration-complete`` event is recorded. Returns the
        completed ``net.StagedMigration`` (or ``None``: nothing pending,
        or transfers still running)."""
        p = self.pending
        if p is None or now < p.eta:
            return None
        self.pending = None
        self._set_plan(p.plan)
        self._record({
            "reason": "migration-complete", "time": now, "adopted": False,
            "staged_at": p.started, "eta": p.eta,
            "transfers": len(p.tasks), "transfer_seconds": p.seconds,
            "transfer_bytes": p.nbytes,
        })
        return p

    def _mesh_distance(self, engine):
        """Topology-derived nearest-replica distance matrix for the
        engine's EP routing tables, when the topology maps 1:1 onto the
        EP ranks (else the default ring distance applies)."""
        if self.topology is None:
            return None
        n_ep = engine.rt.ep_spec.n_ep
        if self.topology.n != n_ep:
            return None
        if hasattr(self.cost, "invocation_seconds"):
            return self.cost.invocation_seconds()
        return self.topology.distance()

    def _apply_plan(self, engine) -> bool:
        """Push the active plan into a serving engine (EP slot re-gather
        + table swap); returns False for engines without EP placement.
        With a :class:`TierManager` attached, GPU-tier experts fill the
        engine's physical slots first (back-tier assignments overflow the
        slot budget and are served via fetch/remote instead)."""
        if getattr(engine.rt, "ep_spec", None) is None:
            return False
        priority = (self.tiers.slot_priority()
                    if self.tiers is not None else None)
        engine.migrate(build_ep_placement(
            self.plan, engine.rt.ep_spec.slots,
            mesh_distance=self._mesh_distance(engine),
            priority=priority))
        return True

    def fault_review_and_apply(self, now: float, engine, *,
                               cause: str = "fault") -> PlacementDecision:
        """``fault_review`` + immediate engine apply when the adopted
        plan is not staged (the runtime-backend analogue of
        ``review_and_apply`` for the fault path)."""
        dec = self.fault_review(now, cause=cause)
        if dec.adopted and not dec.staged:
            dec.applied = self._apply_plan(engine)
        return dec

    def review_and_apply(self, now: float, engine) -> PlacementDecision | None:
        """Review on the caller's clock and apply an adopted plan to a
        serving engine (EP slot re-gather + table swap via
        ``engine.migrate``). The one code path behind both the
        ``ServingRuntime`` decode-round clock and the ``EdgeCluster``
        façade's tick clock. With a topology attached, an adopted plan is
        *staged* first and pushed into the engine only on the later call
        whose ``now`` has passed the transfer schedule's makespan.
        Returns the decision when a review ran or a staged migration
        completed, ``None`` otherwise."""
        completed = self.poll(now)
        if completed is not None:
            dec = PlacementDecision(self.plan, True, dict(self.events[-1]))
            dec.applied = self._apply_plan(engine)
            return dec
        if not self.review_due(now):
            return None
        dec = self.review(now)
        if dec.adopted and not dec.staged:
            dec.applied = self._apply_plan(engine)  # callers log migrations
            #                                         off this flag
        return dec

    @property
    def migrations(self) -> list:
        """Adopted non-initial reviews (actual placement changes)."""
        return [e for e in self.events
                if e["adopted"] and e.get("reason") != "initial"]
