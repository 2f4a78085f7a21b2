"""Lightweight expert migration (Sec. III-C.3).

Eq. (3): T_mig(P, P') = sum over changed placement entries of m_e / speed.
Eq. (4): adopt P' iff  C(P') + T_mig(P, P') < C(P),
where C(.) converts the Eq.-2 proxy (expected remote invocations) into
seconds using the measured per-invocation remote cost and the request rate
over the evaluation horizon — exactly the paper's "historical communication
and computation time as estimation metrics".
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import (PlacementPlan, iter_added_experts,
                                  remote_cost)


@dataclasses.dataclass
class CostModel:
    """Converts proxy-objective units into seconds."""
    expert_bytes: float                 # m_e
    activation_bytes: float             # hidden-state transfer per invocation
    bandwidth: float                    # bytes/s between servers
    io_speed: np.ndarray | float = 1e9  # per-server weight-load bytes/s
    per_call_overhead: float = 1e-3     # network round-trip + queuing (s)
    tokens_per_horizon: float = 1e4     # expected token-layer invocations
                                        # until the next placement review

    def remote_invocation_time(self) -> float:
        return (2.0 * self.activation_bytes / self.bandwidth
                + self.per_call_overhead)

    def comm_cost_seconds(self, plan: PlacementPlan,
                          freqs: np.ndarray) -> float:
        """C(P) in seconds over the horizon (Eq. 2 × cost/invocation)."""
        return (remote_cost(plan, freqs) / freqs.shape[0]
                * self.tokens_per_horizon * self.remote_invocation_time())


def migration_time(old: PlacementPlan, new: PlacementPlan,
                   cost: CostModel) -> float:
    """Eq. (3): bytes moved / IO speed, per changed placement entry."""
    speeds = np.broadcast_to(np.asarray(cost.io_speed, float),
                             (len(new.assign[0]),))
    return sum(cost.expert_bytes / speeds[n]
               for _, n, _ in iter_added_experts(old, new))


def should_migrate(old: PlacementPlan, new: PlacementPlan,
                   freqs: np.ndarray, cost: CostModel
                   ) -> tuple[bool, dict]:
    """Eq. (4) decision. Returns (adopt?, diagnostics).

    ``cost`` may be this module's uniform :class:`CostModel` or any object
    with the same ``comm_cost_seconds`` surface; a cost model that also
    provides ``migration_seconds(old, new)`` (the link-aware
    ``repro_torch.serving.net.CommCostModel`` prices the staged transfer
    schedule's makespan) overrides the uniform Eq.-3 estimate."""
    c_old = cost.comm_cost_seconds(old, freqs)
    c_new = cost.comm_cost_seconds(new, freqs)
    if hasattr(cost, "migration_seconds"):
        t_mig = cost.migration_seconds(old, new)
    else:
        t_mig = migration_time(old, new, cost)
    return c_new + t_mig < c_old, {
        "C_old": c_old, "C_new": c_new, "T_mig": t_mig,
        "gain": c_old - c_new - t_mig,
    }


def _placement_controller():
    # deferred import: policies imports should_migrate from this module
    from repro_torch.core.policies import PlacementController
    return PlacementController


class MigrationController:
    """DEPRECATED shim — use ``repro_torch.core.policies.PlacementController``.

    Kept for the legacy ``maybe_migrate(now, freqs) -> (plan, adopted)``
    API; all review/adopt logic lives in the unified controller."""

    def __init__(self, placement_fn, cost: CostModel,
                 interval: float = 300.0):
        import warnings
        warnings.warn(
            "MigrationController is deprecated: use "
            "core.policies.PlacementController (review(now, freqs)) instead",
            DeprecationWarning, stacklevel=2)
        self.ctrl = _placement_controller()(
            policy=placement_fn, cost=cost, interval=interval)

    @property
    def current(self) -> PlacementPlan | None:
        return self.ctrl.plan

    @property
    def history(self) -> list:
        """Non-initial review diagnostics (legacy semantics: the initial
        adoption was never recorded here)."""
        return [e for e in self.ctrl.events if e.get("reason") != "initial"]

    def maybe_migrate(self, now: float, freqs: np.ndarray
                      ) -> tuple[PlacementPlan, bool]:
        dec = self.ctrl.review(now, freqs)
        return dec.plan, dec.adopted
