"""DEPRECATED shim — the global scheduler's review logic now lives in
``repro_torch.core.policies.PlacementController`` and the serving loop in
``repro_torch.serving.runtime.ServingRuntime``.

``GlobalScheduler`` is kept for the legacy batch-clocked API
(``after_batch() -> bool``): it counts served batches, asks the unified
controller to review at the configured cadence, and applies adopted plans
to the engine. New code should construct a ``PlacementController`` plus a
``ServingRuntime`` (single server) or a ``repro_torch.serving.cluster
.EdgeCluster`` (multi-server) and submit typed ``repro_torch.serving.api
.Request`` objects — see serving/README.md ("Serving API v1") for the
migration table. Live adoption is ``PlacementController
.review_and_apply(now, engine)``, the same code path both consumers use."""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np

from repro_torch.core.migration import CostModel
from repro_torch.core.placement import PlacementPlan, build_ep_placement
from repro_torch.core.policies import ClusterView, PlacementController, get_policy
from repro_torch.serving.engine import ServingEngine


@dataclasses.dataclass
class GlobalScheduler:
    engine: ServingEngine
    capacity: np.ndarray  # per-EP-rank slot budget
    cost: CostModel
    interval_batches: int = 8  # review period (batches ~ minutes)
    placement_fn: Callable | None = None  # freqs -> PlacementPlan
    _batches: int = 0

    def __post_init__(self):
        warnings.warn(
            "GlobalScheduler is deprecated: construct a "
            "core.policies.PlacementController plus a "
            "serving.runtime.ServingRuntime instead (see serving/README.md)",
            DeprecationWarning,
            stacklevel=3,
        )  # 3: through the generated dataclass __init__
        spec = self.engine.rt.ep_spec
        cluster = ClusterView(
            capacity=np.asarray(self.capacity),
            slots_cap=np.full(len(self.capacity), spec.slots),
        )
        self.ctrl = PlacementController(
            policy=self.placement_fn
            if self.placement_fn is not None
            else get_policy("dancemoe"),
            cost=self.cost,
            cluster=cluster,
            interval=self.interval_batches,
            stats=self.engine.stats,
        )
        self.events = self.ctrl.events

    @property
    def current_plan(self) -> PlacementPlan | None:
        return self.ctrl.plan

    def after_batch(self) -> bool:
        """Call once per served batch; returns True if a migration ran."""
        self._batches += 1
        if self._batches % self.interval_batches:
            return False
        dec = self.ctrl.review(self._batches, force=True)
        dec.diag["batch"] = self._batches
        if dec.adopted:
            stacked = build_ep_placement(dec.plan, self.engine.rt.ep_spec.slots)
            self.engine.migrate(stacked)
        return dec.adopted
