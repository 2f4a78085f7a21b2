"""The port's numpy-only layers equal the reference exactly: model configs,
placement plans (DanceMoE's Algorithm 1 and every baseline), EP routing
tables and the placement controller's adopt decisions."""

import dataclasses

import numpy as np
import pytest

from repro import configs as jcfg
from repro.core import migration as jmig
from repro.core import placement as jpl
from repro.core import policies as jpol
from repro.core.stats import ActivationStats as JStats
from repro_torch import configs as tcfg
from repro_torch.core import migration as tmig
from repro_torch.core import placement as tpl
from repro_torch.core import policies as tpol
from repro_torch.core.stats import ActivationStats as TStats

POLICIES = ["dancemoe", "uniform", "redundance", "smartmoe", "eplb"]


def _freqs(L, N, E, seed):
    """Seeded per-(layer, server) gating distributions with Zipf skew."""
    rng = np.random.default_rng(seed)
    z = 1.0 / (np.arange(E) + 1.0) ** rng.uniform(0.3, 1.6, (L, N, 1))
    f = np.stack([[z[l, n][rng.permutation(E)] for n in range(N)]
                  for l in range(L)])
    return f / f.sum(-1, keepdims=True)


def _cluster(mod):
    return mod.ClusterView(capacity=np.array([14, 16, 20]),
                           slots_cap=np.array([5, 6, 7]))


def _plan_arrays(plan):
    return [np.asarray(plan.residency()),
            np.asarray(plan.slot_tables(8))]


@pytest.mark.parametrize("name", sorted(jcfg.list_configs()))
def test_config_fields_identical(name):
    a, b = jcfg.get_config(name), tcfg.get_config(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.layer_pattern() == b.layer_pattern()
    assert a.param_count() == b.param_count()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 7])
def test_policy_plans_identical(policy, seed):
    f = _freqs(4, 3, 8, seed)
    pa = jpol.get_policy(policy).propose(f, _cluster(jpol))
    pb = tpol.get_policy(policy).propose(f, _cluster(tpol))
    for x, y in zip(_plan_arrays(pa), _plan_arrays(pb)):
        np.testing.assert_array_equal(x, y)


def test_dancemoe_placement_and_ep_tables_identical():
    f = _freqs(2, 3, 8, 3)
    cap = np.array([8, 10, 12])
    pa = jpl.dancemoe_placement(f, cap)
    pb = tpl.dancemoe_placement(f, cap)
    for x, y in zip(_plan_arrays(pa), _plan_arrays(pb)):
        np.testing.assert_array_equal(x, y)
    ta = jpl.build_ep_placement(pa, slots=6)
    tb = tpl.build_ep_placement(pb, slots=6)
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_controller_decisions_identical():
    """Same stats stream -> same review/adopt sequence, diagnostics and
    plans."""
    L, N, E = 2, 3, 8

    def run(pol, mig, stats_cls):
        cm = mig.CostModel(expert_bytes=50e6, activation_bytes=8192,
                           bandwidth=62.5e6, io_speed=1e9,
                           tokens_per_horizon=1e4)
        ctrl = pol.PlacementController(policy="dancemoe", cost=cm,
                                       cluster=_cluster(pol), interval=2.0,
                                       stats=stats_cls(L, N, E))
        out = []
        rng = np.random.default_rng(11)
        for now in range(12):
            counts = rng.poisson(3.0, (L, N, E)).astype(float)
            counts[:, now % N, (now // 3) % E] += 40.0   # shifting hot spot
            ctrl.observe(counts)
            dec = ctrl.review(float(now))
            out.append((dec.adopted, dec.diag.get("reason"),
                        None if dec.plan is None
                        else dec.plan.residency().tolist()))
        return out, [sorted(e.items()) for e in ctrl.events]

    assert run(jpol, jmig, JStats) == run(tpol, tmig, TStats)
