"""The port's ``EdgeCluster("runtime")`` at n_ep = 3 against the reference's:
the failover scenario of ``tests/md_scripts/failover_runtime.py`` (three
edge servers as three EP ranks of one engine, a DanceMoE controller with a
live review before server 2 crashes) with failover on and off, in shared
and per-server runtime mode, and once without a controller. The reference
runs in a subprocess on 3 fake CPU devices (the test process keeps its
single CPU device) and hands over its weights as npz and its prompts; the
port must give the same token streams, merged event stream, controller
decisions, ``metrics()`` (the wall-time ``perf`` values aside: their keys
must match) and activation counts, exactly. Then checks of the port alone:
replay, page recycling, token identity with ``generate()`` and the
deprecated ``GlobalScheduler``."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tests._torch_parity import (DEAD, LEGS, N_REQUESTS, STEPS,
                                 cluster_record, port_cluster_engine,
                                 run_cluster_leg)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_RUNNER = (
    "import os\n"
    "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=3'\n"
    "import sys\n"
    "from tests._torch_parity import run_reference_cluster\n"
    "run_reference_cluster(sys.argv[1])\n")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(checkpoint path, the reference's prompts and per-leg records)."""
    out = tmp_path_factory.mktemp("cluster_reference")
    # a fixed hash seed fixes the prompts the reference draws (and hands
    # over), so the scenario's own checks below see the same run every time
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               PYTHONHASHSEED="0")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _RUNNER, str(out)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return out / "dense", json.loads((out / "reference.json").read_text())


def _port_leg(reference, failover=True, shared=True, controller=True):
    ckpt, doc = reference
    return run_cluster_leg("repro_torch", port_cluster_engine(ckpt),
                           doc["prompts"], failover=failover, shared=shared,
                           controller=controller)


@pytest.mark.parametrize("leg", range(len(LEGS)), ids=[
    f"{'failover' if f else 'no-failover'}-{'shared' if s else 'per-server'}"
    + ("" if c else "-no-controller") for f, s, c in LEGS])
def test_cluster_matches_reference(reference, leg):
    failover, shared, controller = LEGS[leg]
    want = reference[1]["legs"][leg]
    got = json.loads(json.dumps(cluster_record(*_port_leg(
        reference, failover, shared, controller)), sort_keys=True))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    # the scenario is not degenerate: the crash caught requests in flight
    downs = [e for e in want["events"] if e[0] == "SERVER_DOWN"]
    assert len(downs) == 1 and downs[0][3]["victims"] >= 1
    faults = want["metrics"]["faults"]
    if failover:
        assert all(t is not None and len(t) == STEPS for t in want["tokens"])
        assert faults["recovered"] == 1 and faults["requests_dropped"] == 0
    else:
        assert faults["requests_dropped"] >= 1
        assert sum(t is None for t in want["tokens"]) == \
            faults["requests_dropped"]
    if controller:
        # a live review adopted a plan before the crash, and the crash
        # triggered a fault review
        assert any(e.get("adopted") and e["time"] < downs[0][1]
                   for e in want["controller"])
        assert any(e.get("fault_review") for e in want["controller"]) \
            == failover
    assert want["metrics"]["net"]["cross_server_bytes"] > 0
    assert "warmup_seconds" in want["perf_keys"]


def test_replay_is_bit_identical(reference):
    """The fault-replay contract: the same schedule on an engine rebuilt
    from the same weights gives the same tokens, events and sections."""
    first = cluster_record(*_port_leg(reference))
    again = cluster_record(*_port_leg(reference))
    assert json.dumps(first, sort_keys=True) == json.dumps(again,
                                                            sort_keys=True)


@pytest.mark.parametrize("shared", [True, False], ids=["shared",
                                                       "per-server"])
def test_pages_recycled_after_crash(reference, shared):
    cluster, handles = _port_leg(reference, shared=shared)
    assert all(h.done for h in handles)
    runtimes = cluster.backend.runtimes
    assert len(runtimes) == (1 if shared else 3)
    for rtm in runtimes:
        rtm.check_invariants()
        assert rtm.allocator.n_free == rtm.allocator.capacity_blocks
        assert not rtm.queue and rtm.active == 0 and not rtm._pending
    if not shared:
        # per-server pools sized by each server's KV budget (24 / 24 / 12)
        assert [r.allocator.capacity_blocks for r in runtimes] == [24, 24, 12]


def test_tokens_match_generate(reference):
    """The crash and the re-prefill on a survivor change no output token:
    every stream equals the port's own ``generate()`` of its prompt."""
    ckpt, doc = reference
    _, handles = _port_leg(reference)
    prompts = np.asarray(doc["prompts"], np.int32)
    want, _ = port_cluster_engine(ckpt).generate(prompts, steps=STEPS)
    assert len(handles) == N_REQUESTS
    for h, w in zip(handles, want):
        np.testing.assert_array_equal(h.result(), w)
    assert any(h.server != h.request.origin for h in handles
               if h.request.origin == DEAD)


def test_cluster_perf_is_the_reference_shape(reference):
    cluster, _ = _port_leg(reference)
    perf = cluster.metrics()["perf"]
    assert perf["warmup_seconds"] == 0.0
    assert perf["executables_compiled"] == 0
    assert perf["traces_after_warmup"] == 0
    assert perf["rounds_timed"] > 0 and perf["host_syncs"] > 0
    assert perf["decode_round_ms"]["p50"] > 0


def test_global_scheduler_warns_and_reviews_at_its_cadence(reference):
    from repro_torch.core.migration import CostModel
    from repro_torch.serving.scheduler import GlobalScheduler

    engine = port_cluster_engine(reference[0])
    cfg = engine.rt.cfg
    engine.generate(np.asarray(reference[1]["prompts"], np.int32), steps=2)
    cost = CostModel(expert_bytes=3 * cfg.d_model * cfg.d_ff * 4,
                     activation_bytes=cfg.d_model * 4, bandwidth=62.5e6,
                     tokens_per_horizon=1e5)
    with pytest.warns(DeprecationWarning, match="GlobalScheduler"):
        sched = GlobalScheduler(engine, capacity=np.full(3, 2 * 2),
                                cost=cost, interval_batches=3)
    before = engine.placement
    done = [sched.after_batch() for _ in range(7)]
    assert done[:2] == [False, False] and done[3:5] == [False, False]
    assert [e["batch"] for e in sched.events] == [3, 6]
    assert sched.current_plan is not None
    if any(done):
        assert engine.placement is not before
