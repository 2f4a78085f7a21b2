"""The port's warmed zero-stall serving loop on the CPU, against the
reference's (``tests/test_warmup.py``) and against the port's synchronous
loop: the reduced Mixtral over the reference's weights, block 8, 4 slots.
Every comparison is exact (tokens, ticks, counts, weights). On the CPU
there are no CUDA graphs: the warmed loop runs the eager steps through the
same one-tick-late backlog; ``tests/test_torch_cuda.py`` holds the graph
ladder on the card."""

import numpy as np
import pytest
import torch

from repro.serving.api import EventType as JEventType
from repro.serving.api import Request as JRequest
from repro.serving.runtime import ServingRuntime as JRuntime
from repro_torch.configs import get_config as tget_config
from repro_torch.core.placement import PlacementPlan, build_ep_placement
from repro_torch.launch.serve import build_engine
from repro_torch.models import moe as TM
from repro_torch.serving import graphs
from repro_torch.serving.api import EventType, Request
from repro_torch.serving.runtime import ServingRuntime
from tests._torch_parity import build_pair, prompts, run_cluster_leg

SLOTS, BLOCK = 4, 8


@pytest.fixture(scope="module")
def pair():
    return build_pair("mixtral-8x7b", "ep", max_len=64)


def _stream(vocab):
    """The reference's occupancy stream: four staggered arrivals (prompts
    of 8 and 16 tokens, 3-9 new tokens) through buckets 1 -> 2 -> 4, a
    drain to one slot, then three more requests (refill 1 -> 4)."""
    wave = [prompts(vocab, 1, 8 + 8 * (k % 2), seed=k)[0] for k in range(4)]
    refill = list(prompts(vocab, 3, 16, seed=10))
    return wave, refill


def _serve(rtm, vocab, request=Request, check=False):
    """Drive the stream on ``rtm``; returns the handles in submit order."""
    wave, refill = _stream(vocab)
    handles = []
    for k, p in enumerate(wave):
        handles.append(rtm.enqueue(request(prompt=p, max_new_tokens=3 + 2 * k)))
        rtm.step()
        if check:
            rtm.check_invariants()
    while rtm.active > 1:
        rtm.step()
    handles += [rtm.enqueue(request(prompt=p, max_new_tokens=4))
                for p in refill]
    while rtm.queue or rtm.active or rtm._pending:
        rtm.step()
        if check:
            rtm.check_invariants()
    rtm.flush()
    return handles


def _record(rtm, handles, token, finished):
    """Tokens, finish ticks and the ticks of the TOKEN and FINISHED events
    of every request."""
    return [(h.result().tolist(), rtm.finished_at[h.rid],
             [(e.type, e.time) for e in h.events
              if e.type in (token, finished)]) for h in handles]


def _rtm(engine, **kw):
    return ServingRuntime(engine, max_slots=SLOTS, block_size=BLOCK, **kw)


def test_warm_tokens_match_sync_loop(pair):
    """Exact: the same token streams; the pool invariants hold every
    tick."""
    _, teng = pair
    vocab = teng.rt.cfg.vocab_size
    sync = _serve(_rtm(teng), vocab)
    rtm = _rtm(teng, warmup=True, warmup_origins="untagged")
    warm = _serve(rtm, vocab, check=True)
    assert [h.result().tolist() for h in warm] == \
        [h.result().tolist() for h in sync]
    assert all(h.done for h in warm)
    assert rtm.max_concurrency == SLOTS   # every bucket width was used
    rtm.drop_prefix_cache()
    assert rtm.allocator.n_free == rtm.allocator.capacity_blocks


def test_warm_matches_reference_warm_loop(pair):
    """Exact: the port's warmed loop gives the reference's warmed loop's
    tokens, finish ticks and TOKEN / FINISHED event ticks."""
    jeng, teng = pair
    vocab = teng.rt.cfg.vocab_size
    jrt = JRuntime(jeng, max_slots=SLOTS, block_size=BLOCK, warmup=True,
                   warmup_origins="untagged")
    want = _record(jrt, _serve(jrt, vocab, JRequest), JEventType.TOKEN,
                   JEventType.FINISHED)
    rtm = _rtm(teng, warmup=True, warmup_origins="untagged")
    got = _record(rtm, _serve(rtm, vocab), EventType.TOKEN,
                  EventType.FINISHED)
    assert got == want
    assert rtm.rounds == jrt.rounds and rtm.ticks == jrt.ticks


def test_warmup_off_unchanged(pair):
    """warmup=False keeps the synchronous loop: no backlog forms, every
    round pays one host sync, the eager-step counter does not move."""
    _, teng = pair
    rtm = _rtm(teng)
    h = rtm.enqueue(Request(prompt=prompts(teng.rt.cfg.vocab_size, 1, 16,
                                           seed=3)[0], max_new_tokens=4))
    rtm.step()
    assert not rtm._pending
    rtm.run()
    assert h.done and len(h.tokens) == 4
    assert not rtm._pending
    assert rtm.warmup is False and rtm.executables_compiled == 0
    assert rtm.host_syncs >= rtm.rounds > 0
    assert rtm.traces_after_warmup == 0


def test_warmup_requires_paged_pool(pair):
    _, teng = pair
    with pytest.raises(ValueError, match="paged"):
        ServingRuntime(teng, max_slots=2, paged=False, warmup=True)


def test_cpu_counters_mean_what_the_docstring_says(pair):
    """No graph on the CPU: nothing captured, no warmup time, every step
    (chunk call, decode round, block clone) eager and counted, no drain
    waits; the backlog lags the drain by one tick."""
    _, teng = pair
    vocab = teng.rt.cfg.vocab_size
    rtm = _rtm(teng, warmup=True, warmup_origins="both")
    assert rtm.executables_compiled == 0 and rtm.warmup_seconds == 0.0
    assert rtm.traces_after_warmup == 0
    p = prompts(vocab, 1, 12, seed=4)[0]
    first = rtm.enqueue(Request(prompt=p, max_new_tokens=3))
    rtm.step()                       # the whole prompt in one chunk ...
    assert rtm._pending and len(first.tokens) == 0   # ... drained next tick
    rtm.run()
    # an identical prompt: a full prefix hit clones the shared tail block
    again = rtm.enqueue(Request(prompt=p, max_new_tokens=3))
    rtm.run()
    assert again.result().tolist() == first.result().tolist()
    assert rtm.cow_copies == 1
    assert rtm.traces_after_warmup == (rtm.prefill_calls + rtm.rounds
                                       + rtm.cow_copies)
    assert rtm.host_syncs == 0
    perf = rtm.perf_metrics()
    assert perf["executables_compiled"] == 0
    assert perf["traces_after_warmup"] == rtm.traces_after_warmup


@pytest.mark.parametrize("origins,n", [("untagged", 7), ("tagged", 7),
                                       ("both", 13)])
def test_ladder_enumeration(origins, n):
    """The reference's count at max_slots 4: widths {1, 2, 4} x {chunk,
    dec} x the origin modes, plus the block clone; 12 slots add 8."""
    keys = graphs.ladder_keys(4, origins)
    assert len(keys) == n == len(set(keys))
    assert keys[-1] == ("copy",)
    assert graphs.ladder_widths(4) == [1, 2, 4]
    assert graphs.ladder_widths(12) == [1, 2, 4, 8, 12]
    assert len(graphs.ladder_keys(12, "tagged")) == 11


def test_input_layout_packs_every_input():
    """The packed static inputs round-trip: each view reads back what
    ``pack`` wrote, float masks bit for bit."""
    for kind, tagged in (("chunk", True), ("dec", False)):
        layout = graphs.input_layout(kind, 2, BLOCK, 3, tagged)
        rng = np.random.default_rng(0)
        arrays = {name: (rng.random(shape).astype(np.float32)
                         if dtype == torch.float32 else
                         rng.integers(0, 99, shape).astype(np.int32))
                  for name, (_, shape, dtype) in layout.items()}
        buf = np.zeros(graphs.layout_size(layout), np.int32)
        graphs.pack(layout, arrays, buf)
        views = graphs.input_views(torch.from_numpy(buf), layout)
        assert set(views) == set(arrays)
        for name, a in arrays.items():
            np.testing.assert_array_equal(views[name].numpy(), a)


def test_migrate_is_in_place(pair):
    """Exact: ``migrate`` keeps every slot weight's and placement table's
    storage, and the new values equal a fresh ``regather_ep_groups``."""
    _, teng = pair
    cfg = teng.rt.cfg
    E, S = cfg.num_experts, teng.rt.ep_spec.slots
    _, G = cfg.layer_pattern()
    ptrs = [t.data_ptr() for t in teng.placement] + [
        teng.params["groups"]["b1"][n].data_ptr() for n in ("w1", "w3", "w2")]
    before = teng.placement
    try:
        plan = PlacementPlan(assign=[[list(range(E))[::-1]] for _ in range(G)],
                             counts=np.full((G, 1), E), num_experts=E)
        new_pl = build_ep_placement(plan, S)
        teng.migrate(new_pl)
        assert teng.placement is not before   # identity caches refresh
        assert [t.data_ptr() for t in teng.placement] + [
            teng.params["groups"]["b1"][n].data_ptr()
            for n in ("w1", "w3", "w2")] == ptrs
        for got, want in zip(teng.placement, new_pl):
            np.testing.assert_array_equal(got.numpy(), want)
        fresh = TM.regather_ep_groups(teng.dense_master, new_pl, G)
        for n in ("w1", "w3", "w2"):
            assert torch.equal(teng.params["groups"]["b1"][n],
                               fresh["b1"][n])
        with pytest.raises(ValueError, match="shape"):
            teng.migrate(TM.placement_from_tables(
                new_pl.slot_to_expert[0], num_experts=E))
    finally:   # the module's engine goes back to the uniform layout
        teng.migrate(build_ep_placement(PlacementPlan(
            assign=[[list(range(E))] for _ in range(G)],
            counts=np.full((G, 1), E), num_experts=E), S))


def test_cluster_warm_matches_sync():
    """Exact: ``EdgeCluster`` at n_ep = 3 (the failover scenario, a crash
    of server 2) serves the same tokens with the warmed runtime as with the
    synchronous one, to the same victims, nothing dropped. (The faults
    section's tokens lost and recovery time may differ: the warmed loop
    emits each token a tick later.)"""
    cfg = tget_config("mixtral-8x7b").reduced()
    src = np.random.default_rng(11)
    ps = [src.integers(0, cfg.vocab_size, 16).astype(np.int32)
          for _ in range(6)]
    out = {}
    for warm in (False, True):
        engine, _ = build_engine(cfg, device="cpu", dtype=torch.float32,
                                 max_len=48, policy="dancemoe",
                                 review_rounds=1000, n_ep=3, slots=2, seed=2)
        cluster, handles = run_cluster_leg(
            "repro_torch", engine, ps, failover=True, shared=True,
            runtime_opts=dict(warmup=True, warmup_origins="tagged")
            if warm else None)
        down = [e.data for e in cluster.events if e.type == "SERVER_DOWN"]
        out[warm] = ([h.result().tolist() for h in handles],
                     [h.rid for h in handles if h.server != h.request.origin],
                     cluster.metrics()["faults"]["requests_dropped"],
                     [(d["victims"], d["reassigned"]) for d in down])
        if warm:
            perf = cluster.metrics()["perf"]
            assert perf["executables_compiled"] == 0
            assert perf["traces_after_warmup"] > 0   # eager on the CPU
    assert out[True] == out[False]
    assert out[True][2] == 0 and out[True][3][0][0] > 0


def test_fill_counts_equal_bincount_under_saturation():
    """Exact: the fixed-shape per-slot fill equals the host-syncing
    ``bincount`` over the kept rows, with capacity drops and unrouted
    rows."""
    rng = np.random.default_rng(1)
    S, C2 = 5, 3
    for _ in range(20):
        keys = torch.from_numpy(rng.integers(0, S + 1, 40))
        order, pos, keep = TM._bucket(keys, S, C2)
        sk = keys[order]
        want = torch.bincount(sk[keep], minlength=S + 1)[:S].to(torch.int32)
        got = TM._slot_fill(sk, keep, S)
        assert torch.equal(got, want)
        assert int((~keep & (sk < S)).sum()) > 0   # drops happened
