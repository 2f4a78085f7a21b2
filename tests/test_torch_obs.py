"""The port's tracer on the runtime backend, on the CPU: a traced
``EdgeCluster("runtime")`` of three virtual EP ranks over a small MoE
records its ticks on the wall clock as nested spans (``STEP`` holding
``ADMIT``, the chunk and decode launches, ``DRAIN`` and the placement
review, ``DEVICE_WAIT`` inside ``DRAIN``, ``MIGRATE`` inside
``PLACEMENT_REVIEW``), each with its parent and its tick; an untraced one
records nothing, and the phase marks are no-ops off the card."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.serving.obs import NULL_TRACER, SpanKind, Tracer

N_EP = 3


def _engine():
    from repro_torch.launch.serve import build_controller
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              d_model=64, d_ff=128, num_heads=2,
                              num_kv_heads=1, head_dim=32, vocab_size=128)
    spec = M.EPSpec.build(N_EP, cfg, capacity=64, slot_capacity=64)
    rt = tr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec, device="cpu")
    dense_rt = tr.Runtime(cfg=cfg, moe_impl="dense", ep_spec=spec,
                          device="cpu")
    dense = tr.init_params(dense_rt, 0)
    _, n_groups = cfg.layer_pattern()
    pls = tr.stack_placement(
        M.uniform_placement(N_EP, spec.slots, cfg.num_experts), n_groups)
    params = dict(dense, groups=M.regather_ep_groups(dense["groups"], pls,
                                                     n_groups))
    engine = ServingEngine(rt=rt, params=params, placement=pls,
                           dense_master=dense["groups"], max_len=48)
    # no incumbent plan: the first review (tick 3) adopts and applies one
    ctrl = build_controller(cfg, spec, "dancemoe", review_rounds=3)
    return engine, ctrl


class _SlowCopies:
    """A round's output copies that have not finished when first asked."""

    def query(self):
        return False

    def synchronize(self):
        pass


def _serve(trace, monkeypatch):
    from repro_torch.serving.api import Request
    from repro_torch.serving.cluster import EdgeCluster
    from repro_torch.serving.runtime import ServingRuntime

    launched = ServingRuntime._launched

    def slow(self, *a, **k):
        return dataclasses.replace(launched(self, *a, **k),
                                   event=_SlowCopies())

    # the CPU's rounds are done at launch; on the card the drain waits
    monkeypatch.setattr(ServingRuntime, "_launched", slow)
    engine, ctrl = _engine()
    cluster = EdgeCluster(
        "runtime", engine=engine, n_servers=N_EP, controller=ctrl,
        runtime_opts=dict(max_slots=4, block_size=8, warmup=True,
                          warmup_origins="tagged"), trace=trace)
    rng = np.random.default_rng(0)
    for k in range(5):
        cluster.submit(Request(prompt=rng.integers(0, 128, 6 + 5 * k),
                               max_new_tokens=3, origin=k % N_EP))
    cluster.run()
    return cluster


@pytest.fixture(scope="module")
def traced():
    with pytest.MonkeyPatch.context() as mp:
        cluster = _serve(True, mp)
    return cluster, {s.seq: s for s in cluster.tracer.spans}


def test_spans_nest_inside_their_tick(traced):
    cluster, spans = traced
    parent_kind = {SpanKind.ADMIT: SpanKind.STEP,
                   SpanKind.PREFILL_CHUNK: SpanKind.STEP,
                   SpanKind.DECODE_ROUND: SpanKind.STEP,
                   SpanKind.PLACEMENT_REVIEW: SpanKind.STEP,
                   SpanKind.DEVICE_WAIT: SpanKind.DRAIN,
                   SpanKind.MIGRATE: SpanKind.PLACEMENT_REVIEW,
                   SpanKind.QUEUE_WAIT: SpanKind.ADMIT}
    kinds = {s.kind for s in spans.values()}
    assert set(parent_kind) | {SpanKind.STEP, SpanKind.DRAIN} <= kinds
    for s in spans.values():
        if s.kind == SpanKind.STEP:
            assert s.parent == -1
            continue
        if s.parent == -1:
            # only the final flush drains outside a tick, in the last one
            assert s.kind in (SpanKind.DRAIN, SpanKind.DEVICE_WAIT)
            assert s.tick == cluster.backend.rounds
            continue
        p = spans[s.parent]
        if s.kind in parent_kind:
            assert p.kind == parent_kind[s.kind], (s, p)
        elif s.kind == SpanKind.DRAIN:
            assert p.kind == SpanKind.STEP
        # a queue wait starts at the enqueue, before its admission
        assert (s.kind == SpanKind.QUEUE_WAIT or p.start <= s.start), (s, p)
        assert s.start <= s.end <= p.end, (s, p)
        assert s.tick == p.tick
        assert s.seq > p.seq
    waits = [s for s in spans.values() if s.kind == SpanKind.DEVICE_WAIT]
    assert len(waits) == cluster.backend.runtimes[0].host_syncs


def test_one_step_per_tick_on_a_monotonic_clock(traced):
    cluster, spans = traced
    steps = sorted((s for s in spans.values() if s.kind == SpanKind.STEP),
                   key=lambda s: s.seq)
    # the harness's tick k is the STEP of rounds == k + 1
    assert [s.tick for s in steps] == list(
        range(1, cluster.backend.rounds + 1))
    for a, b in zip(steps, steps[1:]):
        assert a.start <= a.end <= b.start <= b.end
    # time.time_ns(): the clock torch.profiler stamps its events with
    assert all(isinstance(s.start, int) and s.start > 1.6e18
               for s in spans.values())
    # a span opened later starts later (a queue wait or a prefix hit is
    # numbered when recorded, at admission)
    begun = sorted((s for s in spans.values() if s.kind not in (
        SpanKind.QUEUE_WAIT, SpanKind.PREFIX_HIT)), key=lambda s: s.seq)
    assert all(a.start <= b.start for a, b in zip(begun, begun[1:]))


def test_launch_and_review_spans_keep_their_args(traced):
    cluster, spans = traced
    rt = cluster.backend.runtimes[0]
    launches = [s for s in spans.values()
                if s.kind in (SpanKind.PREFILL_CHUNK, SpanKind.DECODE_ROUND)]
    assert len(launches) == rt.prefill_calls + rt.rounds
    spec, K = rt.engine.rt.ep_spec, rt.engine.rt.cfg.top_k
    for s in launches:
        # the CPU has no graphs: every warmed step is an eager call
        assert 1 <= s.args["rows"] <= s.args["batch"] <= rt.max_slots
        assert s.args["graph"] is False
        # the EP capacities in force at the bucket: a chunk call's device
        # routes R of the batch x block rows over N_EP ranks (R K pairs,
        # N_EP R rows to a slot); a decode rank sees the batch's rows
        B = s.args["batch"]
        if s.kind == SpanKind.PREFILL_CHUNK:
            R = -(-B * rt.block_size // N_EP)
            want = (min(spec.capacity, R * K),
                    min(spec.slot_capacity, N_EP * R))
        else:
            want = (0, min(spec.slot_capacity, B))
        assert (s.args["ep_send_rows"], s.args["ep_slot_rows"]) == want
    assert any(s.args["ep_send_rows"] < spec.capacity for s in launches
               if s.kind == SpanKind.PREFILL_CHUNK)
    reviews = [s for s in spans.values()
               if s.kind == SpanKind.PLACEMENT_REVIEW]
    assert reviews and all("adopted" in s.args and "model_time" in s.args
                           for s in reviews)
    assert reviews[0].args["reason"] == "initial"
    assert reviews[0].args["model_time"] == reviews[0].tick
    migrates = [s for s in spans.values() if s.kind == SpanKind.MIGRATE]
    assert migrates and all(s.args["regather"] for s in migrates)
    waits = [s for s in spans.values() if s.kind == SpanKind.QUEUE_WAIT]
    assert sorted(s.rid for s in waits) == list(range(5))
    doc = json.loads(json.dumps(cluster.tracer.to_trace_doc()))
    assert doc["otherData"]["clock"] == "wall"
    ev = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(ev) == len(spans)
    assert all({"parent", "tick"} <= set(e["args"]) for e in ev)
    step = next(s for s in spans.values() if s.kind == SpanKind.STEP)
    assert any(e["ts"] == pytest.approx(step.start / 1e3) for e in ev)


def test_untraced_cluster_records_nothing_and_marks_are_no_ops(
        monkeypatch):
    cluster = _serve(False, monkeypatch)
    assert cluster.tracer is NULL_TRACER
    assert cluster.backend.engine.tracer is NULL_TRACER
    assert NULL_TRACER.spans == [] and NULL_TRACER.begin("STEP") is None
    assert "obs" not in cluster.metrics()

    def no_build(name):
        raise AssertionError(f"{name} built off the card")

    monkeypatch.setattr(build, "library", no_build)
    with ops.marks():
        ops.phase_mark("moe", torch.zeros(2))   # a CPU tensor: nothing
    ops.phase_mark("end", torch.zeros(2))        # no region: nothing


def test_wall_tracer_nests_and_annotates():
    tr = Tracer()
    step = tr.begin(SpanKind.STEP, tick=7)
    review = tr.begin(SpanKind.PLACEMENT_REVIEW)
    tr.instant(SpanKind.PLACEMENT_REVIEW, 7.0, reason="initial")
    tr.instant(SpanKind.FAULT, 7.0, server=2)
    tr.end(review)
    idle = tr.begin(SpanKind.PLACEMENT_REVIEW)
    tr.end(idle, keep=False)               # nothing happened: no record
    t = tr.now()
    tr.record(SpanKind.QUEUE_WAIT, t - 1000, t, rid=3)
    tr.end(step)
    after = tr.begin(SpanKind.DRAIN)
    tr.end(after)
    by = {s.kind: s for s in tr.spans}
    assert [s.seq for s in sorted(tr.spans, key=lambda s: s.seq)] == \
        list(range(5))
    assert by["PLACEMENT_REVIEW"].args == {"reason": "initial",
                                           "model_time": 7.0}
    assert by["FAULT"].args == {"model_time": 7.0}
    assert by["FAULT"].parent == by["PLACEMENT_REVIEW"].seq
    assert by["FAULT"].start == by["FAULT"].end
    assert by["QUEUE_WAIT"].parent == by["STEP"].seq
    assert {s.tick for s in tr.spans} == {7}       # DRAIN: the last tick
    assert by["DRAIN"].parent == -1 and tr.depth == 0
    with pytest.raises(ValueError):
        Tracer(clock="ticks")


def test_runtime_refuses_a_model_clock_tracer():
    from repro_torch.serving.runtime import ServingRuntime

    engine, _ = _engine()
    with pytest.raises(ValueError, match="wall clock"):
        ServingRuntime(engine, tracer=Tracer(clock="seconds"))


def _mla_engine():
    """Reduced DeepSeek-V2-Lite (a dense layer, then two MLA + MoE layers
    with shared experts) over three virtual EP ranks."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("deepseek-v2-lite-mla").reduced()
    spec = M.EPSpec.build(N_EP, cfg, slots=4, capacity=128, slot_capacity=128)
    rt = tr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec, device="cpu")
    dense = tr.init_params(dataclasses.replace(rt, moe_impl="dense"), 0)
    _, n_groups = cfg.layer_pattern()
    pls = tr.stack_placement(
        M.uniform_placement(N_EP, spec.slots, cfg.num_experts), n_groups)
    params = dict(dense, groups=M.regather_ep_groups(dense["groups"], pls,
                                                     n_groups))
    return ServingEngine(rt=rt, params=params, placement=pls,
                         dense_master=dense["groups"], max_len=64)


def test_mla_steps_mark_attention_the_dense_mlp_and_the_shared_experts(
        monkeypatch):
    """The phases a traced capture of an MLA model's steps marks, in
    order: the chunk or decode start, the dense prefix layer's MLA
    (``attention``) and SwiGLU (``mlp``), then each MoE layer's MLA
    (``attention``), its routed experts (``moe``) and, inside the MoE
    block after them, its shared experts (``shared_expert``), then the
    head and the end. (Off the card the marks launch nothing; the order of
    the calls is what a capture on the card records.)"""
    from repro_torch.serving.runtime import ServingRuntime
    from repro_torch.serving.api import Request

    seen = []
    monkeypatch.setattr(ops, "phase_mark", lambda phase, t: seen.append(phase))
    eng = _mla_engine()
    rt = ServingRuntime(eng, max_slots=2, block_size=16)
    rt.enqueue(Request(prompt=np.arange(20, dtype=np.int32),
                       max_new_tokens=2))
    rt.run()
    layers = ["attention", "mlp"] + ["attention", "moe", "shared_expert"] * 2
    calls = []
    for phase in seen:
        if phase in ("chunk", "decode"):
            calls.append([phase])
        else:
            calls[-1].append(phase)
    assert calls[0] == ["chunk"] + layers + ["head", "end"]
    assert ["decode"] + layers + ["head", "end"] in calls
    assert all(c[1:] == layers + ["head", "end"] for c in calls)


def test_launch_counts_hold_the_paged_mla_calls():
    """``ops.launch_counts`` carries the paged MLA kernel by call, so a
    captured graph counts its launches on every replay (off the card no
    launch is counted)."""
    from repro_torch.kernels import paged_mla

    counts = ops.launch_counts()
    assert {"paged_mla", "paged_mla.decode", "paged_mla.chunk"} <= set(counts)
    before = dict(counts)
    ops.add_launch_counts({"paged_mla": 2, "paged_mla.chunk": 2})
    assert paged_mla.launches == before["paged_mla"] + 2
    assert paged_mla.launches_by_call["chunk"] == before["paged_mla.chunk"] + 2
    ops.add_launch_counts({"paged_mla": 2, "paged_mla.chunk": 2}, -1)
    assert ops.launch_counts() == before
