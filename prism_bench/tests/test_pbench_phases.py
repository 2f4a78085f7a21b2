"""The readers of the program's own trace (``pbench/phases.py``) on
synthetic traces worked by hand, and a tiny traced run on the CPU with
the program's tracer on (``program_trace.run_traced``)."""

import numpy as np
import pytest

from pbench import phases, record
from pbench.loop import Tick
from pbench.record import load_reader

from pbench_tiny import ROOT, tiny_spec

M = phases.MARK


def _tick(k, t0, t1):
    return Tick(k, t0, t1, True, True, False, np.zeros((1, 1, 1)),
                np.zeros((1, 1, 1)))


def _run(dev, steps=(), program=None, window=(0.0, 1e9)):
    """A run whose traced part is [0, 100] us on the trace's clock, with a
    harness span ``step#k`` per ``(start, end)`` of ``steps``."""
    host = [("traced", 0.0, 100.0)] + [
        (f"step#{k}", s, e) for k, (s, e) in enumerate(steps)]
    run = record.Run(sizes={}, mix={}, recs=[],
                     ticks=[_tick(k, s / 1e6, e / 1e6)
                            for k, (s, e) in enumerate(steps)],
                     window=window, seconds=1.0, setup_s=1.0)
    run.trace = record.traced(list(dev), host)
    run.program = program
    return run


def _mark(phase, t):
    return (M + phase, t, t + 1.0)


# two calls inside the window and one the window's end cuts: a chunk
# call [10, 39] (attention 12-24 with two kernels, moe 24-34, head 34-39),
# a decode round [50, 70] (attention 52-60, moe 60-66, head 66-70), a
# decode round from 90 whose end mark lies past the trace; one mark at 2
# belongs to a call that began before the trace
DEV = [
    _mark("moe", 2), ("stale", 3.0, 6.0), _mark("end", 7),
    _mark("chunk", 10), ("embed", 11.0, 12.0),
    _mark("attention", 12), ("gather", 13.0, 19.0), ("attn", 19.0, 23.0),
    _mark("moe", 24), ("gmm_tc", 25.0, 33.0),
    _mark("head", 34), ("lm_head", 35.0, 37.0), _mark("end", 38),
    ("copy_out", 42.0, 44.0),
    _mark("decode", 50), _mark("attention", 52), ("gather", 53.0, 59.0),
    _mark("moe", 60), ("gmm_tc", 61.0, 65.0), _mark("head", 66),
    ("lm_head", 67.0, 68.0), _mark("end", 69),
    _mark("decode", 90), _mark("attention", 92), ("gather", 93.0, 99.0),
    ("gather", 99.0, 104.0),
]


def test_calls_and_their_phases_by_hand():
    calls = phases.calls(DEV)
    assert [(c.kind, c.start, c.end, c.whole) for c in calls] == [
        ("chunk", 10.0, 39.0, True), ("decode", 50.0, 70.0, True),
        ("decode", 90.0, None, False)]
    assert phases.phase_spans(calls[0], 100.0) == [
        ("chunk", 10.0, 12.0), ("attention", 12.0, 24.0), ("moe", 24.0, 34.0),
        ("head", 34.0, 39.0)]
    assert phases.phase_spans(calls[2], 100.0)[-1] == ("attention", 92.0,
                                                       100.0)


def test_call_device_time_counts_whole_calls_inside_the_window():
    run = _run(DEV)
    # chunk: marks 10-11, 12-13, 24-25, 34-35, 38-39 (5) + kernels 1 + 6 +
    # 4 + 8 + 2 = 26 busy us of [10, 39]
    assert load_reader(ROOT, "chunk_device_ms.docs")(run) == pytest.approx(
        26e-3)
    # decode: only the whole round counts (the cut one at 90 does not):
    # marks 5 + kernels 6 + 4 + 1 = 16 us
    assert load_reader(ROOT, "decode_device_ms.chat")(run) == pytest.approx(
        16e-3)


def test_phase_shares_split_across_calls_and_cut_by_the_window():
    run = _run(DEV)
    # busy us by phase inside [0, 100]: attention 1 + 6 + 4 (chunk) + 1 +
    # 6 (decode) + 1 + 6 + 1 (the cut round: marks at 92, gather to 100)
    # = 26; moe 1 + 8 + 1 + 4 = 14; head 1 + 2 + 1 + 1 + 1 (the chunk's
    # end mark) + 1 (the round's) = 7; chunk 1 + 1 = 2; decode 1 + 1 = 2
    total = 26 + 14 + 7 + 2 + 2
    assert load_reader(ROOT, "attention_share.chat")(run) == pytest.approx(
        100 * 26 / total)
    assert load_reader(ROOT, "moe_share.docs")(run) == pytest.approx(
        100 * 14 / total)


def test_no_marks_no_spans_read_nothing():
    run = _run([("gather", 10.0, 20.0), ("gmm_tc", 30.0, 40.0)],
               steps=[(5.0, 45.0)])
    for name in ("chunk_device_ms.chat", "decode_device_ms.chat",
                 "attention_share.chat", "moe_share.docs",
                 "host_tick_ms.chat", "regather_ms.chat"):
        assert load_reader(ROOT, name)(run) is None, name
    run.trace = None
    assert phases.phase_share(run, "moe") is None


def _span(kind, seq, start, end, parent=-1, tick=-1):
    return dict(kind=kind, seq=seq, start=start, end=end, parent=parent,
                tick=tick, rid=-1, args={})


def test_host_tick_and_regather_from_program_spans():
    # harness ticks 0 and 1 (program ticks 1 and 2) traced; tick 1 waits
    # 30 us on the device inside its drain, 10 us more inside a second one
    prog = [_span("STEP", 0, 2.0, 42.0, tick=1),
            _span("DRAIN", 1, 5.0, 40.0, 0, 1),
            _span("DEVICE_WAIT", 2, 6.0, 36.0, 1, 1),
            _span("STEP", 3, 52.0, 92.0, tick=2),
            _span("DRAIN", 4, 60.0, 80.0, 3, 2),
            _span("DEVICE_WAIT", 5, 61.0, 71.0, 4, 2),
            _span("PLACEMENT_REVIEW", 6, 81.0, 90.0, 3, 2),
            _span("MIGRATE", 7, 82.0, 89.0, 6, 2),
            _span("DEVICE_WAIT", 8, 95.0, 99.0, -1, 2)]  # a flush, no tick
    run = _run([], steps=[(1.0, 43.0), (51.0, 93.0)], program=prog)
    # ticks: 40 - 30 = 10 us and 40 - 10 = 30 us of host time
    assert load_reader(ROOT, "host_tick_ms.chat")(run) == pytest.approx(
        20e-3)
    assert load_reader(ROOT, "regather_ms.chat")(run) == pytest.approx(7e-3)
    # a migration outside the window's ticks is not the window's
    run.window = (0.0, 60e-6)
    assert load_reader(ROOT, "regather_ms.chat")(run) is None


def test_tiny_traced_run_with_the_program_tracer():
    import program_trace
    import torch

    torch.set_num_threads(2)
    spec = tiny_spec("mixtral-edge3-chat")
    res, run = program_trace.run_traced(spec, 2**33 + 7, 1.5, 0.0,
                                        device="cpu", log=lambda m: None)
    assert res["correct"], res["checks"]
    assert "host_tick_ms.chat" in res["metrics"]
    steps = phases.steps_by_tick(run.program)
    harness = run.trace["steps"]
    assert harness and {k + 1 for k in harness} <= set(steps)
    # one STEP per harness tick, inside its span on the profiler's clock
    assert len(steps) == len(run.ticks)
    for k, (s, e) in harness.items():
        st = steps[k + 1]
        assert s - 100 <= st["start"] <= st["end"] <= e + 100
    # no card: no marks, nothing for the device readers
    assert program_trace.checks(run)["marks"] == 0
    assert "attention_share.chat" not in res["metrics"]


def test_program_trace_checks_on_a_marked_trace():
    import program_trace

    prog = [_span("STEP", 0, 9.0, 45.0, tick=1),
            _span("STEP", 1, 48.0, 75.0, tick=2)]
    c = program_trace.checks(_run(DEV, steps=[(8.0, 46.0), (47.0, 76.0)],
                                  program=prog))
    assert c["calls"] == {"chunk": 1, "decode": 2, "regather": 0}
    # busy us in [0, 100]: 5 before the first call, the chunk call 26,
    # the copy 2, the whole round 16, the cut one 9; marked 26 + 16 + 9
    assert c["marked_busy_share"] == pytest.approx(100 * 51 / 58)
    assert c["tick_device_ms_median"] == pytest.approx(42e-3)
    assert c["traced_decode_tick_ms_median"] == pytest.approx(33.5e-3)
    assert c["step_excursion_max_us"] == -1.0
    assert c["phase_ops_s"]["attention"] == [["gather", 19e-6],
                                             ["attn", 4e-6]]
