"""The yardstick's arithmetic: percentiles over all requests, the placement
metrics on a hand-worked example, FLOPs, bytes and the roofline bound, and
the reduction of a trace."""

import math

import numpy as np
import pytest

from pbench import model, record, stats
from pbench import trace as T
from pbench.loop import ReqRec, Tick
from pbench.record import load_reader
from pbench.traffic import Req

from pbench_tiny import ROOT

S = dict(layers=2, d=4, heads=2, kv_heads=1, hd=2, ff=8, experts=3, top_k=2,
         vocab=10)


def test_percentile_counts_unserved_requests_as_infinitely_late():
    assert stats.percentile([1, 2, 3, 4, 5], 75) == 4.0
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    # 4 of 5 served: p75 falls between the 4th and the 5th (inf) value
    assert stats.percentile([1, 2, 3, 4, math.inf], 75) == 4.0
    assert stats.percentile([1, 2, 3, math.inf, math.inf], 75) == math.inf
    assert stats.percentile([1, 2, 3, 4, math.inf], 90) == math.inf
    assert math.isnan(stats.percentile([], 50))
    assert stats.percentile([5, 1, 3], 50) == 3
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def _tick(k, delta, res, t0=0.0):
    return Tick(k, t0 + k, t0 + k + 0.5, False, True, False,
                np.asarray(delta, float), np.asarray(res, float))


def _run(ticks, recs=(), window=(0.0, 100.0)):
    return record.Run(sizes=S, mix={}, recs=list(recs), ticks=ticks,
                      window=window, seconds=window[1] - window[0],
                      setup_s=1.0)


def test_local_ratio_and_remote_bytes_by_hand():
    # one layer, two servers, three experts. Server 0 holds experts 0 and
    # 1, server 1 holds expert 2. Tick 1 drains rows launched in tick 0
    # (residency res0); tick 2 drains tick 1's (res1: server 1 got expert
    # 0 too).
    S1 = dict(S, layers=1)
    res0 = [[[1, 1, 0], [0, 0, 1]]]
    res1 = [[[1, 1, 0], [1, 0, 1]]]
    d1 = [[[2, 1, 1], [1, 0, 1]]]  # origin 0: 3 local of 4; 1: 1 of 2
    d2 = [[[0, 0, 2], [2, 0, 0]]]  # origin 0: 0 of 2; origin 1: 2 of 2
    ticks = [_tick(0, np.zeros((1, 2, 3)), res0),
             _tick(1, d1, res1), _tick(2, d2, res1)]
    run = record.Run(sizes=S1, mix={}, recs=[], ticks=ticks,
                     window=(0.9, 100.0), seconds=99.1, setup_s=1.0)
    # local rows: tick 1 under res0: 3 + 1 = 4; tick 2 under res1: 0 + 2
    assert load_reader(ROOT, "local_ratio.docs")(run) == pytest.approx(
        100 * 6 / 10)
    # 4 remote rows x 2 x d(4) x 2 bytes over 10 / top_k = 5 tokens
    assert load_reader(ROOT, "remote_kb_per_tok.chat")(run) == pytest.approx(
        4 * 2 * 4 * 2 / 5 / 1e3)


def test_token_and_step_flops():
    p = model.layer_params_active(S)
    # q 4x4, k and v 4x2 each, o 4x4, router 4x3, two experts of 3x4x8
    assert p == 16 + 16 + 16 + 12 + 2 * 96
    one = model.token_flops(S, np.array([5]), logits=False)
    assert one == 2 * (2 * p + 4 * 2 * 2 * 5)
    assert model.token_flops(S, np.array([5]), True) == one + 2 * 4 * 10
    # a prompt of 6 with 2 skipped computes positions 2..5 (contexts 3..6)
    assert model.prompt_flops(S, 6, 2) == pytest.approx(
        model.token_flops(S, np.arange(3, 7), False) + 2 * 4 * 10)
    assert model.decode_flops(S, 6, 1) == model.token_flops(
        S, np.array([7]), True)


def test_moe_gmm_least_time():
    counts = np.zeros((2, 3, 3))
    counts[0, 0, 1] = 3  # layer 0: 3 rows to expert 1
    counts[0, 2, 1] = 1  # and one more from another origin
    counts[1, 1, 0] = 2  # layer 1: 2 rows each to experts 0 and 2
    counts[1, 1, 2] = 2
    w = 3 * 4 * 8 * 2  # one expert's bf16 weights
    flops = [2 * 3 * 4 * 8 * 4, 2 * 3 * 4 * 8 * 4]
    nbytes = [1 * w + 4 * 2 * 4 * 2, 2 * w + 4 * 2 * 4 * 2]
    want = sum(max(f / model.PEAK_BF16_FLOPS, b / model.PEAK_HBM_BYTES)
               for f, b in zip(flops, nbytes))
    assert model.gmm_least_seconds(S, counts) == pytest.approx(want)
    # at real widths the bound is the bytes for a decode step
    big = dict(S, d=4096, ff=14336)
    assert model.gmm_least_seconds(big, counts) == pytest.approx(
        (3 * 3 * 4096 * 14336 * 2 + 8 * 2 * 4096 * 2) / model.PEAK_HBM_BYTES)


def test_ttft_itl_and_tokens_readers():
    req = Req(0, 0.0, 0, 0, np.zeros(10, np.int32), 3)
    a = ReqRec(req, 1.0, token_t=[3.0, 3.5, 4.5], admit_t=2.0)
    b = ReqRec(Req(1, 0.0, 1, 1, np.zeros(20, np.int32), 2), 2.0)
    late = ReqRec(Req(2, 0.0, 1, 1, np.zeros(5, np.int32), 2), 50.0,
                  token_t=[200.0])
    run = _run([], [a, b, late], window=(0.0, 10.0))
    # b never got a token: of the two due in the window, p75 is inf
    assert load_reader(ROOT, "ttft_p75_ms")(run) == math.inf
    b.token_t = [6.0, 6.25]
    assert load_reader(ROOT, "ttft_p75_ms")(run) == pytest.approx(
        (2.0 + 0.75 * 2.0) * 1e3)
    assert load_reader(ROOT, "itl_p95_ms")(run) == pytest.approx(
        stats.percentile([0.5, 1.0, 0.25], 95) * 1e3)
    # tokens_s: tick k runs from k to k + 0.5, the window is [3, 12.25), so
    # tick 12 counts half. A prompt is spread evenly over the ticks from
    # its admission to its first token.
    ticks = [_tick(k, np.zeros((2, 2, 3)), np.ones((2, 2, 3)))
             for k in range(16)]

    def rec(prompt, admit, tokens):
        return ReqRec(Req(0, 0.0, 0, 0, np.zeros(prompt, np.int32), 2), 0.0,
                      admit_t=admit, token_t=tokens)

    run = _run(ticks, [
        rec(10, 0.5, [3.5, 4.5, 5.5]),  # 1 of 4 prefill ticks, 3 outputs
        rec(20, 10.5, [14.5]),  # 2.5 of 5 prefill ticks, its output after
        rec(5, 5.5, [5.5, 6.5]),  # admitted and answered after one tick
        rec(4, 11.5, [12.5]),  # 1.5 of 2 ticks; its output seen after the
        # half tick counts half
        rec(30, 12.5, []),  # still prefilling: no first token, no share
    ], window=(3.0, 12.25))
    assert load_reader(ROOT, "tokens_s")(run) == pytest.approx(
        (10 / 4 + 3 + 20 * 2.5 / 5 + 5 + 2 + 4 * 1.5 / 2 + 0.5) / 9.25)


def test_trace_reduction():
    dev = [("gmm_tc", 0.0, 4.0), ("copy", 2.0, 6.0), ("gmm_rows", 10.0, 12.0),
           ("x", 20.0, 30.0)]
    busy = T.merged(dev, 1.0, 25.0)
    assert busy == [(1.0, 6.0), (10.0, 12.0), (20.0, 25.0)]
    assert T.busy_in(busy, 5.0, 11.0) == pytest.approx(2.0)
    gaps = T.gaps(busy, 1.0, 25.0)
    assert gaps == [(6.0, 10.0), (12.0, 20.0)]
    host = [("traced", 0.0, 30.0), ("step#3", 5.0, 9.0), ("wait", 12.0, 19.0)]
    labels = T.label_gaps(gaps, host, lambda k: "decode" if k == 3 else "?")
    assert labels == {"step.decode": 4.0, "wait": 8.0}
    assert T.gmm_us(dev, 1.0, 25.0) == pytest.approx(3.0 + 2.0)
    assert T.top_ops(dev, 1.0, 25.0, n=2) == [["x", 5e-6], ["copy", 4e-6]]
