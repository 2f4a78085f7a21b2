"""The port's serving stack end to end on the CPU: the reference's
``generate`` == the port's ``generate`` == the port's ``ServingRuntime``
(paged pool with the prefix cache on and off, dense pool), token for token
under greedy decoding; live migration; and the launcher."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core.placement import PlacementPlan, build_ep_placement
from repro_torch.models import moe as TM
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.runtime import ServingRuntime
from tests._torch_parity import build_pair, prompts

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = [("mixtral-8x7b", "ep"), ("mixtral-8x7b", "dense"), ("yi-6b", "dense")]
STEPS = 6
_PAIRS: dict = {}


def _pair(arch, impl):
    if (arch, impl) not in _PAIRS:
        _PAIRS[arch, impl] = build_pair(arch, impl, max_len=48,
                                        capacity=64, slot_capacity=64)
    return _PAIRS[arch, impl]


def _prompts(vocab):
    """Three prompts sharing a 9-token prefix (one block of 8 + 1), of
    lengths 9, 14 and 17."""
    base = prompts(vocab, 1, 17, seed=5)[0]
    tails = prompts(vocab, 2, 8, seed=6)
    return [base[:9], np.concatenate([base[:9], tails[0][:5]]),
            np.concatenate([base[:9], tails[1]])]


def _serve(engine, ps, **kw):
    rt = ServingRuntime(engine, max_slots=2, block_size=8, **kw)
    handles = [rt.enqueue(Request(prompt=ps[0], max_new_tokens=STEPS))]
    rt.step()
    rt.step()           # the first prompt's prefix is cached by now
    handles += [rt.enqueue(Request(prompt=p, max_new_tokens=STEPS))
                for p in ps[1:]]
    rt.run()
    if rt.paged:
        rt.check_invariants()
    return [list(h.result()) for h in handles], rt


@pytest.mark.parametrize("arch,impl", CASES)
def test_generate_matches_reference(arch, impl):
    jeng, teng = _pair(arch, impl)
    toks = prompts(jeng.rt.cfg.vocab_size, 2, 11, seed=3)
    jgen, _ = jeng.generate(toks, steps=STEPS)
    tgen, _ = teng.generate(toks, steps=STEPS)
    np.testing.assert_array_equal(tgen, np.asarray(jgen))


@pytest.mark.parametrize("arch,impl", CASES)
@pytest.mark.parametrize("pool", ["paged+cache", "paged", "dense"])
def test_runtime_matches_generate(arch, impl, pool):
    jeng, teng = _pair(arch, impl)
    ps = _prompts(teng.rt.cfg.vocab_size)
    want = [list(teng.generate(p[None], steps=STEPS)[0][0]) for p in ps]
    got, rt = _serve(teng, ps, paged=pool != "dense",
                     prefix_cache=pool == "paged+cache")
    assert got == want
    if pool == "paged+cache":
        assert rt.prefix_hits >= 2 and rt.prefix_tokens_skipped >= 16
    # the reference runtime serves the same tokens
    if pool == "paged+cache" and impl == "ep":
        from repro.serving.api import Request as JRequest
        from repro.serving.runtime import ServingRuntime as JRuntime

        jrt = JRuntime(jeng, max_slots=2, block_size=8)
        hs = [jrt.enqueue(JRequest(prompt=p, max_new_tokens=STEPS))
              for p in ps]
        jrt.run()
        assert [list(h.result()) for h in hs] == want


def test_migrate_then_generate_equals_fresh_engine():
    _, teng = build_pair("mixtral-8x7b", "ep", max_len=48, capacity=64,
                         slot_capacity=64)
    cfg = teng.rt.cfg
    E, S = cfg.num_experts, teng.rt.ep_spec.slots
    _, G = cfg.layer_pattern()
    # a new plan: expert order reversed in the slots of every layer
    plan = PlacementPlan(assign=[[list(range(E))[::-1]] for _ in range(G)],
                         counts=np.full((G, 1), E), num_experts=E)
    new_pl = build_ep_placement(plan, S)
    toks = prompts(cfg.vocab_size, 2, 10, seed=9)
    teng.migrate(new_pl)
    moved = teng.generate(toks, steps=STEPS)[0]
    fresh_params = dict(teng.params)
    fresh_params["groups"] = TM.regather_ep_groups(teng.dense_master, new_pl, G)
    fresh = ServingEngine(rt=teng.rt, params=fresh_params, placement=new_pl,
                          dense_master=teng.dense_master, max_len=48)
    np.testing.assert_array_equal(moved, fresh.generate(toks, steps=STEPS)[0])
    assert teng.placement.slot_to_expert[0, 0].tolist() == list(range(E))[::-1]
    # expert slots really moved: slot 0 now holds the last expert's weights
    w1 = teng.params["groups"]["b1"]["w1"]
    assert np.array_equal(w1[0, 0, 0].numpy(),
                          teng.dense_master["b1"]["w1"][0, E - 1].numpy())


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x7b", "--device", "cpu", "--requests", "3", "--steps", "4",
         "--shared-prefix", "16", "--review-rounds", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 3 requests / 12 tokens" in out.stdout, out.stdout


def test_runtime_events_match_reference_runtime():
    """Same stream into the reference's runtime and the port's (dense MoE,
    paged pool, prefix cache, SLO-aware admission with a shed, an EOS stop,
    staggered arrivals, pool pressure): identical event logs — types,
    ticks, payloads — and identical allocator counters."""
    from repro.serving.api import Request as JRequest
    from repro.serving.runtime import ServingRuntime as JRuntime

    jeng, teng = _pair("mixtral-8x7b", "dense")
    ps = _prompts(teng.rt.cfg.vocab_size)
    eos = int(teng.generate(ps[1][None], steps=STEPS)[0][0][2])
    stream = [  # (arrival tick, prompt, max_new_tokens, slo, eos)
        (0, ps[0], STEPS, None, None),
        (0, ps[1], STEPS, 40, eos),
        (1, ps[2], STEPS, 3, None),        # unmeetable: shed
        (2, ps[2], 4, None, None),
        (3, ps[0][:5], 3, 30, None),
    ]

    def drive(runtime_cls, request_cls, engine):
        rt = runtime_cls(engine, max_slots=2, block_size=8, n_blocks=4,
                         slo_aware=True)
        handles, tick = [], 0
        pending = list(stream)
        while pending or rt.queue or rt.active:
            while pending and pending[0][0] <= tick:
                _, p, n, slo, e = pending.pop(0)
                handles.append(rt.enqueue(request_cls(
                    prompt=p, max_new_tokens=n, slo=slo, eos=e)))
            rt.step()
            tick += 1
        log = [[(e.type, e.time, sorted(e.data.items())) for e in h.events]
               for h in handles]
        counters = (rt.sheds, rt.deferrals, rt.prefix_hits,
                    rt.prefix_tokens_skipped, rt.cow_copies, rt.decode_rows,
                    rt.prefill_rows, rt.rounds, rt.ticks)
        return log, counters

    want = drive(JRuntime, JRequest, jeng)
    got = drive(ServingRuntime, Request, teng)
    assert got == want
    sheds, deferrals, hits = want[1][:3]
    assert sheds == 1 and deferrals > 0 and hits > 0
    assert len(want[0][1]) < len(want[0][0])    # the EOS stop cut request 1


def test_outputs_ignore_uninitialized_memory(monkeypatch):
    """The slot buffers, the FFN scratch and the kernel outputs are
    allocated uninitialized; rows past a slot's fill are never read. Fresh
    allocations filled with NaN must leave the token streams unchanged."""
    import torch

    _, teng = _pair("mixtral-8x7b", "ep")
    toks = prompts(teng.rt.cfg.vocab_size, 2, 11, seed=3)
    want = teng.generate(toks, steps=STEPS)[0]

    def poisoned(alloc):
        def fn(*args, **kw):
            t = alloc(*args, **kw)
            return t.fill_(float("nan")) if t.is_floating_point() else t
        return fn

    monkeypatch.setattr(torch, "empty", poisoned(torch.empty))
    monkeypatch.setattr(torch, "empty_like", poisoned(torch.empty_like))
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        poisoned(torch.Tensor.new_empty))
    np.testing.assert_array_equal(teng.generate(toks, steps=STEPS)[0], want)
