"""DeepSeek-V2-Lite in the benchmark, on the CPU: its system module
(``systems/deepseek_v2_lite.py``) serves the port's MLA model with the
benchmark's weights, which through chunked prefill, the copy-on-write of a
cached tail and decode over the latent paged pool gives the logits of the
plain reference (``reference/deepseek_v2_lite.py``); its cell runs end to
end through ``bench.run_cell`` and is correct where the float8 control is
not; the two MLA readers and the yardstick's arithmetic, by hand."""

import json
import math
import time

import numpy as np
import pytest
import torch

from pbench import bench, mla, readers, record, refs
from pbench.loop import ReqRec, Tick
from pbench.traffic import Req

from pbench_tiny import ROOT, tiny_mix

CELL = "dsv2lite-edge3-longdocs"
SEED = 2**33 + 7


def _tiny_spec():
    """The cell at a size the CPU serves in seconds: d_model 128, 4 heads
    over a 32-value latent and 8 rope dims, one dense and two MoE layers of
    8 experts top-3 and 2 shared, vocabulary 512, float32; the docs mix at
    a few short documents."""
    spec = bench.load_cell(ROOT, CELL)
    conf = dict(spec["conf"], hidden_size=128, intermediate_size=192,
                moe_intermediate_size=64, num_attention_heads=4,
                num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                num_experts_per_tok=3, num_hidden_layers=3, vocab_size=512,
                torch_dtype="float32", check={"mean_gap": 1e-3})
    conf["deployment"] = dict(conf["deployment"], slots_per_server=4,
                              ep_capacity=128, ep_slot_capacity=128)
    spec.update(conf=conf, mix=tiny_mix(spec["mix"]))
    return spec


def test_the_served_port_matches_the_reference_through_the_latent_pool():
    """fp32, the benchmark's weights: request A's prompt of 40 tokens in
    three block-aligned chunks, then two decode rounds; B, a full hit of
    A's prompt, on A's two full blocks and a copy-on-write clone of its
    partly filled tail block, decoding other tokens; C, a partial hit of
    A's first two blocks, prefilling its own chunk from position 32. Every
    logit the port produces equals the reference's full forward pass over
    the same sequence to fp32 rounding (1e-4 of the largest logit: the two
    sum in other orders through three layers, and the port reads the
    latent absorbed)."""
    from repro_torch.models import transformer as tr

    spec = _tiny_spec()
    conf, sysmod = spec["conf"], spec["system"]
    ref = refs.reference_for(ROOT, conf)
    eng = sysmod.build_engine(conf, SEED, 96, "cpu")
    rt, params, pl = eng.rt, eng.params, eng.placement
    bs, P = 16, 6
    pool = tr.init_paged_cache(rt, 1 + 3 * P, bs)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 512, 43)  # prompt 40, then the decode inputs
    b = np.concatenate([a[:40], rng.integers(0, 512, 3)])
    c = np.concatenate([a[:32], rng.integers(0, 512, 10)])
    tables = {k: torch.tensor([v + [0] * (P - len(v))]) for k, v in
              {"a": [1, 2, 3], "b": [1, 2, 4], "c": [1, 2, 5]}.items()}
    got = {k: [] for k in "abc"}

    def chunk(name, toks, c0):
        n = len(toks)
        x = np.zeros((1, bs), np.int64)
        x[0, :n] = toks
        mask = torch.zeros(1, bs)
        mask[0, :n] = 1
        tbl = tables[name]
        lg, _, _ = tr.prefill_chunk(rt, params, pool, x, tbl,
                                    tbl[:, c0 // bs], [c0], [n - 1], pl,
                                    token_mask=mask)
        got[name].append(lg[0])

    def decode(name, tok, pos):
        lg, _, _ = tr.decode_step(rt, params, pool, torch.tensor([[tok]]),
                                  torch.tensor([pos]), pl,
                                  token_mask=torch.ones(1),
                                  page_table=tables[name])
        got[name].append(lg[0])

    for c0 in (0, 16, 32):  # logits at positions 15, 31 and 39
        chunk("a", a[c0:min(c0 + bs, 40)], c0)
    for pos in (40, 41):
        decode("a", a[pos], pos)
    tr.copy_paged_block(pool, 3, 4)  # B's clone of the shared tail block
    for pos in (40, 41):
        decode("b", b[pos], pos)
    chunk("c", c[32:], 32)
    seqs = [a[:42], b[:42], c]
    wanted = [[15, 31, 39, 40, 41], range(40, 42), range(41, 42)]
    want = ref.logits_at(conf, SEED, seqs, wanted, "cpu")
    for name, w in zip("abc", want):
        g = torch.stack(got[name])
        assert g.shape == w.shape, name
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), name


def test_the_cell_runs_end_to_end_and_only_the_control_fails(tmp_path,
                                                             monkeypatch):
    """The cell, cut to the CPU, through ``bench.run_cell`` (traced): its
    system module serves it (``EdgeCluster`` on the warmed loop, the radix
    prefix cache, DanceMoE over three virtual ranks), ``correct``; the
    docs metrics read, the MLA readers none (no card kernel in a CPU
    trace). The float8 reference put in the program's place reads not
    correct by the same comparison."""
    held = {}

    class Run(record.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            held["run"] = self

    monkeypatch.setattr(record, "Run", Run)
    spec = _tiny_spec()
    torch.set_num_threads(2)
    logs = []
    res = bench.run_cell(ROOT, spec, SEED, 2.5, True, time.perf_counter(),
                         device="cpu", dump=tmp_path, log=logs.append)
    assert "system: systems/deepseek_v2_lite.py" in logs
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert set(res["metrics"]) <= set(spec["per_layer"])
    run = held["run"]
    assert mla.roofline(run) is None and mla.share(run) is None
    assert run.ticks[0].delta.shape == (2, 3, 8)  # the MoE layers only
    # a tiny backlog may drain before so short a window opens on a fast
    # machine: the window's metrics are read over every tick the run served
    run.window = (run.ticks[0].t0, run.ticks[-1].t1 + 1.0)
    for name in ("local_ratio.docs", "remote_kb_per_tok.docs",
                 "prefix_hit_share.docs", "prefill_tick_ms.docs",
                 "step_mfu.docs"):
        assert record.load_reader(ROOT, name)(run) is not None, name

    (path,) = tmp_path.glob("*.npz")
    d = np.load(path)
    ref = refs.reference_for(ROOT, spec["conf"])
    seqs = np.split(d["tokens"].astype(np.int64), np.cumsum(d["lens"])[:-1])
    wanted = [range(len(q) - 1) for q in seqs]
    exact = ref.logits_at(spec["conf"], SEED, seqs, wanted, "cpu")
    low = ref.logits_at(spec["conf"], SEED, seqs, wanted, "cpu",
                        precision="fp8")
    served = [torch.as_tensor(q[p:]) for p, q in zip(d["prompt"], seqs)]
    prog = [ref.gaps(e[p - 1:], t)
            for e, t, p in zip(exact, served, d["prompt"])]
    ctrl = [ref.gaps(e, lo.argmax(-1)) for e, lo in zip(exact, low)]
    prog_gap, limit, prog_ok = bench.gap_check(spec["conf"], prog)
    ctrl_gap, _, ctrl_ok = bench.gap_check(spec["conf"], ctrl)
    assert prog_ok and not ctrl_ok
    assert prog_gap["mean"] <= limit < ctrl_gap["mean"]


PUBLISHED = dict(layers=9, dense_layers=1, moe_layers=8, d=2048, heads=16,
                 kv_lora=512, nope=128, rope=64, v=128, ff=1408,
                 dense_ff=10944, experts=64, shared=2, top_k=6,
                 vocab=102400)


def test_the_configuration_keeps_the_published_widths():
    """Every size the system module reads is the published one but the
    depth (9 of 27 layers, in ``reduced``); the EP capacities drop no row
    at the mix's largest step (a chunk call of ``max_slots`` x 16 tokens,
    padded to a multiple of the ranks: every routed row of a rank to one
    rank; a slot's expert picked at most once a token)."""
    spec = bench.load_cell(ROOT, CELL)
    conf, mix = spec["conf"], spec["mix"]
    s = spec["system"].sizes(conf)
    assert {k: s[k] for k in PUBLISHED} == PUBLISHED
    assert not s["norm_topk"] and s["routed_scale"] == 1.0
    assert conf["reduced_from"] == {"num_hidden_layers": 27}
    bench_json = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench_json["configs"] if c["name"] == conf["name"])
    assert entry["reduced"] == ["num_hidden_layers"]
    dep = conf["deployment"]
    rows = -(-mix["max_slots"] * 16 // dep["servers"])
    assert dep["ep_capacity"] >= rows * s["top_k"]
    assert dep["ep_slot_capacity"] >= rows * dep["servers"]
    assert dep["servers"] * dep["slots_per_server"] == 1.5 * s["experts"]
    assert mix["max_len"] >= mix["doc_len"][3] + mix["question_len"][1] + \
        mix["output_len"][3]


def test_the_arithmetic_counts_the_published_block():
    """By hand at the published widths: an MLA layer's projections
    2048 x 3072 + 2048 x 576 + 512 x 4096 + 2048 x 2048 = 13,762,560; the
    dense SwiGLU 3 x 2048 x 10944; a MoE layer's router and 6 routed plus 2
    shared experts of 3 x 2048 x 1408; attention 2 x 16 x (192 + 128) a
    (query, key) pair and layer; ``moe_gmm`` counts the routed rows only."""
    sysmod = bench.load_cell(ROOT, CELL)["system"]
    s = dict(PUBLISHED, eps=1e-6)
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    assert attn == 13_762_560
    active = (attn + 3 * 2048 * 10944) + 8 * (
        attn + 2048 * 64 + 8 * 3 * 2048 * 1408)
    assert sysmod.active_params(s) == active
    pair = 2 * 16 * (192 + 128)
    assert sysmod.decode_flops(s, 100, 1) == pytest.approx(
        2 * active + 9 * pair * 101 + 2 * 2048 * 102400, rel=1e-12)
    assert sysmod.prompt_flops(s, 40, 32) == pytest.approx(
        8 * 2 * active + 9 * pair * sum(range(33, 41)) + 2 * 2048 * 102400,
        rel=1e-12)
    counts = np.zeros((8, 3, 64))
    counts[:, 0, :6] = 1  # a token's 6 routed rows in each MoE layer
    assert sysmod.gmm_least_seconds(s, counts) == pytest.approx(
        8 * max(6 * 2 * 3 * 2048 * 1408 / 989e12,
                (6 * 3 * 2048 * 1408 * 2 + 6 * 2 * 2048 * 2) / 3.35e12),
        rel=1e-12)


def _hand_run(with_kernel=True):
    """Six ticks of 0.1 s on the published widths: a 40-token prompt
    admitted after tick 0 (chunks of 16, 16 and 8 from positions 0, 16,
    32, spread over ticks 0 to 2), its first token seen after tick 3, two
    more after ticks 4 and 5 (decodes launched in ticks 3 and 4); every
    tick traced, ``paged_mla`` busy 20 us of each and a ``gmm`` kernel
    30 us."""
    s = dict(PUBLISHED)
    delta = np.zeros((8, 3, 64))
    ticks = [Tick(k, k * 0.1, k * 0.1 + 0.1, k < 3, k >= 3, False, delta,
                  np.ones((8, 3, 64))) for k in range(6)]
    rec = ReqRec(Req(0, 0.0, 0, 0, np.zeros(40, np.int32), 3), 0.0,
                 admit_t=0.1, token_t=[0.4, 0.5, 0.6])
    run = record.Run(sizes=s, mix={}, recs=[rec], ticks=ticks,
                     window=(0.0, 0.6), seconds=0.6, setup_s=1.0)
    host = [("traced", 0.0, 0.6e6)] + [
        (f"step#{k}", k * 1e5, k * 1e5 + 1e5) for k in range(6)]
    dev = [("gmm_tc", k * 1e5 + 1.0, k * 1e5 + 31.0) for k in range(6)]
    if with_kernel:
        dev += [("(anonymous namespace)::paged_mla", k * 1e5 + 40.0,
                 k * 1e5 + 55.0) for k in range(6)]
        dev += [("paged_mla_combine<float>", k * 1e5 + 55.0,
                 k * 1e5 + 60.0) for k in range(6)]
    run.trace = record.traced(dev, host)
    return run


def test_the_mla_readers_on_a_hand_made_run():
    """Calls, FLOPs and bytes by hand: a chunk of q queries from offset c0
    scores q c0 + q (q + 1) / 2 pairs at 2 x 16 x (576 + 512) FLOPs each
    and reads c0 + q latent rows of 1,152 bytes, plus q x 16 x (576 + 512)
    x 2 bytes of queries and outputs; a decode of the token k reads 40 + k
    rows. Each call's least time is the larger bound, times 9 layers; the
    share is the kernels' 120 us of the 300 us busy."""
    run = _hand_run()
    work = mla.call_work(run)
    pair, row, io = 2 * 16 * 1088, 1152, 16 * 1088 * 2
    want = {(0, "chunk"): (16 * 17 // 2, 16, 16),
            (1, "chunk"): (16 * 16 + 16 * 17 // 2, 32, 16),
            (2, "chunk"): (8 * 32 + 8 * 9 // 2, 40, 8),
            (3, "decode"): (41, 41, 1), (4, "decode"): (42, 42, 1)}
    assert set(work) == set(want)
    for key, (pairs, keys, q) in want.items():
        assert work[key] == pytest.approx([pair * pairs,
                                           row * keys + io * q])
    least = 9 * sum(max(f / 989e12, b / 3.35e12) for f, b in work.values())
    assert mla.least_seconds(run, run.ticks) == pytest.approx(least)
    assert mla.roofline(run) == pytest.approx(100 * least / 120e-6)
    assert mla.share(run) == pytest.approx(100 * 120 / 300)
    root_readers = {n: record.load_reader(ROOT, n) for n in
                    ("mla_roofline.longdocs", "mla_share.longdocs")}
    assert root_readers["mla_roofline.longdocs"](run) == mla.roofline(run)
    assert root_readers["mla_share.longdocs"](run) == mla.share(run)
    bare = _hand_run(with_kernel=False)
    assert all(r(bare) is None for r in root_readers.values())
    assert readers.gmm_roofline(run) is None  # counts of zero rows
    assert math.isclose(run.trace["busy_us"], 6 * (30 + 20))
