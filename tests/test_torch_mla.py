"""DeepSeek-V2's blocks in the port, on the CPU: multi-head latent
attention (``models.mla``) read absorbed from a latent cache against the
published non-absorbed equations, its YaRN frequencies and softmax scale
against their closed forms, the paged read's plain version against the
dense read, the top-k router without renormalisation, the shared experts,
and the leading dense layer outside the MoE groups (the engine's groups,
statistics and placement cover the MoE layers only). The port has no JAX
counterpart of these; the plain reference of the whole model is
``prism_bench/reference/deepseek_v2_lite.py``, held against the served
port in ``prism_bench/tests/test_pbench_dsv2.py``."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.models import mla
from repro_torch.models import moe as M
from repro_torch.models import transformer as tr

N_EP = 3


def _cfg(**kw):
    return dataclasses.replace(get_config("deepseek-v2-lite-mla").reduced(),
                               **kw)


def test_yarn_frequencies_and_mscale_match_their_closed_forms():
    """Published YaRN (factor 40, original 4096, betas 32 and 1, theta 1e4,
    64 rope dims): the ramp runs over frequencies 10 to 23; below it the
    original ``theta^(-2i/64)``, above it those over 40, linear between;
    the softmax scale is ``192^-1/2 m^2`` with ``m = 0.1 * 0.707 * ln 40 +
    1``, ``m^2 = 1.5896...``. Both are float64 closed forms, so they agree
    to float64 rounding."""
    cfg = get_config("deepseek-v2-lite-mla")
    assert mla.yarn_ramp(cfg) == (10.0, 23.0)
    inv = mla.yarn_inv_freq(cfg).numpy()
    i = np.arange(32)
    base = 1e4 ** (-2.0 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    np.testing.assert_allclose(inv, base / 40 * ramp + base * (1 - ramp),
                               rtol=1e-14)
    np.testing.assert_allclose(inv[:11], base[:11], rtol=1e-14)
    np.testing.assert_allclose(inv[23:], base[23:] / 40, rtol=1e-14)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert cfg.softmax_scale() == pytest.approx(192 ** -0.5 * m * m,
                                                rel=1e-15)


def _published_mla(p, cfg, x):
    """The published equations, not absorbed, in float32: per-head k_nope
    and v from the normed latent, the shared roped k_pe repeated to every
    head, causal softmax."""
    B, T, _ = x.shape
    H, dn, dr, dv, r = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    eps = cfg.norm_eps

    def rms(v, w):
        return v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + eps) * w

    h = rms(x, p["norm"])
    q = (h @ p["wq"]).view(B, T, H, dn + dr)
    kva = h @ p["wkva"]
    c = rms(kva[..., :r], p["kv_norm"])
    pos = torch.arange(T).expand(B, T)
    inv = mla.yarn_inv_freq(cfg)
    q_pe = mla.rope_yarn(q[..., dn:], pos, inv)
    k_pe = mla.rope_yarn(kva[..., None, r:], pos, inv).expand(B, T, H, dr)
    kv = (c @ p["wkvb"]).view(B, T, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe], -1)
    qf = torch.cat([q[..., :dn], q_pe], -1)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k) * cfg.softmax_scale()
    s = s.masked_fill(torch.ones(T, T).triu(1).bool(), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), kv[..., dn:])
    return x + out.reshape(B, T, H * dv) @ p["wo"]


def _params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = mla.mla_params(gen, cfg, torch.float32, "cpu")
    p["norm"] = 1 + 0.1 * torch.randn(p["norm"].shape, generator=gen)
    p["kv_norm"] = 1 + 0.1 * torch.randn(p["kv_norm"].shape, generator=gen)
    return p


def test_absorbed_read_equals_the_published_equations():
    """fp32, prefill over a dense latent cache and a decode round against
    it: the absorbed read (``q_nope W_kvb_k^T`` scored against the cached
    latent, the latent output times ``W_kvb_v``) equals the non-absorbed
    equations. The two associate the same products differently (and the
    port rounds q times the scale once more), so they agree to fp32
    rounding: 1e-5 of the largest output."""
    cfg = _cfg(rope_original_max=32)  # YaRN's ramp inside 40 positions
    p = _params(cfg)
    B, T = 2, 40
    x = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = _published_mla(p, cfg, x)
    cache = mla.init_latent(cfg, (B, T), dtype=torch.float32, device="cpu")
    got, _ = mla.mla_apply(p, cfg, x[:, :T - 1], mode="prefill", cache=cache,
                           norm_eps=cfg.norm_eps)
    tol = 1e-5 * want.abs().max()
    assert (got - want[:, :T - 1]).abs().max() <= tol
    last, _ = mla.mla_apply(p, cfg, x[:, T - 1:], mode="decode", cache=cache,
                            pos=T - 1, norm_eps=cfg.norm_eps)
    assert (last - want[:, T - 1:]).abs().max() <= tol


def test_paged_chunks_and_decode_write_and_read_the_latent_pool():
    """The paged branches (block-aligned chunks of two rows at different
    offsets over shuffled physical blocks, then a decode round) write one
    latent row a position into the pool and read the same function as the
    dense prefill: equal to fp32 rounding (1e-5 of the largest output; the
    batched rows sum in the same order, the chunks see a gathered table
    wider than their rows)."""
    cfg = _cfg()
    p = _params(cfg, 3)
    bs, P, B, T = 16, 4, 2, 48
    x = torch.randn(B, T + 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    want = _published_mla(p, cfg, x)
    pool = mla.init_latent(cfg, (1 + B * P, bs), dtype=torch.float32,
                           device="cpu")
    perm = torch.randperm(B * P, generator=torch.Generator().manual_seed(0))
    table = (1 + perm).reshape(B, P)
    for c0 in range(0, T, bs):
        out, _ = mla.mla_apply(
            p, cfg, x[:, c0:c0 + bs], mode="chunk", cache=pool,
            pos=torch.full((B,), c0),
            paged={"page_table": table, "write_blocks": table[:, c0 // bs]})
        assert (out - want[:, c0:c0 + bs]).abs().max() <= \
            1e-5 * want.abs().max()
    out, _ = mla.mla_apply(p, cfg, x[:, T:], mode="decode", cache=pool,
                           pos=torch.full((B,), T),
                           paged={"page_table": table})
    assert (out - want[:, T:]).abs().max() <= 1e-5 * want.abs().max()
    assert pool["ckv"].shape[-1] == cfg.kv_lora_rank + cfg.qk_rope_dim


def test_the_gathered_read_is_the_dense_read_of_the_gathered_rows():
    """The kernel's plain version, bit for bit: the pool's pages gathered
    in logical order, then the dense latent read; a vacant row (an
    all-null table at offset 0) reads the null block's first row."""
    torch.manual_seed(0)
    B, Tq, H, D, dv, bs, P = 3, 16, 16, 576, 512, 16, 5
    pool = {"ckv": torch.randn(1 + B * P, bs, D).to(torch.bfloat16)}
    table = torch.zeros(B, P, dtype=torch.long)
    table[:2] = 1 + torch.randperm(2 * P).reshape(2, P)
    q = torch.randn(B, Tq, H, D).to(torch.bfloat16)
    offs = torch.tensor([48, 16, 0])
    got = mla.gathered_mla(q, pool, table, offs, 0.11, dv)
    rows = pool["ckv"][table].reshape(B, P * bs, D)
    want = mla.latent_attention(q, rows, offs, 0.11, dv)
    assert torch.equal(got, want)
    assert torch.equal(got[2, 0], pool["ckv"][0, 0, :dv].expand(H, dv))


def test_an_int8_latent_pool_is_refused():
    eng = _engine()
    rt = dataclasses.replace(eng.rt, kv_quant=True)
    with pytest.raises(ValueError, match="int8 latent pool"):
        tr.init_paged_cache(rt, 9, 16)


def test_no_renorm_routing_weights_are_the_top_k_probabilities():
    """``renormalize=False``: the weights are the top-k softmax
    probabilities themselves, bit for bit; the default still divides them
    by their sum (the GQA models' routing, unchanged)."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(10, 32, generator=gen)
    w = torch.randn(32, 64, generator=gen)
    probs, topv, topi = M.route(w, h, 6, renormalize=False)
    want, idx = torch.sort(torch.softmax(h @ w, -1), dim=-1, descending=True,
                           stable=True)
    assert torch.equal(topi, idx[:, :6]) and torch.equal(topv, want[:, :6])
    assert float(topv.sum(-1).max()) < 1.0
    _, topv_n, topi_n = M.route(w, h, 6)
    assert torch.equal(topi_n, topi)
    assert torch.equal(topv_n, topv / torch.clamp(
        topv.sum(-1, keepdim=True), min=1e-9))


def test_shared_experts_add_a_swiglu_on_every_token():
    """The EP MoE block of a configuration with shared experts: the routed
    experts' output (dense oracle) plus one SwiGLU of the shared width on
    every normed token, whatever the placement; fp32, the EP and the dense
    paths summing the same products in other orders: 1e-5 of the
    largest."""
    cfg = _cfg()
    spec = M.EPSpec.build(N_EP, cfg, slots=4, capacity=64, slot_capacity=64)
    gen = torch.Generator().manual_seed(5)
    dense = M.moe_params_dense(gen, cfg, torch.float32, "cpu")
    assert dense["shared_w1"].shape == (cfg.d_model, 2 * cfg.d_ff)
    pl = M.placement_to(M.uniform_placement(N_EP, 4, cfg.num_experts), "cpu")
    ep = M.dense_to_ep(dense, pl)
    assert ep["shared_w1"] is dense["shared_w1"]
    x = torch.randn(2, 5, cfg.d_model, generator=gen)
    got, stats = M.moe_apply_ep(ep, cfg, x, spec=spec, placement=pl,
                                mode="prefill", norm_eps=cfg.norm_eps)
    want, _ = M.moe_apply_dense(dense, cfg, x, norm_eps=cfg.norm_eps)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    routed = {k: v for k, v in dense.items() if not k.startswith("shared")}
    bare, _ = M.moe_apply_dense(routed, cfg, x, norm_eps=cfg.norm_eps)
    h = tr.rms_norm(x, dense["norm"], cfg.norm_eps)
    shared = F.silu(h @ dense["shared_w1"]) * (h @ dense["shared_w3"]) \
        @ dense["shared_w2"]
    assert (want - bare - shared).abs().max() <= 1e-5 * want.abs().max()
    assert float(stats["counts"].sum()) == 10 * cfg.top_k


def _engine(dtype=torch.float32):
    """Reduced DeepSeek-V2-Lite over three virtual EP ranks of 4 slots,
    with capacities that drop nothing at these sizes."""
    from repro_torch.serving.engine import ServingEngine

    cfg = _cfg()
    spec = M.EPSpec.build(N_EP, cfg, slots=4, capacity=256, slot_capacity=256)
    rt = tr.Runtime(cfg=cfg, moe_impl="ep", ep_spec=spec, dtype=dtype,
                    device="cpu")
    dense = tr.init_params(dataclasses.replace(rt, moe_impl="dense"), 0)
    _, n_groups = cfg.layer_pattern()
    pls = tr.stack_placement(
        M.uniform_placement(N_EP, spec.slots, cfg.num_experts), n_groups)
    params = dict(dense, groups=M.regather_ep_groups(dense["groups"], pls,
                                                     n_groups))
    return ServingEngine(rt=rt, params=params, placement=pls,
                         dense_master=dense["groups"], max_len=96)


def test_the_dense_prefix_stays_outside_the_moe_groups():
    """One dense and two MoE layers: the engine's groups, its statistics
    and its placement cover the two MoE layers; the dense layer's
    parameters and its latent pool ride beside them (``prefix``, and the
    pool's ``prefix.b0``, which the copy-on-write clone copies too); served
    through the runtime, every MoE layer counts ``top_k`` rows a token."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.runtime import ServingRuntime

    eng = _engine()
    cfg = eng.rt.cfg
    assert eng.n_groups == 2 and eng.stats.counts.shape == (2, N_EP, 8)
    assert eng.placement.slot_to_expert.shape == (2, N_EP, 4)
    assert eng.params["prefix"]["b1"]["w1"].shape == (1, 256, 128)
    assert set(eng.params["groups"]) == {"b0", "b1"}
    rt = ServingRuntime(eng, max_slots=2, block_size=16)
    assert set(rt.pool) == {"prefix.b0", "b0"}
    assert rt.pool["prefix.b0"]["ckv"].shape[:2] == (1, rt.allocator.n_blocks)
    assert rt.pool["b0"]["ckv"].shape[:2] == (2, rt.allocator.n_blocks)
    pool = rt.pool
    for c in pool.values():
        c["ckv"][:, 3] = 1.0
    tr.copy_paged_block(pool, 3, 5)
    assert all(bool((c["ckv"][:, 5] == 1.0).all()) for c in pool.values())
    rng = np.random.default_rng(0)
    lens = (20, 35)
    hs = [rt.enqueue(Request(prompt=rng.integers(0, 512, n).astype(np.int32),
                             max_new_tokens=4, origin=o))
          for o, n in enumerate(lens)]
    rt.run()
    tokens = sum(n + len(h.tokens) - 1 for n, h in zip(lens, hs))
    per_layer = eng.stats.counts.sum(axis=(1, 2))
    assert np.array_equal(per_layer, np.full(2, tokens * cfg.top_k))
