"""The port's EP MoE layer over virtual ranks against the reference's
``shard_map`` layer: outputs within fp32 tolerance (1e-5: the same
arithmetic, summed in another order), and the routing statistics —
``counts_per_rank``, ``local_frac`` and the rows dropped at capacity —
exactly. n_ep = 1 runs in process; n_ep = 3 holds the port against a
reference run in a subprocess on 3 fake CPU devices (the test process keeps
its single CPU device), also at the serving cells' capacities, where the
port sizes its buffers by the rows a call routes and the reference by the
capacities."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import moe as JM
from repro_torch.models import moe as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = get_config("mixtral-8x7b").reduced()
ATOL = 1e-5


def _params(seed=0, scale_router=1.0):
    rng = np.random.default_rng(seed)
    d, f, E = CFG.d_model, CFG.d_ff, CFG.num_experts
    return {
        "norm": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        "router": (rng.standard_normal((d, E)) * d ** -0.5
                   * scale_router).astype(np.float32),
        "w1": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w3": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w2": (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32),
    }


def _s2e_replicated(n_ep, S, E):
    """Every rank holds experts r, r+n_ep, ... plus replicas of the hottest
    ones in its spare slots (exercises nearest-replica routing)."""
    s2e = -np.ones((n_ep, S), np.int32)
    for r in range(n_ep):
        own = list(range(r, E, n_ep))
        extra = [e for e in range(E) if e not in own]
        s2e[r] = (own + extra)[:S]
    return s2e


def _port(dense, s2e, spec, x, mode, mask=None, origin=None):
    pl = TM.placement_from_tables(s2e, num_experts=CFG.num_experts)
    ep = TM.dense_to_ep({k: torch.from_numpy(v) for k, v in dense.items()},
                        pl)
    out, st = TM.moe_apply_ep(
        ep, CFG, torch.from_numpy(x), spec=spec,
        placement=TM.placement_to(pl, "cpu"), mode=mode,
        token_mask=None if mask is None else torch.from_numpy(mask),
        origin=None if origin is None else torch.from_numpy(origin))
    return out.numpy(), {k: v.numpy() for k, v in st.items()}


def _ref(dense, s2e, spec_args, x, mode, mask=None, origin=None):
    mesh = make_test_mesh(1, 1)
    spec = JM.EPSpec.build(mesh, CFG, ep_axes=("model",), **spec_args)
    pl = JM.placement_from_tables(s2e, num_experts=CFG.num_experts)
    ep = JM.dense_to_ep({k: jnp.asarray(v) for k, v in dense.items()}, pl)
    fn = jax.jit(lambda p, xx, q, m, o: JM.moe_apply_ep(
        p, CFG, xx, mesh=mesh, spec=spec, placement=q, mode=mode,
        token_mask=m, origin=o))
    out, st = fn(ep, jnp.asarray(x), pl,
                 None if mask is None else jnp.asarray(mask),
                 None if origin is None else jnp.asarray(origin))
    return np.asarray(out), {k: np.asarray(v) for k, v in st.items()}


def _compare(a, b):
    (oa, sa), (ob, sb) = a, b
    np.testing.assert_allclose(oa, ob, atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(sa["counts_per_rank"], sb["counts_per_rank"])
    np.testing.assert_array_equal(sa["counts"], sb["counts"])
    assert float(sa["local_frac"]) == float(sb["local_frac"])
    np.testing.assert_allclose(sa["aux_loss"], sb["aux_loss"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("capacity,slot_capacity", [(64, 32), (8, 2)])
def test_ep_matches_reference_single_rank(mode, capacity, slot_capacity):
    """(8, 2) saturates the capacities: dropped rows must match."""
    dense = _params(1)
    x = np.random.default_rng(2).standard_normal(
        (4, 8 if mode == "prefill" else 1, CFG.d_model)).astype(np.float32)
    mask = (np.random.default_rng(3).random(x.shape[:2]) > 0.25
            ).astype(np.float32)
    s2e = np.arange(CFG.num_experts, dtype=np.int32)[None]
    args = dict(slots=CFG.num_experts, capacity=capacity,
                slot_capacity=slot_capacity)
    spec = TM.EPSpec(1, CFG.num_experts, capacity, slot_capacity)
    got = _port(dense, s2e, spec, x, mode, mask)
    _compare(got, _ref(dense, s2e, args, x, mode, mask))
    if capacity == 8:   # saturated: some (token, expert) pairs were dropped
        full = _port(dense, s2e, TM.EPSpec(1, CFG.num_experts, 64, 64), x,
                     mode, mask)
        assert np.abs(full[0] - got[0]).max() > 1e-3


def test_topk_ties_go_to_the_lowest_expert():
    """A zero router makes every expert tie: lax.top_k picks 0 and 1."""
    dense = _params(4)
    dense["router"][:] = 0.0
    x = np.random.default_rng(5).standard_normal(
        (2, 4, CFG.d_model)).astype(np.float32)
    s2e = np.arange(CFG.num_experts, dtype=np.int32)[None]
    args = dict(slots=CFG.num_experts, capacity=32, slot_capacity=32)
    got = _port(dense, s2e, TM.EPSpec(1, CFG.num_experts, 32, 32), x,
                "prefill")
    _compare(got, _ref(dense, s2e, args, x, "prefill"))
    np.testing.assert_array_equal(got[1]["counts"], [8, 8, 0, 0])
    _, _, topi = TM.route(torch.zeros(4, 4), torch.ones(3, 4), 2)
    assert topi.tolist() == [[0, 1]] * 3


_REF_N3 = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh, set_mesh
from repro.models import moe as JM
cfg = get_config("mixtral-8x7b").reduced()
inp = np.load(sys.argv[1])
out = {}
mesh = make_test_mesh(1, 3)
spec = JM.EPSpec.build(mesh, cfg, ep_axes=("model",), slots=3,
                       capacity=int(inp["capacity"]),
                       slot_capacity=int(inp["slot_capacity"]))
pl = JM.placement_from_tables(inp["s2e"], num_experts=cfg.num_experts)
ep = JM.dense_to_ep({k: jnp.asarray(inp[k]) for k in
                     ("norm", "router", "w1", "w3", "w2")}, pl)
with set_mesh(mesh):
    for mode in ("prefill", "decode"):
        for tag in ("plain", "origin"):
            x = inp["x_" + mode]
            org = jnp.asarray(inp["o_" + mode]) if tag == "origin" else None
            fn = jax.jit(lambda p, xx, q, m, o, mode=mode: JM.moe_apply_ep(
                p, cfg, xx, mesh=mesh, spec=spec, placement=q, mode=mode,
                token_mask=m, origin=o))
            o, st = fn(ep, jnp.asarray(x), pl,
                       jnp.asarray(inp["m_" + mode]), org)
            key = mode + "_" + tag
            out[key + "_out"] = np.asarray(o)
            for k, v in st.items():
                out[key + "_" + k] = np.asarray(v)
np.savez(sys.argv[2], **out)
'''


def _inputs_n3(dense, s2e, capacity, slot_capacity, shapes, seed=8):
    """The reference script's inputs: ``shapes`` maps each mode to the
    [B, T] of its x, drawn with a row mask and per-row origins."""
    rng = np.random.default_rng(seed)
    inp = dict(dense, s2e=s2e, capacity=capacity,
               slot_capacity=slot_capacity)
    for mode, (B, T) in shapes.items():
        inp["x_" + mode] = rng.standard_normal(
            (B, T, CFG.d_model)).astype(np.float32)
        inp["m_" + mode] = (rng.random((B, T)) > 0.2).astype(np.float32)
        inp["o_" + mode] = rng.integers(0, 3, (B,)).astype(np.int32)
    return inp


def _compare_n3(tmp_path, dense, s2e, inp):
    """Run the reference on 3 devices and the port on 3 virtual ranks over
    ``inp``, in both modes, with and without origins; compare each.
    Returns {mode_tag: the reference's (out, stats)}."""
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_N3, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    spec = TM.EPSpec(3, s2e.shape[1], int(inp["capacity"]),
                     int(inp["slot_capacity"]))
    wants = {}
    for mode in ("prefill", "decode"):
        for tag in ("plain", "origin"):
            key = mode + "_" + tag
            org = inp["o_" + mode] if tag == "origin" else None
            got = _port(dense, s2e, spec, inp["x_" + mode], mode,
                        inp["m_" + mode], org)
            want = (ref[key + "_out"],
                    {k: ref[key + "_" + k] for k in
                     ("counts", "counts_per_rank", "local_frac", "aux_loss")})
            _compare(got, want)
            wants[key] = want
    return wants


@pytest.mark.parametrize("capacity,slot_capacity", [(64, 64), (6, 5)])
def test_ep_matches_reference_three_ranks(tmp_path, capacity, slot_capacity):
    dense = _params(7)
    s2e = _s2e_replicated(3, 3, CFG.num_experts)
    # 4 x 5 prefill rows: padded to 21
    wants = _compare_n3(tmp_path, dense, s2e, _inputs_n3(
        dense, s2e, capacity, slot_capacity,
        {"prefill": (4, 5), "decode": (4, 1)}))
    summary = {k: float(w[1]["local_frac"]) for k, w in wants.items()}
    # the case is not degenerate: some rows route off-rank
    assert min(summary.values()) < 1.0, json.dumps(summary)


SERVING_CAPACITIES = (8192, 16384)  # the serving cells' (C, C2)


@pytest.mark.parametrize("case", ["few_rows", "pairs_just_below_c"])
def test_ep_matches_reference_at_the_serving_capacities(tmp_path, case):
    """At the serving cells' C = 8192 and C2 = 16384 over 3 ranks the port
    sizes its buffers by the rows a call routes. ``few_rows``: the
    three-rank case's 21 prefill and 4 decode rows. ``pairs_just_below_c``:
    R = 4095 rows a device, R K = 8190 pairs just below C, and 4095 decode
    rows, under a zero router (every token picks experts 0 and 1) with
    both experts only on rank 0: every pair of a device fills its one
    bucket to R K, and expert 0's slot takes all n R rows (decode: all
    4095), each capacity in force to its last row."""
    dense = _params(9)
    C, C2 = SERVING_CAPACITIES
    if case == "few_rows":
        s2e = _s2e_replicated(3, 3, CFG.num_experts)
        shapes = {"prefill": (4, 5), "decode": (4, 1)}
    else:
        dense["router"][:] = 0.0
        s2e = np.array([[0, 1, 2], [2, 3, -1], [3, 2, -1]], np.int32)
        shapes = {"prefill": (819, 15), "decode": (4095, 1)}
    spec = TM.EPSpec(3, 3, C, C2)
    (Bp, Tp), (Bd, _) = shapes["prefill"], shapes["decode"]
    R = -(-Bp * Tp // 3)
    assert TM.ep_call_capacities(spec, CFG.top_k, Bp, Tp, "prefill") == (
        min(C, R * CFG.top_k), min(C2, 3 * R))
    assert TM.ep_call_capacities(spec, CFG.top_k, Bd, 1, "decode") == (
        0, min(C2, Bd))
    inp = _inputs_n3(dense, s2e, C, C2, shapes)
    wants = _compare_n3(tmp_path, dense, s2e, inp)
    if case == "pairs_just_below_c":
        assert R * CFG.top_k == C - 2
        for key, (out, st) in wants.items():
            c = st["counts"]   # every counted token picked experts 0 and 1
            assert c[0] == c[1] == c.sum() / 2 > 0, key
        for mode in ("prefill", "decode"):   # and no pair was dropped
            full, _ = TM.moe_apply_dense(
                {k: torch.from_numpy(v) for k, v in dense.items()}, CFG,
                torch.from_numpy(inp["x_" + mode]))
            np.testing.assert_allclose(wants[mode + "_plain"][0],
                                       full.numpy(), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("caps,K,B,T,mode,want", [
    # R K >= C and n R >= C2 (R = 5462): the spec's capacities
    (SERVING_CAPACITIES, 2, 2, 8192, "train", (8192, 16384)),
    # R K = C (R = 4096): the spec's send capacity; n R = 12288 < C2: the
    # slot capacity reaches the spec's at its own bound, n R >= C2
    (SERVING_CAPACITIES, 2, 1, 12288, "prefill", (8192, 12288)),
    (SERVING_CAPACITIES, 2, 16384, 1, "decode", (0, 16384)),
    (SERVING_CAPACITIES, 2, 24576, 1, "decode", (0, 16384)),
    # a chat chunk call (4 rows x 16 tokens) and decode round (32 rows)
    (SERVING_CAPACITIES, 2, 4, 16, "chunk", (44, 66)),
    (SERVING_CAPACITIES, 2, 32, 1, "decode", (0, 32)),
    # DeepSeek-V2-Lite's cell sizes C and C2 to its largest chunk call
    # (32 x 16 tokens, top-6): unchanged there; its decode rounds shrink
    ((1026, 513), 6, 32, 16, "chunk", (1026, 513)),
    ((1026, 513), 6, 32, 1, "decode", (0, 32)),
])
def test_capacities_in_force_reach_the_spec(caps, K, B, T, mode, want):
    """``ep_call_capacities`` over 3 ranks: each capacity is the call's
    bound where that is below the spec's, and the spec's once the call's
    shape reaches it."""
    assert TM.ep_call_capacities(TM.EPSpec(3, 4, *caps), K, B, T,
                                 mode) == want
