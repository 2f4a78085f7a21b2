"""The port's EP MoE layer over virtual ranks against the reference's
``shard_map`` layer: outputs within fp32 tolerance (1e-5: the same
arithmetic, summed in another order), and the routing statistics —
``counts_per_rank``, ``local_frac`` and the rows dropped at capacity —
exactly. n_ep = 1 runs in process; n_ep = 3 holds the port against a
reference run in a subprocess on 3 fake CPU devices (the test process keeps
its single CPU device)."""

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


@pytest.mark.parametrize("capacity,slot_capacity", [(64, 64), (6, 5)])
def test_ep_matches_reference_three_ranks(tmp_path, capacity, slot_capacity):
    n_ep, S = 3, 3
    dense = _params(7)
    rng = np.random.default_rng(8)
    s2e = _s2e_replicated(n_ep, S, CFG.num_experts)
    inp = dict(dense, s2e=s2e, capacity=capacity,
               slot_capacity=slot_capacity)
    for mode, T in (("prefill", 5), ("decode", 1)):   # 4*5 rows: padded to 21
        inp["x_" + mode] = rng.standard_normal(
            (4, T, CFG.d_model)).astype(np.float32)
        inp["m_" + mode] = (rng.random((4, T)) > 0.2).astype(np.float32)
        inp["o_" + mode] = rng.integers(0, n_ep, (4,)).astype(np.int32)
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_N3, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    spec = TM.EPSpec(n_ep, S, capacity, slot_capacity)
    summary = {}
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
            summary[key] = float(want[1]["local_frac"])
    # the case is not degenerate: some rows route off-rank
    assert min(summary.values()) < 1.0, json.dumps(summary)
