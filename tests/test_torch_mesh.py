"""The port's virtual meshes against the reference's device meshes on the
CPU: the EP layer on a 2x4 mesh in its three branches (decode gather,
dispatch, sequence-sharded), EP over ("data", "model") and over "model"
alone (two groups), with and without origins, at capacity factor 0.5 —
outputs within fp32 tolerance (1e-5), the dropped rows, ``counts`` and
``counts_per_rank`` and ``local_frac`` exactly; the four layouts on
reduced TinyLlama and Mixtral at the reference's own bounds
(``tests/md_scripts/layout_equivalence.py``: loss within 2e-3, logits
within 5e-4), with the MoE routing statistics exact; decode on the mesh
and with ``cache_seq_sharded`` within 1e-5; the per-device argument bytes
of compiled steps exactly as ``memory_analysis()`` gives them; the EP
geometry of the production meshes. The reference runs once, in a
subprocess on 8 fake CPU devices (this process keeps its single CPU
device), and hands its results over as npz."""

import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import dryrun as jdryrun
from repro.models import moe as JM
from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh)
from repro_torch.models import attention as tattn
from repro_torch.models import moe as TM
from repro_torch.models import transformer as ttr

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = make_test_mesh(2, 4)
CFG = get_config("mixtral-8x7b").reduced()
EP_AXES = {"dm": ("data", "model"), "m": ("model",)}
BRANCHES = ("decode", "dispatch", "seq")
LAYOUTS = ("tp", "sp", "cp", "fsdp")
# rows per device that EPSpec.build sizes the send capacity for: 4 x 128
# prefill rows over 8 devices, 16 decode rows over the 2 data shards, and
# the layout runs' 4 x 64 tokens over 8 devices
ROWS = {"dispatch": 64, "seq": 64, "decode": 8, "layout": 32}
DECODE_SLOT_CAPACITY = 4  # decode drops come from the slot capacity alone
# compiled steps whose per-device argument bytes are compared (arch,
# shape, build_lowerable keywords), at 4 x 32 tokens
MA_CASES = [("tinyllama-1.1b", "train_4k", {}),
            ("tinyllama-1.1b", "train_4k", {"layout": "cp"}),
            ("phi3.5-moe-42b-a6.6b", "train_4k", {"layout": "fsdp"}),
            ("phi3.5-moe-42b-a6.6b", "prefill_32k", {"layout": "sp"}),
            ("falcon-mamba-7b", "decode_32k", {}),
            ("tinyllama-1.1b", "long_500k", {}),
            ("zamba2-2.7b", "decode_32k", {"kv_quant": True})]

_REF = r'''
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint.io import save_checkpoint
from repro.configs import get_config
from repro.configs.base import INPUT_SHAPES
from repro.launch import dryrun
from repro.launch.mesh import make_test_mesh, set_mesh
from repro.models import moe as JM
from repro.models import transformer as jtr
inp = np.load(sys.argv[1])
out_dir = sys.argv[2]
out = {}
mesh = make_test_mesh(2, 4)
moe_cfg = get_config("mixtral-8x7b").reduced()
EP_AXES = {"dm": ("data", "model"), "m": ("model",)}


def ep_spec(cfg, tag, branch):
    kw = dict(ep_axes=EP_AXES[tag], capacity_factor=0.5,
              rows_per_rank=int(inp["rows_" + branch]))
    if branch == "decode":
        kw["slot_capacity"] = int(inp["decode_slot_capacity"])
    return JM.EPSpec.build(mesh, cfg, **kw)


with set_mesh(mesh):
    dense = {k: jnp.asarray(inp[k]) for k in ("norm", "router", "w1", "w3",
                                               "w2")}
    for tag in EP_AXES:
        pl = JM.placement_from_tables(inp["s2e_" + tag],
                                      num_experts=moe_cfg.num_experts)
        ep = JM.dense_to_ep(dense, pl)
        for branch in ("decode", "dispatch", "seq"):
            spec = ep_spec(moe_cfg, tag, branch)
            mode = "decode" if branch == "decode" else "prefill"
            x = jnp.asarray(inp["x_" + mode])
            for use_o in (0, 1):
                fn = jax.jit(lambda p, xx, q, m, o, mode=mode, spec=spec,
                             seq=branch == "seq": JM.moe_apply_ep(
                    p, moe_cfg, xx, mesh=mesh, spec=spec, placement=q,
                    mode=mode, seq_sharded_out=seq, token_mask=m, origin=o))
                o, st = fn(ep, x, pl, jnp.asarray(inp["m_" + mode]),
                           jnp.asarray(inp[f"o_{mode}_{tag}"]) if use_o
                           else None)
                key = f"ep_{tag}_{branch}_{use_o}"
                out[key + "_out"] = np.asarray(o)
                for k, v in st.items():
                    out[key + "_" + k] = np.asarray(v)

    toks = jnp.asarray(inp["tokens"])
    for arch in ("tinyllama-1.1b", "mixtral-8x7b"):
        cfg = get_config(arch).reduced()
        key = jax.random.PRNGKey(0)
        if cfg.is_moe:
            _, n_groups = cfg.layer_pattern()
            params = jtr.init_params(
                jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl="dense"), key)
            pl = JM.placement_from_tables(inp["s2e_dm"],
                                          num_experts=cfg.num_experts)
            pls = jtr.stack_placement(pl, n_groups)
            params = dict(params, groups=JM.regather_ep_groups(
                params["groups"], pls, n_groups))
            rt_kw = dict(moe_impl="ep", ep_spec=ep_spec(cfg, "dm", "layout"))
        else:
            params = jtr.init_params(jtr.Runtime(cfg=cfg, mesh=mesh), key)
            pls, rt_kw = None, {}
        save_checkpoint(os.path.join(out_dir, "lay_" + arch), params)
        for layout in ("tp", "sp", "cp", "fsdp"):
            rt = jtr.Runtime(cfg=cfg, mesh=mesh, layout=layout,
                             remat_policy="dots+kv" if layout != "tp"
                             else "none", **rt_kw)
            loss, met = jax.jit(lambda p, t, q, rt=rt: jtr.loss_fn(
                rt, p, t, jnp.roll(t, -1, 1), q))(params, toks, pls)
            lg, _, st = jax.jit(lambda p, t, q, rt=rt: jtr.prefill(
                rt, p, tokens=t, placement=q))(params, toks, pls)
            k = f"lay_{arch}_{layout}"
            out[k + "_loss"] = np.asarray(loss)
            out[k + "_logits"] = np.asarray(lg)
            if st is not None:
                out[k + "_counts"] = np.asarray(st["counts_per_rank"])
                out[k + "_local"] = np.asarray(st["local_frac"])
                out[k + "_train_counts"] = np.asarray(met["expert_counts"])

    cfg = get_config("tinyllama-1.1b").reduced()
    params = jtr.init_params(jtr.Runtime(cfg=cfg, mesh=mesh),
                             jax.random.PRNGKey(0))
    for name, B, css in (("mesh", 2, False), ("css", 1, True)):
        rt = jtr.Runtime(cfg=cfg, mesh=mesh, cache_seq_sharded=css)
        _, cache, _ = jax.jit(lambda p, t, rt=rt: jtr.prefill(
            rt, p, tokens=t, cache_len=32))(params, toks[:B, :24])
        lg, _, _ = jax.jit(lambda p, c, t, rt=rt: jtr.decode_step(
            rt, p, c, t, jnp.int32(24)))(params, cache, toks[:B, 24:25])
        out[f"dec_{name}_logits"] = np.asarray(lg)

for i, c in enumerate(inp["ma_cases"]):
    arch, shp, kw = eval(str(c))
    cfg = get_config(arch).reduced()
    shape = dataclasses.replace(INPUT_SHAPES[shp], seq_len=32, global_batch=4)
    fn, kwargs = dryrun.build_lowerable(cfg, shape, mesh, **kw)
    with set_mesh(mesh):
        compiled = jax.jit(fn).lower(**kwargs).compile()
    out[f"ma_{i}"] = np.int64(compiled.memory_analysis().argument_size_in_bytes)
np.savez(os.path.join(out_dir, "ref.npz"), **out)
'''


def _s2e(rng, n, S, E):
    """Each rank holds expert ``r % E`` and random others in its spare
    slots: every expert placed, most replicated."""
    t = -np.ones((n, S), np.int32)
    for r in range(n):
        own = [r % E]
        t[r] = (own + [int(e) for e in rng.permutation(E) if e not in own])[:S]
    return t


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Inputs drawn from a seed, the reference's run on them, and its
    results."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    d, f, E = CFG.d_model, CFG.d_ff, CFG.num_experts
    inp = {
        "norm": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        "router": (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32),
        "w1": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w3": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
        "w2": (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32),
        "s2e_dm": _s2e(rng, 8, 2, E), "s2e_m": _s2e(rng, 4, 2, E),
        "x_prefill": rng.standard_normal((4, 128, d)).astype(np.float32),
        "m_prefill": (rng.random((4, 128)) > 0.2).astype(np.float32),
        "o_prefill_dm": rng.integers(0, 8, (4,)).astype(np.int32),
        "o_prefill_m": rng.integers(0, 4, (4,)).astype(np.int32),
        "x_decode": rng.standard_normal((16, 1, d)).astype(np.float32),
        "m_decode": (rng.random((16,)) > 0.2).astype(np.float32),
        "o_decode_dm": rng.integers(0, 8, (16,)).astype(np.int32),
        "o_decode_m": rng.integers(0, 4, (16,)).astype(np.int32),
        "decode_slot_capacity": DECODE_SLOT_CAPACITY,
        "tokens": rng.integers(0, 512, (4, 64)).astype(np.int32),
        "ma_cases": np.array([repr(c) for c in MA_CASES]),
    }
    inp.update({"rows_" + k: v for k, v in ROWS.items()})
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF, str(tmp / "in.npz"),
                          str(tmp)], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return inp, dict(np.load(tmp / "ref.npz")), tmp


def _spec(tag, branch, **over):
    kw = dict(ep_axes=EP_AXES[tag], capacity_factor=0.5,
              rows_per_rank=ROWS[branch])
    if branch == "decode":
        kw["slot_capacity"] = DECODE_SLOT_CAPACITY
    kw.update(over)
    return TM.EPSpec.build(MESH, CFG, **kw)


def _port_ep(inp, tag, branch, use_o, spec):
    mode = "decode" if branch == "decode" else "prefill"
    pl = TM.placement_to(TM.placement_from_tables(
        inp["s2e_" + tag], num_experts=CFG.num_experts), "cpu")
    ep = TM.dense_to_ep({k: torch.from_numpy(inp[k]) for k in
                         ("norm", "router", "w1", "w3", "w2")}, pl)
    out, st = TM.moe_apply_ep(
        ep, CFG, torch.from_numpy(inp["x_" + mode]), spec=spec,
        placement=pl, mode=mode, mesh=MESH, seq_sharded_out=branch == "seq",
        token_mask=torch.from_numpy(inp["m_" + mode]),
        origin=torch.from_numpy(inp[f"o_{mode}_{tag}"]) if use_o else None)
    return out.numpy(), {k: v.numpy() for k, v in st.items()}


def _dropped(out, full):
    """Rows whose output differs from the uncapped layer's: a (token,
    expert) pair of the row was dropped at a capacity."""
    return np.abs(out - full).reshape(-1, out.shape[-1]).max(-1) > 1e-4


@pytest.mark.parametrize("use_o", [0, 1])
@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("tag", list(EP_AXES))
def test_ep_on_a_2x4_mesh_matches_the_reference(ref, tag, branch, use_o):
    inp, want, _ = ref
    key = f"ep_{tag}_{branch}_{use_o}"
    spec = _spec(tag, branch)
    assert spec.axes == EP_AXES[tag] and spec.mesh_axes == ("data", "model")
    out, st = _port_ep(inp, tag, branch, use_o, spec)
    np.testing.assert_allclose(out, want[key + "_out"], atol=1e-5, rtol=1e-5)
    for k in ("counts", "counts_per_rank"):
        np.testing.assert_array_equal(st[k], want[key + "_" + k])
    assert float(st["local_frac"]) == float(want[key + "_local_frac"])
    np.testing.assert_allclose(st["aux_loss"], want[key + "_aux_loss"],
                               rtol=1e-5)
    full, _ = _port_ep(inp, tag, branch, use_o, _spec(
        tag, branch, capacity=4096, slot_capacity=4096))
    dropped = _dropped(out, full)
    np.testing.assert_array_equal(dropped, _dropped(want[key + "_out"], full))
    assert dropped.any(), "capacity factor 0.5 dropped nothing"


def test_ep_ownership_follows_the_mesh(ref):
    """The same rows, weights and placement on the same 8 EP ranks give
    other drops and statistics on a (2, 4) mesh's dispatch rows, its
    sequence blocks and a (1, 8) mesh: which device owns which rows
    decides what is dropped."""
    inp, want, _ = ref
    spec18 = TM.EPSpec.build(make_test_mesh(1, 8), CFG,
                             ep_axes=("data", "model"), capacity_factor=0.5,
                             rows_per_rank=ROWS["dispatch"])
    pl = TM.placement_to(TM.placement_from_tables(
        inp["s2e_dm"], num_experts=CFG.num_experts), "cpu")
    ep = TM.dense_to_ep({k: torch.from_numpy(inp[k]) for k in
                         ("norm", "router", "w1", "w3", "w2")}, pl)
    out18, _ = TM.moe_apply_ep(ep, CFG, torch.from_numpy(inp["x_prefill"]),
                               spec=spec18, placement=pl, mode="prefill",
                               mesh=make_test_mesh(1, 8),
                               seq_sharded_out=True)
    a, b = want["ep_dm_dispatch_0_out"], want["ep_dm_seq_0_out"]
    assert np.abs(a - b).max() > 1e-3
    assert np.abs(out18.numpy() - b).max() > 1e-3


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_layouts_match_the_reference(ref, arch, layout):
    """The reference's weights (its checkpoint, read by the port's
    ``load_checkpoint``), the same tokens, the same 2x4 mesh: loss within
    2e-3 and last-token logits within 5e-4 (the reference's own bounds
    between its layouts); for Mixtral (EP over all 8 devices at capacity
    factor 0.5) the prefill's per-origin counts and local ratio and the
    train step's counts exactly, layout by layout."""
    inp, want, tmp = ref
    cfg = get_config(arch).reduced()
    params, _, _ = load_checkpoint(tmp / f"lay_{arch}", device="cpu")
    kw, pls = {}, None
    if cfg.is_moe:
        _, n_groups = cfg.layer_pattern()
        kw = dict(moe_impl="ep", ep_spec=TM.EPSpec.build(
            MESH, cfg, ep_axes=EP_AXES["dm"], capacity_factor=0.5,
            rows_per_rank=ROWS["layout"]))
        pls = TM.placement_to(ttr.stack_placement(TM.placement_from_tables(
            inp["s2e_dm"], num_experts=cfg.num_experts), n_groups), "cpu")
    rt = ttr.Runtime(cfg=cfg, mesh=MESH, layout=layout, device="cpu",
                     remat_policy="dots+kv" if layout != "tp" else "none",
                     **kw)
    toks = torch.from_numpy(inp["tokens"]).long()
    with torch.no_grad():
        loss, met = ttr.loss_fn(rt, params, toks, torch.roll(toks, -1, 1), pls)
    lg, _, st = ttr.prefill(rt, params, tokens=toks, placement=pls)
    k = f"lay_{arch}_{layout}"
    assert abs(float(loss) - float(want[k + "_loss"])) < 2e-3
    assert np.abs(lg.numpy() - want[k + "_logits"]).max() < 5e-4
    if cfg.is_moe:
        np.testing.assert_array_equal(st["counts_per_rank"].numpy(),
                                      want[k + "_counts"])
        np.testing.assert_array_equal(st["local_frac"].numpy(),
                                      want[k + "_local"])
        np.testing.assert_array_equal(met["expert_counts"].numpy(),
                                      want[k + "_train_counts"])


@pytest.mark.parametrize("name,B,css", [("mesh", 2, False), ("css", 1, True)])
def test_decode_on_the_mesh_matches_the_reference(ref, name, B, css):
    """Decode on the 2x4 mesh, with and without ``cache_seq_sharded`` (the
    reference's cache over every axis; the port's paged pool refuses it)."""
    inp, want, tmp = ref
    cfg = get_config("tinyllama-1.1b").reduced()
    params, _, _ = load_checkpoint(tmp / "lay_tinyllama-1.1b", device="cpu")
    rt = ttr.Runtime(cfg=cfg, mesh=MESH, cache_seq_sharded=css, device="cpu")
    toks = torch.from_numpy(inp["tokens"]).long()
    _, cache, _ = ttr.prefill(rt, params, tokens=toks[:B, :24], cache_len=32)
    lg, _, _ = ttr.decode_step(rt, params, cache, toks[:B, 24:25], 24)
    np.testing.assert_allclose(lg.numpy(), want[f"dec_{name}_logits"],
                               atol=1e-5, rtol=1e-5)
    assert not ttr.supports_paging(rt) if css else ttr.supports_paging(rt)


@pytest.mark.parametrize("case", range(len(MA_CASES)))
def test_per_device_argument_bytes_equal_memory_analysis(ref, case):
    """One device's bytes of every argument the compiled step reads. The
    port keeps the optimizer's step counter on the host, where the
    reference's state holds a 4-byte int32: train steps differ by it."""
    _, want, _ = ref
    arch, shp, kw = MA_CASES[case]
    shape = dataclasses.replace(INPUT_SHAPES[shp], seq_len=32, global_batch=4)
    rec = dryrun.analyse(get_config(arch).reduced(), shape, MESH, **kw)
    counter = 4 if shape.kind == "train" else 0
    assert rec["device_argument_size_in_bytes"] + counter == int(
        want[f"ma_{case}"])
    assert rec["device_argument_size_in_bytes"] < rec["argument_size_in_bytes"]


def _fake_mesh(vm):
    """What the reference's ``make_runtime`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=vm.axis_names, shape=vm.shape,
                                 devices=np.empty(vm.axis_sizes, np.int8))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "phi3.5-moe-42b-a6.6b", "mixtral-8x7b"])
def test_ep_geometry_on_the_production_meshes(arch, multi_pod, shape):
    """``EPSpec.build`` and ``make_runtime`` on 16x16 and 2x16x16: the
    reference reads only the mesh's axis names and sizes, so it runs here
    on the port's ``VirtualMesh``."""
    vm = make_production_mesh(multi_pod=multi_pod)
    assert vm.size == (512 if multi_pod else 256)
    j = jdryrun.make_runtime(jget_config(arch), INPUT_SHAPES[shape],
                             _fake_mesh(vm))
    t = dryrun.make_runtime(get_config(arch), INPUT_SHAPES[shape], vm)
    js, ts = j.ep_spec, t.ep_spec
    for f in ("n_ep", "slots", "capacity", "slot_capacity", "axes",
              "mesh_axes", "batch_axes", "dispatch_row_axes"):
        assert getattr(ts, f) == getattr(js, f), f
    assert (t.ep, t.ep_axes, t.window, t.cache_seq_sharded) == \
        (j.ep, j.ep_axes, j.window, j.cache_seq_sharded)
    direct = JM.EPSpec.build(vm, jget_config(arch), ep_axes=("model",))
    mine = TM.EPSpec.build(vm, get_config(arch), ep_axes=("model",))
    assert dataclasses.astuple(mine) == (direct.n_ep, direct.slots,
                                         direct.capacity,
                                         direct.slot_capacity, direct.axes,
                                         direct.mesh_axes)


def test_dots_kv_keeps_the_gathered_kv_under_cp_and_fsdp():
    """Under cp and fsdp on a mesh every attention layer's train forward
    makes the gathered k and v (``kv_gathered``), which ``dots+kv`` saves
    and ``dots`` recomputes; under tp and sp there are none."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import CheckpointPolicy

    class Named(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if tattn.naming_kv():
                Named.n += 1
                assert ttr._dots_kv_saveable(None, func) == \
                    CheckpointPolicy.MUST_SAVE
                assert ttr._dots_saveable(None, func) == \
                    CheckpointPolicy.PREFER_RECOMPUTE
            return func(*args, **(kwargs or {}))

    cfg = get_config("tinyllama-1.1b").reduced()
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    for layout in LAYOUTS:
        rt = ttr.Runtime(cfg=cfg, mesh=MESH, layout=layout, device="cpu",
                         remat_policy="dots+kv")
        params = ttr.init_params(rt, 0)
        Named.n = 0
        with Named(), torch.no_grad():
            ttr.loss_fn(rt, params, toks, toks)
        assert Named.n == (2 * cfg.num_layers
                           if layout in ("cp", "fsdp") else 0), layout
