"""The port's launch tooling (``repro_torch.launch.{mesh,roofline,dryrun,
perf}``) against the reference's ``repro.launch`` on the CPU: the model
FLOPs, the roofline terms (the TPU constants swapped for the H100's), the
EP geometry, the depth helpers, the best layout and the meta step's
argument bytes equal the reference's; the counted FLOPs of a dense prefill
and the collective counters of an EP step equal their formulas; every
assigned arch's reduced config dry-runs on meta at the four input shapes
with sane roofline terms, on one card and on the production meshes; and
every one of the reference's 16 perf variants runs on meta."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import dryrun as jdryrun
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun, mesh, perf, roofline
from repro_torch.models import moe as tmoe

ARCHS = dryrun.ASSIGNED_ARCHS
SHAPES = list(INPUT_SHAPES)
PAIRS = [(a, s) for a in ARCHS for s in SHAPES]
MOE_ARCHS = [a for a in ARCHS if get_config(a).is_moe]


def _small(name, seq_len=32, batch=2):
    """An input shape of the same name and kind at a small size."""
    return dataclasses.replace(INPUT_SHAPES[name], seq_len=seq_len,
                               global_batch=batch)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_equal_the_reference(arch, shape):
    assert roofline.model_flops(get_config(arch), INPUT_SHAPES[shape]) == \
        jroof.model_flops(jget_config(arch), INPUT_SHAPES[shape])


@pytest.mark.parametrize("kind", ["train_4k", "decode_32k"])
def test_roofline_report_is_the_reference_with_h100_constants(kind):
    rec = {"hlo_flops": 3.2e15, "hlo_bytes": 7.0e12,
           "argument_size_in_bytes": 5.0e10, "output_size_in_bytes": 6.0e10,
           "collectives": {"total_bytes": 2.5e10},
           "donated_cache": kind == "decode_32k"}
    cfg, shape = get_config("yi-6b"), INPUT_SHAPES[kind]
    got = roofline.roofline_report(rec, cfg, shape, n_chips=1)
    want = jroof.roofline_report(rec, jget_config("yi-6b"), shape, n_chips=1)
    assert set(got) == set(want)
    scale = {"compute_s": jmesh.PEAK_FLOPS / mesh.PEAK_FLOPS,
             "memory_s": jmesh.HBM_BW / mesh.HBM_BW,
             "collective_s": jmesh.ICI_BW / (mesh.HBM_BW / 2)}
    for k, s in scale.items():
        assert got[k] == pytest.approx(want[k] * s, rel=1e-12), k
    assert got["memory_s_hlo"] is None
    assert got["model_flops_global"] == want["model_flops_global"]
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    terms = {k: got[k] for k in scale}
    assert got["dominant"] == max(terms, key=terms.get).removesuffix("_s")
    assert got["step_time_lower_bound_s"] == max(terms.values())
    assert got["mfu_bound"] == pytest.approx(
        want["model_flops_global"] / (mesh.PEAK_FLOPS * max(terms.values())),
        rel=1e-12)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in MOE_ARCHS
                                        for s in SHAPES])
def test_ep_geometry_equals_the_reference_on_one_device(arch, shape):
    jrt = jdryrun.make_runtime(jget_config(arch), INPUT_SHAPES[shape],
                               jmesh.make_test_mesh(1, 1))
    trt = dryrun.make_runtime(get_config(arch), INPUT_SHAPES[shape])
    js, ts = jrt.ep_spec, trt.ep_spec
    assert (ts.n_ep, ts.slots, ts.capacity, ts.slot_capacity) == \
        (js.n_ep, js.slots, js.capacity, js.slot_capacity)
    assert (trt.window, trt.moe_impl, trt.dtype) == \
        (jrt.window, jrt.moe_impl, torch.bfloat16)
    over = {"capacity_factor": 1.0}
    jc = jdryrun.make_runtime(jget_config(arch), INPUT_SHAPES[shape],
                              jmesh.make_test_mesh(1, 1), moe_overrides=over)
    tc = dryrun.make_runtime(get_config(arch), INPUT_SHAPES[shape],
                             moe_overrides=over)
    assert tc.ep_spec.capacity == jc.ep_spec.capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_helpers_and_best_layout_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dryrun._unit_layers(cfg) == jdryrun._unit_layers(jcfg)
    for n in (1, 2, 3):
        assert dryrun.depth_variant(cfg, n).num_layers == \
            jdryrun.depth_variant(jcfg, n).num_layers
    for s in SHAPES:
        want = jdryrun.best_layout(jcfg, INPUT_SHAPES[s])
        assert dryrun.best_layout(cfg, INPUT_SHAPES[s]) == want


def _ref_argument_bytes(arch, shape, **kw):
    cfg = jget_config(arch).reduced()
    _, kwargs = jdryrun.build_lowerable(cfg, shape, jmesh.make_test_mesh(1, 1),
                                        **kw)
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(kwargs))


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-vl-72b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("shape", SHAPES)
def test_meta_argument_bytes_equal_the_reference(arch, shape):
    """The reference's ``ShapeDtypeStruct`` leaves (``jax.eval_shape``, no
    compile) at the same reduced config and a small shape. The port keeps
    the optimizer's step counter on the host, where the reference's state
    holds it as a 4-byte int32 array: train steps differ by those 4
    bytes."""
    small = _small(shape)
    fn, kwargs = dryrun.build_step(get_config(arch).reduced(), small)
    step_counter = 4 if small.kind == "train" else 0
    assert dryrun.tree_bytes(kwargs) + step_counter == \
        _ref_argument_bytes(arch, small)
    assert all(t.device.type == "meta" for t in
               jax.tree.leaves(kwargs) if torch.is_tensor(t))


def test_int8_cache_bytes_equal_the_reference():
    small = _small("decode_32k")
    _, kwargs = dryrun.build_step(get_config("yi-6b").reduced(), small,
                                  kv_quant=True)
    assert dryrun.tree_bytes(kwargs) == _ref_argument_bytes(
        "yi-6b", small, kv_quant=True)


def test_counted_flops_of_a_dense_prefill_are_its_matmuls():
    """Reduced Yi (2 layers, d 256, 4 q heads over 2 KV heads of 64, d_ff
    512, vocab 512): q/k/v and output projections, the plain attention's
    two [T, T] products over every head (the mask drops no product), the
    SwiGLU's three, and the last token's logits."""
    cfg = get_config("yi-6b").reduced()
    B, T = 2, 48
    fn, kwargs = dryrun.build_step(cfg, _small("prefill_32k", T, B))
    got = roofline.count_step(fn, kwargs)["flops"]
    d, hd, H, KVH, f = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads, \
        cfg.d_ff
    per_layer = (2 * B * T * d * (H + 2 * KVH) * hd   # q, k, v
                 + 2 * 2 * B * H * T * T * hd           # q k^T, p v
                 + 2 * B * T * H * hd * d               # o
                 + 3 * 2 * B * T * d * f)               # w1, w3, w2
    want = cfg.num_layers * per_layer + 2 * B * d * cfg.vocab_size
    assert got == want


def _ep_counts(kind, n_ep, T, **moe_overrides):
    cfg = get_config("mixtral-8x7b").reduced()
    shape = _small(kind, T, 2)
    fn, kwargs = dryrun.build_step(cfg, shape, n_ep=n_ep, device="cpu",
                                   moe_overrides=moe_overrides or None)
    spec = dryrun.make_runtime(cfg, shape, n_ep=n_ep,
                               moe_overrides=moe_overrides or None).ep_spec
    return cfg, shape, spec, roofline.count_step(fn, kwargs)["collectives"]


def test_collective_counters_follow_the_ep_spec_in_prefill():
    """Per MoE layer of an EP prefill over 3 virtual ranks: three rank
    swaps (the tokens, their expert ids in int64, the outputs), the
    all-reduce of the per-origin counts, the local ratio and the aux loss
    (bytes twice), and the concatenation of the ranks' output rows. A
    swap sends the send capacity in force to every rank: the spec's, or
    the R K (token, expert) pairs of a device's R rows where fewer (the
    built spec's C is below them; a capacity of 64 is above)."""
    n, T = 3, 20
    for over in ({}, {"capacity": 64}):
        cfg, shape, spec, got = _ep_counts("prefill_32k", n, T, **over)
        L, D, E = cfg.num_layers, cfg.d_model, cfg.num_experts
        R = -(-shape.global_batch * T // n)
        C = min(spec.capacity, R * cfg.top_k)
        assert C == (R * cfg.top_k if over else spec.capacity) < 64
        N = R * n
        bf16 = 2
        want = {"all-to-all": {"bytes": L * (2 * n * n * C * D * bf16
                                             + n * n * C * 8),
                               "count": 3 * L},
                "all-reduce": {"bytes": L * 2 * (n * E * 4 + 4 + 4),
                               "count": 3 * L},
                "all-gather": {"bytes": L * N * D * bf16, "count": L}}
        want["total_bytes"] = sum(v["bytes"] for v in want.values())
        assert got == want


def test_collective_counters_follow_the_ep_spec_in_decode_and_train():
    """Decode (gather mode): the sum of the ranks' outputs, the local
    ratio and the aux loss, all-reduced. Train: the forward's swaps twice
    (the checkpointed group is recomputed for its backward) and the two
    differentiable swaps once more in the backward; the recompute stops
    once it has rebuilt what the backward reads (torch's non-reentrant
    checkpoint): after the return swap, before the concatenation and the
    sums."""
    n = 3
    cfg, shape, spec, got = _ep_counts("decode_32k", n, 16)
    L, D, E = cfg.num_layers, cfg.d_model, cfg.num_experts
    assert got["all-reduce"] == {"bytes": L * 2 * (2 * D * 2 + 4 + 4),
                                 "count": 3 * L}
    assert got["all-to-all"]["count"] == got["all-gather"]["count"] == 0
    for over in ({}, {"capacity": 64}):
        cfg, shape, spec, got = _ep_counts("train_4k", n, 16, **over)
        N = 33  # 2 x 16 rows padded to a multiple of 3
        C = min(spec.capacity, N // n * cfg.top_k)  # the capacity in force
        x, ids = n * n * C * D * 2, n * n * C * 8
        assert got["all-to-all"] == {
            "bytes": L * (2 * (2 * x + ids) + 2 * x), "count": 8 * L}
        assert got["all-reduce"] == {"bytes": L * 2 * (n * E * 4 + 8),
                                     "count": 3 * L}
        assert got["all-gather"] == {"bytes": L * N * D * 2, "count": L}


@pytest.fixture(scope="module")
def reduced_sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    pairs = [(a, s) for s in SHAPES for a in ARCHS]
    recs = dryrun.run_all(pairs, workers=4, out_dir=str(out), reduced=True)
    return out, {(r["arch"].removesuffix("-smoke"), r["shape"]): r
                 for r in recs}


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_reduced_dry_run_records_are_sane(reduced_sweep, arch, shape):
    """The reference's ``test_roofline_terms_sane`` on the port's records
    (reduced configs, the four input shapes, meta)."""
    out, recs = reduced_sweep
    r = recs[arch, shape]
    assert r["ok"], r.get("error")
    assert r["chips"] == 1 and r["mesh"] == "1xH100"
    on_disk = json.loads(
        (out / f"{arch}-smoke__{shape}__1xH100.json").read_text())
    assert on_disk["roofline"] == r["roofline"]
    ro = r["roofline"]
    assert ro["compute_s"] >= 0 and ro["memory_s"] > 0
    assert ro["dominant"] in ("compute", "memory", "collective")
    assert 0 < ro["useful_flops_ratio"] < 20
    if shape in ("decode_32k", "long_500k"):
        assert ro["dominant"] != "compute", (arch, shape)
    assert r["temp_size_in_bytes"] is None and ro["memory_s_hlo"] is None
    assert r["argument_size_in_bytes"] > 0 and r["hlo_flops"] > 0
    assert r.get("donated_cache", False) == (INPUT_SHAPES[shape].kind
                                             == "decode")


@pytest.mark.parametrize("variant", list(perf.VARIANTS))
def test_every_perf_variant_runs_on_meta(variant):
    """The reference's 16 variants (``repro.launch.perf.VARIANTS``), each
    on a reduced MoE config at a small train shape on a 2x4 virtual mesh,
    and the card leg's (1, 8) mesh: the step runs on meta, the layout is
    the runtime's, and the remat policies leave the FLOPs of the forward
    alone or cut the recompute."""
    from repro.launch import perf as jperf

    assert set(perf.VARIANTS) == set(jperf.VARIANTS)
    assert perf.VARIANTS[variant] == jperf.VARIANTS[variant]
    cfg = get_config("mixtral-8x7b").reduced()
    kw = perf.VARIANTS[variant]
    small = _small("train_4k", 32, 4)
    for m in (mesh.make_test_mesh(2, 4), perf.MESHES[perf.CARD_MESH]()):
        rt = dryrun.make_runtime(cfg, small, m, **kw)
        assert rt.layout == kw.get("layout", "tp") and rt.mesh == m
        rec = dryrun.analyse(cfg, small, m, **kw)
        base = dryrun.analyse(cfg, small, m)
        assert rec["argument_size_in_bytes"] == base["argument_size_in_bytes"]
        assert 0 < rec["device_argument_size_in_bytes"] <= \
            rec["argument_size_in_bytes"]
        if "remat_policy" in kw:
            assert rec["hlo_flops"] < base["hlo_flops"]
        else:
            assert rec["hlo_flops"] == base["hlo_flops"]


@pytest.mark.parametrize("arch,shapes", [
    ("yi-6b", SHAPES), ("phi3.5-moe-42b-a6.6b", ["train_4k", "decode_32k"])])
def test_both_meshes_write_per_device_records(tmp_path, capsys, arch,
                                              shapes):
    """``dryrun --both-meshes``: one record per production mesh of virtual
    devices, with one device's argument bytes and the whole mesh's FLOPs
    divided over its chips."""
    for shape in shapes:
        dryrun.main(["--arch", arch, "--shape", shape, "--both-meshes",
                     "--reduced", "--out", str(tmp_path)])
    assert capsys.readouterr().out.count("[OK]") == 2 * len(shapes)
    one = dryrun.run_all([(arch, s) for s in shapes], out_dir=str(tmp_path),
                         reduced=True)
    for shape, r1 in zip(shapes, one):
        for tag, chips in (("16x16", 256), ("2x16x16", 512)):
            r = json.loads((tmp_path / f"{arch}-smoke__{shape}__{tag}.json"
                            ).read_text())
            assert r["ok"] and r["chips"] == chips and r["mesh"] == tag
            assert set(r["per_device"]) == {
                "argument_size_in_bytes", "hlo_flops",
                "output_size_in_bytes", "collectives"}
            assert r["argument_size_in_bytes"] < \
                r["global_argument_size_in_bytes"]
            # the q heads pad to a multiple of the 16-wide model axis
            # (reduced configs have 4), and EP keeps slots per rank
            assert r["global_argument_size_in_bytes"] >= \
                r1["argument_size_in_bytes"]
            assert r["hlo_flops"] * chips >= r1["hlo_flops"]


def test_perf_meta_variant_appends_the_dry_run_record(tmp_path):
    for variant in ("baseline", "kv8"):
        perf.run_variant("tinyllama-1.1b", "decode_32k", variant,
                         out_dir=str(tmp_path))
    lines = (tmp_path / "tinyllama-1.1b__decode_32k.jsonl").read_text()
    base, kv8 = (json.loads(x) for x in lines.splitlines())
    assert base["ok"] and kv8["ok"]
    # int8 codes with a bf16 scale per (position, head) against bf16 k/v
    assert kv8["argument_size_in_bytes"] < base["argument_size_in_bytes"]
    assert base["hlo_flops"] == kv8["hlo_flops"]


def test_ep_spec_of_the_port_matches_the_reference_build():
    """``EPSpec.build(n_ep, ...)`` is the reference's
    ``EPSpec.build(mesh, ...)`` on a mesh of ``n_ep`` EP devices."""
    from repro.models import moe as jmoe

    cfg = get_config("mixtral-8x7b")
    for rows, cf in ((4096, 2.0), (131072, 1.0), (8, 2.0)):
        t = tmoe.EPSpec.build(1, cfg, rows_per_rank=rows, capacity_factor=cf)
        j = jmoe.EPSpec.build(jmesh.make_test_mesh(1, 1), jget_config(
            "mixtral-8x7b"), rows_per_rank=rows, capacity_factor=cf)
        assert (t.n_ep, t.slots, t.capacity, t.slot_capacity) == \
            (j.n_ep, j.slots, j.capacity, j.slot_capacity)
