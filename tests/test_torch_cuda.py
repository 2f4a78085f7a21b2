"""The CUDA kernels against their plain versions, on the card (marked
``cuda``; every test skips without a CUDA device). This file imports no
JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are relative to the largest reference value: fp32 1e-4 (the
kernels sum over the reduction axes in another order than the library
products of the plain versions), bf16 3e-2 (one bf16 rounding of the gated
intermediate, resp. of the softmax weights, lands differently). The
selective scan computes in fp32 from the same inputs as its plain version,
so in bf16 only the final rounding of each output differs (one bf16 ulp,
under 1e-2 of the largest value); its fp32 tolerance is 1e-4 for the same
reason as the others (sums over N, T and d in another order)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ssm_scan as tssm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GMM_SHAPES = [(1, 128, 64, 256), (2, 128, 128, 512), (4, 256, 64, 256),
              (3, 128, 96, 384), (8, 512, 256, 704)]
FLASH_CASES = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 256, 4, 4, 64, True, 64),
    (2, 128, 2, 1, 128, True, 0),
    (1, 128, 4, 2, 32, False, 0),
    (1, 512, 2, 2, 64, True, 128),
    (2, 200, 32, 8, 128, True, 0),
    (1, 77, 4, 1, 32, True, 20),
]
# (B, T, d, N): ragged T (not a multiple of the 16-step checkpoint tile or
# of the 4-step backward piece: T = 1, one step either side of each), ragged
# d (not a multiple of the 32-channel forward or 64-channel backward block)
# and N of 1, 5 and 12 (padded to the kernels' 16 states) included
SSM_CASES = [(1, 64, 64, 16), (2, 200, 96, 16), (1, 1, 5, 4), (1, 333, 200, 8),
             (3, 65, 256, 16), (2, 130, 8192, 16), (1, 15, 100, 1),
             (2, 17, 33, 5), (1, 3, 70, 12), (1, 5, 64, 16), (2, 1, 130, 12)]
SSM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _gmm_inputs(S, C, D, F, fill):
    x = _np(S * 1000 + C, (S, C, D), 0.5)
    rows = np.arange(C)[None, :] < np.asarray(fill)[:, None]
    x = x * rows[..., None]          # the dispatcher leaves zeros past fill
    w1 = _np(1, (S, D, F), D ** -0.5)
    w3 = _np(2, (S, D, F), D ** -0.5)
    w2 = _np(3, (S, F, D), F ** -0.5)
    return x, w1, w3, w2, rows




@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,D,F", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_kernel_matches_plain(cuda, S, C, D, F, dtype):
    td = DTYPES[dtype]
    fill = [C, 0, 3, C // 2, 1, 2, 5, C - 1][:S]
    x, w1, w3, w2, rows = _gmm_inputs(S, C, D, F, fill)
    args = [torch.from_numpy(a).to(cuda, td) for a in (x, w1, w3, w2)]
    fl = torch.tensor(fill, dtype=torch.int32, device=cuda)
    before = tgmm.launches
    y = tgmm.launch(*args, fl, C)
    torch.cuda.synchronize()
    assert tgmm.launches == before + 1
    r = tgmm.plain(*args, fl, C)
    tol = (1e-4 if dtype == "float32" else 3e-2) * float(r.abs().max())
    assert float((y.float() - r.float()).abs().max()) <= tol
    assert not y[~torch.from_numpy(rows).to(cuda)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,kvh,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, B, T, H, kvh, hd, causal, window,
                                    dtype):
    td = DTYPES[dtype]
    q, k, v = (torch.from_numpy(_np(s, sh)).to(cuda, td) for s, sh in
               ((1, (B, T, H, hd)), (2, (B, T, kvh, hd)), (3, (B, T, kvh, hd))))
    o = tflash.launch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    r = tflash.plain(q, k, v, causal=causal, window=window)
    tol = (1e-4 if dtype == "float32" else 3e-2) * float(r.abs().max())
    assert float((o.float() - r.float()).abs().max()) <= tol


# the tensor-core moe_gmm at the edges of its tiles: (S, C, D, F, fill,
# max_fill). Fills of 0, 1, 8, 9, 64, 65, 128 and 129 rows against row tiles
# of 8..128 rows (129 loops over two tiles); max_fill below a fill; D and F
# multiples of 8 but not of the 64 / 128-column tiles; split-K in one pass,
# in both and in neither.
GMM_TC_CASES = [
    (8, 160, 96, 704, [0, 1, 8, 9, 64, 65, 128, 129], 160),
    (8, 160, 96, 704, [0, 1, 8, 9, 64, 65, 128, 129], 64),
    (8, 160, 96, 704, [0, 1, 8, 9, 64, 65, 128, 129], 9),
    (4, 16, 256, 512, [1, 2, 0, 3], 4),
    (3, 40, 128, 384, [40, 17, 9], 40),
    (2, 300, 64, 200, [300, 150], 300),
    (8, 8, 4352, 256, [1, 3, 0, 8, 2, 5, 7, 4], 8),
    (8, 8, 128, 2112, [1, 3, 0, 8, 2, 5, 7, 4], 8),
    (2, 64, 4096, 1024, [64, 33], 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,D,F,fill,max_fill", GMM_TC_CASES)
def test_moe_gmm_tensor_core_kernel_matches_plain(cuda, monkeypatch, S, C, D,
                                                  F, fill, max_fill):
    """bf16 on the tensor cores against ``plain``: rows past the fill hold
    NaN (the dispatcher leaves them unwritten) and never reach the output,
    every fresh allocation is NaN-filled (an element the kernel does not
    write shows), and a second run gives the same bits."""
    assert tgmm.select_variant(torch.bfloat16, D, F) == "tc"
    x, w1, w3, w2, rows = _gmm_inputs(S, C, D, F, fill)
    x[~rows] = np.nan
    args = [torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in (x, w1, w3, w2)]
    fl = torch.tensor(fill, dtype=torch.int32, device=cuda)
    want = tgmm.plain(*args, fl, max_fill)
    _poison(monkeypatch)
    before = tgmm.launches_by_variant["tc"]
    y = tgmm.launch(*args, fl, max_fill)
    y2 = tgmm.launch(*args, fl, max_fill)
    torch.cuda.synchronize()
    assert tgmm.launches_by_variant["tc"] == before + 2
    assert torch.equal(y, y2)
    assert bool(torch.isfinite(y).all())
    assert _rel_err(y, want) <= 3e-2
    n = torch.clamp(fl.long(), max=min(max_fill, C))
    past = torch.arange(C, device=cuda)[None, :] >= n[:, None]
    assert not y[past].any()


# the tensor-core flash kernel: hd 32 / 64 / 80 / 128, ragged T, window on
# and off, KVH 1 and H, causal and not
FLASH_TC_CASES = [
    (B, T, 4, kvh, hd, causal, window)
    for hd in (32, 64, 80, 128)
    for T in (77, 200)
    for kvh in (1, 4)
    for causal, window in ((True, 0), (True, 48), (False, 0))
    if not (kvh == 4 and not causal and T == 77)
    for B in (2,)
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,kvh,hd,causal,window", FLASH_TC_CASES)
def test_flash_tensor_core_kernel_matches_plain(cuda, monkeypatch, B, T, H,
                                                kvh, hd, causal, window):
    assert tflash.select_variant(torch.bfloat16, hd) == "tc"
    q, k, v = (torch.from_numpy(_np(s, sh)).to(cuda, torch.bfloat16)
               for s, sh in ((1, (B, T, H, hd)), (2, (B, T, kvh, hd)),
                             (3, (B, T, kvh, hd))))
    want = tflash.plain(q, k, v, causal=causal, window=window)
    _poison(monkeypatch)
    before = tflash.launches_by_variant["tc"]
    o = tflash.launch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tflash.launches_by_variant["tc"] == before + 1
    assert bool(torch.isfinite(o).all())
    assert _rel_err(o, want) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [24, 40])
def test_bf16_flash_with_other_head_sizes_runs_on_the_cuda_cores(cuda, hd):
    q, k, v = (torch.from_numpy(_np(s, (1, 50, 2, hd))).to(cuda, torch.bfloat16)
               for s in (1, 2, 3))
    before = dict(tflash.launches_by_variant)
    o = tflash.launch(q, k, v, window=16)
    torch.cuda.synchronize()
    assert tflash.launches_by_variant == {"tc": before["tc"],
                                          "simt": before["simt"] + 1}
    want = tflash.plain(q, k, v, window=16)
    assert _rel_err(o, want) <= 3e-2


def _ssm_inputs(B, T, d, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, T, d)) - 2))
    Bs = rng.standard_normal((B, T, N)) * 0.3
    Cs = rng.standard_normal((B, T, N)) * 0.3
    A = -np.exp(rng.standard_normal((d, N)) * 0.5)
    D = 1 + 0.1 * rng.standard_normal(d)
    dy = rng.standard_normal((B, T, d))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, dt, Bs, Cs, A, D, dy)]


def _poison(monkeypatch):
    """Fill every fresh allocation with NaN, so that an output element the
    kernel does not write shows."""
    def poisoned(alloc):
        def fn(*args, **kw):
            t = alloc(*args, **kw)
            return t.fill_(float("nan")) if t.is_floating_point() else t
        return fn

    monkeypatch.setattr(torch, "empty", poisoned(torch.empty))
    monkeypatch.setattr(torch, "empty_like", poisoned(torch.empty_like))


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,d,N", SSM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernels_match_plain(cuda, monkeypatch, B, T, d, N, dtype):
    td = DTYPES[dtype]
    x, dt, Bs, Cs, A, D, dy = (a.to(cuda) for a in _ssm_inputs(B, T, d, N))
    x, dt, Bs, Cs, dy = (a.to(td) for a in (x, dt, Bs, Cs, dy))
    want_y = tssm.plain(x, dt, Bs, Cs, A, D)
    want_g = tssm.plain_bwd(x, dt, Bs, Cs, A, D, dy)
    _poison(monkeypatch)
    before = tssm.launches, tssm.bwd_launches
    y, states = tssm.launch(x, dt, Bs, Cs, A, D, save_states=True)
    grads = tssm.launch_bwd(x, dt, Bs, Cs, A, D, dy, states)
    torch.cuda.synchronize()
    assert (tssm.launches, tssm.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == td and states.shape == (B, -(-T // tssm.CHUNK), d, N)
    assert _rel_err(y, want_y) <= SSM_TOL[dtype]
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), grads, want_g):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel_err(g, w) <= SSM_TOL[dtype], name
    # the states are not kept unless asked for, and do not change y
    y2, none = tssm.launch(x, dt, Bs, Cs, A, D)
    assert none is None and torch.equal(y2, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_backward_gives_the_same_bits_twice(cuda, dtype):
    """The channel sums of dB and dC (and the batch sums of dA and dD) run
    in a fixed order with no float atomics: two backward runs over the
    same inputs give identical bits."""
    td = DTYPES[dtype]
    x, dt, Bs, Cs, A, D, dy = (a.to(cuda) for a in _ssm_inputs(2, 130, 8192,
                                                                 16, seed=5))
    x, dt, Bs, Cs, dy = (a.to(td) for a in (x, dt, Bs, Cs, dy))
    _, states = tssm.launch(x, dt, Bs, Cs, A, D, save_states=True)
    first = tssm.launch_bwd(x, dt, Bs, Cs, A, D, dy, states)
    second = tssm.launch_bwd(x, dt, Bs, Cs, A, D, dy, states)
    for name, g, g2 in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), first,
                           second):
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_ssm_scan_autograd_function_matches_autograd_through_plain(cuda):
    """``SsmScan`` (forward and backward kernels) against autograd through
    the plain version, for all six inputs in fp32, on non-contiguous inputs
    as the Mamba-1 block passes them (B and C are views of one
    projection); runs of the backward give the same bits."""
    x, dt, Bs, Cs, A, D, dy = (a.to(cuda) for a in _ssm_inputs(2, 150, 160, 16))
    proj = torch.cat([Bs, Cs], -1)
    leaves = [x, dt, proj, A, D]
    for t in leaves:
        t.requires_grad_(True)

    def run(fn):
        Bv, Cv = proj[..., :16], proj[..., 16:]
        y = fn(x, dt, Bv, Cv, A, D)
        return torch.autograd.grad(y, leaves, dy)

    before = tssm.launches, tssm.bwd_launches
    got = run(tssm.SsmScan.apply)
    again = run(tssm.SsmScan.apply)
    assert (tssm.launches, tssm.bwd_launches) == (before[0] + 2, before[1] + 2)
    want = run(tssm.plain)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert _rel_err(g, w) <= 1e-4
    with torch.no_grad():
        tssm.SsmScan.apply(x, dt, proj[..., :16], proj[..., 16:], A, D)


@pytest.mark.cuda
def test_falcon_mamba_train_step_on_the_card_matches_the_cpu(cuda):
    """Reduced Falcon-Mamba in fp32, same weights: loss, every gradient
    leaf and the parameters after one AdamW step agree between the card
    (scan kernels) and the CPU (plain versions); the step launched the
    forward kernel twice per layer (once more under checkpointing) and
    the backward once."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_and_grads

    cfg = get_config("falcon-mamba-7b").reduced()
    rt, params, state, step = build_trainer(cfg, device="cpu",
                                            dtype=torch.float32, lr=1e-2,
                                            steps=4, seed=1)
    grt = dataclasses.replace(rt, device="cuda")
    gparams = tree_map(lambda a: a.to(cuda), params)
    gstate = {k: tree_map(lambda a: a.to(cuda), state[k]) for k in ("m", "v")}
    gstate["step"] = state["step"]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 100))
    tgt = np.roll(tok, -1, 1)
    loss, _, grads = loss_and_grads(rt, params, tok, tgt)
    before = tssm.launches, tssm.bwd_launches
    gloss, _, ggrads = loss_and_grads(grt, gparams, tok, tgt)
    assert tssm.launches - before[0] == 2 * cfg.num_layers
    assert tssm.bwd_launches - before[1] == cfg.num_layers
    assert float(gloss) == pytest.approx(float(loss), rel=1e-5)
    for g, w in zip(tree_leaves(ggrads), tree_leaves(grads)):
        assert _rel_err(g.cpu(), w) <= 1e-4
    step(params, state, tok, tgt)
    step(gparams, gstate, tok, tgt)
    for g, w in zip(tree_leaves(gparams), tree_leaves(params)):
        # AdamW's first step moves each weight by lr * g / (|g| + eps): only
        # a gradient near 0 whose sign differs can move it differently, by
        # at most twice the first step's learning rate (1e-3 in warmup)
        assert float((g.detach().cpu() - w.detach()).abs().max()) <= 2e-3


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_autograd_on_the_card(cuda):
    x = torch.zeros((1, 2, 8), device=cuda, requires_grad=True)
    w = torch.zeros((1, 8, 8), device=cuda)
    fill = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="moe_gmm"):
        tgmm.launch(x, w, w, w, fill, 2)
    q = torch.zeros((1, 4, 2, 16), device=cuda, requires_grad=True)
    kv = torch.zeros((1, 4, 1, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        tflash.launch(q, kv, kv)
    with torch.no_grad():
        assert tflash.launch(q, kv, kv).shape == q.shape


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 4, 8), device=cuda)
    w = torch.zeros((2, 8, 8), device=cuda)
    fill = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tgmm.launch(x, w.transpose(1, 2), w, w, fill, 4)
    with pytest.raises(ValueError):
        tgmm.launch(x, w, w, w, fill.long(), 4)
    with pytest.raises(TypeError):
        tgmm.launch(x.half(), w.half(), w.half(), w.half(), fill, 4)
    q = torch.zeros((1, 4, 2, 256), device=cuda)
    with pytest.raises(ValueError):
        tflash.launch(q, q[:, :, :1], q[:, :, :1])


@pytest.mark.cuda
def test_serving_on_the_card_matches_the_cpu_and_ignores_garbage(cuda,
                                                                  monkeypatch):
    """Reduced Mixtral, fp32, one EP rank: greedy tokens on the card (the
    kernels) equal the CPU's (plain versions) over the same weights, and
    stay the same when every fresh allocation is NaN-filled (no kernel or
    dispatch step reads memory it did not write)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.moe import EPPlacement
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("mixtral-8x7b").reduced()
    eng, _ = build_engine(cfg, device="cuda", dtype=torch.float32,
                          max_len=40, policy="dancemoe", review_rounds=8)

    def cpu(tree):
        return ({k: cpu(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.cpu())

    import dataclasses

    ceng = ServingEngine(rt=dataclasses.replace(eng.rt, device="cpu"),
                         params=cpu(eng.params),
                         placement=EPPlacement(*(a.cpu() for a in
                                                 eng.placement)),
                         max_len=40)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 19))
    want = ceng.generate(toks, steps=8)[0]
    before = tgmm.launches, tflash.launches
    np.testing.assert_array_equal(eng.generate(toks, steps=8)[0], want)
    assert tgmm.launches > before[0] and tflash.launches > before[1]

    def poisoned(alloc):
        def fn(*args, **kw):
            t = alloc(*args, **kw)
            return t.fill_(float("nan")) if t.is_floating_point() else t
        return fn

    monkeypatch.setattr(torch, "empty", poisoned(torch.empty))
    monkeypatch.setattr(torch, "empty_like", poisoned(torch.empty_like))
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        poisoned(torch.Tensor.new_empty))
    np.testing.assert_array_equal(eng.generate(toks, steps=8)[0], want)


@pytest.mark.cuda
def test_cluster_on_the_card_matches_the_cpu(cuda):
    """Reduced Mixtral in fp32 over 3 virtual EP ranks: ``chip_smoke.py``'s
    cluster scenario (a DanceMoE controller, server 2 crashing mid-run with
    failover) gives the same tokens, merged event stream, controller
    decisions, faults section and activation counts on the card (kernels)
    as on the CPU (plain versions), over the same weights."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine

    cfg = get_config("mixtral-8x7b").reduced()
    ceng, _ = build_engine(cfg, device="cpu", dtype=torch.float32,
                           max_len=cs.CLUSTER_PROMPT + cs.CLUSTER_NEW + 8,
                           policy="dancemoe", review_rounds=1000,
                           n_ep=cs.N_SERVERS, seed=2)
    geng = cs.engine_on(ceng, "cuda")
    requests = cs.cluster_requests(cfg)
    before = tgmm.launches
    finite: list = []
    card = cs.run_cluster_once(geng, requests, finite)
    assert tgmm.launches > before
    cs.check_cluster(*card[:2], finite)
    want = cs.cluster_record(*cs.run_cluster_once(ceng, requests)[:2])
    got = cs.cluster_record(*card[:2])
    for key in want:
        assert got[key] == want[key], key
