"""The CUDA kernels against their plain versions, on the card (marked
``cuda``; every test skips without a CUDA device). This file imports no
JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are relative to the largest reference value: fp32 1e-4 (the
kernels sum over the reduction axes in another order than the library
products of the plain versions), bf16 3e-2 (one bf16 rounding of the gated
intermediate, resp. of the softmax weights, lands differently)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import moe_gmm as tgmm

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
