"""The port's selective scan and SSM blocks against the reference, on the
same seeded numpy inputs: ``ssm_scan``'s plain version against the Pallas
kernel (interpret mode) and the reference oracle, its backward against
``jax.grad`` of the oracle, ``linear_scan``, the Mamba-1 / Mamba-2 blocks
in train, prefill and decode modes over the reference's weights, and
greedy generation through the SSM caches.

Tolerances: fp32 1e-5 absolute and relative where the arithmetic is the
same and only the summation order differs (the reference's chunked
associative scan against the port's doubling scan or step-by-step loop);
the gradients 1e-5 relative to the largest value, since the backward sums
over T and d in another order; bf16 5e-2, as the reference's own kernel
test (one bf16 rounding of the output lands differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as pssm
from repro_torch.serving.runtime import ServingRuntime
from tests._torch_parity import build_pair, prompts, t, to_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


def _scan_inputs(B, T, d, N, seed):
    rng = np.random.default_rng(seed)

    def rnd(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = rnd((B, T, d), 0.5)
    dt = np.log1p(np.exp(rnd((B, T, d)) - 1)).astype(np.float32)
    Bs = rnd((B, T, N), 0.3)
    Cs = rnd((B, T, N), 0.3)
    A = -np.exp(rnd((d, N), 0.3))
    D = (1 + rnd((d,), 0.1)).astype(np.float32)
    return x, dt, Bs, Cs, A, D


def _close_scaled(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


@pytest.mark.parametrize(
    "B,T,d,N,dtype",
    [
        (2, 64, 256, 16, "float32"),
        (1, 128, 128, 8, "float32"),
        (2, 32, 384, 16, "float32"),
        (1, 64, 128, 16, "bfloat16"),
    ],
)
def test_plain_matches_reference_kernel_and_oracle(B, T, d, N, dtype):
    x, dt, Bs, Cs, A, D = _scan_inputs(B, T, d, N, seed=T + d)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = [jnp.asarray(a, jd) for a in (x, dt, Bs, Cs)]
    jargs += [jnp.asarray(A), jnp.asarray(D)]
    targs = [t(a).to(td) for a in (x, dt, Bs, Cs)] + [t(A), t(D)]
    y_kernel = np.asarray(jops.ssm_scan(*jargs, bd=128, bt=32), np.float32)
    y_oracle = np.asarray(jref.ssm_scan_ref(*jargs), np.float32)
    y = tssm.plain(*targs)
    assert y.dtype == td
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().numpy(), y_kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(y.float().numpy(), y_oracle, atol=tol, rtol=tol)
    y_ref = tref.ssm_scan_ref(*targs).float().numpy()
    np.testing.assert_allclose(y_ref, y_oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,T,d,N", [(2, 40, 96, 16), (1, 70, 64, 8)])
def test_backward_matches_jax_grad_of_the_oracle(B, T, d, N):
    """``plain_bwd`` (the kernel's adjoint recurrence) and autograd through
    ``ops.ssm_scan`` on CPU tensors, for all six inputs."""
    args = _scan_inputs(B, T, d, N, seed=7 * T + d)
    dy = np.random.default_rng(1).standard_normal((B, T, d)).astype(np.float32)
    _, vjp = jax.vjp(jref.ssm_scan_ref, *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(dy))
    got = tssm.plain_bwd(*[t(a) for a in args], t(dy))
    leaves = [t(a).requires_grad_(True) for a in args]
    y = tops.ssm_scan(*leaves)
    auto = torch.autograd.grad(y, leaves, t(dy))
    for name, w, g, a in zip(("x", "dt", "B", "C", "A", "D"), want, got, auto):
        assert g.shape == a.shape == tuple(w.shape), name
        _close_scaled(g.numpy(), w, 1e-5)
        _close_scaled(a.numpy(), w, 1e-5)


def test_plain_bwd_keeps_the_input_types():
    args = [t(a) for a in _scan_inputs(1, 9, 8, 4, seed=3)]
    args[:4] = [a.bfloat16() for a in args[:4]]
    dy = torch.ones((1, 9, 8), dtype=torch.bfloat16)
    out = tssm.plain_bwd(*args, dy)
    assert [o.dtype for o in out] == [torch.bfloat16] * 4 + [torch.float32] * 2


@pytest.mark.parametrize("T,chunk", [(100, 16), (64, 256), (37, 8)])
def test_linear_scan_matches_reference(T, chunk):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, T, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jhs, jhT = jssm.linear_scan(*map(jnp.asarray, (a, b, h0)), chunk=chunk)
    ths, thT = pssm.linear_scan(t(a), t(b), t(h0), chunk=chunk)
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), **TOL)
    np.testing.assert_allclose(thT.numpy(), np.asarray(jhT), **TOL)


def test_causal_conv1d_and_xent_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    want = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tlayers.causal_conv1d(t(x), t(w), t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32) * 4
    tgt = rng.integers(0, 17, (3, 5)).astype(np.int32)
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(tgt))
    got = tlayers.softmax_xent(t(logits), t(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _block(arch, version):
    cfg = get_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    init = jssm.mamba1_params if version == 1 else jssm.mamba2_params
    jp = to_numpy(init(jax.random.PRNGKey(3), cfg))
    # non-trivial biases, norms, A and D, so that every parameter matters
    rng = np.random.default_rng(5)
    for k, v in jp.items():
        if v.ndim == 1 or k == "A_log":
            jp[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    tp = {k: t(v) for k, v in jp.items()}
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("arch,version", [("falcon-mamba-7b", 1), ("zamba2-2.7b", 2)])
def test_mamba_block_modes_match_reference(arch, version):
    cfg, tcfg, jp, tp = _block(arch, version)
    japply = jssm.mamba1_apply if version == 1 else jssm.mamba2_apply
    tapply = pssm.mamba1_apply if version == 1 else pssm.mamba2_apply
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)

    jy, _ = japply(jp, cfg, jnp.asarray(x), mode="train")
    ty, tc = tapply(tp, tcfg, t(x), mode="train")
    assert tc is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)

    jy, jc = japply(jp, cfg, jnp.asarray(x), mode="prefill")
    ty, tc = tapply(tp, tcfg, t(x), mode="prefill")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)

    jy, jc = japply(jp, cfg, jnp.asarray(x1), mode="decode", cache=jc)
    cache = {k: v.clone() for k, v in tc.items()}
    ty, tc2 = tapply(tp, tcfg, t(x1), mode="decode", cache=cache)
    assert tc2 is cache  # written in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in jc:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]), **TOL)


def test_mamba1_block_gradients_match_reference():
    """Train-mode gradients through the block (the scan's backward inside
    the conv, projections and gate), for every parameter and the input."""
    cfg, tcfg, jp, tp = _block("falcon-mamba-7b", 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba1_apply(p, cfg, xx, mode="train")[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = t(x).requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    out, _ = pssm.mamba1_apply(tp, tcfg, tx, mode="train")
    keys = sorted(tp)
    grads = torch.autograd.grad((out * t(w)).sum(), [tp[k] for k in keys] + [tx])
    for k, g in zip(keys + ["x"], grads):
        _close_scaled(g.numpy(), jgx if k == "x" else jg[k], 1e-5)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_generate_tokens_identical_and_runtime_refuses(arch):
    """``ServingEngine.generate`` (prefill, then decode through the SSM
    caches and, for the hybrid, the shared attention's KV cache) gives the
    reference's greedy tokens; ``ServingRuntime`` refuses a paged pool for
    SSM archs, as the reference's does, and serves them from the dense
    slot pool (``tests/test_torch_ssm_serving.py`` holds its tokens)."""
    jeng, teng = build_pair(arch, "dense", max_len=32)
    toks = prompts(jeng.rt.cfg.vocab_size, 2, 9, seed=4)
    jgen, _ = jeng.generate(jnp.asarray(toks), steps=8)
    tgen, _ = teng.generate(toks, steps=8)
    np.testing.assert_array_equal(tgen, np.asarray(jgen))
    with pytest.raises(ValueError, match="dense slot pool"):
        ServingRuntime(teng, max_slots=2, paged=True)
    assert not ServingRuntime(teng, max_slots=2).paged
