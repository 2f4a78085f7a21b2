"""The port's kernels against the reference's: the plain versions (what a
CPU tensor runs) against ``repro.kernels.ref`` and the Pallas kernels in
interpret mode, on the reference's sweep shapes. (The CUDA kernels are
held against the plain versions in ``test_torch_cuda.py``.)

Tolerances: fp32 plain versions follow the reference's own kernel-vs-oracle
bounds (same arithmetic, sums in another order); bf16 adds one bf16
rounding of the gated intermediate (moe_gmm) and of the softmax weights
(flash attention, where the Pallas kernel rounds p before p @ v)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BF16 = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _to_j(a, dt):
    return jnp.asarray(a).astype(dt)


def _to_t(a, dt):
    return torch.from_numpy(a).to(dt)


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# moe_gmm
# ---------------------------------------------------------------------------

GMM_SHAPES = [(1, 128, 64, 256), (2, 128, 128, 512), (4, 256, 64, 256),
              (3, 128, 96, 384)]


def _gmm_inputs(S, C, D, F, fill):
    x = _np(S * 1000 + C, (S, C, D), 0.5)
    rows = np.arange(C)[None, :] < np.asarray(fill)[:, None]
    x = x * rows[..., None]          # the dispatcher leaves zeros past fill
    w1 = _np(1, (S, D, F), D ** -0.5)
    w3 = _np(2, (S, D, F), D ** -0.5)
    w2 = _np(3, (S, F, D), F ** -0.5)
    return x, w1, w3, w2, rows


@pytest.mark.parametrize("S,C,D,F", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_reference(S, C, D, F, dtype):
    jd, td = BF16[dtype]
    fill = [C if s == 0 else (s * 37) % C for s in range(S)]
    x, w1, w3, w2, rows = _gmm_inputs(S, C, D, F, fill)
    yj = jref.moe_gmm_ref(*(_to_j(a, jd) for a in (x, w1, w3, w2)))
    yk = jops.moe_gmm(*(_to_j(a, jd) for a in (x, w1, w3, w2)),
                      bc=128, bf=128)
    yt = tops.moe_gmm(*(_to_t(a, td) for a in (x, w1, w3, w2)),
                      torch.tensor(fill, dtype=torch.int32), C)
    tol = 5e-6 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(yt), _f32(yk), atol=tol, rtol=tol)
    assert not _f32(yt)[~rows].any()        # rows past the fill are zero


def test_moe_gmm_plain_honours_max_fill():
    S, C, D, F = 2, 16, 8, 12
    x, w1, w3, w2, _ = _gmm_inputs(S, C, D, F, [C, C])
    full = tref.moe_gmm_ref(*(torch.from_numpy(a) for a in (x, w1, w3, w2)))
    y = tgmm.plain(*(torch.from_numpy(a) for a in (x, w1, w3, w2)),
                   torch.tensor([9, 3], dtype=torch.int32), 5)
    np.testing.assert_allclose(y[0, :5].numpy(), full[0, :5].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(y[1, :3].numpy(), full[1, :3].numpy(),
                               atol=1e-6)
    assert not y[0, 5:].any() and not y[1, 3:].any()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 256, 4, 4, 64, True, 64),
    (2, 128, 2, 1, 128, True, 0),
    (1, 128, 4, 2, 32, False, 0),
    (1, 512, 2, 2, 64, True, 128),
    (2, 200, 4, 2, 64, True, 0),       # ragged T: no tile multiple
    (1, 77, 4, 1, 32, True, 20),
]


@pytest.mark.parametrize("B,T,H,kvh,hd,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference_kernel(B, T, H, kvh, hd, causal, window):
    q = _np(T + H, (B, T, H, hd))
    k = _np(T + H + 1, (B, T, kvh, hd))
    v = _np(T + H + 2, (B, T, kvh, hd))
    bq = 64 if T % 64 == 0 else T
    oj = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, bq=bq, bk=bq)
    ot = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-5,
                               rtol=1e-4)


def test_flash_plain_bf16_matches_reference_kernel():
    q = _np(0, (1, 128, 4, 64))
    k = _np(1, (1, 128, 2, 64))
    v = _np(2, (1, 128, 2, 64))
    oj = jops.flash_attention(*(_to_j(a, jnp.bfloat16) for a in (q, k, v)),
                              bq=64, bk=64)
    ot = tops.flash_attention(*(_to_t(a, torch.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(_f32(ot), _f32(oj), atol=5e-2)


def test_flash_plain_matches_port_chunked_attention():
    from repro_torch.models.attention import chunked_attention

    q, k, v = (torch.from_numpy(_np(s, sh)) for s, sh in
               ((1, (2, 256, 4, 64)), (2, (2, 256, 2, 64)),
                (3, (2, 256, 2, 64))))
    a = chunked_attention(q, k, v, causal=True, window=64, chunk=128)
    b = tops.flash_attention(q, k, v, causal=True, window=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)
