"""The port's attention sublayer against the reference's ``attn_apply`` in
every serving mode (prefill, paged chunk, paged decode, dense decode):
outputs and written caches within fp32 tolerance (2e-5: the same
arithmetic, the port's prefill through the flash kernel's plain version
where the reference runs its chunked online softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as JA
from repro_torch.models import attention as TA

CFG = get_config("mixtral-8x7b").reduced()
TOL = dict(atol=2e-5, rtol=2e-5)
BS = 4          # block size of the paged pools


def _params(seed=0):
    rng = np.random.default_rng(seed)
    d, hd, kvh, H = CFG.d_model, CFG.hd, CFG.num_kv_heads, CFG.num_heads
    return {
        "norm": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        "wq": (rng.standard_normal((d, H * hd)) * d ** -0.5).astype(np.float32),
        "wk": (rng.standard_normal((d, kvh * hd)) * d ** -0.5).astype(np.float32),
        "wv": (rng.standard_normal((d, kvh * hd)) * d ** -0.5).astype(np.float32),
        "wo": (rng.standard_normal((H * hd, d)) * (H * hd) ** -0.5
               ).astype(np.float32),
    }


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(
        shape + (CFG.d_model,)).astype(np.float32)


def _cache_np(c):
    return {k: np.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("T", [8, 13])
def test_prefill_matches_reference(T):
    jp, tp = _both(_params(1))
    x = _x(2, (2, T))
    jc = JA.init_attn_cache(CFG, 2, 16, dtype=jnp.float32)
    tc = TA.init_attn_cache(CFG, 2, 16, dtype=torch.float32, device="cpu")
    jo, jc = JA.attn_apply(jp, CFG, jnp.asarray(x), ep=1, mode="prefill",
                           cache=jc)
    to, tc = TA.attn_apply(tp, CFG, torch.from_numpy(x), ep=1,
                           mode="prefill", cache=tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_dense_decode_with_vector_positions_matches_reference():
    jp, tp = _both(_params(3))
    rng = np.random.default_rng(4)
    cache = {k: rng.standard_normal((3, 12, CFG.num_kv_heads, CFG.hd)
                                    ).astype(np.float32) for k in ("k", "v")}
    pos = np.array([2, 7, 11], np.int32)
    x = _x(5, (3, 1))
    jo, jc = JA.attn_apply(jp, CFG, jnp.asarray(x), ep=1, mode="decode",
                           cache={k: jnp.asarray(v) for k, v in cache.items()},
                           pos=jnp.asarray(pos))
    to, tc = TA.attn_apply(tp, CFG, torch.from_numpy(x), ep=1, mode="decode",
                           cache={k: torch.from_numpy(v.copy())
                                  for k, v in cache.items()},
                           pos=torch.from_numpy(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def _pool(seed, n_blocks=10):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n_blocks, BS, CFG.num_kv_heads, CFG.hd)
                                   ).astype(np.float32) for k in ("k", "v")}


def test_paged_chunk_matches_reference():
    """Batched chunked prefill: row 0 writes its second block (offset 4),
    row 1 its first block (offset 0), row 2 is idle (null block 0)."""
    jp, tp = _both(_params(6))
    pool = _pool(7)
    table = np.array([[3, 5, 0], [6, 0, 0], [0, 0, 0]], np.int32)
    wb = np.array([5, 6, 0], np.int32)
    offs = np.array([4, 0, 0], np.int32)
    x = _x(8, (3, BS))
    jo, jc = JA.attn_apply(
        jp, CFG, jnp.asarray(x), ep=1, mode="chunk",
        cache={k: jnp.asarray(v) for k, v in pool.items()},
        pos=jnp.asarray(offs),
        paged={"page_table": jnp.asarray(table),
               "write_blocks": jnp.asarray(wb)})
    to, tc = TA.attn_apply(
        tp, CFG, torch.from_numpy(x), ep=1, mode="chunk",
        cache={k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        pos=torch.from_numpy(offs),
        paged={"page_table": torch.from_numpy(table),
               "write_blocks": torch.from_numpy(wb)})
    np.testing.assert_allclose(to.numpy()[:2], np.asarray(jo)[:2], **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy()[1:], np.asarray(jc[k])[1:],
                                   **TOL)


def test_paged_decode_matches_reference():
    jp, tp = _both(_params(9))
    pool = _pool(10)
    table = np.array([[3, 5, 0], [6, 2, 8], [0, 0, 0]], np.int32)
    pos = np.array([6, 9, 0], np.int32)
    x = _x(11, (3, 1))
    jo, jc = JA.attn_apply(
        jp, CFG, jnp.asarray(x), ep=1, mode="decode",
        cache={k: jnp.asarray(v) for k, v in pool.items()},
        pos=jnp.asarray(pos), paged={"page_table": jnp.asarray(table)})
    to, tc = TA.attn_apply(
        tp, CFG, torch.from_numpy(x), ep=1, mode="decode",
        cache={k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        pos=torch.from_numpy(pos), paged={"page_table": torch.from_numpy(table)})
    np.testing.assert_allclose(to.numpy()[:2], np.asarray(jo)[:2], **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy()[1:], np.asarray(jc[k])[1:],
                                   **TOL)


def test_copy_pool_block_and_unported_layouts():
    pool = {k: torch.from_numpy(v) for k, v in _pool(12).items()}
    grouped = {k: v[None].repeat(2, 1, 1, 1, 1) for k, v in pool.items()}
    TA.copy_pool_block(grouped, 3, 7, block_axis=1)
    assert torch.equal(grouped["k"][:, 7], grouped["k"][:, 3])
    # the layouts this test once found unported: an int8 pool carries
    # scales, which the block copy moves too; a window makes a ring
    q8 = TA.init_paged_kv(CFG, 4, BS, quantized=True, device="cpu")
    assert q8["k"].dtype == torch.int8 and set(q8) == {
        "k", "v", "k_scale", "v_scale"}
    q8["k_scale"][2] = 3.0
    TA.copy_pool_block(q8, 2, 1)
    assert torch.equal(q8["k_scale"][1], q8["k_scale"][2])
    ring = TA.init_attn_cache(CFG, 1, 32, window=8, device="cpu")
    assert ring["k"].shape[1] == 8
