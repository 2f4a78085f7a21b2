"""Gradients of the port's attention against the reference's, and the
host side of the flash-attention backward kernels.

The Pallas kernel has no backward and the reference trains through plain
jnp, so the reference here is ``jax.vjp`` of
``repro.kernels.ref.flash_attention_ref`` behind the GQA repeat of
``repro.kernels.ops.flash_attention``; the port's side is
``flash_attention.plain_bwd`` (autograd through ``plain``), the function
the CUDA backward kernels are held against on the card. Tolerance: each
gradient within 1e-5 of its largest value (fp32, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops

# (B, T, H, KVH, hd, causal, window): causal, windowed, GQA, hd 80 (Zamba2's
# shared attention), non-causal, and a T that is no multiple of a tile
CASES = [
    (2, 24, 4, 4, 16, True, 0),
    (1, 40, 4, 2, 32, True, 8),
    (2, 33, 8, 2, 16, True, 0),
    (1, 20, 2, 1, 80, True, 0),
    (1, 17, 4, 2, 24, False, 0),
    (1, 37, 4, 1, 16, False, 12),
]
GRAD_TOL = 1e-5


def _inputs(B, T, H, KVH, hd, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, KVH, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _jax_flash(q, k, v, causal, window):
    """``repro.kernels.ops.flash_attention`` with the oracle in place of the
    Pallas kernel: the same GQA repeat and [BH, T, hd] layout."""
    B, Tq, H, hd = q.shape
    grp = H // k.shape[2]
    kx, vx = (jnp.repeat(a, grp, axis=2) for a in (k, v))
    qf, kf, vf = (a.transpose(0, 2, 1, 3).reshape(B * H, -1, hd)
                  for a in (q, kx, vx))
    o = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return o.reshape(B, H, Tq, hd).transpose(0, 2, 1, 3)


def _close_scaled(got, want, rel, name):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (name, err)


@pytest.mark.parametrize("B,T,H,KVH,hd,causal,window", CASES)
def test_plain_gradients_match_the_reference(B, T, H, KVH, hd, causal,
                                             window):
    q, k, v, do = _inputs(B, T, H, KVH, hd)
    o, vjp = jax.vjp(lambda a, b, c: _jax_flash(a, b, c, causal, window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = tflash.plain_bwd(*(torch.from_numpy(a) for a in (q, k, v, do)),
                           causal=causal, window=window)
    out = tflash.plain(*(torch.from_numpy(a) for a in (q, k, v)),
                       causal=causal, window=window)
    _close_scaled(out.numpy(), o, GRAD_TOL, "o")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close_scaled(g.numpy(), w, GRAD_TOL, name)


def test_ops_differentiates_the_plain_version_on_the_cpu():
    """On the CPU, ``ops.flash_attention`` is the plain version, and
    autograd through it gives ``plain_bwd``; no kernel counter moves."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 19, 4, 2, 16))
    before = tflash.launches, tflash.bwd_launches
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tops.flash_attention(*leaves, causal=True, window=5).backward(do)
    want = tflash.plain_bwd(q, k, v, do, causal=True, window=5)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    assert (tflash.launches, tflash.bwd_launches) == before


@pytest.mark.parametrize("B,Tq,Tk,H,KVH,hd,grid_q,grid_k,ld", [
    (2, 2048, 2048, 32, 8, 128, (64, 64), (64, 16), 132),
    (1, 2048, 2048, 32, 32, 80, (64, 32), (64, 32), 84),
    (2, 200, 200, 4, 2, 64, (7, 8), (7, 4), 68),
    (1, 33, 40, 2, 1, 20, (2, 2), (2, 1), 20),
    (1, 1, 1, 1, 1, 1, (1, 1), (1, 1), 4),
])
def test_bwd_plan(B, Tq, Tk, H, KVH, hd, grid_q, grid_k, ld):
    plan = tflash.bwd_plan(B, Tq, Tk, H, KVH, hd)
    assert plan["dq_grid"] == grid_q
    assert plan["dkdv_grid"] == grid_k
    assert plan["row_stride"] == ld
    assert plan["delta"] == tflash.stats_shape(B, Tq, H) == (B, H, Tq)
    tile = tflash.BWD_TILE
    smem = 4 * (4 * tile * ld + 2 * tile * (tile + 1) + 2 * tile)
    assert plan["smem_bytes"] == (smem, smem)


@pytest.mark.parametrize("B,Tq,Tk,H,KVH,hd,grid_q,grid_k,smem", [
    (2, 2048, 2048, 32, 8, 128, (16, 64), (16, 16), (197696, 199744)),
    (1, 1024, 1024, 32, 8, 80, (16, 32), (16, 8), (67584, 45056)),
    (2, 200, 200, 4, 2, 64, (2, 8), (2, 4), (99392, 101440)),
    (1, 1, 1, 1, 1, 16, (1, 1), (1, 1), (18432, 12288)),
])
def test_tensor_core_bwd_plan(B, Tq, Tk, H, KVH, hd, grid_q, grid_k, smem):
    """The tensor-core backward: hd 64 and 128 take the wgmma plan (128-row
    blocks, 128-byte swizzled rows of 64 elements, one block an SM), the
    other head sizes the mma.sync one (64-row dq blocks, 64-key dk/dv
    blocks, bf16 rows of hd + 8, two blocks an SM); both kernels' shared
    memory fits an SM at that occupancy."""
    plan = tflash.bwd_plan(B, Tq, Tk, H, KVH, hd, "tc")
    wg = hd in (64, 128)
    assert plan["design"] == ("wg" if wg else "mma")
    assert plan["design"] == tflash.bwd_design(torch.bfloat16, hd)
    assert (plan["dq_grid"], plan["dkdv_grid"]) == (grid_q, grid_k)
    assert plan["row_stride"] == (64 if wg else hd + 8)
    assert plan["smem_bytes"] == smem
    assert plan["blocks_per_sm"] == (1 if wg else 2)
    assert plan["blocks_per_sm"] * max(smem) <= 232448
    assert tflash.select_variant(torch.bfloat16, hd) == "tc"


@pytest.mark.parametrize("B,Tq,Tk,H,KVH,hd", [
    (2, 2048, 2048, 32, 8, 128),   # the Mixtral train shape
    (1, 8448, 8448, 32, 8, 128),   # a long prompt
    (2, 130, 130, 8, 2, 128),      # ragged: 2 blocks, the last 2 rows deep
    (1, 257, 257, 4, 1, 64),       # GQA group of 4, ragged
    (3, 64, 200, 6, 3, 64),        # Tq != Tk
    (1, 1, 1, 1, 1, 64),
])
def test_wgmma_bwd_plan(B, Tq, Tk, H, KVH, hd):
    """The wgmma backward's plan, from the source's constants: dq blocks of
    128 query rows x B*H, dk/dv blocks of 128 keys x B*KVH; dq holds Q and
    dO (128 rows) and a 4-stage ring of K, V tiles (64 rows), dk/dv holds K
    and V and a 4-stage ring of Q, dO tiles with 64 rows of lse and delta
    (fp32) each, both two mbarriers a stage and 1 KB to align the ring to
    the swizzle atom; one block an SM fits, and at hd 64 two would."""
    plan = tflash.bwd_plan(B, Tq, Tk, H, KVH, hd, "tc")
    blk, tile, stages = (tflash.WG_BWD_BLOCK, tflash.WG_BWD_TILE,
                         tflash.WG_BWD_STAGES)
    assert (blk, tile, stages) == (128, 64, 4)
    assert plan["dq_grid"] == (-(-Tq // 128), B * H)
    assert plan["dkdv_grid"] == (-(-Tk // 128), B * KVH)
    rows = 2 * 128 * hd * 2                     # the resident pair, bf16
    ring = 4 * 2 * 64 * hd * 2                  # the walked pairs
    stats = 4 * 2 * 64 * 4                      # lse and delta rows
    bars = 4 * 2 * 8                            # full, empty mbarriers
    assert plan["smem_bytes"] == (rows + ring + bars + 1024,
                                  rows + ring + bars + stats + 1024)
    assert max(plan["smem_bytes"]) <= tflash.SMEM_PER_SM == 232448
    assert (2 * max(plan["smem_bytes"]) <= 232448) == (hd == 64)
    assert plan["delta"] == (B, H, Tq)


@pytest.mark.parametrize("hd", range(1, tflash.MAX_HEAD_DIM + 1))
def test_bwd_row_stride_is_conflict_free_and_fits(hd):
    """The staged rows hold hd rounded up to 4; a stride of 4 x an odd
    number of words puts the float4 reads of 8 consecutive rows on 32
    distinct banks; two blocks' shared memory fit on an SM at hd = 128."""
    plan = tflash.bwd_plan(1, 64, 64, 1, 1, hd)
    ld = plan["row_stride"]
    assert ld >= hd and ld % 4 == 0 and (ld // 4) % 2 == 1
    banks = {(r * ld + c) % 32 for r in range(8) for c in range(4)}
    assert len(banks) == 32
    assert 2 * max(plan["smem_bytes"]) <= 232448


def _fake_kernels(monkeypatch, calls):
    """``launch`` / ``launch_bwd`` replaced by the plain versions (the
    forward also fills the statistics it is handed)."""
    def launch(q, k, v, *, causal=True, window=0, lse=None):
        calls.append(("fwd", None if lse is None else tuple(lse.shape)))
        if lse is not None:
            lse.fill_(1.0)
        return tflash.plain(q, k, v, causal=causal, window=window)

    def launch_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
        calls.append(("bwd", tuple(lse.shape), causal, window))
        assert torch.equal(o, tflash.plain(q, k, v, causal=causal,
                                           window=window))
        assert bool((lse == 1.0).all())
        return tflash.plain_bwd(q, k, v, do, causal=causal, window=window)

    monkeypatch.setattr(tflash, "launch", launch)
    monkeypatch.setattr(tflash, "launch_bwd", launch_bwd)


def test_flash_function_wiring(monkeypatch):
    """A wiring test, not a kernel test: ``FlashAttention`` with
    ``launch`` / ``launch_bwd`` replaced by the plain versions. It asks the
    forward for the statistics and keeps q, k, v, o and lse only when an
    input needs a gradient, hands the backward the forward's output, its
    statistics and the mask, and returns the gradients autograd through
    the plain version gives."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 21, 4, 2, 16))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tflash.FlashAttention.apply(*leaves, True, 6)
    assert len(o.grad_fn.saved_tensors) == 5
    o.backward(do)
    assert calls == [("fwd", (2, 4, 21)), ("bwd", (2, 4, 21), True, 6)]
    want = tflash.plain_bwd(q, k, v, do, causal=True, window=6)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)

    # only k needs a gradient: still the statistics, and only dk arrives
    calls.clear()
    kk = k.clone().requires_grad_(True)
    tflash.FlashAttention.apply(q, kk, v, True, 0).backward(do)
    assert [c[0] for c in calls] == ["fwd", "bwd"]
    assert torch.equal(kk.grad, tflash.plain_bwd(q, k, v, do)[1])

    # no input needs a gradient: no statistics, nothing kept, no graph
    calls.clear()
    o = tflash.FlashAttention.apply(q, k, v, True, 0)
    assert o.grad_fn is None and calls == [("fwd", None)]
