"""Plain PyTorch oracles for every kernel, mirroring
``repro.kernels.ref`` function for function, plus the paged attention read,
which the reference leaves to XLA and the port has a kernel for."""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def moe_gmm_ref(x, w1, w3, w2):
    """Grouped expert FFN. x: [S, C, D]; w1/w3: [S, D, F]; w2: [S, F, D]."""
    a = torch.matmul(x, w1)
    b = torch.matmul(x, w3)
    mid = (F.silu(a.float()) * b.float()).to(x.dtype)
    return torch.matmul(mid, w2)


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: [BH, Tq, hd]; k, v: [BH, Tk, hd] (kv already expanded to q heads).
    Returns [BH, Tq, hd]."""
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, page_table, q_offset):
    """q: [B, Tq, H, hd]; k_pool, v_pool: [n_blocks, bs, KVH, hd];
    page_table: [B, P] block ids in logical order; q_offset: [B]. Query t
    of row b sees the keys at positions <= q_offset[b] + t of its row
    (position p in block page_table[b, p // bs] at p % bs); q head h reads
    kv head h // (H // KVH). fp32 math; returns [B, Tq, H, hd] in q's
    type."""
    B, Tq, H, hd = q.shape
    grp = H // k_pool.shape[2]
    tbl = page_table.long()
    k = k_pool[tbl].flatten(1, 2).repeat_interleave(grp, dim=2).float()
    v = v_pool[tbl].flatten(1, 2).repeat_interleave(grp, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * hd ** -0.5
    qpos = (torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
            + torch.arange(Tq, device=q.device)[None])  # [B, Tq]
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [B, Tq, Tk]
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def ssm_scan_ref(x, dt, Bs, Cs, A, D):
    """Mamba-1 selective scan.
    x, dt: [B, T, d]; Bs, Cs: [B, T, N]; A: [d, N]; D: [d].
    Returns y: [B, T, d] (fp32 math, cast to x.dtype; ``dt * x`` is formed
    in the input type, as the reference's oracle does)."""
    B, T, d = x.shape
    N = Bs.shape[-1]
    a = torch.exp(dt.float()[..., None] * A[None, None])  # [B, T, d, N]
    b = (dt * x).float()[..., None] * Bs.float()[:, :, None, :]
    Cf = Cs.float()
    h = torch.zeros((B, d, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + D.float() * x.float()
    return y.to(x.dtype)
