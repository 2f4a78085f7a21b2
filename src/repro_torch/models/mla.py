"""Multi-head latent attention (MLA, DeepSeek-V2 [arXiv:2405.04434]) with
no q LoRA, over a latent KV cache. Port-only: the JAX package has no MLA.

Per token, with ``h`` the normed input:

* ``q = h W_q``, split per head into ``q_nope`` (``qk_nope_dim``) and
  ``q_pe`` (``qk_rope_dim``);
* ``[c~; k_pe] = h W_kva`` (``kv_lora_rank + qk_rope_dim``), ``c =
  RMSNorm_kv(c~)``;
* ``[k_nope; v] = c W_kvb`` per head (``qk_nope_dim + v_head_dim``);
* RoPE (half-split, YaRN frequencies, ``yarn_inv_freq``) on ``q_pe`` and
  on the single ``k_pe`` that every head shares;
* score ``(q_nope . k_nope + q_pe . k_pe) * softmax_scale``, then softmax,
  the values, and ``W_o``.

The cache holds one row a token: ``[c; roped k_pe]`` (``latent_dim`` =
576 values at DeepSeek-V2-Lite's widths), shared by all heads. Every mode
reads it absorbed: ``q_nope W_kvb_k^T`` is a ``kv_lora_rank`` latent query
per head, scored with ``q_pe`` against the whole row; the output is the
latent (the row's first ``kv_lora_rank`` values) weighted by the softmax,
then ``W_kvb_v`` and ``W_o``. That equals the published equations
(``tests/test_torch_mla.py`` holds it to them).

Cache layouts: a paged latent pool ``{"ckv": [n_blocks, bs, latent_dim]}``
(block 0 the null block), or a dense one ``[B, S, latent_dim]``, in the
model's type (an int8 latent pool is refused). The paged branches (the
serving steps' chunk call and decode round) write each step's rows first,
then read the pool through ``paged_mla``: on the card the paged MLA kernel
(``kernels/paged_mla.py``), which reads the rows in place through the page
table; off it the gathered read, ``gathered_mla``, its plain version.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# YaRN RoPE on the rope dims
# ---------------------------------------------------------------------------


def yarn_ramp(cfg) -> tuple[float, float]:
    """The YaRN correction range over the ``qk_rope_dim / 2`` frequencies:
    ``(low, high)``, the dims at which ``beta_fast`` and ``beta_slow``
    rotations fit in the original context (floor and ceil, clamped)."""
    dim, base = cfg.qk_rope_dim, cfg.rope_theta

    def at(rotations):
        return (dim * math.log(cfg.rope_original_max
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(at(cfg.beta_fast)), 0)
    high = min(math.ceil(at(cfg.beta_slow)), dim - 1)
    return float(low), float(high if high > low else low + 0.001)


def yarn_inv_freq(cfg, device=None) -> torch.Tensor:
    """[qk_rope_dim / 2] float64 inverse frequencies: below the ramp the
    original ``theta^(-2i/dim)``, above it those divided by
    ``rope_factor``, linear in between. (The cos/sin scale is 1 when
    ``mscale == mscale_all_dim``, as here.)"""
    dim = cfg.qk_rope_dim
    exps = torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim
    extra = 1.0 / cfg.rope_theta ** exps
    inter = extra / cfg.rope_factor
    low, high = yarn_ramp(cfg)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device) - low)
            / (high - low)).clamp(0.0, 1.0)
    return inter * ramp + extra * (1.0 - ramp)


_inv_freq_cache: dict = {}


def _cached_inv_freq(cfg, device) -> torch.Tensor:
    """``yarn_inv_freq`` made once a configuration and device (a captured
    step graph then reads it rather than recomputing it every layer)."""
    key = (cfg.qk_rope_dim, cfg.rope_theta, cfg.rope_factor,
           cfg.rope_original_max, cfg.beta_fast, cfg.beta_slow, str(device))
    if key not in _inv_freq_cache:
        _inv_freq_cache[key] = yarn_inv_freq(cfg, device)
    return _inv_freq_cache[key]


def rope_yarn(x: torch.Tensor, positions: torch.Tensor,
              inv_freq) -> torch.Tensor:
    """x [B, T, H, r] (half-split layout) at positions [B, T]; the angles
    are formed in float64 (positions up to 32k times the highest frequency
    would lose radians' thousandths in fp32)."""
    ang = positions[..., None].double() * inv_freq  # [B, T, r/2]
    cos = torch.cos(ang).float()[..., None, :]
    sin = torch.sin(ang).float()[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Params and caches
# ---------------------------------------------------------------------------


def mla_params(gen, cfg, dtype=torch.float32, device="cuda") -> dict:
    """``wq`` [d, H (nope + rope)], ``wkva`` [d, latent_dim], ``kv_norm``
    [kv_lora_rank], ``wkvb`` [kv_lora_rank, H (nope + v)], ``wo`` [H v, d],
    per head in that order (HF's ``q_proj``, ``kv_a_proj_with_mqa``,
    ``kv_b_proj``, ``o_proj``, transposed)."""
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "wq": dense_init(gen, (d, H * cfg.qk_head_dim), 0, dtype, device),
        "wkva": dense_init(gen, (d, cfg.latent_dim), 0, dtype, device),
        "kv_norm": torch.ones((r,), dtype=dtype, device=device),
        "wkvb": dense_init(gen, (r, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
                           0, dtype, device),
        "wo": dense_init(gen, (H * cfg.v_head_dim, d), 0, dtype, device),
    }


def init_latent(cfg, lead: tuple, *, dtype=torch.bfloat16, quantized=False,
                device="cuda") -> dict:
    """A latent cache ``{"ckv": lead + (latent_dim,)}``: ``(n_blocks, bs)``
    for a paged pool, ``(B, S)`` for a dense cache."""
    if quantized:
        raise ValueError("MLA: an int8 latent pool is not supported")
    return {"ckv": torch.zeros(tuple(lead) + (cfg.latent_dim,), dtype=dtype,
                               device=device)}


# ---------------------------------------------------------------------------
# The absorbed read
# ---------------------------------------------------------------------------


def latent_attention(q, kv, q_offset, scale: float, dv: int):
    """Causal absorbed attention of q [B, Tq, H, D] over latent rows
    kv [B, S, D] (row ``p`` the token at position ``p``): query ``t`` of row
    ``b`` sees the rows ``<= q_offset[b] + t``; the values are each row's
    first ``dv`` entries. q is scaled and rounded to its type, the scores
    and softmax run in fp32, the weights are rounded to q's type before
    the values, the output is q's type. Returns [B, Tq, H, dv]."""
    B, Tq = q.shape[:2]
    S = kv.shape[1]
    dev = q.device
    qs = (q * scale).to(q.dtype).float()
    offs = torch.as_tensor(q_offset, device=dev).reshape(-1).expand(B)
    qpos = torch.arange(Tq, device=dev)[None, :] + offs[:, None]  # [B, Tq]
    s = torch.einsum("bthd,bsd->bhts", qs, kv.float())
    seen = torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None]
    s = torch.where(seen[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bsd->bthd", p.to(q.dtype).float(),
                       kv[..., :dv].float())
    return out.to(q.dtype)


def gathered_mla(q, pool: dict, page_table, q_offset, scale: float, dv: int):
    """The paged read off the card, the kernel's plain version: the pool's
    pages gathered in logical order (index = position), then
    ``latent_attention``."""
    B, Pn = page_table.shape
    g = pool["ckv"][page_table]  # [B, P, bs, D]
    kv = g.reshape(B, Pn * g.shape[2], g.shape[3]).to(q.dtype)
    return latent_attention(q, kv, q_offset, scale, dv)


def paged_mla(q, pool: dict, page_table, q_offset, scale: float, dv: int):
    """The paged branches' read: on the card the paged MLA kernel
    (``ops.paged_mla``), reading the pool in place; off it
    ``gathered_mla``."""
    if ops.on_card(q, "paged_mla"):
        return ops.paged_mla(q.contiguous(), pool["ckv"], page_table,
                             q_offset, scale, dv)
    return gathered_mla(q, pool, page_table, q_offset, scale, dv)


# ---------------------------------------------------------------------------
# The sublayer
# ---------------------------------------------------------------------------


def mla_apply(p, cfg, x, *, mode: str, cache=None, pos=None, paged=None,
              norm_eps: float = 1e-6):
    """Returns (x + attention, cache). Modes as ``attention.attn_apply``:
    'train' (no cache), 'prefill' (fills a dense latent cache from 0),
    'decode' (a dense cache, or the paged pool with ``paged``) and 'chunk'
    (one ``block_size`` chunk a row, its rows written into the whole block
    ``write_blocks[b]``). Caches are written in place, then read."""
    B, T = x.shape[:2]
    dev = x.device
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    h = rms_norm(x, p["norm"], norm_eps)
    q = (h @ p["wq"]).reshape(B, T, H, dn + dr)
    kva = h @ p["wkva"]
    c = rms_norm(kva[..., :r], p["kv_norm"], norm_eps)
    if mode == "decode":
        positions = torch.as_tensor(pos, device=dev).reshape(-1, 1).expand(
            B, 1)
    elif mode == "chunk":
        offs = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        positions = torch.arange(T, device=dev)[None, :] + offs[:, None]
    else:
        positions = torch.arange(T, device=dev).expand(B, T)
    inv_freq = _cached_inv_freq(cfg, dev)
    q_pe = rope_yarn(q[..., dn:], positions, inv_freq)
    k_pe = rope_yarn(kva[..., None, r:], positions, inv_freq)[:, :, 0]
    row = torch.cat([c, k_pe], dim=-1)  # [B, T, latent_dim]
    wkvb = p["wkvb"].reshape(r, H, dn + dv)
    q_lat = torch.einsum("bthn,rhn->bthr", q[..., :dn], wkvb[..., :dn])
    qf = torch.cat([q_lat, q_pe], dim=-1)  # [B, T, H, latent_dim]
    scale = cfg.softmax_scale()

    if mode == "train":
        out = latent_attention(qf, row, 0, scale, r)
    elif mode == "prefill":
        cache["ckv"][:, :T] = row.to(cache["ckv"].dtype)
        out = latent_attention(qf, row.to(cache["ckv"].dtype), 0, scale, r)
    elif mode == "chunk":
        wb = torch.as_tensor(paged["write_blocks"], device=dev)  # [B]
        cache["ckv"][wb] = row.to(cache["ckv"].dtype)
        out = paged_mla(qf, cache, paged["page_table"], pos, scale, r)
    elif mode == "decode" and paged is not None:
        # each row's latent row into (its current block, in-block offset);
        # vacant rows carry an all-null table and write the null block 0
        bs = cache["ckv"].shape[1]
        tbl = torch.as_tensor(paged["page_table"], device=dev)  # [B, P]
        pos_arr = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        blocks = torch.gather(tbl, 1, (pos_arr // bs)[:, None])[:, 0]
        cache["ckv"][blocks, pos_arr % bs] = row[:, 0].to(cache["ckv"].dtype)
        out = paged_mla(qf, cache, tbl, pos_arr, scale, r)
    elif mode == "decode":
        S = cache["ckv"].shape[1]
        pos_arr = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        rows = torch.arange(B, device=dev)
        ok = (pos_arr < S)[:, None]
        slot = torch.where(ok[:, 0], pos_arr, S - 1)
        cache["ckv"][rows, slot] = torch.where(
            ok, row[:, 0].to(cache["ckv"].dtype), cache["ckv"][rows, slot])
        out = latent_attention(qf, cache["ckv"].to(qf.dtype), pos_arr, scale,
                               r)
    else:
        raise ValueError(mode)
    o = torch.einsum("bthr,rhv->bthv", out, wkvb[..., dn:])
    return x + o.reshape(B, T, H * dv) @ p["wo"], cache
