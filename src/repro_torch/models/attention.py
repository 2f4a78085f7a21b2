"""GQA attention (PyTorch port of ``repro.models.attention``): train
(no cache), flash prefill, paged chunked prefill and KV-cache decode.

Head padding: q heads are padded to ``H_pad`` (``cfg.padded_heads(ep)``)
with zero projection rows, as in the reference, so weights carried across
from it keep their shapes. KV stays at its true head count.

Caches are updated in place (the reference returns functionally updated
copies): a serving step writes a few positions of a pool it owns, and a
copy of the pool per step would cost its whole size in memory traffic.

Cache layouts, as the reference's: k/v in the model's type, or int8 codes
with a bf16 scale per (position, head) (``quantize_kv``); a dense cache of
``S < T`` positions under a sliding window is a ring (position ``p`` at
slot ``p % S``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30

_naming_kv = False


def naming_kv() -> bool:
    """Whether the op running now makes the gathered k/v copy
    (``kv_gathered``): the remat policy ``dots+kv`` keeps its output."""
    return _naming_kv


def kv_gathered(t):
    """k or v gathered over the mesh for context-parallel attention (the
    cp and fsdp layouts), named as the reference's ``checkpoint_name(t,
    "kv_gathered")``. On one card the gather is a copy (``clone``); while
    it runs ``naming_kv()`` is true, which is how a selective checkpoint
    policy tells it from any other op."""
    global _naming_kv
    _naming_kv = True
    try:
        return t.clone()
    finally:
        _naming_kv = False


def attn_params(gen, cfg, ep: int, dtype=torch.float32, device="cuda") -> dict:
    d, hd, kvh = cfg.d_model, cfg.hd, cfg.num_kv_heads
    hp = cfg.padded_heads(ep)
    wq = dense_init(gen, (d, hp * hd), 0, dtype, device)
    # zero the padded head rows so padding is function-preserving
    if hp != cfg.num_heads:
        wq[:, cfg.num_heads * hd:] = 0
    p = {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "wq": wq,
        "wk": dense_init(gen, (d, kvh * hd), 0, dtype, device),
        "wv": dense_init(gen, (d, kvh * hd), 0, dtype, device),
        "wo": dense_init(gen, (hp * hd, d), 0, dtype, device),
    }
    if cfg.use_qkv_bias:
        p["bq"] = torch.zeros((hp * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, cfg, ep):
    hd, kvh = cfg.hd, cfg.num_kv_heads
    hp = cfg.padded_heads(ep)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, T = x.shape[:2]
    return (q.reshape(B, T, hp, hd), k.reshape(B, T, kvh, hd),
            v.reshape(B, T, kvh, hd))


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset=0, chunk: int = 512):
    """Online-softmax attention over KV chunks (O(T·chunk) memory).

    q: [B, Tq, H, hd]; k,v: [B, Tk, KVH, hd] with H % KVH == 0.
    ``window`` > 0 restricts to a sliding window. ``q_offset`` is the
    absolute position of q's first token — a scalar shared by the batch or
    a [B] vector when rows sit at different offsets (batched chunked
    prefill of different serving slots).
    """
    B, Tq, H, hd = q.shape
    Tk, kvh = k.shape[1], k.shape[2]
    grp = H // kvh
    dev = q.device
    nchunks = -(-Tk // chunk)
    scale = hd**-0.5
    q32 = (q * scale).to(q.dtype).float()
    offs = torch.as_tensor(q_offset, device=dev).reshape(-1).expand(B)
    qpos = torch.arange(Tq, device=dev)[None, :] + offs[:, None]  # [B, Tq]
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Tq, H, hd), dtype=torch.float32, device=dev)
    for ci in range(nchunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk]
        vci = v[:, ci * chunk:(ci + 1) * chunk]
        c = kci.shape[1]
        kpos = ci * chunk + torch.arange(c, device=dev)  # [c]
        kex = torch.repeat_interleave(kci, grp, dim=2).float()  # [B,c,H,hd]
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kex)  # [B,H,Tq,c]
        mask = torch.ones((B, Tq, c), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, None, :] <= qpos[:, :, None]
        if window:
            mask &= kpos[None, None, :] > qpos[:, :, None] - window
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        vex = torch.repeat_interleave(vci, grp, dim=2).float()
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vex)
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization
# ---------------------------------------------------------------------------


def quantize_kv(x) -> tuple:
    """Per-(position, head) symmetric int8. x: [..., KVH, hd]. Returns
    (codes int8, scale bf16 [..., KVH, 1])."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    q8 = torch.clamp(torch.round(xf / scale), -127, 127)
    return q8.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q8, scale, dtype):
    return (q8.float() * scale.float()).to(dtype)


def _store(kk, vv, quantized: bool) -> dict:
    """k/v in a cache's layout: as given, or int8 codes and scales."""
    if not quantized:
        return {"k": kk, "v": vv}
    k8, ks = quantize_kv(kk)
    v8, vs = quantize_kv(vv)
    return {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}


def _read(cache: dict, dtype) -> tuple:
    """A dense cache's k/v in ``dtype`` (dequantized when int8)."""
    if "k_scale" in cache:
        return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
                dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def paged_gather(cache: dict, page_table, dtype) -> tuple:
    """Gather a slot-contiguous KV view out of a paged block pool.

    cache: k/v pools ``[n_blocks, block_size, KVH, hd]`` (plus
    ``k_scale``/``v_scale`` ``[n_blocks, block_size, KVH, 1]`` for the int8
    layout). ``page_table``: [B, P] physical block ids in *logical order*,
    padded with the null block 0, so the flattened gather index equals the
    absolute cache position. Returns (k, v) as ``[B, P*block_size, KVH,
    hd]`` in ``dtype`` (dequantized when the pool is int8).
    """
    B, Pn = page_table.shape

    def flat(name):
        g = cache[name][page_table]  # [B, P, bs, KVH, *]
        return g.reshape((B, Pn * g.shape[2]) + tuple(g.shape[3:]))

    if "k_scale" in cache:
        return (dequantize_kv(flat("k"), flat("k_scale"), dtype),
                dequantize_kv(flat("v"), flat("v_scale"), dtype))
    return flat("k").to(dtype), flat("v").to(dtype)


def decode_attention(q, k_cache, v_cache, pos, *, ring: bool = False):
    """Single-token attention against a cache.

    q: [B, 1, H, hd]; caches: [B, S, KVH, hd]. ``pos`` is the current
    absolute position (already written to the cache) — a scalar shared by
    the batch, or a [B] vector (continuous batching). With ``ring`` the
    cache is a sliding-window ring: slot ``i`` holds the latest position
    ``p <= pos`` with ``p % S == i``, valid once it is not negative.
    """
    B, S, kvh, hd = k_cache.shape
    H = q.shape[2]
    grp = H // kvh
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    kex = torch.repeat_interleave(k_cache, grp, dim=2).float()
    vex = torch.repeat_interleave(v_cache, grp, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", (q * hd**-0.5).float(), kex)
    idx = torch.arange(S, device=q.device)[None, :]
    if ring:
        valid = pos[:, None] - ((pos[:, None] - idx) % S) >= 0  # [B, S]
    else:
        valid = idx <= pos[:, None]  # [B, S]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vex)
    return out.to(q.dtype)


def gathered_attention(q, cache: dict, page_table, q_offset):
    """Causal attention of q [B, Tq, H, hd] over a paged pool through its
    gathered pages (``paged_gather``): ``decode_attention`` for ``Tq = 1``
    at ``q_offset``, else ``chunked_attention`` from each row's
    ``q_offset`` [B]. Any pool layout; the plain version of the
    paged-attention kernel, which ``paged_attention`` runs off the card."""
    kc, vc = paged_gather(cache, page_table, q.dtype)
    if q.shape[1] == 1:
        return decode_attention(q, kc, vc, q_offset)
    return chunked_attention(q, kc, vc, causal=True, q_offset=q_offset)


def paged_attention(q, cache: dict, page_table, q_offset):
    """The paged branches' read (see ``attn_apply``): on the card the
    paged-attention kernel (``ops.paged_attention``) for every pool
    layout, reading the pages in place; off it (``ops.on_card``) the
    gathered read, ``gathered_attention``."""
    if ops.on_card(q, "paged_attention"):
        return ops.paged_attention(q.contiguous(), cache["k"], cache["v"],
                                   page_table, q_offset,
                                   cache.get("k_scale"), cache.get("v_scale"))
    return gathered_attention(q, cache, page_table, q_offset)


# ---------------------------------------------------------------------------
# Full attention sublayer (norm -> qkv -> rope -> attn -> out proj)
# ---------------------------------------------------------------------------


def attn_apply(p, cfg, x, *, ep: int, mode: str, cache=None, pos=None,
               window: int = 0, norm_eps: float = 1e-5, residual: bool = True,
               gather_kv: bool = False, paged=None,
               quant_consistent: bool = False):
    """Returns (out, cache). Cache layout: dict(k, v) [B, S, KVH, hd], or a
    paged block pool [n_blocks, block_size, KVH, hd] when ``paged`` is given
    (dict with ``page_table`` [B, P] and, for chunk mode, ``write_blocks``
    [B]); either may be int8 (``k_scale``/``v_scale`` beside the codes).
    The cache is written in place and returned.

    mode: 'train' | 'prefill' | 'decode' | 'chunk'. Train has no cache and
    returns None for it; like prefill it runs the flash-attention kernel on
    the card, differentiated by its backward kernels (``ops`` routes a call
    autograd records through ``FlashAttention``), and its plain version on
    the CPU, which autograd differentiates. Prefill runs
    the flash-attention kernel (its plain version for CPU tensors) at any T
    and fills the pre-allocated ``cache``; with ``quant_consistent`` on an
    int8 cache it attends to the dequantized k/v it stores, as every later
    read does. A dense cache shorter than the prompt (``S < T``, a sliding
    window) keeps only the last ``S`` positions, position ``p`` at slot
    ``p % S``, and a windowed decode writes and reads it as that ring.
    'chunk' is batched paged chunked prefill: row
    ``b`` of x holds one ``block_size``-token block-aligned chunk of slot
    ``b``'s prompt starting at absolute position ``pos[b]``; its k/v are
    written into the whole block ``write_blocks[b]``, then it attends
    causally to its row's pages. Idle rows target the reserved null block
    0.

    The paged branches (chunk, and decode with ``paged``) write the k/v
    first, then read the pool through ``paged_attention``, which chooses by
    the device: on the card the paged-attention kernel, which reads each
    row's pages in place through the page table up to the row's own
    length, for a bf16, fp32 or int8 pool (the codes dequantized as they
    arrive); on the CPU its plain version, the pool gathered whole
    (``paged_gather``) and attended by ``decode_attention`` /
    ``chunked_attention``. Neither takes a window (a windowed cache is the
    dense ring). The dense-cache decode and the ring do not go through it.

    CoW contract (paged writes): every block named by a paged write has
    refcount 1 (the runtime clones shared tails with ``copy_pool_block``).

    ``gather_kv`` (train under the cp and fsdp layouts, with a mesh): k
    and v pass through ``kv_gathered``.
    """
    B, T = x.shape[:2]
    dev = x.device
    h = rms_norm(x, p["norm"], norm_eps)
    q, k, v = _project_qkv(p, h, cfg, ep)
    if mode == "decode":
        positions = torch.as_tensor(pos, device=dev).reshape(-1, 1).expand(B, 1)
    elif mode == "chunk":
        offs = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        positions = torch.arange(T, device=dev)[None, :] + offs[:, None]
    else:
        positions = torch.arange(T, device=dev).expand(B, T)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    quant = cache is not None and "k_scale" in cache
    if mode != "train" and not quant:
        k = k.to(cache["k"].dtype)
        v = v.to(cache["v"].dtype)

    if mode == "train" and gather_kv:
        k, v = kv_gathered(k), kv_gathered(v)
    if mode == "train":
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, window=window)
    elif mode == "chunk":
        wb = torch.as_tensor(paged["write_blocks"], device=dev)  # [B]
        for name, val in _store(k, v, quant).items():
            cache[name][wb] = val
        out = paged_attention(q, cache, paged["page_table"], pos)
    elif mode == "prefill":
        if quant and quant_consistent:
            kq, vq = _read(_store(k, v, True), q.dtype)
        else:
            kq, vq = k.to(q.dtype), v.to(q.dtype)
        out = ops.flash_attention(q.contiguous(), kq.contiguous(),
                                  vq.contiguous(), causal=True, window=window)
        S = cache["k"].shape[1]
        if S < T:  # ring cache: keep only the last S, rotated to p % S
            k = torch.roll(k[:, T - S:], (T - S) % S, dims=1)
            v = torch.roll(v[:, T - S:], (T - S) % S, dims=1)
        for name, val in _store(k, v, quant).items():
            cache[name][:, :val.shape[1]] = val
    elif mode == "decode" and paged is not None:
        # paged decode: scatter each row's k/v into (its current block,
        # in-block offset), then attend over the row's pages. Vacant rows
        # carry an all-null page table, so their garbage lands in the
        # reserved null block 0.
        bs = cache["k"].shape[1]
        tbl = torch.as_tensor(paged["page_table"], device=dev)  # [B, P]
        pos_arr = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        blocks = torch.gather(tbl, 1, (pos_arr // bs)[:, None])[:, 0]  # [B]
        offs = pos_arr % bs
        for name, val in _store(k[:, 0], v[:, 0], quant).items():
            cache[name][blocks, offs] = val
        out = paged_attention(q, cache, tbl, pos_arr)
    elif mode == "decode":
        S = cache["k"].shape[1]
        ring = window > 0  # a windowed cache is a ring of S slots
        pos_arr = torch.as_tensor(pos, device=dev).reshape(-1).expand(B)
        rows = torch.arange(B, device=dev)
        entry = _store(k[:, 0], v[:, 0], quant)
        if ring:
            slot = pos_arr % S
            for name, val in entry.items():
                cache[name][rows, slot] = val
        else:
            # the reference's out-of-range writes are no-ops: such a row
            # writes its slot S - 1 back unchanged (a fixed-shape write; a
            # boolean index would read the mask on the host, and has no
            # shape on the meta device)
            ok = pos_arr < S
            slot = torch.where(ok, pos_arr, S - 1)
            for name, val in entry.items():
                keep = ok.reshape((B,) + (1,) * (val.dim() - 1))
                cache[name][rows, slot] = torch.where(
                    keep, val, cache[name][rows, slot])
        kc, vc = _read(cache, q.dtype)
        out = decode_attention(q, kc, vc, pos_arr, ring=ring)
    else:
        raise ValueError(mode)
    hp, hd = cfg.padded_heads(ep), cfg.hd
    out = out.reshape(B, T, hp * hd) @ p["wo"]
    return (x + out if residual else out), cache


def copy_pool_block(cache: dict, src, dst, block_axis: int = 0) -> dict:
    """Copy one physical block of a paged KV pool in place, every leaf (k/v
    and, in the int8 layout, their scales) — the copy-on-write primitive
    behind prefix sharing. ``block_axis`` selects
    the blocks dimension: 0 for a single-layer pool
    ``[n_blocks, bs, KVH, hd]``, 1 for the grouped stacks
    ``[n_groups, n_blocks, bs, KVH, hd]``."""
    pre = (slice(None),) * block_axis
    for a in cache.values():
        a[pre + (int(dst),)] = a[pre + (int(src),)]
    return cache


def init_paged_kv(cfg, n_blocks: int, block_size: int, *, dtype=torch.bfloat16,
                  quantized: bool = False, device="cuda") -> dict:
    """Paged block pool for one attention sublayer: ``n_blocks`` physical
    blocks of ``block_size`` positions shared by every serving slot (block 0
    is reserved as the null block — see ``serving.runtime.BlockAllocator``).
    """
    shape = (n_blocks, block_size, cfg.num_kv_heads, cfg.hd)
    return _zeros_kv(shape, dtype, quantized, device)


def _zeros_kv(shape, dtype, quantized: bool, device) -> dict:
    if quantized:
        scale = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(scale, dtype=torch.bfloat16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_attn_cache(cfg, batch: int, seq_len: int, *, window: int = 0,
                    dtype=torch.bfloat16, quantized: bool = False,
                    device="cuda") -> dict:
    """Dense cache of one attention sublayer: ``[batch, S, KVH, hd]`` with
    ``S = min(window, seq_len)`` under a sliding window (a ring), else
    ``seq_len``."""
    S = min(window, seq_len) if window else seq_len
    return _zeros_kv((batch, S, cfg.num_kv_heads, cfg.hd), dtype, quantized,
                     device)
