"""Decoder stack assembly (PyTorch port of ``repro.models.transformer``):

  init_params   — parameter dict (group params stacked [G, ...])
  loss_fn       — causal-LM loss + MoE aux losses (train mode, autograd)
  prefill       — full-sequence forward, returns last-token logits + cache
  decode_step   — one token against the cache (dense or paged)
  prefill_chunk — batched paged chunked prefill
  init_cache / init_paged_cache — allocate the decode caches

The reference scans the stacked layer groups with ``lax.scan``; here a
Python loop walks them. Every block kind (ATTN, MLP, MOE, MAMBA1, MAMBA2,
SHARED_ATTN) is ported; MLA (``models.mla``) is the port's own. In train
mode each layer group runs under ``torch.utils.checkpoint`` with the
reference's remat policies (``Runtime.remat_policy``, see
``_remat_kwargs``).

A configuration with a ``prefix_pattern()`` (DeepSeek-V2's leading dense
layers, ``configs.mla``) has ``params["prefix"]``, stacked
``[n_prefix, ...]``, and runs those layers ahead of the groups; their cache
entries are keyed ``"prefix.b<i>"`` beside the groups' ``"b<i>"``. Only
the groups carry MoE statistics and placements.

``Runtime.mesh`` (a ``models.sharding.VirtualMesh``) and ``Runtime.layout``
(tp, sp, cp, fsdp) are the reference's. On one card a layout moves no
values: the reference's sp residual sharding (its ``_sp_gather`` /
``_sp_scatter`` constraints) places rows on devices and changes nothing
they hold, so it is not ported. What a layout does decide is which virtual
device owns which rows of the MoE (the sequence-sharded branch under sp,
cp and fsdp outside decode, so at a tight capacity the drops and counts
are the layout's) and which k/v copies ``dots+kv`` keeps (cp, fsdp).
``cache_seq_sharded`` places the KV cache over every mesh axis
(``sharding.cache_pspecs``), which the paged pool does not support; decode
attention computes the same single softmax either way. Not ported:
``scan_layers`` (a Python loop walks the groups either way).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN, MAMBA1, MAMBA2, MLP, MOE,
                                      SHARED_ATTN, ModelConfig)
from repro_torch.configs.mla import MLA
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mla
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (embed_init, mlp_apply, mlp_params,
                                       rms_norm, softmax_xent)

LOSS_CHUNK = 2048  # cross-entropy rows whose logits are formed at once
LAYOUTS = ("tp", "sp", "cp", "fsdp")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Model + execution context. ``mesh``: a ``models.sharding.VirtualMesh``
    (None: the ``(1, n_ep)`` mesh of ``ep_spec``'s virtual EP ranks);
    ``device`` is where parameters, caches and activations live (CUDA
    unless the caller asks for the CPU). On a CUDA device the MoE FFN,
    prefill attention and the Mamba-1 training scan always run the
    hand-written kernels."""

    cfg: ModelConfig
    moe_impl: str = "dense"  # 'dense' | 'ep'
    ep_spec: Any = None  # moe.EPSpec when moe_impl == 'ep'
    dtype: Any = torch.float32
    device: str = "cuda"
    window: int = 0  # >0: sliding-window attention (dense caches: a ring)
    kv_quant: bool = False  # int8 KV cache
    kv_quant_consistent: bool = False  # prefill attends to dequantized k/v
    #   (serve-consistent: full and paged chunked prefill agree bit-wise)
    remat_policy: str = "none"  # none | dots | dots+kv (see _remat_kwargs)
    mesh: Any = None  # models.sharding.VirtualMesh
    layout: str = "tp"  # tp | sp (seq-parallel residual) | cp (replicated
    #   weights, ctx-parallel) | fsdp
    cache_seq_sharded: bool = False  # long context: KV cache over every axis

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout {self.layout!r} not in {LAYOUTS}")

    @property
    def ep(self) -> int:
        """Model-axis width (for head padding): the mesh's, else the EP
        rank count (a (1, n_ep) mesh)."""
        if self.mesh is not None:
            return self.mesh.shape["model"]
        return self.ep_spec.n_ep if self.ep_spec is not None else 1

    @property
    def ep_axes(self) -> tuple:
        return self.ep_spec.axes if self.ep_spec is not None else ("model",)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _block_params(rt: Runtime, kind: str, gen, d_ff: int | None = None):
    cfg, dt, dev = rt.cfg, rt.dtype, rt.device
    if kind in (ATTN, SHARED_ATTN):
        return attn.attn_params(gen, cfg, rt.ep, dt, dev)
    if kind == MLA:
        return mla.mla_params(gen, cfg, dt, dev)
    if kind == MLP:
        p = mlp_params(gen, cfg.d_model, d_ff or cfg.d_ff, dt, dev)
        p["norm"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
        return p
    if kind == MOE:
        if rt.moe_impl == "ep":
            return moe_mod.moe_params_ep(gen, cfg, rt.ep_spec, dt, dev)
        return moe_mod.moe_params_dense(gen, cfg, dt, dev)
    if kind == MAMBA1:
        return ssm.mamba1_params(gen, cfg, dt, dev)
    if kind == MAMBA2:
        return ssm.mamba2_params(gen, cfg, dt, dev)
    raise ValueError(kind)


def init_params(rt: Runtime, seed: int = 0) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, on
    ``rt.device`` (on ``meta``: empty leaves of the right shapes). (Weights
    are never expected to equal the reference's: parity tests carry the
    reference's weights across with ``checkpoint.io.params_from_numpy``.)"""
    cfg = rt.cfg
    gen = (None if torch.device(rt.device).type == "meta"
           else torch.Generator(device=rt.device).manual_seed(seed))
    pattern, n_groups = cfg.layer_pattern()
    params: dict = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), rt.dtype,
                            rt.device),
        "final_norm": torch.ones((cfg.d_model,), dtype=rt.dtype,
                                 device=rt.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                       rt.dtype, rt.device)
    if SHARED_ATTN in pattern:
        params["shared_attn"] = _block_params(rt, SHARED_ATTN, gen)
    prefix = _prefix_pattern(cfg)
    if prefix is not None:
        params["prefix"] = _stacked(rt, gen, *prefix, d_ff=cfg.dense_d_ff)
    params["groups"] = _stacked(rt, gen, pattern, n_groups)
    return params


def _prefix_pattern(cfg):
    """(block kinds, number) of the leading layers that run ahead of the
    groups, or None."""
    fn = getattr(cfg, "prefix_pattern", None)
    if fn is None:
        return None
    pattern, n = fn()
    return (pattern, n) if n else None


def _stacked(rt: Runtime, gen, pattern, n_groups: int, d_ff=None) -> dict:
    """``{"b<i>": params stacked [n_groups, ...]}`` for each block kind of
    ``pattern`` but the shared attention."""
    groups: dict = {}
    for i, kind in enumerate(pattern):
        if kind == SHARED_ATTN:
            continue
        stacked = None
        for g in range(n_groups):
            p = _block_params(rt, kind, gen, d_ff)
            if stacked is None:
                stacked = {k: v.new_empty((n_groups,) + tuple(v.shape))
                           for k, v in p.items()}
            for k, v in p.items():
                stacked[k][g] = v
            del p
        groups[f"b{i}"] = stacked
    return groups


# ---------------------------------------------------------------------------
# Group application
# ---------------------------------------------------------------------------


def _take(tree, g: int):
    """Layer group ``g`` of a stacked dict (views, no copies)."""
    if tree is None:
        return None
    return {k: (_take(v, g) if isinstance(v, dict) else v[g])
            for k, v in tree.items()}


def _apply_block(rt: Runtime, kind: str, p, h, *, mode, cache, pos,
                 placement, token_mask=None, paged=None, origin=None):
    cfg = rt.cfg
    if kind in (ATTN, SHARED_ATTN):
        ops.phase_mark("attention", h)   # a traced capture's phase marks
        return attn.attn_apply(
            p, cfg, h, ep=rt.ep, mode=mode, cache=cache, pos=pos,
            window=rt.window, norm_eps=cfg.norm_eps,
            gather_kv=(rt.layout in ("cp", "fsdp") and rt.mesh is not None),
            paged=paged, quant_consistent=rt.kv_quant_consistent)
    if kind == MLA:
        ops.phase_mark("attention", h)
        return mla.mla_apply(p, cfg, h, mode=mode, cache=cache, pos=pos,
                             paged=paged, norm_eps=cfg.norm_eps)
    if kind == MLP:
        ops.phase_mark("mlp", h)
        x = rms_norm(h, p["norm"], cfg.norm_eps)
        return h + mlp_apply(p, x), None
    if kind == MOE:
        ops.phase_mark("moe", h)
        if rt.moe_impl == "ep":
            return moe_mod.moe_apply_ep(
                p, cfg, h, spec=rt.ep_spec, placement=placement, mode=mode,
                mesh=rt.mesh, norm_eps=cfg.norm_eps,
                # serving steps (decode / chunk) take the masked dispatch
                # branch: the sequence-sharded one ignores token_mask
                seq_sharded_out=(rt.layout in ("sp", "cp", "fsdp")
                                 and mode not in ("decode", "chunk")),
                token_mask=token_mask, origin=origin)
        return moe_mod.moe_apply_dense(p, cfg, h, norm_eps=cfg.norm_eps)
    if kind == MAMBA1:
        return ssm.mamba1_apply(p, cfg, h, mode=mode, cache=cache,
                                norm_eps=cfg.norm_eps)
    if kind == MAMBA2:
        return ssm.mamba2_apply(p, cfg, h, mode=mode, cache=cache,
                                norm_eps=cfg.norm_eps)
    raise ValueError(kind)


def stack_placement(placement, n_groups: int):
    """Broadcast a single EPPlacement to the per-layer stacked form
    [n_groups, ...] (per-layer tables may also be built directly by the
    placement algorithms)."""
    return moe_mod.EPPlacement(*(
        a.expand((n_groups,) + tuple(a.shape)) if torch.is_tensor(a)
        else np.broadcast_to(a, (n_groups,) + np.shape(a))
        for a in placement))


# the matmul ops whose outputs ``dots`` keeps: jax's ``dots_saveable``
_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.baddbmm)


def _dots_saveable(ctx, op, *args, **kwargs):
    if op.overloadpacket in _DOTS and not ops.in_plain_kernel():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_kv_saveable(ctx, op, *args, **kwargs):
    if attn.naming_kv():
        return CheckpointPolicy.MUST_SAVE
    return _dots_saveable(ctx, op, *args, **kwargs)


def _remat_kwargs(policy: str) -> dict:
    """``torch.utils.checkpoint`` arguments of a layer group under the
    reference's remat policy. ``none``: keep the group's input only and
    recompute the rest (``nothing_saveable``). ``dots``: also keep every
    matmul output (``dots_saveable``) outside the kernels; the hand
    kernels run inside ``autograd.Function``s, not as aten matmuls, so
    they are recomputed, as the reference's Pallas calls are not dots, and
    so are their plain versions' matmuls on the CPU and on meta (the FLOP
    count then holds the recompute the card runs). ``dots+kv`` also keeps
    the reference's ``kv_gathered`` names: the k/v copies that
    ``attention.kv_gathered`` makes under the cp and fsdp layouts with a
    mesh; elsewhere there are none, and it keeps what ``dots`` keeps, as
    the reference's does."""
    if policy == "none":
        return {}
    if policy in ("dots", "dots+kv"):
        fn = _dots_saveable if policy == "dots" else _dots_kv_saveable
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, fn)}
    raise ValueError(f"unknown remat policy {policy!r}")


def _run_stack(rt: Runtime, params, h, *, mode, cache, pos, placement,
               token_mask=None, paged=None, origin=None):
    """Walk the layer groups. Returns (h, cache, stacked_moe_stats).

    ``placement`` (EP MoE only): device EPPlacement with a leading
    [n_groups] dim. ``token_mask`` ([B] in decode, [B, T] in chunk mode)
    excludes vacant rows / prompt padding from the gating statistics;
    ``origin`` ([B] or [B, T]) attributes each token's gating counts to the
    EP rank its request originated at. ``paged``: the page-table info
    shared by every layer. Caches are written in place. In train mode
    (``cache`` None) each group runs under activation checkpointing."""
    cfg = rt.cfg
    pattern, n_groups = cfg.layer_pattern()
    shared_p = params.get("shared_attn")
    has_moe = MOE in pattern
    if has_moe and rt.moe_impl == "ep" and placement is None:
        raise ValueError("EP MoE requires a placement")
    prefix = _prefix_pattern(cfg)
    pre_cache, group_cache = _split_cache(cache)

    def walk(h, pat, gp, gcache, gpl):
        stats = None
        for i, kind in enumerate(pat):
            p = shared_p if kind == SHARED_ATTN else gp[f"b{i}"]
            c = gcache.get(f"b{i}") if gcache is not None else None
            h, extra = _apply_block(rt, kind, p, h, mode=mode, cache=c,
                                    pos=pos, placement=gpl,
                                    token_mask=token_mask, paged=paged,
                                    origin=origin)
            if kind == MOE:
                stats = extra  # one MoE sublayer per group at most
        return h, stats

    def prefix_layer(h, g):
        return walk(h, prefix[0], _take(params["prefix"], g),
                    _take(pre_cache, g), None)[0]

    def group(h, g):
        gpl = (moe_mod.EPPlacement(*(a[g] for a in placement))
               if placement is not None else None)
        return walk(h, pattern, _take(params["groups"], g),
                    _take(group_cache, g), gpl)

    remat = _remat_kwargs(rt.remat_policy) if mode == "train" else None
    for g in range(prefix[1] if prefix is not None else 0):
        if mode == "train":
            h = checkpoint(prefix_layer, h, g, use_reentrant=False,
                           preserve_rng_state=False, **remat)
        else:
            h = prefix_layer(h, g)
    stats = []
    for g in range(n_groups):
        if mode == "train":
            # the blocks draw no random numbers: no RNG state to replay
            h, st = checkpoint(group, h, g, use_reentrant=False,
                               preserve_rng_state=False, **remat)
        else:
            h, st = group(h, g)
        stats.append(st)
    mstats = ({k: torch.stack([s[k] for s in stats]) for k in stats[0]}
              if has_moe else None)
    return h, cache, mstats


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _embed(rt: Runtime, params, tokens):
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    return params["embed"][tokens.long()].to(rt.dtype)


def _logits(rt: Runtime, params, h):
    h = rms_norm(h, params["final_norm"], rt.cfg.norm_eps)
    w = params["embed"].T if rt.cfg.tie_embeddings else params["lm_head"]
    return h @ w


def _chunked_xent(rt: Runtime, params, h, targets):
    """Mean cross-entropy over the first ``n * chunk`` rows (as in the
    reference, rows past the last whole chunk are left out), each chunk's
    logits recomputed in the backward instead of kept: the [B, T, V] logits
    never exist at once."""
    B, T, D = h.shape
    rows = h.reshape(B * T, D)
    tgt = targets.reshape(B * T)
    chunk = min(LOSS_CHUNK, B * T)
    n = B * T // chunk

    def chunk_loss(r, t):
        return softmax_xent(_logits(rt, params, r), t).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(chunk_loss, rows[sl], tgt[sl],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (n * chunk)


def loss_fn(rt: Runtime, params, tokens, targets, placement=None,
            aux_weight: float = 0.01):
    """tokens/targets: [B, T] int. Returns (loss, metrics) with the
    reference's metrics keys: ``ce_loss``, ``loss`` and, for MoE configs,
    ``aux_loss``, ``local_frac`` and ``expert_counts``. Runs with autograd
    as the caller has it (``training.train_loop`` differentiates it)."""
    h = _embed(rt, params, tokens)
    h, _, mstats = _run_stack(rt, params, h, mode="train", cache=None,
                              pos=None, placement=placement)
    targets = torch.as_tensor(targets, device=h.device).long()
    ce = _chunked_xent(rt, params, h, targets)
    metrics = {"ce_loss": ce}
    loss = ce
    if mstats is not None:
        aux = mstats["aux_loss"].mean()
        loss = loss + aux_weight * aux
        metrics.update(aux_loss=aux, local_frac=mstats["local_frac"].mean(),
                       expert_counts=mstats["counts_per_rank"])
    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def prefill(rt: Runtime, params, tokens=None, embeds=None, placement=None,
            cache_len: int | None = None, origin=None):
    """tokens: [B, T], or ``embeds`` [B, T, D]: the modality frontend's
    pre-computed patch / frame embeddings (vlm, audio), cast to
    ``rt.dtype`` in place of the token embedding. Returns (last-token
    logits [B, V], cache, moe_stats). ``origin``: optional [B] — the EP
    rank each request originated at."""
    h = (_embed(rt, params, tokens) if embeds is None else
         torch.as_tensor(embeds, device=params["embed"].device).to(rt.dtype))
    B, T = h.shape[:2]
    cache = init_cache(rt, B, cache_len if cache_len is not None else T)
    h, cache, mstats = _run_stack(rt, params, h, mode="prefill", cache=cache,
                                  pos=None, placement=placement, origin=origin)
    return _logits(rt, params, h[:, -1]), cache, mstats


@torch.no_grad()
def decode_step(rt: Runtime, params, cache, tokens, pos, placement=None,
                token_mask=None, page_table=None, origin=None):
    """tokens: [B, 1]; pos: scalar (whole batch at one position) or [B]
    vector (continuous batching). token_mask: optional [B] float validity
    (0-rows are excluded from the MoE gating statistics). page_table:
    optional [B, P] — ``cache`` is then a paged block pool. origin: optional
    [B] originating EP rank per row. Returns (logits [B, V], cache,
    moe_stats); the cache is updated in place."""
    h = _embed(rt, params, tokens)
    paged = {"page_table": page_table} if page_table is not None else None
    h, cache, mstats = _run_stack(rt, params, h, mode="decode", cache=cache,
                                  pos=pos, placement=placement,
                                  token_mask=token_mask, paged=paged,
                                  origin=origin)
    ops.phase_mark("head", h)
    return _logits(rt, params, h[:, -1]), cache, mstats


@torch.no_grad()
def prefill_chunk(rt: Runtime, params, cache, tokens, page_table,
                  write_blocks, offset, last_idx, placement=None,
                  token_mask=None, origin=None):
    """Batched paged chunked prefill: one ``block_size``-aligned chunk of up
    to ``B`` different prompts (one per serving slot) in one call.

    tokens: [B, bs]; page_table: [B, P]; write_blocks: [B] physical block
    receiving each row's k/v (idle rows: the null block 0); offset: [B]
    absolute position of ``tokens[b, 0]``; last_idx: [B] in-chunk index
    whose logits to return; token_mask: optional [B, bs] (0 = padding);
    origin: optional [B]. Returns (logits [B, V], cache, moe_stats)."""
    h = _embed(rt, params, tokens)
    dev = h.device
    paged = {"page_table": torch.as_tensor(page_table, device=dev),
             "write_blocks": torch.as_tensor(write_blocks, device=dev)}
    offset = torch.as_tensor(offset, device=dev)
    h, cache, mstats = _run_stack(rt, params, h, mode="chunk", cache=cache,
                                  pos=offset, placement=placement,
                                  token_mask=token_mask, paged=paged,
                                  origin=origin)
    ops.phase_mark("head", h)
    B = h.shape[0]
    last = torch.as_tensor(last_idx, device=dev).long()
    h_last = h[torch.arange(B, device=dev), last]  # [B, D]
    return _logits(rt, params, h_last), cache, mstats


PREFIX_KEY = "prefix."  # cache entries of the leading layers


def _split_cache(cache):
    """(the prefix layers' cache entries, the groups'), each keyed
    ``b<i>``; (None, None) for no cache."""
    if cache is None:
        return None, None
    pre = {k[len(PREFIX_KEY):]: v for k, v in cache.items()
           if k.startswith(PREFIX_KEY)}
    return pre, {k: v for k, v in cache.items()
                 if not k.startswith(PREFIX_KEY)}


def _cache_entries(rt: Runtime, make) -> dict:
    """Every cache entry of the model, the prefix layers' first: ``make
    (kind, n)`` gives the entry of a block kind stacked ``n`` deep, or
    None for a kind that holds no cache."""
    out = {}
    prefix = _prefix_pattern(rt.cfg)
    lists = [(PREFIX_KEY, *prefix)] if prefix is not None else []
    lists.append(("", *rt.cfg.layer_pattern()))
    for key, pattern, n in lists:
        for i, kind in enumerate(pattern):
            c = make(kind, n)
            if c is not None:
                out[f"{key}b{i}"] = c
    return out


def copy_paged_block(pool, src, dst):
    """Copy one physical block across every layer of a paged pool, in place
    (the serving-side copy-on-write primitive)."""
    for c in pool.values():
        attn.copy_pool_block(c, src, dst, block_axis=1)
    return pool


def supports_paging(rt: Runtime) -> bool:
    """Whether this runtime's caches can live in a paged block pool:
    attention-only state, no sliding-window ring and no sequence-sharded
    cache."""
    pattern, _ = rt.cfg.layer_pattern()
    return (not rt.window and not rt.cache_seq_sharded
            and not any(k in (MAMBA1, MAMBA2) for k in pattern))


def init_paged_cache(rt: Runtime, n_blocks: int, block_size: int,
                     dtype=None) -> dict:
    """Paged KV block pool: per attention sublayer, ``[n_groups, n_blocks,
    block_size, KVH, hd]`` shared by all serving slots (block 0 reserved as
    the null block); per MLA sublayer the latent pool ``{"ckv": [n_groups,
    n_blocks, block_size, latent_dim]}`` (no int8 layout). The prefix
    layers' entries (``"prefix.b<i>"``) lead with their own count."""
    if dtype is None:
        dtype = rt.dtype
    cfg = rt.cfg
    if not supports_paging(rt):
        raise ValueError(
            "paged KV pool requires attention-only caches without a "
            f"sliding window; {cfg.name} (window={rt.window}) does not "
            "qualify — use the dense slot pool")

    def make(kind, n):
        if kind == MLA:
            return mla.init_latent(cfg, (n, n_blocks, block_size),
                                   dtype=dtype, quantized=rt.kv_quant,
                                   device=rt.device)
        if kind in (ATTN, SHARED_ATTN):
            c = attn.init_paged_kv(cfg, n * n_blocks, block_size,
                                   dtype=dtype, quantized=rt.kv_quant,
                                   device=rt.device)
            return {k: v.reshape((n, n_blocks) + tuple(v.shape[1:]))
                    for k, v in c.items()}
        return None

    return _cache_entries(rt, make)


def init_cache(rt: Runtime, batch: int, seq_len: int, dtype=None) -> dict:
    """Per-group dense cache dict, leading dim = n_groups."""
    if dtype is None:
        dtype = rt.dtype
    cfg = rt.cfg

    def make(kind, n):
        if kind == MLA:
            return mla.init_latent(cfg, (n, batch, seq_len), dtype=dtype,
                                   quantized=rt.kv_quant, device=rt.device)
        if kind in (ATTN, SHARED_ATTN):
            c = attn.init_attn_cache(cfg, batch * n, seq_len,
                                     window=rt.window, dtype=dtype,
                                     quantized=rt.kv_quant, device=rt.device)
            return {k: v.reshape((n, batch) + tuple(v.shape[1:]))
                    for k, v in c.items()}
        if kind in (MAMBA1, MAMBA2):
            init = (ssm.init_mamba1_cache if kind == MAMBA1
                    else ssm.init_mamba2_cache)
            c = init(cfg, batch, dtype, device=rt.device)
            return {k: v.new_zeros((n,) + tuple(v.shape))
                    for k, v in c.items()}
        return None

    return _cache_entries(rt, make)
