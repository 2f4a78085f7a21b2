"""Placement-aware Mixture-of-Experts layer (PyTorch port of
``repro.models.moe``).

Two implementations with identical math:

* ``dense`` — reference oracle: every expert computed for every token,
  combined with the routing weights.
* ``ep`` — expert parallel over the *virtual* devices of a mesh
  (``models.sharding.VirtualMesh``; without one, a ``(1, n_ep)`` mesh). The
  reference runs one EP rank per device of a ``shard_map`` mesh (one rank
  = one of the paper's edge servers); the port runs every device in one
  process, with leading ``[G, n_ep]`` axes on the tensors: the devices
  that share their coordinates on the non-EP axes form one EP group
  (``G`` groups), and each group's ranks exchange tokens among
  themselves:

  - ``all_to_all`` is a swap of the source and destination rank axes
    (``_AllToAll``: the token exchange, its expert ids and the return);
  - ``psum`` is a sum over the rank axis (``_pmean`` of the local ratio
    and the aux loss, the per-origin counts, the decode gather's output);
  - ``all_gather`` is a concatenation (the devices' output rows, and the
    decode gather's rows over its gather axes).

  Each of these adds its result's bytes and 1 to ``collective_counts()``
  (all-reduce bytes twice, as the reference's roofline counts its reduce
  and broadcast phases): the counterpart of
  ``repro.launch.roofline.collective_bytes_from_hlo``, which parses them
  out of the compiled HLO; the port has no HLO, so nothing parses it. On
  one card every device's result lives on the one device, so a count is
  the bytes of every group's result, where the reference's is one
  device's. The exchange's backward is the exchange the other way and
  counts too; the backward of the sums and the concatenation does not.

  Which device owns which rows is the reference's (``moe_apply_ep``), and
  so are the capacities, stable-sort bucketing and capacity drops of each
  device: dropped rows, the per-origin ``counts_per_rank [n_ep, E]`` and
  ``local_frac`` match it exactly on any mesh. The buffers are sized by
  the capacities in force at the call (``ep_call_capacities``): the
  spec's, or the bound that the call's static shape proves no bucket
  reaches, whichever is smaller, so a call that routes a few rows moves a
  few rows' bytes and keeps, drops and counts exactly the same rows.
  Three branches, as in the reference:
  - ``dispatch`` (prefill / chunk / train): rows split over
    ``EPSpec.dispatch_row_axes`` (padded with masked rows to the mesh
    size), capacity-bounded exchange inside each group;
  - sequence-sharded (``seq_sharded_out``, the sp / cp / fsdp layouts in
    prefill and train): each device's ``[B-shard, T-shard]`` block,
    flattened locally;
  - ``gather`` (decode): rows over the batch axes when they divide them;
    each group's ranks see the rows gathered over the EP axes among the
    batch axes, compute the (token, expert) pairs routed to them, and
    the rank outputs are summed.

The expert FFN of every group and rank runs as one ``kernels.ops.moe_gmm``
call over the ``[n_ep * S]`` slots, with per-slot fill counts, so the
kernel only touches the rows actually routed. The groups share the
experts' weights: their rows for one slot are packed one group after
another into a slot of ``G * C2`` rows, so no weight is copied per group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, mlp_apply, mlp_params,
                                       rms_norm)
from repro_torch.models.sharding import VirtualMesh, make_test_mesh


@dataclasses.dataclass(frozen=True)
class EPSpec:
    """Static expert-parallel geometry."""

    n_ep: int  # number of EP ranks (product of the EP axes' sizes)
    slots: int  # S: expert slots per rank
    capacity: int  # C: per (src->dst) send capacity
    slot_capacity: int  # C2: per-slot compute capacity (recv side)
    axes: tuple = ("model",)  # mesh axes forming the EP dimension
    mesh_axes: tuple = ("data", "model")  # all mesh axis names, in order

    @property
    def batch_axes(self) -> tuple:
        return tuple(a for a in self.mesh_axes if a != "model")

    @property
    def dispatch_row_axes(self) -> tuple:
        return (tuple(a for a in self.mesh_axes if a not in self.axes)
                + tuple(self.axes))

    @staticmethod
    def build(mesh, cfg, *, ep_axes=("model",), capacity_factor: float = 2.0,
              rows_per_rank: int = 4096, slots: int | None = None,
              capacity: int | None = None, slot_capacity: int | None = None):
        """``repro.models.moe.EPSpec.build``: ``mesh`` is a ``VirtualMesh``
        (or the reference's mesh: only its ``shape`` and ``axis_names``
        are read); an int ``n_ep`` stands for a ``(1, n_ep)`` mesh."""
        if isinstance(mesh, int):
            mesh = make_test_mesh(1, mesh)
        n_ep = int(np.prod([mesh.shape[a] for a in ep_axes]))
        S = slots if slots is not None else (
            -(-cfg.num_experts // n_ep) + (1 if n_ep > 1 else 0))
        C = capacity if capacity is not None else max(
            8, int(np.ceil(rows_per_rank * cfg.top_k / n_ep * capacity_factor)))
        C2 = slot_capacity if slot_capacity is not None else max(
            8, int(np.ceil(n_ep * C / S)))
        return EPSpec(n_ep, S, C, C2, tuple(ep_axes), tuple(mesh.axis_names))


class EPPlacement(NamedTuple):
    """Routing tables derived from a placement plan (numpy int32 on the host;
    ``placement_to`` moves them to the device as int64 index tensors)."""

    slot_to_expert: object  # [n_ep, S] (-1 = empty slot)
    expert_to_slot: object  # [n_ep, E] (-1 = not resident)
    expert_to_target: object  # [n_ep, E] (src rank -> replica rank)


def placement_to(placement: EPPlacement, device) -> EPPlacement:
    """Tables as int64 tensors on ``device`` (any leading layer dims kept)."""
    return EPPlacement(*(torch.as_tensor(np.array(a), dtype=torch.int64,
                                         device=device)
                         if not torch.is_tensor(a)
                         else a.to(device=device, dtype=torch.int64)
                         for a in placement))


def uniform_placement(n_ep: int, S: int, E: int) -> EPPlacement:
    """Megatron-style uniform EP layout (the paper's `Uniform` baseline):
    expert e lives on rank e % n_ep; no replication."""
    s2e = -np.ones((n_ep, S), np.int32)
    for e in range(E):
        r, s = e % n_ep, e // n_ep
        if s < S:
            s2e[r, s] = e
    return placement_from_tables(s2e, num_experts=E)


def placement_from_tables(s2e: np.ndarray, mesh_distance=None,
                          num_experts: int | None = None) -> EPPlacement:
    """Build routing tables from a slot_to_expert matrix [n_ep, S]
    (output of the placement algorithms; -1 = empty slot).

    ``expert_to_target`` picks, per source rank, the nearest replica by
    ``mesh_distance[src, dst]`` (default: ring distance over EP ranks).
    """
    n_ep, S = s2e.shape
    E = num_experts if num_experts is not None else int(s2e.max()) + 1
    e2s = -np.ones((n_ep, E), np.int32)
    for r in range(n_ep):
        for s in range(S):
            e = int(s2e[r, s])
            if e >= 0:
                e2s[r, e] = s
    if mesh_distance is None:
        idx = np.arange(n_ep)
        mesh_distance = np.minimum(np.abs(idx[:, None] - idx[None, :]),
                                   n_ep - np.abs(idx[:, None] - idx[None, :]))
    e2t = np.zeros((n_ep, E), np.int32)
    for e in range(E):
        holders = np.where(e2s[:, e] >= 0)[0]
        if len(holders) == 0:
            raise ValueError(f"expert {e} unplaced (coverage violated)")
        d = np.asarray(mesh_distance)[:, holders]  # [n_ep, n_holders]
        e2t[:, e] = holders[np.argmin(d, axis=1)]
    return EPPlacement(s2e.astype(np.int32), e2s, e2t)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _with_shared(p: dict, gen, cfg, dtype, device) -> dict:
    """``p`` plus the shared experts of a configuration that has them
    (``n_shared_experts``, DeepSeek-V2): one SwiGLU of their summed width,
    ``shared_w1``, ``shared_w3``, ``shared_w2``."""
    n = getattr(cfg, "n_shared_experts", 0)
    if n:
        for k, w in mlp_params(gen, cfg.d_model, n * cfg.d_ff, dtype,
                               device).items():
            p["shared_" + k] = w
    return p


def moe_params_dense(gen, cfg, dtype=torch.float32, device="cuda") -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return _with_shared({
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "router": dense_init(gen, (d, E), 0, dtype, device),
        "w1": dense_init(gen, (E, d, f), 1, dtype, device),
        "w3": dense_init(gen, (E, d, f), 1, dtype, device),
        "w2": dense_init(gen, (E, f, d), 1, dtype, device),
    }, gen, cfg, dtype, device)


def moe_params_ep(gen, cfg, spec: EPSpec, dtype=torch.float32,
                  device="cuda") -> dict:
    """EP-layout params: expert weights stored per (rank, slot)."""
    d, f = cfg.d_model, cfg.d_ff
    n, S = spec.n_ep, spec.slots
    return _with_shared({
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "router": dense_init(gen, (d, cfg.num_experts), 0, dtype, device),
        "w1": dense_init(gen, (n, S, d, f), 2, dtype, device),
        "w3": dense_init(gen, (n, S, d, f), 2, dtype, device),
        "w2": dense_init(gen, (n, S, f, d), 2, dtype, device),
    }, gen, cfg, dtype, device)


def _slot_index(placement: EPPlacement, device) -> torch.Tensor:
    s2e = placement.slot_to_expert
    s2e = s2e if torch.is_tensor(s2e) else torch.as_tensor(np.array(s2e))
    return s2e.to(device=device, dtype=torch.int64).clamp(min=0)


_ROUTED = ("w1", "w3", "w2")  # the routed experts' weights, per slot


def dense_to_ep(dense_p: dict, placement: EPPlacement) -> dict:
    """Materialise EP-layout weights from dense weights + a placement
    (also the migration primitive: a new placement is just a new gather)."""
    s2e = _slot_index(placement, dense_p["w1"].device)
    out = {k: v for k, v in dense_p.items() if k not in _ROUTED}
    for k in _ROUTED:
        out[k] = dense_p[k][s2e]  # [n_ep, S, ...]
    return out


def regather_ep_groups(dense_groups: dict, placement_stacked,
                       n_groups: int, out: dict | None = None) -> dict:
    """Apply ``dense_to_ep`` per layer group: dense master group params
    (stacked [G, E, ...]) + stacked placement tables -> EP-layout groups,
    gathered straight into one stacked tensor per weight (no per-group
    copies to stack). Non-MoE groups, and a MoE group's weights other than
    the routed experts' (norm, router, shared experts), pass through
    unchanged.

    ``out``: EP-layout groups to gather *into*: each MoE group's ``w1``,
    ``w3`` and ``w2`` are overwritten in place (contiguous, of the
    gathered shape) and keep their storage — what a captured CUDA graph
    that reads them needs. Returns ``out`` then."""
    res = {}
    for k, v in dense_groups.items():
        if "router" not in v:
            res[k] = v
            continue
        idx = [_slot_index(EPPlacement(*(t[g] for t in placement_stacked)),
                           v["w1"].device) for g in range(n_groups)]
        grp = {n: w for n, w in v.items() if n not in _ROUTED}
        for n in _ROUTED:
            a = v[n]
            shape = (n_groups,) + tuple(idx[0].shape) + tuple(a.shape[2:])
            if out is None:
                dst = a.new_empty(shape)
            else:
                dst = out[k][n]
                if tuple(dst.shape) != shape or not dst.is_contiguous():
                    raise ValueError(
                        f"regather into {k}.{n}: {tuple(dst.shape)} "
                        f"(contiguous={dst.is_contiguous()}), gathering "
                        f"{shape}")
            for g in range(n_groups):
                torch.index_select(a[g], 0, idx[g].reshape(-1),
                                   out=dst[g].view(-1, *a.shape[2:]))
            grp[n] = dst
        res[k] = grp
    return res if out is None else out


# ---------------------------------------------------------------------------
# Routing (shared by both impls — guarantees identical math)
# ---------------------------------------------------------------------------


def route(router_w, h2d, top_k, renormalize: bool = True):
    """Softmax router with top-k; ties go to the lowest expert index, as
    ``lax.top_k`` breaks them (a stable descending sort). The top-k
    weights are renormalised to sum to 1, unless ``renormalize`` is False
    (DeepSeek-V2's ``norm_topk_prob``): then they are the softmax
    probabilities themselves."""
    logits = (h2d @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]
    if renormalize:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def _renorm(cfg) -> bool:
    return getattr(cfg, "norm_topk_prob", True)


def shared_experts(p, h):
    """The shared experts' output on the normed rows ``h`` (None for a
    layer without them): every token, on its own rank, with no
    dispatch and no placement. Marked ``shared_expert`` in a traced
    capture."""
    if "shared_w1" not in p:
        return None
    ops.phase_mark("shared_expert", h)
    return mlp_apply({k: p["shared_" + k] for k in ("w1", "w3", "w2")}, h)


def _add_out(x, routed, shared):
    """The MoE block's residual: ``x + routed (+ shared)``."""
    y = routed.to(x.dtype)
    if shared is not None:
        y = y + shared.to(x.dtype)
    return x + y


def aux_load_balance_loss(probs, topi, E):
    """Switch-transformer load-balance loss over the rows of probs
    [..., T, E] and topi [..., T, K] (one loss per leading index)."""
    onehot = F.one_hot(topi, E).float().sum(-2)  # [..., T, E]
    frac = onehot.mean(-2)
    mean_prob = probs.mean(-2)
    return E * torch.sum(frac * mean_prob, dim=-1)


def grouped_ffn(x, w1, w3, w2, fill, max_fill: int):
    """Batched expert FFN over the filled rows: x [S, C, D] x weights
    [S, D, F] -> [S, C, D]; rows at or past ``fill[s]`` come out zero."""
    return ops.moe_gmm(x, w1, w3, w2, fill, max_fill)


# ---------------------------------------------------------------------------
# Dense reference
# ---------------------------------------------------------------------------


def moe_apply_dense(p, cfg, x, *, norm_eps: float = 1e-5):
    """x: [B, T, D]. Returns (out, stats)."""
    B, T, D = x.shape
    h = rms_norm(x, p["norm"], norm_eps).reshape(B * T, D)
    probs, topv, topi = route(p["router"], h, cfg.top_k, _renorm(cfg))
    a = torch.einsum("td,edf->tef", h, p["w1"])
    b = torch.einsum("td,edf->tef", h, p["w3"])
    y_all = torch.einsum("tef,efd->ted", F.silu(a) * b, p["w2"])
    sel = torch.take_along_dim(y_all, topi[..., None], dim=1)  # [T, K, D]
    y = torch.einsum("tkd,tk->td", sel, topv.to(y_all.dtype))
    counts = F.one_hot(topi, cfg.num_experts).float().sum((0, 1))
    stats = {"counts": counts,
             "counts_per_rank": counts[None],
             "aux_loss": aux_load_balance_loss(probs, topi, cfg.num_experts),
             "local_frac": torch.ones((), dtype=torch.float32,
                                     device=x.device)}
    return _add_out(x, y.reshape(B, T, D),
                    shared_experts(p, h.reshape(B, T, D))), stats




# ---------------------------------------------------------------------------
# Expert-parallel implementation over the virtual devices of a mesh
# ---------------------------------------------------------------------------

_KINDS = ("all-gather", "all-reduce", "all-to-all")
_collectives = {k: {"bytes": 0, "count": 0} for k in _KINDS}


def collective_counts() -> dict:
    """The collectives run in this process so far, in the reference's form:
    ``{"all-to-all": {"bytes": b, "count": n}, ..., "total_bytes": b}``
    (a caller takes the difference across the work it counts)."""
    out = {k: dict(v) for k, v in _collectives.items()}
    out["total_bytes"] = sum(v["bytes"] for v in _collectives.values())
    return out


def _counted(kind: str, t, times: int = 1):
    """Count one ``kind`` collective whose result is ``t``; returns ``t``."""
    _collectives[kind]["bytes"] += times * t.numel() * t.element_size()
    _collectives[kind]["count"] += 1
    return t


class _AllToAll(torch.autograd.Function):
    """``lax.all_to_all`` over the ranks of every group: [G, src, dst, ...]
    -> [G, dst, src, ...]. Its backward is the exchange the other way."""

    @staticmethod
    def forward(ctx, x):
        return _counted("all-to-all", x.transpose(1, 2).contiguous())

    @staticmethod
    def backward(ctx, g):
        return _counted("all-to-all", g.transpose(1, 2).contiguous())


def _bucket(keys, n_buckets: int, capacity: int):
    """Sort-based capacity bucketing along the last dim (each leading index
    on its own). keys: [..., N] int in [0, n_buckets] (== n_buckets means
    invalid). Returns (order, pos-in-bucket, keep), all aligned with sorted
    order."""
    order = torch.argsort(keys, dim=-1, stable=True)
    sk = keys.gather(-1, order)
    buckets = torch.arange(n_buckets, device=keys.device, dtype=sk.dtype)
    starts = torch.searchsorted(
        sk, buckets.expand(sk.shape[:-1] + (n_buckets,)).contiguous())
    pos = (torch.arange(keys.shape[-1], device=keys.device)
           - starts.gather(-1, sk.clamp(0, n_buckets - 1)))
    keep = (sk < n_buckets) & (pos < capacity)
    return order, pos, keep


def _rows_at(x, idx):
    """``x [..., N, *feat]`` rows at ``idx [..., M]`` (same leading dims):
    ``[..., M, *feat]``."""
    lead = idx.dim() - 1
    feat = x.shape[lead + 1:]
    return x.gather(lead, idx.reshape(idx.shape + (1,) * len(feat)).expand(
        idx.shape + feat))


def _flat_index(idx, n_rows: int):
    """Row indices ``idx [..., M]`` into per-index buffers of ``n_rows``
    rows, as indices into all of them laid end to end."""
    lead = idx.shape[:-1]
    base = torch.arange(math.prod(lead), device=idx.device).reshape(
        lead + (1,)) * n_rows
    return (idx + base).reshape(-1)


def _scatter_rows(n_rows: int, dest, src, fill=0):
    """Per leading index, ``full([n_rows, ...], fill).at[dest].set(src,
    mode="drop")`` with ``dest == n_rows`` meaning drop: written into one
    extra trash row, then sliced off. dest [..., M]; src [..., M, *feat]."""
    lead = dest.shape[:-1]
    feat = src.shape[dest.dim():]
    buf = src.new_full((math.prod(lead) * (n_rows + 1),) + feat, fill)
    buf[_flat_index(dest, n_rows + 1)] = src.reshape((-1,) + feat)
    return buf.view((math.prod(lead), n_rows + 1) + feat)[:, :n_rows].reshape(
        lead + (n_rows,) + feat)


def _add_rows(n_rows: int, idx, src):
    """Per leading index, ``zeros([n_rows, D]).at[idx].add(src)``.
    idx [..., M]; src [..., M, D]."""
    lead = idx.shape[:-1]
    D = src.shape[-1]
    out = src.new_zeros((math.prod(lead) * n_rows, D))
    out.index_add_(0, _flat_index(idx, n_rows), src.reshape(-1, D))
    return out.view(lead + (n_rows, D))


def _slot_fill(slot_key, keep, S: int):
    """[..., S] int32 rows kept per slot: ``keep`` counted at its
    ``slot_key`` (key ``S``, the unrouted rows, goes to a trailing bin that
    is dropped). A fixed-shape count: ``bincount(slot_key[keep])`` would
    sync the host."""
    fill = torch.zeros(slot_key.shape[:-1] + (S + 1,), dtype=torch.int32,
                       device=slot_key.device)
    return fill.scatter_add_(-1, slot_key, keep.to(torch.int32))[..., :S]


def _slot_ffn(p, xs, slot_key, dest2, S: int, C2: int, max_rows: int):
    """The expert FFN of every group and rank in one ``moe_gmm`` call.
    xs [G, n_ep, M, D]: each device's rows in sorted slot order;
    slot_key [G, n_ep, M]: their sorted slot keys (``S`` = unrouted);
    dest2: each row's destination in its device's ``[S * C2]`` slot buffer
    (``S * C2`` = dropped; ``C2`` the slot capacity in force). Rank ``r``'s
    slot ``s`` holds, one group after another, every group's kept rows for
    it (group ``g``'s from the sum of the earlier groups' fills on), so
    slot ``r * S + s`` of the call has ``G * C2`` rows and the weights are
    read once for all groups. One trailing trash row takes the drops; rows
    past a slot's fill are left unwritten (``moe_gmm`` never reads them, and returns zeros there).
    ``max_rows``: the rows routed in all, a bound on any slot's fill.
    Returns the FFN output at each row of ``xs`` ([G, n_ep, M, D]; a
    dropped row reads a row it does not own, which the caller masks)."""
    G, n, M, D = xs.shape
    kept = dest2 < S * C2
    fill = _slot_fill(slot_key, kept, S)  # [G, n, S]
    cap = G * C2
    slot = torch.where(kept, dest2 // C2, 0)
    row = dest2 - slot * C2
    if G > 1:  # groups before g fill the slot first
        off = (fill.cumsum(0) - fill).gather(-1, slot)
        row = row + off
        fill = fill.sum(0, dtype=torch.int32)
    else:
        fill = fill[0]
    rank = torch.arange(n, device=xs.device)[:, None]
    idx = torch.where(kept, (rank * S + slot) * cap + row, n * S * cap)
    buf = xs.new_empty((n * S * cap + 1, D))
    buf[idx.reshape(-1)] = xs.reshape(-1, D)
    w1, w3, w2 = (p[k].reshape((n * S,) + tuple(p[k].shape[2:]))
                  for k in ("w1", "w3", "w2"))
    y = grouped_ffn(buf[:n * S * cap].view(n * S, cap, D), w1, w3, w2,
                    fill.reshape(-1), min(cap, max_rows))
    return y.view(n * S * cap, D)[idx.clamp(max=n * S * cap - 1)]


def _mean_rows(x):
    """Mean over the last dim as XLA computes it (sum times the fp32
    reciprocal of the count), so the routing statistics match the
    reference bit for bit. The reciprocal is a Python float: an fp32 tensor
    times a Python scalar multiplies in fp32 by the scalar rounded to fp32,
    with no host tensor copied to the device (which a CUDA graph could not
    capture)."""
    return x.sum(-1) * (1.0 / x.shape[-1])


def _pmean(vals):
    """``lax.pmean`` over every device: the per-device values [G, n_ep]
    summed in device order, times 1/count."""
    flat = vals.reshape(-1)
    total = flat[0]
    for i in range(1, flat.shape[0]):
        total = total + flat[i]
    return _counted("all-reduce", total * (1.0 / flat.shape[0]), 2)


def _count_by_origin(counts, org, hot) -> None:
    """``counts[org[i]] += hot[i]`` into an ``[n_ep + 1, E]`` table whose
    last row takes the rows with an origin outside ``0..n_ep-1``; the
    caller slices it off. (A boolean index dropping them would sync the
    host.)"""
    n_ep = counts.shape[0] - 1
    ok = (org >= 0) & (org < n_ep)
    counts.index_add_(0, torch.where(ok, org, n_ep), hot)


def _ep_dispatch(rows, mask, origin, p, placement, cfg, spec: EPSpec,
                 caps: tuple):
    """Dispatch mode on every device. rows [G, n_ep, R, D]: device (g, r)
    holds rows[g, r] (group g, EP rank r); mask [G, n_ep, R] excludes rows
    from the gating counts; origin [G, n_ep, R] or None (then each row
    originates at its device's EP rank); caps: the (send, slot)
    capacities in force (``ep_call_capacities``). Returns (out [G, n_ep,
    R, D], counts [n_ep, E], local, aux)."""
    E, K = cfg.num_experts, cfg.top_k
    n, S, (C, C2) = spec.n_ep, spec.slots, caps
    G, _, R, D = rows.shape
    dev = rows.device
    my = torch.arange(n, device=dev)[:, None]  # [n, 1]
    e2t, e2s = placement.expert_to_target, placement.expert_to_slot
    probs, topv, topi = route(p["router"], rows, K, _renorm(cfg))
    flat_e = topi.reshape(G, n, R * K)
    flat_w = topv.reshape(G, n, R * K)
    flat_src = torch.arange(R, device=dev).repeat_interleave(K)  # [RK]
    tgt = e2t[my, flat_e]  # [G, n, RK]
    order, pos, keep = _bucket(tgt, n, C)
    dest = torch.where(keep, tgt.gather(-1, order) * C + pos, n * C)
    src = flat_src[order]  # each sorted pair's row on its device
    send_x = _scatter_rows(n * C, dest, _rows_at(rows, src))
    send_e = _scatter_rows(n * C, dest, flat_e.gather(-1, order), fill=-1)
    # all_to_all in each group: recv[g][dst][src] = send[g][src][dst]
    recv_x = _AllToAll.apply(send_x.reshape(G, n, n, C, D)).reshape(
        G, n, n * C, D)
    recv_e = _AllToAll.apply(send_e.reshape(G, n, n, C)).reshape(G, n, n * C)

    # receiver: slot bucketing + one grouped FFN over every device's slots
    slot = torch.where(recv_e >= 0, e2s[my, recv_e.clamp(min=0)], -1)
    slot_key = torch.where(slot >= 0, slot, S)
    order2, pos2, keep2 = _bucket(slot_key, S, C2)
    sk2 = slot_key.gather(-1, order2)
    dest2 = torch.where(keep2, sk2 * C2 + pos2, S * C2)
    y = _slot_ffn(p, _rows_at(recv_x, order2), sk2, dest2, S, C2,
                  max_rows=G * n * R)
    got = torch.where(keep2[..., None], y, 0).to(rows.dtype)
    # back into receive-buffer order (order2 is a permutation)
    out_tok = _scatter_rows(n * C, order2, got)
    back = _AllToAll.apply(out_tok.reshape(G, n, n, C, D)).reshape(
        G, n, n * C, D)
    contrib = torch.where(keep[..., None],
                          _rows_at(back, dest.clamp(0, n * C - 1)), 0)
    contrib = contrib * flat_w.gather(-1, order)[..., None].to(rows.dtype)
    out = _add_rows(R, src, contrib)

    # stats: f_n(e) per originating server (or the device's EP rank),
    # summed over every device
    hot = F.one_hot(topi, E).float() * mask[..., None, None]
    org = origin if origin is not None else my.expand(G, n, R)
    counts = torch.zeros((n + 1, E), dtype=torch.float32, device=dev)
    _count_by_origin(counts, org.reshape(-1), hot.sum(-2).reshape(-1, E))
    local = _mean_rows((tgt == my).float())  # [G, n]
    aux = aux_load_balance_loss(probs, topi, E)  # [G, n]
    return (_counted("all-gather", out), _counted("all-reduce", counts[:n], 2),
            _pmean(local), _pmean(aux))


def _ep_gather(h_all, m_all, p, placement, cfg, spec: EPSpec, R: int,
               slot_cap: int, o_all=None):
    """Decode gather mode. h_all [G, Btok, D]: the rows every rank of group
    g sees (its devices' rows gathered over the gather axes); each rank
    computes the (token, expert) pairs routed to it and the rank outputs
    are summed. m_all [G, Btok] row validity; o_all: optional [G, Btok]
    originating EP rank per row; without it the rows of each of the
    ``Btok // R`` gathered blocks of ``R`` rows originate at the first EP
    rank of their block's span, as in the reference. slot_cap: the slot
    capacity in force (``ep_call_capacities``). Returns (out_all [G, Btok,
    D], counts [n_ep, E], local, aux)."""
    E, K = cfg.num_experts, cfg.top_k
    n, S, C2 = spec.n_ep, spec.slots, slot_cap
    G, Btok, D = h_all.shape
    dev = h_all.device
    my = torch.arange(n, device=dev)[:, None]  # [n, 1]
    probs, topv, topi = route(p["router"], h_all, K, _renorm(cfg))
    if o_all is not None:
        src_ep = o_all
    else:
        span = max(n // max(Btok // R, 1), 1)
        src_ep = (torch.arange(Btok, device=dev) // R * span).expand(G, Btok)
    flat_e = topi.reshape(G, 1, Btok * K)
    flat_src = torch.arange(Btok, device=dev).repeat_interleave(K)
    src_of = src_ep[:, flat_src]  # [G, BK]
    tgt = placement.expert_to_target[src_of[:, None], flat_e]  # [G, 1, BK]
    slot = torch.where(tgt == my, placement.expert_to_slot[my, flat_e], -1)
    slot_key = torch.where(slot >= 0, slot, S)  # [G, n, BK]
    order2, pos2, keep2 = _bucket(slot_key, S, C2)
    sk2 = slot_key.gather(-1, order2)
    dest2 = torch.where(keep2, sk2 * C2 + pos2, S * C2)
    src = flat_src[order2]  # [G, n, BK]
    xs = _rows_at(h_all[:, None].expand(G, n, Btok, D), src)
    y = _slot_ffn(p, xs, sk2, dest2, S, C2, max_rows=G * Btok)
    yw = torch.where(keep2[..., None], y, 0).to(h_all.dtype)
    w = topv.reshape(G, 1, Btok * K).expand(G, n, Btok * K).gather(-1, order2)
    part = _add_rows(Btok, src, yw * w[..., None].to(h_all.dtype))
    out_all = part[:, 0]
    for r in range(1, n):  # psum over the EP axes, in rank order
        out_all = out_all + part[:, r]
    _counted("all-reduce", out_all, 2)

    valid = m_all[:, flat_src].float()  # [G, BK]
    counts = torch.zeros((n + 1, E), dtype=torch.float32, device=dev)
    _count_by_origin(counts, src_of.reshape(-1),
                     (F.one_hot(flat_e[:, 0], E).float()
                      * valid[..., None]).reshape(-1, E))
    local = (torch.sum((tgt[:, 0] == src_of).float() * valid, -1)
             / torch.clamp(torch.sum(valid, -1), min=1.0))  # [G]
    aux = aux_load_balance_loss(probs, topi, E)  # [G]
    # every rank of a group holds its group's values: pmean over devices
    return (out_all, counts[:n], _pmean(local[:, None].expand(G, n)),
            _pmean(aux[:, None].expand(G, n)))


def _arrange(t, have: tuple, want: tuple, mesh):
    """Re-index per-device blocks: ``t``'s leading dims are the mesh axes
    ``have`` (full size each); the result's are ``want``. An axis of
    ``want`` missing from ``have`` is broadcast (its devices hold the same
    block); an axis of ``have`` missing from ``want`` is taken at index 0
    (the caller knows its blocks are equal)."""
    idx = tuple(slice(None) if a in want else 0 for a in have)
    t = t[idx]
    have = [a for a in have if a in want]
    for a in want:
        if a not in have:
            t = t.unsqueeze(0)
            have.insert(0, a)
    k = len(want)
    t = t.permute([have.index(a) for a in want] + list(range(k, t.dim())))
    return t.expand(tuple(mesh.shape[a] for a in want) + tuple(t.shape[k:]))


def _ep_mesh(spec: EPSpec) -> VirtualMesh:
    """The mesh an EP spec stands for when no mesh is given: every axis 1
    but the last EP axis, which holds the ``n_ep`` ranks (``(1, n_ep)``)."""
    sizes = [spec.n_ep if a == spec.axes[-1] else 1 for a in spec.mesh_axes]
    return VirtualMesh(tuple(spec.mesh_axes), tuple(sizes))


def _row_layout(spec: EPSpec, mesh: VirtualMesh, B: int, T: int, mode: str,
                seq_sharded_out: bool):
    """How ``moe_apply_ep`` lays the rows of x [B, T, D] over ``mesh``:
    ``(branch, row_axes, rows)``. ``branch`` is ``"seq"`` (each device
    routes its [B-shard, T-shard] block), ``"gather"`` (decode: each rank
    of a group sees the group's rows gathered over the gather axes) or
    ``"dispatch"`` (the rows padded to the mesh size, split over the
    devices); ``row_axes`` the batch axes the rows shard over; ``rows``
    the rows each device routes (``"gather"``: each rank sees)."""
    sizes = mesh.shape
    n_batch = math.prod(sizes[a] for a in spec.batch_axes)
    rows_shardable = (B * T) % n_batch == 0 and B * T >= n_batch
    row_axes = spec.batch_axes if rows_shardable else ()
    nb = math.prod(sizes[a] for a in row_axes)
    if mode == "decode":
        gathered = math.prod(sizes[a] for a in spec.axes if a in row_axes)
        return "gather", row_axes, (B * T) // nb * gathered
    if seq_sharded_out and T % sizes.get("model", 1) == 0:
        if B % nb:
            raise ValueError(f"batch {B} does not split over {row_axes}")
        return "seq", row_axes, B // nb * (T // sizes["model"])
    return "dispatch", row_axes, -(-(B * T) // mesh.size)


def ep_call_capacities(spec: EPSpec, top_k: int, B: int, T: int, mode: str,
                       mesh=None, seq_sharded_out: bool = False):
    """The capacities in force at a ``moe_apply_ep`` call on x [B, T, D]
    (same ``mode``, ``mesh`` and ``seq_sharded_out``): ``(send rows, slot
    rows)``, each the spec's or the bound that the call's static shape
    proves no bucket reaches, whichever is smaller. A device routing R rows
    makes R * top_k (token, expert) pairs, so no send bucket holds more; a
    slot holds one expert, which a token picks at most once, so a slot
    takes at most one row per token that reaches it: ``n_ep * R`` in
    dispatch, the ``Btok`` rows a rank sees in the decode gather (which
    sends nothing: send rows 0). Sizing by them keeps, drops and counts
    the same rows as sizing by the spec."""
    mesh = mesh if mesh is not None else _ep_mesh(spec)
    branch, _, rows = _row_layout(spec, mesh, B, T, mode, seq_sharded_out)
    if branch == "gather":
        return 0, min(spec.slot_capacity, rows)
    return (min(spec.capacity, rows * top_k),
            min(spec.slot_capacity, spec.n_ep * rows))


def moe_apply_ep(p, cfg, x, *, spec: EPSpec, placement: EPPlacement,
                 mode: str, mesh=None, norm_eps: float = 1e-5,
                 seq_sharded_out: bool = False, token_mask=None,
                 origin=None):
    """Placement-aware EP MoE over the virtual devices of ``mesh`` (a
    ``VirtualMesh``; None: a ``(1, n_ep)`` mesh). x: [B, T, D]. Returns
    (out, stats).

    placement: device tables (``placement_to``). token_mask: [B] float
    validity per batch row (decode: vacant continuous-batching slots) or
    [B, T] per token (chunked prefill: prompt padding); 0-entries are
    excluded from the gating statistics. origin: [B] or [B, T] int — the EP
    rank each token's *request* originated at; ``counts_per_rank[r]`` then
    holds the gating counts of traffic that arrived at server ``r``.
    Without it attribution falls back to the physical rank (the row's EP
    rank in dispatch mode, its batch block's first rank in decode mode).
    ``seq_sharded_out`` (a sequence-parallel residual, outside decode):
    each device owns a ``[B-shard, T-shard]`` block of x, which it routes
    on its own; that branch ignores ``token_mask`` and ``origin``, as the
    reference's does."""
    B, T, D = x.shape
    h = rms_norm(x, p["norm"], norm_eps)
    mesh = mesh if mesh is not None else _ep_mesh(spec)
    if tuple(mesh.axis_names) != tuple(spec.mesh_axes) or spec.n_ep != \
            math.prod(mesh.shape[a] for a in spec.axes):
        raise ValueError(f"EP spec over {spec.axes} of {spec.mesh_axes} "
                         f"(n_ep {spec.n_ep}) does not fit mesh {mesh}")
    sizes = mesh.shape
    G, n = mesh.size // spec.n_ep, spec.n_ep
    group_axes = tuple(a for a in mesh.axis_names if a not in spec.axes)
    dev_axes = group_axes + tuple(spec.axes)  # devices, group-major
    branch, row_axes, _ = _row_layout(spec, mesh, B, T, mode, seq_sharded_out)
    caps = ep_call_capacities(spec, cfg.top_k, B, T, mode, mesh,
                              seq_sharded_out)
    use_origin = origin is not None

    if branch == "seq":
        # sequence-parallel residual: device blocks [B/(row axes), T/model]
        nb, nm = math.prod(sizes[a] for a in row_axes), sizes["model"]
        b_, t_ = B // nb, T // nm
        have = row_axes + ("model",)
        blocks = h.reshape(tuple(sizes[a] for a in row_axes)
                           + (b_, nm, t_, D))
        k = len(row_axes)
        blocks = blocks.permute(list(range(k)) + [k + 1, k, k + 2, k + 3])
        rows = _arrange(blocks, have, dev_axes, mesh).reshape(
            G, n, b_ * t_, D)
        out, counts, local, aux = _ep_dispatch(
            rows, rows.new_ones((G, n, b_ * t_), dtype=torch.float32), None,
            p, placement, cfg, spec, caps)
        out = _arrange(out.reshape(
            tuple(sizes[a] for a in dev_axes) + (b_, t_, D)), dev_axes, have,
            mesh)
        out = out.permute(list(range(k)) + [k + 1, k, k + 2, k + 3]).reshape(
            B, T, D)
        stats = {"counts": counts.sum(0), "counts_per_rank": counts,
                 "aux_loss": aux, "local_frac": local}
        return _add_out(x, out, shared_experts(p, h)), stats

    # rows over the dispatch row axes (group-major: every device's rows,
    # padded with masked zero rows to the mesh size), or in decode over
    # the batch axes when they divide them
    n_shards = (mesh.size if branch == "dispatch"
                else math.prod(sizes[a] for a in row_axes))
    pad = (-(B * T)) % n_shards
    rows = h.reshape(B * T, D)
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, D))])

    def to_rows(v, dtype, pad_value=0):
        vv = torch.as_tensor(v, device=x.device).to(dtype)
        vv = vv if vv.dim() == 2 else vv[:, None].expand(B, T)
        vv = vv.reshape(B * T)
        if pad:
            vv = torch.cat([vv, torch.full((pad,), pad_value, dtype=dtype,
                                           device=x.device)])
        return vv

    mask_rows = to_rows(token_mask if token_mask is not None
                        else x.new_ones((B, T)), torch.float32)
    origin_rows = to_rows(origin, torch.int64) if use_origin else None
    if branch == "gather":
        gather_axes = tuple(a for a in spec.axes if a in row_axes)
        R = (B * T) // n_shards
        want = group_axes + gather_axes

        def visible(v):
            """Each group's rows: its devices' blocks gathered over the
            gather axes ([G, Btok, ...])."""
            v = v.reshape(tuple(sizes[a] for a in row_axes) + (R,)
                          + tuple(v.shape[1:]))
            v = _arrange(v, row_axes, want, mesh)
            return v.reshape((G, -1) + tuple(v.shape[len(want) + 1:]))

        h_all, m_all = visible(rows), visible(mask_rows)
        o_all = visible(origin_rows) if use_origin else None
        if math.prod(sizes[a] for a in gather_axes) > 1:
            for v in (h_all, m_all) + ((o_all,) if use_origin else ()):
                _counted("all-gather", v)
        out_all, counts, local, aux = _ep_gather(
            h_all, m_all, p, placement, cfg, spec, R, caps[1], o_all=o_all)
        out = _arrange(out_all.reshape(tuple(sizes[a] for a in want)
                                       + (R, D)), want, row_axes, mesh)
        out_rows = out.reshape(B * T, D)
    else:
        R = rows.shape[0] // mesh.size
        out, counts, local, aux = _ep_dispatch(
            rows.reshape(G, n, R, D), mask_rows.reshape(G, n, R), (
                origin_rows.reshape(G, n, R) if use_origin else None),
            p, placement, cfg, spec, caps)
        out_rows = out.reshape(-1, D)
    out = out_rows[:B * T].reshape(B, T, D)
    stats = {"counts": counts.sum(0), "counts_per_rank": counts,
             "aux_loss": aux, "local_frac": local}
    return _add_out(x, out, shared_experts(p, h)), stats
