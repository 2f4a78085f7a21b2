"""Placement-aware Mixture-of-Experts layer (PyTorch port of
``repro.models.moe``).

Two implementations with identical math:

* ``dense`` — reference oracle: every expert computed for every token,
  combined with the routing weights.
* ``ep`` — expert parallel over *virtual* EP ranks. The reference runs one
  EP rank per device of a ``shard_map`` mesh (one rank = one of the paper's
  edge servers); the port runs every rank in one process, with a leading
  rank axis on the tensors:

  - ``all_to_all`` is a swap of the source and destination rank axes
    (``_AllToAll``: the token exchange, its expert ids and the return);
  - ``psum`` is a sum over the rank axis (``_pmean`` of the local ratio
    and the aux loss, the per-origin counts, the decode gather's output);
  - ``all_gather`` is a concatenation (the ranks' output rows).

  Each of these adds its result's bytes and 1 to ``collective_counts()``
  (all-reduce bytes twice, as the reference's roofline counts its reduce
  and broadcast phases): the counterpart of
  ``repro.launch.roofline.collective_bytes_from_hlo``, which parses them
  out of the compiled HLO; the port has no HLO, so nothing parses it. On
  one card every rank's result lives on the one device, so a count is
  the bytes of all ranks' results, where the reference's is one
  device's. The exchange's backward is the exchange the other way and
  counts too; the backward of the sums and the concatenation does not.

  Capacities, the row -> rank assignment, stable-sort bucketing and
  capacity drops are the reference's, so dropped rows, the per-origin
  ``counts_per_rank [n_ep, E]`` and ``local_frac`` match it exactly.

  Two dispatch modes, as in the reference:
  - ``dispatch`` (prefill / chunk): rows split evenly over the ranks,
    capacity-bounded exchange;
  - ``gather`` (decode): every rank sees every row, computes the (token,
    expert) pairs routed to it, and the rank outputs are summed.

The expert FFN of every rank runs as one ``kernels.ops.moe_gmm`` call over
the ``[n_ep * S]`` slots, with per-slot fill counts, so the kernel only
touches the rows actually routed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class EPSpec:
    """Static expert-parallel geometry."""

    n_ep: int  # number of (virtual) EP ranks
    slots: int  # S: expert slots per rank
    capacity: int  # C: per (src->dst) send capacity
    slot_capacity: int  # C2: per-slot compute capacity (recv side)

    @staticmethod
    def build(n_ep: int, cfg, *, capacity_factor: float = 2.0,
              rows_per_rank: int = 4096, slots: int | None = None,
              capacity: int | None = None, slot_capacity: int | None = None):
        """Same defaults as ``repro.models.moe.EPSpec.build``, with the EP
        rank count given directly instead of read off a mesh."""
        S = slots if slots is not None else (
            -(-cfg.num_experts // n_ep) + (1 if n_ep > 1 else 0))
        C = capacity if capacity is not None else max(
            8, int(np.ceil(rows_per_rank * cfg.top_k / n_ep * capacity_factor)))
        C2 = slot_capacity if slot_capacity is not None else max(
            8, int(np.ceil(n_ep * C / S)))
        return EPSpec(n_ep, S, C, C2)


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


def moe_params_dense(gen, cfg, dtype=torch.float32, device="cuda") -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "router": dense_init(gen, (d, E), 0, dtype, device),
        "w1": dense_init(gen, (E, d, f), 1, dtype, device),
        "w3": dense_init(gen, (E, d, f), 1, dtype, device),
        "w2": dense_init(gen, (E, f, d), 1, dtype, device),
    }


def moe_params_ep(gen, cfg, spec: EPSpec, dtype=torch.float32,
                  device="cuda") -> dict:
    """EP-layout params: expert weights stored per (rank, slot)."""
    d, f = cfg.d_model, cfg.d_ff
    n, S = spec.n_ep, spec.slots
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "router": dense_init(gen, (d, cfg.num_experts), 0, dtype, device),
        "w1": dense_init(gen, (n, S, d, f), 2, dtype, device),
        "w3": dense_init(gen, (n, S, d, f), 2, dtype, device),
        "w2": dense_init(gen, (n, S, f, d), 2, dtype, device),
    }


def _slot_index(placement: EPPlacement, device) -> torch.Tensor:
    s2e = placement.slot_to_expert
    s2e = s2e if torch.is_tensor(s2e) else torch.as_tensor(np.array(s2e))
    return s2e.to(device=device, dtype=torch.int64).clamp(min=0)


def dense_to_ep(dense_p: dict, placement: EPPlacement) -> dict:
    """Materialise EP-layout weights from dense weights + a placement
    (also the migration primitive: a new placement is just a new gather)."""
    s2e = _slot_index(placement, dense_p["w1"].device)
    out = {k: dense_p[k] for k in ("norm", "router")}
    for k in ("w1", "w3", "w2"):
        out[k] = dense_p[k][s2e]  # [n_ep, S, ...]
    return out


def regather_ep_groups(dense_groups: dict, placement_stacked,
                       n_groups: int, out: dict | None = None) -> dict:
    """Apply ``dense_to_ep`` per layer group: dense master group params
    (stacked [G, E, ...]) + stacked placement tables -> EP-layout groups,
    gathered straight into one stacked tensor per weight (no per-group
    copies to stack). Non-MoE groups pass through unchanged.

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
        grp = {n: v[n] for n in ("norm", "router")}
        for n in ("w1", "w3", "w2"):
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


def route(router_w, h2d, top_k):
    """Softmax router with top-k; ties go to the lowest expert index, as
    ``lax.top_k`` breaks them (a stable descending sort)."""
    logits = (h2d @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def aux_load_balance_loss(probs, topi, E):
    """Switch-transformer load-balance loss."""
    onehot = F.one_hot(topi, E).float().sum(-2)  # [T, E]
    frac = onehot.mean(0)
    mean_prob = probs.mean(0)
    return E * torch.sum(frac * mean_prob)


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
    probs, topv, topi = route(p["router"], h, cfg.top_k)
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
    return x + y.reshape(B, T, D).to(x.dtype), stats


# ---------------------------------------------------------------------------
# Expert-parallel implementation over virtual ranks
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
    """``lax.all_to_all`` over the virtual ranks: [src, dst, ...] ->
    [dst, src, ...]. Its backward is the exchange the other way."""

    @staticmethod
    def forward(ctx, x):
        return _counted("all-to-all", x.transpose(0, 1).contiguous())

    @staticmethod
    def backward(ctx, g):
        return _counted("all-to-all", g.transpose(0, 1).contiguous())



def _bucket(keys, n_buckets: int, capacity: int):
    """Sort-based capacity bucketing. keys: [N] int in [0, n_buckets]
    (== n_buckets means invalid). Returns (order, pos-in-bucket, keep),
    all aligned with sorted order."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    starts = torch.searchsorted(
        sk, torch.arange(n_buckets, device=keys.device, dtype=sk.dtype))
    pos = (torch.arange(keys.shape[0], device=keys.device)
           - starts[sk.clamp(0, n_buckets - 1)])
    keep = (sk < n_buckets) & (pos < capacity)
    return order, pos, keep


def _scatter_rows(n_rows: int, dest, src, fill=0):
    """``full([n_rows, ...], fill).at[dest].set(src, mode="drop")`` with
    ``dest == n_rows`` meaning drop: written into one extra trash row, then
    sliced off."""
    buf = src.new_full((n_rows + 1,) + tuple(src.shape[1:]), fill)
    buf[dest] = src
    return buf[:n_rows]


def _slot_fill(slot_key, keep, S: int):
    """[S] int32 rows kept per slot: ``keep`` counted at its ``slot_key``
    (key ``S``, the unrouted rows, goes to a trailing bin that is dropped).
    A fixed-shape count: ``bincount(slot_key[keep])`` would sync the
    host."""
    fill = torch.zeros((S + 1,), dtype=torch.int32, device=slot_key.device)
    return fill.scatter_add_(0, slot_key, keep.to(torch.int32))[:S]


def _slot_ffn(p, h, per_rank, spec: EPSpec, max_fill: int):
    """The expert FFN of every rank in one ``moe_gmm`` call. ``per_rank``
    holds, for each rank, ``(slot_key, keep, dest2, src)``: its sorted slot
    keys and keep mask (``_bucket`` output), each sorted row's destination
    in the rank's ``[S * C2]`` slot buffer (``S * C2`` = dropped) and the
    rows themselves. All ranks' slot buffers share one ``[n_ep * S, C2, D]``
    tensor (one trailing trash row takes the drops). Rows past a slot's fill
    are left unwritten: ``moe_gmm`` never reads them and returns zeros
    there. Returns the FFN output as per-rank ``[S * C2, D]`` views."""
    n_ep, S, C2 = spec.n_ep, spec.slots, spec.slot_capacity
    D = h.shape[-1]
    n = n_ep * S * C2
    buf = h.new_empty((n + 1, D))
    fills = []
    for my, (slot_key, keep, dest2, src) in enumerate(per_rank):
        buf[torch.where(dest2 < S * C2, dest2 + my * S * C2, n)] = src
        fills.append(_slot_fill(slot_key, keep, S))
    fill = torch.cat(fills)
    w1, w3, w2 = (p[k].reshape((n_ep * S,) + tuple(p[k].shape[2:]))
                  for k in ("w1", "w3", "w2"))
    y = grouped_ffn(buf[:n].view(n_ep * S, C2, D), w1, w3, w2, fill,
                    min(C2, max_fill))
    return list(y.view(n_ep, S * C2, D))


def _mean(x):
    """Mean as XLA computes it (sum times the fp32 reciprocal of the count),
    so the routing statistics match the reference bit for bit. The
    reciprocal is a Python float: an fp32 tensor times a Python scalar
    multiplies in fp32 by the scalar rounded to fp32, with no host tensor
    copied to the device (which a CUDA graph could not capture)."""
    return x.sum() * (1.0 / x.numel())


def _pmean(vals):
    """``lax.pmean`` over the rank axis: sum in rank order, times 1/n."""
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    return _counted("all-reduce", total * (1.0 / len(vals)), 2)


def _count_by_origin(counts, org, hot) -> None:
    """``counts[org[i]] += hot[i]`` into an ``[n_ep + 1, E]`` table whose
    last row takes the rows with an origin outside ``0..n_ep-1``; the
    caller slices it off. (A boolean index dropping them would sync the
    host.)"""
    n_ep = counts.shape[0] - 1
    ok = (org >= 0) & (org < n_ep)
    counts.index_add_(0, torch.where(ok, org, n_ep), hot)


def _ep_dispatch(rows, mask_rows, origin_rows, p, placement, cfg,
                 spec: EPSpec, use_origin: bool):
    """Dispatch mode over all ranks. rows: [n_ep * R, D] (rank r holds rows
    r*R .. (r+1)*R-1, as the reference's row sharding gives them);
    mask_rows/origin_rows: [n_ep * R]. Returns (out_rows, counts, local,
    aux)."""
    E, K = cfg.num_experts, cfg.top_k
    n_ep, S, C, C2 = spec.n_ep, spec.slots, spec.capacity, spec.slot_capacity
    N, D = rows.shape
    R = N // n_ep
    dev = rows.device
    e2t, e2s = placement.expert_to_target, placement.expert_to_slot
    send_x, send_e, sender = [], [], []
    counts = torch.zeros((n_ep + 1, E), dtype=torch.float32, device=dev)
    locals_, auxes = [], []
    for my in range(n_ep):
        h_loc = rows[my * R:(my + 1) * R]
        probs, topv, topi = route(p["router"], h_loc, K)
        flat_e = topi.reshape(R * K)
        flat_w = topv.reshape(R * K)
        flat_src = torch.arange(R, device=dev).repeat_interleave(K)
        tgt = e2t[my, flat_e]  # [RK]
        order, pos, keep = _bucket(tgt, n_ep, C)
        dest = torch.where(keep, tgt[order] * C + pos, n_ep * C)  # OOB = drop
        send_x.append(_scatter_rows(n_ep * C, dest, h_loc[flat_src[order]]))
        send_e.append(_scatter_rows(n_ep * C, dest, flat_e[order], fill=-1))
        sender.append((order, keep, dest, flat_w, flat_src))
        # stats: f_n(e) per originating server (or the physical rank)
        hot = F.one_hot(topi, E).float() * mask_rows[my * R:(my + 1) * R,
                                                     None, None]
        org = (origin_rows[my * R:(my + 1) * R] if use_origin
               else torch.full((R,), my, dtype=torch.int64, device=dev))
        _count_by_origin(counts, org, hot.sum(1))
        locals_.append(_mean((tgt == my).float()))
        auxes.append(aux_load_balance_loss(probs, topi, E))
    # all_to_all: recv[dst][src] = send[src][dst]
    sx = torch.stack(send_x).reshape(n_ep, n_ep, C, D)
    se = torch.stack(send_e).reshape(n_ep, n_ep, C)
    recv_x = _AllToAll.apply(sx).reshape(n_ep, n_ep * C, D)
    recv_e = _AllToAll.apply(se).reshape(n_ep, n_ep * C)

    # receiver: slot bucketing + one grouped FFN over every rank's slots
    per_rank, recv = [], []
    for my in range(n_ep):
        es = recv_e[my]
        slot = torch.where(es >= 0, e2s[my, es.clamp(min=0)], -1)
        slot_key = torch.where(slot >= 0, slot, S)
        order2, pos2, keep2 = _bucket(slot_key, S, C2)
        dest2 = torch.where(keep2, slot_key[order2] * C2 + pos2, S * C2)
        per_rank.append((slot_key[order2], keep2, dest2, recv_x[my][order2]))
        recv.append((order2, keep2, dest2))
    ys = _slot_ffn(p, rows, per_rank, spec, max_fill=N)
    out_tok = []
    for my in range(n_ep):
        order2, keep2, dest2 = recv[my]
        got = torch.where(keep2[:, None],
                          ys[my][dest2.clamp(0, S * C2 - 1)], 0).to(rows.dtype)
        buf = rows.new_zeros((n_ep * C, D))
        buf[order2] = got
        out_tok.append(buf)
    ot = torch.stack(out_tok).reshape(n_ep, n_ep, C, D)
    back = _AllToAll.apply(ot).reshape(n_ep, n_ep * C, D)

    outs = []
    for my in range(n_ep):
        order, keep, dest, flat_w, flat_src = sender[my]
        contrib = torch.where(keep[:, None],
                              back[my][dest.clamp(0, n_ep * C - 1)], 0)
        contrib = contrib * flat_w[order][:, None].to(rows.dtype)
        out = rows.new_zeros((R, D))
        out.index_add_(0, flat_src[order], contrib)
        outs.append(out)
    return (_counted("all-gather", torch.cat(outs)),
            _counted("all-reduce", counts[:n_ep], 2), _pmean(locals_),
            _pmean(auxes))


def _ep_gather(h_all, m_all, p, placement, cfg, spec: EPSpec, o_all=None):
    """Decode gather mode over all ranks: every rank sees all ``Btok`` rows,
    computes the (token, expert) pairs routed to it, and the rank outputs
    are summed (the reference's psum). o_all: optional [Btok] originating
    EP rank per row; without it every row originates at rank 0."""
    E, K = cfg.num_experts, cfg.top_k
    n_ep, S, C2 = spec.n_ep, spec.slots, spec.slot_capacity
    Btok, D = h_all.shape
    dev = h_all.device
    probs, topv, topi = route(p["router"], h_all, K)
    src_ep = (o_all if o_all is not None
              else torch.zeros((Btok,), dtype=torch.int64, device=dev))
    flat_e = topi.reshape(-1)
    flat_src = torch.arange(Btok, device=dev).repeat_interleave(K)
    tgt = placement.expert_to_target[src_ep[flat_src], flat_e]
    per_rank, recv = [], []
    for my in range(n_ep):
        slot = torch.where(tgt == my, placement.expert_to_slot[my, flat_e], -1)
        slot_key = torch.where(slot >= 0, slot, S)
        order2, pos2, keep2 = _bucket(slot_key, S, C2)
        dest2 = torch.where(keep2, slot_key[order2] * C2 + pos2, S * C2)
        per_rank.append((slot_key[order2], keep2, dest2,
                         h_all[flat_src[order2]]))
        recv.append((order2, keep2, dest2))
    ys = _slot_ffn(p, h_all, per_rank, spec, max_fill=Btok)
    out_all = None
    for my in range(n_ep):
        order2, keep2, dest2 = recv[my]
        yw = torch.where(keep2[:, None],
                         ys[my][dest2.clamp(0, S * C2 - 1)], 0).to(h_all.dtype)
        yw = yw * topv.reshape(-1)[order2][:, None].to(h_all.dtype)
        part = h_all.new_zeros((Btok, D))
        part.index_add_(0, flat_src[order2], yw)
        out_all = part if out_all is None else out_all + part
    _counted("all-reduce", out_all, 2)

    valid = m_all[flat_src].float()
    counts = torch.zeros((n_ep + 1, E), dtype=torch.float32, device=dev)
    _count_by_origin(counts, src_ep[flat_src],
                     F.one_hot(flat_e, E).float() * valid[:, None])
    counts = counts[:n_ep]
    local = (torch.sum((tgt == src_ep[flat_src]).float() * valid)
             / torch.clamp(torch.sum(valid), min=1.0))
    aux = aux_load_balance_loss(probs, topi, E)
    # replicated on every rank, then pmean'd: sum of n_ep copies / n_ep
    return out_all, counts, _pmean([local] * n_ep), _pmean([aux] * n_ep)


def moe_apply_ep(p, cfg, x, *, spec: EPSpec, placement: EPPlacement,
                 mode: str, norm_eps: float = 1e-5, token_mask=None,
                 origin=None):
    """Placement-aware EP MoE. x: [B, T, D]. Returns (out, stats).

    placement: device tables (``placement_to``). token_mask: [B] float
    validity per batch row (decode: vacant continuous-batching slots) or
    [B, T] per token (chunked prefill: prompt padding); 0-entries are
    excluded from the gating statistics. origin: [B] or [B, T] int — the EP
    rank each token's *request* originated at; ``counts_per_rank[r]`` then
    holds the gating counts of traffic that arrived at server ``r``. Without
    it attribution falls back to the physical rank (row rank in dispatch
    mode, rank 0 in decode mode), as in the reference on a (1, n_ep)
    mesh."""
    B, T, D = x.shape
    h = rms_norm(x, p["norm"], norm_eps)
    use_origin = origin is not None
    n_shards = 1 if mode == "decode" else spec.n_ep
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
    origin_rows = to_rows(origin if use_origin
                          else x.new_zeros((B, T)), torch.int64)
    if mode == "decode":
        out_rows, counts, local, aux = _ep_gather(
            rows, mask_rows, p, placement, cfg, spec,
            o_all=origin_rows if use_origin else None)
    else:
        out_rows, counts, local, aux = _ep_dispatch(
            rows, mask_rows, origin_rows, p, placement, cfg, spec, use_origin)
    out = out_rows[:B * T].reshape(B, T, D)
    stats = {"counts": counts.sum(0), "counts_per_rank": counts,
             "aux_loss": aux, "local_frac": local}
    return x + out.to(x.dtype), stats
