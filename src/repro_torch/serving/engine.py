"""Serving engine (PyTorch port of ``repro.serving.engine``): batched
prefill + decode with the placement-aware EP MoE layer, activation-stats
collection, and placement migration (re-gathering the EP weight slots from
the dense master copy — the on-device analogue of the paper's expert
transfer).

The paged step functions thread a device-resident *last-token buffer*
(``last_buf``, ``[max_slots + 1]`` int32 — one entry per serving slot plus
a trailing scratch entry that padding rows read and write) through every
call: the next token is computed on the device and scattered back into the
buffer, so the next round's inputs never depend on a host round trip.

Not in this slice: ``warmup_paged`` (ahead-of-time compiled bucket ladders,
which become CUDA graphs here).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.stats import ActivationStats
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tr
from repro_torch.serving.sampling import sample_tokens


@dataclasses.dataclass
class ServingEngine:
    rt: tr.Runtime
    params: Any  # EP-layout params (tensors on rt.device)
    placement: Any  # stacked EPPlacement [G, ...] (host or device)
    dense_master: Any = None  # dense expert weights (for migration)
    max_len: int = 256

    def __post_init__(self):
        rt = self.rt
        cfg = rt.cfg
        _, self.n_groups = cfg.layer_pattern()
        n_ep = rt.ep_spec.n_ep if rt.ep_spec else 1
        self.stats = ActivationStats(self.n_groups, n_ep, cfg.num_experts)
        self.last_local_frac: float | None = None  # most recent step's
        #   mean local-dispatch fraction (serving-side locality signal)
        if self.placement is not None:
            self.placement = moe_mod.placement_to(self.placement, rt.device)

    # ------------------------------------------------------------------
    def _prefill(self, params, tokens, placement, origin=None):
        return tr.prefill(self.rt, params, tokens, placement=placement,
                          cache_len=self.max_len, origin=origin)

    def _decode(self, params, cache, tokens, pos, placement, token_mask=None,
                origin=None):
        return tr.decode_step(self.rt, params, cache, tokens, pos, placement,
                              token_mask=token_mask, origin=origin)

    def paged_step_fns(self, block_size: int, max_pages: int):
        """(prefill_chunk, decode) step functions for a paged KV pool. The
        chunk function consumes one block-aligned chunk of *every*
        prefilling slot per call (batched multi-slot prefill). Both thread
        the last-token buffer: ``rows`` maps batch row -> slot index (the
        trailing scratch entry for padding rows), decode gathers its input
        tokens from ``last_buf`` and both scatter their next token back
        into it, so consecutive rounds chain without a host transfer. The
        pool and ``last_buf`` are updated in place. ``(block_size,
        max_pages)`` names the pool geometry the functions serve."""
        rt = self.rt

        def _chunk(params, pool, last_buf, rows, tokens, page_table,
                   write_blocks, offset, last_idx, placement, token_mask,
                   temps, seeds, origin=None):
            logits, pool, mstats = tr.prefill_chunk(
                rt, params, pool, tokens, page_table, write_blocks, offset,
                last_idx, placement, token_mask=token_mask, origin=origin)
            # seed the decode chain: rows whose final chunk just landed
            # read their first token from last_buf next round (partial
            # chunks scatter a value no decode round will ever gather)
            first = sample_tokens(logits, temps, seeds, None)
            last_buf[torch.as_tensor(rows, device=last_buf.device).long()] = first
            return last_buf, first, logits, pool, mstats

        def _dec(params, pool, last_buf, rows, pos, page_table, placement,
                 token_mask, temps, seeds, origin=None):
            rows = torch.as_tensor(rows, device=last_buf.device).long()
            cur = last_buf[rows][:, None]
            logits, pool, mstats = tr.decode_step(
                rt, params, pool, cur, pos, placement,
                token_mask=token_mask,
                page_table=torch.as_tensor(page_table, device=last_buf.device),
                origin=origin)
            nxt = sample_tokens(logits, temps, seeds, None)
            last_buf[rows] = nxt
            return last_buf, nxt, pool, mstats

        return _chunk, _dec

    # ------------------------------------------------------------------
    def copy_block(self, pool, src: int, dst: int):
        """Copy one physical block across every layer of a paged pool, in
        place — the runtime's copy-on-write primitive (clone a shared tail
        block before a sharer's first write)."""
        return tr.copy_paged_block(pool, src, dst)

    # ------------------------------------------------------------------
    def generate(self, tokens: np.ndarray, steps: int = 16):
        """tokens: [B, T] prompt. Greedy decoding. Returns (generated
        [B, steps], stats)."""
        B, T = tokens.shape
        if T + steps > self.max_len:
            raise ValueError(f"prompt({T}) + steps({steps}) exceeds "
                             f"max_len={self.max_len}")
        logits, cache, mstats = self._prefill(self.params, tokens,
                                              self.placement)
        # counts_per_rank are raw token counts: a T-token prefill already
        # carries T x the mass of one decode step, so no extra weighting.
        self._ingest(mstats)
        outs = []
        cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
        local_fracs = []
        for i in range(steps):
            outs.append(cur)
            logits, cache, mstats = self._decode(self.params, cache, cur,
                                                 T + i, self.placement)
            self._ingest(mstats)
            if mstats is not None:
                local_fracs.append(float(mstats["local_frac"].mean()))
            cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
        gen = torch.cat(outs, dim=1)
        return gen.cpu().numpy(), {
            "local_frac": float(np.mean(local_fracs)) if local_fracs else 1.0
        }

    def _ingest(self, mstats, weight: float = 1.0):
        """Feed gating statistics to the scheduler-side tracker. ``weight``
        rescales this update's counts."""
        if mstats is None:
            return
        counts = mstats["counts_per_rank"].cpu().numpy().astype(np.float64)
        self.stats.update(counts * weight)
        if "local_frac" in mstats:
            self.last_local_frac = float(mstats["local_frac"].mean())

    # ------------------------------------------------------------------
    def migrate(self, new_placement_stacked) -> None:
        """Adopt a new placement: re-gather EP expert slots from the dense
        master weights (if available) and swap the tables."""
        self.placement = moe_mod.placement_to(new_placement_stacked,
                                              self.rt.device)
        if self.dense_master is None:
            return
        moe_keys = [k for k, v in self.dense_master.items() if "router" in v]
        groups = dict(self.params["groups"])
        for k in moe_keys:  # free the old slots before gathering the new
            groups[k] = None
        self.params = {**self.params, "groups": groups}
        regathered = moe_mod.regather_ep_groups(
            {k: self.dense_master[k] for k in moe_keys}, self.placement,
            self.n_groups)
        groups.update(regathered)
