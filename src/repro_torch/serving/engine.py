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

``warmup_paged`` captures the full compaction bucket ladder (every
power-of-two batch width the runtime's ``compact_decode`` /
``compact_prefill`` bucketing can produce, x {chunk, decode} x the origin
modes, plus the copy-on-write block clone) as CUDA graphs over one
runtime's KV pool and last-token buffer (``serving.graphs``): the port's
counterpart of the reference's ahead-of-time compiled executables with the
pool and buffer donated. Every graph of an engine allocates from one
memory pool. ``migrate`` writes the placement tables and the EP weight
slots in place, so a graph captured before a migration replays the new
placement. ``traces`` counts the steps a warmed runtime ran eagerly
because no graph served them (the reference's lazy-jit traces): on a
CUDA engine the ladder covers every round, on the CPU (no graphs) every
warmed round is such a step.

A traced runtime (``ServingRuntime(tracer=...)``) sets ``tracer``: the
ladder is then captured with phase marks (``kernels.ops.phase_mark``: the
start of a chunk call or a decode round, each attention and MoE block,
the head, the end), ``migrate`` records a ``MIGRATE`` span and marks its
re-gather on the device. An untraced engine captures today's graphs,
with no mark in them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.stats import ActivationStats
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tr
from repro_torch.serving import graphs
from repro_torch.serving.obs import NULL_TRACER, SpanKind
from repro_torch.serving.sampling import greedy_tokens, sample_tokens


def _chunk_positions(offset, last_idx):
    """A chunk row's sample position, the absolute last prompt index (host
    arrays on the eager path, where a greedy batch never moves them to the
    device)."""
    if torch.is_tensor(offset):
        return offset + last_idx
    return np.asarray(offset) + np.asarray(last_idx)


@dataclasses.dataclass
class ServingEngine:
    rt: tr.Runtime
    params: Any  # EP-layout params (tensors on rt.device)
    placement: Any  # stacked EPPlacement [G, ...] (host or device)
    dense_master: Any = None  # dense expert weights (for migration)
    max_len: int = 256

    def __post_init__(self):
        if self.rt.kv_quant and not self.rt.kv_quant_consistent:
            # serving semantics: prefill attends to the dequantized k/v it
            # stores, so sequential generate(), the dense-pool runtime and
            # paged chunked prefill are all token-identical under int8
            self.rt = dataclasses.replace(self.rt, kv_quant_consistent=True)
        rt = self.rt
        cfg = rt.cfg
        _, self.n_groups = cfg.layer_pattern()
        n_ep = rt.ep_spec.n_ep if rt.ep_spec else 1
        self.stats = ActivationStats(self.n_groups, n_ep, cfg.num_experts)
        self.last_local_frac: float | None = None  # most recent step's
        #   mean local-dispatch fraction (serving-side locality signal)
        if self.placement is not None:
            # the engine's own contiguous tables (``stack_placement`` gives
            # stride-0 views): ``migrate`` copies into them in place
            self.placement = moe_mod.EPPlacement(*(
                t.clone(memory_format=torch.contiguous_format)
                for t in moe_mod.placement_to(self.placement, rt.device)))
        self.traces = 0   # steps a warmed runtime ran eagerly for want of
        #   a captured graph (the reference's lazy-jit traces)
        self._banks: list[graphs.Bank] = []   # captured ladders
        self._mempool = None   # the graphs' one memory pool
        self.tracer = NULL_TRACER   # a traced runtime's (see the module)

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
        next token is the seeded Gumbel-max sample of
        ``serving.sampling`` — the exact argmax for rows at ``temps == 0``,
        a per-request ``(seed, position)``-keyed draw otherwise, so
        sampling never depends on batch composition. The pool and
        ``last_buf`` are updated in place. ``(block_size, max_pages)``
        names the pool geometry the functions serve."""

        def _chunk(params, pool, last_buf, rows, tokens, page_table,
                   write_blocks, offset, last_idx, placement, token_mask,
                   temps, seeds, origin=None):
            dev = last_buf.device
            first, logits, mstats = self._chunk_step(
                params, pool, last_buf, torch.as_tensor(rows, device=dev),
                tokens, page_table, write_blocks, offset, last_idx,
                placement, token_mask, temps, seeds, origin)
            return last_buf, first, logits, pool, mstats

        def _dec(params, pool, last_buf, rows, pos, page_table, placement,
                 token_mask, temps, seeds, origin=None):
            dev = last_buf.device
            nxt, _, mstats = self._dec_step(
                params, pool, last_buf, torch.as_tensor(rows, device=dev),
                pos, torch.as_tensor(page_table, device=dev), placement,
                token_mask, temps, seeds, origin)
            return last_buf, nxt, pool, mstats

        return _chunk, _dec

    def _chunk_step(self, params, pool, last_buf, rows, tokens, page_table,
                    write_blocks, offset, last_idx, placement, token_mask,
                    temps, seeds, origin):
        """One batched prefill chunk with the sampled next token: the body
        of the chunk function and, with ``temps`` None (the greedy token
        only), of its captured graphs. Returns (first, logits, mstats)."""
        ops.phase_mark("chunk", last_buf)
        logits, pool, mstats = tr.prefill_chunk(
            self.rt, params, pool, tokens, page_table, write_blocks, offset,
            last_idx, placement, token_mask=token_mask, origin=origin)
        # seed the decode chain: rows whose final chunk just landed read
        # their first token from last_buf next round (partial chunks
        # scatter a value no decode round will ever gather)
        first = greedy_tokens(logits)
        last_buf[rows.long()] = first
        if temps is not None:
            self._resample(first, logits, last_buf, rows, temps, seeds,
                           _chunk_positions(offset, last_idx))
        ops.phase_mark("end", last_buf)
        return first, logits, mstats

    def _dec_step(self, params, pool, last_buf, rows, pos, page_table,
                  placement, token_mask, temps, seeds, origin):
        """One decode round with the sampled next token: the body of the
        decode function and, with ``temps`` None (the greedy token only),
        of its captured graphs. Returns (nxt, logits, mstats)."""
        ops.phase_mark("decode", last_buf)
        rows = rows.long()
        cur = last_buf[rows][:, None]
        logits, pool, mstats = tr.decode_step(
            self.rt, params, pool, cur, pos, placement,
            token_mask=token_mask, page_table=page_table, origin=origin)
        nxt = greedy_tokens(logits)
        last_buf[rows] = nxt
        if temps is not None:
            self._resample(nxt, logits, last_buf, rows, temps, seeds, pos)
        ops.phase_mark("end", last_buf)
        return nxt, logits, mstats

    @staticmethod
    def _resample(tok, logits, last_buf, rows, temps, seeds, positions):
        """Replace the greedy tokens ``tok`` (and their ``last_buf``
        entries) by the seeded draw of ``serving.sampling``, in place: the
        sampling tail of a step, and of a captured step the graph replayed
        after it when a row samples. Host ``temps`` with no hot row leave
        them as they are (greedy rows draw their argmax anyway)."""
        if not torch.is_tensor(temps) and not np.any(np.asarray(temps) > 0.0):
            return
        tok.copy_(sample_tokens(logits, temps, seeds, positions))
        last_buf[rows.long()] = tok

    # ------------------------------------------------------------------
    def _binding(self, pool=None) -> tuple:
        """Addresses of every tensor a captured graph reads: the engine's
        weights and placement tables, and the leaves of the KV ``pool`` it
        was captured over (the int8 layout's scales included)."""
        out = []

        def walk(tree):
            for v in tree.values():
                if isinstance(v, dict):
                    walk(v)
                elif torch.is_tensor(v):
                    out.append(v.data_ptr())
        walk(self.params)
        if self.placement is not None:
            out.extend(t.data_ptr() for t in self.placement)
        if pool is not None:
            walk(pool)
        return tuple(out)

    def _bank(self, last_buf=None, pool=None):
        """The captured ladder over ``last_buf`` (or over ``pool``)."""
        for bank in self._banks:
            if bank.last_buf is last_buf or bank.pool is pool:
                return bank
        return None

    def lease_paged(self, *, block_size: int, max_pages: int, max_slots: int,
                    n_blocks: int, owner, marks: bool = False):
        """``(pool, last_buf)`` of a captured ladder of this geometry (with
        phase marks or without, as ``marks``) that no live runtime holds,
        now held by ``owner`` — a second runtime replays the first one's
        graphs instead of capturing its own — or None."""
        geometry = (block_size, max_pages, max_slots, n_blocks)
        for bank in self._banks:
            if (bank.geometry == geometry and bank.graphs
                    and bank.marks == marks and bank.lease(owner)):
                bank.last_buf.zero_()
                return bank.pool, bank.last_buf
        return None

    def paged_executable(self, kind: str, block_size: int, max_pages: int,
                         B: int, tagged: bool, *, last_buf):
        """The captured graph of one (step kind, batch width, origin mode)
        point of the ladder warmed over ``last_buf`` (and its pool), or
        None when that point has no graph (callers run the eager step).
        ``(block_size, max_pages)`` must be the ladder's geometry."""
        bank = self._bank(last_buf=last_buf)
        if bank is None or bank.geometry[:2] != (block_size, max_pages):
            return None
        return bank.graphs.get(("copy",) if kind == "copy"
                               else (kind, B, tagged))

    def replay(self, g: graphs.StepGraph, sample: bool = False) -> None:
        """Replay a captured step after checking that the engine's weights
        and placement tables and its pool's leaves are the tensors it was
        captured over (a rebound tensor would leave the graph reading freed
        memory)."""
        if self._binding(g.pool) != g.binding:
            raise RuntimeError(
                f"graph {g.key}: the engine's weights, placement tables or "
                "KV pool were rebound since capture (migrate writes them in "
                "place)")
        g.replay(sample)

    def warmup_paged(self, *, block_size: int, max_pages: int,
                     max_slots: int, pool, last_buf, origins: str = "both",
                     owner=None, marks: bool = False) -> dict:
        """Capture the paged serving ladder for one pool geometry as CUDA
        graphs: every compaction bucket width (powers of two up to
        ``max_slots``, plus ``max_slots`` itself) x {prefill chunk, decode}
        x the requested origin modes, plus the copy-on-write block clone.
        ``pool``/``last_buf`` are the runtime's live buffers: the graphs
        read and update them in place, and serve no other buffers.

        origins: "both" (default), "tagged" (per-request origin arrays) or
        "untagged" — a runtime that knows its stream mode can halve the
        ladder. ``owner``: the runtime the buffers belong to (see
        ``lease_paged``). ``marks``: capture the phase marks (a traced
        runtime's ladder); without, the graphs hold none.

        Returns {"seconds": wall_time, "executables": ladder_size} — the
        number of graphs this runtime serves from (ones captured earlier
        over the same buffers included; those are not captured again, so a
        runtime that leased them warms for free). On a CPU engine there
        are no graphs: {"seconds": 0.0, "executables": 0}, and a warmed
        runtime runs every step eagerly (counted in ``traces``)."""
        t0 = time.perf_counter()
        keys = graphs.ladder_keys(max_slots, origins)
        if not last_buf.is_cuda:
            return {"seconds": 0.0, "executables": 0}
        bank = self._bank(last_buf=last_buf)
        if bank is None:
            leaf = next(iter(next(iter(pool.values())).values()))
            bank = graphs.Bank((block_size, max_pages, max_slots,
                                int(leaf.shape[1])), pool, last_buf, owner,
                               marks=marks)
            self._banks.append(bank)
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        with ops.marks() if bank.marks else contextlib.nullcontext():
            for key in keys:
                if key not in bank.graphs:
                    bank.graphs[key] = self._capture(key, bank, max_slots)
        torch.cuda.synchronize()
        return {"seconds": time.perf_counter() - t0, "executables": len(keys)}

    def _capture(self, key, bank: graphs.Bank, max_slots: int):
        block_size, max_pages = bank.geometry[:2]
        pool, last_buf = bank.pool, bank.last_buf
        dev = last_buf.device
        if key == ("copy",):
            static = torch.zeros((2,), dtype=torch.int32, device=dev)

            def run(x):      # src = dst = the null block while warming
                for c in pool.values():
                    for a in c.values():
                        a[:, x["dst"]] = a[:, x["src"]]
                return None

            return graphs.StepGraph.capture(
                key, None, static, run, mempool=self._mempool,
                binding=self._binding(pool), pool=pool)
        kind, B, tagged = key
        layout = graphs.input_layout(kind, B, block_size, max_pages, tagged)
        static = torch.zeros((graphs.layout_size(layout),), dtype=torch.int32,
                             device=dev)
        # padding rows: the last-token buffer's scratch entry, null pages
        static[layout["rows"][0]:layout["rows"][0] + B] = max_slots

        # the step graph computes the greedy token; its sampling tail, a
        # second graph over the step's outputs, is replayed after it only
        # when some row samples (so greedy rounds never pay the draw)
        if kind == "chunk":
            def run(x):
                return self._chunk_step(
                    self.params, pool, last_buf, x["rows"], x["toks"],
                    x["tbl"], x["wb"], x["offs"], x["lidx"], self.placement,
                    x["mask"], None, None, x.get("org"))

            def tail(x, out):
                self._resample(out[0], out[1], last_buf, x["rows"],
                               x["temps"], x["seeds"],
                               _chunk_positions(x["offs"], x["lidx"]))
        else:
            def run(x):
                return self._dec_step(
                    self.params, pool, last_buf, x["rows"], x["pos"],
                    x["tbl"], self.placement, x["mask"], None, None,
                    x.get("org"))

            def tail(x, out):
                self._resample(out[0], out[1], last_buf, x["rows"],
                               x["temps"], x["seeds"], x["pos"])

        return graphs.StepGraph.capture(key, layout, static, run,
                                        mempool=self._mempool,
                                        binding=self._binding(pool), pool=pool,
                                        tail=tail)

    # ------------------------------------------------------------------
    def copy_block(self, pool, src: int, dst: int):
        """Copy one physical block across every layer of a paged pool, in
        place — the runtime's copy-on-write primitive (clone a shared tail
        block before a sharer's first write). Routed through the captured
        clone when the pool belongs to a warmed ladder."""
        bank = self._bank(pool=pool)
        g = bank.graphs.get(("copy",)) if bank is not None else None
        if g is None:
            return tr.copy_paged_block(pool, src, dst)
        g.inputs["src"].fill_(int(src))
        g.inputs["dst"].fill_(int(dst))
        self.replay(g)
        return pool

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
        """Adopt a new placement: copy the tables into the engine's own and
        re-gather the EP expert slots from the dense master weights (if
        available) into the existing slot stacks. Both are written in
        place, so captured graphs keep reading the right tensors (an engine
        built over the same weight tensors sees them move too). On the card
        the copies are enqueued on the current stream behind the rounds in
        flight, which therefore still see the old placement, as the
        reference's in-flight rounds hold its old arrays. ``placement`` is
        rebound to a new tuple over the same tensors, so a caller that
        caches by identity sees the change. A traced engine records the
        call as a ``MIGRATE`` span and marks the re-gather on the device
        (``regather`` ... ``end``)."""
        op = (self.tracer.begin(SpanKind.MIGRATE) if self.tracer.enabled
              else None)
        with ops.marks() if op is not None else contextlib.nullcontext():
            self._migrate(new_placement_stacked)
        if op is not None:
            self.tracer.end(op, regather=self.dense_master is not None)

    def _migrate(self, new_placement_stacked) -> None:
        new = moe_mod.placement_to(new_placement_stacked, self.rt.device)
        for dst, src in zip(self.placement, new):
            if dst.shape != src.shape:
                raise ValueError(f"placement table of shape "
                                 f"{tuple(src.shape)}, expected "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        self.placement = moe_mod.EPPlacement(*self.placement)
        if self.dense_master is None:
            return
        ops.phase_mark("regather", self.placement.slot_to_expert)
        moe_mod.regather_ep_groups(
            {k: v for k, v in self.dense_master.items() if "router" in v},
            self.placement, self.n_groups, out=self.params["groups"])
        ops.phase_mark("end", self.placement.slot_to_expert)
