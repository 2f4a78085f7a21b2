"""Continuous-batching serving runtime on top of the ``ServingEngine`` step
functions (PyTorch port of ``repro.serving.runtime``).

``ServingEngine.generate`` serves one synchronous batch: every request in it
starts and finishes together. This runtime serves a *request stream*
instead:

* a request queue — ``submit()`` at any time, including mid-stream;
* a **paged KV-cache pool** (default) — a shared block table of
  ``n_blocks × block_size`` positions per layer plus a per-slot page list
  managed by a reference-counted ``BlockAllocator``; admission is governed
  by free *blocks*, not free ``max_len`` rows, so heterogeneous request
  streams pack the same KV memory far denser than the legacy dense pool;
* a **radix prefix cache** (``prefix_cache=True``, the default) — a token
  trie mapping block-aligned prompt prefixes to the physical blocks that
  already hold their k/v. A request whose prompt shares a cached prefix
  acquires those blocks shared (refcount + 1) and skips prefill for them
  entirely; an identical prompt skips *all* prefill (first token from the
  cached last-prompt-token logits) and gets a **copy-on-write** clone of
  the partially-filled tail block before its first decode write — a block
  with refcount > 1 is never written;
* **batched chunked prefill** — each scheduler tick advances *every*
  prefilling slot by one ``block_size``-aligned chunk in a single
  ``prefill_chunk`` call,
  interleaved with decode rounds, so neither a long prompt nor many short
  non-shared tails serialize the pool;
* interleaved prefill/decode — every decoding slot advances one token per
  decode round regardless of arrival time (per-row cache positions via the
  vector-``pos`` decode path);
* **compacted decode** (``compact_decode=True``, paged mode) — each decode
  round batches only the occupied slots, padded to the next power-of-two
  bucket width, instead of always paying for the full ``max_slots`` pool.

Requests enter through the typed serving API
(``repro.serving.api.Request`` -> ``enqueue() -> RequestHandle``): handles
emit structured ``ADMITTED/DEFERRED/PREFIX_HIT/TOKEN/FINISHED`` events with
per-request latency/locality metrics. The positional ``submit(...)`` +
``{rid: tokens}`` surface survives only as a ``DeprecationWarning`` shim.

The legacy dense slot pool (``paged=False``) allocates ``max_slots`` rows
of ``max_len`` positions and prefills whole prompts in one call; it remains
for architectures whose caches cannot be paged (SSM state, sliding-window
rings) and as the reference implementation for the equivalence suite.

``warmup=True`` (the reference's ahead-of-time compiled bucket ladder and
zero-stall loop, which become CUDA graphs here) is not ported yet and
raises ``NotImplementedError``; every round is synchronous. The hooks the
cluster layer reads keep their synchronous meaning: ``_pending`` (the
reference's backlog of launched, undrained rounds) is a deque that stays
empty, ``flush()`` drains nothing, and ``warmup_seconds``,
``executables_compiled`` and ``traces_after_warmup`` are 0.

Outputs are token-identical to sequential ``generate()`` calls in both
modes — with or without the prefix cache — as long as the EP dispatch
capacities are not saturated (rows are independent in attention; the MoE
layer couples them only through capacity dropping). Prefix reuse is exact
because k/v at position ``i`` depend only on tokens ``0..i``.

The runtime also hosts the serving side of the placement control plane: it
feeds gating statistics to a ``PlacementController`` and applies adopted
plans to the engine (re-gather + table swap, no recompile). Requests
tagged with ``submit(origin=...)`` have their gating counts attributed to
that *originating server* instead of the physical row-sharding rank
(Algorithm 1's per-server f_n(e)); untagged streams keep the positional
fallback unchanged.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.core.policies import PlacementController
from repro_torch.models import transformer as tr
from repro_torch.serving.api import EventType, Request, RequestHandle, SeqCounter
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.obs import NULL_TRACER, SpanKind, Tracer
from repro_torch.serving.prefix_cache import PrefixMatch, RadixPrefixCache
from repro_torch.serving.sampling import sample_token_host, sample_tokens


@dataclasses.dataclass
class GenRequest:
    """One queued generation request (internal admission record built from
    an API :class:`Request` by ``enqueue``)."""
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new_tokens: int
    origin: int | None = None     # originating server (EP rank) for stats
    eos: int | None = None        # stop token (truncates max_new_tokens)
    temperature: float = 0.0      # 0 = greedy; > 0 = seeded Gumbel-max
    seed: int = 0                 # per-request sampling PRNG seed
    deadline: float | None = None  # absolute tick the SLO expires at
    #   (submitted_at + slo; None = no SLO) — drives the slo_aware
    #   deadline-ordered admission queue and the shed rule


@dataclasses.dataclass
class _Slot:
    """State of one occupied KV-cache pool row."""
    rid: int
    pos: int                      # next cache write position
    last: int                     # last emitted token (next decode input)
    tokens: list                  # emitted tokens so far
    need: int                     # total tokens to emit (shrunk on EOS)
    origin: int | None = None     # originating server (stats attribution)
    eos: int | None = None        # stop token (None = length stop only)
    launched: int = 0             # tokens whose computation was launched;
    #   drives decode-batch composition
    temperature: float = 0.0      # sampling temperature (0 = greedy)
    seed: int = 0                 # sampling PRNG seed
    # paged-mode state
    pages: list = dataclasses.field(default_factory=list)
    prompt: np.ndarray | None = None   # full prompt (kept for cache insert)
    filled: int = 0                    # prompt tokens already in the pool
    final_logits: np.ndarray | None = None  # last-prompt-token logits (for
    #                                         tail insertion at retirement)
    prefix_skipped: int = 0            # prompt tokens served from the cache
    lf_sum: float = 0.0                # running local_frac over decode rounds
    lf_rounds: int = 0

    @property
    def prefilling(self) -> bool:
        return self.prompt is not None and self.filled < len(self.prompt)


class BlockAllocator:
    """Reference-counted free-list allocator over the physical blocks of a
    paged KV pool.

    Block 0 is reserved as the *null block*: vacant decode rows point their
    page tables at it and park their garbage writes there, so it is never
    handed out. ``alloc`` hands out fresh blocks at refcount 1;
    ``acquire`` adds a reference to a live block (prefix sharing: a block
    may be held by several slots plus the radix cache at once); ``release``
    drops one reference and recycles the block only at refcount 0. Acquire
    or release of a non-live block is a structural error and raises.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))   # LIFO: hot reuse
        self._rc: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (the null block is excluded)."""
        return self.n_blocks - 1

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` fresh blocks at refcount 1; raises when exhausted
        (callers check ``can_alloc`` first and defer admission instead)."""
        if not self.can_alloc(n):
            raise RuntimeError(
                f"paged pool exhausted: requested {n} blocks, "
                f"{len(self._free)} free")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._rc[b] = 1
        return blocks

    def acquire(self, blocks: list[int]) -> None:
        """Add one reference to each live block (shared prefix pages)."""
        for b in blocks:
            if b not in self._rc:
                raise RuntimeError(f"block {b} is not allocated")
        for b in blocks:
            self._rc[b] += 1

    def release(self, blocks: list[int]) -> int:
        """Drop one reference per block; a block is recycled only when its
        refcount reaches 0. Returns the number of blocks recycled.

        Refcounts are anonymous (sharing means a block has no single
        owner), so a release the caller does not actually hold steals
        another holder's reference rather than raising — the runtime's
        ``check_invariants`` (refcount == slot holds + cache refs, asserted
        every tick of the property suites) is the guard for that misuse
        class, replacing the old owner-tag check that sharing made
        impossible."""
        freed = 0
        for b in blocks:
            rc = self._rc.get(b)
            if rc is None:
                raise RuntimeError(f"block {b} is not allocated")
            if rc == 1:
                del self._rc[b]
                self._free.append(b)
                freed += 1
            else:
                self._rc[b] = rc - 1
        return freed

    def refcount(self, b: int) -> int:
        return self._rc.get(b, 0)

    def live(self) -> dict[int, int]:
        """Live block -> refcount (for invariant checks and tests)."""
        return dict(self._rc)


class Reservoir:
    """Bounded, deterministic subsample of an append-only float stream.

    The runtime's wall-time series (``decode_round_s``, ``ttft_s``)
    previously grew one entry per decode round / request forever — a
    leak on long-running serving. The reservoir keeps a *systematic*
    1-in-``2^k`` subsample instead: it records every ``stride``-th
    append, and when the kept list would exceed ``cap`` it drops every
    other kept sample and doubles the stride. Survivors stay evenly
    spaced over the whole stream (indices ``0, stride, 2*stride, ...``),
    so percentiles remain representative of the full history at bounded
    memory. No RNG — a replayed fault schedule stays bit-identical.

    ``count`` is the total number of appends (the true observation
    count); ``len()``/iteration expose the kept samples.
    """

    def __init__(self, cap: int = 4096):
        if cap < 2:
            raise ValueError(f"cap must be >= 2 (got {cap})")
        self.cap = cap
        self.count = 0            # total appends ever
        self.stride = 1           # keep one sample per this many appends
        self._data: list[float] = []

    def append(self, x: float) -> None:
        if self.count % self.stride == 0:
            self._data.append(float(x))
            if len(self._data) > self.cap:
                self._data = self._data[::2]
                self.stride *= 2
        self.count += 1

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)


class ServingRuntime:
    """Continuous batching over a shared KV pool.

    engine:      a ``ServingEngine`` (its step functions are reused).
    max_slots:   decode batch width. In paged mode this is
                 *only* the batch width — KV memory is the block pool.
    controller:  optional ``PlacementController``; its clock is decode
                 rounds (set ``interval`` accordingly). Adopted plans are
                 applied to the engine via ``engine.migrate``.
    paged:       True = paged block pool + chunked prefill; False = legacy
                 dense per-slot rows; None (default) = paged when the
                 architecture supports it (attention caches, no sliding
                 window), dense otherwise.
    block_size:  positions per physical KV block (paged mode).
    n_blocks:    physical blocks incl. the null block. Default sizes the
                 pool to the dense pool's KV memory
                 (``max_slots * max_len`` positions) plus the null block.
    max_pages:   page-table width (max blocks one request may hold); the
                 per-step attention gather is ``max_pages * block_size``
                 positions per row, so this is the cost/length-cap knob.
                 Default: ``2 * ceil(max_len / block_size)``, clamped to
                 the pool.
    chunks_per_tick: batched prefill rounds per ``step()`` — each round
                 advances every prefilling slot one chunk in one call
                 (interleaving knob).
    prefix_cache: enable the radix prefix cache (paged mode only).
    compact_decode: decode only the occupied slots each round, padded to
                 the next power-of-two bucket (paged mode only) — a pool
                 that is 1/8 occupied decodes a width-1 batch instead of
                 the full ``max_slots`` width; the dense pool always
                 decodes full width (its KV rows are positional).
    compact_prefill: the same bucketing for the batched ``prefill_chunk``
                 call (paged mode only): only the *prefilling* slots ride
                 each chunk round, padded to the next power-of-two width,
                 instead of the fixed ``max_slots`` batch. ``prefill_rows``
                 counts the rows actually executed (the compaction metric,
                 mirroring ``decode_rows``).
    warmup:      not ported yet (raises ``NotImplementedError``).

    SSM and hybrid architectures are not served here yet (their recurrent
    caches are not in the slot pools): construction raises
    ``NotImplementedError``; ``ServingEngine.generate`` serves them.
    """

    def __init__(self, engine: ServingEngine, max_slots: int = 4,
                 controller: PlacementController | None = None, *,
                 paged: bool | None = None, block_size: int = 16,
                 n_blocks: int | None = None, max_pages: int | None = None,
                 chunks_per_tick: int = 1, prefix_cache: bool = True,
                 compact_decode: bool = True, compact_prefill: bool = True,
                 warmup: bool = False,
                 slo_aware: bool = False, tracer: Tracer | None = None,
                 seq_counter: SeqCounter | None = None,
                 tracer_server: int = -1):
        pattern, _ = engine.rt.cfg.layer_pattern()
        if any(k in (tr.MAMBA1, tr.MAMBA2) for k in pattern):
            raise NotImplementedError(
                f"ServingRuntime does not serve SSM or hybrid architectures "
                f"yet ({engine.rt.cfg.name}); use ServingEngine.generate")
        self.engine = engine
        self.max_slots = max_slots
        # observability: span emission sites guard on tracer.enabled (the
        # default NULL_TRACER), so an untraced runtime allocates nothing
        # extra. tracer_server labels this runtime's spans with its
        # cluster server id (its Perfetto track); -1 = standalone.
        # seq_counter (cluster-shared) stamps handle events with the
        # monotonic merge order; standalone runtimes get their own.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.seq = seq_counter if seq_counter is not None else SeqCounter()
        self.tracer_server = tracer_server
        self._enq_tick: dict[int, int] = {}   # rid -> enqueue tick (traced)
        # SLO-aware scheduling: admission drains the queue in deadline
        # order (EDF) instead of FIFO, and requests whose deadline cannot
        # be met even under the best case (full prefix hit, one token per
        # tick) are *shed* — SHED event + terminal empty FINISHED — so
        # doomed work never occupies a slot another request could use
        self.slo_aware = bool(slo_aware)
        self.sheds = 0                # requests shed by SLO-aware admission
        self.controller = controller
        if controller is not None:
            if controller.stats is None:
                controller.stats = engine.stats
            if controller.last_review is None:
                # start the review clock: the first (initial-adopt) review
                # must also wait a full interval of observed traffic, not
                # fire on decode round 1 with near-empty stats
                controller.last_review = 0.0
        if warmup:
            raise NotImplementedError(
                "warmup=True (ahead-of-time bucket ladder + zero-stall loop) "
                "is not ported yet")
        if paged is None:
            paged = tr.supports_paging(engine.rt)
        self.paged = paged
        self.prefix_cache: RadixPrefixCache | None = None
        if paged:
            self.block_size = block_size
            if n_blocks is None:
                n_blocks = 1 + max_slots * (-(-engine.max_len // block_size))
            self.allocator = BlockAllocator(n_blocks)
            if max_pages is None:
                # per-request length cap: attention gathers max_pages*bs
                # positions per batch row every step, so don't default to
                # the whole pool — 2x the legacy row length keeps long
                # requests admissible at bounded gather cost (pass
                # max_pages=allocator.capacity_blocks for unbounded)
                max_pages = min(self.allocator.capacity_blocks,
                                2 * (-(-engine.max_len // block_size)))
            self.max_pages = max_pages
            self.chunks_per_tick = chunks_per_tick
            if prefix_cache:
                self.prefix_cache = RadixPrefixCache(block_size,
                                                     self.allocator)
            self.pool = tr.init_paged_cache(engine.rt, n_blocks, block_size)
            self.page_table = np.zeros((max_slots, self.max_pages), np.int32)
            self._chunk_fn, self._decode_fn = engine.paged_step_fns(
                block_size, self.max_pages)
            # device-resident last-token buffer: one entry per slot plus a
            # trailing scratch entry that padding batch rows read/write
            self._last_buf = torch.zeros((max_slots + 1,), dtype=torch.int32,
                                         device=engine.rt.device)
        else:
            self.pool = tr.init_cache(engine.rt, max_slots, engine.max_len)
        self.compact_decode = compact_decode
        self.compact_prefill = compact_prefill
        self.slots: list[_Slot | None] = [None] * max_slots
        self.queue: collections.deque[GenRequest] = collections.deque()
        self.finished: dict[int, np.ndarray] = {}
        self.handles: dict[int, RequestHandle] = {}   # rid -> handle
        self.rounds = 0               # decode rounds served (controller clock)
        self.ticks = 0                # scheduler ticks (step() calls)
        self.max_concurrency = 0      # peak active slots in one decode batch
        self.max_admitted = 0         # peak concurrently admitted requests
        self.decode_rows = 0          # batch rows decoded (compaction metric)
        self.prefill_rows = 0         # chunk-call rows issued (compaction)
        self.finished_at: dict[int, int] = {}   # rid -> tick of completion
        self.deferrals = 0            # admissions deferred on free blocks
        self.prefix_hits = 0          # admissions that reused cached pages
        self.prefix_tokens_skipped = 0  # prompt tokens never prefilled
        self.prefill_calls = 0        # chunk calls issued
        self.chunks_executed = 0      # per-slot chunks consumed (compute)
        self.cow_copies = 0           # copy-on-write tail clones
        self.host_syncs = 0           # blocking host waits on device data
        #   (one per decode round / final prefill chunk)
        # the warmed loop's figures and backlog: 0 and empty on the
        # synchronous loop (read by the cluster's perf and pending checks)
        self.warmup_seconds = 0.0
        self.executables_compiled = 0
        self.traces_after_warmup = 0
        self._pending: collections.deque = collections.deque()
        self.decode_round_s = Reservoir()   # per-round wall time of the
        #   decode segment (launch + token fetch); bounded: a systematic
        #   subsample survives long runs
        self.ttft_s = Reservoir()      # wall-clock time to first token
        self._finished_total = 0       # results drained via pop_finished()
        self.migrations: list = []
        self._t_enqueue: dict[int, float] = {}   # rid -> perf_counter()
        self._next_rid = 0
        self._origin_mode: str | None = None   # 'tagged' | 'untagged'

    # ------------------------------------------------------------------
    def _pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Blocks a request holds for its lifetime: prompt positions
        0..T-1 (whole blocks — chunked prefill writes block-aligned) plus
        decode writes at T..T+need-2."""
        bs = self.block_size
        return max(-(-prompt_len // bs),
                   -(-(prompt_len + max_new_tokens - 1) // bs))

    @property
    def capacity_tokens(self) -> int:
        """Total KV positions this runtime can hold for live requests."""
        if self.paged:
            return self.allocator.capacity_blocks * self.block_size
        return self.max_slots * self.engine.max_len

    def enqueue(self, request: Request,
                handle: RequestHandle | None = None) -> RequestHandle:
        """Enqueue one typed :class:`Request`; returns its
        :class:`RequestHandle` (structured ADMITTED/DEFERRED/PREFIX_HIT/
        TOKEN/FINISHED events, tokens, per-request metrics).

        ``request.origin`` is the EP rank / edge server the request arrived
        at — gating statistics are attributed to it (Algorithm 1's f_n(e)).

        ``handle=`` re-admits a request under an *existing* handle (cluster
        failover: a victim evicted from a crashed server keeps one
        observable lifecycle across servers). The handle is re-bound to a
        fresh internal rid; its original ``submitted_at`` is preserved so
        end-to-end latency spans the crash.

        Paged mode validates against the *total pool capacity* (a request
        merely larger than the legacy ``max_len`` is admissible — it just
        holds more pages); dense mode keeps the per-row ``max_len`` bound.
        """
        prompt = request.prompt
        max_new_tokens = request.max_new_tokens
        origin = request.origin
        n_ep = (self.engine.rt.ep_spec.n_ep
                if self.engine.rt.ep_spec is not None else 1)
        if origin is not None and not 0 <= origin < n_ep:
            # the gating-stats scatter drops out-of-range origins silently
            # (mode="drop"); reject them here so the PlacementController
            # never computes adoption decisions on invisibly missing traffic
            raise ValueError(
                f"origin {origin} out of range for {n_ep} EP rank(s)")
        mode = "untagged" if origin is None else "tagged"
        if self._origin_mode is None:
            self._origin_mode = mode
        elif self._origin_mode != mode:
            # mixing would silently credit untagged rows to server 0 when
            # batched with tagged ones (the positional fallback is
            # all-or-nothing per step call) — reject at submit time, the
            # same place out-of-range origins are rejected
            raise ValueError(
                f"cannot mix {mode} submit with a {self._origin_mode} "
                "stream: pass origin= on every request or on none")
        if self.paged:
            npages = self._pages_needed(len(prompt), max_new_tokens)
            if npages > min(self.allocator.capacity_blocks, self.max_pages):
                raise ValueError(
                    f"prompt({len(prompt)}) + max_new_tokens"
                    f"({max_new_tokens}) needs {npages} blocks; the paged "
                    f"pool caps a request at "
                    f"{min(self.allocator.capacity_blocks, self.max_pages)} "
                    f"blocks ({self.capacity_tokens} positions total)")
        elif len(prompt) + max_new_tokens > self.engine.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens({max_new_tokens}) "
                f"exceeds the pool's max_len={self.engine.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        if handle is None:
            handle = RequestHandle(rid, request, clock="ticks",
                                   seq=self.seq)
            handle.submitted_at = self.ticks
        else:
            handle.rid = rid
            handle.request = request
            if handle._seqc is None:
                handle._seqc = self.seq
            if handle.submitted_at is None:
                handle.submitted_at = self.ticks
        if self.tracer.enabled:
            # QUEUE_WAIT opens here; closed (and popped) at admission or
            # shed. Keyed by the fresh rid, so a failover re-admit's wait
            # on the new server is its own span.
            self._enq_tick[rid] = self.ticks
        slo = request.slo
        # the deadline is anchored at the *original* submit tick, so a
        # failover re-admit does not get a fresh SLO budget
        deadline = (handle.submitted_at + slo) if slo is not None else None
        self.queue.append(GenRequest(
            rid, prompt, max_new_tokens, origin,
            getattr(request, "eos", None),
            temperature=float(getattr(request, "temperature", 0.0)),
            seed=int(getattr(request, "seed", 0)),
            deadline=deadline))
        self.handles[rid] = handle
        self._t_enqueue[rid] = time.perf_counter()
        return handle

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               origin: int | None = None) -> int:
        """DEPRECATED positional submit — construct a
        ``repro.serving.api.Request`` and call :meth:`enqueue` instead
        (same admission semantics; the handle's events/metrics replace the
        raw ``{rid: tokens}`` dict). Kept as a thin shim returning the
        request id; results remain readable from ``self.finished``."""
        warnings.warn(
            "ServingRuntime.submit(prompt, max_new_tokens, origin) is "
            "deprecated: build a repro.serving.api.Request and call "
            "enqueue() (see serving/README.md, 'Serving API v1')",
            DeprecationWarning, stacklevel=2)
        return self.enqueue(Request(prompt=prompt,
                                    max_new_tokens=max_new_tokens,
                                    origin=origin)).rid

    # -- event plumbing ------------------------------------------------
    def _emit(self, rid: int, type_: str, **data) -> None:
        h = self.handles.get(rid)
        if h is not None:
            h._emit(type_, self.ticks, **data)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted requests that reused cached prefix pages."""
        n = self._finished_total + len(self.finished) + self.active
        return self.prefix_hits / n if n else 0.0

    def pop_finished(self) -> dict[int, np.ndarray]:
        """Drain completed results: returns ``{rid: tokens}`` for every
        finished request and releases their bookkeeping (result arrays,
        completion ticks, handles). Long-running callers (the cluster
        backends) call this periodically so the runtime's footprint is
        bounded by the *live* request set, not the full serve history —
        ``finished`` / ``finished_at`` / ``handles`` previously grew one
        entry per request forever. Callers that never pop keep the old
        read-after-``run()`` behavior unchanged."""
        out = dict(self.finished)
        self.finished.clear()
        self._finished_total += len(out)
        for rid in out:
            self.finished_at.pop(rid, None)
            self.handles.pop(rid, None)
        return out

    def evict(self, rid: int) -> int:
        """Remove one request — queued or in flight — and return the
        number of tokens it had already emitted (the cluster's failover
        bookkeeping: tokens a re-routed victim must regenerate). An
        in-flight slot's pages are released (cache-shared blocks survive
        via their refcounts). The handle stays with the
        caller, who may re-submit it elsewhere (``enqueue(handle=...)``);
        unknown/finished rids are a no-op returning 0."""
        for k, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[k]
                self.handles.pop(rid, None)
                self._t_enqueue.pop(rid, None)
                self._enq_tick.pop(rid, None)
                return 0
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                if self.paged and s.pages:
                    self.allocator.release(s.pages)
                    self.page_table[i] = 0
                self.slots[i] = None
                self.handles.pop(rid, None)
                self._t_enqueue.pop(rid, None)
                self._enq_tick.pop(rid, None)
                return len(s.tokens)
        return 0

    def perf_metrics(self) -> dict:
        """The ``metrics.perf`` section: warmup cost and retrace counters
        (0 until the warmed loop is ported), host-sync count and
        decode-round / time-to-first-token wall-time percentiles
        (milliseconds)."""
        def pct(xs):
            xs = list(xs)
            if not xs:
                return {"p50": 0.0, "p99": 0.0}
            return {"p50": round(float(np.percentile(xs, 50)) * 1e3, 6),
                    "p99": round(float(np.percentile(xs, 99)) * 1e3, 6)}
        return {
            "warmup_seconds": round(self.warmup_seconds, 6),
            "executables_compiled": self.executables_compiled,
            "traces_after_warmup": self.traces_after_warmup,
            "host_syncs": self.host_syncs,
            "rounds_timed": self.decode_round_s.count,
            "decode_round_ms": pct(self.decode_round_s),
            "ttft_ms": pct(self.ttft_s),
        }

    # ------------------------------------------------------------------
    def _free_slot_ids(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @staticmethod
    def _origin_arg(origins):
        """[B] int64 origin array for the step fns, or None when no
        request in the batch carries an explicit origin — None keeps the
        MoE layer's positional attribution fallback (and its decode
        replica routing) identical to an origin-unaware deployment.
        ``submit`` rejects mixing, so a batch is all-tagged or all-None."""
        origins = list(origins)
        if all(o is None for o in origins):
            return None
        return np.asarray([o or 0 for o in origins], np.int64)

    def _admit(self) -> int:
        if self.slo_aware:
            self._slo_schedule()
        if self.paged:
            n = self._admit_paged()
        else:
            n = self._admit_dense()
        self.max_admitted = max(self.max_admitted, self.active)
        return n

    def _slo_schedule(self) -> None:
        """SLO-aware queue pass (``slo_aware=True``): shed every queued
        request whose deadline is unmeetable even in the best case — a
        full prefix hit emitting its first token this tick and one token
        per tick after (``ticks + need - 1 > deadline``) — then reorder
        the queue earliest-deadline-first (SLO-less requests sort last,
        ties broken by rid, so the order is total and deterministic).
        Shedding is optimistic on purpose: only certainly-doomed requests
        are dropped, a merely-late-looking queue keeps its chance."""
        kept: collections.deque[GenRequest] = collections.deque()
        for r in self.queue:
            if (r.deadline is not None
                    and self.ticks + r.max_new_tokens - 1 > r.deadline):
                self._shed(r)
            else:
                kept.append(r)
        if len(kept) > 1:
            kept = collections.deque(sorted(
                kept, key=lambda r: (r.deadline if r.deadline is not None
                                     else float("inf"), r.rid)))
        self.queue = kept

    def _shed(self, r: GenRequest) -> None:
        """Drop one doomed queued request: SHED event, then the terminal
        FINISHED (``tokens=0, shed=True, slo_met=False``) so the request
        still resolves — consumers block on FINISHED, never on SHED."""
        self.sheds += 1
        if self.tracer.enabled:
            self.tracer.span(SpanKind.QUEUE_WAIT,
                             self._enq_tick.pop(r.rid, self.ticks),
                             self.ticks, rid=r.rid,
                             server=self.tracer_server, shed=True)
            self.tracer.instant(SpanKind.SHED, self.ticks, rid=r.rid,
                                server=self.tracer_server,
                                deadline=r.deadline, need=r.max_new_tokens)
        self._emit(r.rid, EventType.SHED, deadline=r.deadline,
                   need=r.max_new_tokens)
        self.finished[r.rid] = np.zeros(0, np.int32)
        self.finished_at[r.rid] = self.ticks
        self._t_enqueue.pop(r.rid, None)
        h = self.handles.get(r.rid)
        if h is None:
            return
        latency = (self.ticks - h.submitted_at
                   if h.submitted_at is not None else None)
        h._emit(EventType.FINISHED, self.ticks,
                tokens=0, origin=r.origin, server=h.server,
                latency=latency, wait=None,
                deferred_ticks=h.deferred_ticks,
                prefix_tokens_skipped=0, local_frac=None,
                slo=h.request.slo, slo_met=False, shed=True)

    def _admit_paged(self) -> int:
        """Admit queue-head requests while a slot row and enough free
        blocks exist — FIFO order by default, earliest-deadline-first
        under ``slo_aware`` (``_slo_schedule`` reorders the queue before
        this runs). The prefix cache is consulted first: shared pages are
        acquired (refcount + 1) instead of allocated, so a hit both skips
        prefill and shrinks the fresh-block bill. A head that does not fit
        — after evicting cold cache entries — *defers* (stays queued, no
        overtaking within the chosen order) until retirements return
        blocks."""
        admitted = 0
        while self.queue and self._free_slot_ids():
            r = self.queue[0]
            if not self._try_admit_one(r):
                self.deferrals += 1
                h = self.handles.get(r.rid)
                if h is not None:
                    h.deferred_ticks += 1
                    if h.deferred_ticks == 1:   # one event, not one per tick
                        self._emit(r.rid, EventType.DEFERRED,
                                   free_blocks=self.allocator.n_free)
                break
            self.queue.popleft()
            admitted += 1
        return admitted

    def _try_admit_one(self, r: GenRequest) -> bool:
        T = len(r.prompt)
        total = self._pages_needed(T, r.max_new_tokens)
        m = (self.prefix_cache.lookup(r.prompt)
             if self.prefix_cache is not None else PrefixMatch(0, []))
        shared = list(m.blocks)
        if m.tail_block is not None:
            shared.append(m.tail_block)
        # CoW: a full-prompt hit on a non-block-aligned prompt holds the
        # cached, partially-filled tail block. Its first decode write
        # (position T, only if a second token will be emitted) would land
        # in that shared block — clone it first. Full shared blocks sit
        # strictly before the write frontier and are never written.
        cow = m.tail_block is not None and r.max_new_tokens >= 2
        n_fresh = total - len(shared) + (1 if cow else 0)
        # hold the matched pages before evicting: eviction only drops the
        # *cache's* refs, so our shared pages survive it
        if shared:
            self.allocator.acquire(shared)
        if not self.allocator.can_alloc(n_fresh) and self.prefix_cache:
            self.prefix_cache.evict(n_fresh - self.allocator.n_free)
        if not self.allocator.can_alloc(n_fresh):
            if shared:
                self.allocator.release(shared)
            return False
        fresh = self.allocator.alloc(n_fresh)
        pages = list(m.blocks)
        if cow:
            dst = fresh.pop(0)
            self.pool = self.engine.copy_block(self.pool, m.tail_block, dst)
            self.allocator.release([m.tail_block])
            self.cow_copies += 1
            pages.append(dst)
        elif m.tail_block is not None:
            pages.append(m.tail_block)
        pages.extend(fresh)
        i = self._free_slot_ids()[0]
        self.page_table[i] = 0
        self.page_table[i, :len(pages)] = pages
        slot = _Slot(rid=r.rid, pos=0, last=-1, tokens=[],
                     need=r.max_new_tokens, origin=r.origin, eos=r.eos,
                     pages=pages, prompt=r.prompt, filled=m.tokens,
                     prefix_skipped=m.tokens,
                     temperature=r.temperature, seed=r.seed)
        self.slots[i] = slot
        self._emit(r.rid, EventType.ADMITTED, slot=i, server=r.origin,
                   pages=len(pages))
        if self.tracer.enabled:
            self.tracer.span(SpanKind.QUEUE_WAIT,
                             self._enq_tick.pop(r.rid, self.ticks),
                             self.ticks, rid=r.rid,
                             server=self.tracer_server, slot=i)
        if m.tokens:
            self.prefix_hits += 1
            self.prefix_tokens_skipped += m.tokens
            if self.tracer.enabled:
                self.tracer.instant(SpanKind.PREFIX_HIT, self.ticks,
                                    rid=r.rid, server=self.tracer_server,
                                    tokens_skipped=m.tokens,
                                    full_hit=m.full_hit)
            self._emit(r.rid, EventType.PREFIX_HIT, tokens_skipped=m.tokens,
                       full_hit=m.full_hit)
        if m.full_hit:
            # the whole prompt is cached: the first token is recomputed
            # from the cached last-prompt-token logits with the same
            # (seed, position)-keyed sampling rule the chunk call applies,
            # so a hit is bit-equal to running prefill
            first = sample_token_host(m.logits, r.temperature, r.seed, T - 1)
            slot.pos = T
            slot.launched = 1
            slot.final_logits = m.logits
            # seed the device decode chain too: the slot joins the decode
            # batch before any chunk call scatters a token for its row
            self._last_buf[i] = first
            self._append_token(slot, first)
            self._retire_if_done(i)
        return True

    def _admit_dense(self) -> int:
        """Prefill waiting requests into free slots (batching same-length
        prompts so each distinct length compiles once). Returns #admitted."""
        admitted = 0
        while self.queue and self._free_slot_ids():
            free = self._free_slot_ids()
            T = len(self.queue[0].prompt)
            group: list[GenRequest] = []
            rest: collections.deque = collections.deque()
            while self.queue and len(group) < len(free):
                r = self.queue.popleft()
                (group if len(r.prompt) == T else rest).append(r)
            self.queue = rest + self.queue
            tokens = np.stack([r.prompt for r in group])           # [b, T]
            logits, cache, mstats = self.engine._prefill(
                self.engine.params, tokens, self.engine.placement,
                self._origin_arg(r.origin for r in group))
            self.engine._ingest(mstats)
            self._write_rows(cache, free[:len(group)])
            lg = logits.float().cpu().numpy()                      # [b, V]
            for j, r in enumerate(group):
                first = sample_token_host(lg[j], r.temperature, r.seed,
                                          T - 1)
                slot = _Slot(rid=r.rid, pos=T, last=-1, tokens=[],
                             need=r.max_new_tokens, origin=r.origin,
                             eos=r.eos, launched=1,
                             temperature=r.temperature, seed=r.seed)
                self.slots[free[j]] = slot
                self._emit(r.rid, EventType.ADMITTED, slot=free[j],
                           server=r.origin)
                if self.tracer.enabled:
                    self.tracer.span(SpanKind.QUEUE_WAIT,
                                     self._enq_tick.pop(r.rid, self.ticks),
                                     self.ticks, rid=r.rid,
                                     server=self.tracer_server,
                                     slot=free[j])
                self._append_token(slot, first)
                self._retire_if_done(free[j])
            admitted += len(group)
        return admitted

    def _write_rows(self, cache: dict, idx: list[int]) -> None:
        """Copy a prefill cache ``[G, b, S, ...]`` into pool rows ``idx``."""
        for key, layer in cache.items():
            for name, val in layer.items():
                dst = self.pool[key][name]
                dst[:, idx] = val.to(dst.dtype)

    def _append_token(self, slot: _Slot, tok: int) -> None:
        """Record one drained token: handle events, time-to-first-token,
        and EOS stop detection (the stop shrinks ``need`` to the tokens
        already emitted, so ``_retire_if_done`` fires)."""
        slot.last = tok
        slot.tokens.append(tok)
        if len(slot.tokens) == 1:
            t0 = self._t_enqueue.pop(slot.rid, None)
            if t0 is not None:
                self.ttft_s.append(time.perf_counter() - t0)
        self._emit(slot.rid, EventType.TOKEN, token=tok)
        if (slot.eos is not None and tok == slot.eos
                and len(slot.tokens) < slot.need):
            slot.need = len(slot.tokens)

    def _retire_if_done(self, i: int) -> bool:
        slot = self.slots[i]
        if slot is not None and len(slot.tokens) >= slot.need:
            self.finished[slot.rid] = np.asarray(slot.tokens, np.int32)
            self.finished_at[slot.rid] = self.ticks
            self._emit_finished(slot)
            if self.paged and slot.pages:
                if (self.prefix_cache is not None and slot.prompt is not None
                        and slot.final_logits is not None):
                    # donate the partially-filled tail block: the slot will
                    # never write it again, and stale decode entries beyond
                    # the prompt are overwritten by any sharer before its
                    # validity mask can expose them
                    T = len(slot.prompt)
                    if T % self.block_size:
                        self.prefix_cache.insert_tail(
                            slot.prompt, slot.pages[T // self.block_size],
                            slot.final_logits)
                self.allocator.release(slot.pages)
                self.page_table[i] = 0
            self.slots[i] = None
            return True
        return False

    def _emit_finished(self, slot: _Slot) -> None:
        """FINISHED carries the per-request metrics of the API contract:
        latency/wait in scheduler ticks, locality over the request's decode
        rounds, prefix reuse and the SLO verdict."""
        h = self.handles.get(slot.rid)
        if h is None:
            return
        latency = (self.ticks - h.submitted_at
                   if h.submitted_at is not None else None)
        wait = (h.admitted_at - h.submitted_at
                if h.admitted_at is not None and h.submitted_at is not None
                else None)
        slo = h.request.slo
        h._emit(EventType.FINISHED, self.ticks,
                tokens=len(slot.tokens), origin=slot.origin,
                server=h.server, latency=latency, wait=wait,
                deferred_ticks=h.deferred_ticks,
                prefix_tokens_skipped=slot.prefix_skipped,
                local_frac=(slot.lf_sum / slot.lf_rounds
                            if slot.lf_rounds else None),
                slo=slo,
                slo_met=(bool(latency <= slo)
                         if slo is not None and latency is not None
                         else None),
                shed=False)

    # ------------------------------------------------------------------
    def _prefill_round(self) -> None:
        """Advance every prefilling slot by one block-aligned chunk per
        batched call, ``chunks_per_tick`` times. With ``compact_prefill``
        only the prefilling slots ride the call, padded to the next
        power-of-two bucket width (mirroring ``compact_decode``); otherwise
        all
        ``max_slots`` rows do. Rows without a prefilling slot write the
        null block and are masked out of the gating statistics. When a
        slot's final chunk lands, its first token is sampled, its
        block-aligned prefix enters the radix cache, and it joins the
        decode batch from the next round on. One batched host transfer of
        the final-position logits is issued per chunk call (lazily — only
        when some slot finished)."""
        bs = self.block_size
        for _ in range(self.chunks_per_tick):
            act = [i for i, s in enumerate(self.slots)
                   if s is not None and s.prefilling]
            if not act:
                return
            if self.compact_prefill:
                B = min(self.max_slots,
                        1 << max(len(act) - 1, 0).bit_length())
                row_slots: list[int | None] = act + [None] * (B - len(act))
            else:
                B = self.max_slots
                row_slots = [i if i in act else None for i in range(B)]
            rows = np.full((B,), self.max_slots, np.int32)   # pad rows ->
            #   the last-token buffer's trailing scratch entry
            toks = np.zeros((B, bs), np.int32)
            mask = np.zeros((B, bs), np.float32)
            offs = np.zeros((B,), np.int32)
            lidx = np.zeros((B,), np.int32)
            wb = np.zeros((B,), np.int32)      # idle rows -> null block 0
            tbl = np.zeros((B, self.max_pages), np.int32)
            temps = np.zeros((B,), np.float32)
            seeds = np.zeros((B,), np.uint32)
            finals: list[tuple[int, int, int]] = []   # (row, slot, rid)
            for j, i in enumerate(row_slots):
                if i is None:
                    continue
                s = self.slots[i]
                rows[j] = i
                T = len(s.prompt)
                c0 = s.filled
                valid = min(bs, T - c0)
                toks[j, :valid] = s.prompt[c0:c0 + valid]
                mask[j, :valid] = 1.0
                offs[j] = c0
                wb[j] = s.pages[c0 // bs]
                tbl[j] = self.page_table[i]
                temps[j] = s.temperature
                seeds[j] = s.seed
                final = c0 + valid >= T
                lidx[j] = (T - 1 - c0) if final else bs - 1
                s.filled += valid
                if final:
                    # launch-side bookkeeping: the slot joins this tick's
                    # decode batch (its first token is already seeded into
                    # the device last-token buffer by the chunk call)
                    s.pos = T
                    s.launched = 1
                    finals.append((j, i, s.rid))
            org = self._origin_arg(
                self.slots[i].origin if i is not None else None
                for i in row_slots)
            self._last_buf, first, logits, self.pool, mstats = self._chunk_fn(
                self.engine.params, self.pool, self._last_buf, rows, toks,
                tbl, wb, offs, lidx, self.engine.placement, mask, temps,
                seeds, org)
            self.prefill_calls += 1
            self.prefill_rows += B
            self.chunks_executed += len(act)
            if self.tracer.enabled:
                # batch-level span from launch-side metadata only (slot
                # counts, tick number — all host-known): no device reads
                self.tracer.span(SpanKind.PREFILL_CHUNK, self.ticks,
                                 self.ticks + 1, server=self.tracer_server,
                                 rows=len(act), batch=B,
                                 finals=len(finals))
            self.engine._ingest(mstats)
            if finals:
                self.host_syncs += 1
                lg = logits.float().cpu().numpy()
                fi = first.cpu().numpy()
                for j, i, rid in finals:
                    self._finish_prefill(i, rid, lg[j], int(fi[j]))

    def _finish_prefill(self, i: int, rid: int, logits_row,
                        first_tok: int) -> None:
        """Completion of one slot's prefill: first token (the
        chunk call's own sampled value — the exact token it scattered into
        the device last-token buffer, so the emitted stream and the decode
        chain can never disagree), radix-cache registration, and need==1
        retirement."""
        s = self.slots[i]
        if s is None or s.rid != rid:
            return
        row = np.asarray(logits_row)
        s.final_logits = row
        self._append_token(s, int(first_tok))
        self._cache_insert(i, row)
        self._retire_if_done(i)

    def _cache_insert(self, i: int, logits_row: np.ndarray) -> None:
        """Register a freshly prefilled prompt's block-aligned prefix (and,
        for block-aligned prompts, its last-token logits) in the radix
        cache. The partial tail block is donated only at retirement — the
        slot still decodes into it."""
        if self.prefix_cache is None:
            return
        s = self.slots[i]
        T = len(s.prompt)
        nfull = T // self.block_size
        if nfull:
            self.prefix_cache.insert_prefix(s.prompt, s.pages[:nfull])
        if T % self.block_size == 0:
            self.prefix_cache.set_logits(s.prompt, logits_row)

    def _decode_round(self) -> bool:
        """Advance every decoding slot one token in one shared decode
        batch; returns whether a round was launched. With
        ``compact_decode`` (paged mode) only the occupied slots ride the
        batch, padded up to the next power-of-two bucket — the decode fn
        specializes per bucket width, so a near-empty pool stops paying for
        ``max_slots`` rows of garbage decode. Composition is launch-driven:
        a slot rides while ``launched < need``."""
        act = [i for i, s in enumerate(self.slots)
               if s is not None and not s.prefilling
               and s.launched < s.need]
        if not act:
            return False
        self.max_concurrency = max(self.max_concurrency, len(act))
        if self.paged and self.compact_decode:
            B = min(self.max_slots, 1 << max(len(act) - 1, 0).bit_length())
            row_slots: list[int | None] = act + [None] * (B - len(act))
        else:
            B = self.max_slots
            row_slots = [i if i in act else None for i in range(B)]
        pos = np.zeros((B,), np.int32)
        mask = np.zeros((B,), np.float32)
        temps = np.zeros((B,), np.float32)
        seeds = np.zeros((B,), np.uint32)
        launched: list[tuple[int, int, int]] = []    # (row, slot, rid)
        for j, i in enumerate(row_slots):
            if i is None:
                continue
            s = self.slots[i]
            pos[j] = s.pos
            mask[j] = 1.0
            temps[j] = s.temperature
            seeds[j] = s.seed
            s.pos += 1
            s.launched += 1
            launched.append((j, i, s.rid))
        if self.tracer.enabled:
            # launch-side metadata only (see _prefill_round)
            self.tracer.span(SpanKind.DECODE_ROUND, self.ticks,
                             self.ticks + 1, server=self.tracer_server,
                             rows=len(act), batch=B)
        org = self._origin_arg(
            self.slots[i].origin if i is not None else None
            for i in row_slots)
        # padding/vacant rows decode garbage tokens whose outputs are
        # discarded; the token mask keeps them out of the gating statistics
        if self.paged:
            # non-decoding rows (padding, vacant OR still prefilling) get
            # an all-null page table so their garbage write lands in the
            # reserved null block instead of a live page; their last-token
            # gathers/scatters hit the buffer's trailing scratch entry
            rows = np.full((B,), self.max_slots, np.int32)
            tbl = np.zeros((B, self.max_pages), np.int32)
            for j, i in enumerate(row_slots):
                if i is not None:
                    rows[j] = i
                    tbl[j] = self.page_table[i]
            self._last_buf, nxt, self.pool, mstats = self._decode_fn(
                self.engine.params, self.pool, self._last_buf, rows, pos,
                tbl, self.engine.placement, mask, temps, seeds, org)
            self.decode_rows += B
            self.engine._ingest(mstats)
            self.host_syncs += 1
            self._drain_tokens(launched, nxt.cpu().numpy(),
                               self._round_local_frac(mstats))
        else:
            cur = np.zeros((B, 1), np.int32)
            for j, i in enumerate(row_slots):
                if i is not None:
                    cur[j, 0] = self.slots[i].last
            logits, self.pool, mstats = self.engine._decode(
                self.engine.params, self.pool, cur, pos,
                self.engine.placement, mask, org)
            self.decode_rows += B
            self.engine._ingest(mstats)
            self.host_syncs += 1
            nxt = sample_tokens(logits, temps, seeds, pos).cpu().numpy()
            self._drain_tokens(launched, nxt,
                               self._round_local_frac(mstats))
        self.rounds += 1
        self._maybe_review()
        return True

    @staticmethod
    def _round_local_frac(mstats) -> float | None:
        """The round's mean local-dispatch fraction, computed from that
        round's *own* gating stats (not the engine's shared
        ``last_local_frac``, which another sharer of the engine may have
        moved)."""
        if mstats is None or "local_frac" not in mstats:
            return None
        return float(mstats["local_frac"].mean())

    def _drain_tokens(self, rows, nxt: np.ndarray,
                      lf: float | None) -> None:
        """Apply one decode round's tokens to the slots that launched them
        (rid-guarded: a retired or re-assigned slot drops its token).
        ``lf`` is the round's own local fraction (``_round_local_frac``)."""
        for j, i, rid in rows:
            slot = self.slots[i]
            if slot is None or slot.rid != rid:
                continue
            if len(slot.tokens) >= slot.need:
                continue
            self._append_token(slot, int(nxt[j]))
            if lf is not None:
                slot.lf_sum += lf
                slot.lf_rounds += 1
            self._retire_if_done(i)

    def _maybe_review(self) -> None:
        ctrl = self.controller
        if ctrl is None:
            return
        dec = ctrl.review_and_apply(self.rounds, self.engine)
        if dec is not None and dec.applied:
            self.migrations.append(dec.diag)

    # ------------------------------------------------------------------
    def drop_prefix_cache(self) -> int:
        """Evict every cached prefix and return the blocks recycled (tests
        and memory-pressure escape hatch)."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.clear()

    def check_invariants(self) -> None:
        """Paged-pool structural invariants (used by the test suite):
        refcounts exactly match the holders (slots + radix cache), the
        null block is never allocated, no slot holds a page twice, and the
        next block each live slot will *write* is exclusively owned
        (refcount 1) — the no-CoW-aliasing rule."""
        if not self.paged:
            return
        live = self.allocator.live()
        assert 0 not in live, "null block was allocated"
        held: collections.Counter = collections.Counter()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            assert len(set(s.pages)) == len(s.pages), \
                f"slot {i} holds a duplicated page: {s.pages}"
            for b in s.pages:
                held[b] += 1
                assert b in live, f"slot {i} references freed block {b}"
            if s.prefilling:
                frontier = s.pages[s.filled // self.block_size]
            elif s.launched < s.need:
                # fully-launched slots awaiting drain are skipped: their
                # pos may sit one past capacity (nothing writes there)
                frontier = s.pages[s.pos // self.block_size]
            else:
                continue
            assert live.get(frontier) == 1, (
                f"write frontier block {frontier} of rid {s.rid} is shared "
                f"(refcount {live.get(frontier)}) — CoW rule violated")
        cache_refs = (self.prefix_cache.block_refs()
                      if self.prefix_cache is not None
                      else collections.Counter())
        for b, rc in live.items():
            expect = held[b] + cache_refs[b]
            assert rc == expect, (
                f"block {b}: refcount {rc} != {held[b]} slot refs + "
                f"{cache_refs[b]} cache refs")
        assert set(held) | set(cache_refs) == set(live), \
            "allocator tracks blocks held by no slot and no cache entry"

    def step(self) -> bool:
        """One scheduler tick: admit what fits, advance chunked prefills,
        run one decode round. Returns True while there is (or was) work."""
        had_work = bool(self.queue) or self.active > 0
        self.ticks += 1
        self._admit()
        if self.paged:
            self._prefill_round()
        t0 = time.perf_counter()
        launched = self._decode_round()
        if launched:
            self.decode_round_s.append(time.perf_counter() - t0)
        return had_work

    def flush(self) -> None:
        """Drain the backlog of launched rounds: a no-op, since every round
        of the synchronous loop is applied before ``step()`` returns."""

    def run(self) -> dict[int, np.ndarray]:
        """Serve until queue and slots drain; returns {rid: tokens}."""
        while self.queue or self.active:
            self.step()
        return dict(self.finished)
