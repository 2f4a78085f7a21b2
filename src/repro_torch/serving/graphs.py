"""The CUDA-graph ladder of the paged serving steps: the port's counterpart
of the reference's ahead-of-time compiled executables
(``repro.serving.engine.ServingEngine.warmup_paged``).

A ladder point is one ``torch.cuda.CUDAGraph`` of a prefill-chunk or decode
step at one compaction bucket width and origin mode, or of the
copy-on-write block clone. A graph replays the kernels its capture
recorded on the addresses its capture saw, so each point is captured over

* static inputs: one int32 device tensor that packs every per-round input
  of the step (``rows``, ``toks``, ``tbl``, ..., the per-row sampling
  temperatures and seeds — ``input_layout``), filled by one host-to-device
  copy before each replay;
* the runtime's live KV pool and last-token buffer (a ``Bank``), which the
  step updates in place;
* the engine's weights and placement tables, which ``ServingEngine.migrate``
  therefore rewrites in place;
* static outputs (the sampled tokens, the final-position logits, the
  gating statistics), which the next replay of the same graph overwrites.

Replays run no Python, so the kernel wrappers' launch counters do not see
them: each graph records the launches of its capture and adds them on
every replay (``kernels.ops.add_launch_counts``). A ladder captured for a
traced runtime (``Bank.marks``) also holds the phase marks
(``kernels.ops.phase_mark``), which no launch counter counts.

Two host-side rings serve the zero-stall loop (``ServingRuntime(warmup=
True)``): ``Stager`` holds the pinned buffers the inputs are copied from,
``HostRing`` the pinned buffers a round's outputs are copied into. Both
are allocated at warmup, so a round calls no ``cudaHostAlloc``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.kernels import ops

TAG_MODES = {"both": (False, True), "tagged": (True,), "untagged": (False,)}
WARM_ITERS = 2  # eager runs on a side stream before each capture
RING = 2        # pinned output sets allocated per ladder point at warmup
STAGES = 8      # pinned input buffers in the staging ring


def ladder_widths(max_slots: int) -> list[int]:
    """Compaction bucket widths: the powers of two below ``max_slots``,
    then ``max_slots`` itself."""
    widths, w = [], 1
    while w < max_slots:
        widths.append(w)
        w <<= 1
    return widths + [max_slots]


def ladder_keys(max_slots: int, origins: str = "both") -> list[tuple]:
    """Every ladder point, as the reference counts them: ``(kind, B,
    tagged)`` for kind in chunk, dec, each bucket width and origin mode,
    then ``("copy",)`` for the block clone."""
    if origins not in TAG_MODES:
        raise ValueError(f"origins must be one of {sorted(TAG_MODES)}, "
                         f"got {origins!r}")
    keys = [(kind, B, tagged) for B in ladder_widths(max_slots)
            for tagged in TAG_MODES[origins] for kind in ("chunk", "dec")]
    return keys + [("copy",)]


def input_layout(kind: str, B: int, block_size: int, max_pages: int,
                 tagged: bool) -> dict:
    """``{name: (offset, shape, dtype)}`` of one step's inputs inside its
    packed int32 buffer. float32 inputs (the token mask, the per-row
    temperatures) are stored as their bits, uint32 ones (the per-row
    sampling seeds) as the int32 of the same bits: the buffer carries
    both unrounded."""
    f32, i32, u32 = torch.float32, torch.int32, torch.uint32
    if kind == "chunk":
        fields = [("rows", (B,), i32), ("toks", (B, block_size), i32),
                  ("tbl", (B, max_pages), i32), ("wb", (B,), i32),
                  ("offs", (B,), i32), ("lidx", (B,), i32),
                  ("mask", (B, block_size), f32)]
    elif kind == "dec":
        fields = [("rows", (B,), i32), ("pos", (B,), i32),
                  ("tbl", (B, max_pages), i32), ("mask", (B,), f32)]
    else:
        raise ValueError(kind)
    fields += [("temps", (B,), f32), ("seeds", (B,), u32)]
    if tagged:
        fields.append(("org", (B,), i32))
    out, off = {}, 0
    for name, shape, dtype in fields:
        out[name] = (off, shape, dtype)
        off += int(np.prod(shape))
    return out


def layout_size(layout: dict) -> int:
    return max(off + int(np.prod(shape)) for off, shape, _ in layout.values())


def input_views(static: torch.Tensor, layout: dict) -> dict:
    """The named inputs as views into the packed buffer (a uint32 input
    stays an int32 view of its bits: ``sampling`` reads it as uint32)."""
    views = {}
    for name, (off, shape, dtype) in layout.items():
        v = static[off:off + int(np.prod(shape))]
        views[name] = (v.view(dtype) if dtype == torch.float32 else v).view(
            shape)
    return views


def pack(layout: dict, arrays: dict, out: np.ndarray) -> None:
    """Write host ``arrays`` into the int32 array ``out`` at ``layout``."""
    for name, (off, shape, dtype) in layout.items():
        a = np.asarray(arrays[name])
        n = int(np.prod(shape))
        if dtype == torch.float32:
            out[off:off + n] = a.astype(np.float32).reshape(-1).view(np.int32)
        elif dtype == torch.uint32:
            out[off:off + n] = a.astype(np.uint32).reshape(-1).view(np.int32)
        else:
            out[off:off + n] = a.reshape(-1)


def flat_outputs(kind: str, out) -> dict:
    """The tensors of a step's outputs (``(tokens, logits, mstats)``) that
    the host drains: the sampled tokens, for a chunk also the
    final-position logits, and the gating statistics it ingests (none for
    a model without MoE layers)."""
    if kind == "dec":
        nxt, _, mstats = out
        flat = {"nxt": nxt}
    else:
        first, logits, mstats = out
        flat = {"first": first, "logits": logits}
    if mstats is not None:
        flat["counts_per_rank"] = mstats["counts_per_rank"]
        flat["local_frac"] = mstats["local_frac"]
    return flat


class StepGraph:
    """One captured ladder point. ``replay()`` runs it on whatever
    ``inputs`` hold; its results are in ``outputs`` until the next
    replay."""

    def __init__(self, key, layout, static, inputs, graph, outputs,
                 launches, binding, pool=None, tail=None):
        self.key = key
        self.tail = tail          # the sampling tail's graph, or None
        self.pool = pool          # the KV pool it updates (its bank's)
        self.layout = layout      # None for the block clone
        self.static = static
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.launches = launches  # kernel launches of one replay
        self.binding = binding    # the engine's and the pool's tensor
        #   addresses at capture

    @classmethod
    def capture(cls, key, layout, static, run, *, mempool, binding,
                pool=None, tail=None):
        """Capture ``run(inputs)`` (which reads the views of ``static``)
        and, if given, ``tail(inputs, outputs)`` as a second graph over
        its outputs, which ``replay(sample=True)`` runs after it.
        ``static`` holds padding inputs that touch only the null block and
        the last-token buffer's scratch entry: the eager warm-up runs on a
        side stream, as PyTorch's graph capture requires (lazy library
        state, the kernels' one-time attribute setup), never touch a live
        page. A capture that fails raises: there is no eager fallback."""
        inputs = input_views(static, layout) if layout is not None else {
            "src": static[0:1], "dst": static[1:2]}
        graph = torch.cuda.CUDAGraph()
        ctx = torch.cuda.graph(graph, pool=mempool)
        # warm up on the capture stream itself: one stream for every
        # capture in the process (PyTorch keeps a cuBLAS workspace per
        # stream for the life of the process; a fresh side stream per
        # capture would leave one behind per graph)
        side, cur = ctx.capture_stream, torch.cuda.current_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARM_ITERS):
                run(inputs)
        cur.wait_stream(side)
        before = ops.launch_counts()
        with ctx:
            outputs = run(inputs)
        after = ops.launch_counts()
        launches = {k: v - before[k] for k, v in after.items()
                    if v != before[k]}
        ops.add_launch_counts(launches, -1)   # the capture launched nothing
        tail_graph = None
        if tail is not None:
            tail_graph = torch.cuda.CUDAGraph()
            tctx = torch.cuda.graph(tail_graph, pool=mempool)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                tail(inputs, outputs)
            cur.wait_stream(side)
            with tctx:
                tail(inputs, outputs)
        return cls(key, layout, static, inputs, graph, outputs, launches,
                   binding, pool, tail_graph)

    def replay(self, sample: bool = False) -> None:
        """Replay the step; with ``sample``, its sampling tail after it."""
        self.graph.replay()
        if sample and self.tail is not None:
            self.tail.replay()
        ops.add_launch_counts(self.launches)


class Bank:
    """The buffers one ladder is captured over — a runtime's KV pool and
    last-token buffer — and its graphs, keyed like ``ladder_keys``. A bank
    serves one live runtime at a time (``owner``); when that runtime is
    gone, a new runtime of the same geometry may lease its buffers and
    replay its graphs without capturing again."""

    def __init__(self, geometry: tuple, pool, last_buf, owner=None,
                 marks: bool = False):
        self.geometry = geometry  # (block_size, max_pages, max_slots,
        #   n_blocks)
        self.pool = pool
        self.last_buf = last_buf
        self.marks = marks        # the graphs hold the phase marks
        self.graphs: dict = {}
        self._owner = weakref.ref(owner) if owner is not None else None

    def lease(self, owner) -> bool:
        """Hand the bank to ``owner`` if no live runtime holds it."""
        if self._owner is not None and self._owner() is not None:
            return False
        self._owner = weakref.ref(owner)
        return True


class Stager:
    """Pinned host buffers the packed inputs are copied from.

    Hazard (b): a non-blocking host-to-device copy from pinned memory reads
    the buffer when the stream reaches the copy, not when it is enqueued.
    The host must not refill a buffer for a later round before then, so
    the buffers form a ring, each with an event recorded after its copy;
    a buffer is refilled only once its event has completed."""

    def __init__(self, size: int):
        self.bufs = [torch.empty((size,), dtype=torch.int32, pin_memory=True)
                     for _ in range(STAGES)]
        self.events = [None] * STAGES
        self.i = 0

    def load(self, g: StepGraph, arrays: dict) -> None:
        k = self.i
        self.i = (k + 1) % STAGES
        if self.events[k] is not None:
            self.events[k].synchronize()   # long done: STAGES rounds ago
        buf = self.bufs[k]
        n = g.static.numel()
        pack(g.layout, arrays, buf.numpy()[:n])
        g.static.copy_(buf[:n], non_blocking=True)
        ev = self.events[k] or torch.cuda.Event()
        ev.record()
        self.events[k] = ev


class HostRing:
    """Pinned copies of one ladder point's outputs, a free list of them.

    Hazard (a): the next replay of the same graph overwrites its static
    outputs, so the copy out of them must be ordered before that replay.
    Both run on the serving stream, where the order of enqueueing is the
    order of execution: ``copy`` enqueues the copies right after the
    replay. (A copy on a side stream would need an event each way.) An
    entry goes back on the free list only when the host has drained it."""

    def __init__(self, like: dict, n: int = RING):
        self.like = {k: (tuple(v.shape), v.dtype) for k, v in like.items()}
        self.free = [self._new() for _ in range(n)]

    def _new(self):
        bufs = {k: torch.empty(shape, dtype=dt, pin_memory=True)
                for k, (shape, dt) in self.like.items()}
        return bufs, torch.cuda.Event()

    def copy(self, flat: dict, names) -> tuple:
        """Start the device-to-host copies of ``names`` of ``flat``; returns
        the entry (pinned buffers, the event recorded after them)."""
        entry = self.free.pop() if self.free else self._new()
        bufs, ev = entry
        for k in names:
            bufs[k].copy_(flat[k], non_blocking=True)
        ev.record()
        return entry

    def release(self, entry) -> None:
        self.free.append(entry)
