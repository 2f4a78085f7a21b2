"""Radix (token-trie) prefix cache over a paged KV block pool.

Edge request streams are dominated by shared system prompts and few-shot
templates, so consecutive prompts overlap heavily. Because k/v at position
``i`` depend only on tokens ``0..i``, two prompts with a common prefix have
*bit-identical* KV entries for every shared position — the cache exploits
this by mapping block-aligned prompt prefixes to the physical blocks that
already hold their k/v, so a new request skips prefill for every shared
page.

Structure (block granularity — only whole ``block_size``-token blocks are
reusable, since pages are the pool's unit of sharing):

* a trie whose edges are whole-block token runs: node ``n`` at depth ``j``
  holds the physical block for prompt positions ``j*bs .. (j+1)*bs - 1`` of
  every prompt whose first ``(j+1)*bs`` tokens spell the path to ``n``;
* per-node **tail entries**: a prompt whose length is not block-aligned
  ends in a partially-filled block; its remainder tokens key a tail entry
  holding that block plus the last-prompt-token logits, so an *identical*
  prompt skips prefill entirely (the first generated token is recomputed
  from the cached logits — greedy argmax, bit-equal to the live path);
* block-aligned full prompts attach their logits to the trie node itself.

Reference counting: the cache holds exactly one ``BlockAllocator`` ref per
node/tail entry. Live slots that share a cached block hold their own refs,
so a block is recycled only when the last holder (cache or slot) releases
it. **Cached blocks are never written**: a sharer that must write into a
partially-filled shared tail block gets a copy-on-write clone first (see
``ServingRuntime._admit_paged``); full shared blocks sit strictly before
any sharer's write frontier.

Eviction is LRU over leaves (tail entries and childless nodes), so a prefix
is never orphaned from its extension, and it skips entries whose block a
live slot still shares — evicting those would free no memory while
destroying reuse. Evicting an entry drops the cache's ref and recycles the
block immediately.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools

import numpy as np


@dataclasses.dataclass
class PrefixMatch:
    """Result of a cache lookup.

    tokens:     prompt tokens covered by the match (block-aligned, except
                for a full-prompt hit where it equals the prompt length).
    blocks:     physical blocks of the matched *full* blocks, logical order.
    tail_block: the shared partially-filled tail block (full-prompt hits on
                non-block-aligned prompts only; requires CoW before any
                write).
    logits:     cached last-prompt-token logits (full-prompt hits only).
    """
    tokens: int
    blocks: list
    tail_block: int | None = None
    logits: np.ndarray | None = None

    @property
    def full_hit(self) -> bool:
        return self.logits is not None


class _Tail:
    __slots__ = ("block", "logits", "last_use")

    def __init__(self, block: int, logits: np.ndarray, last_use: int):
        self.block = block
        self.logits = logits
        self.last_use = last_use


class _Node:
    __slots__ = ("key", "block", "children", "tails", "logits", "parent",
                 "last_use")

    def __init__(self, key: bytes, block: int | None, parent):
        self.key = key                 # this node's block-token run (bytes)
        self.block = block             # physical block id (None: root)
        self.children: dict = {}       # next-block token run -> _Node
        self.tails: dict = {}          # remainder token run -> _Tail
        self.logits = None             # last-token logits of the
        #                                block-aligned prompt ending here
        self.parent = parent
        self.last_use = 0


class RadixPrefixCache:
    """Token-trie prefix cache; one allocator ref per cached block."""

    def __init__(self, block_size: int, allocator):
        self.block_size = block_size
        self.allocator = allocator
        self.root = _Node(b"", None, None)
        self._clock = 0
        self.evictions = 0             # entries evicted (for metrics)

    # -- internal walks ------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, p: np.ndarray, *, create_blocks=None):
        """Walk (optionally extending with ``create_blocks``) the full-block
        path of prompt ``p``. Returns (node, matched_tokens, blocks)."""
        bs = self.block_size
        now = self._tick()
        node, k, blocks = self.root, 0, []
        j = 0
        while k + bs <= len(p):
            key = p[k:k + bs].tobytes()
            child = node.children.get(key)
            if child is None:
                if create_blocks is None or j >= len(create_blocks):
                    break
                child = _Node(key, int(create_blocks[j]), node)
                self.allocator.acquire([child.block])
                node.children[key] = child
            child.last_use = now
            node, k = child, k + bs
            blocks.append(child.block)
            j += 1
        return node, k, blocks

    # -- queries -------------------------------------------------------
    def lookup(self, prompt) -> PrefixMatch:
        """Longest block-aligned cached prefix of ``prompt`` (full-prompt
        hits also return the tail block / logits). A block-aligned full-walk
        without cached logits backs off one block: the final prompt token
        must be recomputed to produce the first sampled token."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        node, k, blocks = self._walk(p)
        if k == len(p):
            if node.logits is not None:
                return PrefixMatch(k, blocks, None, node.logits)
            if blocks:
                blocks.pop()
                k -= self.block_size
            return PrefixMatch(k, blocks)
        tail = node.tails.get(p[k:].tobytes())
        if tail is not None:
            tail.last_use = self._clock
            return PrefixMatch(len(p), blocks, tail.block, tail.logits)
        return PrefixMatch(k, blocks)

    # -- insertion -----------------------------------------------------
    def insert_prefix(self, prompt, blocks) -> None:
        """Register the block-aligned prefix of ``prompt`` (``len(blocks)``
        full blocks). Existing trie nodes win — only missing nodes take a
        ref on the corresponding entry of ``blocks``."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        self._walk(p[:len(blocks) * self.block_size], create_blocks=blocks)

    def set_logits(self, prompt, logits) -> None:
        """Attach last-token logits to a block-aligned full prompt (its
        prefix path must already be inserted)."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        node, k, _ = self._walk(p)
        if k == len(p) and node is not self.root and node.logits is None:
            node.logits = np.asarray(logits, np.float32).copy()

    def insert_tail(self, prompt, tail_block: int, logits) -> bool:
        """Register the partially-filled tail block of a finished request
        (called at retirement — the owner will never write it again). Takes
        a ref on ``tail_block``; no-op when an identical tail is cached."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        rem = len(p) % self.block_size
        if rem == 0:
            return False
        node, k, _ = self._walk(p)
        if k != len(p) - rem:          # prefix path incomplete (evicted)
            return False
        key = p[k:].tobytes()
        if key in node.tails:
            return False
        node.tails[key] = _Tail(int(tail_block),
                                np.asarray(logits, np.float32).copy(),
                                self._clock)
        self.allocator.acquire([int(tail_block)])
        return True

    # -- eviction ------------------------------------------------------
    def _leaves(self):
        """All evictable entries, (last_use, place, kind, node, key), and
        the place of every node. A place numbers the entries as a walk of
        the trie lists them (it pops the nodes from a stack; a node lists
        its tails, then its children, in dict order), so sorting by
        (last_use, place) orders them as the reference's eviction does;
        removing leaves keeps the order of what remains."""
        out, place, count = [], {}, itertools.count()
        stack = [self.root]
        while stack:
            n = stack.pop()
            for key, t in n.tails.items():
                out.append((t.last_use, next(count), "tail", n, key))
            for key, c in n.children.items():
                place[id(c)] = next(count)
                if not c.children and not c.tails:
                    out.append((c.last_use, place[id(c)], "node", n, key))
                stack.append(c)
        return out, place

    def evict(self, n_blocks: int, *, force: bool = False) -> int:
        """Drop LRU leaf entries until ``n_blocks`` physical blocks were
        recycled or nothing evictable remains. Entries whose block is still
        shared with a live slot (refcount > 1) are *skipped* — evicting
        them frees no memory and only destroys reuse (admission acquires
        its matched pages before evicting, so a hit's own prefix is always
        protected). ``force=True`` drops shared entries too (``clear``).
        Returns the number of blocks recycled.

        Each pass takes the evictable leaves at its start, oldest first
        (ties in the walk's order), and drops them in turn; when a pass
        drops them all, the next takes the leaves left: this pass's kept
        ones and the nodes its drops left childless. The trie is walked
        once a call. (Walking it again for every pass cost time quadratic
        in a long prompt's blocks: a pass frees one block of each cached
        prompt.)"""
        def block(entry):
            _, _, kind, parent, key = entry
            return (parent.tails[key] if kind == "tail"
                    else parent.children[key]).block

        def evictable(entry):
            return force or self.allocator.refcount(block(entry)) == 1

        leaves, place = self._leaves()
        freed = 0
        while freed < n_blocks:
            live = [e for e in leaves if evictable(e)]
            if not live:
                break
            kept = [e for e in leaves if not evictable(e)]
            live.sort(key=lambda e: e[:2])
            for _, _, kind, parent, key in live:
                if kind == "tail":
                    t = parent.tails.pop(key)
                    freed += self.allocator.release([t.block])
                else:
                    c = parent.children.pop(key)
                    freed += self.allocator.release([c.block])
                self.evictions += 1
                if (parent is not self.root and not parent.children
                        and not parent.tails):
                    kept.append((parent.last_use, place[id(parent)], "node",
                                 parent.parent, parent.key))
                if freed >= n_blocks:
                    break
            leaves = kept
        return freed

    def clear(self) -> int:
        """Evict everything, shared or not (tests / shutdown). Returns
        blocks recycled."""
        freed = 0
        while True:
            got = self.evict(1 << 30, force=True)
            freed += got
            if not self._leaves()[0]:
                return freed

    # -- introspection -------------------------------------------------
    def block_refs(self) -> collections.Counter:
        """Physical block -> number of cache refs held on it (0/1 each —
        every cached block backs exactly one node or tail entry)."""
        refs: collections.Counter = collections.Counter()
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.block is not None:
                refs[n.block] += 1
            for t in n.tails.values():
                refs[t.block] += 1
            stack.extend(n.children.values())
        return refs

    @property
    def held_blocks(self) -> int:
        return sum(self.block_refs().values())
