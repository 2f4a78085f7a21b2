"""The port's radix prefix cache evicts as the reference's does
(``repro.serving.prefix_cache``, whose eviction walks the whole trie again
for every pass): the same entries in the same order, the same blocks
recycled, on random streams of inserts, lookups, shared blocks and
evictions, with long cached prompts (chains of many blocks, where a pass
frees one block a prompt) and tails."""

import numpy as np
import pytest

from repro.serving.prefix_cache import RadixPrefixCache as RefCache
from repro.serving.runtime import BlockAllocator as RefAllocator
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.runtime import BlockAllocator

BS = 4


def _state(cache, alloc):
    """The trie (every path's block, last use and logits flag, every tail)
    and the allocator's free list and refcounts."""
    out = []
    stack = [(cache.root, ())]
    while stack:
        n, path = stack.pop()
        for key, t in n.tails.items():
            out.append(("tail", path, key, t.block, t.last_use))
        for key, c in n.children.items():
            out.append(("node", path + (key,), c.block, c.last_use,
                        c.logits is not None))
            stack.append((c, path + (key,)))
    refs = [alloc.refcount(b) for b in range(1, alloc.n_blocks)]
    return sorted(out), alloc.n_free, refs


@pytest.mark.parametrize("seed", range(6))
def test_eviction_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    n_blocks = 400
    port, ref = BlockAllocator(n_blocks), RefAllocator(n_blocks)
    pair = [(RadixPrefixCache(BS, port), port), (RefCache(BS, ref), ref)]
    docs = [rng.integers(0, 3, rng.integers(8, 120)).astype(np.int32)
            for _ in range(12)]
    held = [[], []]  # blocks a "live slot" shares, per side
    for step in range(160):
        op = rng.integers(0, 10)
        doc = docs[rng.integers(len(docs))]
        prompt = np.concatenate([doc, rng.integers(0, 3, rng.integers(0, 9))
                                 .astype(np.int32)])
        if op < 5:  # a prompt's blocks are inserted, maybe its tail too
            n = len(prompt) // BS
            for cache, alloc in pair:
                m = cache.lookup(prompt)
                fresh = max(0, n - len(m.blocks))
                if alloc.n_free < fresh + 1:
                    cache.evict(fresh + 1 - alloc.n_free)
                if alloc.n_free < fresh + 1:
                    continue
                blocks = m.blocks[:n] + alloc.alloc(fresh)
                cache.insert_prefix(prompt, blocks)
                alloc.release(blocks[len(m.blocks):])
                if len(prompt) % BS and op < 2:
                    tail = alloc.alloc(1)[0]
                    cache.insert_tail(prompt, tail, np.zeros(3))
                    alloc.release([tail])
        elif op < 7:  # a lookup refreshes a path
            for cache, _ in pair:
                cache.lookup(prompt)
        elif op < 8:  # a live slot shares a matched prefix (or lets go)
            let_go = rng.random() < 0.5
            for side, (cache, alloc) in enumerate(pair):
                if held[side] and let_go:
                    alloc.release(held[side])
                    held[side] = []
                else:
                    m = cache.lookup(prompt)
                    alloc.acquire(m.blocks)
                    held[side] += m.blocks
        else:
            n = int(rng.integers(1, 200))
            got = [cache.evict(n, force=op == 9 and step % 7 == 0)
                   for cache, _ in pair]
            assert got[0] == got[1]
        assert _state(*pair[0]) == _state(*pair[1]), step
        assert pair[0][0].evictions == pair[1][0].evictions
    assert pair[0][0].evictions > 100  # many passes over long chains


def _stamp(cache, fn):
    """Set every entry's last use to ``fn(last use)``."""
    stack = [cache.root]
    while stack:
        n = stack.pop()
        for t in n.tails.values():
            t.last_use = fn(t.last_use)
        for c in n.children.values():
            c.last_use = fn(c.last_use)
            stack.append(c)


@pytest.mark.parametrize("buckets", [1, 3])
def test_eviction_breaks_ties_as_the_reference(buckets):
    """Leaves last used at once (every stamp folded into ``buckets``
    values) are evicted in the reference's walk order: branching prompts
    with tails, evicted tens of blocks a call (several passes, whose later
    leaves the drops exposed) down to nothing."""
    rng = np.random.default_rng(buckets)
    port, ref = BlockAllocator(600), RefAllocator(600)
    pair = [(RadixPrefixCache(BS, port), port), (RefCache(BS, ref), ref)]
    stems = [rng.integers(0, 3, 24).astype(np.int32) for _ in range(4)]
    for k in range(30):
        prompt = np.concatenate([stems[k % 4], rng.integers(
            0, 3, rng.integers(1, 40)).astype(np.int32)])
        n = len(prompt) // BS
        for cache, alloc in pair:
            m = cache.lookup(prompt)
            blocks = m.blocks[:n] + alloc.alloc(n - len(m.blocks))
            cache.insert_prefix(prompt, blocks)
            alloc.release(blocks[len(m.blocks):])
            if len(prompt) % BS:
                tail = alloc.alloc(1)[0]
                cache.insert_tail(prompt, tail, np.zeros(3))
                alloc.release([tail])
    for cache, _ in pair:
        _stamp(cache, lambda t: t % buckets)
    while pair[1][1].n_free < 599:
        n = int(rng.integers(10, 80))  # several passes a call
        assert pair[0][0].evict(n) == pair[1][0].evict(n)
        assert _state(*pair[0]) == _state(*pair[1])
