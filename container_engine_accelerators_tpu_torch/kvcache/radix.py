# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Block-granular radix tree over cached KV prefixes.

Copy of ``container_engine_accelerators_tpu/kvcache/radix.py`` (the port
imports nothing of the JAX package); the contracts are the same.

The SGLang RadixAttention shape at block granularity: each node maps
one *full block* of tokens (a ``block_size``-tuple edge label) to the
physical block holding that span's K/V, and a path from the root
spells a cached prefix. Admission walks the prompt's full blocks down
the tree (:meth:`RadixIndex.match`) and maps every matched block into
the new slot's page table — those tokens skip prefill entirely.
Retirement inserts the request's full blocks (:meth:`RadixIndex
.insert`), adopting its blocks into the tree or discarding duplicates
when an identical prefix already resides.

Every node holds one pool ref on its block. Eviction
(:meth:`RadixIndex.evict`) walks leaves in LRU order and drops nodes
whose block has no other owner (refcount 1 — cached but unused);
blocks also referenced by a running slot are never evicted. Evicting a
leaf can expose its parent as the next candidate, so eviction
iterates until the request is met or nothing is evictable.

Determinism: the LRU clock is a monotone counter bumped per
match/insert, so eviction order is a pure function of the request
sequence.
"""


class _Node:
    __slots__ = ("children", "block", "parent", "key", "last_use")

    def __init__(self, parent=None, key=None, block=None):
        self.children = {}  # block-token tuple -> _Node
        self.parent = parent
        self.key = key
        self.block = block
        self.last_use = 0


class RadixIndex:
    def __init__(self, block_size):
        self.block_size = block_size
        self._root = _Node()
        self._clock = 0
        self._nodes = 0
        # Running eviction count for the engine's counter.
        self.evictions = 0

    def __len__(self):
        return self._nodes

    def _tick(self):
        self._clock += 1
        return self._clock

    def _blocks_of(self, tokens):
        bs = self.block_size
        n = len(tokens) // bs
        return [tuple(tokens[i * bs:(i + 1) * bs]) for i in range(n)]

    # -- lookup ---------------------------------------------------------------

    def match(self, tokens):
        """Longest cached prefix of ``tokens`` in FULL blocks: returns
        the list of physical block ids (possibly empty). Bumps the
        matched path's LRU clocks; takes NO refs — the caller maps the
        blocks into a page table and refs them there."""
        now = self._tick()
        node = self._root
        out = []
        for key in self._blocks_of(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            out.append(child.block)
            node = child
        return out

    # -- insertion ------------------------------------------------------------

    def insert(self, tokens, block_ids, pool):
        """Cache ``tokens``'s full blocks, whose K/V live in
        ``block_ids`` (one id per full block, the retiring slot's page
        table). For spans already cached, the slot's duplicate block is
        redundant — it keeps the tree's copy and the caller's per-slot
        ref is simply dropped by the caller as usual. For new spans the
        tree takes its OWN ref on the slot's block (the slot's ref is
        still the caller's to drop). Returns the number of newly
        adopted blocks."""
        now = self._tick()
        node = self._root
        adopted = 0
        for i, key in enumerate(self._blocks_of(tokens)):
            if i >= len(block_ids):
                break
            child = node.children.get(key)
            if child is None:
                child = _Node(parent=node, key=key, block=block_ids[i])
                pool.ref(block_ids[i])
                node.children[key] = child
                self._nodes += 1
                adopted += 1
            child.last_use = now
            node = child
        return adopted

    # -- eviction -------------------------------------------------------------

    def _leaves(self):
        out = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                else:
                    out.append(c)
        return out

    def evict(self, pool, need):
        """Free at least ``need`` blocks by dropping LRU leaves whose
        block has no owner besides the tree (refcount 1). Returns the
        number of blocks actually freed (may be < need when the rest of
        the tree is pinned by running slots).

        One leaf collection per call, then a heap: evicting a leaf may
        expose its parent as the next candidate, which is pushed
        incrementally — O((n + evicted) log n) instead of a full-tree
        rescan per freed block (this runs on the engine loop's hot
        path under cache pressure). Refcounts cannot change mid-call
        (single-writer), so a pinned candidate can be skipped
        permanently: a slot-referenced
        leaf always has slot-referenced ancestors (matching maps the
        whole path), so nothing evictable hides behind it."""
        import heapq

        freed = 0
        heap = [
            (leaf.last_use, leaf.block, leaf) for leaf in self._leaves()
        ]
        heapq.heapify(heap)
        while freed < need and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.children or \
                    victim.parent.children.get(victim.key) is not victim:
                continue  # stale entry
            if pool.refcount(victim.block) != 1:
                continue  # pinned by a running slot for this call
            victim.parent.children.pop(victim.key)
            self._nodes -= 1
            self.evictions += 1
            if pool.unref(victim.block):
                freed += 1
            parent = victim.parent
            if parent is not self._root and not parent.children:
                heapq.heappush(
                    heap, (parent.last_use, parent.block, parent)
                )
        return freed

    def clear(self, pool):
        """Drop every node (engine cache reset): unref all tree-held
        blocks."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            pool.unref(n.block)
        self._root = _Node()
        self._nodes = 0
