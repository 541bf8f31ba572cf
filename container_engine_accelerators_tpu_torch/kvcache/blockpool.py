# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Ref-counted fixed-size KV block pool (host side).

Copy of ``container_engine_accelerators_tpu/kvcache/blockpool.py`` that
takes ``NULL_BLOCK`` from the port's ``ops.paged_attention`` (the JAX
package's module imports jax); the contracts are the same.

One :class:`BlockPool` owns the allocation state of a device block pool
(``ops/paged_attention.py``): which block ids are free, and how many
owners each allocated block has. Owners are (a) slot page-table
entries and (b) radix-tree nodes (``kvcache/radix.py``) — a block
shared by two running requests and cached in the tree carries three
refs. A block whose refcount reaches zero returns to the free list.

Block 0 is the reserved **null block**
(:data:`~container_engine_accelerators_tpu_torch.ops.paged_attention
.NULL_BLOCK`): never allocated, the write-redirect target for inactive
rows. The pool is single-writer (the engine loop thread); the only
cross-thread reads are the integer snapshots (:meth:`free_count`),
which are GIL-atomic.
"""

import collections

from container_engine_accelerators_tpu_torch.ops.paged_attention import (
    NULL_BLOCK,
)


class PoolExhausted(RuntimeError):
    """No free block and nothing evictable: every block is referenced
    by an active slot. Callers sized per the manager's capacity
    contract (``num_blocks - 1 >= max_slots * blocks_per_seq``) only
    see this on admission pressure, never mid-decode."""


class BlockPool:
    def __init__(self, num_blocks, block_size):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks ({num_blocks}) must be >= 2 (block 0 is "
                f"the reserved null block)"
            )
        if block_size < 1 or block_size & (block_size - 1):
            raise ValueError(
                f"block_size ({block_size}) must be a power of two"
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = collections.deque(range(1, num_blocks))
        self._refs = [0] * num_blocks
        # Peak simultaneously-allocated blocks over the pool's life (the
        # JAX package's obs/hbm.py reads it as the KV watermark).
        # GIL-atomic int, same read contract as free_count.
        self.watermark = 0

    # -- allocation -----------------------------------------------------------

    def alloc(self, n=1):
        """Allocate ``n`` blocks (each born with one ref). Raises
        :class:`PoolExhausted` — atomically: either all ``n`` or none —
        when the free list is short; the caller (the manager) evicts
        from the radix tree and retries."""
        if len(self._free) < n:
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free"
            )
        out = [self._free.popleft() for _ in range(n)]
        for bid in out:
            self._refs[bid] = 1
        in_use = (self.num_blocks - 1) - len(self._free)
        if in_use > self.watermark:
            self.watermark = in_use
        return out

    def ref(self, bid):
        """Add an owner to an allocated block (prefix sharing)."""
        if bid == NULL_BLOCK or self._refs[bid] < 1:
            raise ValueError(f"ref of unallocated block {bid}")
        self._refs[bid] += 1

    def unref(self, bid):
        """Drop one owner; frees the block at zero. Returns True when
        the block was freed."""
        if bid == NULL_BLOCK or self._refs[bid] < 1:
            raise ValueError(f"unref of unallocated block {bid}")
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def refcount(self, bid):
        return self._refs[bid]

    def free_count(self):
        return len(self._free)

    def shared(self, bid):
        """True when the block has more than one owner — a write to it
        needs copy-on-write (the manager forks it first)."""
        return self._refs[bid] > 1
