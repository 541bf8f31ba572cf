# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""PagedKVManager: page tables + prefix reuse for the serving engine.

Copy of ``container_engine_accelerators_tpu/kvcache/manager.py`` built on
the port's block pool and ``NULL_BLOCK``; every contract is the same
(tests/test_torch_kvcache.py drives both through one random sequence).

The host brain of the paged KV cache: owns the per-slot page tables the
device programs consume (``transformer.paged_decode_chunk`` /
``paged_prefill_segment``), the :class:`~container_engine_accelerators_tpu_torch
.kvcache.blockpool.BlockPool` refcounts, and the
:class:`~container_engine_accelerators_tpu_torch.kvcache.radix.RadixIndex`
over cached prefixes.

Lifecycle per request:

  * **admit** — match the prompt against the radix tree; every matched
    FULL block (capped at ``len - 1`` tokens: at least one suffix token
    must run through the model to produce the next-token logits) is
    mapped into the slot's table under a new ref. Those tokens skip
    prefill.
  * **ensure_blocks** — before each prefill segment / decode chunk,
    extend the slot's table with fresh blocks to cover the positions
    the dispatch will write. Shared blocks are never written: mapped
    reused blocks precede the write offset by construction, and
    :meth:`ensure_writable` forks (copy-on-write) any shared block
    that would be written anyway — the defensive path the property
    tests exercise.
  * **release** — on retire, snapshot the slot's blocks (refs ride the
    snapshot), free the table row immediately (the slot can re-admit
    while the retire's device work is still in flight), and later
    :meth:`finish_release` inserts the request's full blocks into the
    radix tree — making its prefix reusable — before dropping the
    per-slot refs. Drained/failed rows :meth:`drop` without inserting.

Capacity contract: ``num_blocks - 1 >= max_slots * blocks_per_seq`` so
decode coverage can ALWAYS be satisfied (tree-only blocks are
evictable; active slots can never pin more than the budgeted total) —
enforced at construction, which is what keeps :class:`PoolExhausted`
away from the decode hot path.

Single-writer: only the engine loop thread mutates; the /healthz
snapshot reads (:meth:`free_blocks`, :meth:`hit_ratio`) are GIL-atomic
integer reads.
"""

import numpy as np

from container_engine_accelerators_tpu_torch.kvcache.blockpool import (
    BlockPool,
    PoolExhausted,
)
from container_engine_accelerators_tpu_torch.kvcache.radix import RadixIndex
from container_engine_accelerators_tpu_torch.ops.paged_attention import (
    NULL_BLOCK,
)


class PagedKVManager:
    def __init__(self, max_seq_len, max_slots, block_size=16,
                 num_blocks=0, cache_contexts=2):
        if max_seq_len % block_size:
            raise ValueError(
                f"block_size ({block_size}) must divide max_seq_len "
                f"({max_seq_len})"
            )
        if block_size > 16:
            # Segment/bucket lengths are power-of-two with a 16 floor
            # (transformer._length_bucket); a larger block could not
            # align to every bucket.
            raise ValueError(
                f"block_size ({block_size}) must be <= 16 (the bucket "
                f"floor) so every prefill bucket is block-aligned"
            )
        self.block_size = block_size
        self.blocks_per_seq = max_seq_len // block_size
        self.max_slots = max_slots
        min_blocks = max_slots * self.blocks_per_seq + 1
        if num_blocks <= 0:
            # Default: full coverage + room to keep ~cache_contexts
            # retired contexts resident for prefix reuse.
            num_blocks = min_blocks + cache_contexts * self.blocks_per_seq
        if num_blocks < min_blocks:
            raise ValueError(
                f"num_blocks ({num_blocks}) below the coverage floor "
                f"{min_blocks} (= max_slots x blocks_per_seq + null): "
                f"decode could deadlock on allocation"
            )
        self.num_blocks = num_blocks
        self.pool = BlockPool(num_blocks, block_size)
        self.radix = RadixIndex(block_size)
        # Per-slot page tables, NULL-initialized; the device operand is
        # exactly this array.
        self.tables = np.full(
            (max_slots, self.blocks_per_seq), NULL_BLOCK, np.int32
        )
        self.mapped = [0] * max_slots
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.cow_copies = 0

    # -- allocation -----------------------------------------------------------

    def _alloc(self, n):
        """Allocate ``n`` blocks, evicting LRU cached prefixes when the
        free list is short."""
        short = n - self.pool.free_count()
        if short > 0:
            self.radix.evict(self.pool, short)
        return self.pool.alloc(n)

    # -- admission ------------------------------------------------------------

    def admit(self, slot, tokens):
        """Map the longest reusable cached prefix of ``tokens`` into
        ``slot``'s fresh page table. Returns ``(reused_len,
        hit_tokens, miss_tokens)`` — ``reused_len`` is block-aligned
        and <= len(tokens) - 1, the offset prefill starts at."""
        if self.mapped[slot]:
            raise RuntimeError(f"slot {slot} still mapped on admit")
        matched = self.radix.match(tokens)
        cap = (len(tokens) - 1) // self.block_size
        use = matched[:cap]
        for i, bid in enumerate(use):
            self.pool.ref(bid)
            self.tables[slot, i] = bid
        self.mapped[slot] = len(use)
        reused = len(use) * self.block_size
        hit, miss = reused, len(tokens) - reused
        self.hit_tokens += hit
        self.miss_tokens += miss
        return reused, hit, miss

    def ensure_blocks(self, slot, upto_pos):
        """Extend ``slot``'s table with fresh blocks so positions
        [0, upto_pos) are mapped (capped at the context end — bucket
        overhang past it is redirected to the null block by
        :meth:`segment_ids`). Returns the newly allocated ids."""
        need = min(
            -(-int(upto_pos) // self.block_size), self.blocks_per_seq
        )
        fresh = []
        if need > self.mapped[slot]:
            fresh = self._alloc(need - self.mapped[slot])
            for bid in fresh:
                self.tables[slot, self.mapped[slot]] = bid
                self.mapped[slot] += 1
        return fresh

    def segment_ids(self, slot, offset, length):
        """The physical blocks a segment at [offset, offset+length)
        writes — ``offset`` and ``length`` block-aligned; indices past
        the context end come back as the null block (padding writes
        land in garbage)."""
        bs = self.block_size
        b0 = offset // bs
        n = length // bs
        out = np.full(n, NULL_BLOCK, np.int32)
        hi = min(b0 + n, self.blocks_per_seq)
        if hi > b0:
            out[: hi - b0] = self.tables[slot, b0:hi]
        return out

    def position_targets(self, slot, pos, width):
        """Per-position (block_ids, offsets) for a width-W write at
        positions [pos, pos+width) — the operands of
        ``paged_write_positions`` (the speculative verify step's
        scatter, which starts at an arbitrary decode position so the
        block-aligned :meth:`segment_ids` cannot serve it). Positions
        past the context end redirect to the null block."""
        bs = self.block_size
        positions = np.arange(pos, pos + width)
        offsets = (positions % bs).astype(np.int32)
        bids = np.full(width, NULL_BLOCK, np.int32)
        for i, p in enumerate(positions):
            bi = p // bs
            if bi < self.blocks_per_seq:
                bids[i] = self.tables[slot, bi]
        return bids, offsets

    def ensure_writable(self, slot, first_block, last_block):
        """Copy-on-write guard over block indices [first, last]: any
        mapped SHARED block in the range is forked onto a fresh block.
        Returns ``(src_ids, dst_ids)`` for the device copy (empty in
        the structural steady state — reused blocks always precede the
        write offset)."""
        src, dst = [], []
        hi = min(last_block, self.mapped[slot] - 1)
        for idx in range(first_block, hi + 1):
            bid = int(self.tables[slot, idx])
            if bid != NULL_BLOCK and self.pool.shared(bid):
                (fresh,) = self._alloc(1)
                self.tables[slot, idx] = fresh
                self.pool.unref(bid)
                src.append(bid)
                dst.append(fresh)
                self.cow_copies += 1
        return src, dst

    # -- retirement / drain ---------------------------------------------------

    def release(self, slot):
        """Free ``slot``'s table row NOW; the blocks' refs ride the
        returned snapshot until :meth:`finish_release`/:meth:`drop`."""
        blocks = [
            int(b) for b in self.tables[slot, : self.mapped[slot]]
        ]
        self.tables[slot, :] = NULL_BLOCK
        self.mapped[slot] = 0
        return blocks

    def finish_release(self, blocks, tokens):
        """Retire path: cache the request's full blocks in the radix
        tree (its prefix becomes reusable), then drop the per-slot
        refs."""
        self.radix.insert(tokens, blocks, self.pool)
        self.drop(blocks)

    def drop(self, blocks):
        """Drop a snapshot's refs without caching (drain, failure)."""
        for bid in blocks:
            self.pool.unref(bid)

    def reset(self):
        """Cache lost (a device fault left the pools in an unknown
        state): forget everything."""
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.radix = RadixIndex(self.block_size)
        self.tables[:] = NULL_BLOCK
        self.mapped = [0] * self.max_slots

    # -- snapshots ------------------------------------------------------------

    def free_blocks(self):
        return self.pool.free_count()

    def cached_blocks(self):
        return len(self.radix)

    def hit_ratio(self):
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    def stats(self):
        return {
            "free_blocks": self.free_blocks(),
            "total_blocks": self.num_blocks - 1,
            "cached_blocks": self.cached_blocks(),
            "prefix_hit_ratio": round(self.hit_ratio(), 6),
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_miss_tokens": self.miss_tokens,
            "evictions": self.radix.evictions,
            "cow_copies": self.cow_copies,
        }


__all__ = ["PagedKVManager", "PoolExhausted"]
