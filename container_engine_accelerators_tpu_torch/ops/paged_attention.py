# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Paged KV cache over a block pool: gathers, scatters and decode attention.

Port of ``container_engine_accelerators_tpu/ops/paged_attention.py``. The
dense serving cache reserves the full context for every slot; the paged
layout keeps one pool of fixed-size token blocks per layer::

    pool: (L, num_blocks, Hkv, block_size, hd)

and a per-slot page table of block ids. Block 0 is the reserved null
block: never allocated, the write target of inactive rows and of bucket
padding past the context end, so its contents are garbage by definition.

JAX is functional and returns new pools; here every writer updates the
pool tensor it is given IN PLACE, as ``transformer.decode_logits`` does
with the dense cache. Reads gather a window of a row's pages into the
dense window layout, so paged decode is the dense ``decode_attention`` on
bit-identical values.
"""

import torch

from container_engine_accelerators_tpu_torch.ops.attention import (
    decode_attention,
)

# Block id 0 is reserved: never allocated, the write-redirect target for
# inactive rows (kvcache/blockpool.py enforces the reservation).
NULL_BLOCK = 0


def init_paged_kv_cache(n_layers, num_blocks, n_kv_heads, block_size,
                        head_dim, dtype, device):
    """Zeroed K/V block pools ``(L, num_blocks, Hkv, block_size, hd)``.

    Zeros, never ``empty``: the null block and pages not written yet are
    read inside every gathered window, and a NaN there would survive the
    p = 0 mask of the P·V product (0 · NaN = NaN)."""
    shape = (n_layers, num_blocks, n_kv_heads, block_size, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def gather_block_kv(pool, tables, n_blocks):
    """The first ``n_blocks`` pages of each row in the dense window layout.

    pool: (num_blocks, H, bs, hd); tables: (B, T) integer page tables.
    Returns a contiguous (B, H, n_blocks * bs, hd): positions
    [0, n_blocks * bs) of each row, the layout the flash kernel and the
    dense ``decode_attention`` take. Unallocated entries point at the null
    block; its garbage is masked by position in the attention."""
    blocks = pool[tables[:, :n_blocks]]  # (B, n, H, bs, hd)
    b, n, h, bs, hd = blocks.shape
    return blocks.transpose(1, 2).reshape(b, h, n * bs, hd).contiguous()


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, window,
                           block_size):
    """One decode step's attention over paged caches.

    q: (B, Hq, 1, hd); pools (num_blocks, Hkv, bs, hd); tables (B, T);
    row b attends its positions [0, lengths[b]). ``window`` (a multiple
    of ``block_size``) bounds the gathered extent as the dense window
    slice does. Gather, then the dense ``decode_attention``: the same
    values through the same function as the dense step."""
    n = window // block_size
    k = gather_block_kv(k_pool, tables, n)
    v = gather_block_kv(v_pool, tables, n)
    return decode_attention(q, k, v, lengths)


def paged_write(pool, new, block_ids, offsets):
    """Per-row single-position write, in place: pool (num_blocks, H, bs,
    hd) ← new (B, H, 1, hd) at block ``block_ids[b]``, in-block offset
    ``offsets[b]``. Callers redirect inactive rows to ``NULL_BLOCK``."""
    pool[block_ids, :, offsets, :] = new[:, :, 0, :].to(pool.dtype)


def paged_write_positions(pool, new, block_ids, offsets):
    """Write a width-W segment per row at per-position targets, in place:
    the scatter of speculation's verify step.

    pool (num_blocks, H, bs, hd) ← new (B, H, W, hd): position i of row
    b lands at block ``block_ids[b, i]``, in-block offset ``offsets[b,
    i]`` (both (B, W) integer tensors). Unlike ``paged_write_segment``
    the segment need not be block-aligned (a verify starts at any decode
    position). Padding positions, padding rows and positions past the
    context end carry ``NULL_BLOCK``: garbage into the garbage block. JAX
    (``paged_write_positions``) writes one row; the batched verify here
    writes all its rows in one ``index_put_``, which reads nothing back
    to the host and so can be captured in a CUDA graph."""
    pool[block_ids, :, offsets, :] = new.transpose(1, 2).to(pool.dtype)


def paged_write_segment(pool, new, block_ids):
    """Write one prefill segment's K/V into its blocks, in place.

    new: (1, H, C, hd) with C = len(block_ids) * block_size (segments are
    block-aligned). Ids past the context end are ``NULL_BLOCK``: bucket
    padding writes garbage into the garbage block."""
    h, n = new.shape[1], block_ids.shape[0]
    seg = new[0].reshape(h, n, -1, new.shape[-1]).transpose(0, 1)
    pool[block_ids] = seg.to(pool.dtype)


def copy_blocks(pools, src_ids, dst_ids):
    """Copy-on-write, the device half: blocks ``src_ids`` are copied into
    ``dst_ids`` in every layer of both pools, in place (the host block
    pool decides which blocks fork). pools: {"k", "v"} each (L,
    num_blocks, H, bs, hd); ids (n,) integer tensors. Returns ``pools``."""
    for buf in pools.values():
        buf[:, dst_ids] = buf[:, src_ids]
    return pools


def write_blocks(pools, block_ids, k, v):
    """A KV handoff install's device half: whole blocks ``block_ids``
    ((n,) integer tensor) of every layer ← ``k`` and ``v`` (L, n, H, bs,
    hd), in place, one indexed copy per pool (the pools keep their
    addresses, which captured graphs hold). ``k`` and ``v`` may lie on
    the host: each goes to the pool's device by a blocking copy first, so
    its host buffer is free on return. Returns ``pools``."""
    for buf, src in ((pools["k"], k), (pools["v"], v)):
        buf.index_copy_(1, block_ids.to(buf.device), src.to(buf.device))
    return pools
