# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's paged-cache ops and kvcache copies vs the JAX package (CPU).

Every op of ``ops/paged_attention.py`` runs on the same seeded numpy
inputs through both packages: gathers, writes (null redirect included)
and ``copy_blocks`` must agree exactly, ``paged_decode_attention`` within
1e-6 (f32; the two frameworks sum in other orders), and the port's paged
decode attention must be bit-identical to its own dense
``decode_attention`` on the equivalent dense cache. The manager copy and
the JAX manager take one seeded random sequence of operations and must
agree after every one of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.kvcache import (  # noqa: E402
    blockpool as jblockpool,
)
from container_engine_accelerators_tpu.kvcache import (  # noqa: E402
    manager as jmanager,
)
from container_engine_accelerators_tpu.ops import (  # noqa: E402
    paged_attention as jpa,
)
from container_engine_accelerators_tpu_torch.kvcache import (  # noqa: E402
    blockpool as tblockpool,
)
from container_engine_accelerators_tpu_torch.kvcache import (  # noqa: E402
    manager as tmanager,
)
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention as tattn,
)
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    paged_attention as tpa,
)

NUM_BLOCKS, HKV, BS, HD = 9, 2, 4, 8
DECODE_ATOL = 1e-6


def _pool(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((NUM_BLOCKS, HKV, BS, HD)).astype(np.float32)


def _tables(seed, batch=3, width=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, NUM_BLOCKS, (batch, width)).astype(np.int32)


def test_null_block_is_the_jax_constant():
    assert tpa.NULL_BLOCK == jpa.NULL_BLOCK == 0


def test_init_paged_kv_cache_is_zeros_of_the_jax_shape():
    want = jpa.init_paged_kv_cache(2, NUM_BLOCKS, HKV, BS, HD, jnp.float32)
    got = tpa.init_paged_kv_cache(2, NUM_BLOCKS, HKV, BS, HD, torch.float32,
                                  "cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any()


@pytest.mark.parametrize("n_blocks", [1, 3, 5])
def test_gather_block_kv_matches_jax(n_blocks):
    pool, tables = _pool(0), _tables(1)
    want = np.asarray(jpa.gather_block_kv(jnp.asarray(pool),
                                          jnp.asarray(tables), n_blocks))
    got = tpa.gather_block_kv(torch.from_numpy(pool),
                              torch.from_numpy(tables).long(), n_blocks)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_write_matches_jax_with_null_redirect():
    pool = _pool(2)
    rng = np.random.default_rng(3)
    new = rng.standard_normal((4, HKV, 1, HD)).astype(np.float32)
    # Rows 1 and 3 are inactive: redirected to the null block.
    block_ids = np.array([5, tpa.NULL_BLOCK, 2, tpa.NULL_BLOCK], np.int32)
    offsets = np.array([3, 1, 0, 2], np.int32)
    want = np.asarray(jpa.paged_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(block_ids),
        jnp.asarray(offsets)))
    got = torch.from_numpy(pool.copy())
    tpa.paged_write(got, torch.from_numpy(new),
                    torch.from_numpy(block_ids).long(),
                    torch.from_numpy(offsets).long())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block_ids", [[4, 7, 1], [6, 3, tpa.NULL_BLOCK]])
def test_paged_write_segment_matches_jax(block_ids):
    pool = _pool(4)
    ids = np.asarray(block_ids, np.int32)
    new = np.random.default_rng(5).standard_normal(
        (1, HKV, len(ids) * BS, HD)).astype(np.float32)
    want = np.asarray(jpa.paged_write_segment(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(ids)))
    got = torch.from_numpy(pool.copy())
    tpa.paged_write_segment(got, torch.from_numpy(new),
                            torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_copy_blocks_matches_jax():
    pools = {"k": np.stack([_pool(6), _pool(7)]),
             "v": np.stack([_pool(8), _pool(9)])}
    src, dst = np.array([2, 5], np.int32), np.array([7, 1], np.int32)
    want = jpa.copy_blocks({n: jnp.asarray(p) for n, p in pools.items()},
                           jnp.asarray(src), jnp.asarray(dst))
    got = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    out = tpa.copy_blocks(got, torch.from_numpy(src).long(),
                          torch.from_numpy(dst).long())
    assert out is got
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def _decode_inputs(seed, hq=4):
    rng = np.random.default_rng(seed)
    k_pool, v_pool = _pool(seed), _pool(seed + 1)
    tables = _tables(seed + 2)
    q = rng.standard_normal((3, hq, 1, HD)).astype(np.float32)
    lengths = np.array([1, 13, 20], np.int32)
    return q, k_pool, v_pool, tables, lengths


@pytest.mark.parametrize("window", [16, 20])
def test_paged_decode_attention_matches_jax(window):
    q, k_pool, v_pool, tables, lengths = _decode_inputs(10)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(np.minimum(lengths, window)),
        window, BS))
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables).long(),
        torch.from_numpy(np.minimum(lengths, window)).long(), window, BS)
    np.testing.assert_allclose(got.numpy(), want, atol=DECODE_ATOL, rtol=0)


def test_paged_decode_attention_is_dense_decode_bit_for_bit():
    """The gathered window holds exactly the values a dense cache would,
    so the paged step is the dense step on the same bits."""
    q, k_pool, v_pool, tables, lengths = _decode_inputs(20)
    window = tables.shape[1] * BS
    dense_k = np.zeros((3, HKV, window, HD), np.float32)
    dense_v = np.zeros_like(dense_k)
    for b in range(3):
        for j, bid in enumerate(tables[b]):
            dense_k[b, :, j * BS:(j + 1) * BS] = k_pool[bid]
            dense_v[b, :, j * BS:(j + 1) * BS] = v_pool[bid]
    lengths_t = torch.from_numpy(lengths).long()
    dense = tattn.decode_attention(torch.from_numpy(q),
                                   torch.from_numpy(dense_k),
                                   torch.from_numpy(dense_v), lengths_t)
    paged = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables).long(),
        lengths_t, window, BS)
    assert torch.equal(paged, dense)


# -- the kvcache copies --------------------------------------------------------

@pytest.mark.parametrize("args,kwargs", [
    ((30, 2), {"block_size": 4}),              # block does not divide S
    ((64, 2), {"block_size": 32}),             # above the bucket floor
    ((32, 2), {"block_size": 4, "num_blocks": 16}),  # below coverage
])
def test_manager_construction_errors_match_jax(args, kwargs):
    with pytest.raises(ValueError) as want:
        jmanager.PagedKVManager(*args, **kwargs)
    with pytest.raises(ValueError) as got:
        tmanager.PagedKVManager(*args, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [(1, 4), (8, 3), (8, 0)])
def test_block_pool_construction_errors_match_jax(args):
    with pytest.raises(ValueError) as want:
        jblockpool.BlockPool(*args)
    with pytest.raises(ValueError) as got:
        tblockpool.BlockPool(*args)
    assert str(got.value) == str(want.value)


def _call(manager, op, args):
    """(outcome, value) of one manager op: exceptions by type name."""
    try:
        out = getattr(manager, op)(*args)
    except (tblockpool.PoolExhausted, jblockpool.PoolExhausted) as e:
        return "PoolExhausted", str(e)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    if isinstance(out, np.ndarray):
        out = out.tolist()
    if isinstance(out, tuple):
        out = tuple(o.tolist() if isinstance(o, np.ndarray) else o
                    for o in out)
    return "ok", out


@pytest.mark.parametrize("seed,extra_blocks", [(0, 0), (1, 0), (2, 6)])
def test_manager_copy_follows_jax_through_a_random_sequence(seed,
                                                            extra_blocks):
    """admit / ensure_blocks / segment_ids / ensure_writable / release /
    finish_release / drop in one seeded random order through both
    managers (at the coverage floor, so allocation evicts): the same
    return values, page tables and stats() after every op."""
    max_seq, slots, bs = 32, 3, 4
    floor = slots * (max_seq // bs) + 1
    kw = dict(block_size=bs, num_blocks=floor + extra_blocks)
    jm = jmanager.PagedKVManager(max_seq, slots, **kw)
    tm = tmanager.PagedKVManager(max_seq, slots, **kw)
    rng = np.random.default_rng(seed)
    snapshots = []  # (blocks, tokens) released, not yet finished
    ctx = {}
    slot_ops = ("ensure_blocks", "segment_ids", "ensure_writable",
                "release", "retire")
    seen = set()
    for step in range(400):
        slot = int(rng.integers(slots))
        op = "admit" if slot not in ctx else \
            slot_ops[rng.integers(len(slot_ops))]
        if op == "admit":
            # Two distinct tokens, so prompts share prefixes often.
            toks = rng.integers(0, 2, int(rng.integers(1, max_seq))).tolist()
            ctx[slot] = toks
            args = (slot, toks)
        elif op == "ensure_blocks":
            args = (slot, int(rng.integers(0, max_seq + 8)))
        elif op == "segment_ids":
            args = (slot, bs * int(rng.integers(0, 8)),
                    bs * int(rng.integers(1, 5)))
        elif op == "ensure_writable":
            # Mostly over the leading blocks, where reused pages sit.
            first = int(rng.integers(0, 3))
            args = (slot, first, first + int(rng.integers(0, 4)))
        elif op == "release":
            args = (slot,)
        elif not snapshots:
            continue
        else:
            # A released snapshot retires: cached (3 in 4) or dropped.
            blocks, toks = snapshots.pop(int(rng.integers(len(snapshots))))
            op = "drop" if rng.integers(4) == 0 else "finish_release"
            args = (blocks, toks) if op == "finish_release" else (blocks,)
        want, got = _call(jm, op, args), _call(tm, op, args)
        assert got == want, (step, op, args)
        seen.add((op, want[0]))
        if op == "release":
            snapshots.append((want[1], ctx.pop(slot)))
        np.testing.assert_array_equal(tm.tables, jm.tables)
        assert tm.mapped == jm.mapped
        assert tm.stats() == jm.stats(), (step, op)
    # The sequence reached the paths that matter.
    for needed in ("admit", "release", "finish_release", "drop",
                   "ensure_writable"):
        assert (needed, "ok") in seen, (needed, seen)
    assert tm.stats()["prefix_hit_tokens"] > 0
    assert tm.stats()["evictions"] > 0
    assert tm.stats()["cow_copies"] > 0
