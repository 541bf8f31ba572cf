# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's paged serving path vs the JAX package (CPU, f32).

Both packages run the JAX ``init_params`` weights (bridged with
``weights.params_from_jax``) of a 2-layer model (d_model 64, 4 q heads,
2 kv heads, vocab 256, context 64) with a block size of 4:

  * ``paged_prefill_segment`` and ``paged_decode_chunk`` against their
    JAX counterparts (the JAX flash forward in Pallas interpret mode on
    the CPU, the port's through its plain version): greedy tokens exact,
    the pools within ``POOL_ATOL`` (f32; the frameworks sum in other
    orders);
  * ``ContinuousEngine`` (2 slots, decode chunk 4, prefill chunk 16)
    against the JAX ``Model.generate`` (dense greedy): exactly the same
    tokens for shared prefixes, chunked prefill, concurrent requests
    beyond the slot count, one-token requests, the multi-turn
    block-boundary case and a pool at its coverage floor.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.kvcache.blockpool import (  # noqa: E402
    PoolExhausted,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    paged_attention as tpa,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--n-layers", "1", "--d-model", "64", "--n-heads", "2",
              "--seq-len", "64", "--vocab-size", "256"]
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
BS = 4
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16, kv_block_size=BS,
              kv_cache="paged")
# f32 pools: the same projections in two frameworks, summed in other
# orders (one f32 ulp at these magnitudes is ~1e-7).
POOL_ATOL = 1e-5
BLOCKS_PER_SEQ = SHAPE["max_seq_len"] // BS
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def models():
    """(JAX Model, port Model) on identical weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


@pytest.fixture
def engine(models):
    engines = []

    def make(**kwargs):
        eng = tserve.ContinuousEngine(models[1], **{**ENGINE, **kwargs})
        engines.append(eng)
        return eng

    yield make
    for eng in engines:
        eng.shutdown()


def _prompt(rng, n):
    return rng.integers(1, SHAPE["vocab_size"], n).tolist()


def _expect(jmodel, prompt, max_new):
    return jmodel.generate([prompt], max_new)[0]


def _pools(seed, num_blocks):
    rng = np.random.default_rng(seed)
    shape = (SHAPE["n_layers"], num_blocks, SHAPE["n_kv_heads"], BS,
             SHAPE["d_model"] // SHAPE["n_heads"])
    return {n: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for n in ("k", "v")}


def _assert_pools_close(got, want):
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=POOL_ATOL, rtol=0)


# -- the paged programs ---------------------------------------------------------

@pytest.mark.parametrize("offset,true_len", [
    (8, None),   # a middle segment at a reused offset: no token
    (20, 28),    # the final segment, padded to its 16-row bucket
    (52, 58),    # padding past the context end: its blocks go to NULL
])
def test_paged_prefill_segment_matches_jax(models, offset, true_len):
    jmodel, tmodel = models
    seg_len, slot, num_blocks = 16, 1, 40
    end = min(offset + seg_len, SHAPE["max_seq_len"])
    window = ttf._window_for(end, SHAPE["max_seq_len"])
    rng = np.random.default_rng(offset)
    table = rng.permutation(np.arange(1, num_blocks))[:BLOCKS_PER_SEQ]
    table = table.astype(np.int32)
    seg_ids = np.full(seg_len // BS, tpa.NULL_BLOCK, np.int32)
    b0 = offset // BS
    hi = min(b0 + seg_len // BS, BLOCKS_PER_SEQ)
    seg_ids[:hi - b0] = table[b0:hi]
    seg = np.zeros((1, seg_len), np.int32)
    real = seg_len if true_len is None else true_len - offset
    seg[0, :real] = _prompt(rng, real)
    pools = _pools(offset, num_blocks)
    last = np.array([7, 9], np.int32)
    want = true_len is not None
    true_pos = (true_len or offset + seg_len) - 1

    jtok, jpools, jlast = jtf.paged_prefill_segment(
        jmodel.params, {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(seg), offset, jnp.asarray(seg_ids), jnp.asarray(table),
        true_pos, jnp.asarray(last), slot, cfg=jmodel.cfg, window=window,
        block_size=BS, want_logits=want,
    )
    tpools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    tlast = torch.from_numpy(last).long()
    tok = ttf.paged_prefill_segment(
        tmodel.model, tpools, torch.from_numpy(seg).long(), offset,
        torch.from_numpy(seg_ids).long(), torch.from_numpy(table).long(),
        true_pos, tlast, slot, window=window, block_size=BS,
        want_logits=want,
    )
    _assert_pools_close(tpools, jpools)
    assert tlast.tolist() == np.asarray(jlast).tolist()
    if want:
        assert int(tok) == int(jtok) == tlast[slot]
    else:
        assert tok is None and tlast.tolist() == last.tolist()


@pytest.mark.parametrize("positions,steps,window", [
    ([9, 5, 29], 4, 32),   # row 2 runs into the window's end and clamps
    ([40, 3, 17], 2, 64),
])
def test_paged_decode_chunk_matches_jax(models, positions, steps, window):
    jmodel, tmodel = models
    batch, num_blocks = 3, 1 + 3 * BLOCKS_PER_SEQ
    rng = np.random.default_rng(steps)
    # Disjoint pages per row, so no two rows write one block.
    tables = rng.permutation(np.arange(1, num_blocks)).reshape(batch, -1)
    tables = tables.astype(np.int32)
    tokens = np.asarray(_prompt(rng, batch), np.int32)
    positions = np.asarray(positions, np.int32)
    active = np.array([True, False, True])
    pools = _pools(steps + 10, num_blocks)

    jtoks, jlast, jpools, jpos = jtf.paged_decode_chunk(
        jmodel.params, {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(active), cfg=jmodel.cfg, steps=steps, window=window,
        block_size=BS,
    )
    tpools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    toks, last, pos = ttf.paged_decode_chunk(
        tmodel.model, tpools, torch.from_numpy(tables).long(),
        torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        torch.from_numpy(active), steps=steps, window=window, block_size=BS,
    )
    assert toks.shape == (steps, batch)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    # The inactive row kept its token and position.
    assert last[1] == tokens[1] and pos[1] == positions[1]
    _assert_pools_close(tpools, jpools)


def test_paged_decode_chunk_is_dense_decode_bit_for_bit(models):
    """Inside the port, a paged decode step over pages holding a dense
    cache's values gives exactly the dense step's logits."""
    tmodel = models[1].model
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor([_prompt(rng, 11)])
    _, cache = ttf.prefill(tmodel, prompt)
    tok = torch.as_tensor([17])
    dense = ttf.decode_logits(tmodel, cache, tok.clone(), 11)
    table = torch.arange(1, 1 + BLOCKS_PER_SEQ)[None, :]
    pools = tpa.init_paged_kv_cache(
        SHAPE["n_layers"], 1 + BLOCKS_PER_SEQ, SHAPE["n_kv_heads"], BS,
        SHAPE["d_model"] // SHAPE["n_heads"], torch.float32, "cpu")
    for name in ("k", "v"):
        dense_kv = cache[name][:, 0]  # (L, Hkv, S, hd), step 11 written
        pages = dense_kv.reshape(SHAPE["n_layers"], SHAPE["n_kv_heads"],
                                 BLOCKS_PER_SEQ, BS, -1).transpose(1, 2)
        pools[name][:, 1:] = pages
    cache_k = cache["k"].clone()
    # The step rewrites position 11 with the same K/V it already holds.
    toks, _, _ = ttf.paged_decode_chunk(
        tmodel, pools, table, tok, torch.as_tensor([11]),
        torch.as_tensor([True]), steps=1, window=16, block_size=BS)
    assert toks[0, 0] == dense.argmax(dim=-1)[0]
    paged_k = pools["k"][:, 1:].transpose(1, 2).reshape(cache_k[:, 0].shape)
    assert torch.equal(paged_k, cache_k[:, 0])


# -- the engine -----------------------------------------------------------------

def test_engine_shared_prefixes_match_jax_and_hit_the_radix_cache(models,
                                                                  engine):
    jmodel, tmodel = models
    eng = engine()
    rng = np.random.default_rng(0)
    prefix = _prompt(rng, 12)
    cases = [prefix + _prompt(rng, 1 + i % 3) for i in range(4)]
    cases.append(_prompt(rng, 5))
    for prompt in cases:
        (got,) = eng.generate([prompt], 6)
        assert got == _expect(jmodel, prompt, 6)
        # f32 identity with the port's own dense path, too.
        assert got == tmodel.generate([prompt], 6)[0]
    assert eng.kv_stats()["prefix_hit_tokens"] > 0


def test_engine_chunked_prefill_interleaves_with_decode(models, engine):
    """A 40-token prompt prefills in three 16-token segments while a short
    request decodes beside it; both match JAX."""
    jmodel, _ = models
    eng = engine()
    rng = np.random.default_rng(1)
    long_prompt, short = _prompt(rng, 40), _prompt(rng, 3)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        short_f = pool.submit(eng.generate, [short], 12)
        long_f = pool.submit(eng.generate, [long_prompt], 8)
        assert long_f.result(TIMEOUT_S)[0] == \
            _expect(jmodel, long_prompt, 8)
        assert short_f.result(TIMEOUT_S)[0] == _expect(jmodel, short, 12)
    # 1 segment for the short prompt, 3 for the long one.
    assert eng.stats()["n_prefills"] == 4


def test_engine_concurrent_requests_beyond_the_slots_match_jax(models,
                                                               engine):
    jmodel, _ = models
    eng = engine()
    rng = np.random.default_rng(2)
    prefix = _prompt(rng, 8)
    cases = [(prefix + _prompt(rng, 2 + i), 3 + 2 * i) for i in range(3)]
    cases += [(_prompt(rng, 17), 5), (_prompt(rng, 2), 9), (prefix, 4)]
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = [pool.submit(eng.generate, [p], n) for p, n in cases]
        outs = [f.result(TIMEOUT_S)[0] for f in futures]
    for (prompt, max_new), got in zip(cases, outs):
        assert got == _expect(jmodel, prompt, max_new), (prompt, max_new)
    st, kv = eng.stats(), eng.kv_stats()
    assert st["occupied_slots"] == 0 and st["queue_depth"] == 0
    assert kv["free_blocks"] + kv["cached_blocks"] == kv["total_blocks"]


def test_engine_one_token_request_finishes_at_prefill(models, engine):
    jmodel, _ = models
    eng = engine()
    prompt = _prompt(np.random.default_rng(4), 9)
    (got,) = eng.generate([prompt], 1)
    assert got == _expect(jmodel, prompt, 1)
    assert eng.stats()["n_chunks"] == 0
    kv = eng.kv_stats()
    assert kv["free_blocks"] + kv["cached_blocks"] == kv["total_blocks"]


def test_engine_multi_turn_reuse_at_a_block_boundary_matches_jax(models,
                                                                 engine):
    """Turn 1's prompt + output is an exact block multiple (12 + 8 = 20);
    only its written extent (19 tokens, 4 blocks) may be cached, and turn
    2, which extends the whole turn, reuses it and still matches."""
    jmodel, _ = models
    eng = engine()
    rng = np.random.default_rng(5)
    prompt = _prompt(rng, 12)
    (turn1,) = eng.generate([prompt], 8)
    assert turn1 == _expect(jmodel, prompt, 8)
    assert len(eng.kv.radix.match(turn1)) == (len(turn1) - 1) // BS
    follow = turn1 + _prompt(rng, 3)
    (turn2,) = eng.generate([follow], 6)
    assert turn2 == _expect(jmodel, follow, 6)
    assert eng.kv_stats()["prefix_hit_tokens"] == 16


def test_engine_at_the_coverage_floor_evicts_and_drains(models, engine):
    """kv_blocks at the floor (2 slots x 16 blocks + null): full-context
    requests evict each other's cached prefixes, and an admission that
    finds the pool pinned by last iteration's retire drains the pending
    syncs and retries; every output still matches JAX."""
    jmodel, _ = models
    eng = engine(kv_blocks=2 * BLOCKS_PER_SEQ + 1)
    exhausted = []
    ensure_blocks = eng.kv.ensure_blocks

    def counting_ensure_blocks(slot, upto_pos):
        try:
            return ensure_blocks(slot, upto_pos)
        except PoolExhausted:
            exhausted.append(slot)
            raise

    eng.kv.ensure_blocks = counting_ensure_blocks
    rng = np.random.default_rng(6)
    cases = [_prompt(rng, 56) for _ in range(5)]
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = [pool.submit(eng.generate, [p], 8) for p in cases]
        outs = [f.result(TIMEOUT_S)[0] for f in futures]
    for prompt, got in zip(cases, outs):
        assert got == _expect(jmodel, prompt, 8)
    assert eng.kv_stats()["evictions"] > 0
    assert exhausted
    # The loop survived: a fresh request still serves.
    (got,) = eng.generate([[1, 2, 3]], 4)
    assert got == _expect(jmodel, [1, 2, 3], 4)


def test_engine_backs_an_admission_out_under_pool_pressure(models):
    """A prefill segment that cannot get its blocks even after draining
    un-admits its row (reuse un-counted, sync generation bumped) and
    re-queues it; once blocks are free again it serves as JAX does."""
    jmodel, tmodel = models
    eng = tserve.ContinuousEngine(tmodel, start_loop=False, **ENGINE)
    rng = np.random.default_rng(7)
    prompt = _prompt(rng, 20)
    hog = eng.kv.pool.alloc(eng.kv.free_blocks() - 2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(eng.generate, [prompt], 5)
        row = eng._q.get(timeout=TIMEOUT_S)
        eng._admit_paged(0, row)
        assert eng._advance_prefill_paged(0) is None
        assert eng.occupied[0] is None and eng.kv.mapped[0] == 0
        assert row["_sync_gen"] == 1 and row["prefix_hit_tokens"] == 0
        assert eng.kv.free_blocks() == 2
        for bid in hog:
            eng.kv.pool.unref(bid)
        eng._thread = threading.Thread(target=eng._loop_paged, daemon=True)
        eng._thread.start()
        try:
            assert fut.result(TIMEOUT_S)[0] == _expect(jmodel, prompt, 5)
        finally:
            eng.shutdown()


def test_engine_failed_chunk_fails_its_rows_and_keeps_the_pools(models,
                                                                 engine):
    """A decode chunk that raises at dispatch fails its rows and frees
    their blocks; the pools, written in place and only in the failed
    rows' own blocks, are kept (no reset), and the engine serves on."""
    jmodel, _ = models
    eng = engine()
    paged_chunk, faults = eng._paged_chunk, []

    def chunk_failing_once(*args, **kwargs):
        if not faults:
            faults.append(1)
            raise RuntimeError("injected chunk fault")
        return paged_chunk(*args, **kwargs)

    eng._paged_chunk = chunk_failing_once
    with pytest.raises(RuntimeError, match="decode chunk failed"):
        eng.generate([[1, 2, 3]], 6)
    (got,) = eng.generate([[4, 5, 6]], 6)
    assert got == _expect(jmodel, [4, 5, 6], 6)
    assert eng._kv_epoch == 0
    kv = eng.kv_stats()
    assert kv["free_blocks"] + kv["cached_blocks"] == kv["total_blocks"]


def test_engine_failed_sync_resets_the_pools(models, engine):
    """A device error that surfaces at the deferred sync fails its rows
    and rebuilds the pools and the radix index (the port cannot tell what
    a faulted device wrote); the engine serves on from the fresh pool."""
    jmodel, _ = models
    eng = engine()
    (cached,) = eng.generate([[9, 8, 7, 6, 5]], 2)
    assert eng.kv.radix.match(cached)
    to_host, faults = eng._to_host, []

    class Faulted:
        def numpy(self):
            raise RuntimeError("injected sync fault")

        __int__ = numpy

    def to_host_failing_once(tensor):
        if not faults:
            faults.append(1)
            return Faulted(), None
        return to_host(tensor)

    eng._to_host = to_host_failing_once
    with pytest.raises(RuntimeError, match="paged sync failed"):
        eng.generate([[1, 2, 3]], 6)
    (got,) = eng.generate([[4, 5, 6]], 6)
    assert got == _expect(jmodel, [4, 5, 6], 6)
    assert eng._kv_epoch == 1 and not eng.kv.radix.match(cached)


def test_engine_failed_sync_zeroes_the_pools_before_it_wakes_the_row(
        models, engine):
    """A failed deferred sync resets the pools before it wakes the failed
    row's waiter: with a reset that sleeps before it zeroes, the pools
    and ``last_dev`` are already zero when ``generate`` raises."""
    eng = engine()
    eng.generate([[9, 8, 7, 6, 5]], 2)
    to_host, reset, faults = eng._to_host, eng._reset_paged, []

    class Faulted:
        def numpy(self):
            raise RuntimeError("injected sync fault")

        __int__ = numpy

    def to_host_failing_once(tensor):
        if not faults:
            faults.append(1)
            return Faulted(), None
        return to_host(tensor)

    def slow_reset(*args, **kwargs):
        time.sleep(0.5)
        return reset(*args, **kwargs)

    eng._to_host, eng._reset_paged = to_host_failing_once, slow_reset
    with pytest.raises(RuntimeError, match="paged sync failed"):
        eng.generate([[1, 2, 3]], 6)
    assert not any(p.any() for p in eng.cache.values())
    assert not eng.last_dev.any()


def test_engine_shutdown_fails_what_is_queued(models):
    """shutdown() stops the loop and fails queued requests (the JAX
    engine's shutdown leaves its loop thread running)."""
    eng = tserve.ContinuousEngine(models[1], start_loop=False, **ENGINE)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(eng.generate, [[1, 2, 3]], 4)
        while eng._q.qsize() == 0 and not fut.done():
            threading.Event().wait(0.01)
        eng.shutdown()
        with pytest.raises(RuntimeError, match="engine shut down"):
            fut.result(TIMEOUT_S)
    with pytest.raises(RuntimeError, match="engine is shut down"):
        eng.generate([[1, 2, 3]], 4)


def test_engine_sampled_requests_go_to_the_model(models, engine):
    tmodel = models[1]
    eng = engine()
    kw = dict(temperature=1.0, top_k=8, seed=3)
    assert eng.generate([[4, 5, 6]], 5, **kw) == \
        tmodel.generate([[4, 5, 6]], 5, **kw)
    assert eng.stats()["n_prefills"] == 0


def test_engine_stats_keys_match_jax(models, engine):
    jmodel, _ = models
    jeng = jserve.ContinuousEngine(jmodel, start_loop=False, **ENGINE)
    eng = engine()
    eng.generate([[1, 2, 3]], 2)
    assert set(eng.stats()) == set(jeng.stats())
    assert set(eng.kv_stats()) == set(jeng.kv_stats())


def test_engine_kv_cache_modes(models):
    tmodel = models[1]
    # kv_cache defaults to "dense", as in JAX: one cache row per slot, no
    # block manager.
    dense = tserve.ContinuousEngine(tmodel, start_loop=False)
    assert dense.kv_cache == "dense" and dense.kv is None
    assert dense.kv_stats() is None and dense.chunk_graphs is not None
    assert tuple(dense.cache["k"].shape) == (
        SHAPE["n_layers"], tserve.MAX_BATCH, SHAPE["n_kv_heads"],
        SHAPE["max_seq_len"], SHAPE["d_model"] // SHAPE["n_heads"])
    with pytest.raises(ValueError, match="dense.*paged"):
        tserve.ContinuousEngine(tmodel, start_loop=False, kv_cache="ring")
    with pytest.raises(ValueError, match="coverage floor"):
        tserve.ContinuousEngine(tmodel, start_loop=False, kv_cache="paged",
                                kv_block_size=BS,
                                kv_blocks=2 * BLOCKS_PER_SEQ)
    eng = tserve.ContinuousEngine(tmodel, start_loop=False, **ENGINE)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate([[1] * 60], 8)


@pytest.mark.parametrize("args", [(64, 16, 4), (64, 24, 6), (96, 64, 32),
                                  (100, 64, 32), (8192, 512, 32)])
def test_normalize_chunks_matches_jax(args):
    assert tserve.normalize_chunks(*args) == jserve.normalize_chunks(*args)


def test_engine_behind_the_http_server(models, engine):
    jmodel, _ = models
    eng = engine()
    server, state = tserve.start_server(eng, port=0, host="127.0.0.1")
    try:
        tserve.wait_ready(state, timeout=TIMEOUT_S)
        port = server.server_address[1]
        resp = tserve.post_generate(port, [[3, 1, 4, 1, 5]], 6)
        assert resp["tokens"] == jmodel.generate([[3, 1, 4, 1, 5]], 6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["max_slots"] == ENGINE["max_slots"]
        assert health["occupied_slots"] == 0 and health["queue_depth"] == 0
        assert health["free_blocks"] > 0
        assert 0.0 <= health["prefix_hit_ratio"] <= 1.0
    finally:
        server.shutdown()
        server.server_close()


def test_serve_cli_continuous_batching_once_on_cpu_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", *TINY_FLAGS,
         "--continuous-batching", "--kv-cache", "paged",
         "--kv-block-size", "4", "--max-slots", "2", "--decode-chunk", "4",
         "--prefill-chunk", "16"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["tokens"][0]) == 4 and out["tokens"][0][:2] == [5, 6]


def test_continuous_batching_raises_without_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--once", "--port", "0", *TINY_FLAGS,
                     "--continuous-batching"])
