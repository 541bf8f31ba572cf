# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's dense continuous-batching path vs the JAX package (CPU, f32).

Both packages run the JAX ``init_params`` weights (bridged with
``weights.params_from_jax``) of a 2-layer model (d_model 64, 4 q heads,
2 kv heads, vocab 256, context 64):

  * ``decode_logits_multi``, ``decode_chunk``, ``prefill_into_slot`` and
    ``prefill_chunk_into_slot`` against their JAX counterparts (the JAX
    flash forward in Pallas interpret mode on the CPU, the port's through
    its plain version): greedy tokens exact, caches within ``POOL_ATOL``
    (f32; the frameworks sum in other orders), and the rows a call must
    not write bit for bit unchanged;
  * ``DenseChunkGraphs`` (the engine's chunk over static buffers) against
    the eager ``decode_chunk``, and its capture-time restore;
  * the dense ``ContinuousEngine`` (2 slots, decode chunk 4, prefill
    chunk 16, the default ``kv_cache``) against the JAX ``Model.generate``,
    tokens exact, over every traffic case, and the same traffic on the
    paged engine; its faults, keys, ``/healthz`` and warm plan;
  * ``BatchingModel`` (``--batch-window-ms``) and the CLI.
"""

import concurrent.futures
import functools
import json
import logging
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
from container_engine_accelerators_tpu.warmstart import (  # noqa: E402
    warmup as jwarmup,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serving_graphs,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.warmstart import (  # noqa: E402
    warmup as twarmup,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--n-layers", "1", "--d-model", "64", "--n-heads", "2",
              "--seq-len", "64", "--vocab-size", "256"]
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16)
# f32 caches and logits: the same projections in two frameworks, summed
# in other orders (one f32 ulp at these magnitudes is ~1e-7).
POOL_ATOL = 1e-5
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def models():
    """(JAX Model, port Model) on identical weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def expect(models):
    """JAX ``Model.generate``'s greedy row for (prompt, max_new), each
    computed once in the module."""
    jmodel = models[0]

    @functools.lru_cache(maxsize=None)
    def want(prompt, max_new):
        return jmodel.generate([list(prompt)], max_new)[0]

    return lambda prompt, max_new: want(tuple(prompt), max_new)


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


def _cache(seed, batch):
    """A dense (L, B, Hkv, S, hd) cache of random K/V per name."""
    rng = np.random.default_rng(seed)
    shape = (SHAPE["n_layers"], batch, SHAPE["n_kv_heads"],
             SHAPE["max_seq_len"], SHAPE["d_model"] // SHAPE["n_heads"])
    return {n: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for n in ("k", "v")}


def _torch_cache(cache):
    return {n: torch.from_numpy(c.copy()) for n, c in cache.items()}


def _jax_cache(cache):
    return {n: jnp.asarray(c) for n, c in cache.items()}


def _assert_cache_close(got, want):
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=POOL_ATOL, rtol=0)


def _assert_rows_unchanged(got, before, rows):
    for name in ("k", "v"):
        for r in rows:
            assert np.array_equal(got[name][:, r].numpy(), before[name][:, r])


# -- the dense programs ---------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_decode_logits_multi_matches_jax(models, masked):
    jmodel, tmodel = models
    rng = np.random.default_rng(1)
    cache = _cache(1, 3)
    tokens = np.asarray(_prompt(rng, 3), np.int32)
    positions = np.array([7, 20, 33], np.int32)
    active = np.array([True, False, True]) if masked else None
    jlogits, jcache = jtf.decode_logits_multi(
        jmodel.params, _jax_cache(cache), jnp.asarray(tokens),
        jnp.asarray(positions), jmodel.cfg,
        active=None if active is None else jnp.asarray(active),
    )
    tcache = _torch_cache(cache)
    with torch.inference_mode():
        logits = ttf.decode_logits_multi(
            tmodel.model, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(positions).long(),
            active=None if active is None else torch.from_numpy(active),
        )
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=POOL_ATOL, rtol=0)
    _assert_cache_close(tcache, jcache)
    if masked:
        # The inactive row wrote its own value back: bit for bit.
        _assert_rows_unchanged(tcache, cache, [1])


def test_decode_logits_multi_at_uniform_positions_is_decode_logits(models):
    """With every row at one position, the per-row step is the port's
    shared-position ``decode_logits``, logits and cache."""
    tmodel = models[1].model
    cache = _cache(2, 2)
    tokens = torch.tensor([5, 9])
    window = ttf._window_for(12, SHAPE["max_seq_len"])
    a, b = _torch_cache(cache), _torch_cache(cache)
    with torch.inference_mode():
        multi = ttf.decode_logits_multi(tmodel, a, tokens,
                                        torch.tensor([11, 11]), window=window)
    shared = ttf.decode_logits(tmodel, b, tokens, 11)
    assert torch.equal(multi, shared)
    for name in ("k", "v"):
        assert torch.equal(a[name], b[name])


@pytest.mark.parametrize("positions,steps,window,mask_writes", [
    ([9, 5, 29], 4, 32, False),    # row 2 runs into the window's end
    ([9, 5, 29], 4, 32, True),
    ([40, 3, 17], 3, None, True),  # no window: the whole context
    ([40, 3, 17], 2, 64, False),
])
def test_decode_chunk_matches_jax(models, positions, steps, window,
                                  mask_writes):
    jmodel, tmodel = models
    rng = np.random.default_rng(steps)
    cache = _cache(steps + 10, 3)
    tokens = np.asarray(_prompt(rng, 3), np.int32)
    positions = np.asarray(positions, np.int32)
    active = np.array([True, False, True])
    jtoks, jlast, jcache, jpos = jtf.decode_chunk(
        jmodel.params, _jax_cache(cache), jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(active), jmodel.cfg,
        steps=steps, window=window, mask_writes=mask_writes,
    )
    tcache = _torch_cache(cache)
    toks, last, pos = ttf.decode_chunk(
        tmodel.model, tcache, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), torch.from_numpy(active),
        steps=steps, window=window, mask_writes=mask_writes,
    )
    assert toks.shape == (steps, 3)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    # The inactive row kept its token and position.
    assert last[1] == tokens[1] and pos[1] == positions[1]
    _assert_cache_close(tcache, jcache)
    if mask_writes:
        _assert_rows_unchanged(tcache, cache, [1])


@pytest.mark.parametrize("bucket,true_len,slot", [(16, 11, 1), (32, 20, 0)])
def test_prefill_into_slot_matches_jax(models, bucket, true_len, slot):
    jmodel, tmodel = models
    rng = np.random.default_rng(bucket)
    cache = _cache(bucket, 3)
    prompt = np.zeros((1, bucket), np.int32)
    prompt[0, :true_len] = _prompt(rng, true_len)
    jtok, jcache = jtf.prefill_into_slot(
        jmodel.params, _jax_cache(cache), jnp.asarray(prompt), true_len,
        slot, jmodel.cfg,
    )
    tcache = _torch_cache(cache)
    tok = ttf.prefill_into_slot(tmodel.model, tcache,
                                torch.from_numpy(prompt).long(), true_len,
                                slot)
    assert tok.dim() == 0 and int(tok) == int(jtok)
    _assert_cache_close(tcache, jcache)
    _assert_rows_unchanged(tcache, cache, [r for r in range(3) if r != slot])
    with pytest.raises(ValueError, match="one request per slot"):
        ttf.prefill_into_slot(tmodel.model, tcache,
                              torch.zeros((2, 16), dtype=torch.long), 4, 0)


@pytest.mark.parametrize("offset,true_len", [
    (16, None),   # a middle segment: no token
    (32, 40),     # the final segment, right-padded
])
def test_prefill_chunk_into_slot_matches_jax(models, offset, true_len):
    jmodel, tmodel = models
    seg_len, slot = 16, 1
    window = ttf._window_for(offset + seg_len, SHAPE["max_seq_len"])
    rng = np.random.default_rng(offset)
    cache = _cache(offset, 3)
    seg = np.zeros((1, seg_len), np.int32)
    real = seg_len if true_len is None else true_len - offset
    seg[0, :real] = _prompt(rng, real)
    want = true_len is not None
    true_pos = (true_len or offset + seg_len) - 1
    jtok, jcache = jtf.prefill_chunk_into_slot(
        jmodel.params, _jax_cache(cache), jnp.asarray(seg), offset, slot,
        true_pos, jmodel.cfg, window=window, want_logits=want,
    )
    tcache = _torch_cache(cache)
    tok = ttf.prefill_chunk_into_slot(
        tmodel.model, tcache, torch.from_numpy(seg).long(), offset, slot,
        true_pos, window=window, want_logits=want,
    )
    _assert_cache_close(tcache, jcache)
    _assert_rows_unchanged(tcache, cache, [0, 2])
    if want:
        assert int(tok) == int(jtok)
    else:
        assert tok is None
    for bad in (8, 48):  # below the segment; neither 2^k nor 128-multiple
        with pytest.raises(ValueError, match="power of two"):
            ttf.prefill_chunk_into_slot(
                tmodel.model, tcache, torch.from_numpy(seg).long(), 0, slot,
                seg_len - 1, window=bad, want_logits=True)


def test_prefill_segments_equal_the_single_shot_prefill(models):
    """A 50-token prompt prefilled in four 16-token segments (the last
    padded) gives the single-shot prefill's first token, and its cache
    over the real tokens (JAX: within 2e-4; here within POOL_ATOL). With
    ``return_logits`` the final segment also returns its logits, the
    single-shot prefill's within POOL_ATOL."""
    tmodel = models[1].model
    rng = np.random.default_rng(11)
    prompt = torch.as_tensor([_prompt(rng, 50)])
    want_tok, want_cache = ttf.prefill(tmodel, prompt)
    want_logits, _ = ttf.prefill(tmodel, prompt, return_logits=True)
    cache = ttf.init_kv_cache(tmodel.cfg, 2, "cpu")
    padded = torch.nn.functional.pad(prompt, (0, 14))
    for i in range(4):
        tok = ttf.prefill_chunk_into_slot(
            tmodel, cache, padded[:, 16 * i:16 * (i + 1)], 16 * i, 1, 49,
            window=ttf._window_for(16 * (i + 1), 64), want_logits=i == 3,
            return_logits=i == 3)
    tok, logits = tok
    assert int(tok) == int(want_tok[0]) == int(logits.argmax())
    np.testing.assert_allclose(logits.numpy(), want_logits[0].numpy(),
                               atol=POOL_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, 1, :, :50].numpy(),
                                   want_cache[name][:, 0, :, :50].numpy(),
                                   atol=POOL_ATOL, rtol=0)
        assert not cache[name][:, 0].any()


# -- DenseChunkGraphs -------------------------------------------------------------

@pytest.mark.parametrize("mask_writes", [False, True])
def test_chunk_graphs_on_cpu_are_the_eager_chunk(models, mask_writes):
    """The engine's chunk over static buffers gives the eager
    ``decode_chunk``'s tokens, last tokens, positions and cache bit for
    bit; warming a step (its neutral run) leaves the cache as it was."""
    tmodel = models[1].model
    cache = _cache(5, 3)
    tokens = np.array([3, 7, 11])
    positions = np.array([12, 30, 5])
    active = np.array([True, True, False])
    eager = _torch_cache(cache)
    want, last, pos = ttf.decode_chunk(
        tmodel, eager, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(active), steps=3, window=32,
        mask_writes=mask_writes)
    tcache = _torch_cache(cache)
    runner = serving_graphs.DenseChunkGraphs(tmodel, tcache, 3, 4)
    assert runner.warm(32, mask_writes) is None
    _assert_rows_unchanged(tcache, cache, range(3))
    got = runner(tokens, positions, active, 3, 32, mask_writes)
    assert torch.equal(got, want)
    assert torch.equal(runner.tokens, last)
    assert torch.equal(runner.positions, pos)
    for name in ("k", "v"):
        assert torch.equal(tcache[name], eager[name])
    with pytest.raises(ValueError, match="steps"):
        runner(tokens, positions, active, 5, 32)


# -- the engine -------------------------------------------------------------------

def _serve(eng, cases):
    """Post (prompt, max_new) cases at once; the outputs in order."""
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = [pool.submit(eng.generate, [p], n) for p, n in cases]
        return [f.result(TIMEOUT_S)[0] for f in futures]


def _traffic(rng, name):
    if name == "one_request":
        return [(_prompt(rng, 7), 9)]
    if name == "mixed_shapes":
        return [(_prompt(rng, 3), 12), (_prompt(rng, 11), 5)]
    if name == "more_than_slots":
        return [(_prompt(rng, 2 + 3 * i), 3 + 2 * i) for i in range(5)]
    if name == "chunked_prefill":  # 40 tokens: three segments
        return [(_prompt(rng, 40), 8), (_prompt(rng, 3), 12)]
    return [(_prompt(rng, 9), 1)]  # one_token


@pytest.mark.parametrize("name", ["one_request", "mixed_shapes",
                                  "more_than_slots", "chunked_prefill",
                                  "one_token"])
def test_engine_matches_jax_generate(models, expect, engine, name):
    """The dense engine returns JAX's greedy tokens exactly, and the paged
    engine returns the same for the same traffic."""
    cases = _traffic(np.random.default_rng(len(name)), name)
    eng = engine()
    outs = _serve(eng, cases)
    for (prompt, max_new), got in zip(cases, outs):
        assert got == expect(prompt, max_new), (prompt, max_new)
    st = eng.stats()
    assert st["occupied_slots"] == 0 and st["queue_depth"] == 0
    if name == "chunked_prefill":
        # 3 segments for the long prompt, 1 single-shot for the short one.
        assert st["n_prefills"] == 4
    if name == "one_token":
        assert st["n_chunks"] == 0
    assert _serve(engine(kv_cache="paged", kv_block_size=4), cases) == outs


def test_engine_request_joins_mid_decode(models, expect, engine):
    """A short request posted while a long decode runs joins it and
    returns before the long one finishes; both match JAX."""
    eng = engine()
    eng.generate([[2, 2]], 3)
    long_out, long_done = {}, threading.Event()

    def run_long():
        long_out["tokens"] = eng.generate([[1, 2, 3, 4]], 56)
        long_done.set()

    t = threading.Thread(target=run_long)
    t.start()
    deadline = time.monotonic() + TIMEOUT_S
    while eng.stats()["steps_done"] < 8:
        assert time.monotonic() < deadline, "the long decode never started"
        time.sleep(0.005)
    (short,) = eng.generate([[9, 8, 7]], 3)
    assert not long_done.is_set(), "the short request waited for the long"
    t.join(TIMEOUT_S)
    assert short == expect([9, 8, 7], 3)
    assert long_out["tokens"][0] == expect([1, 2, 3, 4], 56)


def test_engine_rejects_oversized_and_samples_through_the_model(models,
                                                                engine):
    tmodel = models[1]
    eng = engine()
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate([[1] * 60], 8)
    kw = dict(temperature=1.0, top_k=8, seed=3)
    assert eng.generate([[4, 5, 6]], 5, **kw) == \
        tmodel.generate([[4, 5, 6]], 5, **kw)
    assert eng.stats()["n_prefills"] == 0


def test_engine_capped_window_768_matches_jax():
    """max_seq_len 768 (a 128-multiple, not a power of two): the final
    segment's window caps at 768, a window JAX accepts and so does the
    port; a 600-token prompt in three 256-token segments matches JAX."""
    shape = dict(SHAPE, vocab_size=128, d_ff=128, max_seq_len=768)
    jmodel = jserve.Model(jtf.TransformerConfig(**shape), seed=0)
    cfg = ttf.TransformerConfig(**shape)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    eng = tserve.ContinuousEngine(tmodel, max_slots=2, chunk=4,
                                  prefill_chunk=256)
    seg_windows, prefill_seg = [], eng._prefill_seg

    def recording_seg(*args, window, **kwargs):
        seg_windows.append(window)
        return prefill_seg(*args, window=window, **kwargs)

    eng._prefill_seg = recording_seg
    try:
        prompt = (np.arange(600) % 120 + 1).tolist()
        (got,) = eng.generate([prompt], 4)
    finally:
        eng.shutdown()
    assert eng.prefill_chunk == 256 and seg_windows == [256, 512, 768]
    assert got == jmodel.generate([prompt], 4)[0]


def test_engine_failed_chunk_fails_its_rows_and_keeps_the_cache(models,
                                                                expect,
                                                                engine):
    """A decode chunk that raises at dispatch fails its rows; the cache,
    where only those rows' entries may have been written, is kept (no
    reset), and the engine serves on."""
    eng = engine()
    chunk, faults = eng._chunk, []

    def chunk_failing_once(*args, **kwargs):
        if not faults:
            faults.append(1)
            raise RuntimeError("injected chunk fault")
        return chunk(*args, **kwargs)

    eng._chunk = chunk_failing_once
    with pytest.raises(RuntimeError, match="decode chunk failed"):
        eng.generate([[1, 2, 3]], 6)
    # The failed row's prefill stays in its (now free) cache row.
    assert eng.cache["k"].any()
    (got,) = eng.generate([[4, 5, 6]], 6)
    assert got == expect([4, 5, 6], 6)
    assert eng.stats()["occupied_slots"] == 0


def test_engine_failed_sync_zeroes_the_cache_in_place(models, expect,
                                                      engine):
    """A device error that surfaces at a sync fails the rows in flight
    and zeroes the cache in place (the chunk graphs hold its address);
    the engine serves on."""
    eng = engine()
    eng.generate([[9, 8, 7, 6, 5]], 2)
    ptrs = {n: c.data_ptr() for n, c in eng.cache.items()}
    to_host, faults = eng._to_host, []

    class Faulted:
        def numpy(self):
            raise RuntimeError("injected sync fault")

    def to_host_failing_at_the_chunk(tensor):
        if not faults and tensor.dim() == 2:  # a chunk's tokens
            faults.append(1)
            return Faulted(), None
        return to_host(tensor)

    eng._to_host = to_host_failing_at_the_chunk
    with pytest.raises(RuntimeError, match="decode chunk sync failed"):
        eng.generate([[1, 2, 3]], 6)
    assert {n: c.data_ptr() for n, c in eng.cache.items()} == ptrs
    assert eng.chunk_graphs.cache is eng.cache
    assert not any(c.any() for c in eng.cache.values())
    assert not eng.positions.any() and not eng.last_tok.any()
    (got,) = eng.generate([[4, 5, 6]], 6)
    assert got == expect([4, 5, 6], 6)


def test_engine_failed_sync_zeroes_the_cache_before_it_wakes_the_row(
        models, engine):
    """A failed sync resets the cache before it wakes the failed row's
    waiter: with a reset that sleeps before it zeroes, the cache is
    already zero when ``generate`` raises, not only some time later."""
    eng = engine()
    eng.generate([[9, 8, 7, 6, 5]], 2)
    to_host, reset, faults = eng._to_host, eng._reset_dense, []

    class Faulted:
        def numpy(self):
            raise RuntimeError("injected sync fault")

    def to_host_failing_at_the_chunk(tensor):
        if not faults and tensor.dim() == 2:  # a chunk's tokens
            faults.append(1)
            return Faulted(), None
        return to_host(tensor)

    def slow_reset(*args, **kwargs):
        time.sleep(0.5)
        return reset(*args, **kwargs)

    eng._to_host, eng._reset_dense = to_host_failing_at_the_chunk, slow_reset
    with pytest.raises(RuntimeError, match="decode chunk sync failed"):
        eng.generate([[1, 2, 3]], 6)
    assert not any(c.any() for c in eng.cache.values())


def test_engine_stats_keys_match_jax_and_kv_stats_is_none(models, engine):
    jmodel, _ = models
    jeng = jserve.ContinuousEngine(jmodel, start_loop=False, **ENGINE)
    eng = engine()
    eng.generate([[1, 2, 3]], 2)
    assert jeng.kv_cache == eng.kv_cache == "dense"
    assert set(eng.stats()) == set(jeng.stats())
    assert eng.kv_stats() is None and jeng.kv_stats() is None
    graphs = eng.graph_stats()
    assert graphs["graph_captures"] == graphs["graph_replays"] == 0
    assert graphs["eager_chunks_on_cuda"] == 0


def test_dense_engine_behind_the_http_server(models, expect, engine):
    eng = engine()
    server, state = tserve.start_server(eng, port=0, host="127.0.0.1")
    try:
        tserve.wait_ready(state, timeout=TIMEOUT_S)
        port = server.server_address[1]
        resp = tserve.post_generate(port, [[3, 1, 4, 1, 5]], 6)
        assert resp["tokens"] == [expect([3, 1, 4, 1, 5], 6)]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert r.status == 200
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    assert health == {"status": "ok", "queue_depth": 0, "occupied_slots": 0,
                      "max_slots": ENGINE["max_slots"]}


# -- warmup -----------------------------------------------------------------------

class _StubModel:
    def __init__(self, cfg):
        self.cfg = cfg
        self.params = {"w": jnp.zeros((4, 4))}
        self.mesh = None


@pytest.mark.parametrize("prefill_chunk,chunk", [(16, 4), (64, 8), (32, 1)])
def test_warm_plan_covers_the_jax_dense_grid_per_window(models,
                                                        prefill_chunk, chunk):
    """The same prefill and segment tasks as the JAX dense plan, label for
    label and in order; one decode task per (window, mask) where JAX has
    one per (steps, window, mask)."""
    kw = dict(ENGINE, prefill_chunk=prefill_chunk, chunk=chunk)
    eng = tserve.ContinuousEngine(models[1], start_loop=False, **kw)
    jeng = jserve.ContinuousEngine(
        _StubModel(jtf.TransformerConfig(**SHAPE)), start_loop=False, **kw)
    labels = [t.label for t in twarmup.warm_plan(eng)]
    jlabels = [t.label for t in jwarmup.warm_plan(jeng)]
    assert len(labels) == len(set(labels))
    for kind in ("prefill/", "prefill_seg/"):
        assert [lab for lab in labels if lab.startswith(kind)] == \
            [lab for lab in jlabels if lab.startswith(kind)]
    decode = [lab for lab in labels if lab.startswith("decode/")]
    jdecode = {tuple(lab.split("/")[2:]) for lab in jlabels
               if lab.startswith("decode/")}
    assert {tuple(lab.split("/")[1:]) for lab in decode} == jdecode
    assert len(decode) == len(jdecode)
    assert len(labels) == sum(lab.startswith(("prefill/", "prefill_seg/",
                                              "decode/")) for lab in labels)


def test_warm_engine_leaves_live_slots_and_host_state_alone(models, expect):
    """warm_engine with slot 0 live (its cache row random, its position
    and token set): the prefill tasks run in slot 1, the decode steps'
    writes are restored, and slot 0's cache, every position and last
    token come out as they were; then the engine serves as JAX does."""
    eng = tserve.ContinuousEngine(models[1], start_loop=False, **ENGINE)
    live = torch.from_numpy(_cache(7, 1)["k"][:, 0])
    eng.cache["k"][:, 0] = live
    eng.cache["v"][:, 0] = -live
    eng.occupied[0] = {"prompt": [1], "remaining": 3}
    eng.positions[0], eng.last_tok[0] = 17, 42
    summary = twarmup.warm_engine(eng)
    assert summary["tasks"] == summary["compiled"] == \
        len(twarmup.warm_plan(eng)) == 13
    assert summary["cache_hits"] == summary["cache_misses"] == 0
    assert torch.equal(eng.cache["k"][:, 0], live)
    assert torch.equal(eng.cache["v"][:, 0], -live)
    assert eng.positions.tolist() == [17, 0]
    assert eng.last_tok.tolist() == [42, 0]
    eng.occupied[0] = None
    with pytest.raises(RuntimeError, match="free slot"):
        eng.occupied = [{"remaining": 1}] * 2
        twarmup.warm_engine(eng)
    eng.occupied = [None] * 2
    eng.positions[:], eng.last_tok[:] = 0, 0
    eng._thread = threading.Thread(target=eng._loop, daemon=True)
    eng._thread.start()
    try:
        assert eng.generate([[5, 6, 7]], 5)[0] == expect([5, 6, 7], 5)
    finally:
        eng.shutdown()


# -- BatchingModel ----------------------------------------------------------------

class _Counting:
    """A wrapped model that records its calls: each row's answer is the
    row plus ``max_new`` copies of its first token."""

    def __init__(self, fail=False):
        self.cfg = ttf.TransformerConfig(**SHAPE)
        self.calls = []
        self.fail = fail

    def generate(self, tokens, max_new_tokens, **sampler):
        self.calls.append(([list(r) for r in tokens], max_new_tokens,
                           sampler))
        if self.fail:
            raise RuntimeError("injected batch fault")
        return [list(r) + [r[0]] * max_new_tokens for r in tokens]


def _post_all(batcher, requests, gap_s=0.0):
    with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
        futures = []
        for rows, max_new in requests:
            futures.append(pool.submit(batcher.generate, rows, max_new))
            time.sleep(gap_s)
        return [f.result(TIMEOUT_S) for f in futures]


def test_batcher_coalesces_compatible_greedy_requests():
    inner = _Counting()
    batcher = tserve.BatchingModel(inner, window_ms=5000, max_batch=4)
    try:
        reqs = [([[i + 1, 2, 3]], 4) for i in range(4)]
        outs = _post_all(batcher, reqs)
    finally:
        batcher.shutdown()
    assert len(inner.calls) == batcher.n_batches == 1
    assert batcher.batch_rows == 4 and len(batcher.queue_wait_s) == 4
    assert sorted(inner.calls[0][0]) == [[i + 1, 2, 3] for i in range(4)]
    for (rows, _), out in zip(reqs, outs):
        assert out == [rows[0] + [rows[0][0]] * 4]


def test_batcher_defers_incompatible_requests_and_samples_solo():
    """An incompatible request waits in the reorder buffer for a later
    round (not dropped, not closing the window); a sampled one runs alone
    on the wrapped model; ragged rows fail before they are queued."""
    inner = _Counting()
    # The window outlasts the three arrivals (0.1 s apart); the deferred
    # request's own round then waits it out alone.
    batcher = tserve.BatchingModel(inner, window_ms=800, max_batch=2)
    try:
        reqs = [([[1, 2, 3]], 4), ([[7, 7, 7, 7, 7]], 4), ([[4, 5, 6]], 4)]
        outs = _post_all(batcher, reqs, gap_s=0.1)
        for (rows, max_new), out in zip(reqs, outs):
            assert out == [rows[0] + [rows[0][0]] * max_new]
        assert [sorted(c[0]) for c in inner.calls] == \
            [[[1, 2, 3], [4, 5, 6]], [[7, 7, 7, 7, 7]]]
        sampled = batcher.generate([[1, 2]], 3, temperature=1.0, seed=5)
        assert sampled == [[1, 2, 1, 1, 1]]
        assert inner.calls[-1][2]["temperature"] == 1.0
        assert batcher.n_batches == 2
        calls = len(inner.calls)
        with pytest.raises(ValueError, match="rectangular"):
            batcher.generate([[1, 2], [3]], 2)
        with pytest.raises(ValueError, match="rectangular"):
            batcher.generate([], 2)
        assert len(inner.calls) == calls
    finally:
        batcher.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.generate([[1, 2, 3]], 4)


def test_batcher_gives_each_waiter_its_own_exception():
    inner = _Counting(fail=True)
    batcher = tserve.BatchingModel(inner, window_ms=5000, max_batch=2)
    errors = []

    def post(rows):
        try:
            batcher.generate(rows, 3)
        except RuntimeError as e:  # noqa: PERF203 - the point of the test
            errors.append(e)

    try:
        threads = [threading.Thread(target=post, args=([[i, 1]],))
                   for i in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
    finally:
        batcher.shutdown()
    assert len(inner.calls) == 1 and len(errors) == 2
    assert errors[0] is not errors[1]
    for e in errors:
        assert "co-batched generate failed" in str(e)
        assert str(e.__cause__) == "injected batch fault"
    assert errors[0].__cause__ is errors[1].__cause__


def test_batcher_on_real_weights_matches_jax(models, expect):
    batcher = tserve.BatchingModel(models[1], window_ms=5000, max_batch=3)
    rng = np.random.default_rng(12)
    prompts = [_prompt(rng, 6) for _ in range(3)]
    try:
        outs = _post_all(batcher, [([p], 7) for p in prompts])
    finally:
        batcher.shutdown()
    assert batcher.n_batches == 1 and batcher.batch_rows == 3
    for prompt, out in zip(prompts, outs):
        assert out == [expect(prompt, 7)]


# -- the CLI ----------------------------------------------------------------------

@pytest.mark.parametrize("extra,tasks", [
    ([], 13),  # dense: 1 prefill, 3 windows x 2 segments, 3 x 2 decode
    (["--kv-cache", "paged", "--kv-block-size", "4"], 9),
])
def test_serve_cli_continuous_batching_warmup_all_once_on_cpu(extra, tasks):
    """``--continuous-batching`` builds the dense engine by default, and
    ``--kv-cache paged`` the paged one; each warms its grid before ready
    and serves one request."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", *TINY_FLAGS,
         "--continuous-batching", "--max-slots", "2", "--decode-chunk", "4",
         "--prefill-chunk", "16", "--warmup", "all", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"warmup (all): {tasks} task(s)" in proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["tokens"][0]) == 4 and out["tokens"][0][:2] == [5, 6]


def test_serve_cli_batch_window_once_on_cpu(capsys):
    assert tserve.main(["--once", "--device", "cpu", "--port", "0",
                        *TINY_FLAGS, "--batch-window-ms", "5"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tokens"][0][:2] == [5, 6] and len(out["tokens"][0]) == 4


def test_speculate_on_the_dense_engine_falls_back_to_off(caplog):
    args = ["--once", "--device", "cpu", "--port", "0", *TINY_FLAGS,
            "--continuous-batching", "--speculate", "ngram"]
    with caplog.at_level(logging.WARNING, logger="serve_cli"):
        assert tserve.main(args) == 0
    assert "falling back to off" in caplog.text


def test_batch_window_raises_without_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--once", "--port", "0", *TINY_FLAGS,
                     "--batch-window-ms", "5"])
