# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The serving decode as one program per shape bucket, on the CPU, vs JAX.

On CUDA the port replays captured graphs (``models/serving_graphs.py``);
on the CPU the same step functions run eagerly over the same static
buffers, which is what these tests drive:

  * ``serving_shape_buckets`` against the JAX function;
  * ``PagedDecodeGraphs`` (the engine's decode chunk over static
    buffers) against the eager ``paged_decode_chunk`` and the JAX one
    (tokens and positions exact, pools bit-equal to the eager chunk and
    within ``POOL_ATOL`` of JAX's, f32);
  * ``decode_logits`` at a device position against the Python-position
    form (bit for bit) and JAX, and ``generate`` on a persistent cache;
  * the port's ``warmstart.warmup`` against the JAX plan, and what
    ``warm_engine`` may and may not touch;
  * ``serve_cli --warmup all``.

The model is the JAX ``init_params`` one (2 layers, d_model 64, 4 q
heads, 2 kv heads, vocab 256, context 64, f32), bridged with
``weights.params_from_jax``; block size 4.
"""

import json
import logging
import os
import subprocess
import sys
import threading

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
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
BS = 4
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16, kv_block_size=BS,
              kv_cache="paged")
BLOCKS_PER_SEQ = SHAPE["max_seq_len"] // BS
# f32 pools: the same projections in two frameworks, summed in other
# orders (one f32 ulp at these magnitudes is ~1e-7).
POOL_ATOL = 1e-5
LOGITS_ATOL = 1e-4
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


def _pools(seed, num_blocks):
    rng = np.random.default_rng(seed)
    shape = (SHAPE["n_layers"], num_blocks, SHAPE["n_kv_heads"], BS,
             SHAPE["d_model"] // SHAPE["n_heads"])
    return {n: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for n in ("k", "v")}


# -- serving_shape_buckets ------------------------------------------------------

@pytest.mark.parametrize("max_seq_len,prefill_chunk,decode_chunk,kw", [
    (128, 64, 4, {"block_size": 4}),
    (256, 64, 8, {}),
    (8192, 512, 32, {"block_size": 16, "speculate_widths": [2, 5, 9]}),
    (64, 16, 4, {"block_size": 4}),
    (100, 64, 32, {"block_size": 4}),  # a context that is no power of two
    (64, 64, 1, {"block_size": 16}),   # single-shot prefill, one-step chunks
])
def test_serving_shape_buckets_match_jax(max_seq_len, prefill_chunk,
                                         decode_chunk, kw):
    shape = dict(SHAPE, max_seq_len=max_seq_len)
    want = jtf.serving_shape_buckets(jtf.TransformerConfig(**shape),
                                     prefill_chunk, decode_chunk, **kw)
    got = ttf.serving_shape_buckets(ttf.TransformerConfig(**shape),
                                    prefill_chunk, decode_chunk, **kw)
    assert got == want


# -- the paged decode chunk over static buffers ---------------------------------

def _chunk_case(positions, active, seed):
    batch, num_blocks = len(positions), 1 + len(positions) * BLOCKS_PER_SEQ
    rng = np.random.default_rng(seed)
    # Disjoint pages per row, so no two rows write one block.
    tables = rng.permutation(np.arange(1, num_blocks)).reshape(batch, -1)
    return (tables.astype(np.int32), np.asarray(_prompt(rng, batch), np.int32),
            np.asarray(positions, np.int32), np.asarray(active),
            _pools(seed + 10, num_blocks))


@pytest.mark.parametrize("positions,active,steps,window", [
    ([9, 5, 29], [True, False, True], 4, 32),   # row 2 clamps at 31
    ([40, 3, 17], [True, False, True], 2, 64),
    ([0, 12, 61], [False, True, True], 3, 64),  # row 2 clamps at 63
    ([15, 7, 2], [True, True, False], 1, 16),
    ([30, 30, 30], [False, False, False], 2, 32),  # nothing decodes
])
def test_step_runner_matches_the_eager_chunk_and_jax(models, positions,
                                                     active, steps, window):
    jmodel, tmodel = models
    tables, tokens, positions, active, pools = _chunk_case(
        positions, active, steps + window)
    jtoks, jlast, jpools, jpos = jtf.paged_decode_chunk(
        jmodel.params, {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(tables), jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(active), cfg=jmodel.cfg, steps=steps, window=window,
        block_size=BS,
    )
    eager_pools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    toks, last, pos = ttf.paged_decode_chunk(
        tmodel.model, eager_pools, torch.from_numpy(tables).long(),
        torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        torch.from_numpy(active), steps=steps, window=window, block_size=BS,
    )
    graph_pools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    last_dev = torch.from_numpy(tokens).long()
    runner = serving_graphs.PagedDecodeGraphs(
        tmodel.model, graph_pools, last_dev, tables.shape, chunk=4,
        block_size=BS)
    out = runner(tables, positions, active, steps, window)
    assert out.shape == (steps, len(tokens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jtoks))
    assert torch.equal(out, toks)
    # The last tokens advanced in place in the engine's vector.
    assert torch.equal(last_dev, last)
    np.testing.assert_array_equal(last_dev.numpy(), np.asarray(jlast))
    assert torch.equal(runner.positions, pos)
    np.testing.assert_array_equal(runner.positions.numpy(), np.asarray(jpos))
    for name in ("k", "v"):
        assert torch.equal(graph_pools[name], eager_pools[name])
        np.testing.assert_allclose(graph_pools[name].numpy(),
                                   np.asarray(jpools[name]),
                                   atol=POOL_ATOL, rtol=0)
    assert runner.graphs.captures == runner.graphs.replays == 0


def test_step_runner_chunks_continue_from_the_tokens_they_left(models):
    """Two 2-step chunks through the runner (the host advancing the
    positions between them, as the engine does) are one 4-step eager
    chunk: the static buffers carry nothing stale across calls."""
    _, tmodel = models
    tables, tokens, positions, active, pools = _chunk_case(
        [9, 20, 33], [True, True, False], 7)
    eager_pools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    want, _, _ = ttf.paged_decode_chunk(
        tmodel.model, eager_pools, torch.from_numpy(tables).long(),
        torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        torch.from_numpy(active), steps=4, window=64, block_size=BS)
    graph_pools = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    runner = serving_graphs.PagedDecodeGraphs(
        tmodel.model, graph_pools, torch.from_numpy(tokens).long(),
        tables.shape, chunk=2, block_size=BS)
    first = runner(tables, positions, active, 2, 64).clone()
    second = runner(tables, positions + 2 * active, active, 2, 64)
    assert torch.equal(torch.cat([first, second]), want)
    with pytest.raises(ValueError, match="steps"):
        runner(tables, positions, active, 3, 64)


# -- the dense decode -------------------------------------------------------------

def test_decode_logits_at_a_device_position_is_the_int_form_and_jax(models):
    jmodel, tmodel = models
    rng = np.random.default_rng(8)
    toks = np.asarray([_prompt(rng, 11), _prompt(rng, 11)])
    ref_logits, ref_cache = jtf.prefill(
        jmodel.params, jnp.asarray(toks), jmodel.cfg, return_logits=True)
    nxt = np.argmax(np.asarray(ref_logits), axis=-1)
    ref_step, ref_cache = jtf.decode_logits(
        jmodel.params, ref_cache, jnp.asarray(nxt), 11, jmodel.cfg)
    _, cache_int = ttf.prefill(tmodel.model, torch.as_tensor(toks))
    cache_dev = {n: c.clone() for n, c in cache_int.items()}
    at_int = ttf.decode_logits(tmodel.model, cache_int, torch.as_tensor(nxt),
                               11)
    at_dev = ttf.decode_logits(tmodel.model, cache_dev, torch.as_tensor(nxt),
                               torch.tensor([11]), window=16)
    assert torch.equal(at_dev, at_int)
    for name in ("k", "v"):
        assert torch.equal(cache_dev[name], cache_int[name])
        np.testing.assert_allclose(cache_dev[name].numpy(),
                                   np.asarray(ref_cache[name]), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(at_dev.numpy(), np.asarray(ref_step),
                               atol=LOGITS_ATOL, rtol=0)
    with pytest.raises(ValueError, match="window"):
        ttf.decode_logits(tmodel.model, cache_dev, torch.as_tensor(nxt),
                          torch.tensor([12]))


def test_generate_reuses_one_dense_cache_per_batch_size(models):
    """The Model's decoder keeps one dense cache per batch size: a short
    prompt after a long one decodes over the long one's stale entries,
    which the length mask removes; both match JAX."""
    jmodel, tmodel = models
    rng = np.random.default_rng(9)
    long_prompt, short = _prompt(rng, 40), _prompt(rng, 3)
    assert tmodel.generate([long_prompt], 10) == \
        jmodel.generate([long_prompt], 10)
    cache = tmodel.decode_graphs.cache(1)
    assert cache["k"][:, :, :, 40:49].abs().sum() > 0
    assert tmodel.generate([short], 12) == jmodel.generate([short], 12)
    assert tmodel.decode_graphs.cache(1) is cache
    pair = [_prompt(rng, 6), _prompt(rng, 6)]
    assert tmodel.generate(pair, 5) == jmodel.generate(pair, 5)
    decoder = serving_graphs.DenseDecodeGraphs(tmodel.model)
    out = ttf.generate(tmodel.model, torch.as_tensor([short]),
                       max_new_tokens=12, decoder=decoder)
    assert out[0].tolist() == jmodel.generate([short], 12)[0]
    assert decoder.graphs.captures == decoder.graphs.replays == 0


@pytest.mark.parametrize("max_rows,batches,kept", [
    # 3 evicts 2, the least recently used; 4 then evicts 1 and 3.
    (4, [1, 2, 1, 3, 4, 2], [(1,), (1, 2), (2, 1), (1, 3), (4,), (2,)]),
    # A batch above the limit is kept alone, until the next other size.
    (1, [1, 2, 2, 1, 3], [(1,), (2,), (2,), (1,), (3,)]),
    (8, [1, 2, 3, 2, 1, 4, 5], [(1,), (1, 2), (1, 2, 3), (1, 3, 2),
                                (3, 2, 1), (2, 1, 4), (5,)]),
])
def test_dense_decoder_keeps_at_most_max_rows_of_cache(models, max_rows,
                                                       batches, kept):
    """However many batch sizes the decoder serves, the dense caches it
    keeps hold at most ``max_rows`` rows (or the one batch just served,
    if larger): the least recently used go first. A batch served again
    after its eviction starts from a fresh cache and still matches JAX."""
    jmodel, tmodel = models
    cfg = tmodel.model.cfg
    row_bytes = sum(t.nbytes
                    for t in ttf.init_kv_cache(cfg, 1, "cpu").values())
    decoder = serving_graphs.DenseDecodeGraphs(tmodel.model,
                                               max_rows=max_rows)
    rng = np.random.default_rng(max_rows)
    for batch, want in zip(batches, kept):
        prompts = [_prompt(rng, 5) for _ in range(batch)]
        ttf.generate(tmodel.model, torch.as_tensor(prompts),
                     max_new_tokens=2, decoder=decoder)
        assert decoder.cached_batches == want
        assert decoder.cached_bytes() == sum(want) * row_bytes
        assert sum(want) <= max(max_rows, batch)
    assert batches[0] not in decoder.cached_batches and decoder.evictions
    again = [_prompt(rng, 7) for _ in range(batches[0])]
    out = ttf.generate(tmodel.model, torch.as_tensor(again),
                       max_new_tokens=4, decoder=decoder)
    assert out.tolist() == jmodel.generate(again, 4)


def test_model_decoder_keeps_the_default_row_limit(models):
    assert models[1].decode_graphs.max_rows == \
        serving_graphs.MAX_CACHED_ROWS == tserve.MAX_BATCH
    with pytest.raises(ValueError, match="max_rows"):
        serving_graphs.DenseDecodeGraphs(models[1].model, max_rows=0)


# -- warmup ---------------------------------------------------------------------

class _StubModel:
    def __init__(self, cfg):
        self.cfg = cfg
        self.params = {"w": jnp.zeros((4, 4))}
        self.mesh = None


@pytest.mark.parametrize("prefill_chunk,chunk", [(16, 4), (64, 8), (32, 1)])
def test_warm_plan_covers_the_jax_grid_per_window(models, prefill_chunk,
                                                  chunk):
    """The same prefill tasks as the JAX plan (labels equal: every
    paged_prefill pair, mid segments only at the full prefill chunk),
    one decode task per window where JAX has one per (steps, window),
    and no dense task."""
    tmodel = models[1]
    kw = dict(ENGINE, prefill_chunk=prefill_chunk, chunk=chunk)
    eng = tserve.ContinuousEngine(tmodel, start_loop=False, **kw)
    jeng = jserve.ContinuousEngine(
        _StubModel(jtf.TransformerConfig(**SHAPE)), start_loop=False,
        **kw)
    labels = [t.label for t in twarmup.warm_plan(eng)]
    jlabels = [t.label for t in jwarmup.warm_plan(jeng)]
    assert len(labels) == len(set(labels))
    assert all(lab.startswith(("pprefill/", "pdecode/")) for lab in labels)
    prefill = [lab for lab in labels if lab.startswith("pprefill/")]
    assert prefill == [lab for lab in jlabels if lab.startswith("pprefill/")]
    mids = [lab for lab in prefill if lab.endswith("/mid")]
    if prefill_chunk < SHAPE["max_seq_len"]:
        assert mids and all(
            lab.startswith(f"pprefill/c{eng.prefill_chunk}/") for lab in mids)
    else:
        assert not mids
    buckets = ttf.serving_shape_buckets(eng.cfg, eng.prefill_chunk, eng.chunk,
                                        block_size=BS)
    for c, w in buckets["paged_prefill"]:
        assert f"pprefill/c{c}/w{w}/logits" in labels
    decode = [lab for lab in labels if lab.startswith("pdecode/")]
    assert decode == [f"pdecode/w{w}" for w in buckets["windows"]]
    jwindows = {lab.split("/")[2] for lab in jlabels
                if lab.startswith("pdecode/")}
    assert {lab.split("/")[1] for lab in decode} == jwindows


def test_warm_engine_touches_only_the_null_block(models, engine):
    """warm_engine runs every task on the loop thread and leaves the
    pools (but block 0), last_dev, the page tables and the radix index
    as they were; the engine serves on as JAX does."""
    jmodel, _ = models
    eng = engine()
    rng = np.random.default_rng(10)
    prompt = _prompt(rng, 21)
    (cached,) = eng.generate([prompt], 6)
    pools = {n: p.clone() for n, p in eng.cache.items()}
    last, tables = eng.last_dev.clone(), eng.kv.tables.copy()
    kv, match = eng.kv_stats(), eng.kv.radix.match(cached)
    threads, warm = [], eng.decode_graphs.warm

    def warm_recording(window):
        threads.append(threading.current_thread())
        return warm(window)

    eng.decode_graphs.warm = warm_recording
    summary = twarmup.warm_engine(eng)
    n_tasks = len(twarmup.warm_plan(eng))
    assert summary["tasks"] == summary["compiled"] == n_tasks
    assert set(summary) == set(jwarmup.build_summary(
        "all", 0, 0, 0, 0, 0.0, {"hits": 0, "misses": 0},
        {"hits": 0, "misses": 0}))
    # JAX's counts: no compile cache armed, nothing hit or missed.
    assert summary["cache_hits"] == summary["cache_misses"] == 0
    assert threads and set(threads) == {eng._thread}
    for name in ("k", "v"):
        assert torch.equal(eng.cache[name][:, 1:], pools[name][:, 1:])
    assert torch.equal(eng.last_dev, last)
    np.testing.assert_array_equal(eng.kv.tables, tables)
    assert eng.kv_stats() == kv and eng.kv.radix.match(cached) == match
    follow = cached + _prompt(rng, 2)
    (got,) = eng.generate([follow], 5)
    assert got == jmodel.generate([follow], 5)[0]
    assert eng.kv_stats()["prefix_hit_tokens"] > kv["prefix_hit_tokens"]


def test_warm_engine_modes(models):
    eng = tserve.ContinuousEngine(models[1], start_loop=False, **ENGINE)
    lazy = twarmup.warm_engine(eng, mode="lazy")
    assert lazy["mode"] == "lazy" and lazy["tasks"] == lazy["compiled"] == 0
    with pytest.raises(ValueError, match="unknown warmup mode"):
        twarmup.warm_engine(eng, mode="eager")
    # Without a loop thread the pass runs on the caller's.
    assert twarmup.warm_engine(eng)["tasks"] == len(twarmup.warm_plan(eng))


def test_reset_keeps_the_pools_in_place_and_zeroes_them(models, engine):
    jmodel, _ = models
    eng = engine()
    eng.generate([[9, 8, 7, 6, 5]], 3)
    ptrs = {n: p.data_ptr() for n, p in eng.cache.items()}
    last_ptr = eng.last_dev.data_ptr()
    assert any(p.abs().sum() > 0 for p in eng.cache.values())
    eng.run_on_loop(lambda: eng._reset_paged(RuntimeError("test reset")))
    assert {n: p.data_ptr() for n, p in eng.cache.items()} == ptrs
    assert eng.last_dev.data_ptr() == last_ptr
    assert eng.decode_graphs.tokens is eng.last_dev
    assert not any(p.any() for p in eng.cache.values())
    assert not eng.last_dev.any() and eng._kv_epoch == 1
    (got,) = eng.generate([[4, 5, 6]], 6)
    assert got == jmodel.generate([[4, 5, 6]], 6)[0]


def test_warmup_all_on_a_plain_model_falls_back(models, caplog):
    state = {"ready": False}
    with caplog.at_level(logging.WARNING, logger="serve_cli"):
        tserve.warmup(models[1], state, "", mode="all")
    assert state["ready"] and "warmup" not in state
    assert "--warmup=all needs --continuous-batching" in caplog.text


def test_serve_cli_warmup_all_runs_the_grid_before_ready():
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", "--n-layers", "1",
         "--d-model", "64", "--n-heads", "2", "--seq-len", "64",
         "--vocab-size", "256", "--continuous-batching",
         "--kv-cache", "paged", "--kv-block-size", "4", "--max-slots", "2", "--decode-chunk", "4",
         "--prefill-chunk", "16", "--warmup", "all"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stderr.splitlines()
    warm = [i for i, line in enumerate(lines) if "warmup (all): " in line]
    ready = [i for i, line in enumerate(lines) if "serving ready" in line]
    # 6 prefill tasks (segment 16 in windows 16, 32, 64; mid and logits)
    # and 3 decode windows.
    assert warm and ready and warm[0] < ready[0], proc.stderr
    assert "warmup (all): 9 task(s)" in lines[warm[0]]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["tokens"][0][:2] == [5, 6]
