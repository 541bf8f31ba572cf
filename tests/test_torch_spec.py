# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's speculative decoding vs the JAX package (CPU, f32).

The same setup as tests/test_torch_paged.py: the JAX ``init_params``
weights of a 2-layer model (d_model 64, 4 q heads, 2 kv heads, vocab 256,
context 64), bridged with ``weights.params_from_jax``, block size 4, the
JAX flash forward in Pallas interpret mode and the port's through its
plain version:

  * the flash forward at per-row bases (the kernel's device-memory
    ``base``) against per-row int calls and JAX ``_flash_fwd`` at a
    traced ``q_base``;
  * ``paged_write_positions``, ``paged_verify_chunk`` and
    ``paged_verify_batch`` against JAX on the same pools and tables
    (greedy tokens exact, pools within ``POOL_ATOL``), and
    ``PagedVerifyGraphs`` against the eager batch;
  * the proposer copy step for step against JAX's, ``speculate_grid``,
    ``verify_batch_sizes`` and ``DraftProposer`` on JAX's draft weights;
  * ``ContinuousEngine`` with ``speculate`` ngram and draft: tokens equal
    to ``speculate="off"`` and to JAX ``Model.generate``; device steps
    per token under an oracle and an always-wrong proposer; validation,
    the warm plan's JAX labels, slot release on retire, failure and
    reset; the CLI.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.ops import attention as jattn  # noqa: E402
from container_engine_accelerators_tpu.ops import paged_attention as jpa  # noqa: E402
from container_engine_accelerators_tpu.spec import draft as jdraft  # noqa: E402
from container_engine_accelerators_tpu.spec import proposer as jprop  # noqa: E402
from container_engine_accelerators_tpu.warmstart import (  # noqa: E402
    warmup as jwarmup,
)
from container_engine_accelerators_tpu_torch import spec as tspec  # noqa: E402
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
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention as tattn,
)
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    paged_attention as tpa,
)
from container_engine_accelerators_tpu_torch.warmstart import (  # noqa: E402
    warmup as twarmup,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--n-layers", "1", "--d-model", "64", "--n-heads", "2",
              "--seq-len", "64", "--vocab-size", "256"]
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
BS = 4
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16, kv_block_size=BS,
              kv_cache="paged")
BLOCKS_PER_SEQ = SHAPE["max_seq_len"] // BS
HD = SHAPE["d_model"] // SHAPE["n_heads"]
# f32 attention and pools: the same arithmetic in two frameworks, summed
# in other orders (one f32 ulp at these magnitudes is ~1e-7).
ATTN_ATOL = 1e-5
POOL_ATOL = 1e-5
TIMEOUT_S = 120
V = SHAPE["vocab_size"]


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
    return rng.integers(1, V, n).tolist()


def _pools(seed, num_blocks):
    rng = np.random.default_rng(seed)
    shape = (SHAPE["n_layers"], num_blocks, SHAPE["n_kv_heads"], BS, HD)
    return {n: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for n in ("k", "v")}


def _torch_pools(pools):
    return {n: torch.from_numpy(p.copy()) for n, p in pools.items()}


def _assert_pools_close(got, want):
    """Every block but the null one, whose garbage depends on the order
    of the padding writes."""
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy()[:, 1:],
                                   np.asarray(want[name])[:, 1:],
                                   atol=POOL_ATOL, rtol=0)


# -- the flash forward at per-row bases ----------------------------------------

@pytest.mark.parametrize("q_bases,seq_q,seq_k", [
    ([0, 17, 40], 16, 64),      # verify rows: a window at decode positions
    ([5, 120, 63, 200], 8, 256),
])
def test_flash_fwd_per_row_bases_match_int_calls_and_jax(q_bases, seq_q,
                                                         seq_k):
    """One call with a (B, 3) base equals B calls at int bases and JAX
    ``_flash_fwd`` at each row's traced q_base (Pallas interpret)."""
    rng = np.random.default_rng(len(q_bases))
    b = len(q_bases)
    q = rng.standard_normal((b, 4, seq_q, 32)).astype(np.float32)
    k = rng.standard_normal((b, 2, seq_k, 32)).astype(np.float32)
    v = rng.standard_normal((b, 2, seq_k, 32)).astype(np.float32)
    base = torch.tensor([[qb, 0, seq_k] for qb in q_bases],
                        dtype=torch.int32)
    kw = dict(causal=True, sm_scale=32 ** -0.5)
    out, lse = tattn.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), base=base, **kw)

    @jax.jit
    def jfwd(q, k, v, q_base):
        return jattn._flash_fwd(q, k, v, block_q=seq_q, block_k=64,
                                interpret=True, q_base=q_base, **kw)

    for i, qb in enumerate(q_bases):
        row = slice(i, i + 1)
        one, one_lse = tattn.flash_fwd(
            torch.from_numpy(q[row]), torch.from_numpy(k[row]),
            torch.from_numpy(v[row]), q_base=qb, **kw)
        assert torch.equal(out[row], one) and torch.equal(lse[row], one_lse)
        jout, jlse = jfwd(q[row], k[row], v[row], jnp.int32(qb))
        np.testing.assert_allclose(out[row].numpy(), np.asarray(jout),
                                   atol=ATTN_ATOL, rtol=0)
        np.testing.assert_allclose(lse[row].numpy(), np.asarray(jlse),
                                   atol=ATTN_ATOL, rtol=0)


def test_flash_fwd_per_row_k_base_and_kv_len_match_int_calls():
    """Every field of the base is per row, and kv_len is clamped to
    [0, Sk] as the kernel clamps it (here no host int() of it)."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(4, 2, 5, 16, generator=gen)
    k = torch.randn(4, 1, 20, 16, generator=gen)
    v = torch.randn(4, 1, 20, 16, generator=gen)
    rows = [[3, 0, 20], [10, 4, 15], [30, 2, 99], [7, 0, -3]]
    for causal in (True, False):
        out, lse = tattn.flash_fwd(
            q, k, v, causal=causal, sm_scale=0.25,
            base=torch.tensor(rows, dtype=torch.int32))
        for i, (qb, kb, kv) in enumerate(rows):
            one, one_lse = tattn.flash_fwd(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
                sm_scale=0.25, q_base=qb, k_base=kb,
                kv_len=max(0, min(kv, 20)))
            assert torch.equal(out[i:i + 1], one)
            assert torch.equal(lse[i:i + 1], one_lse)
    # kv_len -3 leaves row 3 no key: out 0, lse -1e30.
    assert not out[3].any() and (lse[3] <= -1e29).all()


# -- the verify programs --------------------------------------------------------

def test_paged_write_positions_matches_jax_with_null_redirect():
    rng = np.random.default_rng(4)
    pool = np.zeros((6, 2, 4, 8), np.float32)
    new = rng.standard_normal((2, 2, 5, 8)).astype(np.float32)
    bids = np.array([[2, 2, 3, jpa.NULL_BLOCK, 5],
                     [4, 4, 4, 4, jpa.NULL_BLOCK]], np.int32)
    offs = np.array([[2, 3, 0, 1, 3], [0, 1, 2, 3, 0]], np.int32)
    want = jnp.asarray(pool)
    for b in range(2):
        want = jpa.paged_write_positions(want, jnp.asarray(new[b:b + 1]),
                                         jnp.asarray(bids[b]),
                                         jnp.asarray(offs[b]))
    got = torch.from_numpy(pool.copy())
    tpa.paged_write_positions(got, torch.from_numpy(new),
                              torch.from_numpy(bids).long(),
                              torch.from_numpy(offs).long())
    # The null block holds garbage by definition; every other block is
    # JAX's, and untargeted slots stay zero.
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    assert not got[5, :, :3].any() and not got[1].any()


def _verify_case(rng, poss, num_blocks, width=16):
    """Per-row verify operands over disjoint random page tables: segments,
    write targets from the manager's rule (null past the context end) and
    tables; rows with pos None are padding (null targets and tables)."""
    S = SHAPE["max_seq_len"]
    perm = rng.permutation(np.arange(1, num_blocks))
    b = len(poss)
    segs = np.zeros((b, width), np.int32)
    bids = np.full((b, width), tpa.NULL_BLOCK, np.int32)
    offs = np.zeros((b, width), np.int32)
    tables = np.full((b, BLOCKS_PER_SEQ), tpa.NULL_BLOCK, np.int32)
    real = []
    for i, pos in enumerate(poss):
        if pos is None:
            continue
        real.append(i)
        tables[i] = perm[i * BLOCKS_PER_SEQ:(i + 1) * BLOCKS_PER_SEQ]
        segs[i] = _prompt(rng, width)
        for j, p in enumerate(range(pos, pos + width)):
            offs[i, j] = p % BS
            if p < S:
                bids[i, j] = tables[i, p // BS]
    return segs, bids, offs, tables, real


def _window(poss, width=16):
    S = SHAPE["max_seq_len"]
    return ttf._window_for(min(max(p or 0 for p in poss) + width, S), S)


@pytest.mark.parametrize("pos", [9, 50])  # 50: the tail runs past the end
def test_paged_verify_chunk_matches_jax(models, pos):
    jmodel, tmodel = models
    rng = np.random.default_rng(pos)
    num_blocks = 1 + BLOCKS_PER_SEQ
    segs, bids, offs, tables, _ = _verify_case(rng, [pos], num_blocks)
    window = _window([pos])
    pools = _pools(pos, num_blocks)
    jgreedy, jpools = jtf.paged_verify_chunk(
        jmodel.params, {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(segs), pos, jnp.asarray(bids[0]), jnp.asarray(offs[0]),
        jnp.asarray(tables[0]), cfg=jmodel.cfg, window=window,
        block_size=BS)
    tpools = _torch_pools(pools)
    greedy = ttf.paged_verify_chunk(
        tmodel.model, tpools, torch.from_numpy(segs).long(), pos,
        torch.from_numpy(bids[0]).long(), torch.from_numpy(offs[0]).long(),
        torch.from_numpy(tables[0]).long(), window=window, block_size=BS)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    _assert_pools_close(tpools, jpools)


@pytest.mark.parametrize("poss", [
    [13],
    [6, 21],
    [5, None, 30, None],   # padding rows: null targets and tables
])
def test_paged_verify_batch_matches_jax(models, poss):
    """Greedy tokens exactly JAX's scan of the one-row program, pools
    within POOL_ATOL, and padding rows write only the null block."""
    jmodel, tmodel = models
    rng = np.random.default_rng(len(poss))
    num_blocks = 1 + len(poss) * BLOCKS_PER_SEQ
    segs, bids, offs, tables, real = _verify_case(rng, poss, num_blocks)
    window = _window(poss)
    pos_arr = np.asarray([p or 0 for p in poss], np.int32)
    pools = _pools(len(poss) + 20, num_blocks)
    jgreedy, jpools = jtf.paged_verify_batch(
        jmodel.params, {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(segs), jnp.asarray(pos_arr), jnp.asarray(bids),
        jnp.asarray(offs), jnp.asarray(tables), cfg=jmodel.cfg,
        window=window, block_size=BS)
    tpools = _torch_pools(pools)
    greedy = ttf.paged_verify_batch(
        tmodel.model, tpools, torch.from_numpy(segs).long(),
        torch.from_numpy(pos_arr).long(), torch.from_numpy(bids).long(),
        torch.from_numpy(offs).long(), torch.from_numpy(tables).long(),
        window=window, block_size=BS)
    assert greedy.shape == (len(poss), 16)
    np.testing.assert_array_equal(greedy.numpy()[real],
                                  np.asarray(jgreedy)[real])
    _assert_pools_close(tpools, jpools)
    # Blocks no real row targets are as they were (padding rows and the
    # null block aside).
    targeted = {int(x) for i in real for x in bids[i]} | {tpa.NULL_BLOCK}
    for blk in set(range(num_blocks)) - targeted:
        for name in ("k", "v"):
            assert np.array_equal(tpools[name][:, blk].numpy(),
                                  pools[name][:, blk])


def test_verify_graphs_on_the_cpu_equal_the_eager_batch(models):
    """PagedVerifyGraphs (eager on the CPU, over its static buffers)
    gives the eager batch's tokens and pools; a new bucket gets its own
    buffers, a used one keeps them."""
    tmodel = models[1].model
    rng = np.random.default_rng(8)
    poss = [11, 27]
    num_blocks = 1 + 2 * BLOCKS_PER_SEQ
    segs, bids, offs, tables, _ = _verify_case(rng, poss, num_blocks)
    window = _window(poss)
    pools = _pools(8, num_blocks)
    eager_pools, graph_pools = _torch_pools(pools), _torch_pools(pools)
    want = ttf.paged_verify_batch(
        tmodel, eager_pools, torch.from_numpy(segs).long(),
        torch.tensor(poss), torch.from_numpy(bids).long(),
        torch.from_numpy(offs).long(), torch.from_numpy(tables).long(),
        window=window, block_size=BS)
    runner = serving_graphs.PagedVerifyGraphs(tmodel, graph_pools, 16,
                                              BLOCKS_PER_SEQ, BS)
    got = runner(segs, poss, bids, offs, tables, window)
    buffers = runner.buffers(2)
    assert got is buffers["greedy"] and torch.equal(got, want)
    for name in ("k", "v"):
        assert torch.equal(graph_pools[name][:, 1:], eager_pools[name][:, 1:])
    assert runner.warm(1, 16) is None and runner.buffers(2) is buffers
    assert set(runner._buffers) == {1, 2} and len(runner.graphs) == 0


# -- the host half --------------------------------------------------------------

_slots = st.integers(0, 1)
_toks = st.lists(st.integers(0, 3), max_size=12)
_ops = st.lists(st.one_of(
    st.tuples(st.just("admit"), _slots, _toks),
    st.tuples(st.just("observe"), _slots, _toks),
    st.tuples(st.just("propose"), _slots, st.integers(0, 9)),
    st.tuples(st.just("release"), _slots),
), max_size=30)


@settings(max_examples=60, deadline=None)
@given(ops=_ops, n=st.tuples(st.integers(1, 3), st.integers(0, 2)))
def test_ngram_proposer_copy_steps_like_jax(ops, n):
    min_n, max_n = n[0], n[0] + n[1]
    ours = tspec.NgramProposer(min_n=min_n, max_n=max_n)
    theirs = jprop.NgramProposer(min_n=min_n, max_n=max_n)
    for op in ops:
        got = getattr(ours, op[0])(*op[1:])
        want = getattr(theirs, op[0])(*op[1:])
        assert got == want, op


@settings(max_examples=60, deadline=None)
@given(k_max=st.integers(1, 16), cooldown=st.integers(0, 4),
       ops=st.lists(st.one_of(
           st.tuples(st.just("update"), st.integers(0, 16),
                     st.integers(0, 16)),
           st.tuples(st.just("tick"))), max_size=40))
def test_adaptive_k_copy_steps_like_jax(k_max, cooldown, ops):
    ours = tspec.AdaptiveK(k_max=k_max, cooldown=cooldown)
    theirs = jprop.AdaptiveK(k_max=k_max, cooldown=cooldown)
    assert ours.k == theirs.k
    for op in ops:
        getattr(ours, op[0])(*op[1:])
        getattr(theirs, op[0])(*op[1:])
        assert ours.k == theirs.k, op


@pytest.mark.parametrize("speculate_k,max_seq_len,max_slots", [
    (8, 64, 2), (1, 64, 8), (6, 8192, 8), (16, 8192, 5), (3, 20, 3),
])
def test_speculate_grid_and_verify_batch_sizes_match_jax(speculate_k,
                                                         max_seq_len,
                                                         max_slots):
    assert tserve.speculate_grid(speculate_k, max_seq_len) == \
        jserve.speculate_grid(speculate_k, max_seq_len)
    assert tserve.verify_batch_sizes(max_slots) == \
        jserve.verify_batch_sizes(max_slots)


def test_draft_proposer_on_jax_params_proposes_jax_tokens():
    """The port's DraftProposer on JAX's draft weights proposes JAX's
    tokens round for round: bulk prefill at admission, the forced-token
    ingest after confirmed tokens, the propose chunk's steps."""
    jcfg = jdraft.draft_config(jtf.TransformerConfig(**SHAPE))
    tcfg = tspec.draft_config(ttf.TransformerConfig(**SHAPE))
    assert dataclasses_equal(jcfg, tcfg)
    jparams = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    kw = dict(block_size=BS, prefill_chunk=16, width=16)
    theirs = jdraft.DraftProposer(jcfg, 2, params=jparams, **kw)
    ours = tspec.DraftProposer(
        tcfg, 2, device="cpu", params=weights.params_from_jax(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"), **kw)
    rng = np.random.default_rng(9)
    ctx = _prompt(rng, 25)
    rounds = [("admit", 1, ctx), ("propose", 1, 8),
              ("observe", 1, [7, 8, 9]), ("propose", 1, 4),
              ("admit", 0, ctx[:6]), ("propose", 0, 3),
              ("observe", 1, _prompt(rng, 20)), ("propose", 1, 8),
              ("release", 1), ("propose", 1, 2)]
    for op in rounds:
        want = getattr(theirs, op[0])(*op[1:])
        got = getattr(ours, op[0])(*op[1:])
        assert got == want, op
    assert ours.kv.stats()["free_blocks"] == theirs.kv.stats()["free_blocks"]


def dataclasses_equal(jcfg, tcfg):
    return all(getattr(jcfg, f) == getattr(tcfg, f)
               for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                         "n_kv_heads", "d_ff", "max_seq_len", "dtype"))


# -- the engine -----------------------------------------------------------------

def _mixed_cases(rng, n):
    """The mix of test_spec.py's ``_mixed_cases``: repetitive-suffix
    prompts (a run resumed mid-way), shared-prefix ones and structureless
    ones."""
    cases = []
    for _ in range(n):
        kind = rng.integers(3)
        if kind == 0:
            start = int(rng.integers(V))
            run = [(start + j) % V for j in range(24)]
            cases.append(run + run[:4 + int(rng.integers(3))])
        elif kind == 1:
            prefix = [(j % 9) + 1 for j in range(12)]
            cases.append(prefix + _prompt(rng, 1 + int(rng.integers(4))))
        else:
            cases.append(_prompt(rng, 3 + int(rng.integers(8))))
    return cases


def _serve_all(eng, cases, max_new):
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = [pool.submit(eng.generate, [c], max_new) for c in cases]
        return [f.result(TIMEOUT_S)[0] for f in futures]


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculating_engine_gives_the_tokens_of_off_and_jax(models, engine,
                                                            mode):
    """More concurrent requests than slots, a repetitive/shared/random
    mix: the speculating engine's tokens are exactly those of
    ``speculate="off"`` and of JAX's dense greedy generate."""
    jmodel, _ = models
    cases = _mixed_cases(np.random.default_rng(11), 6)
    off = _serve_all(engine(), cases, 10)
    eng = engine(speculate=mode)
    got = _serve_all(eng, cases, 10)
    for prompt, a, b in zip(cases, got, off):
        assert a == b == jmodel.generate([prompt], 10)[0], prompt
    stats = eng.stats()
    assert stats["spec_verifies"] > 0 and stats["spec_proposed"] > 0
    assert stats["occupied_slots"] == 0 and not eng._spec_owner
    kv = eng.kv_stats()
    assert kv["free_blocks"] + kv["cached_blocks"] == kv["total_blocks"]


class _Oracle(tspec.Proposer):
    """Proposes the true continuation (``truth``: prompt tuple -> the
    full greedy sequence), or with ``wrong`` a token off by one at every
    position; records its releases."""

    source = "oracle"

    def __init__(self, truth, wrong=False):
        self.truth, self.wrong = truth, wrong
        self.ctx, self.released = {}, []

    def admit(self, slot, ctx):
        self.ctx[slot] = list(ctx)

    def observe(self, slot, tokens):
        if slot in self.ctx:
            self.ctx[slot].extend(int(t) for t in tokens)

    def propose(self, slot, k):
        ctx = self.ctx.get(slot)
        if ctx is None:
            return []
        full = next(seq for p, seq in self.truth.items()
                    if ctx[:len(p)] == list(p))
        props = full[len(ctx):len(ctx) + k]
        return [(t + 1) % V for t in props] if self.wrong else props

    def release(self, slot):
        self.released.append(slot)
        self.ctx.pop(slot, None)


def _steps_per_token(models, engine, wrong):
    jmodel, _ = models
    rng = np.random.default_rng(12)
    prompts = [_prompt(rng, 9 + i) for i in range(4)]
    truth = {tuple(p): jmodel.generate([p], 24)[0] for p in prompts}
    oracle = _Oracle(truth, wrong=wrong)
    eng = engine(speculate="ngram", spec_proposer=oracle)
    tokens = 0
    for p in prompts:  # batch 1: one request at a time
        (got,) = eng.generate([p], 24)
        assert got == truth[tuple(p)]
        tokens += 24 - 1  # decode tokens (the first comes from prefill)
    assert sorted(set(oracle.released)) == [0] and not eng._spec_owner
    return eng.stats()["steps_done"] / tokens, eng.stats()


def test_oracle_proposer_halves_the_device_steps_per_token(models, engine):
    """The port's form of test_spec.py's step-reduction pin: a proposer
    that guesses right retires batch-1 traffic in <= 0.5 device steps
    (verify dispatches + chunk steps) per generated token."""
    ratio, stats = _steps_per_token(models, engine, wrong=False)
    assert ratio <= 0.5, (ratio, stats)
    assert stats["spec_acceptance"] == 1.0
    assert stats["spec_accepted"] > 0


def test_wrong_proposer_stays_within_the_one_step_per_token_baseline(
        models, engine):
    """The port's form of test_spec.py's adaptive-backoff pin: a
    proposer that is always wrong costs at most 1.05 device steps per
    generated token (each probing verify still emits its correction)."""
    ratio, stats = _steps_per_token(models, engine, wrong=True)
    assert ratio <= 1.05, (ratio, stats)
    assert stats["spec_accepted"] == 0 and stats["spec_verifies"] > 0


def test_retired_rows_carry_their_accepted_count(models, engine):
    jmodel, _ = models
    prompt = list(range(30, 40))
    truth = {tuple(prompt): jmodel.generate([prompt], 12)[0]}
    eng = engine(speculate="ngram", spec_proposer=_Oracle(truth))
    eng.generate([prompt], 12)
    assert list(eng.retired_spec_accepted) == [eng.stats()["spec_accepted"]]
    assert eng.retired_spec_accepted[0] > 0


def test_engine_validates_speculate_config(models):
    """As test_spec.py's validation: an unknown mode, speculation off the
    paged cache, and a draft without model params raise."""
    tmodel = models[1]

    class _NoParams:
        cfg = tmodel.cfg
        device = tmodel.device
        model = None

    with pytest.raises(ValueError, match="paged"):
        tserve.ContinuousEngine(tmodel, start_loop=False, kv_cache="dense",
                                speculate="ngram")
    with pytest.raises(ValueError, match="speculate"):
        tserve.ContinuousEngine(tmodel, start_loop=False, kv_block_size=BS,
                                speculate="turbo")
    with pytest.raises(ValueError, match="draft"):
        tserve.ContinuousEngine(_NoParams(), start_loop=False,
                                kv_cache="paged", kv_block_size=BS,
                                speculate="draft")
    eng = tserve.ContinuousEngine(tmodel, start_loop=False, **ENGINE)
    assert eng.spec_proposer is None and eng.verify_graphs is None
    assert "spec_proposed" not in eng.stats()


class _StubModel:
    def __init__(self, cfg):
        self.cfg = cfg
        self.params = {"w": jnp.zeros((4, 4))}
        self.mesh = None


def test_warm_plan_lists_the_jax_verify_labels(models):
    """``warm_plan`` of a speculating engine lists JAX's
    ``verify/b{B}/c{C}/w{window}`` tasks, in JAX's order, for every batch
    bucket and (width, window); a draft engine adds the draft group."""
    tmodel = models[1]
    kw = dict(ENGINE, speculate="ngram", speculate_k=8)
    eng = tserve.ContinuousEngine(tmodel, start_loop=False, **kw)
    jeng = jserve.ContinuousEngine(
        _StubModel(jtf.TransformerConfig(**SHAPE)), start_loop=False,
        **kw)
    plan = twarmup.warm_plan(eng)
    verify = [t.label for t in plan if t.label.startswith("verify/")]
    jverify = [t.label for t in jwarmup.warm_plan(jeng)
               if t.label.startswith("verify/")]
    assert verify == jverify and len(verify) == 2 * 3  # b1, b2 × w16-64
    assert all(t.group == "engine" for t in plan)
    draft = tserve.ContinuousEngine(tmodel, start_loop=False,
                                    **dict(kw, speculate="draft"))
    jdraft_eng = jserve.ContinuousEngine(
        _StubModel(jtf.TransformerConfig(**SHAPE)), start_loop=False,
        **dict(kw, speculate="draft"))
    group = [t.label for t in twarmup.warm_plan(draft) if t.group == "draft"]
    jgroup = [t.label for t in jwarmup.warm_plan(jdraft_eng)
              if t.group == "draft"]
    for kind in ("draft_prefill/", "draft_ingest/"):
        assert [lab for lab in group if lab.startswith(kind)] == \
            [lab for lab in jgroup if lab.startswith(kind)]
    # One propose-chunk graph per window where JAX has one per (steps,
    # window).
    chunk = [lab for lab in group if lab.startswith("draft_chunk/")]
    assert {lab.split("/")[-1] for lab in chunk} == \
        {lab.split("/")[-1] for lab in jgroup
         if lab.startswith("draft_chunk/")}


def test_warm_engine_with_a_draft_touches_only_the_null_blocks(models,
                                                               engine):
    jmodel, _ = models
    eng = engine(speculate="draft")
    drafter = eng.spec_proposer
    pools = {n: p.clone() for n, p in eng.cache.items()}
    dpools = {n: p.clone() for n, p in drafter.pools.items()}
    summary = twarmup.warm_engine(eng)
    assert summary["tasks"] == len(twarmup.warm_plan(eng))
    for name in ("k", "v"):
        assert torch.equal(eng.cache[name][:, 1:], pools[name][:, 1:])
        assert torch.equal(drafter.pools[name][:, 1:], dpools[name][:, 1:])
    (got,) = eng.generate([[3, 1, 4, 1, 5]], 6)
    assert got == jmodel.generate([[3, 1, 4, 1, 5]], 6)[0]


def _oracle_engine(models, engine, prompt, max_new):
    jmodel, _ = models
    truth = {tuple(prompt): jmodel.generate([prompt], max_new)[0]}
    oracle = _Oracle(truth)
    return engine(speculate="ngram", spec_proposer=oracle), oracle, truth


def test_failed_verify_fails_its_rows_and_keeps_the_pools(models, engine):
    """A verify that raises at dispatch fails its rows, releases their
    proposer slots and keeps the pools (no reset); the engine serves
    on."""
    prompt = list(range(50, 60))
    eng, oracle, truth = _oracle_engine(models, engine, prompt, 8)
    verify, faults = eng._paged_verify, []

    def verify_failing_once(*args, **kwargs):
        if not faults:
            faults.append(1)
            raise RuntimeError("injected verify fault")
        return verify(*args, **kwargs)

    eng._paged_verify = verify_failing_once
    with pytest.raises(RuntimeError, match="speculative verify failed"):
        eng.generate([prompt], 8)
    assert oracle.released == [0] and not eng._spec_owner
    assert eng._kv_epoch == 0
    (got,) = eng.generate([prompt], 8)
    assert got == truth[tuple(prompt)]
    kv = eng.kv_stats()
    assert kv["free_blocks"] + kv["cached_blocks"] == kv["total_blocks"]


def test_failed_verify_sync_resets_the_pools(models, engine):
    """A device error that surfaces at the verify's deferred sync fails
    its rows, releases their proposer slots and resets the pools, as a
    failed chunk sync does."""
    prompt = list(range(70, 80))
    eng, oracle, truth = _oracle_engine(models, engine, prompt, 8)
    dispatch, faults = eng._dispatch_verify_batch, []

    class Faulted:
        def numpy(self):
            raise RuntimeError("injected verify sync fault")

    def dispatch_faulting_once(entries, window):
        rec = dispatch(entries, window)
        if rec is not None and not faults:
            faults.append(1)
            rec["greedy"] = Faulted()
        return rec

    eng._dispatch_verify_batch = dispatch_faulting_once
    with pytest.raises(RuntimeError, match="verify sync failed"):
        eng.generate([prompt], 8)
    assert oracle.released == [0]
    # The reset follows the row's failure on the loop thread; the next
    # request queues behind it.
    (got,) = eng.generate([prompt], 8)
    assert got == truth[tuple(prompt)]
    assert eng._kv_epoch == 1


def test_failed_verify_sync_zeroes_the_pools_before_it_wakes_the_row(
        models, engine):
    """A failed verify sync resets the pools before it wakes the
    verified row's waiter: with a reset that sleeps before it zeroes,
    the pools are already zero when ``generate`` raises."""
    prompt = list(range(70, 80))
    eng, _, _ = _oracle_engine(models, engine, prompt, 8)
    dispatch, reset, faults = eng._dispatch_verify_batch, eng._reset_paged, []

    class Faulted:
        def numpy(self):
            raise RuntimeError("injected verify sync fault")

    def dispatch_faulting_once(entries, window):
        rec = dispatch(entries, window)
        if rec is not None and not faults:
            faults.append(1)
            rec["greedy"] = Faulted()
        return rec

    def slow_reset(*args, **kwargs):
        time.sleep(0.5)
        return reset(*args, **kwargs)

    eng._dispatch_verify_batch = dispatch_faulting_once
    eng._reset_paged = slow_reset
    with pytest.raises(RuntimeError, match="verify sync failed"):
        eng.generate([prompt], 8)
    assert not any(p.any() for p in eng.cache.values())


def test_reset_and_shutdown_release_the_proposer_slots(models):
    """``_reset_paged`` and ``shutdown`` fail a speculating row and
    release its proposer slot."""
    prompt = list(range(90, 100))
    for how in ("reset", "shutdown"):
        oracle = _Oracle({tuple(prompt): prompt + [0] * 20})
        eng = tserve.ContinuousEngine(models[1], start_loop=False,
                                      speculate="ngram",
                                      spec_proposer=oracle, **ENGINE)
        row = {"prompt": prompt, "max_new": 8, "out": None, "err": None,
               "event": threading.Event(), "t_enq": 0.0,
               "generated": [5]}
        eng._admit_paged(0, row)
        row["remaining"], eng.positions[0] = 7, len(prompt) + 1
        row["_spec"] = {"ak": tspec.AdaptiveK(8), "inflight": 0,
                        "hold": False}
        eng._spec_owner[0] = row
        oracle.admit(0, prompt + [5])
        if how == "reset":
            eng._reset_paged(RuntimeError("injected"))
        else:
            eng.shutdown()
        assert oracle.released == [0] and not eng._spec_owner
        assert row["err"] is not None and row["event"].is_set()


def test_speculating_engine_behind_the_cli_on_cpu_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", *TINY_FLAGS,
         "--continuous-batching", "--kv-cache", "paged", "--kv-block-size",
         "4", "--max-slots", "2", "--decode-chunk", "4", "--prefill-chunk",
         "16", "--speculate", "ngram"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["tokens"][0]) == 4 and out["tokens"][0][:2] == [5, 6]


def test_speculate_without_continuous_batching_falls_back_to_off(caplog):
    args = ["--once", "--device", "cpu", "--port", "0", *TINY_FLAGS,
            "--speculate", "draft"]
    with caplog.at_level("WARNING", logger="serve_cli"):
        assert tserve.main(args) == 0
    assert "falling back to off" in caplog.text


def test_speculate_raises_without_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--once", "--port", "0", *TINY_FLAGS,
                     "--continuous-batching", "--speculate", "ngram"])
