# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Serving a mixture-of-experts model: the port against the JAX package
(CPU, f32).

A 2-layer MoE model (d_model 64, 4 experts, top-2, GELU experts) with
JAX's ``init_params`` weights, bridged by ``weights.params_from_jax``,
at the default capacity factor 1.25 and at 0.5, where most groups drop
tokens. Each serving program routes per leading-dim group of its input,
with capacity from that group's padded length: a prefill's bucket, a
segment, a decode step's one token a row, a verify row. Every program
is held to JAX's at the same padding:

  * ``prefill``, ``decode_logits``, ``prefill_into_slot``,
    ``prefill_chunk_into_slot``, ``paged_prefill_segment``,
    ``paged_decode_chunk`` and ``paged_verify_batch``: greedy tokens
    exact, logits, caches and pools within ``LOGITS_ATOL``; at 0.5 the
    experts each token keeps in a program's own padded groups equal
    JAX's (:func:`kept_experts`);
  * ``Model.generate``, ``BatchingModel``, the dense and the paged
    engine (and the paged engine speculating, every round verified):
    greedy streams equal JAX's (JAX's paged seams made synchronous, as
    in ``tests/test_torch_handoff.py``);
  * int8: the tensors ``quantize_params`` quantizes are exactly JAX's
    (the attention matrices; the experts stay f32), and the int8
    model's tokens JAX's;
  * tp 2, every rank in one process and a 2-rank gloo world
    (``tests/torch_dist_worker.py`` scenario ``moe_tp``), against JAX's
    ``Model(tp=2)``.
"""

import concurrent.futures
import os
import pickle
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import (  # noqa: E402
    quantization as jq8,
)
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.parallel import moe as jmoe  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    quantization as q8,
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
from container_engine_accelerators_tpu_torch.parallel import moe as tmoe  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32",
             n_experts=4, expert_top_k=2)
# f32 logits, caches and pools: the same arithmetic in two frameworks,
# summed in other orders, through two MoE layers.
LOGITS_ATOL = 1e-4
BS = 4
BLOCKS_PER_SEQ = SHAPE["max_seq_len"] // BS
HD = SHAPE["d_model"] // SHAPE["n_heads"]
DENSE = dict(max_slots=2, chunk=4, prefill_chunk=16)
PAGED = dict(DENSE, kv_block_size=BS, kv_cache="paged")
TIMEOUT_S = 120
CAPACITY_FACTORS = (1.25, 0.5)


def _cfgs(cf):
    return (jtf.TransformerConfig(**SHAPE, capacity_factor=cf),
            ttf.TransformerConfig(**SHAPE, capacity_factor=cf))


@pytest.fixture(scope="module", params=CAPACITY_FACTORS,
                ids=[f"cf{cf}" for cf in CAPACITY_FACTORS])
def models(request):
    """(JAX Model, port Model) on JAX's weights at a capacity factor."""
    jcfg, cfg = _cfgs(request.param)
    jmodel = jserve.Model(jcfg, seed=0)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def dropping():
    """The models at capacity factor 0.5."""
    jcfg, cfg = _cfgs(0.5)
    jmodel = jserve.Model(jcfg, seed=0)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


def _prompt(rng, n):
    return rng.integers(1, SHAPE["vocab_size"], n).tolist()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)


def _cache(seed, batch):
    rng = np.random.default_rng(seed)
    shape = (SHAPE["n_layers"], batch, SHAPE["n_kv_heads"],
             SHAPE["max_seq_len"], HD)
    return {n: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for n in ("k", "v")}


def _pools(seed, num_blocks):
    rng = np.random.default_rng(seed)
    shape = (SHAPE["n_layers"], num_blocks, SHAPE["n_kv_heads"], BS, HD)
    return {n: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for n in ("k", "v")}


def _j(tree):
    return {n: jnp.asarray(c) for n, c in tree.items()}


def _t(tree):
    return {n: torch.from_numpy(c.copy()) for n, c in tree.items()}


def _close_trees(got, want, skip_null=False):
    for name in ("k", "v"):
        g, w = got[name].numpy(), np.asarray(want[name])
        if skip_null:  # the null block's garbage depends on write order
            g, w = g[:, 1:], w[:, 1:]
        _close(g, w)


# -- the dense programs -----------------------------------------------------------

def test_prefill_and_decode_logits_match_jax(models):
    """A (2, 16) bucket holding 11 real tokens: each row routes its 16
    positions (the pads take the slots the real tokens left)."""
    jmodel, tmodel = models
    rng = np.random.default_rng(3)
    padded = np.zeros((2, 16), np.int32)
    padded[:, :11] = rng.integers(1, 256, (2, 11))
    jlogits, jcache = jtf.prefill(jmodel.params, jnp.asarray(padded),
                                  jmodel.cfg, true_len=jnp.int32(11),
                                  return_logits=True)
    logits, cache = ttf.prefill(tmodel.model, torch.as_tensor(padded).long(),
                                true_len=11, return_logits=True)
    _close(logits.numpy(), jlogits)
    _close(cache["k"][:, :, :, :16].numpy(),
           np.asarray(jcache["k"])[:, :, :, :16])
    nxt = np.argmax(np.asarray(jlogits), axis=-1)
    jstep, jcache = jtf.decode_logits(jmodel.params, jcache,
                                      jnp.asarray(nxt), 11, jmodel.cfg)
    step = ttf.decode_logits(tmodel.model, cache, torch.as_tensor(nxt), 11)
    _close(step.numpy(), jstep)
    _close(cache["v"][:, :, :, :12].numpy(),
           np.asarray(jcache["v"])[:, :, :, :12])


def test_prefill_into_slot_matches_jax(models):
    jmodel, tmodel = models
    rng = np.random.default_rng(4)
    cache = _cache(4, 3)
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :20] = _prompt(rng, 20)
    jtok, jcache = jtf.prefill_into_slot(jmodel.params, _j(cache),
                                         jnp.asarray(prompt), 20, 1,
                                         jmodel.cfg)
    tcache = _t(cache)
    tok = ttf.prefill_into_slot(tmodel.model, tcache,
                                torch.from_numpy(prompt).long(), 20, 1)
    assert int(tok) == int(jtok)
    _close_trees(tcache, jcache)


@pytest.mark.parametrize("offset,true_len", [(16, None), (32, 40)])
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
        jmodel.params, _j(cache), jnp.asarray(seg), offset, slot, true_pos,
        jmodel.cfg, window=window, want_logits=want)
    tcache = _t(cache)
    tok = ttf.prefill_chunk_into_slot(
        tmodel.model, tcache, torch.from_numpy(seg).long(), offset, slot,
        true_pos, window=window, want_logits=want)
    _close_trees(tcache, jcache)
    assert (tok is None) if not want else int(tok) == int(jtok)


# -- the paged programs -----------------------------------------------------------

@pytest.mark.parametrize("offset,true_len", [(8, None), (20, 28)])
def test_paged_prefill_segment_matches_jax(models, offset, true_len):
    jmodel, tmodel = models
    seg_len, slot, num_blocks = 16, 1, 40
    window = ttf._window_for(min(offset + seg_len, SHAPE["max_seq_len"]),
                             SHAPE["max_seq_len"])
    rng = np.random.default_rng(offset)
    table = rng.permutation(np.arange(1, num_blocks))[:BLOCKS_PER_SEQ]
    table = table.astype(np.int32)
    seg_ids = np.full(seg_len // BS, tpa.NULL_BLOCK, np.int32)
    b0 = offset // BS
    seg_ids[:seg_len // BS] = table[b0:b0 + seg_len // BS]
    seg = np.zeros((1, seg_len), np.int32)
    real = seg_len if true_len is None else true_len - offset
    seg[0, :real] = _prompt(rng, real)
    pools = _pools(offset, num_blocks)
    last = np.array([7, 9], np.int32)
    want = true_len is not None
    true_pos = (true_len or offset + seg_len) - 1
    jtok, jpools, jlast = jtf.paged_prefill_segment(
        jmodel.params, _j(pools), jnp.asarray(seg), offset,
        jnp.asarray(seg_ids), jnp.asarray(table), true_pos,
        jnp.asarray(last), slot, cfg=jmodel.cfg, window=window,
        block_size=BS, want_logits=want)
    tpools, tlast = _t(pools), torch.from_numpy(last).long()
    tok = ttf.paged_prefill_segment(
        tmodel.model, tpools, torch.from_numpy(seg).long(), offset,
        torch.from_numpy(seg_ids).long(), torch.from_numpy(table).long(),
        true_pos, tlast, slot, window=window, block_size=BS,
        want_logits=want)
    _close_trees(tpools, jpools)
    assert tlast.tolist() == np.asarray(jlast).tolist()
    assert (tok is None) if not want else int(tok) == int(jtok)


def test_paged_decode_chunk_matches_jax(models):
    jmodel, tmodel = models
    batch, num_blocks, steps = 3, 1 + 3 * BLOCKS_PER_SEQ, 4
    rng = np.random.default_rng(9)
    tables = rng.permutation(np.arange(1, num_blocks)).reshape(batch, -1)
    tables = tables.astype(np.int32)
    tokens = np.asarray(_prompt(rng, batch), np.int32)
    positions = np.asarray([9, 5, 29], np.int32)
    active = np.array([True, False, True])
    pools = _pools(19, num_blocks)
    jtoks, jlast, jpools, jpos = jtf.paged_decode_chunk(
        jmodel.params, _j(pools), jnp.asarray(tables), jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(active), cfg=jmodel.cfg,
        steps=steps, window=32, block_size=BS)
    tpools = _t(pools)
    toks, last, pos = ttf.paged_decode_chunk(
        tmodel.model, tpools, torch.from_numpy(tables).long(),
        torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        torch.from_numpy(active), steps=steps, window=32, block_size=BS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    _close_trees(tpools, jpools)


def _verify_case(rng, poss, num_blocks, width=8):
    """Verify operands over disjoint page tables (tests/test_torch_spec.py's
    construction)."""
    S = SHAPE["max_seq_len"]
    perm = rng.permutation(np.arange(1, num_blocks))
    b = len(poss)
    segs = np.zeros((b, width), np.int32)
    bids = np.full((b, width), tpa.NULL_BLOCK, np.int32)
    offs = np.zeros((b, width), np.int32)
    tables = np.zeros((b, BLOCKS_PER_SEQ), np.int32)
    for i, pos in enumerate(poss):
        tables[i] = perm[i * BLOCKS_PER_SEQ:(i + 1) * BLOCKS_PER_SEQ]
        segs[i] = _prompt(rng, width)
        for j, p in enumerate(range(pos, pos + width)):
            offs[i, j] = p % BS
            if p < S:
                bids[i, j] = tables[i, p // BS]
    return segs, bids, offs, tables


def test_paged_verify_batch_matches_jax(models):
    """JAX scans one-row chunks, the port runs the batch: both route
    each row's Sq tokens as one group."""
    jmodel, tmodel = models
    poss = [6, 21]
    rng = np.random.default_rng(2)
    num_blocks = 1 + len(poss) * BLOCKS_PER_SEQ
    segs, bids, offs, tables = _verify_case(rng, poss, num_blocks)
    window = ttf._window_for(max(poss) + 8, SHAPE["max_seq_len"])
    pools = _pools(22, num_blocks)
    pos_arr = np.asarray(poss, np.int32)
    jgreedy, jpools = jtf.paged_verify_batch(
        jmodel.params, _j(pools), jnp.asarray(segs), jnp.asarray(pos_arr),
        jnp.asarray(bids), jnp.asarray(offs), jnp.asarray(tables),
        cfg=jmodel.cfg, window=window, block_size=BS)
    tpools = _t(pools)
    greedy = ttf.paged_verify_batch(
        tmodel.model, tpools, torch.from_numpy(segs).long(),
        torch.from_numpy(pos_arr).long(), torch.from_numpy(bids).long(),
        torch.from_numpy(offs).long(), torch.from_numpy(tables).long(),
        window=window, block_size=BS)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    _close_trees(tpools, jpools, skip_null=True)


# -- the experts each token keeps -------------------------------------------------

def kept_experts(moe_ffn, x, router, top_k, capacity_factor, as_array):
    """The gate weight of every expert that keeps each token of ``x`` (0
    where it is not chosen or its slot is past the capacity), read off
    ``moe_ffn`` itself: the input gains a constant feature the router
    ignores, and each expert maps any token it holds to its own basis
    vector (w1 reads the constant, GELU(1) is divided out by w2), so the
    combine of the experts' outputs is the gate weights of the kept
    ones. → (..., E)."""
    d, e = router.shape
    f = 2
    probe_x = np.concatenate([x, np.ones(x.shape[:-1] + (1,), np.float32)],
                             axis=-1)
    probe_router = np.concatenate([router, np.zeros((1, e), np.float32)])
    w1 = np.zeros((e, d + 1, f), np.float32)
    w1[:, d, 0] = 1.0
    w2 = np.zeros((e, f, d + 1), np.float32)
    gelu1 = 0.5 * (1 + np.tanh(np.sqrt(2 / np.pi) * (1 + 0.044715)))
    for i in range(e):
        w2[i, 0, i] = 1.0 / gelu1
    params = {"router": probe_router, "w1": w1, "w2": w2}
    y, _ = moe_ffn(as_array(probe_x), {k: as_array(v)
                                       for k, v in params.items()},
                   top_k=top_k, capacity_factor=capacity_factor)
    return np.asarray(y, dtype=np.float32)[..., :e]


def test_dropped_tokens_route_as_jax(dropping, monkeypatch):
    """At capacity factor 0.5 the tokens each expert keeps, in the groups
    the port's prefill, segment, decode and verify programs route (their
    padded lengths), are JAX's: the same experts with the same gate
    weights, tokens past an expert's capacity dropped alike."""
    jmodel, tmodel = dropping
    seen = []
    real = tmoe.moe_ffn

    def record(x, params, **kw):
        seen.append((x.detach().numpy().copy(),
                     params["router"].detach().numpy().copy()))
        return real(x, params, **kw)

    monkeypatch.setattr(tmoe, "moe_ffn", record)
    rng = np.random.default_rng(5)
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :20] = _prompt(rng, 20)
    ttf.prefill_into_slot(tmodel.model, _t(_cache(1, 2)),
                          torch.from_numpy(prompt).long(), 20, 0)
    ttf.decode_logits(tmodel.model, _t(_cache(2, 2)),
                      torch.as_tensor([3, 4]), 11)
    segs, bids, offs, tables = _verify_case(rng, [6, 21],
                                            1 + 2 * BLOCKS_PER_SEQ)
    ttf.paged_verify_batch(
        tmodel.model, _t(_pools(3, 1 + 2 * BLOCKS_PER_SEQ)),
        torch.from_numpy(segs).long(), torch.tensor([6, 21]),
        torch.from_numpy(bids).long(), torch.from_numpy(offs).long(),
        torch.from_numpy(tables).long(), window=32, block_size=BS)
    monkeypatch.setattr(tmoe, "moe_ffn", real)
    # Two layers each of the prefill (1, 32), decode (2, 1), verify (2, 8).
    assert [x.shape[:-1] for x, _ in seen] == \
        [(1, 32)] * 2 + [(2, 1)] * 2 + [(2, 8)] * 2
    dropped = 0
    for x, router in seen:
        kw = dict(top_k=2, capacity_factor=0.5)
        got = kept_experts(tmoe.moe_ffn, x, router, as_array=torch.from_numpy,
                           **kw)
        want = kept_experts(jmoe.moe_ffn, x, router, as_array=jnp.asarray,
                            **kw)
        np.testing.assert_array_equal(got > 0, want > 0)
        _close(got, want)
        dropped += int(((got > 0).sum(-1) < 2).sum())
    assert dropped > 0  # capacity 0.5 drops tokens of every long group


# -- generate, the batcher and the engines ----------------------------------------

def _cases(seed=0):
    rng = np.random.default_rng(seed)
    prefix = _prompt(rng, 12)
    # One segment; two (and a radix hit on the first's prefix blocks);
    # a one-token request.
    return [(prefix + _prompt(rng, 3), 6), (prefix + _prompt(rng, 9), 5),
            ([9, 8, 7], 1)]


def test_generate_matches_jax(models):
    jmodel, tmodel = models
    for prompt, n in _cases(1):
        assert tmodel.generate([prompt], n) == jmodel.generate([prompt], n)
    row = _prompt(np.random.default_rng(2), 7)
    rows = [row, row[::-1]]
    assert tmodel.generate(rows, 5) == jmodel.generate(rows, 5)


def test_batching_model_matches_jax(models):
    """Concurrent equal-length requests coalesce into one batch, whose
    rows route alone: each equals JAX's own generate of it."""
    jmodel, tmodel = models
    batcher = tserve.BatchingModel(tmodel, window_ms=50.0)
    rng = np.random.default_rng(6)
    prompts = [_prompt(rng, 9) for _ in range(3)]
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            outs = [f.result(TIMEOUT_S) for f in
                    [pool.submit(batcher.generate, [p], 4) for p in prompts]]
    finally:
        batcher.shutdown()
    for prompt, out in zip(prompts, outs):
        assert out == jmodel.generate([prompt], 4)
    assert batcher.n_batches < len(prompts)


def _synchronous(jeng, seams):
    for seam in seams:
        fn = getattr(jeng, seam)
        setattr(jeng, seam, lambda *a, _fn=fn, **k:
                jax.block_until_ready(_fn(*a, **k)))


def _serve_in_turn(eng, cases):
    return [eng.generate([p], n)[0] for p, n in cases]


class EchoProposer:
    """A proposer that always proposes (the context's last k tokens), so
    every round of a speculating engine verifies: the proposer contract
    of ``spec/proposer.py``, which both packages' engines take."""

    def __init__(self):
        self.ctx = {}

    def admit(self, slot, ctx):
        self.ctx[slot] = list(ctx)

    def observe(self, slot, tokens):
        self.ctx[slot].extend(tokens)

    def propose(self, slot, k):
        return self.ctx[slot][-k:]

    def release(self, slot):
        self.ctx.pop(slot, None)


@pytest.mark.parametrize("mode", ["dense", "paged", "paged_spec"])
def test_engine_matches_the_jax_engine(models, mode):
    """The port's engine and JAX's on the same requests, one at a time:
    greedy streams equal. (Not ``generate``'s: an engine's prefill
    routes per segment of ``prefill_chunk``, and a radix hit shortens
    it, where ``generate`` routes the whole bucket, so a long prompt's
    capacities, and what they drop, differ.)"""
    jmodel, tmodel = models
    kw = dict(DENSE) if mode == "dense" else dict(PAGED)
    spec = mode == "paged_spec"
    if spec:
        kw.update(speculate="ngram", speculate_k=3)
    jeng = jserve.ContinuousEngine(
        jmodel, start_loop=False, **kw,
        **({"spec_proposer": EchoProposer()} if spec else {}))
    if mode != "dense":
        _synchronous(jeng, ["_paged_prefill", "_paged_chunk", "_copy_blocks"]
                     + (["_paged_verify"] if spec else []))
    loop = jeng._loop if mode == "dense" else jeng._loop_paged
    threading.Thread(target=loop, daemon=True).start()
    eng = tserve.ContinuousEngine(
        tmodel, **kw, **({"spec_proposer": EchoProposer()} if spec else {}))
    cases = _cases(2)
    try:
        want = _serve_in_turn(jeng, cases)
        got = _serve_in_turn(eng, cases)
        stats = eng.stats()
    finally:
        eng.shutdown()
        jeng.shutdown()
    assert got == want
    if spec:
        assert stats["spec_verifies"] > 0


# -- int8 ------------------------------------------------------------------------

def test_int8_quantizes_jax_s_tensors(dropping):
    """``quantize_params`` swaps exactly the tensors JAX's default
    ``quantize_params`` quantizes (wq, wk, wv, wo), q and scale bit for
    bit; the router and experts stay f32, and the int8 model's tokens are
    JAX's ``Model(quantize="int8")``'s."""
    jcfg, cfg = _cfgs(0.5)
    jmodel = jserve.Model(jcfg, seed=0, quantize="int8")
    jparams = jq8.quantize_params(jserve.Model(jcfg, seed=0).params)
    quantized = {k for k, v in jparams["layers"].items()
                 if jq8.is_quantized(v)}
    assert quantized == {"wq", "wk", "wv", "wo"}
    model = weights.params_from_jax(
        jax.tree.map(np.asarray, jserve.Model(jcfg, seed=0).params), cfg,
        device="cpu")
    q8.quantize_params(model)
    for i, layer in enumerate(model.layers):
        for key in quantized:
            w = getattr(layer.attn, key)
            assert isinstance(w, q8.Int8Weight)
            np.testing.assert_array_equal(
                w.q.T.numpy(), np.asarray(jparams["layers"][key]["q"][i]))
            np.testing.assert_array_equal(
                w.scale.numpy(),
                np.asarray(jparams["layers"][key]["scale"][i]))
        for p in layer.ffn.parameters():
            assert p.dtype == torch.float32
    assert not any(q8.is_quantized(getattr(layer.ffn, k))
                   for layer in model.layers for k in ("w1", "w2"))
    tmodel = tserve.Model(cfg, weights=model)
    for prompt, n in _cases(3):
        assert tmodel.generate([prompt], n) == jmodel.generate([prompt], n)


# -- tensor parallel ---------------------------------------------------------------

def test_tp2_in_process_matches_jax(dropping):
    """``Model(tp=2)`` (every rank in this process): the experts' F split
    over tp, the combine's partials summed once; generate equals JAX's
    ``Model(tp=2)``, the paged engine JAX's paged engine on it, and the
    int8 tp model JAX's int8 tp model."""
    jcfg, cfg = _cfgs(0.5)
    jtp = jserve.Model(jcfg, tp=2)
    whole = weights.params_from_jax(jax.device_get(jtp.params), cfg,
                                    device="cpu")
    model = tserve.Model(cfg, device="cpu", tp=2, weights=whole)
    shard = model.model.shards[1].layers[0].ffn
    assert tuple(shard.w1.shape) == (4, 64, 64)
    assert tuple(shard.w2.shape) == (4, 64, 64)
    assert tuple(shard.router.shape) == (64, 4)
    cases = _cases(4)
    want = [jtp.generate([p], n) for p, n in cases]
    assert [model.generate([p], n) for p, n in cases] == want
    jeng = jserve.ContinuousEngine(jtp, start_loop=False, **PAGED)
    _synchronous(jeng, ["_paged_prefill", "_paged_chunk", "_copy_blocks"])
    threading.Thread(target=jeng._loop_paged, daemon=True).start()
    eng = tserve.ContinuousEngine(model, **PAGED)
    try:
        got = _serve_in_turn(eng, cases)
        want = _serve_in_turn(jeng, cases)
    finally:
        eng.shutdown()
        jeng.shutdown()
    assert got == want
    jint8 = jserve.Model(jcfg, tp=2, quantize="int8")
    tint8 = tserve.Model(cfg, device="cpu", tp=2, weights=whole,
                         quantize="int8")
    for prompt, n in cases[:2]:
        assert tint8.generate([prompt], n) == jint8.generate([prompt], n)


def test_tp_sharded_init_with_experts_matches_host_init():
    """``tp_serving.init_shards`` (each rank drawing only its pieces, as
    ``Model(tp=...)`` without weights does) merges to
    ``transformer.init_params`` in bf16, the router kept f32 as the
    unsplit model keeps it."""
    from container_engine_accelerators_tpu_torch.models import tp_serving
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    cfg = ttf.TransformerConfig(**{**SHAPE, "dtype": "bfloat16"})
    host = ttf.init_params(cfg, device="cpu", seed=3)
    model = tp_serving.init_shards(cfg, tpar.Axes.in_process(tp=2),
                                   device="cpu", seed=3)
    merged = tpar.merged(model.shards, model.axes, tpar.TRANSFORMER_TP)
    for name, p in host.named_parameters():
        assert merged[name].dtype == p.dtype, name
        torch.testing.assert_close(merged[name], p.detach(), rtol=0, atol=0)
    assert model.shards[0].layers[0].ffn.router.dtype == torch.float32


def test_tp_split_with_experts_is_the_training_split(dropping):
    """Serving's ``tp_serving.split`` of an MoE model lays the shards out
    as training's ``tp_lm.split_params`` does at ep 1: every expert's F
    columns of w1 and rows of w2 over tp, the router whole (JAX's
    ``serving_shardings`` on a tp-only mesh)."""
    from container_engine_accelerators_tpu_torch.models import (
        tp_lm,
        tp_serving,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    whole = dropping[1].model
    axes = tpar.Axes.in_process(tp=2)
    serving = tp_serving.split(whole, axes).shards
    training = tp_lm.split_params(whole, axes)
    for a, b in zip(serving, training):
        want = dict(b.named_parameters())
        for name, p in a.named_parameters():
            assert torch.equal(p, want[name]), name
    assert tuple(serving[1].layers[0].ffn.w1.shape) == (4, 64, 64)


def test_tp2_gloo_world_matches_jax(tmp_path):
    """Two gloo ranks, each ``Model(tp=2)`` over its mesh's tp axis (the
    combine's partials all-reduced over gloo): rank 0's streams are JAX
    ``Model(tp=2)``'s, and both ranks agree."""
    jcfg, _ = _cfgs(0.5)
    jtp = jserve.Model(jcfg, tp=2)
    cases = _cases(5)
    with open(tmp_path / "moe_tp_in.pkl", "wb") as f:
        pickle.dump({"cfg": {**SHAPE, "capacity_factor": 0.5},
                     "tree": jax.device_get(jtp.params),
                     "cases": cases}, f)
    outs = worker.spawn("moe_tp", 2, str(tmp_path))
    want = [jtp.generate([p], n) for p, n in cases]
    assert outs[0] == outs[1] == want
