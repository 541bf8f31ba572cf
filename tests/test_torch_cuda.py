# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's CUDA kernel on the card (skipped without a GPU).

Imports no JAX (the machine with the card has none), so run it there
without the repo's JAX-configuring conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli,
    serving_graphs,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as tf,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    quantization,
)
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention,
    int8_matmul,
)

pytestmark = pytest.mark.cuda

# Kernel vs flash_fwd_reference on the same inputs. bf16: both round p
# and out to bf16 but p at different running maxima, so an output may
# differ by about one bf16 step (2^-8 relative); f32: summation order.
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-5, 0.0)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


CASES = {
    "causal_gqa": ((2, 8, 2, 192, 192, 128), True, {}),
    "q_base_window": ((1, 8, 2, 100, 512, 128), True, {"q_base": 300}),
    "kv_len_rows_past_keys": ((1, 4, 1, 256, 256, 64), True,
                              {"kv_len": 100}),
    "noncausal_kv_len": ((2, 4, 2, 70, 333, 64), False, {"kv_len": 250}),
    "future_keys": ((1, 4, 2, 128, 128, 128), True, {"k_base": 64}),
    "d32_unaligned": ((2, 8, 4, 77, 77, 32), True, {}),
    # The edges of the forward's 128-row q and 128-key K/V tiles: one row
    # or key past a tile, the causal diagonal mid-tile, kv_len inside the
    # first key tile, ragged D 64 and D 32, several waves of blocks.
    "s129": ((1, 8, 2, 129, 129, 128), True, {}),
    "s255": ((1, 8, 2, 255, 255, 128), True, {}),
    "diagonal_mid_tile": ((1, 8, 2, 300, 700, 128), True, {"q_base": 400}),
    "kv_len_in_first_tile": ((1, 8, 2, 200, 300, 128), True, {"kv_len": 50}),
    "d64_ragged": ((2, 8, 2, 333, 517, 64), False, {"kv_len": 400}),
    "d32_ragged": ((2, 8, 4, 250, 250, 32), True, {}),
    "waves_b4": ((4, 32, 8, 1024, 1024, 128), True, {}),
}
# The paged engine's prefill segments: a segment bucket below the 128-row
# q tile at a block-aligned (not tile-aligned) q_base, against a window
# that reaches past the diagonal.
FWD_CASES = {
    **CASES,
    "paged_sq16": ((1, 8, 2, 16, 2048, 128), True, {"q_base": 1040}),
    "paged_sq64": ((1, 8, 2, 64, 4096, 64), True, {"q_base": 2000}),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_kernel_matches_plain_version(gen, name, dtype):
    (b, hq, hkv, sq, sk, d), causal, kw = FWD_CASES[name]
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dtype)
    before = attention.flash_fwd_launches
    out, lse = attention.flash_fwd(q, k, v, causal=causal,
                                   sm_scale=d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    ref, ref_lse = attention.flash_fwd_reference(
        q, k, v, causal=causal, sm_scale=d ** -0.5, **kw)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_without_keys_gives_zero_rows(gen, dtype):
    """Sk = 0: every row sees no key, so out = 0 and lse = -1e30, as for
    any row without a visible key (the bf16 kernel loads no K/V tile)."""
    q = torch.randn(1, 4, 64, 128, generator=gen, device="cuda").to(dtype)
    k = torch.empty(1, 2, 0, 128, device="cuda", dtype=dtype)
    out, lse = attention.flash_fwd(q, k, k, causal=False, sm_scale=0.1)
    torch.cuda.synchronize()
    assert not out.any()
    assert (lse == attention.NEG_INF).all()


def test_kernel_rejects_what_it_does_not_take(gen):
    q = torch.randn(1, 2, 16, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_fwd(q, q, q, causal=True, sm_scale=0.1)
    q = torch.randn(1, 2, 16, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_fwd(q, q, q, causal=True, sm_scale=0.1)
    q = torch.randn(1, 16, 2, 64, device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_fwd(q, q, q, causal=True, sm_scale=0.1)


def test_small_model_on_card_matches_cpu(gen):
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    gpu = tf.init_params(cfg, device="cuda", seed=2)
    cpu = tf.Transformer(cfg, "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    prompt = torch.arange(5, 30)[None, :]
    before = attention.flash_fwd_launches
    decoder = serving_graphs.DenseDecodeGraphs(gpu)
    out = tf.generate(gpu, prompt.cuda(), max_new_tokens=6,
                      decoder=decoder).cpu()
    assert attention.flash_fwd_launches == before + cfg.n_layers
    # Every decode step was a replay: positions 25-29, one window (32).
    assert (decoder.graphs.captures, decoder.graphs.replays) == (1, 5)
    assert torch.equal(out, tf.generate(
        cpu, prompt, max_new_tokens=6,
        decoder=serving_graphs.DenseDecodeGraphs(cpu)))


def test_paged_engine_on_card_matches_dense_generate(gen):
    """The paged engine on a small f32 model (head dim 128: the f32 kernel
    under every prefill segment) returns dense generate's tokens exactly,
    through a radix hit and a prompt prefilled in three segments; every
    decode chunk replays its window's graph."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    model = serve_cli.Model(cfg, seed=4, device="cuda")
    engine = serve_cli.ContinuousEngine(model, max_slots=2, chunk=4,
                                        prefill_chunk=32, kv_block_size=16,
                                        kv_cache="paged")
    prefix = list(range(7, 47))
    cases = [(prefix + [3, 4], 6), (prefix + [5], 6),
             (list(range(100, 170)), 7)]
    before = attention.flash_fwd_launches
    try:
        outs = [engine.generate([p], n)[0] for p, n in cases]
    finally:
        engine.shutdown()
    assert attention.flash_fwd_launches - before == \
        cfg.n_layers * engine.stats()["n_prefills"]
    assert engine.kv_stats()["prefix_hit_tokens"] > 0
    graphs = engine.graph_stats()
    assert graphs["graph_captures"] > 0 and graphs["graph_replays"] > 0
    assert graphs["eager_chunks_on_cuda"] == 0
    for (prompt, max_new), got in zip(cases, outs):
        want = tf.generate(model.model,
                           torch.as_tensor([prompt], device="cuda"),
                           max_new_tokens=max_new,
                           decoder=model.decode_graphs)
        assert got == want[0].tolist()


SMALL = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
             n_kv_heads=1, d_ff=768, max_seq_len=128, dtype="float32")


@pytest.mark.parametrize("window,steps", [(64, 4), (128, 3)])
def test_graphed_chunk_matches_the_eager_chunk(gen, window, steps):
    """The captured step replayed ``steps`` times gives the eager
    ``paged_decode_chunk``'s tokens, last tokens and positions, and
    writes the pools bit for bit alike but for the null block, whose
    garbage the capture's warm-up iterations rewrite (small f32 model, 4
    rows, one inactive, one clamping at the window's end)."""
    cfg = tf.TransformerConfig(**SMALL)
    model = tf.init_params(cfg, device="cuda", seed=5)
    slots, bs = 4, 16
    per_row = cfg.max_seq_len // bs
    shape = (cfg.n_layers, 1 + slots * per_row, cfg.n_kv_heads, bs,
             cfg.head_dim)
    pools = {n: torch.randn(shape, generator=gen, device="cuda")
             for n in ("k", "v")}
    eager_pools = {n: p.clone() for n, p in pools.items()}
    tables = (1 + torch.arange(slots * per_row)).view(slots, per_row)
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                           device="cuda")
    positions = torch.tensor([3, window - 2, 40, window // 2])
    active = torch.tensor([True, True, False, True])
    want, last, pos = tf.paged_decode_chunk(
        model, eager_pools, tables.cuda(), tokens.clone(), positions.cuda(),
        active.cuda(), steps=steps, window=window, block_size=bs)
    last_dev = tokens.clone()
    runner = serving_graphs.PagedDecodeGraphs(model, pools, last_dev,
                                              tuple(tables.shape), 4, bs)
    got = runner(tables.numpy(), positions.numpy(), active.numpy(), steps,
                 window)
    torch.cuda.synchronize()
    assert (runner.graphs.captures, runner.graphs.replays) == (1, steps)
    assert torch.equal(got, want) and torch.equal(last_dev, last)
    assert torch.equal(runner.positions, pos)
    for name in ("k", "v"):
        assert torch.equal(pools[name][:, 1:], eager_pools[name][:, 1:])


def test_dense_decode_graph_matches_the_eager_step(gen):
    """A replayed dense step gives the eager ``decode_logits``' logits
    bit for bit, at a Python position and at a device position."""
    cfg = tf.TransformerConfig(**SMALL)
    model = tf.init_params(cfg, device="cuda", seed=6)
    prompt = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen,
                           device="cuda")
    decoder = serving_graphs.DenseDecodeGraphs(model)
    _, cache = tf.prefill(model, prompt)
    decoder_cache = decoder.cache(2)
    for name in ("k", "v"):
        decoder_cache[name].copy_(cache[name])
    tok = prompt[:, -1].clone()
    eager = tf.decode_logits(model, cache, tok, 20)
    at_dev = tf.decode_logits(model, {n: c.clone() for n, c in cache.items()},
                              tok, torch.tensor([20], device="cuda"),
                              window=32)
    replayed = decoder.step(tok, 20).clone()
    torch.cuda.synchronize()
    assert decoder.graphs.replays == 1
    assert torch.equal(at_dev, eager) and torch.equal(replayed, eager)
    for name in ("k", "v"):
        assert torch.equal(decoder_cache[name], cache[name])


def test_dense_decoder_eviction_drops_its_graphs(gen):
    """An evicted batch size takes its graphs with it (they hold the
    freed cache's addresses); served again, it captures anew over a fresh
    cache and gives the CPU's tokens."""
    cfg = tf.TransformerConfig(**SMALL)
    gpu = tf.init_params(cfg, device="cuda", seed=7)
    cpu = tf.Transformer(cfg, "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    decoder = serving_graphs.DenseDecodeGraphs(gpu, max_rows=2)
    prompts = {b: torch.randint(0, cfg.vocab_size, (b, 20), generator=gen,
                                device="cuda") for b in (1, 2)}
    outs = {}
    for batch in (1, 2, 1):
        outs[batch] = tf.generate(gpu, prompts[batch], max_new_tokens=6,
                                  decoder=decoder).cpu()
        assert decoder.cached_batches == (batch,)
        assert len(decoder.graphs) == 1
    assert (decoder.evictions, decoder.graphs.captures) == (2, 3)
    cpu_decoder = serving_graphs.DenseDecodeGraphs(cpu)
    for batch, out in outs.items():
        assert torch.equal(out, tf.generate(cpu, prompts[batch].cpu(),
                                            max_new_tokens=6,
                                            decoder=cpu_decoder))


def _small_engine(seed):
    model = serve_cli.Model(tf.TransformerConfig(**SMALL), seed=seed,
                            device="cuda")
    return model, serve_cli.ContinuousEngine(
        model, max_slots=2, chunk=4, prefill_chunk=32, kv_block_size=16,
        kv_cache="paged")


def test_failed_capture_raises_and_nothing_runs_eagerly(gen):
    """A step that syncs the host inside its capture fails the capture:
    the chunk's rows fail, no chunk runs eagerly, no graph is kept; with
    the step repaired the next request captures and serves."""
    model, engine = _small_engine(7)
    runner = engine.decode_graphs
    step = runner._step

    def syncing_step(window):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        step(window)

    runner._step = syncing_step
    try:
        with pytest.raises(RuntimeError, match="decode chunk failed"):
            engine.generate([[1, 2, 3]], 6)
        stats = engine.graph_stats()
        assert stats["graph_captures"] == stats["graph_replays"] == 0
        assert stats["eager_chunks_on_cuda"] == 0
        del runner._step
        (got,) = engine.generate([[4, 5, 6]], 6)
    finally:
        engine.shutdown()
    want = tf.generate(model.model, torch.tensor([[4, 5, 6]], device="cuda"),
                       max_new_tokens=6,
                       decoder=model.decode_graphs)[0].tolist()
    assert got == want
    assert engine.graph_stats()["graph_captures"] == 1


def test_captures_from_many_threads_take_turns(gen):
    """Sampled requests on handler threads capture dense graphs while the
    engine loop captures its paged ones (lazy windows): 8 threads at
    once, more than the captures the card could run side by side. Every
    request succeeds and matches the same request run alone."""
    import concurrent.futures

    model, engine = _small_engine(9)
    prompts = [list(range(3 + i, 11 + 9 * i)) for i in range(8)]

    def run(i):
        if i % 2:
            return engine.generate([prompts[i]], 9)[0]
        return engine.generate([prompts[i]], 9, temperature=1.0,
                               seed=i)[0]

    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            outs = [f.result(timeout=300)
                    for f in [pool.submit(run, i) for i in range(8)]]
        alone = [run(i) for i in range(8)]
    finally:
        engine.shutdown()
    assert outs == alone
    assert engine.graph_stats()["graph_captures"] > 0
    assert model.decode_graphs.graphs.captures > 0


def test_graphs_stay_valid_across_a_pool_reset(gen):
    """Serve, fail a sync (the pools, page tables and radix index are
    reset in place), serve again: the same tokens, from the graphs
    captured before the reset."""
    _, engine = _small_engine(8)
    prompt = list(range(30, 45))
    try:
        (first,) = engine.generate([prompt], 8)
        to_host, faults = engine._to_host, []

        class Faulted:
            def numpy(self):
                raise RuntimeError("injected sync fault")

            __int__ = numpy

        def to_host_failing_once(tensor):
            if not faults:
                faults.append(1)
                return Faulted(), None
            return to_host(tensor)

        engine._to_host = to_host_failing_once
        with pytest.raises(RuntimeError, match="paged sync failed"):
            engine.generate([[1, 2, 3]], 6)
        # The faulted request's chunk captured its own window; the same
        # prompt again needs none.
        captures = engine.graph_stats()["graph_captures"]
        (again,) = engine.generate([prompt], 8)
    finally:
        engine.shutdown()
    assert engine._kv_epoch == 1
    assert again == first
    stats = engine.graph_stats()
    assert stats["graph_captures"] == captures
    assert stats["eager_chunks_on_cuda"] == 0


# -- the base from device memory (speculation's verify) -----------------------

BASE_CASES = ("q_base_window", "kv_len_rows_past_keys", "noncausal_kv_len",
              "future_keys", "diagonal_mid_tile", "kv_len_in_first_tile",
              "d32_ragged", "paged_sq16", "paged_sq64")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", BASE_CASES)
def test_device_base_is_bit_equal_to_the_int_arguments(gen, name, dtype):
    """The kernel reading [q_base, k_base, kv_len] from a device (B, 3)
    tensor gives the bits of the by-value form, at the tile edges, and
    counts one launch."""
    (b, hq, hkv, sq, sk, d), causal, kw = FWD_CASES[name]
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dtype)
    row = [kw.get("q_base", 0), kw.get("k_base", 0), kw.get("kv_len", sk)]
    base = torch.tensor([row] * b, dtype=torch.int32, device="cuda")
    want = attention.flash_fwd(q, k, v, causal=causal, sm_scale=d ** -0.5,
                               **kw)
    before = attention.flash_fwd_launches
    got = attention.flash_fwd(q, k, v, causal=causal, sm_scale=d ** -0.5,
                              base=base)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_per_row_bases_in_one_launch_equal_per_row_launches(gen, dtype):
    """One launch over B rows at their own bases (a verify's decode
    positions, a k_base, a kv_len inside the window, one past Sk and one
    below 0, both clamped by the kernel) equals B launches at int bases,
    bit for bit."""
    rows = [[1040, 0, 2048], [2000, 0, 2048], [3, 0, 2048],
            [1500, 64, 700], [1800, 0, 5000], [900, 0, -7]]
    b, d = len(rows), 128
    q = torch.randn(b, 8, 16, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, 2, 2048, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, 2, 2048, d, generator=gen, device="cuda").to(dtype)
    base = torch.tensor(rows, dtype=torch.int32, device="cuda")
    out, lse = attention.flash_fwd(q, k, v, causal=True, sm_scale=d ** -0.5,
                                   base=base)
    for i, (qb, kb, kv) in enumerate(rows):
        one, one_lse = attention.flash_fwd(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True,
            sm_scale=d ** -0.5, q_base=qb, k_base=kb, kv_len=kv)
        assert torch.equal(out[i:i + 1], one), rows[i]
        assert torch.equal(lse[i:i + 1], one_lse), rows[i]
    assert not out[5].any() and (lse[5] == attention.NEG_INF).all()


def _verify_setup(gen, seed, poss, width=16):
    """A small f32 model, random pools and the verify operands of rows at
    ``poss`` over disjoint page tables (block 16)."""
    cfg = tf.TransformerConfig(**SMALL)
    model = tf.init_params(cfg, device="cuda", seed=seed)
    bs, per_row = 16, cfg.max_seq_len // 16
    rows = len(poss)
    shape = (cfg.n_layers, 1 + rows * per_row, cfg.n_kv_heads, bs,
             cfg.head_dim)
    pools = {n: torch.randn(shape, generator=gen, device="cuda")
             for n in ("k", "v")}
    tables = (1 + torch.arange(rows * per_row)).view(rows, per_row)
    segs = torch.randint(0, cfg.vocab_size, (rows, width), generator=gen,
                         device="cuda").cpu()

    def targets(poss):
        pos = torch.tensor(poss)[:, None] + torch.arange(width)
        return torch.gather(tables, 1, pos // bs), pos % bs

    return model, pools, tables, segs, targets


def test_verify_graph_follows_poss_changed_after_capture(gen):
    """A verify captured once and replayed at two sets of positions: each
    replay's logits equal the eager batch's at those positions, 0 apart,
    and the two differ: the kernel reads its base at replay, not at
    capture."""
    poss_a, poss_b, window = [20, 70], [45, 100], 128
    model, pools, tables, segs, targets = _verify_setup(gen, 11, poss_a)
    eager_pools = {n: p.clone() for n, p in pools.items()}
    buf = {"segs": segs.cuda(), "poss": torch.zeros(2, dtype=torch.long,
                                                    device="cuda"),
           "bids": torch.zeros(2, 16, dtype=torch.long, device="cuda"),
           "offs": torch.zeros(2, 16, dtype=torch.long, device="cuda"),
           "tables": torch.zeros_like(tables).cuda()}
    kept = {}

    def run():
        kept["out"] = tf.paged_verify_batch(
            model, pools, buf["segs"], buf["poss"], buf["bids"], buf["offs"],
            buf["tables"], window, 16, return_logits=True)

    graphs = serving_graphs.GraphSet("cuda")
    graphs.capture("verify", run)  # at positions 0, null targets
    logits = []
    for poss in (poss_a, poss_b):
        bids, offs = targets(poss)
        for name, value in (("poss", torch.tensor(poss)), ("bids", bids),
                            ("offs", offs), ("tables", tables)):
            buf[name].copy_(value)
        graphs.replay("verify")
        greedy, got = (t.clone() for t in kept["out"])
        want_greedy, want = tf.paged_verify_batch(
            model, eager_pools, segs.cuda(), torch.tensor(poss).cuda(),
            bids.cuda(), offs.cuda(), tables.cuda(), window, 16,
            return_logits=True)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() == 0.0, poss
        assert torch.equal(greedy, want_greedy)
        logits.append(got)
    assert not torch.equal(logits[0], logits[1])
    assert graphs.captures == 1 and graphs.replays == 2


def test_verify_replay_equals_the_eager_batch(gen):
    """PagedVerifyGraphs at batch buckets 2 and 4 (two padding rows):
    the replay's tokens equal the eager ``paged_verify_batch``'s, and the
    pools come out bit for bit alike but for the null block; every call
    after the first of a (batch, window) is a replay."""
    poss = [3, 50, 90]
    model, pools, tables, segs, targets = _verify_setup(gen, 12, poss)
    eager_pools = {n: p.clone() for n, p in pools.items()}
    runner = serving_graphs.PagedVerifyGraphs(model, pools, 16,
                                              tables.shape[1], 16)
    bids, offs = targets(poss)
    for rows, window in ((2, 128), (3, 128), (2, 128)):
        batch = 1 << (rows - 1).bit_length()
        pad = batch - rows
        host = [torch.cat([t[:rows], torch.zeros((pad,) + t.shape[1:],
                                                 dtype=t.dtype)])
                for t in (segs, torch.tensor(poss), bids, offs, tables)]
        got = runner(*(t.numpy() for t in host), window).clone()
        want = tf.paged_verify_batch(model, eager_pools,
                                     *(t.cuda() for t in host), window, 16)
        torch.cuda.synchronize()
        assert torch.equal(got[:rows], want[:rows])
    assert (runner.graphs.captures, runner.graphs.replays) == (2, 3)
    for name in ("k", "v"):
        assert torch.equal(pools[name][:, 1:], eager_pools[name][:, 1:])


# Backward kernels vs flash_bwd_reference, per gradient: the relative L2
# error and the worst row against its own norm plus the typical row norm
# (chip_smoke.grad_errors). bf16: both round p and ds at the same values
# up to f32 summation-order noise, and each writes one bf16 output (about
# 2^-9 of a row's norm); f32: summation order only.
BWD_TOL = {torch.bfloat16: {"rel_l2": 5e-3, "row": 1e-2},
           torch.float32: {"rel_l2": 1e-5, "row": 1e-4}}
BWD_CASES = {
    **CASES,
    "mqa_unaligned": ((2, 4, 1, 100, 100, 64), True, {}),
    "noncausal_gqa": ((1, 8, 2, 130, 70, 128), False, {}),
    # The edges of the backward's tiles (dk/dv: 128-key blocks of two
    # 64-key halves and 64-row q tiles; dq: 128-row blocks and 64-key
    # tiles): one row past a 64-row q tile, a ragged key half, and a GQA
    # group of 8 q heads summed into each dk/dv.
    "sq65": ((1, 8, 2, 65, 65, 128), True, {}),
    "sk191": ((1, 8, 2, 256, 191, 128), False, {}),
    "gqa8": ((1, 32, 4, 256, 256, 128), True, {}),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_bwd_kernels_match_plain_version(gen, name, dtype):
    (b, hq, hkv, sq, sk, d), causal, kw = BWD_CASES[name]
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(dtype)
    kw = dict(kw, causal=causal, sm_scale=d ** -0.5)
    out, lse = attention.flash_fwd(q, k, v, **kw)
    before = (attention.flash_dq_launches, attention.flash_dkv_launches)
    grads = attention.flash_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert (attention.flash_dq_launches, attention.flash_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    ref = attention.flash_bwd_reference(q, k, v, out, lse, g, **kw)
    tol = BWD_TOL[dtype]
    for got, want in zip(grads, ref):
        assert got.dtype == dtype and got.shape == want.shape
        _, rel_l2, worst_row = chip_smoke.grad_errors(got, want)
        assert rel_l2 <= tol["rel_l2"] and worst_row <= tol["row"], name
    kv_len = kw.get("kv_len", sk)
    assert not grads[1][:, :, kv_len:].any()
    assert not grads[2][:, :, kv_len:].any()


# f32 card (the f32 kernels, cuBLAS without TF32) vs CPU: summation order
# only. Each gradient to 1e-4 relative L2; each step's loss to 1e-4.
TRAIN_GRAD_REL_L2 = 1e-4
TRAIN_LOSS_ATOL = 1e-4
TRAIN_STEPS = 3


def test_training_step_on_card_matches_cpu(gen):
    """Every gradient of a tiny f32 model (head dim 128: the f32 kernels)
    on the card vs the same weights on the CPU, then three make_train_step
    steps on each, whose losses after the first see the updates."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    batches = [torch.randint(0, 512, (2, 65), generator=gen, device="cuda")
               for _ in range(TRAIN_STEPS)]
    gpu = tf.init_params(cfg, device="cuda", seed=3)
    cpu = tf.Transformer(cfg, "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    for model in (gpu, cpu):
        model.zero_grad(set_to_none=True)
        tf.loss_fn(model, {"tokens": batches[0]}, remat=True).backward()
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        ref = b.grad.float()
        err = (a.grad.cpu().float() - ref).norm() / ref.norm()
        assert err < TRAIN_GRAD_REL_L2, name
    runs = []
    for model, device in ((gpu, "cuda"), (cpu, "cpu")):
        init_state, train_step = tf.make_train_step(cfg, device=device)
        runs.append((init_state(model=model), train_step, device))
    counts = (attention.flash_fwd_launches, attention.flash_dq_launches,
              attention.flash_dkv_launches)
    for step, batch in enumerate(batches):
        a, b = [train_step(state, {"tokens": batch.to(device)})[1].item()
                  for state, train_step, device in runs]
        assert abs(a - b) < TRAIN_LOSS_ATOL, step
        if step == 0:
            # Adam's first step moves each weight by about lr = 3e-4;
            # see test_torch_train.py.
            for (name, p), r in zip(gpu.state_dict().items(),
                                    cpu.state_dict().values()):
                torch.testing.assert_close(p.cpu(), r, atol=6e-4, rtol=0,
                                           msg=name)
    assert (attention.flash_fwd_launches, attention.flash_dq_launches,
            attention.flash_dkv_launches) == (
        counts[0] + 2 * cfg.n_layers * TRAIN_STEPS,
        counts[1] + cfg.n_layers * TRAIN_STEPS,
        counts[2] + cfg.n_layers * TRAIN_STEPS)


# -- the dense continuous-batching engine -------------------------------------

def _dense_state(gen, cfg, slots):
    cache = {n: torch.randn((cfg.n_layers, slots, cfg.n_kv_heads,
                             cfg.max_seq_len, cfg.head_dim), generator=gen,
                            device="cuda") for n in ("k", "v")}
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                           device="cuda")
    return cache, tokens


@pytest.mark.parametrize("mask_writes", [False, True])
def test_dense_chunk_graphs_match_the_eager_chunk(gen, mask_writes):
    """The captured dense step replayed ``steps`` times gives the eager
    ``decode_chunk``'s tokens, last tokens and positions, and the same
    cache, 0 apart (small f32 model, 4 rows, one inactive, one clamping
    at the window's end)."""
    cfg = tf.TransformerConfig(**SMALL)
    model = tf.init_params(cfg, device="cuda", seed=8)
    cache, tokens = _dense_state(gen, cfg, 4)
    eager = {n: c.clone() for n, c in cache.items()}
    positions = torch.tensor([3, 62, 40, 32])
    active = torch.tensor([True, True, False, True])
    want, last, pos = tf.decode_chunk(
        model, eager, tokens.clone(), positions.cuda(), active.cuda(),
        steps=3, window=64, mask_writes=mask_writes)
    runner = serving_graphs.DenseChunkGraphs(model, cache, 4, 4)
    got = runner(tokens.cpu().numpy(), positions.numpy(), active.numpy(), 3,
                 64, mask_writes)
    torch.cuda.synchronize()
    assert (runner.graphs.captures, runner.graphs.replays) == (1, 3)
    assert torch.equal(got, want) and torch.equal(runner.tokens, last)
    assert torch.equal(runner.positions, pos)
    for name in ("k", "v"):
        assert (cache[name] - eager[name]).abs().max().item() == 0.0


@pytest.mark.parametrize("mask_writes", [False, True])
def test_dense_chunk_graphs_of_one_step_match_the_eager_chunk(
        gen, mask_writes):
    """``--decode-chunk 1``: ``out`` has one row, below the capture's
    WARMUP_ITERS warm-up iterations, which restart its row counter each
    (``GraphSet.capture``'s ``reset``) and so never write past it. Two
    one-step chunks give the eager ``decode_chunk``'s tokens, positions
    and cache, 0 apart."""
    cfg = tf.TransformerConfig(**SMALL)
    model = tf.init_params(cfg, device="cuda", seed=11)
    cache, tokens = _dense_state(gen, cfg, 4)
    eager = {n: c.clone() for n, c in cache.items()}
    positions = torch.tensor([3, 62, 40, 32])
    active = torch.tensor([True, True, False, True])
    runner = serving_graphs.DenseChunkGraphs(model, cache, 4, 1)
    tok, pos, tok_dev, pos_dev = tokens.clone(), positions.cuda(), \
        tokens.cpu().numpy(), positions.numpy()
    for _ in range(2):
        want, tok, pos = tf.decode_chunk(
            model, eager, tok, pos, active.cuda(), steps=1, window=64,
            mask_writes=mask_writes)
        got = runner(tok_dev, pos_dev, active.numpy(), 1, 64, mask_writes)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(runner.positions, pos)
        tok_dev, pos_dev = got[-1].cpu().numpy(), \
            runner.positions.cpu().numpy()
    assert (runner.graphs.captures, runner.graphs.replays) == (1, 2)
    for name in ("k", "v"):
        assert (cache[name] - eager[name]).abs().max().item() == 0.0


def test_paged_chunk_graphs_of_one_step_match_the_eager_chunk(gen):
    """The paged runner at ``--decode-chunk 1``: its capture's warm-up
    iterations stay inside the one-row ``out`` too, and a one-step chunk
    gives the eager ``paged_decode_chunk``'s tokens and pools (but the
    null block)."""
    cfg = tf.TransformerConfig(**SMALL)
    model = tf.init_params(cfg, device="cuda", seed=12)
    slots, bs = 4, 16
    per_row = cfg.max_seq_len // bs
    shape = (cfg.n_layers, 1 + slots * per_row, cfg.n_kv_heads, bs,
             cfg.head_dim)
    pools = {n: torch.randn(shape, generator=gen, device="cuda")
             for n in ("k", "v")}
    eager_pools = {n: p.clone() for n, p in pools.items()}
    tables = (1 + torch.arange(slots * per_row)).view(slots, per_row)
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                           device="cuda")
    positions = torch.tensor([3, 62, 40, 32])
    active = torch.tensor([True, True, False, True])
    want, last, _ = tf.paged_decode_chunk(
        model, eager_pools, tables.cuda(), tokens.clone(), positions.cuda(),
        active.cuda(), steps=1, window=64, block_size=bs)
    last_dev = tokens.clone()
    runner = serving_graphs.PagedDecodeGraphs(model, pools, last_dev,
                                              tuple(tables.shape), 1, bs)
    got = runner(tables.numpy(), positions.numpy(), active.numpy(), 1, 64)
    torch.cuda.synchronize()
    assert (runner.graphs.captures, runner.graphs.replays) == (1, 1)
    assert torch.equal(got, want) and torch.equal(last_dev, last)
    for name in ("k", "v"):
        assert torch.equal(pools[name][:, 1:], eager_pools[name][:, 1:])


def test_dense_capture_leaves_live_slots_bit_identical(gen):
    """A capture made while every slot holds live K/V (``--warmup=lazy``
    mid-traffic): its warm-up iterations execute, and the unmasked step
    writes position 0 of every slot; the capture restores it, so each
    (window, mask_writes) capture leaves the whole cache bit-identical."""
    cfg = tf.TransformerConfig(**SMALL)
    model = tf.init_params(cfg, device="cuda", seed=9)
    cache, _ = _dense_state(gen, cfg, 4)
    before = {n: c.clone() for n, c in cache.items()}
    runner = serving_graphs.DenseChunkGraphs(model, cache, 4, 4)
    for window in (16, 128):
        for mask in (False, True):
            assert runner.warm(window, mask) is False
            assert runner.warm(window, mask) is True
            torch.cuda.synchronize()
            for name in ("k", "v"):
                assert torch.equal(cache[name], before[name]), (window, mask)
    assert runner.graphs.captures == 4


def test_dense_engine_on_card_matches_dense_generate(gen):
    """The dense engine (the default ``kv_cache``) on a small f32 model
    returns dense generate's tokens exactly, for concurrent requests with
    a prompt prefilled in three segments; every prefill runs the flash
    kernel once per layer and every decode chunk replays its graph."""
    cfg = tf.TransformerConfig(**SMALL)
    model = serve_cli.Model(cfg, seed=10, device="cuda")
    engine = serve_cli.ContinuousEngine(model, max_slots=2, chunk=4,
                                        prefill_chunk=32)
    cases = [(list(range(7, 47)), 6), (list(range(100, 170)), 7),
             ([5, 6, 7], 9)]
    before = attention.flash_fwd_launches
    try:
        with chip_smoke.concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = [pool.submit(engine.generate, [p], n)
                       for p, n in cases]
            outs = [f.result(timeout=300)[0] for f in futures]
    finally:
        engine.shutdown()
    assert engine.kv is None
    assert attention.flash_fwd_launches - before == \
        cfg.n_layers * engine.stats()["n_prefills"]
    graphs = engine.graph_stats()
    assert graphs["graph_captures"] > 0 and graphs["eager_chunks_on_cuda"] == 0
    assert graphs["graph_replays"] == engine.stats()["steps_done"]
    for (prompt, max_new), got in zip(cases, outs):
        want = tf.generate(model.model,
                           torch.as_tensor([prompt], device="cuda"),
                           max_new_tokens=max_new,
                           decoder=model.decode_graphs)
        assert got == want[0].tolist()


# -- weight-only int8 (W8A16) ---------------------------------------------------

# (M, K, N): decode rows, odd M, K not a multiple of 16 (the element-wise
# loads) and N not a multiple of the 128-wide tile, the verify's and the
# prefill's tiles. The Hopper kernel's edges: each token tile's last row
# and the next's first (M 1, 8, 16, 17, 64, 128, 129, 256, 257, 2048), N
# not a multiple of its 64- or 128-channel tile, K 14336 (a cluster of K
# splits at M <= 16, and past the verify), K past a 128-deep stage by 16
# (a stage's second x atom wholly past K), K under one stage (the general
# path's cp.async loads).
INT8_SHAPES = [(1, 64, 40), (3, 200, 130), (17, 256, 300), (8, 4096, 1024),
               (1, 77, 9), (128, 512, 200), (300, 256, 136), (513, 96, 260),
               (1, 14336, 4096), (8, 14336, 300), (16, 14336, 1000),
               (16, 4096, 14336), (17, 144, 300), (64, 1024, 200),
               (129, 512, 200), (128, 14336, 520), (256, 384, 136),
               (257, 1024, 520), (2048, 4096, 1000), (9, 112, 72)]


def _int8_operands(gen, m, k, n, dtype):
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
    qw = quantization.quantize_weight(w)
    return x, qw["q"].T.contiguous(), qw["scale"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=str)
def test_int8_mm_matches_plain_version(gen, shape, dtype):
    """The kernel against ``int8_mm_reference`` on the same operands. bf16:
    both sum exact int8 x bf16 products in f32 and round once, so they
    agree to one bf16 step (2^-7 of |ref|) plus the f32 summation-order
    noise; f32: summation order only. One launch counted per call."""
    m, k, n = shape
    x, qt, scale = _int8_operands(gen, m, k, n, dtype)
    before = int8_matmul.int8_mm_launches
    got = int8_matmul.int8_mm(x, qt, scale)
    torch.cuda.synchronize()
    assert int8_matmul.int8_mm_launches == before + 1
    want = int8_matmul.int8_mm_reference(x, qt, scale)
    assert got.dtype == dtype and got.shape == (m, n)
    rtol, atol = (2.0 ** -7, 1e-3) if dtype == torch.bfloat16 else \
        (1e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", [(8, 4096, 1024), (128, 512, 200),
                                   (1, 4096, 1024), (1, 14336, 4096),
                                   (8, 4096, 14336), (128, 4096, 14336)],
                         ids=str)
def test_int8_mm_replay_is_bit_equal_to_the_eager_launch(gen, shape):
    """Captured in a CUDA graph (with and without a cluster split of K), a
    replay gives the eager launch's output bit for bit: the partials are
    summed in rank order, never by atomics; the capture counts no
    launch."""
    m, k, n = shape
    x, qt, scale = _int8_operands(gen, m, k, n, torch.bfloat16)
    eager = int8_matmul.int8_mm(x, qt, scale)
    out = {}
    graphs = serving_graphs.GraphSet("cuda")
    counted = int8_matmul.int8_mm_launches
    graphs.capture("mm", lambda: out.update(y=int8_matmul.int8_mm(
        x, qt, scale)))
    assert int8_matmul.int8_mm_launches == counted
    out["y"].zero_()
    graphs.replay("mm")
    torch.cuda.synchronize()
    assert torch.equal(out["y"], eager)


@pytest.mark.parametrize("m", [1, 8, 16])
def test_int8_mm_is_one_kernel_without_workspace_at_decode_rows(gen, m):
    """At M <= 16 a product splits K inside one launch (a cluster summed in
    rank order): no workspace, and the profiler sees one kernel, the
    Hopper one, with no reduce kernel after it."""
    from torch.profiler import ProfilerActivity, profile

    from container_engine_accelerators_tpu_torch.ops import _ext

    k, n = 14336, 4096
    x, qt, scale = _int8_operands(gen, m, k, n, torch.bfloat16)
    assert _ext.int8_mm_workspace_floats(torch.bfloat16, m, n, k) == 0
    int8_matmul.int8_mm(x, qt, scale)  # built and set up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        int8_matmul.int8_mm(x, qt, scale)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, kernels
    assert "int8_mm_sm90_kernel" in kernels[0], kernels
    assert not any("reduce" in name for name in kernels), kernels


@pytest.mark.parametrize("m", [1, 8, 128, 300])
def test_int8_mm_unaligned_weight_takes_the_elementwise_path(gen, m):
    """A qt view one byte past a 16-byte boundary (no TMA map describes
    it) takes the general path's element-wise loads, within the plain
    version's tolerance."""
    k, n = 512, 136
    x, qt, scale = _int8_operands(gen, m, k, n, torch.bfloat16)
    buf = torch.empty(n * k + 1, dtype=torch.int8, device="cuda")
    view = buf[1:].view(n, k)
    view.copy_(qt)
    assert view.data_ptr() % 16 and view.is_contiguous()
    got = int8_matmul.int8_mm(x, view, scale)
    torch.cuda.synchronize()
    want = int8_matmul.int8_mm_reference(x, qt, scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


def test_int8_mm_rejects_what_it_does_not_take(gen):
    x, qt, scale = _int8_operands(gen, 4, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        int8_matmul.int8_mm(x.half(), qt, scale)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul.int8_mm(x, qt.float(), scale)
    with pytest.raises(ValueError, match="last dim"):
        int8_matmul.int8_mm(x[:, :32], qt, scale)
    with pytest.raises(ValueError, match="cpu or all on cuda"):
        int8_matmul.int8_mm(x, qt.cpu(), scale)


def _int8_model(seed):
    cfg = tf.TransformerConfig(**SMALL)
    return cfg, quantization.quantize_params(
        tf.init_params(cfg, device="cuda", seed=seed))


def test_int8_small_model_on_card_matches_cpu(gen):
    """A small f32 int8 model (the kernel's f32 path in every projection)
    generates the CPU's tokens on the same int8 weights; the prefill
    launches 7 products a layer."""
    cfg, gpu = _int8_model(12)
    cpu = quantization.quantize_params(tf.Transformer(cfg, "cpu"))
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    prompt = torch.arange(5, 30)[None, :]
    before = int8_matmul.int8_mm_launches
    with torch.inference_mode():
        tf.forward(gpu, prompt.cuda())
    assert int8_matmul.int8_mm_launches == before + 7 * cfg.n_layers
    out = tf.generate(gpu, prompt.cuda(), max_new_tokens=6,
                      decoder=serving_graphs.DenseDecodeGraphs(gpu)).cpu()
    assert torch.equal(out, tf.generate(
        cpu, prompt, max_new_tokens=6,
        decoder=serving_graphs.DenseDecodeGraphs(cpu)))


def test_int8_dense_chunk_replay_matches_the_eager_chunk(gen):
    """The int8 model's dense decode step captured and replayed gives the
    eager ``decode_chunk``'s tokens, positions and cache, 0 apart; the
    eager chunk counts 7 × layers launches a step, the capture none."""
    cfg, model = _int8_model(13)
    cache, tokens = _dense_state(gen, cfg, 4)
    eager = {n: c.clone() for n, c in cache.items()}
    positions = torch.tensor([3, 62, 40, 32])
    active = torch.tensor([True, True, False, True])
    before = int8_matmul.int8_mm_launches
    want, last, pos = tf.decode_chunk(
        model, eager, tokens.clone(), positions.cuda(), active.cuda(),
        steps=3, window=64)
    assert int8_matmul.int8_mm_launches == before + 3 * 7 * cfg.n_layers
    runner = serving_graphs.DenseChunkGraphs(model, cache, 4, 4)
    before = int8_matmul.int8_mm_launches
    got = runner(tokens.cpu().numpy(), positions.numpy(), active.numpy(), 3,
                 64, False)
    torch.cuda.synchronize()
    assert int8_matmul.int8_mm_launches == before
    assert (runner.graphs.captures, runner.graphs.replays) == (1, 3)
    assert torch.equal(got, want) and torch.equal(runner.tokens, last)
    assert torch.equal(runner.positions, pos)
    for name in ("k", "v"):
        assert (cache[name] - eager[name]).abs().max().item() == 0.0
