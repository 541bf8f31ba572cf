# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's CUDA kernel on the card (skipped without a GPU).

Imports no JAX (the machine with the card has none), so run it there
without the repo's JAX-configuring conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import threading
import time

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
from container_engine_accelerators_tpu_torch.ops import _ext  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention,
    int8_matmul,
)

pytestmark = pytest.mark.cuda

# Kernel vs flash_fwd_reference on the same inputs. bf16: both round p
# and out to bf16 but p at different running maxima, so an output may
# differ by about one bf16 step (2^-8 relative); f16 the same at its step
# (2^-11, 8 times finer); f32: summation order.
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float16: (2e-3, 2e-3),
       torch.float32: (2e-5, 0.0)}
# The flash kernels' dtypes: the 16-bit tensor-core kernels and the f32
# check kernels.
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


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
    # Head dims between the kernels' widths (run on the next width up with
    # the columns past d read as zeros): 80 and 96 on the D 128 kernels, 40
    # and 24 on the D 64 and D 32 ones, 136 on the D 256 ones (its last
    # 64-column atom wholly past d), 100 (not a multiple of 8: the binding
    # pads it to 104); and D 256 itself (64-key forward tiles, 32-row
    # backward tiles, the dk/dv kernel's two walks).
    "d80_causal_gqa": ((1, 8, 2, 300, 300, 80), True, {}),
    "d96_noncausal_kv_len": ((2, 4, 2, 200, 333, 96), False,
                             {"kv_len": 250}),
    "d96_q_base": ((1, 8, 8, 100, 512, 96), True, {"q_base": 300}),
    "d100_padded": ((1, 8, 2, 257, 257, 100), True, {}),
    "d40_gqa": ((2, 4, 2, 100, 100, 40), True, {}),
    "d24_unaligned": ((2, 4, 4, 77, 77, 24), True, {}),
    "d136_atom_past_d": ((1, 4, 2, 129, 129, 136), True, {}),
    "d256_mqa": ((1, 8, 1, 300, 300, 256), True, {}),
    "d256_noncausal_kv_len": ((1, 4, 2, 130, 200, 256), False,
                              {"kv_len": 150}),
    # B * Hq (and, in the second, B * Hkv) past grid.y's 65535: folded
    # over grid.y and grid.z.
    "bhq_65792": ((2056, 32, 8, 128, 128, 64), True, {}),
    "bhkv_65792": ((4112, 16, 16, 32, 32, 32), True, {}),
    # Head dims past 256, by column chunks (the forward and dq: chunks of up
    # to 4 atoms of 64 columns; dk/dv: of 2): 264 (an atom of 8 columns),
    # 288 (Gemma-2-2B's and Gemma-3-1B's heads on the repo's block), 300
    # (padded to 304), 384, 512 and 1024 (the widest the kernels take).
    "d264_mqa": ((1, 4, 1, 300, 300, 264), True, {}),
    "d288_gqa": ((1, 8, 4, 257, 257, 288), True, {}),
    "d300_padded_kv_len": ((1, 4, 2, 130, 333, 300), False,
                           {"kv_len": 250}),
    "d384_q_base": ((1, 4, 2, 100, 512, 384), True, {"q_base": 300}),
    "d512_mha": ((1, 8, 8, 256, 256, 512), True, {}),
    "d1024_mqa": ((1, 2, 1, 200, 200, 1024), True, {}),
    # The wide forward's edges: D 640, the widest whose 128-row q tile
    # stays resident (10 atoms), Sq not a multiple of the tile; D 648, the
    # first streamed; D 288 rows with no visible key (k_base 64).
    "d640_resident_edge": ((1, 4, 2, 200, 333, 640), True, {"q_base": 100}),
    "d648_streamed": ((1, 4, 2, 200, 200, 648), True, {}),
    "d288_future_keys": ((1, 4, 2, 128, 128, 288), True, {"k_base": 64}),
}
# The paged engine's prefill segments: a segment bucket below the 128-row
# q tile at a block-aligned (not tile-aligned) q_base, against a window
# that reaches past the diagonal.
FWD_CASES = {
    **CASES,
    "paged_sq16": ((1, 8, 2, 16, 2048, 128), True, {"q_base": 1040}),
    "paged_sq64": ((1, 8, 2, 64, 4096, 64), True, {"q_base": 2000}),
    # A verify's rows at D 288, over a window past the diagonal.
    "d288_sq16": ((2, 8, 4, 16, 1024, 288), True, {"q_base": 700}),
}


@pytest.mark.parametrize("dtype", DTYPES)
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


@pytest.mark.parametrize("dtype", DTYPES)
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
    q = torch.randn(1, 2, 16, 1032, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 1032.*1024"):
        attention.flash_fwd(q, q, q, causal=True, sm_scale=0.1)
    q = torch.randn(1, 2, 16, 64, device="cuda", dtype=torch.float64)
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
              "d32_ragged", "paged_sq16", "paged_sq64", "d288_sq16",
              "d300_padded_kv_len", "d640_resident_edge", "d288_future_keys",
              "d648_streamed")


@pytest.mark.parametrize("dtype", DTYPES)
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


@pytest.mark.parametrize("dtype", DTYPES)
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
           torch.float16: {"rel_l2": 1e-3, "row": 2e-3},
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


@pytest.mark.parametrize("dtype", DTYPES)
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


# The dk/dv launch's GQA split (_ext.dkv_plan) on a 132-SM card: one and
# two KV heads whose blocks would leave it idle. (B, Hq, Hkv, S, D).
SPLIT_CASES = {
    "mqa_d128_s1024": (1, 8, 1, 1024, 128),
    "gqa2_d128_s2048": (1, 8, 2, 2048, 128),
    "mqa_d256_s512": (1, 8, 1, 512, 256),
    "mqa_d288_s1024": (1, 4, 1, 1024, 288),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_dkv_is_the_same_bits_every_run(gen, name, dtype):
    """The split blocks' f32 partials, summed in a fixed order by the
    second kernel, give the same bits on every run, and agree with the
    plain version of the split (``flash_bwd_dkv_split_reference``)."""
    b, hq, hkv, s, d = SPLIT_CASES[name]
    split, _, _ = _ext.dkv_plan(b, hq, hkv, s, d, _ext.sm_count(0))
    assert split > 1, name
    q, g = (torch.randn(b, hq, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kw = dict(causal=True, sm_scale=d ** -0.5)
    out, lse = attention.flash_fwd(q, k, v, **kw)
    runs = [attention.flash_bwd(q, k, v, out, lse, g, **kw)[1:]
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other)), name
    ref = attention.flash_bwd_dkv_split_reference(q, k, v, out, lse, g,
                                                  split=split, **kw)
    tol = BWD_TOL[dtype]
    for got, want in zip(runs[0], ref):
        _, rel_l2, worst_row = chip_smoke.grad_errors(got, want)
        assert rel_l2 <= tol["rel_l2"] and worst_row <= tol["row"], name


def test_dkv_plan_is_the_kernels_plan(gen):
    """``_ext.dkv_plan``'s scratch for a split group is what csrc's
    launch asks for, on this card's SM count."""
    lib = _ext._flash_bwd_lib()
    n_sm = _ext.sm_count(0)
    for shape in [(1, 8, 1, 4096, 256), (1, 8, 2, 4096, 128),
                  (1, 32, 8, 2048, 128), (1, 32, 8, 8192, 128),
                  (1, 4, 1, 4096, 288), (1, 8, 4, 4096, 288),
                  (2, 16, 4, 1000, 1024), (3, 6, 2, 100, 64)]:
        assert lib.flash_bwd_dkv_partial_floats(*shape, n_sm) == \
            _ext.dkv_partial_floats(*shape, n_sm), shape


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=str)
def test_int8_mm_matches_plain_version(gen, shape, dtype):
    """The kernel against ``int8_mm_reference`` on the same operands. bf16:
    both sum exact int8 x bf16 products in f32 and round once, so they
    agree to one bf16 step (2^-7 of |ref|) plus the f32 summation-order
    noise; f16 the same at its step (2^-10); f32: summation order only.
    One launch counted per call."""
    m, k, n = shape
    x, qt, scale = _int8_operands(gen, m, k, n, dtype)
    before = int8_matmul.int8_mm_launches
    got = int8_matmul.int8_mm(x, qt, scale)
    torch.cuda.synchronize()
    assert int8_matmul.int8_mm_launches == before + 1
    want = int8_matmul.int8_mm_reference(x, qt, scale)
    assert got.dtype == dtype and got.shape == (m, n)
    rtol, atol = {torch.bfloat16: (2.0 ** -7, 1e-3),
                  torch.float16: (2.0 ** -10, 1e-3),
                  torch.float32: (1e-5, 1e-5)}[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=str)
def test_int8_mm_f32_output_matches_plain_version(gen, shape, dtype):
    """16-bit activations with an f32 output (the tensor-parallel
    reduce-scatter's partial sums): the tensor-core kernels with the scaled
    accumulator written unrounded, against ``int8_mm_reference`` with the
    same output dtype. Both sum exact int8 x bf16 (f16) products in f32, so
    only the order of the f32 sums differs; the 16-bit-output launch on the
    same operands (the same tiles and K splits) is that result rounded
    once, bit for bit."""
    m, k, n = shape
    x, qt, scale = _int8_operands(gen, m, k, n, dtype)
    before = int8_matmul.int8_mm_launches
    got = int8_matmul.int8_mm(x, qt, scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert int8_matmul.int8_mm_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = int8_matmul.int8_mm_reference(x, qt, scale,
                                         out_dtype=torch.float32)
    # f16 products carry up to 18 significant bits where bf16's carry 15,
    # so the f32 partial sums round from the first few terms on: order
    # noise of about sqrt(K) 2^-24 |y|, 2e-5 at K 14336 and |y| ~ 3
    # (observed 1.4e-5); bf16's sums stay exact longer.
    atol = 1e-5 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    assert torch.equal(int8_matmul.int8_mm(x, qt, scale), got.to(dtype))


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
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        int8_matmul.int8_mm(x.double(), qt, scale)
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


# -- observability on the card --------------------------------------------------

@pytest.mark.parametrize("kv", ["dense", "paged", "paged_ngram"])
def test_ledger_sums_to_its_envelopes_on_replayed_chunks(gen, kv):
    """``--chip-accounting`` on the card: every decode chunk (and verify)
    a graph replay, timed by no added sync, and the ledger's device
    seconds over every label equal the envelopes it booked, the phase
    counters' seconds, to 1e-9 s; its decode seconds are positive."""
    from container_engine_accelerators_tpu_torch.obs import devicetime
    from container_engine_accelerators_tpu_torch.obs import metrics

    cfg = tf.TransformerConfig(**SMALL)
    model = serve_cli.Model(cfg, seed=11, device="cuda")
    extra = {"dense": {},
             "paged": dict(kv_cache="paged", kv_block_size=16),
             "paged_ngram": dict(kv_cache="paged", kv_block_size=16,
                                 speculate="ngram")}[kv]
    reg = metrics.Registry()
    engine = serve_cli.ContinuousEngine(
        model, max_slots=2, chunk=4, prefill_chunk=32, registry=reg,
        devicetime=devicetime.DeviceTimeLedger(registry=reg), **extra)
    cases = [(list(range(7, 47)), 6), ([1, 2, 3] * 10, 12), ([5, 6, 7], 9)]
    try:
        with chip_smoke.concurrent.futures.ThreadPoolExecutor(3) as pool:
            for f in [pool.submit(engine.generate, [p], n)
                      for p, n in cases]:
                f.result(timeout=300)
    finally:
        engine.shutdown()
    graphs = engine.graph_stats()
    assert graphs["graph_replays"] > 0 and graphs["eager_chunks_on_cuda"] == 0
    assert graphs.get("eager_verifies_on_cuda", 0) == 0
    series = engine.registry.get("tpu_serving_device_seconds_total")
    device_s = sum(c.value for _, c in series._series())
    envelopes = engine._m_t_prefill.value + engine._m_t_chunk.value
    if kv == "paged_ngram":
        envelopes += engine._m_t_verify.value
    assert abs(device_s - envelopes) <= 1e-9
    assert engine.devicetime.per_phase["decode"] > 0
    assert engine.chip_stats()["device_s"] == pytest.approx(device_s)


def test_hbm_model_weights_equal_the_allocation_of_loading(gen):
    """The HBM model's ``weights`` (bf16) against the bytes loading the
    model allocated on the card, within 1 % (the allocator rounds each
    tensor up to 512 B); its ``kv_pool`` equal to the pools' bytes."""
    from container_engine_accelerators_tpu_torch.obs import hbm

    cfg = tf.TransformerConfig(**{**SMALL, "vocab_size": 4096,
                                  "d_model": 512, "d_ff": 1536,
                                  "n_heads": 4, "n_kv_heads": 2,
                                  "dtype": "bfloat16"})
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    model = serve_cli.Model(cfg, seed=12, device="cuda")
    torch.cuda.synchronize()
    loaded = torch.cuda.memory_allocated() - alloc0
    assert abs(hbm.weights_bytes(cfg) - loaded) <= 0.01 * loaded
    engine = serve_cli.ContinuousEngine(model, max_slots=2, chunk=4,
                                        prefill_chunk=32, kv_cache="paged",
                                        kv_block_size=16, start_loop=False)
    assert hbm.HbmModel(engine).kv_pool == \
        sum(t.nbytes for t in engine.cache.values())


def test_profile_dir_trace_names_the_flash_kernel(gen, tmp_path):
    """``--profile-dir``'s bracket on the card: the trace holds one
    ``flash_fwd_sm90_kernel`` event per launch the request made."""
    import json
    import os

    from container_engine_accelerators_tpu_torch.utils import profiling

    cfg = tf.TransformerConfig(**{**SMALL, "dtype": "bfloat16",
                                  "n_heads": 2, "d_model": 256})
    model = serve_cli.Model(cfg, seed=13, device="cuda")
    model.generate([[1, 2, 3]], 2)  # kernels built outside the window
    before = attention.flash_fwd_launches
    with profiling.trace_or_null(str(tmp_path)):
        model.generate([list(range(5, 45))], 4)
    launches = attention.flash_fwd_launches - before
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    assert launches == cfg.n_layers
    assert sum("flash_fwd_sm90_kernel" in k for k in kernels) == launches


# -- cross-replica KV handoff on the card -------------------------------------

HANDOFF_ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=32,
                      kv_cache="paged", kv_block_size=16)
# 50 tokens: 3 full blocks of 16 travel, the receiver prefills the rest.
HANDOFF_PROMPT = list(range(3, 53))


def _handoff_pair(cfg, seed):
    model = serve_cli.Model(cfg, seed=seed, device="cuda")
    return (serve_cli.ContinuousEngine(model, **HANDOFF_ENGINE),
            serve_cli.ContinuousEngine(model, **HANDOFF_ENGINE))


def _pool_ptrs(engine):
    return [p.data_ptr() for p in engine.cache.values()]


def test_kv_handoff_bf16_round_trip_is_bit_exact(gen):
    """A bf16 stream exported on the card installs bit for bit: the
    receiver's pools hold the sender's bytes at the installed ids, its
    pools keep their addresses, and it serves the sender's radix-hit
    tokens."""
    cfg = tf.TransformerConfig(**{**SMALL, "dtype": "bfloat16"})
    a, b = _handoff_pair(cfg, 14)
    try:
        a.generate([HANDOFF_PROMPT], 6)
        want = a.generate([HANDOFF_PROMPT], 6)[0]
        frames = a.kv_export(HANDOFF_PROMPT)
        assert frames[1]["payload"]["kv"]["dtype"] == "bfloat16"
        ptrs = _pool_ptrs(b)
        assert b.kv_install(frames)["installed_blocks"] == 3
        assert _pool_ptrs(b) == ptrs
        ids = torch.tensor(b.kv.radix.match(HANDOFF_PROMPT), device="cuda")
        sent = torch.tensor([f["payload"]["block"] for f in frames[1:-1]],
                            device="cuda")
        for name in ("k", "v"):
            assert torch.equal(b.cache[name][:, ids].view(torch.int16),
                               a.cache[name][:, sent].view(torch.int16))
        assert b.generate([HANDOFF_PROMPT], 6)[0] == want
    finally:
        a.shutdown()
        b.shutdown()


def test_kv_install_under_captured_graphs_is_read_by_the_replay(gen):
    """An install into a receiver whose decode graph is captured already:
    the install writes the pools the graph holds, so the next chunks
    replay (no capture, nothing eager) over the installed blocks and give
    the sender's tokens."""
    cfg = tf.TransformerConfig(**SMALL)
    a, b = _handoff_pair(cfg, 15)
    try:
        a.generate([HANDOFF_PROMPT], 6)
        want = a.generate([HANDOFF_PROMPT], 6)[0]
        b.generate([list(range(100, 150))], 6)  # captures the window
        before = b.graph_stats()
        assert before["graph_captures"] > 0
        assert b.kv_install(a.kv_export(HANDOFF_PROMPT))[
            "installed_blocks"] == 3
        hit0 = b.kv_stats()["prefix_hit_tokens"]
        assert b.generate([HANDOFF_PROMPT], 6)[0] == want
        after = b.graph_stats()
        assert b.kv_stats()["prefix_hit_tokens"] - hit0 == 48
        assert after["graph_captures"] == before["graph_captures"]
        assert after["graph_replays"] > before["graph_replays"]
        assert after["eager_chunks_on_cuda"] == 0
    finally:
        a.shutdown()
        b.shutdown()


def test_failed_install_copy_resets_and_wakes_no_row_on_unwritten_blocks(
        gen):
    """A failure in the install's device copy (half the blocks written,
    then an error) takes the reset path: the pools are zeroed in place,
    the radix index forgotten, the row in flight fails instead of reading
    on, and the prompt then prefills cold to the sender's cold tokens."""
    cfg = tf.TransformerConfig(**SMALL)
    a, b = _handoff_pair(cfg, 16)
    try:
        cold = a.generate([HANDOFF_PROMPT], 6)[0]
        frames = a.kv_export(HANDOFF_PROMPT)
        ptrs = _pool_ptrs(b)
        real = b._write_blocks

        def half_then_fail(pools, ids, k, v):
            real(pools, ids[:1], k[:, :1], v[:, :1])
            raise RuntimeError("injected device copy failure")

        b._write_blocks = half_then_fail
        errors = []

        def long_request():
            try:
                b.generate([[7, 8, 9]], 120)
            except RuntimeError as e:
                errors.append(e)

        worker = threading.Thread(target=long_request)
        worker.start()
        deadline = time.monotonic() + 300
        while b.stats()["steps_done"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        with pytest.raises(RuntimeError, match="injected device copy"):
            b.kv_install(frames)
        worker.join(300)
        assert not worker.is_alive()
        assert errors and "cache lost" in str(errors[0])
        kv = b.kv_stats()
        assert kv["cached_blocks"] == 0
        assert kv["free_blocks"] == kv["total_blocks"]
        assert _pool_ptrs(b) == ptrs
        b._write_blocks = real
        hit0 = b.kv_stats()["prefix_hit_tokens"]
        assert b.generate([HANDOFF_PROMPT], 6)[0] == cold
        assert b.kv_stats()["prefix_hit_tokens"] == hit0
    finally:
        a.shutdown()
        b.shutdown()


def test_bert_large_attention_launches_the_kernels_and_matches_plain(gen):
    """BERT-large's unmasked attention (B 8, S 512, 16/16 heads, D 64,
    non-causal, bf16) goes through the forward, dq and dk/dv kernels once
    each, and equals the plain versions within chip_smoke's tolerances."""
    from container_engine_accelerators_tpu_torch.models import bert

    shape = (8, 16, 512, 64)
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = (attention.flash_fwd_launches, attention.flash_dq_launches,
              attention.flash_dkv_launches)
    out = bert._attention(*qkv, None, "flash")
    out.backward(g)
    torch.cuda.synchronize()
    assert (attention.flash_fwd_launches - counts[0],
            attention.flash_dq_launches - counts[1],
            attention.flash_dkv_launches - counts[2]) == (1, 1, 1)
    kw = dict(causal=False, sm_scale=64 ** -0.5)
    ref_out, ref_lse = attention.flash_fwd_reference(q, k, v, **kw)
    tol = chip_smoke.TOL["bfloat16"]
    assert ((out.float() - ref_out.float()).abs()
            - tol["out_atol"] - tol["out_rtol"] * ref_out.float().abs()
            ).max().item() <= 0
    ref = attention.flash_bwd_reference(q, k, v, ref_out, ref_lse, g, **kw)
    for name, got, want in zip(("dq", "dk", "dv"),
                               (t.grad for t in qkv), ref):
        _, rel_l2, worst = chip_smoke.grad_errors(got, want)
        assert rel_l2 <= chip_smoke.BWD_TOL["bfloat16"]["rel_l2"], name
        assert worst <= chip_smoke.BWD_TOL["bfloat16"]["row"], name


def test_bert_step_on_card_matches_cpu(gen):
    """A small f32 BERT: the loss and every gradient through the kernels
    on the card equal the CPU's plain versions on the same weights."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=256, d_model=128, n_layers=2,
                          n_heads=2, d_ff=256, max_seq_len=128,
                          dtype="float32")
    cpu = bert.init_params(cfg, device="cpu", seed=0)
    card = bert.Bert(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    batch = bert.synthetic_mlm_batch(np.random.default_rng(0), 2, cfg)
    losses = []
    for model in (cpu, card):
        loss = bert.loss_fn(model, batch)
        loss.backward()
        losses.append(loss.item())
    assert abs(losses[0] - losses[1]) < 1e-4
    for (name, a), b in zip(cpu.named_parameters(), card.parameters()):
        want = a.grad
        err = (b.grad.cpu() - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-7, name


# -- single-card qualification (collectives/device_bench.py) ------------------

GIB = 1 << 30


def _stream_length(length, dtype):
    """A 1 GiB buffer's elements, or a length off the kernels' blocks."""
    if length == "1GiB":
        return GIB // torch.empty((), dtype=dtype).element_size()
    return 3 * 4096 + 77


def _stream_buffer(gen, n, dtype):
    if dtype == torch.int8:
        return torch.randint(-127, 127, (n,), generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn(n, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("length", ["1GiB", "ragged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_triad_matches_plain_version(gen, dtype, length):
    """The Triton triad, in place as the HBM row runs it, against
    ``triad_reference`` within one ulp of the dtype (both compute in f32
    in one order and round once; the kernel has no fused multiply-add),
    at constants that move every term."""
    from container_engine_accelerators_tpu_torch.ops import stream

    n = _stream_length(length, dtype)
    x, y, z = (_stream_buffer(gen, n, dtype) for _ in range(3))
    want = stream.triad_reference(x, y, z, 0.375, -0.25)
    before = stream.stream_triad_launches
    got = stream.triad(x, y, z, 0.375, -0.25, out=z)
    torch.cuda.synchronize()
    assert stream.stream_triad_launches == before + 1
    assert got.data_ptr() == z.data_ptr()
    assert chip_smoke.ulp_gap(torch, got, want) <= chip_smoke.STREAM_ULPS


@pytest.mark.parametrize("length", ["1GiB", "ragged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_stream_read_matches_plain_version(gen, dtype, length):
    """The Triton read's f32 total against ``stream_read_reference`` plus
    the carry, within chip_smoke's bound for the kernel's longest chain of
    f32 additions (every term is >= 0)."""
    from container_engine_accelerators_tpu_torch.ops import stream

    n = _stream_length(length, dtype)
    x = _stream_buffer(gen, n, dtype)
    want = 3.0 + stream.stream_read_reference(x, 0.125).item()
    acc = torch.full((1,), 3.0, device="cuda")
    before = stream.stream_read_launches
    got = stream.stream_read(x, acc, 0.125).item()
    assert stream.stream_read_launches == before + 1
    assert abs(got - want) <= chip_smoke.read_rtol(torch, n) * want


@pytest.mark.parametrize("length", ["1GiB", "ragged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_stream_copy_matches_plain_version(gen, dtype, length):
    """The Triton copy against ``stream_copy_reference``, at constants that
    move every term: bf16 and f32 within one ulp (both compute in f32 in
    one order and round once; no fused multiply-add), int8 exactly (the
    sum wraps)."""
    from container_engine_accelerators_tpu_torch.ops import stream

    n = _stream_length(length, dtype)
    x, src = (_stream_buffer(gen, n, dtype) for _ in range(2))
    out = torch.empty_like(x)
    kw = {"k": -77} if dtype == torch.int8 else {"c": 0.375, "eps": -0.25}
    want = stream.stream_copy_reference(x, src, **kw)
    before = stream.stream_copy_launches
    got = stream.stream_copy(x, src, out, **kw)
    torch.cuda.synchronize()
    assert stream.stream_copy_launches == before + 1
    assert got.data_ptr() == out.data_ptr()
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        assert chip_smoke.ulp_gap(torch, got, want) <= chip_smoke.STREAM_ULPS


HBM_STEPS = ["rw", "triad", "read_bf16", "read_f32", "read_i8", "copy_bf16",
             "copy_f32", "copy_i8"]


@pytest.mark.parametrize("pattern", HBM_STEPS)
def test_each_hbm_pattern_step_is_one_pass_over_the_buffer(gen, pattern):
    """One iteration of each HBM pattern over 1 GiB, under torch.profiler:
    exactly one kernel runs, and long enough to touch the buffer (at least
    a tenth of the bytes' bound at 3.35 TB/s), so the bytes each row
    credits are the bytes its kernel moves."""
    from torch.profiler import ProfilerActivity, profile

    from container_engine_accelerators_tpu_torch.collectives import (
        device_bench as db,
    )
    from container_engine_accelerators_tpu_torch.ops import stream

    kind, _, dt = pattern.partition("_")
    dtype = {"": torch.bfloat16, "bf16": torch.bfloat16,
             "f32": torch.float32, "i8": torch.int8}[dt]
    n = _stream_length("1GiB", dtype)
    x = _stream_buffer(gen, n, dtype)
    if kind == "rw":
        step, factor = (lambda: db.rw_step(x, 5e-9)), 2
    elif kind == "triad":
        y, z = _stream_buffer(gen, n, dtype), torch.zeros_like(x)
        step, factor = (lambda: stream.triad(x, y, z, 5e-9, 1e-9, out=z)), 4
    elif kind == "read":
        acc = torch.zeros(1, device="cuda")
        step, factor = (lambda: stream.stream_read(x, acc, 5e-9)), 1
    else:
        dst = torch.empty_like(x)
        scales = None if dtype == torch.int8 else \
            db.copy_scales(8, dtype)
        step, factor = (lambda: db.copy_step(x, x, 5, scales, 1e-9, dst)), 2
    step()  # built and set up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [(e.name, e.device_time_total) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    bound_us = factor * GIB / chip_smoke.HBM_BYTES_PER_S * 1e6
    passes = [k for k in kernels if k[1] >= 0.1 * bound_us]
    assert len(passes) == 1, kernels
    assert len(kernels) == 1, kernels


def test_flash_long_context_launches_the_kernels():
    """``bench_flash_long_context`` at S 32768 (one iteration a round)
    goes through the flash forward, dq and dk/dv kernels: a warm and three
    timed rounds of the forward chain, then of the fwd+bwd chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from container_engine_accelerators_tpu_torch.collectives import (
        device_bench as db,
    )

    before = (attention.flash_fwd_launches, attention.flash_dq_launches,
              attention.flash_dkv_launches)
    r = db.bench_flash_long_context(seq=32768, iters=1)
    d = r.detail
    assert (d["flash_fwd_launches"], d["flash_dq_launches"],
            d["flash_dkv_launches"]) == (8, 4, 4)
    assert (attention.flash_fwd_launches - before[0],
            attention.flash_dq_launches - before[1],
            attention.flash_dkv_launches - before[2]) == (8, 4, 4)
    assert r.value > 0 and d["fwd_bwd_ms"] > 0


# -- ring attention's kernel half ---------------------------------------------

@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_steps_in_one_process_match_the_whole_sequence(gen, sp, dtype):
    """Every rank's forward and backward ring in one process (the chip_smoke
    ring phase's way: ``parallel/ring_attention.py``'s ring loops over an
    ``InProcess`` transport) at S 2048, GQA 8/2: sp² launches of each
    kernel and the assembled out, lse, dq, dk, dv against the
    whole-sequence flash kernels, bf16 by ``world_smoke.ring_errors``
    (the ring phase's check), f32 to 1e-4."""
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention as ra,
        world_smoke,
    )

    seq, d = 2048, 128
    q, g = (torch.randn(1, 8, seq, d, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    k, v = (torch.randn(1, 2, seq, d, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    scale = d ** -0.5
    out_w, lse_w = attention.flash_fwd(q, k, v, causal=True, sm_scale=scale)
    grads_w = attention.flash_bwd(q, k, v, out_w, lse_w, g, causal=True,
                                  sm_scale=scale)
    qs, ks, vs, gs = ([t.contiguous() for t in x.split(seq // sp, dim=2)]
                      for x in (q, k, v, g))
    transport = ra.InProcess(sp)
    before = chip_smoke._flash_counts(attention)
    outs, lses = ra.ring_flash_forward(qs, ks, vs, transport, True, scale)
    dqs, dks, dvs = ra.ring_flash_backward(qs, ks, vs, outs, lses, gs,
                                           transport, True, scale)
    torch.cuda.synchronize()
    after = chip_smoke._flash_counts(attention)
    assert tuple(a - b for a, b in zip(after, before)) == (sp * sp,) * 3
    got = {"out": torch.cat(outs, 2), "lse": torch.cat(lses, 2),
           "dq": torch.cat(dqs, 2), "dk": torch.cat(dks, 2),
           "dv": torch.cat(dvs, 2)}
    want = {"out": out_w, "lse": lse_w,
            **dict(zip(("dq", "dk", "dv"), grads_w))}
    if dtype == torch.bfloat16:
        errs, ok = world_smoke.ring_errors(got, want)
        assert ok, errs
        return
    torch.testing.assert_close(got["out"], out_w, atol=1e-4, rtol=0)
    torch.testing.assert_close(got["lse"], lse_w, atol=1e-4, rtol=0)
    for name, want_grad in zip(("dq", "dk", "dv"), grads_w):
        _, rel_l2, row = chip_smoke.grad_errors(got[name], want_grad)
        assert rel_l2 <= 1e-4 and row <= 1e-3, (name, rel_l2, row)


def test_wholly_future_shard_gives_exact_zeros(gen):
    """Trouble spot (a): a K/V shard wholly in the queries' future visits
    no tile, and the kernels' epilogues still write out = 0, lse = -1e30
    and zero dq, dk, dv."""
    q, g = (torch.randn(1, 8, 1024, 128, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, 2, 1024, 128, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, sm_scale=128 ** -0.5, q_base=0, k_base=1024)
    out = torch.full_like(q, 7.0)
    lse = torch.full(q.shape[:3], 3.0, device="cuda")
    o, lse_b = attention.flash_fwd(q, k, v, **kw)
    assert not o.any() and bool((lse_b == -1e30).all())
    dq, dk, dv = attention.flash_bwd(q, k, v, out, lse, g, **kw)
    assert not dq.any() and not dk.any() and not dv.any()


def test_train_cli_distributed_world_of_one_over_nccl(tmp_path, gen):
    """train_cli --distributed in-process: a world of one over NCCL from
    the env contract, its marker, n_devices 1, and the loss of the run
    without --distributed."""
    import json
    import os
    import socket

    from container_engine_accelerators_tpu_torch.models import train_cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    flags = ["--model", "transformer", "--steps", "2"]
    marker = tmp_path / "health.log"
    results = []
    for env in ({}, {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "localhost",
                     "TPU_COORDINATOR_PORT": str(port),
                     "TPU_HEALTH_CHECK_LOG_FILE": str(marker)}):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            import contextlib
            import io

            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert train_cli.main(flags) == 0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        results.append(json.loads(out.getvalue().strip().splitlines()[-1]))
    assert marker.read_text() == "TPU_BOOTSTRAP_OK rank=0 world=1\n"
    assert results[1]["n_devices"] == 1
    assert results[1]["loss"] == results[0]["loss"]
