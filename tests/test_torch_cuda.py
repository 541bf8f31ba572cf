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
    transformer as tf,
)
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention,
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
    out = tf.generate(gpu, prompt.cuda(), max_new_tokens=6).cpu()
    assert attention.flash_fwd_launches == before + cfg.n_layers
    assert torch.equal(out, tf.generate(cpu, prompt, max_new_tokens=6))


def test_paged_engine_on_card_matches_dense_generate(gen):
    """The paged engine on a small f32 model (head dim 128: the f32 kernel
    under every prefill segment) returns dense generate's tokens exactly,
    through a radix hit and a prompt prefilled in three segments."""
    from container_engine_accelerators_tpu_torch.models import serve_cli

    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    model = serve_cli.Model(cfg, seed=4, device="cuda")
    engine = serve_cli.ContinuousEngine(model, max_slots=2, chunk=4,
                                        prefill_chunk=32, kv_block_size=16)
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
    for (prompt, max_new), got in zip(cases, outs):
        want = tf.generate(model.model,
                           torch.as_tensor([prompt], device="cuda"),
                           max_new_tokens=max_new)
        assert got == want[0].tolist()


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
