# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's CUDA kernel on the card (skipped without a GPU).

Imports no JAX (the machine with the card has none), so run it there
without the repo's JAX-configuring conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

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
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(gen, name, dtype):
    (b, hq, hkv, sq, sk, d), causal, kw = CASES[name]
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
