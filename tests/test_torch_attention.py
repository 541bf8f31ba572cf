# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port attention (PyTorch, CPU path) vs the JAX package.

The JAX side runs its Pallas flash kernel in interpret mode, as its own
tests do on the CPU; the port's CPU path is the kernel's plain version
(flash_fwd_reference), the same function the CUDA kernel is held
against on the card. Inputs are seeded numpy arrays handed to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.ops import attention as jattn  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import _ext  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention as tattn,
)

# f32 on both sides: the same algorithm, summed in another order.
ATOL = 2e-5


def _qkv(seed, batch, hq, hkv, seq_q, seq_k, d):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((batch, hq, seq_q, d), (batch, hkv, seq_k, d),
                      (batch, hkv, seq_k, d))
    ]


def _jax_fwd(q, k, v, causal, sm_scale, **kw):
    out, lse = jattn._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=sm_scale, block_q=128, block_k=128, interpret=True, **kw,
    )
    return np.asarray(out, np.float32), np.asarray(lse)


def _port_fwd(q, k, v, causal, sm_scale, **kw):
    out, lse = tattn.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=sm_scale, **kw,
    )
    return out.float().numpy(), lse.numpy()


# (B, Hq, Hkv, Sq, Sk, D), causal, extra kwargs (q_base/k_base/kv_len).
FWD_CASES = {
    "causal": ((2, 4, 2, 128, 128, 32), True, {}),
    "noncausal": ((2, 4, 2, 128, 128, 32), False, {}),
    "gqa_group4": ((1, 8, 2, 256, 256, 32), True, {}),
    "mqa": ((1, 4, 1, 128, 128, 64), True, {}),
    # Chunked/paged prefill shape: a segment at a global offset attends
    # the window [0, W) of the cache, seq_k > seq_q.
    "q_base_segment": ((1, 4, 2, 128, 384, 32), True, {"q_base": 256}),
    "q_base_mid_tile": ((1, 4, 2, 128, 384, 32), True, {"q_base": 200}),
    "kv_len_noncausal": ((1, 4, 2, 128, 256, 32), False, {"kv_len": 200}),
    # Rows past the last real key (seq_q > kv_len) must see the tail
    # masked, not the zero keys behind it.
    "kv_len_causal_rows_past_keys": (
        (1, 4, 2, 256, 256, 32), True, {"kv_len": 100}),
    "kv_len_q_base": ((1, 4, 2, 128, 256, 32), True,
                      {"q_base": 128, "kv_len": 190}),
    # Every key in every row's future: the loop is empty (ring attention's
    # future shard): out = 0, lse = -1e30, never NaN.
    "future_keys_empty_loop": ((1, 4, 2, 128, 128, 32), True,
                               {"k_base": 128}),
}


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_flash_fwd_matches_jax_pallas_kernel(name):
    shape, causal, kw = FWD_CASES[name]
    q, k, v = _qkv(len(name), *shape)
    sm_scale = shape[-1] ** -0.5
    out_j, lse_j = _jax_fwd(q, k, v, causal, sm_scale, **kw)
    out_t, lse_t = _port_fwd(q, k, v, causal, sm_scale, **kw)
    assert np.isfinite(out_t).all() and np.isfinite(lse_t).all()
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL, rtol=0)


def test_rows_without_keys_in_a_visited_tile():
    """k_base = 64: rows 0..63 see no key, but the JAX kernel still
    visits the tile for rows 64..127 and, with the finite -1e30, averages
    v over it for the blind rows (exp(0) = 1). The port gives those rows
    out = 0; lse agrees (-1e30) and every row that sees a key agrees."""
    q, k, v = _qkv(3, 1, 4, 2, 128, 128, 32)
    out_j, lse_j = _jax_fwd(q, k, v, True, 0.2, k_base=64)
    out_t, lse_t = _port_fwd(q, k, v, True, 0.2, k_base=64)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL, rtol=0)
    assert (lse_t[:, :, :64] == np.float32(tattn.NEG_INF)).all()
    np.testing.assert_allclose(out_t[:, :, 64:], out_j[:, :, 64:],
                               atol=ATOL, rtol=0)
    assert (out_t[:, :, :64] == 0).all()
    assert np.abs(out_j[:, :, :64]).max() > 0


def test_flash_fwd_bf16_matches_jax_pallas_kernel():
    """bf16 in, p rounded to bf16 before PV on both sides; they round p
    at different running maxima (JAX per 128-key tile, the plain version
    per row), so an output may differ by about one bf16 step (2^-8
    relative) of its magnitude."""
    q, k, v = _qkv(5, 1, 4, 2, 256, 256, 64)
    out_j, lse_j = jattn._flash_fwd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        sm_scale=0.125, block_q=128, block_k=128, interpret=True,
    )
    out_t, lse_t = tattn.flash_fwd(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=True,
        sm_scale=0.125,
    )
    assert out_t.dtype == torch.bfloat16
    out_j = np.asarray(out_j, np.float32)
    np.testing.assert_allclose(out_t.float().numpy(), out_j, atol=1e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4,
                               rtol=0)


# Unaligned lengths, as tests/test_ops.py replays through the JAX
# wrapper: (B, Hq, Hkv, Sq, Sk, D), causal.
UNALIGNED = {
    "causal_100": ((2, 4, 2, 100, 100, 64), True),
    "causal_200": ((1, 2, 2, 200, 200, 32), True),
    "noncausal_200_tail_mask": ((1, 2, 2, 200, 200, 32), False),
    "longer_q_than_k_tail_mask": ((1, 2, 2, 300, 200, 32), True),
    "gqa_causal_q_shorter_than_k": ((1, 4, 1, 77, 150, 32), True),
}


@pytest.mark.parametrize("name", sorted(UNALIGNED))
def test_flash_attention_unaligned_matches_jax(name):
    shape, causal = UNALIGNED[name]
    q, k, v = _qkv(len(name) + 100, *shape)
    ref = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128,
    )
    out = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
    )
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(7, 2, 4, 2, 48, 48, 16)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal)
    out = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("length", [9, "per_row"])
def test_decode_attention_matches_jax(length):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 8, 1, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 2, 32, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 2, 32, 16)).astype(np.float32)
    lengths = np.array([1, 17, 32]) if length == "per_row" else length
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lengths))
    out = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc),
                                 torch.as_tensor(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_cpu_path_does_not_count_kernel_launches():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 2, 1, 16, 16, 64))
    before = tattn.flash_fwd_launches
    tattn.flash_attention(q, k, v)
    assert tattn.flash_fwd_launches == before


def test_flash_fwd_rejects_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 3, 2, 16, 16, 64))
    with pytest.raises(ValueError, match="multiple"):
        tattn.flash_fwd(q, k, v, causal=True, sm_scale=0.1)
    with pytest.raises(ValueError, match="expected"):
        tattn.flash_fwd(q, k[:, :, :8], v, causal=True, sm_scale=0.1)


def test_kernel_binding_rejects_cpu_tensors_before_building():
    """The binding checks device/dtype/shape before it builds or
    launches anything, so bad input raises instead of faulting."""
    q = torch.zeros(1, 2, 16, 64)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="cuda"):
        _ext.flash_fwd(q, q, q, q, lse, causal=True, sm_scale=1.0,
                       q_base=0, k_base=0, kv_len=16)
