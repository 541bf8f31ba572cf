# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port flash backward (PyTorch, CPU path) vs the JAX package's.

The JAX side runs ``_flash_bwd`` with its Pallas kernels in interpret
mode, staged or (with ``STREAM_THRESHOLD`` lowered, as tests/test_ops.py
does) streaming; the port's CPU path is the kernels' plain version
(``flash_bwd_reference``), the function the CUDA kernels are held
against on the card. Both get the same seeded numpy inputs and the JAX
forward's out and lse.
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

# f32: the same algorithm summed in another order (the port sums the GQA
# group inside one product, the JAX caller after its kernels), on
# gradients of magnitude up to ~7 here (observed error <= 2.4e-6).
F32_ATOL = 1e-5
# bf16, outputs rounded once on both sides (dq always; dk/dv on the
# streaming branch, whose per-q-head outputs are f32): the same bf16
# rounding points on the same f32 values up to summation order agree to
# well under one bf16 step (observed <= 4.9e-4 at |dq| ~2); a missed
# rounding point (ds not cast) shows as a full step (7.8e-3).
BF16_ONCE_ATOL = 2e-3
# bf16 dk/dv on the staged branch: that JAX kernel rounds them once per q
# head and again after the group sum, the port once after it; a few bf16
# steps of the magnitude (observed 3.1e-2 at |dv| 6.3).
BF16_ATOL, BF16_RTOL = 5e-2, 2e-2


def _inputs(seed, batch, hq, hkv, seq_q, seq_k, d):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((batch, hq, seq_q, d), (batch, hkv, seq_k, d),
                      (batch, hkv, seq_k, d), (batch, hq, seq_q, d))
    ]


def _jax(q, k, v, g, dtype, causal, sm_scale, **kw):
    """JAX forward then backward → (out, lse, dq, dk, dv) as numpy f32."""
    jq, jk, jv, jg = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    blocks = dict(block_q=128, block_k=128, interpret=True)
    out, lse = jattn._flash_fwd(jq, jk, jv, causal=causal,
                                sm_scale=sm_scale, **blocks, **kw)
    grads = jattn._flash_bwd(jq, jk, jv, out, lse, jg, causal=causal,
                             sm_scale=sm_scale, **blocks, **kw)
    return [np.asarray(a, np.float32) for a in (out, lse, *grads)]


def _port(q, k, v, out, lse, g, dtype, causal, sm_scale, **kw):
    def t(a):
        return torch.from_numpy(np.array(a)).to(dtype)

    lse = torch.from_numpy(np.array(lse))
    grads = tattn.flash_bwd(t(q), t(k), t(v), t(out), lse, t(g),
                            causal=causal, sm_scale=sm_scale, **kw)
    for grad in grads:
        assert grad.dtype == dtype
    return [grad.float().numpy() for grad in grads]


# (B, Hq, Hkv, Sq, Sk, D), causal, extra kwargs (q_base/kv_len), dtype,
# streaming (STREAM_THRESHOLD lowered to 128: the dq kernel streams K/V
# past Sk 128, the dk/dv kernel q/dO past Sq 128, the forward K/V).
CASES = {
    "causal_gqa": ((1, 4, 2, 256, 256, 64), True, {}, "float32", False),
    "noncausal": ((2, 4, 2, 128, 128, 64), False, {}, "float32", False),
    "mqa_causal": ((1, 4, 1, 256, 256, 64), True, {}, "float32", False),
    "q_base_segment": ((1, 4, 2, 128, 384, 64), True, {"q_base": 256},
                       "float32", False),
    "kv_len_noncausal": ((1, 4, 2, 128, 256, 64), False, {"kv_len": 200},
                         "float32", False),
    "bf16_causal_gqa": ((1, 4, 2, 256, 256, 64), True, {}, "bfloat16",
                        False),
    "bf16_mqa_noncausal": ((1, 4, 1, 128, 256, 64), False, {}, "bfloat16",
                           False),
    "stream_causal_gqa": ((1, 4, 2, 256, 256, 64), True, {}, "float32",
                          True),
    # Causal with Sk > Sq and q_base 0: the clamped streaming index maps.
    "stream_causal_sk_gt_sq": ((1, 4, 2, 256, 384, 64), True, {}, "float32",
                               True),
    "stream_q_base_mqa": ((1, 4, 1, 256, 384, 64), True, {"q_base": 128},
                          "float32", True),
    "stream_noncausal_kv_len": ((1, 4, 2, 256, 384, 64), False,
                                {"kv_len": 300}, "float32", True),
    "stream_bf16_causal": ((1, 4, 2, 256, 256, 64), True, {}, "bfloat16",
                           True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_bwd_matches_jax_pallas_kernels(name, monkeypatch):
    shape, causal, kw, dtype, stream = CASES[name]
    if stream:
        monkeypatch.setattr(jattn, "STREAM_THRESHOLD", 128)
    q, k, v, g = _inputs(len(name), *shape)
    sm_scale = shape[-1] ** -0.5
    out, lse, *ref = _jax(q, k, v, g, getattr(jnp, dtype), causal, sm_scale,
                          **kw)
    got = _port(q, k, v, out, lse, g, getattr(torch, dtype), causal,
                sm_scale, **kw)
    kv_len = kw.get("kv_len", shape[4])
    for name_, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert np.isfinite(a).all(), name_
        if name_ != "dq":
            # Key rows past kv_len: the true gradient 0 here; the JAX
            # kernel leaves values its caller slices away.
            assert (a[:, :, kv_len:] == 0).all(), name_
            a, b = a[:, :, :kv_len], b[:, :, :kv_len]
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0,
                                       err_msg=name_)
        elif name_ == "dq" or stream:
            np.testing.assert_allclose(a, b, atol=BF16_ONCE_ATOL, rtol=0,
                                       err_msg=name_)
        else:
            np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=BF16_RTOL,
                                       err_msg=name_)
    if stream:
        # The streaming forward (JAX _attn_stream_kernel) vs the port's.
        t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
        out_t, lse_t = tattn.flash_fwd(*t, causal=causal, sm_scale=sm_scale,
                                       **kw)
        # bf16: both round p, at different running maxima (JAX per
        # 128-key tile, the plain version per row): one bf16 step.
        tol = 2e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(out_t.float().numpy(), out, atol=tol,
                                   rtol=0 if dtype == "float32" else tol)
        np.testing.assert_allclose(lse_t.numpy(), lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_autograd_of_the_oracle(causal):
    """FlashAttention's backward (flash_bwd) vs torch.autograd through
    mha_reference, f32, GQA, an unaligned length."""
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs(9, 2, 4, 2, 70, 70, 32))
    grads = []
    for fn in (tattn.flash_attention, tattn.mha_reference):
        qkv = [a.clone().requires_grad_() for a in (q, k, v)]
        out = fn(*qkv, causal=causal)
        grads.append(torch.autograd.grad(out, qkv, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_rows_without_visible_keys_get_zero_gradients():
    """k_base = 64: query rows 0..63 see no key (lse = -1e30, out = 0).
    Their dq is 0 and they add nothing to dk/dv; rows that see keys match
    the JAX kernel's dq (which depends only on the row's own statistics)."""
    q, k, v, g = _inputs(4, 1, 4, 2, 128, 128, 32)
    out, lse, dq_j, _, _ = _jax(q, k, v, g, jnp.float32, True, 0.2,
                                k_base=64)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out_t, lse_t = tattn.flash_fwd(tq, tk, tv, causal=True, sm_scale=0.2,
                                   k_base=64)
    dq, dk, dv = tattn.flash_bwd(tq, tk, tv, out_t, lse_t, tg, causal=True,
                                 sm_scale=0.2, k_base=64)
    assert (dq[:, :, :64] == 0).all()
    np.testing.assert_allclose(dq[:, :, 64:].numpy(), dq_j[:, :, 64:],
                               atol=F32_ATOL, rtol=0)
    g_seen = tg.clone()
    g_seen[:, :, :64] = 0
    _, dk_seen, dv_seen = tattn.flash_bwd(tq, tk, tv, out_t, lse_t, g_seen,
                                          causal=True, sm_scale=0.2,
                                          k_base=64)
    assert torch.equal(dk, dk_seen) and torch.equal(dv, dv_seen)


def test_cpu_path_counts_no_kernel_launches():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 1, 16, 16, 64))
    q.requires_grad_()
    before = (tattn.flash_fwd_launches, tattn.flash_dq_launches,
              tattn.flash_dkv_launches)
    tattn.flash_attention(q, k, v).backward(g)
    assert q.grad is not None
    assert (tattn.flash_fwd_launches, tattn.flash_dq_launches,
            tattn.flash_dkv_launches) == before


def test_backward_binding_rejects_cpu_tensors_before_building():
    q = torch.zeros(1, 2, 16, 64)
    row = torch.zeros(1, 2, 16)
    kw = dict(causal=True, sm_scale=1.0, q_base=0, k_base=0, kv_len=16)
    with pytest.raises(ValueError, match="cuda"):
        _ext.flash_bwd_dq(q, q, q, q, row, row, q, **kw)
    with pytest.raises(ValueError, match="cuda"):
        _ext.flash_bwd_dkv(q, q, q, q, row, row, q, q, **kw)


@pytest.mark.parametrize("only", ["dq", "dkv"])
def test_reference_forms_one_kernels_outputs_alone(only):
    """``only`` (each kernel's plain counterpart, timed on the card) gives
    exactly that kernel's outputs of the whole plain backward."""
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(6, 1, 4, 2, 96, 96, 64))
    kw = dict(causal=True, sm_scale=0.125, kv_len=80)
    out, lse = tattn.flash_fwd(q, k, v, **kw)
    whole = tattn.flash_bwd_reference(q, k, v, out, lse, g, **kw)
    part = tattn.flash_bwd_reference(q, k, v, out, lse, g, only=only, **kw)
    kept = (0,) if only == "dq" else (1, 2)
    for i, (a, b) in enumerate(zip(part, whole)):
        if i in kept:
            assert torch.equal(a, b)
        else:
            assert a is None
