# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Head widths between the flash kernels' instantiations, and D 256.

JAX's head width is d_model // n_heads, any value, and its Pallas
kernels block the whole width. The port's CUDA kernels are built for D
32, 64, 128 and 256; a width in between runs the next one up, the
columns past it zero (a width that is not a multiple of 8 on copies the
binding pads), and D 256 has layouts of its own. Here, on the CPU: the
port's plain versions (the functions the kernels are held to on the
card) against JAX's Pallas kernels in interpret mode at D 80, 96, 100
and 256; the transformer's serving programs, a training step and the
weight bridge at widths that give those heads; and the binding's width
and grid rules, which the CUDA sources follow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.ops import attention as jattn  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serving_graphs,
    weights,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.ops import _ext  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention as tattn,
)

# f32 on both sides, the same algorithm summed in another order (the
# port's GQA group inside one product, JAX's after its kernels): out and
# the gradients (magnitudes up to about 10 here) to 1e-5, lse to 2e-5.
ATOL = 1e-5
LSE_ATOL = 2e-5

# (B, Hq, Hkv, Sq, Sk, D), causal, extra kwargs (q_base / kv_len).
ATTN_CASES = {
    "d80_causal_gqa": ((1, 4, 2, 256, 256, 80), True, {}),
    "d80_kv_len_q_base": ((1, 4, 2, 128, 256, 80), True,
                          {"q_base": 128, "kv_len": 190}),
    "d96_noncausal_kv_len": ((1, 4, 2, 128, 256, 96), False,
                             {"kv_len": 200}),
    "d96_q_base_segment": ((1, 4, 4, 128, 384, 96), True, {"q_base": 256}),
    "d100_causal_gqa": ((1, 4, 2, 256, 256, 100), True, {}),
    "d100_noncausal": ((2, 4, 1, 128, 128, 100), False, {}),
    "d256_causal_mqa": ((1, 4, 1, 256, 256, 256), True, {}),
    "d256_noncausal_kv_len": ((2, 4, 2, 128, 256, 256), False,
                              {"kv_len": 200}),
}


def _inputs(seed, batch, hq, hkv, seq_q, seq_k, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((batch, hq, seq_q, d), (batch, hkv, seq_k, d),
                          (batch, hkv, seq_k, d), (batch, hq, seq_q, d))]


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_forward_and_gradients_match_jax_pallas(name):
    shape, causal, kw = ATTN_CASES[name]
    q, k, v, g = _inputs(len(name), *shape)
    sm_scale = shape[-1] ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    blocks = dict(block_q=128, block_k=128, interpret=True)
    j_out, j_lse = jattn._flash_fwd(jq, jk, jv, causal=causal,
                                    sm_scale=sm_scale, **blocks, **kw)
    j_grads = jattn._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal=causal,
                               sm_scale=sm_scale, **blocks, **kw)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = tattn.flash_fwd(tq, tk, tv, causal=causal, sm_scale=sm_scale,
                               **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse),
                               atol=LSE_ATOL, rtol=0)
    grads = tattn.flash_bwd(tq, tk, tv, out, lse, tg, causal=causal,
                            sm_scale=sm_scale, **kw)
    kv_len = kw.get("kv_len", shape[4])
    for grad_name, got, want in zip(("dq", "dk", "dv"), grads, j_grads):
        got, want = got.numpy(), np.asarray(want, np.float32)
        if grad_name != "dq":
            # Keys past kv_len: the true gradient 0 here; the JAX kernel
            # leaves values its caller slices away.
            assert not got[:, :, kv_len:].any(), grad_name
            got, want = got[:, :, :kv_len], want[:, :, :kv_len]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=grad_name)


@pytest.mark.parametrize("d", [80, 96, 100, 256])
def test_flash_attention_autograd_matches_the_oracle(d):
    """``flash_attention`` (the autograd Function the models train
    through) against autograd of ``mha_reference``, f32, GQA, causal."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(d, 1, 4, 2, 70, 70,
                                                        d))
    grads = []
    for fn in (tattn.flash_attention, tattn.mha_reference):
        qkv = [a.clone().requires_grad_() for a in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*qkv, causal=True), qkv, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


# d_model / n_heads = 80, 96, 256 (StableLM-3B's, Phi-3-mini's and
# Gemma-2B's head widths) at a tiny depth, one KV head.
WIDTHS = {80: 160, 96: 192, 256: 512}
# f32 logits on both sides, summed in other orders.
LOGITS_ATOL = 1e-4
# A training step: the loss to 1e-5 and each gradient to 1e-5 of its
# own largest entry (tests/test_torch_train.py's tolerances).
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5


def _shape(d):
    return dict(vocab_size=256, d_model=WIDTHS[d], n_layers=2, n_heads=2,
                n_kv_heads=1, d_ff=2 * WIDTHS[d], max_seq_len=64,
                dtype="float32")


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def pair(request):
    """(jax cfg, jax params, port model) on the same weights."""
    cfg_j = jtf.TransformerConfig(**_shape(request.param))
    cfg_t = ttf.TransformerConfig(**_shape(request.param))
    assert cfg_t.head_dim == cfg_j.head_dim == request.param
    params = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    model = weights.params_from_jax(jax.tree.map(np.asarray, params),
                                    cfg_t, device="cpu")
    return cfg_j, params, model


def _tokens(batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq))


def test_weights_round_trip_at_the_head_width(pair):
    """``params_from_jax`` then ``params_to_jax`` gives JAX's tree back,
    every leaf bit for bit."""
    _, params, model = pair
    back = weights.params_to_jax(model)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))
    for path, leaf in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf)


def test_prefill_and_decode_logits_match_jax(pair):
    cfg_j, params, model = pair
    toks = _tokens(2, 11, seed=2)
    padded = np.pad(toks, ((0, 0), (0, 5)))
    ref_logits, ref_cache = jtf.prefill(
        params, jnp.asarray(padded), cfg_j, true_len=jnp.int32(11),
        return_logits=True)
    logits, cache = ttf.prefill(model, torch.as_tensor(padded), true_len=11,
                                return_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGITS_ATOL, rtol=0)
    nxt = np.argmax(np.asarray(ref_logits), axis=-1)
    ref_step, _ = jtf.decode_logits(params, ref_cache, jnp.asarray(nxt), 11,
                                    cfg_j)
    step = ttf.decode_logits(model, cache, torch.as_tensor(nxt), 11)
    np.testing.assert_allclose(step.numpy(), np.asarray(ref_step),
                               atol=LOGITS_ATOL, rtol=0)


def test_greedy_generate_matches_jax(pair):
    cfg_j, params, model = pair
    toks = _tokens(2, 13, seed=13)
    ref = np.asarray(jtf.generate(params, jnp.asarray(toks, jnp.int32),
                                  cfg_j, max_new_tokens=8))
    out = ttf.generate(model, torch.as_tensor(toks), max_new_tokens=8,
                       decoder=serving_graphs.DenseDecodeGraphs(model))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_training_step_loss_and_grads_match_jax(pair):
    """JAX with its Pallas kernels (interpret mode) against the port's
    flash path, one step's loss and every gradient."""
    cfg_j, params, model = pair
    toks = _tokens(2, 33, seed=5)
    loss_j, grads_j = jax.value_and_grad(jtf.loss_fn)(
        params, {"tokens": jnp.asarray(toks)}, cfg_j, attn_impl="flash")
    model.zero_grad(set_to_none=True)
    loss = ttf.loss_fn(model, {"tokens": toks})
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    got = weights.grads_to_jax(model)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads_j)
    for path, want in flat:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(np.asarray(leaf, np.float32), want,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   rtol=0, err_msg=jax.tree_util.keystr(path))
    model.zero_grad(set_to_none=True)


def test_kernel_head_dim_on_every_width_it_takes():
    """Every head dim from 1 to 256: the padded width is the next
    multiple of 8 (TMA's 16-byte row stride), the kernel width the next
    instantiation that holds it, and a width already a multiple of 8 is
    not copied. (Past 256: tests/test_torch_wide_heads.py.)"""
    for d in range(1, _ext.FLASH_WIDTHS[-1] + 1):
        width, kernel = _ext.kernel_head_dim(d)
        assert width % 8 == 0 and d <= width < d + 8, d
        assert kernel in _ext.FLASH_WIDTHS and width <= kernel, d
        assert kernel == _ext.FLASH_WIDTHS[0] or kernel // 2 < width, d
        assert (width == d) == (d % 8 == 0), d
    assert _ext.kernel_head_dim(80) == (80, 128)
    assert _ext.kernel_head_dim(96) == (96, 128)
    assert _ext.kernel_head_dim(100) == (104, 128)
    assert _ext.kernel_head_dim(136) == (136, 256)
    assert _ext.kernel_head_dim(256) == (256, 256)


@pytest.mark.parametrize("d", [-8, -1, 0, 257, 264, 512])
def test_kernel_head_dim_refuses_past_256(d):
    """Widths below 1 are refused. Past 256, which the kernels refused
    until they took wider heads by column chunks, a width is planned: its
    padded width, run by the wide kernels at that width."""
    if d < 1:
        with pytest.raises(ValueError, match=f"head dim {d} "):
            _ext.kernel_head_dim(d)
        return
    width = -(-d // 8) * 8
    assert _ext.kernel_head_dim(d) == (width, width)
    assert _ext.column_chunks(width, _ext.FWD_CHUNK_ATOMS)[0] == \
        -(-width // (_ext.ATOM_COLS * _ext.FWD_CHUNK_ATOMS))


def test_padded_copy_is_zero_past_the_width():
    t = torch.randn(2, 3, 5, 100)
    p = _ext._padded(t, 104)
    assert p.shape == (2, 3, 5, 104) and p.is_contiguous()
    assert torch.equal(p[..., :100], t) and not p[..., 100:].any()
    assert _ext._padded(t, 100) is t


@pytest.mark.parametrize("n", [1, 65535, 65536, 65792, 98303, 131069,
                               131070, 131071])
def test_fold_rows_covers_every_row_once(n):
    """B * Hq rows over grid.y and grid.z (each at most 65535), as
    csrc/launch.cuh folds them: block (y, z) holds row z * Y + y, rows
    at or past n idle. n up to 65535 keeps today's grid (n, 1)."""
    y, z = _ext.fold_rows(n)
    assert 1 <= y <= _ext.GRID_YZ_LIMIT and 1 <= z <= _ext.GRID_YZ_LIMIT
    assert y * z >= n and y * z - n < z
    if n <= _ext.GRID_YZ_LIMIT:
        assert (y, z) == (n, 1)
    rows = np.arange(z)[:, None] * y + np.arange(y)[None, :]
    held = rows[rows < n]
    assert held.size == n and np.array_equal(np.sort(held), np.arange(n))


def test_fold_rows_from_one_grid_to_two_slices():
    """Every n from 65535 to 2 * 65535 folds into at most two slices."""
    for n in range(_ext.GRID_YZ_LIMIT, 2 * _ext.GRID_YZ_LIMIT + 1, 97):
        y, z = _ext.fold_rows(n)
        assert z == (1 if n <= _ext.GRID_YZ_LIMIT else 2), n
        assert y <= _ext.GRID_YZ_LIMIT and y * z - n < z, n
