# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Head widths past 256, and the dk/dv grid that splits the GQA group.

JAX's head width is d_model // n_heads, any value, and its Pallas
kernels block the whole width. Past 256 the port's CUDA kernels cut the
outputs' columns into chunks of 64-column atoms, each block recomputing
the scores over the whole width (``_ext.column_chunks``), up to
``_ext.MAX_HEAD_DIM``; the dk/dv launch spreads a KV head's q heads over
blocks where the card would stand idle, summing their f32 partials in a
fixed order (``_ext.dkv_plan``). Here, on the CPU: the port's plain
versions (the functions the kernels are held to on the card) against
JAX's Pallas kernels in interpret mode at D 264, 288, 300 and 520; the
transformer's serving programs, a training step and the weight bridge at
D 288 (Gemma-2-2B's and Gemma-3-1B's heads on the repo's block); the
plain split dk/dv against the unsplit one; and the binding's width,
chunk and split rules, which the CUDA sources follow.
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

# f32 on both sides, the same algorithm summed in another order: out and
# the gradients (magnitudes up to about 10 here) to 1e-5, lse to 2e-5, as
# tests/test_torch_head_widths.py holds D 80-256.
ATOL = 1e-5
LSE_ATOL = 2e-5

# (B, Hq, Hkv, Sq, Sk, D), causal, extra kwargs (q_base / kv_len). S <= 256.
ATTN_CASES = {
    "d264_causal_mqa": ((1, 4, 1, 256, 256, 264), True, {}),
    "d288_causal_mqa": ((1, 4, 1, 256, 256, 288), True, {}),
    "d300_noncausal_kv_len": ((1, 4, 2, 128, 256, 300), False,
                              {"kv_len": 200}),
    "d520_q_base_segment": ((1, 4, 2, 128, 256, 520), True,
                            {"q_base": 128}),
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


# The dk/dv kernel's split (f32 partials of group / split q heads each,
# summed in split order, rounded once) against the unsplit plain version:
# f32 differs by summation order only (1e-5 at these magnitudes); bf16 by
# at most one bf16 step of the result (2^-7 of its magnitude at most: 8
# significant bits) where the two f32 sums round to neighbouring values.
SPLIT_CASES = {
    "mqa8_split2": ((1, 8, 1, 200, 200, 64), True, {}, 2),
    "mqa8_split8_kv_len": ((1, 8, 1, 130, 190, 32), False, {"kv_len": 150},
                           8),
    "gqa4_split4_q_base": ((2, 8, 2, 64, 192, 288), True, {"q_base": 128},
                           4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_dkv_plain_version_matches_the_unsplit_one(name, dtype):
    shape, causal, kw, split = SPLIT_CASES[name]
    q, k, v, g = (torch.from_numpy(a).to(dtype)
                  for a in _inputs(len(name), *shape))
    kw = dict(kw, causal=causal, sm_scale=shape[-1] ** -0.5)
    out, lse = tattn.flash_fwd(q, k, v, **kw)
    _, dk, dv = tattn.flash_bwd_reference(q, k, v, out, lse, g, **kw)
    got = tattn.flash_bwd_dkv_split_reference(q, k, v, out, lse, g,
                                              split=split, **kw)
    for grad_name, a, b in zip(("dk", "dv"), got, (dk, dv)):
        assert a.dtype == dtype, grad_name
        a, b = a.float(), b.float()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
        else:
            assert ((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-6).all(), \
                grad_name
    kv_len = kw.get("kv_len", shape[4])
    assert not got[0][:, :, kv_len:].any() and not got[1][:, :, kv_len:].any()


def test_split_dkv_plain_version_refuses_a_split_the_group_does_not_hold():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(0, 1, 6, 2, 8, 8, 8))
    out, lse = tattn.flash_fwd(q, k, v, causal=True, sm_scale=0.3)
    with pytest.raises(ValueError, match="split 2"):
        tattn.flash_bwd_dkv_split_reference(q, k, v, out, lse, g,
                                            causal=True, sm_scale=0.3,
                                            split=2)


# Gemma-2-2B (d 2304, 8 heads) and Gemma-3-1B (d 1152, 4 heads) on the
# repo's block give D 288; here d 576 over 2 heads, one KV head, 2 layers.
SHAPE = dict(vocab_size=256, d_model=576, n_layers=2, n_heads=2,
             n_kv_heads=1, d_ff=1152, max_seq_len=64, dtype="float32")
# f32 logits on both sides, summed in other orders.
LOGITS_ATOL = 1e-4
# A training step: the loss to 1e-5 and each gradient to 1e-5 of its
# own largest entry (tests/test_torch_train.py's tolerances).
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port model) on the same weights."""
    cfg_j = jtf.TransformerConfig(**SHAPE)
    cfg_t = ttf.TransformerConfig(**SHAPE)
    assert cfg_t.head_dim == cfg_j.head_dim == 288
    params = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    model = weights.params_from_jax(jax.tree.map(np.asarray, params),
                                    cfg_t, device="cpu")
    return cfg_j, params, model


def _tokens(batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq))


def test_weights_round_trip_at_d288(pair):
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


def test_prefill_decode_and_generate_match_jax_at_d288(pair):
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
    toks = _tokens(2, 13, seed=13)
    ref = np.asarray(jtf.generate(params, jnp.asarray(toks, jnp.int32),
                                  cfg_j, max_new_tokens=6))
    out = ttf.generate(model, torch.as_tensor(toks), max_new_tokens=6,
                       decoder=serving_graphs.DenseDecodeGraphs(model))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_training_step_loss_and_grads_match_jax_at_d288(pair):
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


# -- the binding's rules, which csrc/launch.cuh follows ------------------------


def test_kernel_head_dim_from_1_to_1100():
    """Up to 256 the instantiations' rule; past it the padded width (the
    next multiple of 8) is the kernel width, by column chunks; past
    MAX_HEAD_DIM (1024) a ValueError naming it."""
    for d in range(1, 1101):
        if d > _ext.MAX_HEAD_DIM:
            with pytest.raises(ValueError, match="1024"):
                _ext.kernel_head_dim(d)
            continue
        width, kernel = _ext.kernel_head_dim(d)
        assert width % 8 == 0 and d <= width < d + 8, d
        if width > _ext.FLASH_WIDTHS[-1]:
            assert kernel == width, d
        else:
            assert kernel in _ext.FLASH_WIDTHS and width <= kernel, d
    assert _ext.kernel_head_dim(288) == (288, 288)
    assert _ext.kernel_head_dim(300) == (304, 304)
    assert _ext.kernel_head_dim(1024) == (1024, 1024)


@pytest.mark.parametrize("max_atoms", [_ext.DKV_CHUNK_ATOMS,
                                       _ext.FWD_CHUNK_ATOMS,
                                       _ext.DQ_CHUNK_ATOMS])
def test_column_chunks_cover_every_atom_once(max_atoms):
    """Every padded width up to 1024: the fewest chunks of at most
    ``max_atoms`` 64-column atoms, none empty, all but the last ``per``
    atoms, together every atom once."""
    for width in range(8, _ext.MAX_HEAD_DIM + 1, 8):
        atoms = -(-width // _ext.ATOM_COLS)
        n, per = _ext.column_chunks(width, max_atoms)
        assert n == -(-atoms // max_atoms), width
        sizes = [min(per, atoms - c * per) for c in range(n)]
        assert min(sizes) >= 1 and max(sizes) <= max_atoms, width
        assert sizes[:-1] == [per] * (n - 1) and sum(sizes) == atoms, width
    # D 288: 5 atoms; the forward's one chunk (the scores formed once a
    # key tile), dq's 3 + 2, dk/dv's 2 + 2 + 1.
    assert _ext.column_chunks(288, _ext.FWD_CHUNK_ATOMS) == (1, 5)
    assert _ext.column_chunks(288, _ext.DQ_CHUNK_ATOMS) == (2, 3)
    assert _ext.column_chunks(288, _ext.DKV_CHUNK_ATOMS) == (3, 2)


# Padded width -> (q resident, chunks, atoms a chunk) of the wide forward.
WIDE_FWD_PLANS = {264: (True, 1, 5), 288: (True, 1, 5), 320: (True, 1, 5),
                  384: (True, 2, 3), 512: (True, 2, 4), 640: (True, 2, 5),
                  648: (False, 3, 4), 1024: (False, 4, 4)}


@pytest.mark.parametrize("width", sorted(WIDE_FWD_PLANS))
def test_wide_forward_plan_keeps_q_resident(width):
    """The wide forward keeps its 128-row q tile in shared memory up to D
    640 (10 atoms, 160 KB beside a 40 KB V stage of 5 atoms and at least
    two 8 KB K slots); up to D 320 one chunk holds the whole O. Past 640
    the streaming kernel cuts O into chunks of 4 atoms."""
    resident, n, per = _ext.wide_fwd_plan(width)
    assert (resident, n, per) == WIDE_FWD_PLANS[width]
    atoms = -(-width // _ext.ATOM_COLS)
    q_tile = 128 * atoms * 128
    v_stage, two_slots = 5 * 8192 + 16, 2 * (8192 + 16)
    assert resident == (q_tile + 8 + 1024 + v_stage + two_slots <= 231424)


# (B, Hq, Hkv, Sk, width) -> the plan on a 132-SM card.
PLANS = {
    # Llama-3-8B at S 8192: 8 x 64 = 512 blocks, no split.
    "llama_s8192": ((1, 32, 8, 8192, 128), (1, 1, 2)),
    # At S 2048: 8 x 16 = 128 blocks, under 132: split 2.
    "llama_s2048": ((1, 32, 8, 2048, 128), (2, 1, 2)),
    # Its tp-4 rank: 2 x 32 = 64 blocks, the group of 4 split 4.
    "tp_rank": ((1, 8, 2, 4096, 128), (4, 1, 2)),
    # Gemma-2B: 1 x 32 = 32 blocks, the group of 8 split 8.
    "gemma2b_d256": ((1, 8, 1, 4096, 256), (8, 1, 4)),
    # Gemma-2-2B's D 288: 4 x 32 x 3 chunks = 384, no split.
    "gemma2_2b_d288": ((1, 8, 4, 4096, 288), (1, 3, 2)),
    # Gemma-3-1B's: 1 x 32 x 3 = 96, split 2.
    "gemma3_1b_d288": ((1, 4, 1, 4096, 288), (2, 3, 2)),
    # No divisor of a group of 3 reaches 132 from 2 x 1: the whole group.
    "group3_short": ((1, 6, 2, 100, 64), (3, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_dkv_plan_at_the_paths_shapes(name):
    args, want = PLANS[name]
    assert _ext.dkv_plan(*args, 132) == want


def test_dkv_plan_splits_only_below_the_sm_count():
    """Every small shape: the split divides the group; it is 1 where the
    blocks fill the card, else the smallest divisor that does (or the
    whole group); the scratch is 2 · split · B · Hkv · Sk · width floats
    with a split and none without."""
    for batch in (1, 2, 3):
        for hkv in (1, 2, 4):
            for group in (1, 2, 3, 4, 8):
                for seq_k in (1, 128, 1000, 4096):
                    for width in (64, 128, 256, 288, 1024):
                        for n_sm in (16, 132):
                            hq = hkv * group
                            split, n, _ = _ext.dkv_plan(batch, hq, hkv,
                                                        seq_k, width, n_sm)
                            blocks = batch * hkv * -(-seq_k // 128) * n
                            assert group % split == 0
                            if blocks >= n_sm:
                                assert split == 1
                            else:
                                held = [g for g in range(1, group + 1)
                                        if group % g == 0 and
                                        blocks * g >= n_sm]
                                assert split == (held[0] if held else group)
                            floats = _ext.dkv_partial_floats(
                                batch, hq, hkv, seq_k, width, n_sm)
                            assert floats == (0 if split == 1 else 2 * split
                                              * batch * hkv * seq_k * width)
