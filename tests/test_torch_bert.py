# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port BERT (PyTorch, CPU) vs the JAX package's on the same weights and
batches: hidden states, MLM logits, loss and every gradient, with and
without a pad mask, and AdamW steps against JAX ``make_train_step``.

Tiny f32 config (vocab 128, d_model 64, 2 layers, 4 heads, S 32); JAX's
``init_params(PRNGKey(0))`` is bridged with ``weights.load_jax_tree`` and
gradients come back with ``weights.jax_tree(model, "grads")``. Without a
pad mask the port's attention is the flash kernels' plain versions
(non-causal); JAX runs its plain f32 path on the CPU, or, with its
``on_tpu`` branch forced, its Pallas flash kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import bert as jbert  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    bert as tbert,
    weights,
)

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=256,
             max_seq_len=32, dtype="float32")
BATCH = 2
# f32 on both sides, summed in other orders: hidden states and logits
# to 1e-4 absolute (post-LN states are unit-scale), the loss (~5) to 1e-5,
# each gradient to 1e-5 of its own largest entry.
STATE_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
LR = 1e-4
# After AdamW steps a parameter moves by about lr per step; entries whose
# gradient sits near eps or flips sign under summation-order noise may
# move differently: compare to 2 * lr.
PARAM_ATOL = 2 * LR


@pytest.fixture(scope="module")
def jax_params():
    return jbert.init_params(jax.random.PRNGKey(0),
                             jbert.BertConfig(**SHAPE))


def _port_model(params):
    model = tbert.Bert(tbert.BertConfig(**SHAPE), "cpu")
    return weights.load_jax_tree(model, jax.tree.map(np.asarray, params))


def _batch(seed, pad=False):
    batch = tbert.synthetic_mlm_batch(np.random.default_rng(seed), BATCH,
                                      tbert.BertConfig(**SHAPE))
    batch = {k: v.numpy() for k, v in batch.items()}
    if pad:
        # The second row's last 9 positions are padding.
        mask = np.ones((BATCH, SHAPE["max_seq_len"]), bool)
        mask[1, -9:] = False
        batch["pad_mask"] = mask
        batch["segment_ids"] = (np.arange(SHAPE["max_seq_len"])[None]
                                >= 20).repeat(BATCH, 0).astype(np.int64)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(path), np.asarray(leaf, np.float32))
            for path, leaf in flat]


def _assert_trees_close(got, ref, rel=None, atol=None):
    got = dict(_leaves(got))
    ref = _leaves(ref)
    assert sorted(got) == sorted(p for p, _ in ref)
    for path, want in ref:
        tol = atol if rel is None else rel * np.abs(want).max()
        np.testing.assert_allclose(got[path], want, atol=tol, rtol=0,
                                   err_msg=path)


def _force_jax_flash(monkeypatch):
    """JAX's flash branch (its TPU path) on the CPU: the Pallas kernel in
    interpret mode."""
    attend = jbert._attention
    monkeypatch.setattr(
        jbert, "_attention",
        lambda q, k, v, pad_mask, on_tpu: attend(q, k, v, pad_mask, True))


def test_config_bert_large_matches_jax():
    j, t = jbert.BertConfig.bert_large(), tbert.BertConfig.bert_large()
    for field in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
                  "max_seq_len", "type_vocab_size", "dtype"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.head_dim == 64 and t.torch_dtype == torch.bfloat16


def test_bridge_round_trips_every_leaf(jax_params):
    model = _port_model(jax_params)
    _assert_trees_close(weights.jax_tree(model), jax_params, atol=0.0)


@pytest.mark.parametrize("pad,jax_flash", [(False, False), (False, True),
                                           (True, False)])
def test_hidden_states_and_logits_match_jax(jax_params, monkeypatch, pad,
                                            jax_flash):
    if jax_flash:
        _force_jax_flash(monkeypatch)
    cfg = jbert.BertConfig(**SHAPE)
    batch = _batch(0, pad=pad)
    jb = _jax_batch(batch)
    hidden_j = jbert.forward(jax_params, jb["tokens"], cfg,
                             segment_ids=jb.get("segment_ids"),
                             pad_mask=jb.get("pad_mask"))
    logits_j = jbert.mlm_logits(jax_params, hidden_j, cfg)
    model = _port_model(jax_params)
    with torch.no_grad():
        hidden = tbert.forward(
            model, torch.as_tensor(batch["tokens"]),
            segment_ids=(torch.as_tensor(batch["segment_ids"])
                         if pad else None),
            pad_mask=torch.as_tensor(batch["pad_mask"]) if pad else None)
        logits = tbert.mlm_logits(model, hidden)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(hidden.numpy(), np.asarray(hidden_j),
                               atol=STATE_ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=STATE_ATOL, rtol=0)


@pytest.mark.parametrize("pad,jax_flash", [(False, False), (False, True),
                                           (True, False)])
def test_loss_and_grads_match_jax(jax_params, monkeypatch, pad, jax_flash):
    if jax_flash:
        _force_jax_flash(monkeypatch)
    cfg = jbert.BertConfig(**SHAPE)
    batch = _batch(1, pad=pad)
    loss_j, grads_j = jax.value_and_grad(jbert.loss_fn)(
        jax_params, _jax_batch(batch), cfg)
    model = _port_model(jax_params)
    loss = tbert.loss_fn(model, batch)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    _assert_trees_close(weights.jax_tree(model, "grads"), grads_j,
                        rel=GRAD_RTOL)


def test_reference_attention_is_jax_plain_path(jax_params):
    """``attn_impl="reference"`` (the card's comparison) is JAX's plain
    f32 path, the same function as the flash path."""
    model = _port_model(jax_params)
    tokens = torch.as_tensor(_batch(2)["tokens"])
    with torch.no_grad():
        flash = tbert.forward(model, tokens)
        ref = tbert.forward(model, tokens, attn_impl="reference")
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), atol=STATE_ATOL,
                               rtol=0)
    with pytest.raises(ValueError, match="attn_impl"):
        tbert.forward(model, tokens, attn_impl="xla")


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(tbert.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=0)


def test_train_steps_match_jax_make_train_step(jax_params):
    cfg = jbert.BertConfig(**SHAPE)
    init_j, step_j = jbert.make_train_step(cfg)
    state_j = init_j(jax.random.PRNGKey(0))  # the fixture's params
    init_t, step_t = tbert.make_train_step(tbert.BertConfig(**SHAPE),
                                           device="cpu")
    model = _port_model(jax_params)
    state_t = init_t(model=model)
    for step in range(3):
        batch = _batch(10 + step)
        state_j, loss_j = step_j(state_j, _jax_batch(batch))
        state_t, loss_t = step_t(state_t, batch)
        assert abs(loss_t.item() - float(loss_j)) < LOSS_ATOL, step
    assert state_t[0] is model  # updated in place
    _assert_trees_close(weights.jax_tree(model), state_j[0], atol=PARAM_ATOL)


def test_synthetic_batch_masks_about_15_percent():
    cfg = tbert.BertConfig(vocab_size=1000, max_seq_len=512)
    batch = tbert.synthetic_mlm_batch(np.random.default_rng(0), 8, cfg)
    mask = batch["mlm_mask"].bool()
    assert 0.13 < mask.float().mean().item() < 0.17
    assert (batch["tokens"][mask] == tbert.MASK_TOKEN).all()
    assert (batch["tokens"][~mask] == batch["labels"][~mask]).all()
    assert batch["labels"].min() > tbert.MASK_TOKEN
    assert batch["labels"].max() < cfg.vocab_size


def test_random_init_loss_is_near_ln_vocab():
    """init_params' scales: the first loss of random weights sits near
    ln V (the tied head's logits are small)."""
    cfg = tbert.BertConfig(**{**SHAPE, "vocab_size": 1000})
    model = tbert.init_params(cfg, device="cpu", seed=0)
    batch = tbert.synthetic_mlm_batch(np.random.default_rng(0), 2, cfg)
    loss = tbert.loss_fn(model, batch).item()
    assert abs(loss - np.log(cfg.vocab_size)) < 0.5
