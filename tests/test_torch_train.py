# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port training step (PyTorch, CPU) vs the JAX package's on the same
weights: loss, every gradient, AdamW steps and the CLI's result keys.

Tiny f32 config (vocab 128, d_model 64, 2 layers, 4/2 heads, S 32); the
JAX ``init_params(PRNGKey(0))`` weights are bridged into the port with
``params_from_jax`` and gradients come back with ``grads_to_jax``. The
port's attention on the CPU is the flash kernels' plain versions.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import train_cli as jtrain_cli  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serving_graphs,
    train_cli,
    weights,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32")
SEQ = 32
LR = 3e-4
# f32 on both sides, summed in other orders: the loss (~4.9) to 1e-5 and
# each gradient to 1e-5 of its own largest entry.
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
# After Adam steps a parameter moves by about lr * sign(m / sqrt(v)) per
# step; entries whose gradient is near eps or flips sign under the
# summation-order noise may move differently: compare to about 2 * lr.
PARAM_ATOL = 2 * LR


@pytest.fixture(scope="module")
def jax_params():
    return jtf.init_params(jax.random.PRNGKey(0), jtf.TransformerConfig(**SHAPE))


def _port_model(params):
    return weights.params_from_jax(jax.tree.map(np.asarray, params),
                                   ttf.TransformerConfig(**SHAPE),
                                   device="cpu")


def _batch(seed, batch=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SHAPE["vocab_size"], (batch, SEQ + 1))


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(path), np.asarray(leaf, np.float32))
            for path, leaf in flat]


def _assert_trees_close(got, ref, rel=None, atol=None):
    got = dict(_leaves(got))
    for path, want in _leaves(ref):
        tol = atol if rel is None else rel * np.abs(want).max()
        np.testing.assert_allclose(got[path], want, atol=tol, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("jax_attn,remat", [("flash", True), ("xla", False)])
def test_loss_and_grads_match_jax(jax_params, jax_attn, remat):
    """JAX with its Pallas kernels (interpret mode) or its XLA oracle vs
    the port's flash path, per-layer remat on or off."""
    toks = _batch(0)
    cfg = jtf.TransformerConfig(**SHAPE)
    loss_j, grads_j = jax.value_and_grad(jtf.loss_fn)(
        jax_params, {"tokens": jnp.asarray(toks)}, cfg, attn_impl=jax_attn)
    model = _port_model(jax_params)
    loss = ttf.loss_fn(model, {"tokens": toks}, remat=remat)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    _assert_trees_close(weights.grads_to_jax(model), grads_j, rel=GRAD_RTOL)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_make_train_step(jax_params, steps):
    cfg = jtf.TransformerConfig(**SHAPE)
    init_j, step_j = jtf.make_train_step(cfg, attn_impl="xla")
    # init_state(key) draws PRNGKey(0)'s params, the fixture's.
    state_j = init_j(jax.random.PRNGKey(0))
    init_t, step_t = ttf.make_train_step(ttf.TransformerConfig(**SHAPE),
                                         device="cpu")
    model = _port_model(jax_params)
    state_t = init_t(model=model)
    for step in range(steps):
        toks = _batch(10 + step)
        state_j, loss_j = step_j(state_j, {"tokens": jnp.asarray(toks)})
        state_t, loss_t = step_t(state_t, {"tokens": toks})
        assert abs(loss_t.item() - float(loss_j)) < LOSS_ATOL, step
    assert state_t[0] is model  # updated in place
    _assert_trees_close(weights.params_to_jax(model), state_j[0],
                        atol=PARAM_ATOL)


def test_training_reduces_loss():
    """The port's twin of tests/test_models.py's convergence check."""
    init_state, train_step = ttf.make_train_step(
        ttf.TransformerConfig(**SHAPE), device="cpu")
    state = init_state(seed=0)
    toks = _batch(1, batch=4)
    losses = []
    for _ in range(5):
        state, loss = train_step(state, {"tokens": toks})
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert np.isfinite(losses[-1])


def test_serving_after_a_training_step_matches_jax(jax_params):
    """Trainable parameters serve as before: after one step, greedy
    generation on the updated weights equals the JAX package's on the
    same weights, and builds no autograd graph."""
    init_state, train_step = ttf.make_train_step(
        ttf.TransformerConfig(**SHAPE), device="cpu")
    state, _ = train_step(init_state(model=_port_model(jax_params)),
                          {"tokens": _batch(2)})
    model = state[0]
    prompt = _batch(3)[:, :9]
    out = ttf.generate(model, torch.as_tensor(prompt), max_new_tokens=6,
                       decoder=serving_graphs.DenseDecodeGraphs(model))
    assert not out.requires_grad
    params = jax.tree.map(jnp.asarray, weights.params_to_jax(model))
    ref = jtf.generate(params, jnp.asarray(prompt, jnp.int32),
                       jtf.TransformerConfig(**SHAPE), max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# --batch-size: the JAX CLI's default scales with its dp axis, the test
# host's 8 virtual CPU devices, and its batch must divide over them; the
# port runs on one device.
TINY_FLAGS = ["--model", "transformer", "--steps", "2", "--d-model", "64",
              "--n-heads", "4", "--seq-len", "32", "--vocab-size", "128",
              "--batch-size", "8"]


def test_train_cli_prints_the_jax_result_keys(capsys):
    assert train_cli.main([*TINY_FLAGS, "--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jtrain_cli.main(TINY_FLAGS) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(port) == sorted(ref)
    assert port["steps_run"] == 2 and np.isfinite(port["loss"])
    assert port["batch_size"] == ref["batch_size"] == 8
    assert port["est_mfu"] == 0.0  # no known card: no peak to divide by


# Small flags each model takes on both packages (the JAX CLI's batch
# must divide over its 8 virtual CPU devices).
MODEL_FLAGS = {
    "mnist": ["--batch-size", "8"],
    "resnet": ["--batch-size", "8", "--image-size", "32"],
    "bert": ["--batch-size", "8", "--seq-len", "32", "--d-model", "64",
             "--n-heads", "4", "--vocab-size", "128"],
}


@pytest.mark.parametrize("model", sorted(MODEL_FLAGS))
def test_train_cli_runs_every_model_with_jax_s_result_keys(model, capsys):
    flags = ["--model", model, "--steps", "2", *MODEL_FLAGS[model]]
    assert train_cli.main([*flags, "--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jtrain_cli.main(flags) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(port) == sorted(ref)
    assert port["steps_run"] == 2 and np.isfinite(port["loss"])
    assert port["batch_size"] == ref["batch_size"] == 8
    assert port["model"] == model


def test_train_cli_default_model_is_mnist(capsys):
    assert train_cli.main(["--steps", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "mnist" and out["batch_size"] == 64


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--sp", "2"],
                                  ["--ep", "2"], ["--pp", "2"],
                                  ["--microbatches", "4"],
                                  ["--distributed"]])
def test_multi_gpu_flags_are_not_ported_yet(flag):
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        train_cli.main(["--model", "transformer", "--device", "cpu", *flag])
