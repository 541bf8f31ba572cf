# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port MNIST and ResNet (PyTorch, CPU) vs the JAX package's on the same
weights and batches: logits, loss, every gradient, optimizer steps, and
ResNet's running statistics after a step.

f32 parameters on both sides. JAX's weights are bridged with
``weights.load_jax_tree`` (HWIO conv kernels → OIHW; flax's ``params``
into the parameters, its ``batch_stats`` into the buffers) and come back
with ``weights.jax_tree``. ResNet runs at image sizes 32 and 30: flax's
SAME padding of the stride-2 3×3 conv is (0, 1) on an even input and
(1, 1) on an odd one, and its stem gives a 16- or 15-wide map.

ResNet's gradients are compared where both packages compute in f32
(``resnet18_ish``, what ``train_cli`` trains) at size 32, and with f64
compute (``ResNet(dtype=float64)``: f32 parameters, f64 activations and
statistics, the f32 head) at size 30. At size 30 in f32 one input of the
last ReLU lies 6e-8 from 0 while the two packages' activations differ by
up to 2e-5 there (summation order), so a ReLU can open in one and not
the other and route that element's gradient differently (1.3 % of
block 1's last conv gradient): a property of the data at a kink, not a
difference between the packages. In f64 the activations agree to about
1e-15. The f32 forward at size 30 is held as well.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import mnist as jmnist  # noqa: E402
from container_engine_accelerators_tpu.models import resnet as jresnet  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    mnist as tmnist,
    resnet as tresnet,
    weights,
)

# f32, summed in other orders (convolutions in other algorithms): logits
# to 1e-4 absolute, the loss (~2.3) to 1e-5, each gradient to 1e-5 of its
# own largest entry; running statistics to 1e-5.
LOGITS_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
STATS_ATOL = 1e-5
# SGD with momentum moves a parameter by lr · (a sum of gradients): after
# steps the summation-order noise of the gradients is scaled by lr.
MNIST_PARAM_ATOL = 1e-5
RESNET_PARAM_ATOL = 1e-5


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


# -- MNIST ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnist_params():
    return jmnist.init_params(jax.random.PRNGKey(0))


def _mnist_model(params):
    return weights.load_jax_tree(tmnist.Mnist("cpu"),
                                 jax.tree.map(np.asarray, params))


def _mnist_batch(seed, batch=8):
    b = tmnist.synthetic_batch(np.random.default_rng(seed), batch)
    return {k: v.numpy() for k, v in b.items()}


def test_mnist_logits_loss_and_grads_match_jax(mnist_params):
    batch = _mnist_batch(0)
    logits_j = jmnist.forward(mnist_params, jnp.asarray(batch["images"]))
    loss_j, grads_j = jax.value_and_grad(jmnist.loss_fn)(
        mnist_params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _mnist_model(mnist_params)
    _assert_trees_close(weights.jax_tree(model), mnist_params, atol=0.0)
    logits = tmnist.forward(model, torch.as_tensor(batch["images"]))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=LOGITS_ATOL, rtol=0)
    loss = tmnist.loss_fn(model, batch)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    _assert_trees_close(weights.jax_tree(model, "grads"), grads_j,
                        rel=GRAD_RTOL)


def test_mnist_sgd_steps_match_jax(mnist_params):
    init_j, step_j = jmnist.make_train_step()
    state_j = init_j(jax.random.PRNGKey(0))
    init_t, step_t = tmnist.make_train_step(device="cpu")
    model = _mnist_model(mnist_params)
    state_t = init_t(model=model)
    for step in range(3):
        batch = _mnist_batch(10 + step)
        state_j, loss_j = step_j(
            state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        state_t, loss_t = step_t(state_t, batch)
        assert abs(loss_t.item() - float(loss_j)) < LOSS_ATOL, step
    _assert_trees_close(weights.jax_tree(model), state_j[0],
                        atol=MNIST_PARAM_ATOL)


# -- ResNet --------------------------------------------------------------------

RESNET_BATCH = 4


# The compute dtypes of the ResNet cases: (JAX, port).
DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}
RESNET_CASES = [(32, "float32"), (30, "float64")]


def _resnet_variables(image_size, dtype="float32"):
    model = jresnet.ResNet([1, 1], 10, DTYPES[dtype][0])
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, image_size, image_size, 3)),
                           train=False)
    # Non-trivial statistics and BN scales (the last BN of each block
    # starts at 0, which would hide its branch from the gradients).
    rng = np.random.default_rng(5)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        variables["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.uniform(0.5, 1.5, a.shape),
                                     a.dtype)
                         if jax.tree_util.keystr(path).endswith("['scale']")
                         else a),
        variables["params"])
    return model, params, stats


def _resnet_port(params, stats, dtype="float32"):
    model = tresnet.ResNet([1, 1], 10, DTYPES[dtype][1], "cpu")
    weights.load_jax_tree(model, jax.tree.map(np.asarray, params))
    weights.load_jax_tree(model, jax.tree.map(np.asarray, stats))
    return model


def _resnet_batch(seed, image_size):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.standard_normal(
            (RESNET_BATCH, image_size, image_size, 3), dtype="float32"),
        "labels": rng.integers(0, 10, RESNET_BATCH),
    }


@pytest.mark.parametrize("image_size", [32, 30])
def test_resnet_f32_forward_and_stats_match_jax(image_size):
    jmodel, params, stats = _resnet_variables(image_size)
    batch = _resnet_batch(0, image_size)
    logits_j, updates = jmodel.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(batch["images"]), train=True, mutable=["batch_stats"])
    model = _resnet_port(params, stats)
    with torch.no_grad():
        logits = model(torch.as_tensor(batch["images"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=LOGITS_ATOL, rtol=0)
    _assert_trees_close(weights.jax_tree(model, "buffers"),
                        updates["batch_stats"], atol=STATS_ATOL)


@pytest.fixture
def x64(request):
    """JAX in 64-bit mode for the f64 cases (a scoped switch)."""
    if request.node.callspec.params["dtype"] != "float64":
        yield
        return
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("image_size,dtype", RESNET_CASES)
def test_resnet_forward_grads_and_stats_match_jax(image_size, dtype, x64):
    jmodel, params, stats = _resnet_variables(image_size, dtype)
    batch = _resnet_batch(0, image_size)

    def jloss(p):
        logits, updates = jmodel.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
            train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(batch["labels"])[:, None], axis=1))
        return loss, (logits, updates["batch_stats"])

    (loss_j, (logits_j, stats_j)), grads_j = jax.value_and_grad(
        jloss, has_aux=True)(params)
    model = _resnet_port(params, stats, dtype)
    _assert_trees_close(weights.jax_tree(model), params, atol=0.0)
    _assert_trees_close(weights.jax_tree(model, "buffers"), stats, atol=0.0)
    logits = model(torch.as_tensor(batch["images"]))
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, 1, torch.as_tensor(
        batch["labels"])[:, None]).mean()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=LOGITS_ATOL, rtol=0)
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    _assert_trees_close(weights.jax_tree(model, "grads"), grads_j,
                        rel=GRAD_RTOL)
    _assert_trees_close(weights.jax_tree(model, "buffers"), stats_j,
                        atol=STATS_ATOL)


@pytest.mark.parametrize("image_size,dtype", RESNET_CASES)
def test_resnet_sgd_step_and_batch_stats_match_jax(image_size, dtype, x64):
    jmodel, params, stats = _resnet_variables(image_size, dtype)
    init_j, step_j = jresnet.make_train_step(jmodel, image_size=image_size)
    state_j = (params, stats, init_j(jax.random.PRNGKey(0))[2])
    model = _resnet_port(params, stats, dtype)
    init_t, step_t = tresnet.make_train_step(None)
    state_t = init_t(model=model)
    for step in range(2):
        batch = _resnet_batch(10 + step, image_size)
        state_j, loss_j = step_j(
            state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        state_t, loss_t = step_t(state_t, batch)
        assert abs(loss_t.item() - float(loss_j)) < LOSS_ATOL, step
    _assert_trees_close(weights.jax_tree(model), state_j[0],
                        atol=RESNET_PARAM_ATOL)
    _assert_trees_close(weights.jax_tree(model, "buffers"), state_j[1],
                        atol=STATS_ATOL)


@pytest.mark.parametrize("n,k,s,want", [
    (32, 3, 2, (0, 1)), (15, 3, 2, (1, 1)), (32, 1, 2, (0, 0)),
    (31, 1, 2, (0, 0)), (16, 3, 1, (1, 1)),
])
def test_same_padding_is_flax_s(n, k, s, want):
    assert tresnet.same_pad(n, k, s) == want


def test_resnet50_has_flax_s_parameter_tree():
    """resnet50's modules and shapes equal flax's (the bridge's
    contract), without running it."""
    jmodel = jresnet.resnet50(num_classes=10, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))
    model = tresnet.resnet50(num_classes=10, dtype=torch.float32,
                             device="cpu")
    got = jax.tree.map(np.shape, weights.jax_tree(model))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes["params"])
    assert got == want
    got = jax.tree.map(np.shape, weights.jax_tree(model, "buffers"))
    assert got == jax.tree.map(lambda s: tuple(s.shape),
                               shapes["batch_stats"])


def test_random_init_resnet_trains_on_cpu():
    init_state, train_step = tresnet.make_train_step(
        lambda: tresnet.resnet18_ish(device="cpu"))
    state = init_state(seed=0)
    batch = _resnet_batch(1, 32)
    losses = [train_step(state, batch)[1].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
