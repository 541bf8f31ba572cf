# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port MoE FFN (PyTorch, CPU) vs the JAX package's ``parallel/moe.py``
on the same numpy inputs, and the transformer with experts vs JAX's
(loss with the aux term, every gradient, AdamW steps); serving a model
with experts is refused.

f32 on both sides: outputs to 1e-5, the aux loss to 1e-6, the loss to
1e-5, each gradient to 1e-5 of its own largest entry, parameters to
2 · lr after AdamW steps.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.parallel import moe as jmoe  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    quantization,
    serve_cli,
    weights,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.parallel import moe as tmoe  # noqa: E402

OUT_ATOL = 1e-5
AUX_ATOL = 1e-6
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
LR = 3e-4
PARAM_ATOL = 2 * LR

D, F, E = 16, 32, 4


def _params(seed):
    rng = np.random.default_rng(seed)
    return {
        "router": rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5,
        "w1": rng.standard_normal((E, D, F)).astype(np.float32) * D ** -0.5,
        "w2": rng.standard_normal((E, F, D)).astype(np.float32) * F ** -0.5,
    }


def _both(x, params, **kw):
    yj, auxj = jmoe.moe_ffn(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in params.items()},
                            **kw)
    yt, auxt = tmoe.moe_ffn(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in params.items()},
                            **kw)
    return (np.asarray(yj), float(auxj)), (yt.numpy(), auxt.item())


@pytest.mark.parametrize("shape,kw", [
    ((24, D), {}),
    ((3, 8, D), {}),
    ((2, 3, 4, D), {"top_k": 1}),
    ((24, D), {"top_k": 2, "capacity_factor": 0.5}),
    ((3, 8, D), {"top_k": 3, "capacity_factor": 0.25}),
])
def test_moe_ffn_matches_jax(shape, kw):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    (yj, auxj), (yt, auxt) = _both(x, _params(0), **kw)
    assert yt.shape == x.shape
    np.testing.assert_allclose(yt, yj, atol=OUT_ATOL, rtol=0)
    assert abs(auxt - auxj) < AUX_ATOL


def test_small_capacity_drops_tokens_as_jax_does():
    """cf 0.5 over 24 tokens, top-2 of 4 experts: capacity 6 per expert
    for 48 assignments, so tokens are dropped (rows of zeros when every
    choice overflowed), and the same ones in both packages."""
    assert tmoe.capacity(24, E, 2, 0.5) == jmoe.capacity(24, E, 2, 0.5) == 6
    x = np.random.default_rng(2).standard_normal((24, D)).astype(np.float32)
    (yj, _), (yt, _) = _both(x, _params(3), top_k=2, capacity_factor=0.5)
    (yfull, _), _ = _both(x, _params(3), top_k=2, capacity_factor=4.0)
    dropped = ~np.isclose(yj, yfull, atol=1e-6).all(axis=-1)
    assert dropped.sum() > 0
    np.testing.assert_allclose(yt, yj, atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("n,k,cf", [(24, 2, 1.25), (7, 1, 1.0), (1, 2, 0.1),
                                    (100, 3, 2.0)])
def test_capacity_matches_jax(n, k, cf):
    assert tmoe.capacity(n, E, k, cf) == jmoe.capacity(n, E, k, cf)


def test_top_k_ties_go_to_the_lower_index_as_in_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(probs), 3)
    vt, it = tmoe.sorted_top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_forced_router_ties_route_as_jax_does():
    """A zero router gives every expert the same probability: each token's
    top-k are then experts 0..k-1 in both packages, and capacity decides
    who is dropped."""
    params = _params(4)
    params["router"] = np.zeros_like(params["router"])
    x = np.random.default_rng(5).standard_normal((2, 12, D)).astype(
        np.float32)
    (yj, auxj), (yt, auxt) = _both(x, params, top_k=2, capacity_factor=1.0)
    np.testing.assert_allclose(yt, yj, atol=OUT_ATOL, rtol=0)
    assert abs(auxt - auxj) < AUX_ATOL
    assert abs(auxt - 1.0) < AUX_ATOL  # E · (1 · 1/E) with all on expert 0


def test_aux_loss_gradients_match_jax():
    """The router learns through the gates and the aux loss: d(sum(y) +
    aux) for every parameter and the input."""
    params = _params(6)
    x = np.random.default_rng(7).standard_normal((2, 10, D)).astype(
        np.float32)

    def jf(p, xj):
        y, aux = jmoe.moe_ffn(xj, p)
        return (y * jnp.arange(D)).sum() + aux

    gj = jax.grad(jf, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_ffn(xt, pt)
    ((y * torch.arange(D)).sum() + aux).backward()
    for name in params:
        want = np.asarray(gj[0][name])
        np.testing.assert_allclose(pt[name].grad.numpy(), want,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   rtol=0, err_msg=name)
    want = np.asarray(gj[1])
    np.testing.assert_allclose(xt.grad.numpy(), want,
                               atol=GRAD_RTOL * np.abs(want).max(), rtol=0)


# -- the transformer with experts ---------------------------------------------

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32",
             n_experts=4)
SEQ = 32


@pytest.fixture(scope="module")
def jax_params():
    return jtf.init_params(jax.random.PRNGKey(0),
                           jtf.TransformerConfig(**SHAPE))


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
    ref = _leaves(ref)
    assert sorted(got) == sorted(p for p, _ in ref)
    for path, want in ref:
        tol = atol if rel is None else rel * np.abs(want).max()
        np.testing.assert_allclose(got[path], want, atol=tol, rtol=0,
                                   err_msg=path)


def test_config_fields_match_jax():
    j, t = jtf.TransformerConfig(), ttf.TransformerConfig()
    for name in ("n_experts", "expert_top_k", "capacity_factor",
                 "moe_aux_weight"):
        assert getattr(t, name) == getattr(j, name), name


def test_bridge_keeps_the_router_f32_and_round_trips(jax_params):
    model = _port_model(jax_params)
    assert model.layers[0].ffn.router.dtype == torch.float32
    _assert_trees_close(weights.params_to_jax(model), jax_params, atol=0.0)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_transformer_loss_and_grads_match_jax(jax_params, remat):
    cfg = jtf.TransformerConfig(**SHAPE)
    toks = _batch(0)
    loss_j, grads_j = jax.value_and_grad(jtf.loss_fn)(
        jax_params, {"tokens": jnp.asarray(toks)}, cfg, attn_impl="xla")
    _, aux_j = jtf.forward(jax_params, jnp.asarray(toks[:, :-1]), cfg,
                           attn_impl="xla", return_aux=True)
    model = _port_model(jax_params)
    _, aux = ttf.forward(model, torch.as_tensor(toks[:, :-1]),
                         return_aux=True)
    assert abs(aux.item() - float(aux_j)) < AUX_ATOL
    loss = ttf.loss_fn(model, {"tokens": toks}, remat=remat)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    _assert_trees_close(weights.grads_to_jax(model), grads_j, rel=GRAD_RTOL)


def test_moe_train_steps_match_jax(jax_params):
    cfg = jtf.TransformerConfig(**SHAPE)
    init_j, step_j = jtf.make_train_step(cfg, attn_impl="xla")
    state_j = init_j(jax.random.PRNGKey(0))
    init_t, step_t = ttf.make_train_step(ttf.TransformerConfig(**SHAPE),
                                         device="cpu")
    model = _port_model(jax_params)
    state_t = init_t(model=model)
    for step in range(3):
        toks = _batch(10 + step)
        state_j, loss_j = step_j(state_j, {"tokens": jnp.asarray(toks)})
        state_t, loss_t = step_t(state_t, {"tokens": toks})
        assert abs(loss_t.item() - float(loss_j)) < LOSS_ATOL, step
    _assert_trees_close(weights.params_to_jax(model), state_j[0],
                        atol=PARAM_ATOL)


def test_dense_forward_reports_a_zero_aux():
    cfg = ttf.TransformerConfig(**{**SHAPE, "n_experts": 0})
    model = ttf.init_params(cfg, device="cpu", seed=0)
    _, aux = ttf.forward(model, torch.zeros(1, 4, dtype=torch.long),
                         return_aux=True)
    assert aux.item() == 0.0


def test_serving_and_int8_refuse_experts(jax_params):
    """Serving and int8 no longer refuse experts: ``Model`` and the
    engine take the MoE config, and ``quantize_params`` quantizes the
    attention matrices only, the experts refused the int8 treatment as
    JAX's default keys refuse them (``tests/test_torch_moe_serving.py``
    holds the served tokens to JAX's)."""
    cfg = ttf.TransformerConfig(**SHAPE)
    model = _port_model(jax_params)
    served = serve_cli.Model(cfg, device="cpu", weights=model)
    assert served.model is model
    engine = serve_cli.ContinuousEngine(served, start_loop=False)
    assert engine.model is served
    experts = [(layer.ffn.w1.clone(), layer.ffn.w2.clone(),
                layer.ffn.router.clone()) for layer in model.layers]
    quantization.quantize_params(model)
    for layer, (w1, w2, router) in zip(model.layers, experts):
        for key in ("wq", "wk", "wv", "wo"):
            assert isinstance(getattr(layer.attn, key),
                              quantization.Int8Weight)
        assert not quantization.is_quantized(layer.ffn.w1)
        assert torch.equal(layer.ffn.w1, w1)
        assert torch.equal(layer.ffn.w2, w2)
        assert torch.equal(layer.ffn.router, router)
