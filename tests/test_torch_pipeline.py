# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's pipeline schedules (``parallel/pipeline.py``) against the
JAX package's on the same inputs.

The stage is ``tests/test_pipeline.py``'s tanh-linear one, the loss its
MSE, with a loss parameter (a per-feature scale) so that the
loss-parameter gradients are held too. Inputs come from a numpy
generator; JAX runs on its 8-device CPU mesh. ``pipeline_train_1f1b``
under ``InProcess`` (every stage in one process) is held to JAX's for N
in {2, 4} and M in {4, 6 (ragged at N 4), 8}: the loss, the stage and
loss-parameter gradients and dx, f32, atol 1e-5 and rtol 1e-4.
``pipeline_apply``, forward and gradient, is held to the sequential
composition and to JAX's. Then 2- and 4-rank gloo worlds
(``tests/torch_dist_worker.py``'s ``pipeline`` scenario, the ``P2P``
transport over the "pp" ring) give ``InProcess``'s results within 1e-6.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.parallel import pipeline as jpl  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import pipeline as pl  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel.ring_attention import (  # noqa: E402
    InProcess,
)

ATOL, RTOL = 1e-5, 1e-4
WORLD_ATOL = 1e-6
SHAPES = [(2, 4), (2, 6), (2, 8), (4, 4), (4, 6), (4, 8)]


def _close(got, ref, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


def jstage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def jloss(y, tgt, lp):
    return jnp.mean((y * lp["scale"] - tgt) ** 2)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("pp",))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("n_stages,n_micro", SHAPES)
def test_1f1b_in_process_matches_jax(n_stages, n_micro):
    inputs = worker.pipeline_inputs(n_stages, n_micro)
    ws, bs, x, tgt, scale = inputs
    loss_j, (gw_j, gb_j), lpg_j, dx_j = jpl.pipeline_train_1f1b(
        jstage, jloss, (jnp.asarray(ws), jnp.asarray(bs)), jnp.asarray(x),
        jnp.asarray(tgt), _mesh(n_stages),
        loss_params={"scale": jnp.asarray(scale)}, return_dx=True)
    loss, grads, lpg, dx = worker.pipeline_in_process(inputs)
    _close(float(loss), float(loss_j), "loss")
    _close(np.stack([g[0].numpy() for g in grads]), gw_j, "dW")
    _close(np.stack([g[1].numpy() for g in grads]), gb_j, "db")
    _close(lpg["scale"].numpy(), lpg_j["scale"], "d scale")
    _close(dx.numpy(), dx_j, "dx")


def test_1f1b_without_loss_params_returns_loss_and_grads():
    ws, bs, x, tgt, _ = worker.pipeline_inputs(2, 3)
    out = pl.pipeline_train_1f1b(
        worker.stage, lambda y, t: ((y - t) ** 2).mean(),
        [(_t(ws[i]), _t(bs[i])) for i in range(2)], _t(x), _t(tgt),
        InProcess(2))
    assert len(out) == 2
    loss_j, (gw_j, _) = jpl.pipeline_train_1f1b(
        jstage, lambda y, t: jnp.mean((y - t) ** 2),
        (jnp.asarray(ws), jnp.asarray(bs)), jnp.asarray(x),
        jnp.asarray(tgt), _mesh(2))
    _close(float(out[0]), float(loss_j), "loss")
    _close(np.stack([g[0].numpy() for g in out[1]]), gw_j, "dW")


def test_1f1b_holds_at_most_2n_minus_1_inputs_per_stage():
    """The schedule's memory bound: a stage's forward (no grad) keeps its
    input until the backward's recompute (under autograd) of the same
    microbatch, so the inputs a stage holds peak at B(i, 0) - F(i, 0) + 1
    = 2(N - 1 - i) + 1, at most 2N - 1 (stage 0); the last stage runs its
    forward once, at its backward tick."""
    n, m = 4, 12
    ws, bs, x, tgt, _ = worker.pipeline_inputs(n, m)
    params = [(_t(ws[i]), _t(bs[i])) for i in range(n)]
    stage_of = {p[0].data_ptr(): i for i, p in enumerate(params)}
    live, peak = [0] * n, [0] * n

    def stage(p, h):
        i = stage_of[p[0].data_ptr()]
        if torch.is_grad_enabled():
            live[i] -= i < n - 1
        else:
            live[i] += 1
            peak[i] = max(peak[i], live[i])
        return worker.stage(p, h)

    pl.pipeline_train_1f1b(stage, lambda y, t: ((y - t) ** 2).mean(),
                           params, _t(x), _t(tgt), InProcess(n))
    assert peak == [2 * (n - 1 - i) + 1 for i in range(n - 1)] + [0], peak
    assert live == [0] * n


@pytest.mark.parametrize("n_stages,n_micro,with_jax",
                         [(2, 6, True), (4, 8, True), (4, 1, False)])
def test_pipeline_apply_matches_sequential_and_jax(n_stages, n_micro,
                                                   with_jax):
    """Forward and gradient against the sequential composition; against
    JAX's ``pipeline_apply`` too where ``with_jax`` (its gradient takes
    about 7 s to compile; a single microbatch is held to the sequential
    one only)."""
    ws, bs, x, _, _ = worker.pipeline_inputs(n_stages, n_micro)
    w_t = _t(ws).requires_grad_(True)
    b_t = _t(bs).requires_grad_(True)
    x_t = _t(x).requires_grad_(True)
    out = pl.pipeline_apply(worker.stage,
                            [(w_t[i], b_t[i]) for i in range(n_stages)],
                            x_t, InProcess(n_stages))
    (out * out).sum().backward()

    w_s = _t(ws).requires_grad_(True)
    x_s = _t(x).requires_grad_(True)
    seq = x_s
    for i in range(n_stages):
        seq = worker.stage((w_s[i], _t(bs[i])), seq)
    (seq * seq).sum().backward()
    assert (out - seq).abs().max().item() < 1e-6
    _close(w_t.grad.numpy(), w_s.grad.numpy(), "dW vs sequential")
    _close(x_t.grad.numpy(), x_s.grad.numpy(), "dx vs sequential")
    if not with_jax:
        return
    mesh = _mesh(n_stages)

    def jfn(w, b, xx):
        y = jpl.pipeline_apply(jstage, (w, b), xx, mesh)
        return jnp.sum(y * y), y

    (_, y_j), (gw_j, gb_j, gx_j) = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(ws), jnp.asarray(bs), jnp.asarray(x))
    _close(out.detach().numpy(), y_j, "out vs JAX")
    _close(w_t.grad.numpy(), gw_j, "dW vs JAX")
    _close(b_t.grad.numpy(), gb_j, "db vs JAX")
    _close(x_t.grad.numpy(), gx_j, "dx vs JAX")


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """The pipeline scenario on gloo worlds of 2 and 4 ranks."""
    out = {}
    for world in (2, 4):
        workdir = tmp_path_factory.mktemp(f"pp{world}")
        cases = {f"n{world}_m{m}": (world, m) for m in (4, 6)}
        with open(workdir / "pipeline_in.pkl", "wb") as f:
            pickle.dump(cases, f)
        out[world] = (cases, worker.spawn("pipeline", world, str(workdir)))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_1f1b_and_apply_over_gloo_ranks_match_in_process(gloo_worlds, world):
    cases, ranks = gloo_worlds[world]
    for name, (n, m) in cases.items():
        inputs = worker.pipeline_inputs(n, m)
        loss, grads, lpg, dx = worker.pipeline_in_process(inputs)
        ref_out, ref_grads = worker.pipeline_apply_in_process(inputs)
        for rank, got in enumerate(ranks):
            res = got[name]
            tag = f"{name} rank {rank}"
            _close(res["loss"], float(loss), tag + " loss", WORLD_ATOL, 0)
            _close(res["dw"], grads[rank][0].numpy(), tag + " dW",
                   WORLD_ATOL, 0)
            _close(res["db"], grads[rank][1].numpy(), tag + " db",
                   WORLD_ATOL, 0)
            _close(res["dscale"], lpg["scale"].numpy(), tag + " dscale",
                   WORLD_ATOL, 0)
            _close(res["dx"], dx.numpy(), tag + " dx", WORLD_ATOL, 0)
            _close(res["apply_out"], ref_out, tag + " apply out",
                   WORLD_ATOL, 0)
            _close(res["apply_dw"], ref_grads[rank], tag + " apply dW",
                   WORLD_ATOL, 0)
