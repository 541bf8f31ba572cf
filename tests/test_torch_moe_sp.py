# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""MoE under sequence parallelism, each sequence routed whole across its
sp ranks, against the JAX package's.

JAX's ``train_cli --n-experts E --sp N`` hands ``moe.moe_ffn`` the
sp-sharded activations under GSPMD, which routes each whole sequence as
one group (its per-leading-dim ``vmap``): the capacity, the slot cumsum
and the Switch aux are the whole sequence's. The port's sp ranks route
their own tokens and exchange their per-row hit counts
(``parallel/moe._route_sharded``). Held here, f32:

  * the sharded routing at sp 2 and 4, every sp rank in this process
    (``Axes.in_process(sp=...)``), against JAX's routing of the whole
    sequence (``_moe_ffn_flat``'s lines, vmapped as ``moe_ffn`` vmaps
    them): slot masks and drops exactly, gate values to 1e-6 relative
    (an f32 ulp of the two frameworks' softmax); y and the aux
    against ``moe_ffn`` within JAX's own bounds (1e-4 relative and 1e-5
    absolute, the aux 1e-5), at capacity factor 1.25 and at 0.5, where
    an expert that earlier ranks filled drops a later rank's tokens;
  * the gradients of JAX's gradient test, ``(y ** 2).mean() + 0.01 ·
    aux``, through it: each rank's share, the ranks' parameters one
    tensor (their gradients summed, as over sp), the router's, the
    experts' and x's each within 1e-4 of the largest entry of
    ``jax.grad``'s;
  * a 2-layer MoE transformer's loss and gradients on a 2-rank gloo
    world (sp 2) and a 4-rank one (sp 2 × ep 2) against JAX's loss and
    ``jax.grad`` on the same mesh (the loss within 1e-5 relative, each
    gradient leaf within 1e-4 of its largest entry);
  * ``train_cli --n-experts 4 --sp 2 --ep 2`` on four ranks against one
    rank's run.

Alone: about 60 s.
"""

import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.models import train_cli as jtrain_cli  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.parallel import moe as jmoe  # noqa: E402
from container_engine_accelerators_tpu_torch.models import train_cli  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import moe as tmoe  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import (  # noqa: E402
    tensor_parallel as tpar,
)

D = 16
EXPERTS = 8
TOP_K = 2
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MOE_SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=64, max_seq_len=32, dtype="float32",
                 n_experts=4, capacity_factor=1.0)


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def assert_grads_close(got, want, what):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want), what
    for path, ref in want.items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(got[path], ref, rtol=0,
                                   atol=GRAD_RTOL * scale,
                                   err_msg=f"{what} {path}")


def moe_params():
    return jax.tree.map(np.array, jmoe.init_moe_params(
        jax.random.PRNGKey(0), D, 32, EXPERTS, dtype=jnp.float32))


def jax_routing(x, router, cf):
    """The routing lines of JAX's ``_moe_ffn_flat`` on each group of x
    (B, S, D), vmapped as ``moe_ffn`` vmaps them: (gate values (B, S, k),
    the k slot masks (B, k, S, E, C))."""
    def one(xf):
        c = jmoe.capacity(xf.shape[0], EXPERTS, TOP_K, cf)
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ router, axis=-1)
        gate_vals, gate_idx = jax.lax.top_k(probs, TOP_K)
        counts = jnp.zeros((EXPERTS,), jnp.float32)
        masks = []
        for j in range(TOP_K):
            onehot = jax.nn.one_hot(gate_idx[:, j], EXPERTS)
            pos = jnp.cumsum(onehot, axis=0) - 1 + counts[None, :]
            counts = counts + onehot.sum(axis=0)
            within = (pos < c) & (onehot > 0)
            slot = jax.nn.one_hot(pos.astype(jnp.int32), c)
            masks.append(slot * within[..., None])
        return gate_vals, jnp.stack(masks)
    gate_vals, masks = jax.jit(jax.vmap(one))(jnp.asarray(x))
    return np.asarray(gate_vals), np.asarray(masks)


def _shards(x, sp):
    return [t.contiguous() for t in torch.as_tensor(x).split(
        x.shape[1] // sp, dim=1)]


def _alone_kept(route, c):
    """Whether each of a rank's (token, slot) hits would fit in its
    expert's capacity were the rank's tokens the whole group: the hits
    of its earlier slots and tokens only."""
    _, gate_idx, _, _ = route
    onehot = torch.nn.functional.one_hot(gate_idx, EXPERTS).float()
    flat = onehot.transpose(1, 2).reshape(onehot.shape[0], -1, EXPERTS)
    pos = (torch.cumsum(flat, dim=1) - 1).view(onehot.shape[0], TOP_K, -1,
                                               EXPERTS).transpose(1, 2)
    return torch.gather(pos, -1, gate_idx[..., None])[..., 0] < c


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["roomy", "dropping"])
@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_routing_is_jax_s_whole_sequence_routing(sp, cf):
    params = moe_params()
    x = np.random.default_rng(3).standard_normal((2, 24, D),
                                                 dtype=np.float32)
    want_gates, want_masks = jax_routing(x, params["router"], cf)
    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe_ffn(
        x, p, top_k=TOP_K, capacity_factor=cf))(params, x)
    axes = tpar.Axes.in_process(sp=sp)
    xs = _shards(x, sp)
    routes, auxes, c = tmoe._route_sharded(
        xs, [torch.as_tensor(params["router"])] * sp, TOP_K, cf, axes)
    assert c == jmoe.capacity(24, EXPERTS, TOP_K, cf)
    masks = [torch.cat([tmoe.slot_masks(r, EXPERTS, c)[j] for r in routes],
                       dim=1).numpy() for j in range(TOP_K)]
    for j in range(TOP_K):
        np.testing.assert_array_equal(masks[j], want_masks[:, j],
                                      err_msg=f"slot {j}")
    # The softmax of two frameworks: the gate values to an f32 ulp.
    np.testing.assert_allclose(
        torch.cat([r[0] for r in routes], dim=1).numpy(), want_gates,
        rtol=1e-6, atol=0)
    kept = torch.cat([r[3] for r in routes], dim=1).numpy()
    np.testing.assert_array_equal(~kept, want_masks.sum(axis=(-1, -2))
                                  .transpose(0, 2, 1) == 0)
    for aux in auxes:
        np.testing.assert_allclose(aux.mean().item(), float(want_aux),
                                   rtol=1e-5)
    ys, _ = tmoe.moe_ffn_parallel(
        xs, [{k: torch.as_tensor(v) for k, v in params.items()}] * sp, axes,
        top_k=TOP_K, capacity_factor=cf)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(),
                               np.asarray(want_y), rtol=1e-4, atol=1e-5)
    if cf < 1:
        # A later rank drops a token its own hits would have fitted:
        # earlier ranks filled the expert.
        crossed = [((~r[3]) & _alone_kept(r, c)).any().item()
                   for r in routes[1:]]
        assert any(crossed)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["roomy", "dropping"])
@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_routing_gradients_are_jax_s(sp, cf):
    """``jax.grad`` of JAX's gradient test on the whole sequence against
    the sp ranks' shares of it: the router's gradient takes the aux once
    (the probabilities' sum over sp carries every rank's cotangent)."""
    params = moe_params()
    x = np.random.default_rng(4).standard_normal((2, 16, D),
                                                 dtype=np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(x, p, top_k=TOP_K, capacity_factor=cf)
        return (y ** 2).mean() + 0.01 * aux

    want, want_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    shared = {k: torch.as_tensor(v).clone().requires_grad_()
              for k, v in params.items()}
    xs = [t.requires_grad_() for t in _shards(x, sp)]
    ys, auxes = tmoe.moe_ffn_parallel(xs, [shared] * sp,
                                      tpar.Axes.in_process(sp=sp),
                                      top_k=TOP_K, capacity_factor=cf)
    sum((y ** 2).sum() / x.size + 0.01 * a / sp
        for y, a in zip(ys, auxes)).backward()
    assert_grads_close({k: t.grad.numpy() for k, t in shared.items()}, want,
                       f"sp {sp} cf {cf}")
    assert_grads_close({"x": torch.cat([t.grad for t in xs], 1).numpy()},
                       {"x": np.asarray(want_x)}, "x")


# -- gloo worlds --------------------------------------------------------------

# name: (world, sp, ep)
WORLD_CASES = {"sp2": (2, 2, 1), "sp2xep2": (4, 2, 2)}


def jax_moe_step(toks, sp, ep):
    """(JAX's initial weights, its loss and ``jax.grad``) of the MoE
    transformer on ``build_mesh(sp·ep, sp, 1, ep)``."""
    cfg = jtf.TransformerConfig(**MOE_SHAPE)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.array, params)
    mesh = jtrain_cli.build_mesh(sp * ep, sp, 1, ep)
    sharded = jax.device_put(params, jtf.param_shardings(cfg, mesh))
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      NamedSharding(mesh, P("dp", None)))}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, b, cfg, mesh=mesh)))(sharded, batch)
    return host, float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def sp_worlds(tmp_path_factory):
    out = {}
    for name, (world, sp, ep) in WORLD_CASES.items():
        workdir = tmp_path_factory.mktemp(name)
        toks = np.random.default_rng(5).integers(0, 64, (2, 17))
        host, jloss, jgrads = jax_moe_step(toks, sp, ep)
        with open(workdir / "tp_in.pkl", "wb") as f:
            pickle.dump({name: {"model": "transformer", "cfg": MOE_SHAPE,
                                "params": host, "batch": {"tokens": toks},
                                "sp": sp, "tp": 1, "ep": ep,
                                "overlap": None}}, f)
        out[name] = (jloss, jgrads,
                     worker.spawn("tp_train", world, str(workdir)))
    return out


@pytest.mark.parametrize("name", sorted(WORLD_CASES))
def test_gloo_world_matches_jax(sp_worlds, name):
    jloss, jgrads, ranks = sp_worlds[name]
    for rank, outs in enumerate(ranks):
        got = outs[name]
        np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {rank}")
        assert_grads_close(got["grads"], jgrads, f"{name} rank {rank}")


CLI = ["--model", "transformer", "--device", "cpu", "--d-model", "64",
       "--n-heads", "4", "--seq-len", "32", "--vocab-size", "128",
       "--steps", "2", "--dtype", "float32", "--n-experts", "4",
       "--batch-size", "4"]


def test_cli_moe_sp_ep_trains_on_four_ranks_as_one_rank_does(tmp_path,
                                                            capsys):
    runs, markers = worker.cli_world(CLI + ["--sp", "2", "--ep", "2"],
                                     str(tmp_path), "moe_sp", world=4)
    assert [rc for rc, _, _ in runs] == [0] * 4, runs[0][2][-2000:]
    assert train_cli.main(CLI) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for _, result, _ in runs:
        assert result["n_devices"] == 4 and result["steps_run"] == 2
        np.testing.assert_allclose(result["loss"], one["loss"],
                                   rtol=LOSS_RTOL)
    assert markers == [f"TPU_BOOTSTRAP_OK rank={r} world=4\n"
                       for r in range(4)]
