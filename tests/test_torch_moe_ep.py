# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Expert-parallel MoE of the port against the JAX package's, and MoE
training under data parallelism.

JAX's setups: ``tests/test_moe.py``'s ``test_ep_sharded_matches_unsharded``
(the MoE FFN with ``moe_shardings`` on a 4-device ep mesh) and
``test_transformer_moe_matches_unsharded`` (the MoE transformer's step on
a dp 2 × ep 4 mesh). The port runs ``moe.moe_ffn_parallel`` and
``models/tp_lm.py`` with every ep rank in this process
(``Axes.in_process(ep=...)``), and over 2-rank gloo worlds at ep 2 and at
dp 2 (``tests/torch_dist_worker.py`` scenario ``tp_train``); the
gradients merged from the ep ranks (the router's: the local experts'
combine parts summed over ep, the aux part once) are held to JAX's
``jax.grad`` on the same weights. f32: outputs within JAX's own bounds
(1e-4 relative and 1e-5 absolute; the aux 1e-5), losses 1e-5 relative,
each gradient leaf within 1e-4 of its largest entry. ``train_cli --ep``
and ``--n-experts`` on a dp or an sp world are held to one rank's run;
MoE with ``--sp`` has no refusal of its own (on one process the CLI
fails only as JAX's mesh plan fails), and an in-process sp 2 step gives
the unsplit loss. Each sequence's routing across sp ranks is
``tests/test_torch_moe_sp.py``'s.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.models import train_cli as jtrain_cli  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.parallel import mesh as jmesh  # noqa: E402
from container_engine_accelerators_tpu.parallel import moe as jmoe  # noqa: E402
from container_engine_accelerators_tpu_torch.models import tp_lm  # noqa: E402
from container_engine_accelerators_tpu_torch.models import train_cli  # noqa: E402
from container_engine_accelerators_tpu_torch.models import transformer as ttf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import moe as tmoe  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import (  # noqa: E402
    tensor_parallel as tpar,
)

D = 16
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# JAX's test_transformer_moe_matches_unsharded configuration.
MOE_SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=64, max_seq_len=32, dtype="float32",
                 n_experts=4, capacity_factor=4.0)


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
        jax.random.PRNGKey(0), D, 32, 8, dtype=jnp.float32))


def _split_experts(params, ep):
    return [{"router": torch.as_tensor(params["router"]),
             "w1": torch.as_tensor(params["w1"]).chunk(ep)[r].clone(),
             "w2": torch.as_tensor(params["w2"]).chunk(ep)[r].clone()}
            for r in range(ep)]


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("shape", [(16, D), (2, 6, D)], ids=["flat",
                                                             "grouped"])
def test_ep_sharded_ffn_matches_jax(ep, shape):
    """JAX's ``moe_shardings`` on an ep mesh against every ep rank's
    experts in this process: each rank's output and aux are the whole
    unsharded result."""
    params = moe_params()
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:ep]), ("ep",))
    sharded = jax.device_put(params, jmoe.moe_shardings(mesh))
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_ffn(
        x, p, top_k=2, capacity_factor=4.0))(
        sharded, jax.device_put(x, NamedSharding(mesh, P())))
    ys, auxes = tmoe.moe_ffn_parallel(
        [torch.as_tensor(x)] * ep, _split_experts(params, ep),
        tpar.Axes.in_process(ep=ep), top_k=2, capacity_factor=4.0)
    for y, aux in zip(ys, auxes):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["roomy", "dropping"])
def test_ep_gradients_sum_to_jax_s_unsharded(cf):
    """``(y ** 2).mean() + 0.01 · aux`` (JAX's gradient test) through ep 4:
    the experts' gradients concatenated, the router's and x's (local
    combine parts reduced over ep, the aux part once) equal to
    ``jax.grad`` of the unsharded FFN, with and without dropped
    tokens."""
    params = moe_params()
    x = np.random.default_rng(2).standard_normal((8, D), dtype=np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(x, p, top_k=2, capacity_factor=cf)
        return (y ** 2).mean() + 0.01 * aux

    want, want_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    ep = 4
    parts = _split_experts(params, ep)
    for p in parts:
        for t in p.values():
            t.requires_grad_()
    xs = [torch.as_tensor(x).clone().requires_grad_() for _ in range(ep)]
    ys, auxes = tmoe.moe_ffn_parallel(xs, parts, tpar.Axes.in_process(ep=ep),
                                      top_k=2, capacity_factor=cf)
    sum((y ** 2).mean() + 0.01 * a for y, a in zip(ys, auxes)).backward()
    got = {"router": parts[0]["router"].grad.numpy(),
           "w1": torch.cat([p["w1"].grad for p in parts]).numpy(),
           "w2": torch.cat([p["w2"].grad for p in parts]).numpy()}
    for p in parts[1:]:
        np.testing.assert_array_equal(p["router"].grad.numpy(),
                                      got["router"])
    assert_grads_close(got, want, f"cf {cf}")
    for xt in xs:
        assert_grads_close({"x": xt.grad.numpy()}, {"x": want_x}, "x")


def jax_moe_step(toks, dp, ep, shape=MOE_SHAPE):
    """(JAX's initial weights, loss and gradients of ``loss_fn`` and its
    ``make_train_step`` loss) on ``build_mesh(dp·ep, 1, 1, ep)``."""
    cfg = jtf.TransformerConfig(**shape)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.array, params)
    mesh = jtrain_cli.build_mesh(dp * ep, 1, 1, ep)
    sharded = jax.device_put(params, jtf.param_shardings(cfg, mesh))
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      NamedSharding(mesh, P("dp", None)))}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, b, cfg, mesh=mesh)))(sharded, batch)
    init, step = jtf.make_train_step(cfg, mesh=mesh)
    _, step_loss = step(init(jax.random.PRNGKey(0)), batch)
    return host, float(loss), jax.tree.map(np.asarray, grads), \
        float(step_loss)


def _toks(rows=4, seed=1):
    return np.random.default_rng(seed).integers(0, 64, (rows, 17))


@pytest.mark.parametrize("ep,dp,cf", [(4, 2, 4.0), (2, 1, 4.0),
                                      (4, 1, 1.25)],
                         ids=["dp2xep4", "ep2", "ep4_dropping"])
def test_in_process_moe_transformer_matches_jax(ep, dp, cf):
    """JAX's step on a dp × ep mesh (its
    ``test_transformer_moe_matches_unsharded`` at dp 2 × ep 4) against
    every ep rank in this process on the whole batch (a dp split changes
    no number: routing is per sequence)."""
    shape = dict(MOE_SHAPE, capacity_factor=cf)
    toks = _toks()
    host, jloss, jgrads, jstep = jax_moe_step(toks, dp, ep, shape)
    cfg = ttf.TransformerConfig(**shape)
    axes = tpar.Axes.in_process(ep=ep)
    init, step = tp_lm.make_train_step(cfg, axes, device="cpu")
    state = init(model=weights.params_from_jax(host, cfg, device="cpu"))
    state, loss = step(state, {"tokens": toks})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), jstep, rtol=LOSS_RTOL)
    assert_grads_close(weights.tp_to_jax(list(state[0]), axes, "grads"),
                       jgrads, f"ep {ep}")
    # Each rank holds E/ep experts.
    assert state[0][0].layers[0].ffn.w1.shape[0] == cfg.n_experts // ep


# -- gloo worlds ------------------------------------------------------------------

WORLD_CASES = {"ep2": (1, 2), "dp2": (2, 1)}


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    import pickle

    workdir = tmp_path_factory.mktemp("moe_ep")
    inputs, refs = {}, {}
    for name, (dp, ep) in WORLD_CASES.items():
        toks = _toks()
        host, jloss, jgrads, _ = jax_moe_step(toks, dp, ep)
        inputs[name] = {"model": "transformer", "cfg": MOE_SHAPE,
                        "params": host, "batch": {"tokens": toks}, "sp": 1,
                        "tp": 1, "ep": ep, "overlap": None}
        refs[name] = (jloss, jgrads)
    with open(workdir / "tp_in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return refs, worker.spawn("tp_train", 2, str(workdir))


@pytest.mark.parametrize("name", sorted(WORLD_CASES))
def test_gloo_world_matches_jax(moe_world, name):
    refs, ranks = moe_world
    jloss, jgrads = refs[name]
    for rank, outs in enumerate(ranks):
        got = outs[name]
        np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {rank}")
        assert_grads_close(got["grads"], jgrads, f"{name} rank {rank}")


# -- the CLI ------------------------------------------------------------------------

CLI = ["--model", "transformer", "--device", "cpu", "--d-model", "64",
       "--n-heads", "4", "--seq-len", "32", "--vocab-size", "128",
       "--steps", "2", "--dtype", "float32", "--n-experts", "4",
       "--batch-size", "4"]


@pytest.mark.parametrize("flags", [["--ep", "2"], [], ["--sp", "2"]],
                         ids=["ep2", "dp2", "sp2"])
def test_cli_moe_trains_on_two_ranks_as_one_rank_does(tmp_path, capsys,
                                                     flags):
    """The same global batch (``--batch-size 4``) on two ranks, split
    over ep 2's experts, dp 2's rows or sp 2's positions (each sequence
    routed whole across the two), and on one."""
    runs, markers = worker.cli_world(CLI + flags, str(tmp_path), "moe")
    assert [rc for rc, _, _ in runs] == [0, 0], runs[0][2][-2000:]
    assert train_cli.main(CLI) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for _, result, _ in runs:
        assert result["n_devices"] == 2 and result["steps_run"] == 2
        np.testing.assert_allclose(result["loss"], one["loss"],
                                   rtol=LOSS_RTOL)
    assert markers == [f"TPU_BOOTSTRAP_OK rank={r} world=2\n"
                       for r in range(2)]


def test_moe_with_sp_trains_in_process_as_unsplit():
    """No name refuses MoE with ``--sp`` any more: the transformer module
    holds no such refusal, one process's CLI fails only as JAX's mesh
    plan fails (one device does not factor into sp 2), and every sp rank
    of a step held in this process gives the unsplit loss."""
    assert not hasattr(ttf, "MoESequenceParallelError")
    assert not hasattr(ttf, "check_moe_mesh")
    with pytest.raises(ValueError, match="cannot factor 1 devices"):
        train_cli.main(CLI + ["--sp", "2"])
    with pytest.raises(ValueError, match="cannot factor 1 devices"):
        jmesh.plan_mesh(1, {"dp": -1, "sp": 2, "tp": 1})
    cfg = ttf.TransformerConfig(**MOE_SHAPE)
    batch = {"tokens": _toks()}
    want = ttf.loss_fn(ttf.init_params(cfg, device="cpu"), batch)
    init, step = tp_lm.make_train_step(cfg, tpar.Axes.in_process(sp=2),
                                       device="cpu")
    _, loss = step(init(seed=0), batch)
    np.testing.assert_allclose(float(loss), want.item(), rtol=LOSS_RTOL)
