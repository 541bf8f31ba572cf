# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Multi-process training of the port against the JAX package's train
steps on a 2-device mesh, and ``train_cli --distributed`` through the
env contract.

The step parity: a 2-process gloo world (``tests/torch_dist_worker.py``,
a ``file://`` rendezvous in the test's ``tmp_path``) runs the port's
``make_train_step(mesh=...)`` for the transformer at sp 2 (RoPE at
global positions, ring attention over the sp axis) and for mnist, bert
and resnet at dp 2 (ResNet's BatchNorm statistics summed over the dp
group), from JAX's initial weights, two steps on the same global
batches; losses and every parameter after the steps (ResNet's running
statistics too, and AdamW's moments for the transformer and bert) are
held to JAX's ``make_train_step`` on a 2-device mesh of the same axes
(``train_cli.build_mesh``), f32 throughout.

The CLI: two ``train_cli --distributed`` processes (``TPU_WORKER_ID`` 0,
``TPU_WORKER_HOSTNAMES`` localhost, ``LOCAL_RANK`` 0/1 of
``LOCAL_WORLD_SIZE`` 2) write their bootstrap markers, agree on every
loss, checkpoint from rank 0 only, and resume from it to the loss of a
straight run, also after a supervisor restart where each rank has a
checkpoint directory of its own; MoE trains on two ranks, and under
``--tp 2`` or ``--ep 2`` the shards checkpoint per shard and resume.
"""

import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.models import bert as jbert  # noqa: E402
from container_engine_accelerators_tpu.models import mnist as jmnist  # noqa: E402
from container_engine_accelerators_tpu.models import resnet as jresnet  # noqa: E402
from container_engine_accelerators_tpu.models import train_cli as jtrain_cli  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import bert as tbert  # noqa: E402
from container_engine_accelerators_tpu_torch.models import train_cli  # noqa: E402
from container_engine_accelerators_tpu_torch.utils import checkpointing  # noqa: E402

REPO = worker.REPO
STEPS = 2
TF_SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32")
BERT_SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  d_ff=128, max_seq_len=32, dtype="float32")
IMAGE = 32
# f32 on both sides, summed in other orders (ring blocks, per-rank
# partial sums): losses to 1e-5. After the steps a parameter has moved
# by lr-scaled updates: SGD (mnist, resnet) by lr · (a sum of
# gradients), so the summation-order noise stays near 1e-5; Adam (the
# transformer, bert) by about lr · sign(m / sqrt(v)) a step, so an entry
# whose gradient is near eps may move differently: 2 · lr, as the
# single-device parity tests allow. ResNet's running statistics to 1e-5.
LOSS_ATOL = 1e-5
PARAM_ATOL = {"transformer": 2 * 3e-4, "bert": 2 * 1e-4, "mnist": 1e-5,
              "resnet": 1e-5}
STATS_ATOL = 1e-5
# The 2·lr parameter bound barely sees the gradients' size (Adam's first
# steps move by about lr · sign(g)), so for the AdamW models AdamW's
# moments after the steps (optax's mu and nu, linear in the gradients
# and in their squares) are held too: each leaf within 1e-4 of its
# largest entry. Readings on the CPU: at most 2.7e-6 (mu) and 4.3e-6
# (nu) for the transformer, 1.1e-6 and 1.9e-6 for bert; a gradient of
# twice its size reads 1 or more.
MOMENT_RTOL = 1e-4
ADAM_MODELS = ("transformer", "bert")


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _assert_trees_close(got, ref, atol, what):
    got, ref = _leaves(got), _leaves(ref)
    assert sorted(got) == sorted(ref), what
    for path, want in ref.items():
        np.testing.assert_allclose(got[path], want, atol=atol, rtol=0,
                                   err_msg=f"{what} {path}")


def _assert_moments_close(got, ref, rtol, what):
    """Each leaf within ``rtol`` of its largest |entry| (a moment's scale
    is its gradient's, or the square of it)."""
    got, ref = _leaves(got), _leaves(ref)
    assert sorted(got) == sorted(ref), what
    for path, want in ref.items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=rtol * scale + 1e-30,
                                   err_msg=f"{what} {path}")


def _sharded(mesh, batch, spec):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec(v)))
            for k, v in batch.items()}


def _rows(v):
    return P("dp", *[None] * (v.ndim - 1))


def _transformer_case():
    cfg = jtf.TransformerConfig(**TF_SHAPE)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 33))}
               for _ in range(STEPS)]
    mesh = jtrain_cli.build_mesh(2, 2, 1)
    init, step = jtf.make_train_step(cfg, mesh=mesh)
    return {"model": "transformer", "sp": 2, "cfg": TF_SHAPE,
            "params": params, "batches": batches}, mesh, init, step


def _mnist_case(sp=1):
    params = jmnist.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    batches = [{"images": rng.standard_normal((8, 28, 28, 1),
                                              dtype=np.float32),
                "labels": rng.integers(0, 10, 8)} for _ in range(STEPS)]
    mesh = jtrain_cli.build_mesh(2, sp, 1)
    init, step = jmnist.make_train_step(mesh=mesh)
    return {"model": "mnist", "sp": sp, "params": params,
            "batches": batches}, mesh, init, step


def _bert_case(sp=1):
    cfg = jbert.BertConfig(**BERT_SHAPE)
    params = jbert.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(13)
    batches = [{k: v.numpy() for k, v in tbert.synthetic_mlm_batch(
        rng, 4, tbert.BertConfig(**BERT_SHAPE)).items()}
        for _ in range(STEPS)]
    mesh = jtrain_cli.build_mesh(2, sp, 1)
    init, step = jbert.make_train_step(cfg, mesh=mesh)
    return {"model": "bert", "sp": sp, "cfg": BERT_SHAPE, "params": params,
            "batches": batches}, mesh, init, step


def _resnet_case(sp=1):
    model = jresnet.ResNet([1, 1], 10, jnp.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, IMAGE, IMAGE, 3)), train=False)
    # Non-trivial statistics and BN scales (the last BN of each block
    # starts at 0, which would hide its branch from the gradients).
    rng = np.random.default_rng(5)
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        variables["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
                         if jax.tree_util.keystr(path).endswith("['scale']")
                         else a),
        variables["params"])
    batches = [{"images": rng.standard_normal((4, IMAGE, IMAGE, 3),
                                              dtype=np.float32),
                "labels": rng.integers(0, 10, 4)} for _ in range(STEPS)]
    mesh = jtrain_cli.build_mesh(2, sp, 1)
    _, step = jresnet.make_train_step(model, mesh=mesh, image_size=IMAGE)

    def init(_key):
        rep = NamedSharding(mesh, P())
        return (jax.device_put(params, rep), jax.device_put(stats, rep),
                optax.sgd(0.1, momentum=0.9, nesterov=True).init(params))
    return {"model": "resnet", "sp": sp, "params": params,
            "batch_stats": stats, "batches": batches}, mesh, init, step


# The sp 2 cases of mnist, bert and resnet: a {"dp": 1, "sp": 2} mesh,
# whose sp ranks are replicas (JAX shards those batches over dp alone), so
# the port must not sum their gradients over sp.
CASES = {"transformer_sp2": _transformer_case, "mnist_dp2": _mnist_case,
         "bert_dp2": _bert_case, "resnet_dp2": _resnet_case,
         "mnist_sp2": lambda: _mnist_case(sp=2),
         "bert_sp2": lambda: _bert_case(sp=2),
         "resnet_sp2": lambda: _resnet_case(sp=2)}


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    """JAX's runs of every case, and the port's 2-rank world on the same
    weights and batches."""
    workdir = tmp_path_factory.mktemp("train")
    jax_runs, inputs = {}, {}
    for name, build in CASES.items():
        case, mesh, init, step = build()
        # Copied out before JAX's step donates (deletes) its state.
        inputs[name] = {k: (jax.tree.map(np.array, v)
                            if k in ("params", "batch_stats") else v)
                        for k, v in case.items()}
        spec = (lambda v: P("dp", None)) \
            if case["model"] == "transformer" else _rows
        state = init(jax.random.PRNGKey(0))
        losses = []
        for batch in case["batches"]:
            state, loss = step(state, _sharded(mesh, batch, spec))
            losses.append(float(loss))
        jax_runs[name] = {"losses": losses, "state": state}
    with open(workdir / "train_in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return jax_runs, worker.spawn("train", 2, str(workdir))


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_jax_train_step_on_a_2_device_mesh(train_world,
                                                           name):
    jax_runs, ranks = train_world
    ref = jax_runs[name]
    model = name.split("_")[0]
    for rank, outs in enumerate(ranks):
        got = outs[name]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   atol=LOSS_ATOL, rtol=0,
                                   err_msg=f"{name} rank {rank}")
        _assert_trees_close(got["params"], ref["state"][0],
                            PARAM_ATOL[model], f"{name} rank {rank}")
        if model == "resnet":
            _assert_trees_close(got["batch_stats"], ref["state"][1],
                                STATS_ATOL, f"{name} rank {rank} stats")
        if model in ADAM_MODELS:
            adam = ref["state"][1][0]
            for key in ("mu", "nu"):
                _assert_moments_close(got[key], getattr(adam, key),
                                      MOMENT_RTOL,
                                      f"{name} rank {rank} {key}")
    # Every rank ends with the same replicated weights and loss.
    for path, leaf in _leaves(ranks[1][name]["params"]).items():
        np.testing.assert_array_equal(
            leaf, _leaves(ranks[0][name]["params"])[path], err_msg=path)
    assert ranks[0][name]["losses"] == ranks[1][name]["losses"]


# -- train_cli --distributed ---------------------------------------------------

CLI_FLAGS = ["--model", "transformer", "--device", "cpu", "--d-model", "64",
             "--n-heads", "4", "--n-layers", "2", "--seq-len", "32",
             "--vocab-size", "128", "--dtype", "float32", "--sp", "2"]


_cli_world = worker.cli_world


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Three steps of the 2-rank CLI world without checkpoints."""
    runs, _ = _cli_world([*CLI_FLAGS, "--steps", "3"],
                         tmp_path_factory.mktemp("straight"), "straight")
    for rc, _, err in runs:
        assert rc == 0, err
    return runs


def test_distributed_cli_bootstraps_checkpoints_on_rank_0_and_resumes(
        tmp_path, straight):
    ckpt = tmp_path / "ckpt"
    first, markers = _cli_world(
        [*CLI_FLAGS, "--steps", "2", "--checkpoint-dir", str(ckpt),
         "--checkpoint-every", "1"], tmp_path, "first")
    for rank, (rc, result, err) in enumerate(first):
        assert rc == 0, err
        assert markers[rank] == f"TPU_BOOTSTRAP_OK rank={rank} world=2\n"
        assert result["n_devices"] == 2 and result["steps_run"] == 2
        # JAX's default batch scales with dp (1 here: the world is sp 2).
        assert result["batch_size"] == 2
    assert first[0][1]["loss"] == first[1][1]["loss"]
    assert sorted(os.listdir(ckpt)) == ["step_1", "step_2"]
    resumed, _ = _cli_world(
        [*CLI_FLAGS, "--steps", "3", "--checkpoint-dir", str(ckpt)],
        tmp_path, "resumed")
    for (rc, result, err), (_, ref, _) in zip(resumed, straight):
        assert rc == 0, err
        assert result["start_step"] == 2 and result["steps_run"] == 1
        assert "resumed from" in err
        assert result["loss"] == ref["loss"]
    assert sorted(os.listdir(ckpt)) == ["step_1", "step_2", "step_3"]


def test_distributed_cli_restarts_every_rank_from_rank_0_s_own_dir(
        tmp_path, straight):
    """Each rank has a checkpoint directory of its own, as JAX's
    multislice manifest mounts ``--checkpoint-dir`` in each host's
    container. A preemption before the second step on every rank and the
    in-process supervisor's restart resume every rank from rank 0's step
    1 (the others' directories hold nothing) into the same collectives,
    to the loss of a straight run."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"kind": "preemption", "site": "train.step", "at": 1}]}))
    runs, _ = _cli_world(
        lambda rank: [*CLI_FLAGS, "--steps", "3", "--checkpoint-dir",
                      str(tmp_path / f"ckpt{rank}"), "--checkpoint-every",
                      "1", "--max-restarts", "1", "--restart-backoff-s",
                      "0.001", "--fault-plan", str(plan)],
        tmp_path, "own", timeout=120)
    for (rc, result, err), (_, ref, _) in zip(runs, straight):
        assert rc == 0, err
        assert result["restarts"] == 1 and result["start_step"] == 1
        assert result["steps_run"] == 2 and "resumed from" in err
        assert result["loss"] == ref["loss"]
    assert sorted(os.listdir(tmp_path / "ckpt0")) == [
        "step_1", "step_2", "step_3"]
    assert not (tmp_path / "ckpt1").exists() or \
        not os.listdir(tmp_path / "ckpt1")


def test_distributed_cli_trains_moe_on_two_ranks(tmp_path):
    """MoE routes per sequence, so it trains data-parallel: both ranks
    print the same loss (tests/test_torch_moe_ep.py holds it to JAX)."""
    runs, markers = _cli_world(
        ["--model", "transformer", "--device", "cpu", "--d-model", "64",
         "--n-heads", "4", "--seq-len", "32", "--vocab-size", "128",
         "--n-experts", "2", "--steps", "1"], tmp_path, "moe")
    for rank, (rc, result, err) in enumerate(runs):
        assert rc == 0, err
        assert result["n_devices"] == 2 and np.isfinite(result["loss"])
        assert markers[rank] == f"TPU_BOOTSTRAP_OK rank={rank} world=2\n"
    assert runs[0][1]["loss"] == runs[1][1]["loss"]


@pytest.mark.parametrize("flags", [["--tp", "2"],
                                   ["--ep", "2", "--n-experts", "4"]],
                         ids=["tp2", "ep2"])
def test_sharded_cli_checkpoints_per_shard_and_resumes(tmp_path, flags):
    """Under a tp or ep axis each shard's rank (dp index 0) writes
    ``tp_<t>_ep_<e>/step_<N>``; a resume restores every shard at the
    oldest newest step and reaches the loss of a straight run."""
    argv = [*CLI_FLAGS[:-2], *flags]
    straight_runs, _ = _cli_world([*argv, "--steps", "3"], tmp_path,
                                  "straight")
    ckpt = tmp_path / "ckpt"
    first, _ = _cli_world([*argv, "--steps", "2", "--checkpoint-dir",
                           str(ckpt), "--checkpoint-every", "1"],
                          tmp_path, "first")
    for rc, _, err in first + straight_runs:
        assert rc == 0, err
    dirs = ["tp_0_ep_0", "tp_1_ep_0"] if "--tp" in flags else \
        ["tp_0_ep_0", "tp_0_ep_1"]
    assert sorted(os.listdir(ckpt)) == dirs
    for d in dirs:
        assert sorted(os.listdir(ckpt / d)) == ["step_1", "step_2"]
    # One shard a step behind: the world resumes at the older step.
    checkpointing.quarantine(str(ckpt / dirs[1]), 2)
    resumed, _ = _cli_world([*argv, "--steps", "3", "--checkpoint-dir",
                             str(ckpt)], tmp_path, "resumed")
    for (rc, result, err), (_, ref, _) in zip(resumed, straight_runs):
        assert rc == 0, err
        assert result["start_step"] == 1 and result["steps_run"] == 2
        assert result["loss"] == ref["loss"]


def test_sp_on_one_rank_fails_as_jax_s_plan_does():
    with pytest.raises(ValueError, match="cannot factor 1 devices"):
        train_cli.main(["--model", "transformer", "--device", "cpu",
                        "--sp", "2"])
