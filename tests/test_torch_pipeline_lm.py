# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's pipeline-parallel decoder training (``models/pipeline_lm.py``)
against the JAX package's and against the port's unsplit step, and
``train_cli --pp``.

On ``tests/test_pipeline_lm.py``'s ``tiny_cfg`` (f32) and JAX's own
parameters (``init_state`` of JAX's ``make_pp_train_step``, merged and
bridged by ``weights.pp_params_from_jax``): three pp steps under the
``InProcess`` transport give JAX's losses (1e-5) and parameters (2·lr,
AdamW's per-step move, as the other AdamW parity tests allow); the same
steps equal the port's unsplit ``make_train_step`` on the flattened
batch; the tied embedding's gradient is the head part plus the lookup
part; ``split_params``/``merge_params`` round-trip; MoE is refused.

The CLI: ``--pp 2`` over a 2-rank gloo world (``tests/
torch_dist_worker.py``'s ``cli_world``) checkpointed at step 2 and
resumed gives the uninterrupted run's loss exactly; ``--pp 4`` on a world
of one and ``--pp`` with ``--sp`` are refused with JAX's texts.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.models import pipeline_lm as jpp  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import pipeline_lm  # noqa: E402
from container_engine_accelerators_tpu_torch.models import train_cli  # noqa: E402
from container_engine_accelerators_tpu_torch.models import transformer as tf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel.pipeline import (  # noqa: E402
    pipeline_train_1f1b,
)
from container_engine_accelerators_tpu_torch.parallel.ring_attention import (  # noqa: E402
    InProcess,
)

SHAPE = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=16, dtype="float32")
STEPS = 3
LOSS_ATOL = 1e-5
PARAM_ATOL = 2 * 3e-4
GRAD_ATOL = 1e-4


def _tokens(n_micro=4, mb=2, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SHAPE["vocab_size"], (n_micro, mb, seq + 1))


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("pp",))


def _jax_start(n_stages):
    """JAX's pp step and its initial state from ``init_state``."""
    cfg = jtf.TransformerConfig(**SHAPE)
    init_state, step = jpp.make_pp_train_step(cfg, _mesh(n_stages),
                                              attn_impl="xla")
    return init_state(jax.random.PRNGKey(0)), step


def _port_model(jstate):
    stages, lp = jax.tree.map(np.asarray, (jstate[0], jstate[1]))
    return weights.pp_params_from_jax(stages, lp, tf.TransformerConfig(
        **SHAPE), device="cpu")


def _assert_tree_close(got, ref, atol, what):
    flat_got, flat_ref = jax.tree.leaves(got), jax.tree.leaves(ref)
    assert len(flat_got) == len(flat_ref)
    for a, b in zip(flat_got, flat_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=0, err_msg=what)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pp_steps_match_jax_make_pp_train_step(n_stages):
    jstate, jstep = _jax_start(n_stages)
    model = _port_model(jstate)
    init, step = pipeline_lm.make_pp_train_step(
        tf.TransformerConfig(**SHAPE), InProcess(n_stages), device="cpu")
    state = init(model=model)
    tokens = _tokens()
    losses, jlosses = [], []
    for _ in range(STEPS):
        state, loss = step(state, {"tokens": tokens})
        losses.append(float(loss))
        jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_ATOL, rtol=0)
    ref = jax.tree.map(np.asarray, (jstate[0], jstate[1]))
    got = weights.pp_split_jax(weights.params_to_jax(model), n_stages)
    _assert_tree_close(got, ref, PARAM_ATOL, "parameters after 3 steps")


def test_pp_steps_match_the_unsplit_step():
    jstate, _ = _jax_start(2)
    pp_model, flat_model = _port_model(jstate), _port_model(jstate)
    cfg = tf.TransformerConfig(**SHAPE)
    init, step = pipeline_lm.make_pp_train_step(cfg, InProcess(2),
                                                device="cpu")
    init1, step1 = tf.make_train_step(cfg, device="cpu")
    state, state1 = init(model=pp_model), init1(model=flat_model)
    for k in range(STEPS):
        tokens = _tokens(seed=10 + k)
        state, loss = step(state, {"tokens": tokens})
        state1, loss1 = step1(state1, {"tokens": tokens.reshape(
            -1, tokens.shape[-1])})
        assert abs(float(loss) - float(loss1)) < LOSS_ATOL
        if k == 0:
            _assert_tree_close(weights.grads_to_jax(pp_model),
                               weights.grads_to_jax(flat_model), GRAD_ATOL,
                               "first step's gradients")
    _assert_tree_close(weights.params_to_jax(pp_model),
                       weights.params_to_jax(flat_model), PARAM_ATOL,
                       "parameters after 3 steps")


def test_tied_embedding_gradient_is_head_plus_lookup():
    """JAX's check on the port: the pipeline's loss-parameter gradient
    for ``embed`` (the head use) plus its input cotangent pulled through
    the lookup is the unsplit model's ``embed`` gradient; the stage and
    ``ln_f`` gradients are the unsplit ones too."""
    n_stages = 2
    jstate, _ = _jax_start(n_stages)
    model = _port_model(jstate)
    stages, lp = pipeline_lm.split_params(model, n_stages)
    tokens = torch.as_tensor(_tokens())
    inputs, targets = tokens[..., :-1], tokens[..., 1:]
    with torch.no_grad():
        x_micro = model.embed[inputs]
    loss, sgrads, lp_grads, dx = pipeline_train_1f1b(
        pipeline_lm._stage_fn, pipeline_lm._loss_fn, stages, x_micro, targets,
        InProcess(n_stages), loss_params=lp, return_dx=True)
    model.zero_grad(set_to_none=True)
    ref = tf.loss_fn(model, {"tokens": tokens.reshape(-1, 17)})
    ref.backward()
    assert abs(float(loss) - ref.item()) < LOSS_ATOL
    lookup = torch.zeros_like(model.embed).index_add_(
        0, inputs.reshape(-1), dx.reshape(-1, SHAPE["d_model"]))
    head = lp_grads["embed"]
    assert head.abs().max() > 0 and lookup.abs().max() > 0
    torch.testing.assert_close(head + lookup, model.embed.grad,
                               atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(lp_grads["ln_f"], model.ln_f.weight.grad,
                               atol=GRAD_ATOL, rtol=0)
    for stage, grads in zip(stages, sgrads):
        for p, g in zip(stage.parameters(), grads):
            torch.testing.assert_close(g, p.grad, atol=GRAD_ATOL, rtol=0)


def test_split_merge_round_trip_and_jax_layout():
    jstate, _ = _jax_start(2)
    model = _port_model(jstate)
    stages, lp = pipeline_lm.split_params(model, 2)
    assert [len(s) for s in stages] == [2, 2]
    assert lp["embed"] is model.embed and lp["ln_f"] is model.ln_f.weight
    merged = pipeline_lm.merge_params(stages, lp)
    assert merged.cfg == model.cfg
    assert [id(p) for p in merged.parameters()] == \
        [id(p) for p in model.parameters()]
    # The port's split of the bridged model is JAX's split, leaf for leaf.
    ref = jax.tree.map(np.asarray, (jstate[0], jstate[1]))
    got = weights.pp_split_jax(weights.params_to_jax(merged), 2)
    _assert_tree_close(got, ref, 0.0, "split of the bridged model")
    with pytest.raises(ValueError, match="must divide over 3 stages"):
        pipeline_lm.split_params(model, 3)


def test_pp_rejects_moe():
    cfg = dataclasses.replace(tf.TransformerConfig(**SHAPE), n_experts=4)
    with pytest.raises(ValueError, match="dense"):
        pipeline_lm.make_pp_train_step(cfg, InProcess(2), device="cpu")


CLI_FLAGS = ["--model", "transformer", "--pp", "2", "--device", "cpu",
             "--batch-size", "2", "--seq-len", "32", "--d-model", "64",
             "--n-layers", "4", "--n-heads", "4", "--vocab-size", "128",
             "--dtype", "float32"]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Three steps of ``--pp 2`` on two gloo ranks, no checkpoints."""
    runs, _ = worker.cli_world([*CLI_FLAGS, "--steps", "3"],
                               tmp_path_factory.mktemp("pp_straight"),
                               "straight")
    for rc, _, err in runs:
        assert rc == 0, err
    return runs


def test_train_cli_pp_checkpoints_each_stage_and_resumes(tmp_path,
                                                         straight):
    """JAX's ``test_train_cli_pp`` on two gloo ranks: two steps
    checkpointed (every stage its own directory), then a resumed run of
    one more step from step 2 gives the straight run's loss exactly."""
    ckpt = tmp_path / "ckpt"
    first, markers = worker.cli_world(
        [*CLI_FLAGS, "--steps", "2", "--checkpoint-dir", str(ckpt),
         "--checkpoint-every", "2"], tmp_path, "first")
    for rank, (rc, result, err) in enumerate(first):
        assert rc == 0, err
        assert markers[rank] == f"TPU_BOOTSTRAP_OK rank={rank} world=2\n"
        assert result["steps_run"] == 2 and result["microbatches"] == 4
        assert result["microbatch_size"] == 2 and result["n_devices"] == 2
        assert "batch_size" not in result
    assert sorted(os.listdir(ckpt)) == ["stage_0", "stage_1"]
    assert os.listdir(ckpt / "stage_1") == ["step_2"]
    resumed, _ = worker.cli_world(
        [*CLI_FLAGS, "--steps", "3", "--checkpoint-dir", str(ckpt)],
        tmp_path, "resumed")
    for (rc, result, err), (_, ref, _) in zip(resumed, straight):
        assert rc == 0, err
        assert result["start_step"] == 2 and result["steps_run"] == 1
        assert result["loss"] == ref["loss"]
    assert resumed[0][1]["loss"] == resumed[1][1]["loss"]


def test_train_cli_pp_survives_a_preemption_under_the_supervisor(
        tmp_path, straight):
    """A preemption before the second step on every rank: the in-process
    supervisor restarts each stage from its own step 1 into the same
    schedule, to the straight run's loss; the event log gives the
    goodput block."""
    plan = tmp_path / "plan.json"
    plan.write_text('{"faults": [{"kind": "preemption", '
                    '"site": "train.step", "at": 1}]}')
    runs, _ = worker.cli_world(
        lambda rank: [*CLI_FLAGS, "--steps", "3", "--checkpoint-dir",
                      str(tmp_path / "ckpt"), "--checkpoint-every", "1",
                      "--max-restarts", "1", "--restart-backoff-s", "0.001",
                      "--fault-plan", str(plan), "--event-log",
                      str(tmp_path / f"ev{rank}.jsonl")],
        tmp_path, "supervised", timeout=120)
    for (rc, result, err), (_, ref, _) in zip(runs, straight):
        assert rc == 0, err
        assert result["restarts"] == 1 and result["start_step"] == 1
        assert result["steps_run"] == 2 and result["loss"] == ref["loss"]
        assert "goodput" in result


def test_train_cli_pp_on_a_world_of_one_is_refused_with_jax_s_text(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--model", "transformer", "--device", "cpu",
                        "--pp", "4"])
    assert "--pp=4 needs 4 devices, have 1" in capsys.readouterr().err


@pytest.mark.parametrize("flags,text", [
    (["--model", "transformer", "--sp", "2"],
     "--pp is exclusive with --sp/--tp/--ep"),
    (["--model", "bert"], "--pp supports --model transformer only"),
])
def test_train_cli_pp_refusals(flags, text, capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--pp", "2", *flags])
    assert text in capsys.readouterr().err
