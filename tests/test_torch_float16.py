# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""float16 end to end: the port against the JAX package on the CPU.

JAX takes any dtype name (``TransformerConfig.jdtype`` reads it through
``jnp.dtype``) and its Pallas kernels keep their operands in the input
dtype, so float16 runs wherever bf16 does. The port takes ``float16``
beside ``bfloat16`` and ``float32``: the flash kernels, ``int8_mm`` and
both CLIs. Held here, on inputs made from numpy seeds:

  * the plain f16 flash forward, dq and dk/dv (the functions the CUDA
    kernels are held to on the card) against JAX's ``_flash_fwd`` /
    ``_flash_bwd`` in interpret mode, at D 64 and D 288;
  * ``int8_mm_reference`` with f16 activations against ``_chunk_mm``;
  * greedy ``transformer.generate`` and the paged engine's tokens at
    ``dtype="float16"`` (JAX's paged seams made synchronous);
  * a training step's loss and gradients, transformer and BERT;
  * a defect of the reference that the port shares (ROADMAP "Defects of
    the reference"): AdamW's eps 1e-8 is 0 in float16 and a second moment
    under f16's smallest value is 0, so after one step every parameter
    entry with a zero second moment is ±inf (NaN where the first moment is
    0 too), in both packages, and the second step's loss is NaN;
  * ``serve_cli`` and ``train_cli`` parsing ``--dtype float16``.

About 35-48 s alone on a shared CPU, most of it JAX compiling the
paged engine, the Pallas kernels in interpret mode and the steps.

f16 keeps 11 significant bits: a rounding moves a value by at most 2^-11
of it (2^-10 between neighbours), eight times finer than bf16's 2^-8. Each
tolerance below is the bf16 one of the matching test, scaled by that, or
the observed spread with room, as its comment says.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from container_engine_accelerators_tpu.models import bert as jbert  # noqa: E402
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.ops import attention as jattn  # noqa: E402
from container_engine_accelerators_tpu.parallel import overlap as joverlap  # noqa: E402
from container_engine_accelerators_tpu_torch.models import bert as tbert  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serving_graphs,
    train_cli,
    weights,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.ops import _ext  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import (  # noqa: E402
    attention as tattn,
)
from container_engine_accelerators_tpu_torch.ops import int8_matmul  # noqa: E402

# The forward's out: both round p to f16 at different running maxima (JAX
# per 128-key tile, the plain version per row) and round out once: about
# one f16 step (observed <= 4.9e-4 at |out| ~1; bf16's test holds 1e-2).
OUT_TOL = 2e-3
LSE_ATOL = 1e-5  # f32 on both sides (observed 4.8e-7)
# dq, rounded once on both sides from the same f16 p and ds: within one
# f16 step of |dq| up to 3 (observed 4.9e-4; bf16's test 2e-3).
DQ_ATOL, DQ_RTOL = 2e-3, 2.0 ** -10
# dk/dv: JAX rounds each q head's sum and the group sum, the port once
# after the group sum: a few f16 steps (observed 7.8e-3 at |dv| 9.8, one
# step there; bf16's test 5e-2 + 2e-2 relative, scaled by 1/8).
DKV_ATOL, DKV_RTOL = 6e-3, 3e-3

# (B, Hq, Hkv, Sq, Sk, D), causal, kwargs: D 64 (the D 64 kernel) with a
# GQA group and a kv_len tail, D 288 (the wide kernels) with a q_base.
ATTN_CASES = {
    "d64_noncausal_kv_len": ((1, 2, 1, 128, 256, 64), False,
                             {"kv_len": 200}),
    "d288_causal_q_base": ((1, 2, 1, 128, 256, 288), True, {"q_base": 128}),
}


def _inputs(seed, batch, hq, hkv, seq_q, seq_k, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((batch, hq, seq_q, d), (batch, hkv, seq_k, d),
                          (batch, hkv, seq_k, d), (batch, hq, seq_q, d))]


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_plain_flash_f16_matches_jax_pallas(name):
    """The forward on the same f16 inputs; the backward on JAX's forward
    outputs, so that each gradient is held alone."""
    shape, causal, kw = ATTN_CASES[name]
    q, k, v, g = _inputs(len(name), *shape)
    sm_scale = shape[-1] ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a, jnp.float16) for a in (q, k, v, g))
    blocks = dict(block_q=128, block_k=128, interpret=True)
    j_out, j_lse = jattn._flash_fwd(jq, jk, jv, causal=causal,
                                    sm_scale=sm_scale, **blocks, **kw)
    j_grads = jattn._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal=causal,
                               sm_scale=sm_scale, **blocks, **kw)
    tq, tk, tv, tg = (torch.from_numpy(a).half() for a in (q, k, v, g))
    out, lse = tattn.flash_fwd(tq, tk, tv, causal=causal, sm_scale=sm_scale,
                               **kw)
    assert out.dtype == torch.float16 and j_out.dtype == jnp.float16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out, np.float32), atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse),
                               atol=LSE_ATOL, rtol=0)
    grads = tattn.flash_bwd(
        tq, tk, tv, torch.from_numpy(np.asarray(j_out, np.float32)).half(),
        torch.from_numpy(np.array(j_lse)), tg, causal=causal,
        sm_scale=sm_scale, **kw)
    kv_len = kw.get("kv_len", shape[4])
    for grad_name, got, want in zip(("dq", "dk", "dv"), grads, j_grads):
        assert got.dtype == torch.float16, grad_name
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.isfinite(got).all(), grad_name
        if grad_name == "dq":
            np.testing.assert_allclose(got, want, atol=DQ_ATOL, rtol=DQ_RTOL,
                                       err_msg=grad_name)
            continue
        # Keys past kv_len: the true gradient 0; JAX leaves values there.
        assert not got[:, :, kv_len:].any(), grad_name
        np.testing.assert_allclose(got[:, :, :kv_len], want[:, :, :kv_len],
                                   atol=DKV_ATOL, rtol=DKV_RTOL,
                                   err_msg=grad_name)


@pytest.mark.parametrize("out_dtype", ["float16", "float32"])
def test_int8_mm_reference_f16_matches_chunk_mm(out_dtype):
    """JAX ``_chunk_mm``: (x @ q.astype(f16)) accumulated in f32, times the
    channel scale, one cast. Both sum exact int8 x f16 products in f32: the
    f16 output within one f16 step where the f32 sums round to neighbours
    (observed 1.2e-7 at |y| 32), the f32 output to summation order
    (observed 5.7e-6)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 256)).astype(np.float16)
    q = rng.integers(-127, 128, (256, 96)).astype(np.int8)
    scale = (rng.random(96) * 0.01).astype(np.float32)
    want = joverlap._chunk_mm(
        jnp.asarray(x), {"q": jnp.asarray(q), "scale": jnp.asarray(scale[None])},
        getattr(jnp, out_dtype))
    got = int8_matmul.int8_mm_reference(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(q.T)),
        torch.from_numpy(scale), out_dtype=getattr(torch, out_dtype))
    assert str(got.dtype) == f"torch.{out_dtype}"
    tol = (dict(atol=0, rtol=2.0 ** -10) if out_dtype == "float16"
           else dict(atol=1e-4, rtol=0))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    with pytest.raises(ValueError, match="float64"):
        int8_matmul.int8_mm_reference(torch.zeros(2, 256, dtype=torch.float64),
                                      torch.from_numpy(q.T.copy()),
                                      torch.from_numpy(scale))


SERVE_SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float16")


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def serving_pair():
    """(JAX Model, port Model) on JAX's f16 init weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SERVE_SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SERVE_SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        _f32(jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


def test_f16_weights_bridge_exactly(serving_pair):
    """f16 → f32 → f16 is exact: the port holds JAX's f16 weights bit for
    bit, and its config names the dtype as JAX does."""
    jmodel, tmodel = serving_pair
    assert tmodel.model.cfg.torch_dtype == torch.float16
    for name, leaf in weights.params_to_jax(tmodel.model).items():
        if name == "layers":
            continue
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(jmodel.params[name]))
    with pytest.raises(KeyError, match="float64"):
        ttf.TransformerConfig(dtype="float64").torch_dtype


def test_greedy_generate_f16_matches_jax(serving_pair):
    """Greedy tokens equal; the f16 logits, rounded at other places by the
    two frameworks, within a few f16 steps (observed 8.5e-4 at |logit|
    0.57; bf16's test holds 2e-2)."""
    jmodel, tmodel = serving_pair
    cfg_j = jtf.TransformerConfig(**SERVE_SHAPE)
    toks = np.random.default_rng(13).integers(0, 256, (2, 13))
    ref = np.asarray(jtf.generate(jmodel.params, jnp.asarray(toks, jnp.int32),
                                  cfg_j, max_new_tokens=8))
    model = tmodel.model
    out = ttf.generate(model, torch.as_tensor(toks), max_new_tokens=8,
                       decoder=serving_graphs.DenseDecodeGraphs(model))
    np.testing.assert_array_equal(out.numpy(), ref)
    logits = ttf.forward(model, torch.as_tensor(toks)).detach().numpy()
    np.testing.assert_allclose(
        logits, np.asarray(jtf.forward(jmodel.params, jnp.asarray(toks),
                                       cfg_j)), atol=4e-3, rtol=0)


def _synchronous(fn):
    return lambda *args, **kwargs: jax.block_until_ready(fn(*args, **kwargs))


def test_paged_engine_f16_matches_jax_paged_engine(serving_pair):
    """The port's paged engine and JAX's (its device seams synchronous, as
    tests/test_torch_obs_serving.py runs it) on shared prefixes, a radix
    hit and a prompt prefilled in three segments: the same greedy
    tokens."""
    import threading

    jmodel, tmodel = serving_pair
    engine = dict(max_slots=2, chunk=4, prefill_chunk=16, kv_block_size=4,
                  kv_cache="paged")
    port = tserve.ContinuousEngine(tmodel, **engine)
    ref = jserve.ContinuousEngine(jmodel, start_loop=False, **engine)
    for seam in ("_paged_prefill", "_paged_chunk", "_copy_blocks"):
        setattr(ref, seam, _synchronous(getattr(ref, seam)))
    threading.Thread(target=ref._loop_paged, daemon=True).start()
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, 256, 12).tolist()
    prompts = [prefix + [3], prefix + [5, 7], rng.integers(1, 256, 40).tolist()]
    try:
        for prompt in prompts:
            (got,) = port.generate([prompt], 6)
            assert got == ref.generate([prompt], 6)[0], prompt
        assert port.kv_stats()["prefix_hit_tokens"] > 0
    finally:
        port.shutdown()
        ref.shutdown()


# Step 0 of training in f16 (JAX's XLA attention; its Pallas kernels are
# held above): every product and activation rounded to f16 at other places
# by the two frameworks (XLA's fusions, the port's flash p), carried
# through two layers' backward: observed relative L2 up to 3.0e-3 and
# largest error up to 4.1e-3 of the largest gradient, a few f16 steps.
# Loss: an f32 mean over f16 logits (observed 9.2e-5 apart).
GRAD_REL_L2, GRAD_MAX_REL = 5e-3, 1e-2
LOSS_ATOL = 5e-4

TRAIN_SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float16")
BERT_SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  d_ff=256, max_seq_len=32, dtype="float16")


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _assert_grads_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for path, ref in want.items():
        err = got[path] - ref
        assert np.isfinite(got[path]).all(), path
        assert np.linalg.norm(err) <= GRAD_REL_L2 * np.linalg.norm(ref), path
        assert np.abs(err).max() <= GRAD_MAX_REL * np.abs(ref).max(), path


@pytest.fixture(scope="module")
def lm_params():
    """JAX's f16 init weights of TRAIN_SHAPE (PRNGKey(0))."""
    return jtf.init_params(jax.random.PRNGKey(0),
                           jtf.TransformerConfig(**TRAIN_SHAPE))


@pytest.fixture(scope="module")
def bert_params():
    return jbert.init_params(jax.random.PRNGKey(0),
                             jbert.BertConfig(**BERT_SHAPE))


def _lm_pair(params):
    """(JAX config, the port's model on ``params``)."""
    return jtf.TransformerConfig(**TRAIN_SHAPE), weights.params_from_jax(
        _f32(params), ttf.TransformerConfig(**TRAIN_SHAPE), device="cpu")


def _bert_pair(params):
    return jbert.BertConfig(**BERT_SHAPE), weights.load_jax_tree(
        tbert.Bert(tbert.BertConfig(**BERT_SHAPE), "cpu"), _f32(params))


def _bert_batch(seed):
    batch = tbert.synthetic_mlm_batch(np.random.default_rng(seed), 2,
                                      tbert.BertConfig(**BERT_SHAPE))
    return {k: v.numpy() for k, v in batch.items()}


def test_transformer_step0_loss_and_grads_f16_match_jax(lm_params):
    cfg, model = _lm_pair(lm_params)
    toks = np.random.default_rng(0).integers(0, 128, (2, 33))
    loss_j, grads_j = jax.jit(jax.value_and_grad(functools.partial(
        jtf.loss_fn, cfg=cfg, attn_impl="xla")))(
        lm_params, {"tokens": jnp.asarray(toks)})
    loss = ttf.loss_fn(model, {"tokens": toks}, remat=True)
    loss.backward()
    assert next(model.parameters()).dtype == torch.float16
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    _assert_grads_close(weights.grads_to_jax(model), grads_j)


def test_bert_step0_loss_and_grads_f16_match_jax(bert_params):
    cfg, model = _bert_pair(bert_params)
    batch = _bert_batch(1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(functools.partial(
        jbert.loss_fn, cfg=cfg)))(
        bert_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = tbert.loss_fn(model, batch)
    loss.backward()
    assert next(model.parameters()).dtype == torch.float16
    assert abs(loss.item() - float(loss_j)) < LOSS_ATOL
    _assert_grads_close(weights.jax_tree(model, "grads"), grads_j)


def _port_nonfinite_at_zero_second_moment(optimizer, model):
    """Every parameter entry of the port's model after a step: non-finite
    exactly where AdamW's second moment is 0; and some are."""
    seen = 0
    for prm in model.parameters():
        zero = optimizer.state[prm]["exp_avg_sq"] == 0
        assert torch.equal(~torch.isfinite(prm), zero)
        seen += int(zero.sum())
    assert seen > 0


def _jax_nonfinite_at_zero_second_moment(state):
    adam = state[1][0]  # optax.adamw's scale_by_adam state
    params, nu = _leaves(state[0]), _leaves(adam.nu)
    for path, leaf in params.items():
        np.testing.assert_array_equal(~np.isfinite(leaf), nu[path] == 0,
                                      err_msg=path)
    assert sum(int((n == 0).sum()) for n in nu.values()) > 0


@pytest.mark.parametrize("model", ["transformer", "bert"])
def test_f16_adamw_step1_nan_is_the_reference_s_defect(model, lm_params,
                                                       bert_params):
    """A defect of the reference, kept: in f16, AdamW's eps (1e-8) rounds
    to 0 and the second moment (1 - 0.999) g^2 of a gradient under about
    5e-3 rounds to 0, so the update m / (sqrt(v) + eps) is ±inf (NaN
    where m is 0 too). Both packages: a finite step-0 loss, equal within
    LOSS_ATOL; after it every parameter entry with v = 0 is non-finite,
    and only those; the step-1 loss is NaN."""
    # Each package's default optimizer (the port's adamw is a copy of
    # JAX's: optax.adamw at lr 3e-4 for the transformer, 1e-4 for BERT,
    # weight decay 0.01), passed so that the JAX state starts from the
    # fixture's weights.
    optimizer = optax.adamw(3e-4 if model == "transformer" else 1e-4,
                            weight_decay=0.01)
    if model == "transformer":
        params = lm_params
        cfg, tmodel = _lm_pair(params)
        _, step_j = jtf.make_train_step(cfg, optimizer=optimizer,
                                        attn_impl="xla")
        init_t, step_t = ttf.make_train_step(
            ttf.TransformerConfig(**TRAIN_SHAPE), device="cpu")
        rng = np.random.default_rng(10)
        batches = [{"tokens": rng.integers(0, 128, (2, 33))}
                   for _ in range(2)]
    else:
        params = bert_params
        cfg, tmodel = _bert_pair(params)
        _, step_j = jbert.make_train_step(cfg, optimizer=optimizer)
        init_t, step_t = tbert.make_train_step(
            tbert.BertConfig(**BERT_SHAPE), device="cpu")
        batches = [_bert_batch(10 + i) for i in range(2)]
    # make_train_step's step donates its state: a copy of the fixture's.
    params = jax.tree.map(jnp.copy, params)
    state_j = (params, optimizer.init(params))
    state_t = init_t(model=tmodel)
    losses = []
    for step, batch in enumerate(batches):
        state_j, loss_j = step_j(
            state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        state_t, loss_t = step_t(state_t, batch)
        losses.append((float(loss_j), loss_t.item()))
        if step == 0:
            _jax_nonfinite_at_zero_second_moment(state_j)
            _port_nonfinite_at_zero_second_moment(state_t[1], state_t[0])
    (j0, t0), (j1, t1) = losses
    assert np.isfinite([j0, t0]).all() and abs(j0 - t0) < LOSS_ATOL
    assert np.isnan(j1) and np.isnan(t1)


@pytest.mark.parametrize("cli", ["serve_cli", "train_cli"])
def test_clis_take_dtype_float16_and_refuse_others_by_name(cli, capsys):
    parser = (tserve if cli == "serve_cli" else train_cli).build_parser()
    assert parser.parse_args(["--dtype", "float16"]).dtype == "float16"
    assert parser.parse_args([]).dtype == "bfloat16"
    with pytest.raises(SystemExit):
        parser.parse_args(["--dtype", "float64"])
    assert "float64" in capsys.readouterr().err


def test_train_cli_trains_the_transformer_in_f16_on_the_cpu(capsys):
    """``train_cli --dtype float16`` runs its steps as JAX's does: the
    step-0 loss is finite (later steps carry the reference's NaN)."""
    train_cli.main(["--model", "transformer", "--device", "cpu", "--steps",
                    "1", "--d-model", "64", "--n-heads", "4", "--seq-len",
                    "32", "--vocab-size", "128", "--batch-size", "2",
                    "--dtype", "float16"])
    import json

    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["loss"]) and result["steps_run"] == 1


def test_binding_codes_take_f16():
    """The launches' dtype codes (csrc/launch.cuh kDtype*): f16 runs the
    tensor-core kernels beside bf16; int8_mm's f32-output codes follow."""
    assert _ext._DTYPE_CODE == {torch.bfloat16: 0, torch.float32: 1,
                                torch.float16: 2}
    assert _ext._INT8_TO_F32 == {torch.bfloat16: 3, torch.float16: 4}
