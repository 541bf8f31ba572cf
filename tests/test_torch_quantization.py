# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's weight-only int8 serving (W8A16) vs the JAX package (CPU).

Inputs come from numpy seeds, or from the JAX ``init_params`` weights and
JAX's own ``quantize_params``, bridged with ``weights.params_from_jax`` so
both packages run the same int8 weights:

  * ``quantize_weight`` bit for bit against JAX's (the scale rounded in
    the weight's dtype), including a zero column and rounding halves;
  * ``int8_mm_reference`` (what ``int8_mm`` runs on CPU tensors) against
    JAX ``_chunk_mm``; ``params_from_jax`` on JAX's quantized tree against
    the port's ``quantize_params`` on the bridged dense weights;
  * the quantized forward (f32, 1e-4) and greedy tokens, exact, against
    JAX ``generate`` and JAX's dense ``ContinuousEngine`` on
    ``Model(quantize="int8")`` (the paged engine against ``generate``);
    ``--speculate ngram`` equal to off;
  * the properties ``tests/test_quantization.py`` holds JAX to, here on
    the port; ``--quantize``'s choices; training refused on int8.
"""

import argparse
import concurrent.futures
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import quantization as jq  # noqa: E402
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.parallel import overlap as joverlap  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    quantization as tq,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serving_graphs,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import int8_matmul  # noqa: E402

# The engine fixtures of tests/test_torch_dense.py and test_torch_paged.py.
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16)
PAGED = dict(ENGINE, kv_block_size=4, kv_cache="paged")
# f32 logits: the same int8 products in two frameworks, summed in other
# orders, through two layers.
LOGITS_ATOL = 1e-4
TIMEOUT_S = 120


def _bf16_to_f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def models():
    """(JAX Model(quantize="int8"), port Model on JAX's int8 weights)."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0,
                          quantize="int8")
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def dense_pair():
    """(JAX cfg, dense JAX params, port cfg) for the small f32 model."""
    jcfg = jtf.TransformerConfig(**SHAPE)
    return jcfg, jtf.init_params(jax.random.PRNGKey(0), jcfg), \
        ttf.TransformerConfig(**SHAPE)


def _weight_with_edges(dtype, seed=0, shape=(64, 48)):
    """A random (K, N) weight with a zero column (the 1e-8 clamp) and a
    column of exact halves of its scale (max 16: scale 16 / 127, rows at
    k/2 - 16 include values whose quotient ends in .5 after rounding the
    scale)."""
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    w[..., :, 5] = 0.0
    w[..., :, 7] = np.arange(shape[-2]) * 0.5 - 16.0
    return jnp.asarray(w).astype(dtype)


@pytest.mark.parametrize("dtype,shape", [
    ("bfloat16", (64, 48)), ("float32", (64, 48)), ("bfloat16", (3, 32, 40)),
])
def test_quantize_weight_is_bit_equal_to_jax(dtype, shape):
    """q and scale exactly equal to JAX's (eager) quantize_weight; on bf16
    the scale is rounded to bf16 before the division, which a scale
    computed in f32 would not reproduce."""
    w = _weight_with_edges(dtype, shape=shape)
    want = jq.quantize_weight(w)
    got = tq.quantize_weight(
        torch.from_numpy(_bf16_to_f32(w)).to(getattr(torch, dtype)))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert (got["scale"][..., 5] == np.float32(
        jnp.asarray(1e-8, dtype).astype(jnp.float32))).all()
    if dtype == "bfloat16" and len(shape) == 2:
        # The bf16 scale matters: an f32 one moves some entries.
        w32 = _bf16_to_f32(w)
        s32 = np.maximum(np.abs(w32).max(0, keepdims=True) / 127, 1e-8)
        naive = np.clip(np.round(w32 / s32), -127, 127).astype(np.int8)
        assert (naive != np.asarray(want["q"])).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_mm_reference_matches_jax_chunk_mm(dtype):
    """The plain version against JAX ``_chunk_mm`` on the same int8 weight
    and activations: f32 within 1e-5 (summation order), bf16 within one
    bf16 step of the reference (both round one f32 sum once); the CPU
    wrapper is the plain version, leading dims kept."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 5, 96)).astype(np.float32)) \
        .astype(dtype)
    w = jnp.asarray((rng.standard_normal((96, 40)) * 0.1).astype(np.float32))
    qw = jq.quantize_weight(w)
    want = _bf16_to_f32(joverlap._chunk_mm(x, qw, x.dtype))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(_bf16_to_f32(x)).to(tdt)
    qt = torch.from_numpy(np.array(qw["q"]).T.copy())
    scale = torch.from_numpy(np.array(qw["scale"]))
    got = int8_matmul.int8_mm_reference(tx, qt, scale)
    assert got.dtype == tdt and got.shape == (2, 5, 40)
    assert torch.equal(int8_matmul.int8_mm(tx, qt, scale), got)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_quantized_tree_equals_port_quantize_params(dtype):
    """JAX's quantized tree bridged into the port holds the q and scale
    the port's own ``quantize_params`` gives on the bridged dense
    weights, leaf for leaf."""
    jcfg = jtf.TransformerConfig(**{**SHAPE, "dtype": dtype})
    cfg = ttf.TransformerConfig(**{**SHAPE, "dtype": dtype})
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    bridged = weights.params_from_jax(
        jax.tree.map(np.asarray, jq.quantize_params(params)), cfg,
        device="cpu")
    own = tq.quantize_params(weights.params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))
    for a, b in zip(bridged.layers, own.layers):
        for owner_a, owner_b in ((a.attn, b.attn), (a.ffn, b.ffn)):
            for key in tq.DENSE_WEIGHT_KEYS:
                wa, wb = getattr(owner_a, key, None), getattr(owner_b, key,
                                                              None)
                if wa is None:
                    continue
                assert isinstance(wa, tq.Int8Weight), key
                assert torch.equal(wa.q, wb.q) and torch.equal(wa.scale,
                                                               wb.scale)


def test_int8_weight_keeps_q_transposed(models):
    """The port keeps each quantized matrix as (dout, din), din contiguous
    (the kernel's operand layout), the transpose of JAX's q, and no other
    copy; its scale is JAX's (1, dout)."""
    jmodel, tmodel = models
    for i, layer in enumerate(tmodel.model.layers):
        for owner, keys in ((layer.attn, ("wq", "wk", "wv", "wo")),
                            (layer.ffn, ("w1", "w3", "w2"))):
            for key in keys:
                w, want = getattr(owner, key), jmodel.params["layers"][key]
                assert w.q.is_contiguous()
                assert w.q.shape == want["q"].shape[1:][::-1]
                np.testing.assert_array_equal(w.q.numpy(),
                                              np.asarray(want["q"][i]).T)
                np.testing.assert_array_equal(
                    w.scale.numpy(), np.asarray(want["scale"][i]))
                assert sorted(n for n, _ in w.named_buffers()) == \
                    ["q", "scale"]


def test_quantized_forward_matches_jax(models):
    """Forward logits of the int8 model against JAX's quantized
    ``forward`` on the same int8 weights (f32, 1e-4)."""
    jmodel, tmodel = models
    toks = np.random.default_rng(2).integers(0, SHAPE["vocab_size"], (2, 13))
    want = np.asarray(jtf.forward(jmodel.params, jnp.asarray(toks),
                                  jmodel.cfg))
    got = ttf.forward(tmodel.model, torch.as_tensor(toks)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_greedy_tokens_match_jax_generate(models):
    jmodel, tmodel = models
    rng = np.random.default_rng(3)
    for n, max_new in ((3, 8), (17, 6), (30, 12)):
        prompt = rng.integers(1, SHAPE["vocab_size"], n).tolist()
        assert tmodel.generate([prompt], max_new) == \
            jmodel.generate([prompt], max_new)


def _serve(engine, cases):
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        futures = [pool.submit(engine.generate, [p], n) for p, n in cases]
        return [f.result(timeout=TIMEOUT_S)[0] for f in futures]


def _traffic(seed):
    """More requests than slots: a prompt prefilled in three segments,
    three short ones, a one-token request."""
    rng = np.random.default_rng(seed)
    cases = [(rng.integers(1, SHAPE["vocab_size"], 40).tolist(), 8)]
    cases += [(rng.integers(1, SHAPE["vocab_size"], 3 + 5 * i).tolist(),
               5 + i) for i in range(3)]
    return cases + [([9, 8, 7], 1)]


def test_dense_engine_matches_the_jax_engine_on_int8_weights(models):
    """The port's dense engine against JAX's dense ``ContinuousEngine`` on
    ``Model(quantize="int8")``, both under the same concurrent traffic:
    tokens exact, and equal to JAX ``generate``'s."""
    jmodel, tmodel = models
    cases = _traffic(4)
    jeng = jserve.ContinuousEngine(jmodel, **ENGINE)
    eng = tserve.ContinuousEngine(tmodel, **ENGINE)
    try:
        want = _serve(jeng, cases)
        got = _serve(eng, cases)
    finally:
        eng.shutdown()
        jeng.shutdown()
    assert got == want
    assert got == [jmodel.generate([p], n)[0] for p, n in cases]


def test_paged_engine_matches_jax_generate_on_int8_weights(models):
    """The port's paged engine on the same traffic: tokens exact against
    JAX ``generate`` on ``Model(quantize="int8")``, which is what JAX's
    paged engine promises. (JAX's paged engine itself is not the yardstick
    here: on the 8-device CPU mesh the tests run on, it returns other
    tokens from run to run, on dense weights too.)"""
    jmodel, tmodel = models
    cases = _traffic(4)
    eng = tserve.ContinuousEngine(tmodel, **PAGED)
    try:
        got = _serve(eng, cases)
    finally:
        eng.shutdown()
    assert got == [jmodel.generate([p], n)[0] for p, n in cases]


def test_speculate_ngram_on_the_int8_paged_engine_equals_off(models):
    _, tmodel = models
    rng = np.random.default_rng(5)
    pattern = rng.integers(1, SHAPE["vocab_size"], 6).tolist()
    cases = [(pattern * 4, 16), (pattern * 2 + pattern[:3], 12),
             (rng.integers(1, SHAPE["vocab_size"], 9).tolist(), 10)]
    outs = {}
    for mode in ("off", "ngram"):
        eng = tserve.ContinuousEngine(tmodel, speculate=mode, **PAGED)
        try:
            outs[mode] = _serve(eng, cases)
            if mode == "ngram":
                assert eng.stats()["spec_verifies"] > 0
        finally:
            eng.shutdown()
    assert outs["ngram"] == outs["off"]


# -- the properties tests/test_quantization.py holds the JAX package to ------

def test_quantize_roundtrip_error_bounded():
    """Round to nearest: |dequantized - w| <= scale / 2 <= max|w| / 254."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy((rng.standard_normal((4, 32, 48)) * 0.2)
                         .astype(np.float32))
    qw = tq.quantize_weight(w)
    assert qw["q"].dtype == torch.int8 and qw["scale"].shape == (4, 1, 48)
    err = (tq.dequantize_weight(qw) - w).abs().max().item()
    assert err <= w.abs().max().item() / 254 + 1e-7


def test_quantized_params_structure(dense_pair):
    """Every layer matrix becomes an ``Int8Weight`` (int8 q, f32 scale,
    buffers, not parameters); the embedding and the norms are the very
    tensors they were."""
    _, params, cfg = dense_pair
    model = weights.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    embed, norms = model.embed, [(l.ln1.weight, l.ln2.weight)
                                 for l in model.layers]
    assert tq.quantize_params(model) is model
    for layer, (ln1, ln2) in zip(model.layers, norms):
        for owner, keys in ((layer.attn, ("wq", "wk", "wv", "wo")),
                            (layer.ffn, ("w1", "w3", "w2"))):
            for key in keys:
                w = getattr(owner, key)
                assert tq.is_quantized(w), key
                assert w.q.dtype == torch.int8 and w.scale.dtype == \
                    torch.float32
        assert layer.ln1.weight is ln1 and layer.ln2.weight is ln2
    assert model.embed is embed
    names = {n for n, _ in model.named_parameters()}
    assert names == {"embed", "ln_f.weight"} | {
        f"layers.{i}.{n}.weight" for i in range(cfg.n_layers)
        for n in ("ln1", "ln2")}


def test_quantized_forward_close_to_dense(dense_pair):
    """W8A16 per channel: logits within 0.15 std of the dense model's."""
    _, params, cfg = dense_pair
    tree = jax.tree.map(np.asarray, params)
    dense = weights.params_from_jax(tree, cfg, device="cpu")
    quant = tq.quantize_params(weights.params_from_jax(tree, cfg,
                                                       device="cpu"))
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, SHAPE["vocab_size"], (2, 32)))
    with torch.inference_mode():
        want = ttf.forward(dense, toks)
        got = ttf.forward(quant, toks)
    err = (want - got).abs().max().item()
    assert err < 0.15 * want.std().item(), err


def test_quantized_generate_runs_and_mostly_matches(dense_pair):
    """Greedy tokens of the int8 model agree with the dense model's on at
    least 3 in 4 positions (argmax flips on near-ties)."""
    _, params, cfg = dense_pair
    tree = jax.tree.map(np.asarray, params)
    dense = tserve.Model(cfg, weights=weights.params_from_jax(
        tree, cfg, device="cpu"))
    quant = tserve.Model(cfg, weights=weights.params_from_jax(
        tree, cfg, device="cpu"), quantize="int8")
    prompt = np.random.default_rng(8).integers(
        0, SHAPE["vocab_size"], (2, 8)).tolist()
    want = np.asarray(dense.generate(prompt, 8))
    got = np.asarray(quant.generate(prompt, 8))
    assert got.shape == want.shape
    assert (got[:, 8:] == want[:, 8:]).mean() >= 0.75


# -- the CLI and training ------------------------------------------------------

def _parser_of(main):
    """The argparse parser ``main`` builds, caught at ``parse_args``."""
    class Parsed(Exception):
        pass

    def grab(self, *args, **kwargs):
        raise Parsed(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Parsed) as caught:
            main([])
    return caught.value.args[0]


def _action(parser, flag):
    return next(a for a in parser._actions if flag in a.option_strings)


def test_quantize_flag_takes_the_jax_choices_and_default():
    ours = _action(_parser_of(tserve.main), "--quantize")
    theirs = _action(_parser_of(jserve.main), "--quantize")
    assert list(ours.choices) == list(theirs.choices) == ["none", "int8"]
    assert ours.default == theirs.default == "none"
    with pytest.raises(ValueError, match="quantize"):
        tserve.Model(ttf.TransformerConfig(**SHAPE), device="cpu",
                     quantize="int4")


def test_serve_cli_quantize_int8_once_on_cpu(capsys):
    """``--quantize int8`` reaches the model through the CLI: rc 0 and one
    response from the int8 dense engine."""
    flags = ["--n-layers", "1", "--d-model", "64", "--n-heads", "2",
             "--seq-len", "64", "--vocab-size", "256"]
    assert tserve.main(["--once", "--device", "cpu", "--port", "0",
                        "--quantize", "int8", "--continuous-batching",
                        *flags]) == 0
    assert '"tokens"' in capsys.readouterr().out


def test_make_train_step_refuses_a_quantized_model(dense_pair):
    _, params, cfg = dense_pair
    model = tq.quantize_params(weights.params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))
    init_state, train_step = ttf.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="dense weights"):
        init_state(model=model)
    dense = weights.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    state = init_state(model=dense)
    tq.quantize_params(dense)
    with pytest.raises(ValueError, match="dense weights"):
        train_step(state, {"tokens": np.zeros((1, 9), np.int64)})


def test_int8_dense_decode_graphs_run_on_the_cpu(models):
    """The decoder the server keeps (``DenseDecodeGraphs``) runs the int8
    step eagerly on the CPU, as ``Model.generate`` does, and the CPU
    wrapper never counts a kernel launch."""
    jmodel, tmodel = models
    before = int8_matmul.int8_mm_launches
    prompt = torch.as_tensor([[5, 6, 7, 8]])
    out = ttf.generate(tmodel.model, prompt, max_new_tokens=4,
                       decoder=serving_graphs.DenseDecodeGraphs(tmodel.model))
    assert out.tolist() == jmodel.generate([[5, 6, 7, 8]], 4)
    assert int8_matmul.int8_mm_launches == before
