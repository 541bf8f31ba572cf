# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port transformer (PyTorch, CPU) vs the JAX package on the same weights.

Both run the JAX ``init_params(PRNGKey(0))`` weights, bridged into the
port with ``params_from_jax`` (trainable, so ``forward``'s outputs are
detached before they are compared): 2 layers, d_model 64, 4 q heads, 2 kv
heads, vocab 256. f32 logits agree to 1e-4 and greedy tokens exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serving_graphs,
    weights,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)

SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64)
LOGITS_ATOL = 1e-4
# bf16 weights and activations on both sides; the two frameworks round
# at other places (matmul outputs, the attention's p), so logits differ
# by a few bf16 steps (2^-8 relative at magnitudes below 1 here).
BF16_LOGITS_ATOL = 2e-2


def _configs(dtype):
    return (jtf.TransformerConfig(**SHAPE, dtype=dtype),
            ttf.TransformerConfig(**SHAPE, dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(jax cfg, jax params, port cfg, port model) on identical weights."""
    cfg_j, cfg_t = _configs(request.param)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params)
    model = weights.params_from_jax(tree, cfg_t, device="cpu")
    return cfg_j, params, cfg_t, model


@pytest.fixture(scope="module")
def f32_pair():
    cfg_j, cfg_t = _configs("float32")
    params = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    model = weights.params_from_jax(jax.tree.map(np.asarray, params),
                                    cfg_t, device="cpu")
    return cfg_j, params, cfg_t, model


def _tokens(batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab_size"],
                                                (batch, seq))


def test_forward_logits_match_jax(pair):
    cfg_j, params, cfg_t, model = pair
    toks = _tokens(2, 13)
    ref = np.asarray(jtf.forward(params, jnp.asarray(toks), cfg_j))
    out = ttf.forward(model, torch.as_tensor(toks))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    atol = LOGITS_ATOL if cfg_t.dtype == "float32" else BF16_LOGITS_ATOL
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=atol,
                               rtol=0)


@pytest.mark.parametrize("logits_at", ["last", 5])
def test_forward_kv_and_logits_at_match_jax(f32_pair, logits_at):
    cfg_j, params, _, model = f32_pair
    toks = _tokens(2, 16, seed=1)
    ref, (rk, rv) = jtf.forward(params, jnp.asarray(toks), cfg_j,
                                return_kv=True, logits_at=logits_at)
    out, (k, v) = ttf.forward(model, torch.as_tensor(toks), return_kv=True,
                              logits_at=logits_at)
    assert out.shape == (2, 1, SHAPE["vocab_size"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(k.detach().numpy(), np.asarray(rk), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(rv), atol=1e-5,
                               rtol=0)


def test_prefill_and_decode_step_match_jax(f32_pair):
    """Bucketed prefill (logits at true_len - 1, cache [0, P)) and one
    decode step, whose K/V the port writes into the cache in place."""
    cfg_j, params, cfg_t, model = f32_pair
    toks = _tokens(2, 11, seed=2)
    padded = np.pad(toks, ((0, 0), (0, 5)))
    ref_logits, ref_cache = jtf.prefill(
        params, jnp.asarray(padded), cfg_j, true_len=jnp.int32(11),
        return_logits=True,
    )
    logits, cache = ttf.prefill(model, torch.as_tensor(padded), true_len=11,
                                return_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(ref_cache["k"]),
                               atol=1e-5, rtol=0)
    nxt = np.argmax(np.asarray(ref_logits), axis=-1)
    ref_step, ref_cache = jtf.decode_logits(
        params, ref_cache, jnp.asarray(nxt), 11, cfg_j
    )
    k_cache = cache["k"]
    step = ttf.decode_logits(model, cache, torch.as_tensor(nxt), 11)
    assert cache["k"] is k_cache  # written in place
    np.testing.assert_allclose(step.numpy(), np.asarray(ref_step),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(ref_cache["v"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("batch,prompt_len", [(2, 13), (1, 16), (3, 5)])
def test_greedy_generate_matches_jax(f32_pair, batch, prompt_len):
    cfg_j, params, _, model = f32_pair
    toks = _tokens(batch, prompt_len, seed=prompt_len)
    ref = np.asarray(jtf.generate(params, jnp.asarray(toks, jnp.int32),
                                  cfg_j, max_new_tokens=8))
    out = ttf.generate(model, torch.as_tensor(toks), max_new_tokens=8,
                       decoder=serving_graphs.DenseDecodeGraphs(model))
    assert out.shape == (batch, prompt_len + 8)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_rejects_overlong_request(f32_pair):
    model = f32_pair[3]
    with pytest.raises(ValueError, match="max_seq_len"):
        ttf.generate(model, torch.zeros(1, 60, dtype=torch.long),
                     max_new_tokens=8,
                     decoder=serving_graphs.DenseDecodeGraphs(model))


def test_sampling_keeps_to_top_k_and_top_p_and_is_seeded():
    logits = torch.tensor([[0.0, 3.0, 2.9, -1.0, 2.0, 1.0]]).repeat(64, 1)
    gen = torch.Generator().manual_seed(3)
    top2 = ttf.sample_token(logits, gen, temperature=1.0, top_k=2)
    assert set(top2.tolist()) == {1, 2}
    # Sorted probs of the top three: ~0.45, 0.40, 0.16 of the mass.
    nucleus = ttf.sample_token(logits, gen, temperature=1.0, top_p=0.8)
    assert set(nucleus.tolist()) <= {1, 2, 4} and 4 in nucleus.tolist()
    greedy = ttf.sample_token(logits, None)
    assert greedy.tolist() == [1] * 64
    a = ttf.sample_token(logits, torch.Generator().manual_seed(9), 0.7)
    b = ttf.sample_token(logits, torch.Generator().manual_seed(9), 0.7)
    assert torch.equal(a, b)


def test_sampled_generate_is_reproducible_per_seed(f32_pair):
    model = f32_pair[3]
    toks = torch.as_tensor(_tokens(1, 6))
    decoder = serving_graphs.DenseDecodeGraphs(model)

    def run(seed):
        return ttf.generate(model, toks, max_new_tokens=6, temperature=1.0,
                            generator=torch.Generator().manual_seed(seed),
                            decoder=decoder)

    assert torch.equal(run(4), run(4))
    assert run(4)[0, :6].tolist() == toks[0].tolist()


def test_weights_round_trip():
    cfg_j, cfg_t = _configs("float32")
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(1), cfg_j))
    back = weights.params_to_jax(
        weights.params_from_jax(tree, cfg_t, device="cpu"))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf)


def test_init_params_scales_follow_jax():
    cfg = ttf.TransformerConfig(vocab_size=512, d_model=128, n_layers=1,
                                n_heads=4, n_kv_heads=2, d_ff=256,
                                max_seq_len=32, dtype="float32")
    model = ttf.init_params(cfg, device="cpu", seed=0)
    layer = model.layers[0]
    assert model.embed.std().item() == pytest.approx(0.02, rel=0.05)
    assert layer.attn.wq.std().item() == pytest.approx(128 ** -0.5, rel=0.05)
    assert layer.ffn.w2.std().item() == pytest.approx(256 ** -0.5, rel=0.05)
    assert (layer.ln1.weight == 1).all() and (model.ln_f.weight == 1).all()
    again = ttf.init_params(cfg, device="cpu", seed=0)
    assert torch.equal(again.layers[0].ffn.w1, layer.ffn.w1)


def test_moe_configs_are_not_ported_yet():
    """A model with experts builds and trains (tests/test_torch_moe.py);
    serving one is what is not ported yet."""
    from container_engine_accelerators_tpu_torch.models import serve_cli

    cfg = dataclasses.replace(_configs("float32")[1], n_experts=4)
    model = ttf.Transformer(cfg, "cpu")
    assert all(isinstance(layer.ffn, ttf.MoEFeedForward)
               for layer in model.layers)
    with pytest.raises(NotImplementedError, match="experts"):
        serve_cli.Model(cfg, device="cpu", weights=model)


def test_config_llama3_8b_matches_jax():
    j, t = jtf.TransformerConfig.llama3_8b(), ttf.TransformerConfig.llama3_8b()
    for field in dataclasses.fields(t):
        assert getattr(t, field.name) == getattr(j, field.name), field.name
    assert t.head_dim == 128 and t.torch_dtype == torch.bfloat16
