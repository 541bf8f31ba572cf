# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Tensor-parallel training of the port against the JAX package's on a
dp × tp mesh.

The reference is JAX's ``transformer.loss_fn`` (and ``bert``'s) on the
8-device CPU mesh of ``train_cli.build_mesh`` with the parameters laid
out by ``param_shardings`` and the batch over dp, under ``jax.jit`` and
``jax.value_and_grad``: the loss and gradients ``make_train_step``
differentiates (its remat changes nothing of them), and its step's loss.
The port runs ``models/tp_lm.py`` (and ``bert.make_tp_train_step``) from
the same weights, every tp rank in this process (``Axes.in_process``)
and over gloo worlds of 2 (tp 2, the MoE off path among them) and 4
(dp 2 × tp 2; tp 4 over 2 KV heads and over BERT's 2 heads) processes
(``tests/torch_dist_worker.py`` scenario ``tp_train``), and merges the
ranks' gradients (``weights.tp_to_jax``). f32 throughout, summed in
other orders (ring chunks, per-rank partials, the vocab-parallel cross
entropy): the loss within 1e-5 relative, each gradient leaf within 1e-4
of its largest entry (readings here: at most 2e-6).

``resolve_overlap``'s rules are held to JAX's on the same sizes, the
shards to JAX's ``param_shardings`` layout, and ``train_cli --tp`` to a
one-rank run through the CLI. tp over heads, KV heads or a vocabulary
it does not divide holds those parts whole on every rank
(``tp_lm.whole_parts``, ``bert.whole_parts``); a d_ff (or a head width)
tp does not divide and ep that does not divide the experts are refused,
as JAX's ``device_put`` fails on them.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.models import bert as jbert  # noqa: E402
from container_engine_accelerators_tpu.models import train_cli as jtrain_cli  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import bert as tbert  # noqa: E402
from container_engine_accelerators_tpu_torch.models import tp_lm  # noqa: E402
from container_engine_accelerators_tpu_torch.models import train_cli  # noqa: E402
from container_engine_accelerators_tpu_torch.models import transformer as ttf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import (  # noqa: E402
    tensor_parallel as tpar,
)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TF_SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
                n_kv_heads=4, d_ff=128, max_seq_len=64, dtype="float32")
MOE_SHAPE = dict(TF_SHAPE, n_experts=4, capacity_factor=2.0)
BERT_SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  d_ff=128, max_seq_len=32, dtype="float32")


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


def tokens(batch=2, seq=32, vocab=128, seed=11):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))


def jax_transformer(shape, toks, dp, tp, ep=1, overlap="auto", step=True):
    """(JAX's initial weights as numpy, its loss, its gradients, its
    make_train_step loss, or None without ``step``) on
    ``build_mesh(dp·tp·ep, 1, tp, ep)``."""
    cfg = jtf.TransformerConfig(**shape)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.array, params)
    mesh = jtrain_cli.build_mesh(dp * tp * ep, 1, tp, ep)
    sharded = jax.device_put(params, jtf.param_shardings(cfg, mesh))
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      NamedSharding(mesh, P("dp", None)))}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, b, cfg, mesh=mesh, overlap=overlap)))(
        sharded, batch)
    step_loss = None
    if step:
        init, train_step = jtf.make_train_step(cfg, mesh=mesh,
                                               overlap=overlap)
        _, step_loss = train_step(init(jax.random.PRNGKey(0)), batch)
        step_loss = float(step_loss)
    return host, float(loss), jax.tree.map(np.asarray, grads), step_loss


def jax_bert(batch, dp, tp, shape=BERT_SHAPE):
    cfg = jbert.BertConfig(**shape)
    params = jbert.init_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree.map(np.array, params)
    mesh = jtrain_cli.build_mesh(dp * tp, 1, tp)
    sharded = jax.device_put(params, jbert.param_shardings(cfg, mesh))
    jb = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P("dp", *[None] * (v.ndim - 1)))) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jbert.loss_fn(p, b, cfg)))(sharded, jb)
    return host, float(loss), jax.tree.map(np.asarray, grads)


def bert_batch(rows=4, seed=13, shape=BERT_SHAPE):
    return {k: v.numpy() for k, v in tbert.synthetic_mlm_batch(
        np.random.default_rng(seed), rows,
        tbert.BertConfig(**shape)).items()}


# -- every tp rank in one process ----------------------------------------------

@pytest.mark.parametrize("overlap,tp", [("ring", 2), ("ring", 4),
                                        ("off", 2), ("off", 4)])
def test_in_process_transformer_matches_jax(overlap, tp):
    toks = tokens()
    host, jloss, jgrads, jstep = jax_transformer(TF_SHAPE, toks, 1, tp,
                                                 overlap=overlap)
    cfg = ttf.TransformerConfig(**TF_SHAPE)
    axes = tpar.Axes.in_process(tp=tp)
    assert tp_lm.resolve(cfg, axes, None, 2, 32, overlap) == overlap
    init, step = tp_lm.make_train_step(cfg, axes, device="cpu",
                                       overlap=overlap)
    state = init(model=weights.params_from_jax(host, cfg, device="cpu"))
    state, loss = step(state, {"tokens": toks})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), jstep, rtol=LOSS_RTOL)
    assert_grads_close(weights.tp_to_jax(list(state[0]), axes, "grads"),
                       jgrads, f"{overlap} tp {tp}")


@pytest.mark.parametrize("tp", [2, 4])
def test_in_process_bert_matches_jax(tp):
    batch = bert_batch()
    host, jloss, jgrads = jax_bert(batch, 1, tp)
    cfg = tbert.BertConfig(**BERT_SHAPE)
    axes = tpar.Axes.in_process(tp=tp)
    init, step = tbert.make_tp_train_step(cfg, axes, device="cpu")
    state = init(model=weights.load_jax_tree(tbert.Bert(cfg, "cpu"), host))
    state, loss = step(state, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert_grads_close(weights.bert_tp_to_jax(list(state[0]), axes, "grads"),
                       jgrads, f"bert tp {tp}")


def test_moe_on_a_tp_mesh_takes_the_off_path_as_jax():
    """Experts resolve to "off"; their F dim splits over tp
    (``moe_w1`` P(None, ep, dp, tp))."""
    toks = tokens()
    host, jloss, jgrads, _ = jax_transformer(MOE_SHAPE, toks, 1, 2)
    cfg = ttf.TransformerConfig(**MOE_SHAPE)
    axes = tpar.Axes.in_process(tp=2)
    assert tp_lm.resolve(cfg, axes, None, 2, 32) == "off"
    init, step = tp_lm.make_train_step(cfg, axes, device="cpu")
    state = init(model=weights.params_from_jax(host, cfg, device="cpu"))
    state, loss = step(state, {"tokens": toks})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert_grads_close(weights.tp_to_jax(list(state[0]), axes, "grads"),
                       jgrads, "moe tp 2")


# bf16: the sharded paths against the same step in f32 (seed 0's bf16
# weights widened exactly), beside the unsplit bf16 step. Readings here
# (worst leaf's relative L2 error): the unsplit step 0.020-0.022 from
# f32, ring and off 0.020-0.023, ring and off 0.008-0.010 from the unsplit
# step; ep equal to the unsplit step.
BF16_SHAPE = dict(vocab_size=1024, d_model=128, n_layers=2, n_heads=8,
                  n_kv_heads=4, d_ff=384, max_seq_len=128, dtype="bfloat16")


def _worst_rel_l2(got, want):
    return max(((got[n].float() - w).norm() / w.norm()).item()
               for n, w in want.items())


@pytest.mark.parametrize("overlap,axes", [
    ("ring", tpar.Axes.in_process(tp=4)),
    ("off", tpar.Axes.in_process(tp=4)),
    (None, tpar.Axes.in_process(ep=4))], ids=["ring", "off", "ep"])
def test_bf16_paths_round_like_the_unsplit_step(overlap, axes):
    """In bf16 a sharded step rounds at other places than the unsplit one
    (narrower products, f32 partial sums over the axis, the vocab-parallel
    cross entropy), so the two differ by bf16 rounding: each path is as
    close to the step's f32 arithmetic as the unsplit bf16 step is
    (within 10 %), and closer to the unsplit step than either is to f32.
    A missing partial sum or a gradient counted twice reads far above."""
    shape = dict(BF16_SHAPE, n_experts=8) if axes.ep.size > 1 else BF16_SHAPE
    cfg = ttf.TransformerConfig(**shape)
    batch = {"tokens": torch.as_tensor(tokens(1, cfg.max_seq_len,
                                              cfg.vocab_size, seed=3))}

    def grads(model):
        ttf.loss_fn(model, batch).backward()
        return {n: p.grad.float() for n, p in model.named_parameters()}

    model = ttf.init_params(cfg, device="cpu", seed=0)
    unsplit = grads(model)
    wide = ttf.Transformer(dataclasses.replace(cfg, dtype="float32"), "cpu")
    with torch.no_grad():
        for p, q in zip(wide.parameters(), model.parameters()):
            p.copy_(q.float())
    f32 = grads(wide)
    init, step = tp_lm.make_train_step(cfg, axes, device="cpu",
                                       overlap=overlap, remat=False)
    state = init(model=model)
    step(state, batch)
    path = tp_lm.merged(list(state[0]), axes, "grads")
    floor = _worst_rel_l2(unsplit, f32)
    assert 0.005 < floor < 0.5
    assert _worst_rel_l2(path, f32) <= 1.1 * floor
    assert _worst_rel_l2(path, unsplit) < floor


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_are_jax_s_param_shardings(tp):
    """Each rank's shard of every leaf equals the shard JAX's
    ``param_shardings`` puts on the device of that tp index (dp 1)."""
    cfg = jtf.TransformerConfig(**TF_SHAPE)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    mesh = jtrain_cli.build_mesh(tp, 1, tp)
    sharded = jax.device_put(params, jtf.param_shardings(cfg, mesh))
    axes = tpar.Axes.in_process(tp=tp)
    shards = weights.tp_params_from_jax(jax.tree.map(np.array, params),
                                        ttf.TransformerConfig(**TF_SHAPE),
                                        axes, device="cpu")
    tp_of = {d: int(np.argwhere(mesh.devices == d)[0][2])
             for d in mesh.devices.flat}
    for name, leaf in sharded["layers"].items():
        for piece in leaf.addressable_shards:
            r = tp_of[piece.device]
            # params_to_jax walks the layers by name, whatever the widths.
            port = weights.params_to_jax(shards[r])["layers"][name]
            np.testing.assert_array_equal(
                port, np.asarray(piece.data), err_msg=f"{name} tp {r}")


@pytest.mark.parametrize("sizes,seq,batch", [
    ({"dp": 1, "sp": 1, "tp": 2}, 32, 2), ({"dp": 1, "sp": 1, "tp": 1}, 32, 2),
    ({"dp": 1, "sp": 2, "tp": 2}, 32, 2), ({"dp": 1, "sp": 1, "tp": 4}, 30, 2),
    ({"dp": 2, "sp": 1, "tp": 2}, 32, 3), ({"dp": 2, "sp": 1, "tp": 2}, 32, 4),
    ({"dp": 1, "sp": 1, "tp": 3}, 33, 2), ({"dp": 1, "sp": 1}, 32, 2)])
@pytest.mark.parametrize("overlap", ["auto", "ring", "off", None])
def test_resolve_overlap_is_jax_s(sizes, seq, batch, overlap):
    from jax.sharding import Mesh

    cfg_j = jtf.TransformerConfig(**TF_SHAPE)
    cfg_t = ttf.TransformerConfig(**TF_SHAPE)
    n = int(np.prod(list(sizes.values())))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(sizes.values())), tuple(sizes))
    assert ttf.resolve_overlap(overlap, cfg_t, sizes, seq=seq, batch=batch) \
        == jtf.resolve_overlap(overlap, cfg_j, mesh, seq=seq, batch=batch)
    for moe in (dataclasses.replace(cfg_t, n_experts=4),):
        assert ttf.resolve_overlap(overlap, moe, sizes, seq=seq) == "off"


def test_resolve_overlap_refuses_an_unknown_mode_as_jax_does():
    for fn, cfg in ((ttf.resolve_overlap, ttf.TransformerConfig()),
                    (jtf.resolve_overlap, jtf.TransformerConfig())):
        with pytest.raises(ValueError, match="unknown overlap mode"):
            fn("sideways", cfg, {"tp": 2} if fn is ttf.resolve_overlap
               else jtrain_cli.build_mesh(2, 1, 2), seq=32)


# Shapes tp does not divide: the parts held whole (``tp_lm.whole_parts``).
# JAX shards the weight arrays (n_heads·hd, n_kv_heads·hd and d_ff
# columns) and lets GSPMD cut through a head, so it trains heads or KV
# heads that tp does not divide where those widths divide, and the
# vocabulary (its embedding is not tp-sharded) at any tp; its
# ``device_put`` refuses a d_ff that tp does not divide, and so does the
# port (``test_widths_jax_cannot_shard_are_refused_as_jax_does``).
WHOLE_CASES = {
    "kv2": (dict(TF_SHAPE, n_kv_heads=2), "auto", {"attn"}),
    "vocab_ring": (dict(TF_SHAPE, vocab_size=130), "ring", {"vocab"}),
    "all": (dict(TF_SHAPE, n_heads=2, n_kv_heads=1, vocab_size=130),
            "auto", {"attn", "vocab"}),
}


@pytest.mark.parametrize("name", sorted(WHOLE_CASES))
def test_tp_over_dims_it_does_not_divide_matches_jax(name):
    """tp 4 over heads, KV heads or a vocabulary it does not divide: each
    such part whole on every rank (its weights the whole model's), the
    rest split, the path JAX's ``resolve_overlap`` gives; the loss and
    the merged gradients against JAX's ``loss_fn`` and ``jax.grad`` on a
    tp-4 mesh. A whole part's gradients are not summed over tp: a sum
    would read 4 times too large. The "all" case has the attention (2
    heads, 1 KV head) and the vocabulary whole on the off path."""
    shape, overlap, whole = WHOLE_CASES[name]
    toks = tokens(vocab=shape["vocab_size"])
    host, jloss, jgrads, _ = jax_transformer(shape, toks, 1, 4,
                                             overlap=overlap, step=False)
    cfg = ttf.TransformerConfig(**shape)
    axes = tpar.Axes.in_process(tp=4)
    assert tp_lm.whole_parts(cfg, 4) == whole
    assert tp_lm.resolve(cfg, axes, None, 2, 32, overlap) == \
        ("ring" if overlap == "ring" else "off")
    init, step = tp_lm.make_train_step(cfg, axes, device="cpu",
                                       overlap=overlap)
    state = init(model=weights.params_from_jax(host, cfg, device="cpu"))
    whole_layer = weights.params_from_jax(host, cfg, device="cpu").layers[0]
    for shard in state[0]:
        for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                            ("ffn", ("w1", "w2"))):
            module = getattr(shard.layers[0], part)
            for n in names:
                full = getattr(getattr(whole_layer, part), n).shape
                assert (getattr(module, n).shape == full) == \
                    (part in whole), (part, n)
    state, loss = step(state, {"tokens": toks})
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert_grads_close(weights.tp_to_jax(list(state[0]), axes, "grads"),
                       jgrads, name)


@pytest.mark.parametrize("shape", [dict(BERT_SHAPE, n_heads=2)],
                         ids=["heads2"])
def test_bert_tp_over_dims_it_does_not_divide_matches_jax(shape):
    """BERT at tp 4 with 2 heads: the attention whole (JAX cuts through
    the heads), the FFN split."""
    batch = bert_batch(shape=shape)
    host, jloss, jgrads = jax_bert(batch, 1, 4, shape)
    cfg = tbert.BertConfig(**shape)
    axes = tpar.Axes.in_process(tp=4)
    assert tbert.whole_parts(cfg, 4) == {"attn"}
    init, step = tbert.make_tp_train_step(cfg, axes, device="cpu")
    state = init(model=weights.load_jax_tree(tbert.Bert(cfg, "cpu"), host))
    state, loss = step(state, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert_grads_close(weights.bert_tp_to_jax(list(state[0]), axes, "grads"),
                       jgrads, "bert whole parts")


def test_shapes_that_do_not_divide_are_refused_by_name():
    """A d_ff that tp does not divide and ep that does not divide the
    experts stay refused, as JAX's ``device_put`` of ``param_shardings``
    and of ``moe_shardings`` fails on them."""
    from jax.sharding import Mesh

    from container_engine_accelerators_tpu.parallel import moe as jmoe

    shape = dict(TF_SHAPE, d_ff=126)
    with pytest.raises(ValueError, match="tp=4 must divide d_ff=126"):
        tp_lm.make_train_step(ttf.TransformerConfig(**shape),
                              tpar.Axes.in_process(tp=4), device="cpu")
    cfg = jtf.TransformerConfig(**shape)
    mesh = jtrain_cli.build_mesh(4, 1, 4)
    with pytest.raises(ValueError, match="divisible by 4"):
        jax.device_put(jtf.init_params(jax.random.PRNGKey(0), cfg),
                       jtf.param_shardings(cfg, mesh))
    with pytest.raises(ValueError, match="ep=3 must divide n_experts=4"):
        tp_lm.make_train_step(ttf.TransformerConfig(**MOE_SHAPE),
                              tpar.Axes.in_process(ep=3), device="cpu")
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), 16, 32, 4,
                                  dtype=jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:3]), ("ep",))
    with pytest.raises(ValueError, match="divisible by 3"):
        jax.device_put(params, jmoe.moe_shardings(mesh))


# Widths JAX's ``param_shardings`` puts on tp and ``device_put`` cannot
# cut: (the model, its shape, tp, the port's message).
REFUSED_WIDTHS = {
    "moe_dff": ("transformer", dict(MOE_SHAPE, d_ff=126), 4,
                "tp=4 must divide d_ff=126"),
    "head_width": ("transformer", dict(TF_SHAPE, d_ff=192), 3,
                   "tp=3 must divide n_heads\\*head_dim=64"),
    "bert_dff": ("bert", dict(BERT_SHAPE, d_ff=126), 4,
                 "tp=4 must divide d_ff=126"),
}


@pytest.mark.parametrize("name", sorted(REFUSED_WIDTHS))
def test_widths_jax_cannot_shard_are_refused_as_jax_does(name):
    """An MoE FFN's experts' F, a head width (n_heads·head_dim) or BERT's
    d_ff that tp does not divide: the port refuses it by name before any
    shard is made, and JAX's ``device_put`` of its ``param_shardings`` on
    the tp mesh fails on the same weights."""
    from jax.sharding import Mesh

    model, shape, tp, message = REFUSED_WIDTHS[name]
    axes = tpar.Axes.in_process(tp=tp)
    mesh = Mesh(np.asarray(jax.devices()[:tp]), ("tp",))
    if model == "bert":
        jmod, cfg = jbert, jbert.BertConfig(**shape)
        with pytest.raises(ValueError, match=message):
            tbert.make_tp_train_step(tbert.BertConfig(**shape), axes,
                                     device="cpu")
    else:
        jmod, cfg = jtf, jtf.TransformerConfig(**shape)
        with pytest.raises(ValueError, match=message):
            tp_lm.make_train_step(ttf.TransformerConfig(**shape), axes,
                                  device="cpu")
    with pytest.raises(ValueError, match=f"divisible by {tp}"):
        jax.device_put(jmod.init_params(jax.random.PRNGKey(0), cfg),
                       jmod.param_shardings(cfg, mesh))


# -- gloo worlds ----------------------------------------------------------------

WORLD_CASES = {
    2: {"ring_tp2": ("transformer", 1, 2, "ring"),
        "off_tp2": ("transformer", 1, 2, "off"),
        "moe_tp2": ("moe", 1, 2, "auto"),
        "bert_tp2": ("bert", 1, 2, None)},
    4: {"ring_dp2_tp2": ("transformer", 2, 2, "ring"),
        "off_dp2_tp2": ("transformer", 2, 2, "off"),
        "bert_dp2_tp2": ("bert", 2, 2, None),
        # tp 4 over 2 KV heads and over BERT's 2 heads: attention whole.
        "kv2_tp4": ("kv2", 1, 4, "auto"),
        "bert_heads2_tp4": ("bert_heads2", 1, 4, None)},
}
WORLD_SHAPES = {"transformer": TF_SHAPE, "moe": MOE_SHAPE,
                "kv2": dict(TF_SHAPE, n_kv_heads=2), "bert": BERT_SHAPE,
                "bert_heads2": dict(BERT_SHAPE, n_heads=2)}


@pytest.fixture(scope="module")
def tp_worlds(tmp_path_factory):
    import pickle

    out = {}
    for world, cases in WORLD_CASES.items():
        workdir = tmp_path_factory.mktemp(f"tp{world}")
        inputs, refs = {}, {}
        for name, (model, dp, tp, overlap) in cases.items():
            shape = WORLD_SHAPES[model]
            if model.startswith("bert"):
                batch = bert_batch(rows=2 * dp, shape=shape)
                host, jloss, jgrads = jax_bert(batch, dp, tp, shape)
                inputs[name] = {"model": "bert", "cfg": shape,
                                "params": host, "batch": batch, "sp": 1,
                                "tp": tp, "ep": 1, "overlap": None}
            else:
                toks = tokens(batch=2 * dp)
                host, jloss, jgrads, _ = jax_transformer(
                    shape, toks, dp, tp, overlap=overlap)
                inputs[name] = {"model": "transformer", "cfg": shape,
                                "params": host, "batch": {"tokens": toks},
                                "sp": 1, "tp": tp, "ep": 1,
                                "overlap": overlap}
            refs[name] = (jloss, jgrads)
        with open(workdir / "tp_in.pkl", "wb") as f:
            pickle.dump(inputs, f)
        out[world] = (refs, worker.spawn("tp_train", world, str(workdir)))
    return out


@pytest.mark.parametrize("world,name", [(w, n) for w, cases in
                                        WORLD_CASES.items() for n in cases])
def test_gloo_world_matches_jax(tp_worlds, world, name):
    refs, ranks = tp_worlds[world]
    jloss, jgrads = refs[name]
    for rank, outs in enumerate(ranks):
        got = outs[name]
        np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {rank}")
        assert_grads_close(got["grads"], jgrads, f"{name} rank {rank}")


# -- train_cli --tp --------------------------------------------------------------

CLI = ["--device", "cpu", "--d-model", "64", "--n-heads", "4", "--seq-len",
       "32", "--vocab-size", "128", "--steps", "2", "--dtype", "float32"]


@pytest.mark.parametrize("flags", [
    ["--model", "transformer", "--tp", "2"],
    ["--model", "transformer", "--tp", "2", "--n-experts", "4"],
    ["--model", "bert", "--tp", "2"],
    ["--model", "mnist", "--tp", "2"]], ids=["ring", "moe_off", "bert",
                                             "mnist"])
def test_cli_tp_trains_as_one_rank_does(tmp_path, capsys, flags):
    """Two ``--distributed`` ranks at tp 2 print the loss of the same
    flags on one process (same seed, same batches), f32."""
    runs, markers = worker.cli_world(flags + CLI, str(tmp_path), "tp")
    assert [rc for rc, _, _ in runs] == [0, 0], runs[0][2][-2000:]
    assert train_cli.main([f for f in flags if f not in ("--tp", "2")]
                          + CLI) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for _, result, _ in runs:
        assert result["n_devices"] == 2 and result["steps_run"] == 2
        np.testing.assert_allclose(result["loss"], one["loss"],
                                   rtol=LOSS_RTOL)
    assert markers[1] == "TPU_BOOTSTRAP_OK rank=1 world=2\n"


def test_cli_tp_on_one_rank_fails_as_jax_s_plan_does():
    with pytest.raises(ValueError, match="cannot factor 1 devices"):
        train_cli.main(["--model", "transformer", "--device", "cpu",
                        "--tp", "2"])
