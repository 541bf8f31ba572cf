# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Tensor-parallel serving of the decoder.

The port of the tensor-parallel serving half of
``container_engine_accelerators_tpu/models/transformer.py``:
``serving_shardings`` (:160; its "tp=N must divide" check is
:func:`check_config`), the Megatron layout of ``param_shardings`` (:122)
without a dp axis, the cache spec (:176: the K/V heads split over tp), and
the two paths a prefill takes with a mesh (``prefill`` :956,
``prefill_into_slot`` :924: the ring collective matmuls of
``_ring_tp_hidden`` :417 where ``resolve_overlap`` allows, GSPMD's
all-reduces otherwise). Every decode step and every prefill segment takes
the "off" path, as in JAX.

A :class:`ShardedModel` holds the shards of the ranks one process holds
(``tensor_parallel.Axes``): one rank of a world of one process per GPU
(``Axes.of_mesh``, the all-reduces over NCCL or gloo), or every rank in
one process (``Axes.in_process``, the CPU tests and the card check). Its
shards are ``transformer.Transformer`` modules whose wq/wk/wv/w1/w3 hold
their columns and wo/w2 their rows of the whole model's (Megatron's
layout, ``tensor_parallel.TRANSFORMER_TP``); the embedding and the norms
are whole on every rank, as JAX's tp-only mesh replicates them, so the
tied head gives the full logits on every rank. It has the serving view
``transformer.Transformer`` has (``tp``, ``ranks``, ``kv_heads``,
``leave``), which the serving programs of ``models/transformer.py`` run
over: attention at n_heads/tp query and n_kv_heads/tp key/value heads a
rank, each rank's caches holding its own heads (a process holding every
rank keeps them in rank order, the whole model's head order), the
activations replicated, and each row-parallel product's f32 partials
all-reduced over tp and cast once (:meth:`ShardedModel.leave`).

A mixture-of-experts layer splits as JAX's ``serving_shardings`` does on
a tp-only mesh (``moe_w1`` P(None, ep, dp, tp): ep and dp absent): the
experts' F dim over tp (``ffn.w1`` (E, D, F) by columns, ``ffn.w2`` (E,
F, D) by rows, ``TRANSFORMER_TP``'s names), the router whole on every
rank. Each rank routes the replicated input on the whole router, runs
its columns of every expert, and the combine's f32 partials are
all-reduced over tp once and cast once (:meth:`ShardedModel.moe_ffn`),
the rule of the row-parallel products. Its prefill takes the off path
(``transformer.resolve_overlap`` gives no ring with experts).

``--quantize int8`` under tp (:func:`quantize_shards`): a column shard
keeps its own per-channel scales; a row-parallel shard (wo, w2) takes the
scale of the whole weight, the max over tp (the all-reduce GSPMD inserts
in JAX), so every rank's int8 shard equals the whole weight's quantized
and then split. Its f32 partials come from ``int8_mm(...,
out_dtype=torch.float32)``.
"""

import functools

import torch
from torch import nn

from container_engine_accelerators_tpu_torch.models import quantization as q8
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.parallel import moe
from container_engine_accelerators_tpu_torch.parallel import (
    overlap as ring_mm,
)
from container_engine_accelerators_tpu_torch.parallel import (
    tensor_parallel as tpar,
)

# The row-parallel layer matrices (their contraction dim split over tp),
# by their names in a layer's attn or ffn.
ROW_PARALLEL = tuple(name.split(".")[1] for name, dim
                     in tpar.TRANSFORMER_TP.items() if dim == -2)


def check_config(cfg, tp):
    """JAX's ``serving_shardings`` check: tp must divide the query and
    key/value heads and d_ff."""
    if cfg.n_kv_heads % tp or cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads} and d_ff={cfg.d_ff}"
        )


class ShardedModel(nn.Module):
    """The shards (``transformer.Transformer`` modules, in ``axes.tp``'s
    ``indices`` order) of the tp ranks this process holds, with the
    serving view the serving programs take (module docstring)."""

    def __init__(self, cfg, shards, axes):
        super().__init__()
        self.cfg = cfg
        self.axes = axes
        self.shards = nn.ModuleList(shards)
        self.tp = axes.tp.size

    @property
    def ranks(self):
        return list(self.shards)

    @property
    def device(self):
        return self.shards[0].embed.device

    @property
    def embed(self):
        return self.shards[0].embed

    @property
    def ln_f(self):
        return self.shards[0].ln_f

    @property
    def kv_heads(self):
        return self.cfg.n_kv_heads // self.tp * len(self.shards)

    def leave(self, xs, ws):
        """Σ over tp of each rank's row-parallel product: the partials in
        f32 (``int8_mm``'s f32 epilogue for an int8 shard), all-reduced
        and cast once to the activations' dtype, as the whole product
        rounds once."""
        parts = [ring_mm._chunk_mm(x, w, torch.float32)
                 for x, w in zip(xs, ws)]
        sums = self.axes.tp.all_reduce(parts)
        return [p.to(x.dtype) for p, x in zip(sums, xs)]

    def moe_ffn(self, layers):
        """``transformer.block``'s ``moe_ffn`` for ``layers`` (one a rank
        held), None for a dense FFN: ``moe.moe_ffn_parallel`` at ep 1.
        Each rank routes its (replicated) normed input per leading-dim
        group on the whole router (``moe.moe_ffn``'s groups and
        capacity), runs every expert on its columns of F, and the f32
        combines are all-reduced over tp and cast once."""
        if not self.cfg.n_experts:
            return None
        params = [{"router": lp.ffn.router, "w1": lp.ffn.w1,
                   "w2": lp.ffn.w2} for lp in layers]
        return functools.partial(
            moe.moe_ffn_parallel, params=params, axes=self.axes,
            top_k=self.cfg.expert_top_k,
            capacity_factor=self.cfg.capacity_factor)

    def prefill_forward(self, tokens, logits_at, overlap=None):
        """A prefill's forward on every rank held → (f32 logits (B, 1, V)
        at ``logits_at`` ("last" or an index), (ks, vs) (L, B, Hkv held,
        P, hd)). The ring path (``transformer.resolve_overlap``, None →
        the config's ``overlap``): the residual stream sequence-sharded
        over tp, q/k/v and w1/w3 each on one gathering ring, wo and w2
        reduce-scattered back to the shard, attention over the rank's
        heads on the whole sequence; the rank holding ``logits_at``'s row
        shares it over tp, and the head runs on it whole. The off path:
        the serving programs' replicated activations."""
        cfg = self.cfg
        batch, seq = tokens.shape
        ranks = self.ranks
        mode = tf.resolve_overlap(overlap, cfg, {"tp": self.tp}, seq=seq,
                                  batch=batch)
        positions = torch.arange(seq, device=tokens.device).expand(
            batch, seq)
        idx = seq - 1 if isinstance(logits_at, str) else int(logits_at)
        tp = self.axes.tp
        if mode == "ring":
            per = seq // self.tp
            xs = [s.embed[tokens[:, r * per:(r + 1) * per]]
                  for s, r in zip(ranks, tp.indices)]

            def enter(hs, wss):
                return ring_mm.allgather_matmul(hs, wss, tp)

            def leave(ys, ws):
                return ring_mm.matmul_reducescatter(ys, ws, tp)
        else:
            xs = [self.embed[tokens]] * len(ranks)
            enter, leave = tf.dense_products, self.leave
        ks, vs = [], []
        for i in range(cfg.n_layers):
            layers = [s.layers[i] for s in ranks]
            xs, kvs, _ = tf.block(layers, xs, positions,
                                  tf.each_rank(tf._flash_attend),
                                  enter=enter, leave=leave,
                                  moe_ffn=self.moe_ffn(layers))
            ks.append(torch.cat([k for k, _ in kvs], dim=1))
            vs.append(torch.cat([v for _, v in kvs], dim=1))
        if mode == "ring":
            owner, row = divmod(idx, per)
            x = tp.share([x[:, row:row + 1].contiguous() if r == owner
                          else torch.empty_like(x[:, :1])
                          for x, r in zip(xs, tp.indices)], owner)[0]
        else:
            x = xs[0][:, idx:idx + 1]
        logits = tf.lm_head(x, self.ln_f.weight, self.embed)
        return logits, (torch.stack(ks), torch.stack(vs))


def _set(module, name, tensor):
    tpar._set_param(module, name, nn.Parameter(tensor, requires_grad=False))


def split(model, axes):
    """The :class:`ShardedModel` of ``model``'s (a whole
    ``transformer.Transformer``) shards that the ranks of ``axes`` hold:
    new tensors for the split matrices; the replicated embedding and
    norms are the model's own, shared by every rank held."""
    cfg = model.cfg
    check_config(cfg, axes.tp.size)
    shards = []
    with torch.no_grad():
        for r in axes.tp.indices:
            shard = tf.Transformer(cfg, "meta")
            for name, p in model.named_parameters():
                dim, _ = tpar.shard_dims(name, tpar.TRANSFORMER_TP)
                if dim is None:
                    _set(shard, name, p.detach())
                else:
                    _set(shard, name, tpar._piece(
                        p.detach(), dim, axes.tp.size, r).clone())
            shards.append(shard)
    return ShardedModel(cfg, shards, axes)


def init_shards(cfg, axes, device="cuda", seed=0):
    """Random weights from ``seed`` where each rank materialises only its
    own shard (JAX's init under ``out_shardings``: an 8B model never has
    to fit one card): every whole tensor of ``transformer.init_params``
    is drawn in its order from the same generator, one at a time, and
    each rank held keeps its piece, so the merged shards equal
    ``init_params(cfg, device, seed)``. The replicated tensors are drawn
    once and shared by the ranks held."""
    check_config(cfg, axes.tp.size)
    device = tf.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.torch_dtype
    shards = [tf.Transformer(cfg, "meta") for _ in axes.tp.indices]

    def put(name, whole):
        dim, _ = tpar.shard_dims(name, tpar.TRANSFORMER_TP)
        for shard, r in zip(shards, axes.tp.indices):
            if dim is None:
                _set(shard, name, whole)
            else:
                _set(shard, name, tpar._piece(
                    whole, dim, axes.tp.size, r).clone())

    def draw(name, shape, scale, dtype):
        put(name, (torch.randn(shape, generator=gen, device=device)
                   * scale).to(dtype))

    with torch.no_grad():
        draw("embed", (cfg.vocab_size, cfg.d_model), 0.02, dt)
        whole = tf.Transformer(cfg, "meta")
        for i, layer in enumerate(whole.layers):
            pre = f"layers.{i}."
            # transformer.init_params' order: wq, wk, wv, wo, then the
            # FFN's parameters, each in its own dtype (an MoE router is
            # f32); the fan in is dim -2.
            for key, w in (("attn.wq", layer.attn.wq),
                           ("attn.wk", layer.attn.wk),
                           ("attn.wv", layer.attn.wv),
                           ("attn.wo", layer.attn.wo),
                           *(("ffn." + n, p) for n, p in
                             layer.ffn.named_parameters())):
                draw(pre + key, tuple(w.shape), w.shape[-2] ** -0.5,
                     w.dtype)
            for norm in ("ln1.weight", "ln2.weight"):
                put(pre + norm, torch.ones(cfg.d_model, dtype=dt,
                                           device=device))
        put("ln_f.weight", torch.ones(cfg.d_model, dtype=dt, device=device))
    return ShardedModel(cfg, shards, axes)


def quantize_shards(model, keys=q8.DENSE_WEIGHT_KEYS):
    """``quantization.quantize_params`` on a :class:`ShardedModel`, in
    place: a column shard's per-channel scales are its own; a row
    shard's (wo, w2) are the whole weight's, from the max over tp of the
    shards' column maxima (all-reduced in f32, exact for the weight's
    dtype). Each rank's int8 shard then equals the whole weight's
    quantized and split. Returns ``model``."""
    tp = model.axes.tp
    with torch.no_grad():
        for i in range(model.cfg.n_layers):
            for owner_name in q8.weight_owners(model.cfg):
                owners = [getattr(s.layers[i], owner_name)
                          for s in model.shards]
                for key in keys:
                    ws = [getattr(o, key, None) for o in owners]
                    if ws[0] is None or q8.is_quantized(ws[0]):
                        continue
                    amaxes = [None] * len(ws)
                    if key in ROW_PARALLEL:
                        local = [w.detach().abs().amax(dim=-2, keepdim=True)
                                 .float() for w in ws]
                        amaxes = [m.to(w.dtype) for m, w in
                                  zip(tp.all_reduce(local, "max"), ws)]
                    for owner, w, amax in zip(owners, ws, amaxes):
                        qw = q8.quantize_weight(w.detach(), amax=amax)
                        delattr(owner, key)
                        setattr(owner, key, q8.Int8Weight.from_jax_layout(
                            qw["q"], qw["scale"]))
    return model
