# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Tensor- and expert-parallel training of the decoder.

The port of the tp and ep paths of
``container_engine_accelerators_tpu/models/transformer.py``'s training
forward: ``param_shardings`` (:122) and ``_ring_tp_param_specs`` (:385)
give the shards, ``_ring_tp_layer`` (:343) and ``_ring_tp_hidden`` (:417)
the ring path, the ring ``lm_head`` (:537) its head, and GSPMD's
collectives the off path. Every rank holds a ``transformer.Transformer``
whose parameters are its shards (``split_params``): wq/wk/wv/w1/w3 split
by columns and wo/w2 by rows over tp (Megatron's layout), the experts of
an MoE FFN over ep and their F dim over tp, everything else whole. A
part tp does not divide (``whole_parts``: the attention where tp does
not divide n_heads or n_kv_heads, the vocabulary) is held whole on every
tp rank and computed there alike with no collective: the unsplit
function, which GSPMD computes where it cuts through a head or leaves
the vocabulary whole. Widths JAX's ``device_put`` cannot shard over tp
(d_ff, n_heads·head_dim, n_kv_heads·head_dim) are refused as it fails
(``check_config``). Its gradients, and its input's, are whole on every rank
already, so they are not summed over tp; the split parts keep their
sums. Its weights are whole in every tp shard's checkpoint.

``resolve_overlap`` (``models/transformer.py``) picks the path:

  ring  the residual stream sequence-sharded over tp: each layer's
        entering products all-gather the sequence shards round the ring
        while their chunk products run (q/k/v share one ring, w1/w3
        another), the exiting ones reduce-scatter straight back to the
        shard (``parallel/overlap.py``); attention is local over the
        rank's hq/tp query and hkv/tp key/value heads on the whole
        sequence (``flash_attention``: kernels 1, 3 and 4, the streamed
        forms past S 8192). The tied head ring-gathers the final
        shards against the rank's vocabulary rows of the embedding.
  off   activations replicated over tp, one all-reduce after each
        split row-parallel product (JAX's GSPMD path where the ring does
        not apply: an sp axis, experts, heads that do not divide). The
        sp ring (``ring_attention.ring_attend`` over ``axes.sp``) runs
        on the tp-local heads. The MoE FFN is
        ``parallel/moe.moe_ffn_parallel``, each sequence routed whole
        over sp.

With the vocabulary split both heads leave vocab-sharded f32 logits, and
the cross entropy is vocab-parallel
(``tensor_parallel.vocab_parallel_xent``): gathering 1 × 4096 × 128256
f32 logits would cost 2.1 GB a rank. The embedding lookup is the rank's
sequence shard (ring) or vocab-parallel (off), so a rank's embedding
gradient is a part of the whole in both, summed over tp with the norms'
under ring (they see a sequence shard), one flat f32 buffer a group,
after ``backward()`` (``tensor_parallel.reduce_grads``). A whole
vocabulary is looked up and projected whole: its gradient is whole on
the off path and a sequence shard's under ring. The loss is the whole
loss on every tp and ep rank, scaled by the rank's share of the tokens
over dp and sp and summed over those axes only.

Transports: ``Axes.of_mesh(mesh)`` gives this process's rank of the
mesh's "tp", "ep" and "sp" rings (``P2P``: NCCL or gloo),
``Axes.in_process`` every rank of one axis in this process (the CPU
tests and the card check; sp ranks held so share one shard, whose
gradients then sum over sp as they accumulate). Per-layer remat
checkpoints each layer of every rank held; its recompute issues the
layer's collectives again, in the same order on every rank.
"""

import torch
from torch.utils.checkpoint import checkpoint

from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.parallel import (
    data_parallel,
    moe,
    overlap as ring_mm,
    ring_attention,
)
from container_engine_accelerators_tpu_torch.parallel import (
    tensor_parallel as tpar,
)


def whole_parts(cfg, tp):
    """The parts tp does not divide, each held whole on every tp rank and
    computed there alike, with no collective: "attn" (q, k, v and wo)
    unless tp divides both n_heads and n_kv_heads, "vocab" (the embedding
    lookup and the head) unless it divides vocab_size. A whole part is
    the unsplit function, which is what GSPMD computes where its shards
    cut through a head (JAX shards the n_heads·head_dim columns) or
    leave the vocabulary whole (JAX's embedding is not tp-sharded); it
    costs each rank the part's whole weights, where JAX holds a shard."""
    if tp == 1:
        return frozenset()
    parts = set()
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        parts.add("attn")
    if cfg.vocab_size % tp:
        parts.add("vocab")
    return frozenset(parts)


def layout(cfg, tp):
    """``tensor_parallel.TRANSFORMER_TP`` without the whole parts'
    weights: the shard layout at this tp."""
    whole = whole_parts(cfg, tp)
    return {name: dim for name, dim in tpar.TRANSFORMER_TP.items()
            if name.split(".")[0] not in whole}


def check_config(cfg, axes):
    """What JAX's ``device_put`` of ``param_shardings`` needs, refused as
    it fails there: tp dividing each width it shards over tp (the q and
    k/v columns n_heads·head_dim and n_kv_heads·head_dim, d_ff, an MoE
    FFN's experts' F among them), and ep dividing the experts."""
    tp, ep = axes.tp.size, axes.ep.size
    widths = {"d_ff": cfg.d_ff,
              "n_heads*head_dim": cfg.n_heads * cfg.head_dim,
              "n_kv_heads*head_dim": cfg.n_kv_heads * cfg.head_dim}
    for name, width in widths.items():
        if width % tp:
            raise ValueError(f"tp={tp} must divide {name}={width}")
    if ep > 1 and cfg.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")


def split_params(model, axes):
    """The shards of ``model`` the ranks of ``axes`` hold, an
    ``nn.ModuleList`` in list order (new tensors; the model is left as it
    is): :func:`layout`'s parts split, the whole parts whole."""
    cfg = model.cfg
    return tpar.split_module(model, lambda: tf.Transformer(cfg, "meta"),
                             axes, layout(cfg, axes.tp.size),
                             moe=bool(cfg.n_experts))


def merged(shards, axes, which="params"):
    """The whole model's parameters (``which="grads"``: gradients) by
    name from every rank's shards (``tensor_parallel.merged``)."""
    cfg = shards[0].cfg
    return tpar.merged(shards, axes, layout(cfg, axes.tp.size), which=which,
                       moe=bool(cfg.n_experts))


def _layer_ring(layers, xs, positions, axes, attend, whole):
    """JAX's ``_ring_tp_layer`` on every rank held (``tf.block`` with the
    ring collective matmuls): xs (B, S/tp, D) sequence shards, q/k/v over
    one ring and w1/w3 over another, wo and w2 reduce-scattered back to
    the shard; attention local over the rank's heads on the whole
    sequence. Returns (xs, None)."""
    tp = axes.tp
    xs, _, _ = tf.block(
        layers, xs, positions, attend,
        enter=lambda hs, wss: ring_mm.allgather_matmul(hs, wss, tp),
        leave=lambda ys, ws: ring_mm.matmul_reducescatter(ys, ws, tp))
    return xs, None


def _products(axes, split):
    """(enter, leave) of a part of the off path: a split part's column
    shards (``column_products``: the input gradient's partials summed
    over tp in f32) and row-parallel sums (``row_parallel``); a whole
    part's plain products, whose input gradient is whole already."""
    if not split:
        return tf.dense_products, tf.dense_sums
    return (lambda hs, wss: tpar.column_products(hs, wss, [axes.tp]),
            lambda ys, ws: tpar.row_parallel(ys, ws, axes))


def _layer_off(layers, xs, positions, axes, attend, whole):
    """One block on every rank held with activations replicated over tp
    (``tf.block``): the attention split or whole (:func:`_products`), the
    FFN split; an MoE FFN over ep and tp (and its sequences routed whole
    over sp). Returns (xs, the MoE aux per rank or None)."""
    cfg = layers[0].attn.cfg
    moe_ffn = None
    if cfg.n_experts:
        def moe_ffn(hs):
            return moe.moe_ffn_parallel(
                hs, [{"router": lp.ffn.router, "w1": lp.ffn.w1,
                      "w2": lp.ffn.w2} for lp in layers], axes,
                top_k=cfg.expert_top_k, capacity_factor=cfg.capacity_factor)
    enter, leave = _products(axes, "attn" not in whole)
    ffn_enter, ffn_leave = _products(axes, True)
    xs, _, aux = tf.block(
        layers, xs, positions, attend, enter=enter, leave=leave,
        moe_ffn=moe_ffn, ffn_enter=ffn_enter, ffn_leave=ffn_leave)
    return xs, aux


def _hidden(shards, inputs, positions, axes, mode, attend, remat,
            whole):
    """The embedding and the layer stack on every rank held (``inputs``
    and ``positions`` each rank's) → (xs, aux summed over the layers per
    rank or None)."""
    cfg = shards[0].cfg
    if mode == "ring":
        n, index = axes.tp.size, axes.tp_index
        per = inputs[0].shape[1] // n
        xs = [s.embed[t[:, index(j) * per:(index(j) + 1) * per]]
              for j, (s, t) in enumerate(zip(shards, inputs))]
    elif "vocab" in whole:
        xs = [s.embed[t] for s, t in zip(shards, inputs)]
    else:
        xs = tpar.vocab_parallel_embed([s.embed for s in shards], inputs,
                                       axes)
    layer_fn = _layer_ring if mode == "ring" else _layer_off
    aux = None
    for i in range(cfg.n_layers):
        layers = [s.layers[i] for s in shards]
        if remat:
            xs, layer_aux = checkpoint(layer_fn, layers, xs, positions, axes,
                                       attend, whole,
                                       use_reentrant=False)
        else:
            xs, layer_aux = layer_fn(layers, xs, positions, axes,
                                     attend, whole)
        if layer_aux is not None:
            aux = layer_aux if aux is None else \
                [a + b for a, b in zip(aux, layer_aux)]
    return xs, aux


def _xents(shards, xs, targets, axes, mode, whole):
    """Final norm, the tied head and the mean cross entropy per rank
    held, each the whole loss of its targets. A split vocabulary leaves
    vocab-sharded f32 logits (B, S, V / tp) over the rank's rows and the
    cross entropy is vocab-parallel. A whole one gives every rank the
    whole logits of its positions: all of them on the off path; under
    ring its sequence shard's, whose cross entropy sums are added over
    tp."""
    tp = axes.tp
    hs = [tf._rms_norm(x, s.ln_f.weight) for x, s in zip(xs, shards)]
    if "vocab" in whole:
        if mode != "ring":
            return [tf.softmax_xent((h @ s.embed.T).float(), t)
                    for h, s, t in zip(hs, shards, targets)]
        per = hs[0].shape[1]
        sums = []
        for j, (h, s, t) in enumerate(zip(hs, shards, targets)):
            lo = axes.tp_index(j) * per
            mine = t[:, lo:lo + per]
            sums.append(tf.softmax_xent((h @ s.embed.T).float(), mine)
                        * mine.numel())
        return [total / t.numel() for total, t in
                zip(tpar.reduce_from([tp], sums), targets)]
    rows = []
    for j, s in enumerate(shards):
        lo, hi = tpar.vocab_range(s.embed.shape[0], tp.size, axes.tp_index(j))
        rows.append(s.embed[lo:hi])
    if mode == "ring":
        outs = ring_mm.allgather_matmul(hs, [r.T for r in rows], tp)
    else:
        outs = [o for (o,) in tpar.column_products(
            hs, [(r.T,) for r in rows], [tp])]
    return tpar.vocab_parallel_xent([o.float() for o in outs], targets, axes)


def _attend_for(axes, attn_impl):
    """``block``'s ``attend``: the ring over ``axes.sp`` above one
    rank (the flash ring for "flash", else the plain block ring), each
    rank's own attention otherwise."""
    if axes.sp.size > 1:
        return ring_attention.ring_attend(
            axes.sp, "flash" if attn_impl == "flash" else "plain")
    return tf.each_rank(tf.ATTN_IMPLS[attn_impl])


def resolve(cfg, axes, mesh, batch_rows, seq, overlap=None):
    """The path a step takes ("ring" or "off"; ``tf.resolve_overlap``
    over the mesh's axis sizes and the axes held in this process)."""
    sizes = {**tf.axis_sizes(mesh), "tp": axes.tp.size, "ep": axes.ep.size,
             "sp": axes.sp.size}
    return tf.resolve_overlap(overlap, cfg, sizes, seq=seq, batch=batch_rows)


def loss_fn(shards, batch, axes, mesh=None, overlap=None, remat=False,
            attn_impl="flash"):
    """Per rank held, its share of the global loss (next-token cross
    entropy, + ``moe_aux_weight`` × the MoE aux): the whole loss over
    the rank's dp rows and sp positions of the GLOBAL batch, scaled by
    its tokens over the global count. Returns (shares, the path)."""
    cfg = shards[0].cfg
    device = shards[0].embed.device
    tokens = torch.as_tensor(batch["tokens"], device=device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    global_tokens = inputs.numel()
    batch_rows, seq = inputs.shape
    mode = resolve(cfg, axes, mesh, batch_rows, seq, overlap)
    whole = whole_parts(cfg, axes.tp.size)
    sp = axes.sp.size
    if seq % sp:
        raise ValueError(f"sequence length {seq} must divide by sp={sp}")
    local = seq // sp
    inputs = data_parallel.shard_rows(inputs, mesh)
    targets = data_parallel.shard_rows(targets, mesh)
    ins, tgts, poss = [], [], []
    for j in range(len(shards)):
        lo = axes.sp_index(j) * local
        ins.append(inputs[:, lo:lo + local])
        tgts.append(targets[:, lo:lo + local])
        poss.append((lo + torch.arange(local, device=device)).expand(
            inputs.shape[0], local))
    xs, aux = _hidden(shards, ins, poss, axes, mode,
                      _attend_for(axes, attn_impl), remat, whole)
    losses = _xents(shards, xs, tgts, axes, mode, whole)
    if cfg.n_experts:
        losses = [loss + cfg.moe_aux_weight * (a / max(cfg.n_layers, 1))
                  for loss, a in zip(losses, aux)]
    return [loss * (t.numel() / global_tokens)
            for loss, t in zip(losses, tgts)], mode


def tp_partial(mode, whole=frozenset()):
    """Which replicated parameters a tp rank holds part of the gradient
    of: the embedding under ring (its lookup and head see a sequence
    shard) and wherever the vocabulary is split (each rank's rows), the
    norms under ring (they see a sequence shard). A whole part's
    gradients are whole on every rank and are not summed."""
    def partial(name):
        if name == "embed":
            return mode == "ring" or "vocab" not in whole
        return mode == "ring" and (name == "ln_f.weight" or name.endswith(
            (".ln1.weight", ".ln2.weight")))
    return partial


def make_train_step(cfg, axes, mesh=None, optimizer=None, remat=True,
                    device="cuda", overlap=None, attn_impl="flash"):
    """Returns (init_state, train_step) over ``axes``
    (``tensor_parallel.Axes``) and, for the data axes, ``mesh``.

    ``init_state(seed=0, model=None)`` draws the whole model from the
    seed on ``device`` (the unsplit step's weights for the same seed) or
    takes ``model``, keeps the shards of the ranks held and builds the
    optimizer (default ``transformer.adamw``) over them: state = (the
    shards, an ``nn.ModuleList``; the optimizer). ``train_step(state,
    batch)`` takes the GLOBAL batch and returns (state, the global loss,
    f32); after it each shard parameter's ``.grad`` holds its gradient,
    the replicated ones whole."""
    check_config(cfg, axes)
    device = tf.resolve_device(device)
    make_optimizer = optimizer or tf.adamw

    def init_state(seed=0, model=None):
        if model is None:
            model = tf.init_params(cfg, device=device, seed=seed)
        tf._require_dense(model)
        shards = split_params(model, axes)
        return shards, make_optimizer(list(shards.parameters()))

    def train_step(state, batch):
        shards, opt = state
        opt.zero_grad(set_to_none=True)
        losses = backward(shards, batch, axes, mesh=mesh, overlap=overlap,
                          remat=remat, attn_impl=attn_impl)
        # sp ranks held here hold shares of the loss, tp or ep ranks
        # each the whole rank's.
        share = sum(losses) if len(axes.sp.indices) > 1 else losses[0]
        loss = data_parallel.sum_loss(share, mesh)
        opt.step()
        return state, loss

    return init_state, train_step


def backward(shards, batch, axes, mesh=None, overlap=None, remat=True,
             attn_impl="flash"):
    """The step's gradients into the shards' ``.grad`` (each shard
    parameter's, the replicated ones whole): ``loss_fn``, one backward
    of every rank's loss seeded with 1 (the collectives' backwards carry
    what the processes would exchange), then ``reduce_grads``. Returns
    the ranks' loss shares."""
    losses, mode = loss_fn(list(shards), batch, axes, mesh=mesh,
                           overlap=overlap, remat=remat, attn_impl=attn_impl)
    sum(losses).backward()
    tpar.reduce_grads(shards, axes, mesh, tp_partial(
        mode, whole_parts(shards[0].cfg, axes.tp.size)))
    return losses


def n_params(cfg):
    """The whole model's parameter count (the MFU estimate's N)."""
    return sum(p.numel() for p in tf.Transformer(cfg, "meta").parameters())
