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
an MoE FFN over ep and their F dim over tp, everything else whole.

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
        row-parallel product (JAX's GSPMD path where the ring does not
        apply: an sp axis, experts, shapes that do not divide). The sp
        ring (``ring_attention`` over the mesh's "sp" axis) runs on the
        tp-local heads. The MoE FFN is ``parallel/moe.moe_ffn_parallel``.

Both heads leave vocab-sharded f32 logits, and the cross entropy is
vocab-parallel (``tensor_parallel.vocab_parallel_xent``): gathering
1 × 4096 × 128256 f32 logits would cost 2.1 GB a rank. The embedding
lookup is the rank's sequence shard (ring) or vocab-parallel (off), so a
rank's embedding gradient is a part of the whole in both, summed over tp
with the norms' under ring (they see a sequence shard), one flat f32
buffer a group, after ``backward()`` (``tensor_parallel.reduce_grads``).
The loss is the whole loss on every tp and ep rank, scaled by the rank's
share of the tokens over dp and sp and summed over those axes only.

Transports: ``Axes.of_mesh(mesh)`` gives this process's rank of the
mesh's "tp" and "ep" rings (``P2P``: NCCL or gloo), ``Axes.in_process``
every rank of one axis in this process (the CPU tests and the card
check). Per-layer remat checkpoints each layer of every rank held; its
recompute issues the layer's collectives again, in the same order on
every rank.
"""

import torch
from torch.utils.checkpoint import checkpoint

from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.parallel import (
    data_parallel,
    moe,
    overlap as ring_mm,
)
from container_engine_accelerators_tpu_torch.parallel import (
    tensor_parallel as tpar,
)


def check_config(cfg, axes):
    """What the shards need: heads, kv heads, d_ff and the vocabulary
    dividing over tp, experts over ep."""
    tp, ep = axes.tp.size, axes.ep.size
    for name in ("n_heads", "n_kv_heads", "d_ff", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"tp={tp} must divide {name}="
                             f"{getattr(cfg, name)}")
    if ep > 1 and cfg.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")


def split_params(model, axes):
    """The shards of ``model`` the ranks of ``axes`` hold, an
    ``nn.ModuleList`` in list order (new tensors; the model is left as it
    is)."""
    cfg = model.cfg
    return tpar.split_module(model, lambda: tf.Transformer(cfg, "meta"),
                             axes, tpar.TRANSFORMER_TP,
                             moe=bool(cfg.n_experts))


def merged(shards, axes, which="params"):
    """The whole model's parameters (``which="grads"``: gradients) by
    name from every rank's shards (``tensor_parallel.merged``)."""
    return tpar.merged(shards, axes, tpar.TRANSFORMER_TP, which=which,
                       moe=bool(shards[0].cfg.n_experts))


def _layer_ring(layers, xs, positions, axes, attend):
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


def _layer_off(layers, xs, positions, axes, attend):
    """One block on every rank held with activations replicated over tp
    (``tf.block``): the column shards' products (``column_products``: the
    input gradient's partials summed over tp in f32), one all-reduce of
    each row-parallel product's f32 partials (``row_parallel``); an MoE
    FFN over ep and tp. Returns (xs, the MoE aux per rank or None)."""
    cfg = layers[0].attn.cfg
    moe_ffn = None
    if cfg.n_experts:
        def moe_ffn(hs):
            return moe.moe_ffn_parallel(
                hs, [{"router": lp.ffn.router, "w1": lp.ffn.w1,
                      "w2": lp.ffn.w2} for lp in layers], axes,
                top_k=cfg.expert_top_k, capacity_factor=cfg.capacity_factor)
    xs, _, aux = tf.block(
        layers, xs, positions, attend,
        enter=lambda hs, wss: tpar.column_products(hs, wss, [axes.tp]),
        leave=lambda ys, ws: tpar.row_parallel(ys, ws, axes),
        moe_ffn=moe_ffn)
    return xs, aux


def _hidden(shards, inputs, positions, axes, mode, attend, remat):
    """The embedding and the layer stack on every rank held → (xs, aux
    summed over the layers per rank or None)."""
    cfg = shards[0].cfg
    if mode == "ring":
        n, index = axes.tp.size, axes.tp_index
        per = inputs.shape[1] // n
        xs = [s.embed[inputs[:, index(j) * per:(index(j) + 1) * per]]
              for j, s in enumerate(shards)]
    else:
        xs = tpar.vocab_parallel_embed([s.embed for s in shards],
                                       [inputs] * len(shards), axes)
    layer_fn = _layer_ring if mode == "ring" else _layer_off
    aux = None
    for i in range(cfg.n_layers):
        layers = [s.layers[i] for s in shards]
        if remat:
            xs, layer_aux = checkpoint(layer_fn, layers, xs, positions, axes,
                                       attend, use_reentrant=False)
        else:
            xs, layer_aux = layer_fn(layers, xs, positions, axes, attend)
        if layer_aux is not None:
            aux = layer_aux if aux is None else \
                [a + b for a, b in zip(aux, layer_aux)]
    return xs, aux


def _logits(shards, xs, axes, mode):
    """Final norm and the tied head → vocab-sharded f32 logits per rank
    held, (B, S, V / tp) over the rank's vocabulary rows."""
    tp = axes.tp
    rows = []
    for j, s in enumerate(shards):
        lo, hi = tpar.vocab_range(s.embed.shape[0], tp.size, axes.tp_index(j))
        rows.append(s.embed[lo:hi])
    hs = [tf._rms_norm(x, s.ln_f.weight) for x, s in zip(xs, shards)]
    if mode == "ring":
        outs = ring_mm.allgather_matmul(hs, [r.T for r in rows], tp)
    else:
        outs = [o for (o,) in tpar.column_products(
            hs, [(r.T,) for r in rows], [tp])]
    return [o.float() for o in outs]


def _attend_for(mesh, attn_impl):
    if data_parallel.axis(mesh, "sp")[1] > 1:
        return tf._ring_attend(mesh, attn_impl)
    return tf.ATTN_IMPLS[attn_impl]


def resolve(cfg, axes, mesh, batch_rows, seq, overlap=None):
    """The path a step takes ("ring" or "off"; ``tf.resolve_overlap``
    over the mesh's axis sizes and the axes held in this process)."""
    sizes = {**tf.axis_sizes(mesh), "tp": axes.tp.size, "ep": axes.ep.size}
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
    tf.check_moe_mesh(cfg, tf.axis_sizes(mesh))
    mode = resolve(cfg, axes, mesh, batch_rows, seq, overlap)
    sp_index, sp = data_parallel.axis(mesh, "sp")
    if seq % sp:
        raise ValueError(f"sequence length {seq} must divide by sp={sp}")
    local = seq // sp
    cols = slice(sp_index * local, (sp_index + 1) * local)
    inputs = data_parallel.shard_rows(inputs, mesh)[:, cols]
    targets = data_parallel.shard_rows(targets, mesh)[:, cols]
    positions = (sp_index * local + torch.arange(
        local, device=device)).expand(inputs.shape[0], local)
    xs, aux = _hidden(shards, inputs, positions, axes, mode,
                      _attend_for(mesh, attn_impl), remat)
    logits = _logits(shards, xs, axes, mode)
    losses = tpar.vocab_parallel_xent(logits, [targets] * len(shards), axes)
    if cfg.n_experts:
        losses = [loss + cfg.moe_aux_weight * (a / max(cfg.n_layers, 1))
                  for loss, a in zip(losses, aux)]
    share = targets.numel() / global_tokens
    return [loss * share for loss in losses], mode


def tp_partial(mode):
    """Which replicated parameters a tp rank holds part of the gradient
    of: the embedding always (its lookup and head each see a part), the
    norms under ring (they see a sequence shard)."""
    def partial(name):
        if name == "embed":
            return True
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
        loss = data_parallel.sum_loss(losses[0], mesh)
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
    tpar.reduce_grads(shards, axes, mesh, tp_partial(mode))
    return losses


def n_params(cfg):
    """The whole model's parameter count (the MFU estimate's N)."""
    return sum(p.numel() for p in tf.Transformer(cfg, "meta").parameters())
