# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Tensor- and expert-parallel building blocks: the axes a step runs
over, the Megatron collectives with their gradients, the vocab-parallel
embedding and cross entropy, the shard layout of a model's parameters
and the gradient reduction by group.

In JAX these are GSPMD's: ``param_shardings`` names each weight's tp
and ep dims (``models/transformer.py:122``, ``models/bert.py:102``) and
XLA inserts the collectives. Here every rank holds a module of the
model's class whose parameters are its shards (same names as the whole
model's), and the forward calls the collectives itself:

  :func:`copy_to`      identity forward, all-reduce of the gradient
                       (a replicated activation entering a column- or
                       expert-sharded product: Megatron's f);
  :func:`reduce_from`  all-reduce forward, identity backward (the
                       partial sums a row- or expert-sharded product
                       leaves: Megatron's g);
  :func:`column_products`  f and the column-sharded products in one: the
                       input's gradient summed over the axis from f32
                       partials, cast once, as the whole product's
                       backward rounds once (:func:`row_parallel` does
                       the same for the forward's partial sums);
  :func:`sum_over`     all-reduce forward and backward (a sum each
                       rank's own share of the loss consumes: the MoE
                       router probabilities over sp).

Each rank's loss is then the whole loss and its backward, seeded with 1,
gives every shard its gradient and every replicated parameter the
gradient its rank computed: whole where the rank saw every token, a
part where it saw a part (the sequence shard of ring TP, the embedding's
vocabulary shard), summed over the axis by :func:`reduce_grads`.

The transports are ``parallel/ring_attention.py``'s, one per axis
(:class:`Axes`: tp, ep and sp): ``P2P`` over the axis's ring of a
DeviceMesh, one rank a process, or ``InProcess`` holding every rank of
one axis in this process (the CPU tests and the card check). Per-rank
values travel as lists with one entry per rank held. In one process the
joint backward of the ranks' summed losses runs each collective's
backward once, as the processes would.
"""

import dataclasses

import torch
from torch import nn

from container_engine_accelerators_tpu_torch.parallel import data_parallel
from container_engine_accelerators_tpu_torch.parallel.ring_attention import (
    InProcess,
    P2P,
    ring_of,
)


@dataclasses.dataclass(frozen=True)
class Axes:
    """The tp, ep and sp transports of a step. At most one holds more
    than one rank of its axis in this process; the others then have size
    1 or hold this process's one rank. The sp axis splits the sequence:
    its ranks hold other tokens of the same parameters (ranks of it held
    in one process share one shard, :func:`split_module`)."""

    tp: object
    ep: object
    sp: object = dataclasses.field(default_factory=lambda: InProcess(1))

    def __post_init__(self):
        if sum(len(t.indices) > 1 for t in (self.tp, self.ep, self.sp)) > 1:
            raise ValueError("one process holds the ranks of one axis at most")

    @classmethod
    def in_process(cls, tp=1, ep=1, sp=1):
        """Every rank of the tp (or the ep, or the sp) axis in this
        process."""
        return cls(InProcess(tp), InProcess(ep), InProcess(sp))

    @classmethod
    def of_mesh(cls, mesh):
        """This process's rank of a DeviceMesh's "tp", "ep" and "sp" axes
        (a lone rank where the mesh lacks one)."""
        names = mesh.mesh_dim_names or ()

        def axis(name):
            return P2P(ring_of(mesh, name)) if name in names else InProcess(1)
        return cls(axis("tp"), axis("ep"), axis("sp"))

    @property
    def held(self):
        return max(len(t.indices) for t in (self.tp, self.ep, self.sp))

    def _index(self, transport, j):
        idx = transport.indices
        return idx[j] if len(idx) > 1 else idx[0]

    def tp_index(self, j):
        return self._index(self.tp, j)

    def ep_index(self, j):
        return self._index(self.ep, j)

    def sp_index(self, j):
        return self._index(self.sp, j)

    def coords(self):
        """(tp index, ep index) of each rank held, in list order."""
        return [(self.tp_index(j), self.ep_index(j))
                for j in range(self.held)]


class _Reduce(torch.autograd.Function):
    """Megatron's g: the all-reduce forward, the identity backward."""

    @staticmethod
    def forward(ctx, transport, *xs):
        out = transport.all_reduce(list(xs))
        # One output tensor a rank, as each process would hold its own.
        return tuple(o if i == 0 else o.clone() for i, o in enumerate(out))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _Copy(torch.autograd.Function):
    """Megatron's f: the identity forward, the all-reduce backward."""

    @staticmethod
    def forward(ctx, transport, *xs):
        ctx.transport = transport
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.transport.all_reduce(list(gs)))


class _Sum(torch.autograd.Function):
    """The all-reduce forward and the all-reduce backward: a sum over the
    axis that each rank's own loss consumes, where the ranks' losses
    add up to the whole (the sp ranks' shares), so each rank's input
    gets every rank's cotangent."""

    @staticmethod
    def forward(ctx, transport, *xs):
        ctx.transport = transport
        out = transport.all_reduce(list(xs))
        return tuple(o if i == 0 else o.clone() for i, o in enumerate(out))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.transport.all_reduce(list(gs)))


def sum_over(transport, xs):
    """The sum of ``xs`` (per rank held) over ``transport``'s axis, its
    gradient summed over the axis too (:class:`_Sum`)."""
    if transport.size == 1:
        return list(xs)
    return list(_Sum.apply(transport, *xs))


def reduce_from(transports, xs):
    """The sum of ``xs`` (per rank held) over each transport's axis in
    turn, its gradient passed through unchanged."""
    for t in transports:
        if t.size > 1:
            xs = list(_Reduce.apply(t, *xs))
    return xs


def copy_to(transports, xs):
    """``xs`` unchanged, its gradient summed over each transport's
    axis."""
    for t in transports:
        if t.size > 1:
            xs = list(_Copy.apply(t, *xs))
    return xs


class _PartialProduct(torch.autograd.Function):
    """x @ w with an f32 output (no rounding of the f32 accumulator: a
    row-parallel product's partial sum), its backward in the operands'
    dtype as the whole product's is."""

    @staticmethod
    def forward(ctx, x, w):
        from container_engine_accelerators_tpu_torch.parallel import overlap

        ctx.save_for_backward(x, w)
        return overlap._chunk_mm(x, w, torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ w.T, dw


class _ColumnProducts(torch.autograd.Function):
    """Per rank held, x @ w for each weight of its tuple, x replicated
    over ``transports``' axes: the backward's dx is Σ_i g_i @ w_iᵀ with
    f32 output, summed over the axes in f32 and cast once to x's dtype;
    dw_i = xᵀ @ g_i in the operands' dtype, as autograd gives it."""

    @staticmethod
    def forward(ctx, transports, n_held, n_w, *tensors):
        from container_engine_accelerators_tpu_torch.parallel import overlap

        xs = tensors[:n_held]
        wss = [tensors[n_held + j * n_w:n_held + (j + 1) * n_w]
               for j in range(n_held)]
        ctx.save_for_backward(*tensors)
        ctx.transports, ctx.n_held, ctx.n_w = transports, n_held, n_w
        return tuple(overlap._chunk_mm(x, w, x.dtype)
                     for x, ws in zip(xs, wss) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        from container_engine_accelerators_tpu_torch.parallel import overlap

        n_held, n_w = ctx.n_held, ctx.n_w
        saved = ctx.saved_tensors
        xs = saved[:n_held]
        wss = [saved[n_held + j * n_w:n_held + (j + 1) * n_w]
               for j in range(n_held)]
        dxs, dws = [], []
        for j, (x, ws) in enumerate(zip(xs, wss)):
            dx = None
            for i, w in enumerate(ws):
                g = gs[j * n_w + i]
                if g is None:
                    dws.append(torch.zeros_like(w))
                    continue
                part = overlap._chunk_mm(g, w.T, torch.float32)
                dx = part if dx is None else dx + part
                dws.append(x.reshape(-1, x.shape[-1]).T
                           @ g.reshape(-1, g.shape[-1]))
            dxs.append(torch.zeros(x.shape, dtype=torch.float32,
                                   device=x.device) if dx is None else dx)
        for t in ctx.transports:
            if t.size > 1:
                dxs = t.all_reduce(dxs)
        return (None, None, None, *[d.to(x.dtype) for d, x in zip(dxs, xs)],
                *dws)


def column_products(xs, wss, transports):
    """Per rank held, the tuple of ``x @ w`` for each weight of its tuple
    ``wss[j]``: ``copy_to(transports, xs)`` and the products in one, the
    input gradient's partial sums over the axes kept in f32 until the
    sum. Without an axis above one, the plain products."""
    if all(t.size == 1 for t in transports):
        return [tuple(x @ w for w in ws) for x, ws in zip(xs, wss)]
    n_w = len(wss[0])
    flat = _ColumnProducts.apply(tuple(transports), len(xs), n_w, *xs,
                                 *[w for ws in wss for w in ws])
    return [tuple(flat[j * n_w:(j + 1) * n_w]) for j in range(len(xs))]


def row_parallel(xs, ws, axes):
    """Σ over tp of each rank's x @ w (its contraction shard): the
    partials f32, summed (``reduce_from``) and cast once to x's dtype,
    as the whole product rounds once."""
    if axes.tp.size == 1:
        return [x @ w for x, w in zip(xs, ws)]
    parts = reduce_from([axes.tp], [_PartialProduct.apply(x, w)
                                    for x, w in zip(xs, ws)])
    return [p.to(x.dtype) for p, x in zip(parts, xs)]


# -- the vocabulary over tp ---------------------------------------------------

def vocab_range(vocab, tp_size, tp_index):
    """[lo, hi) of the vocabulary rows rank ``tp_index`` holds."""
    if vocab % tp_size:
        raise ValueError(f"vocab_size={vocab} must divide over tp={tp_size}")
    per = vocab // tp_size
    return tp_index * per, (tp_index + 1) * per


def vocab_parallel_embed(embeds, tokens, axes):
    """The embedding lookup with the vocabulary split over tp (Megatron's
    VocabParallelEmbedding): each rank looks up the tokens of its rows,
    zeros for the others, and the sum over tp is the lookup (exact: one
    term is nonzero). A rank's embedding gradient then lands on its rows
    only, so the sum over tp (:func:`reduce_grads`) is the whole one."""
    tp = axes.tp
    if tp.size == 1:
        return [e[t] for e, t in zip(embeds, tokens)]
    parts = []
    for j, (e, t) in enumerate(zip(embeds, tokens)):
        lo, hi = vocab_range(e.shape[0], tp.size, axes.tp_index(j))
        inside = (t >= lo) & (t < hi)
        rows = e[lo:hi][(t - lo).clamp(0, hi - lo - 1)]
        parts.append(rows * inside[..., None].to(rows.dtype))
    return reduce_from([tp], parts)


def vocab_parallel_xent(logits, targets, axes):
    """Mean cross entropy of vocab-sharded f32 logits, per rank held
    (B, S, V / tp) over rank r's rows [r·V/tp, (r+1)·V/tp): the max and
    the sum of exponentials all-reduced over tp, the target's logit taken
    on the rank that holds it. Every rank's value is the whole loss (the
    logsumexp − target form of ``transformer.softmax_xent``); its
    gradient is the rank's own softmax − one-hot, no transfer."""
    tp = axes.tp
    if tp.size == 1:
        return [(torch.logsumexp(lg, dim=-1) - torch.gather(
            lg, -1, t[..., None])[..., 0]).mean()
            for lg, t in zip(logits, targets)]
    maxes = tp.all_reduce([lg.detach().amax(dim=-1) for lg in logits], "max")
    sums, picked = [], []
    for j, (lg, t, m) in enumerate(zip(logits, targets, maxes)):
        per = lg.shape[-1]
        lo = axes.tp_index(j) * per
        inside = (t >= lo) & (t < lo + per)
        got = torch.gather(lg, -1, (t - lo).clamp(0, per - 1)[..., None])
        picked.append(torch.where(inside, got[..., 0], 0.0))
        sums.append(torch.exp(lg - m[..., None]).sum(dim=-1))
    sums = reduce_from([tp], sums)
    picked = reduce_from([tp], picked)
    return [(torch.log(s) + m - p).mean()
            for s, m, p in zip(sums, maxes, picked)]


# -- shard layout -------------------------------------------------------------

# Megatron's layout (JAX's param_shardings): column-parallel weights split
# their output dim (-1), row-parallel ones their input dim (-2); expert
# weights (E, ...) split their expert dim over ep. Names are the suffixes
# of the port's parameter names.
TRANSFORMER_TP = {"attn.wq": -1, "attn.wk": -1, "attn.wv": -1,
                  "ffn.w1": -1, "ffn.w3": -1, "attn.wo": -2, "ffn.w2": -2}
BERT_TP = {"wq": -1, "wk": -1, "wv": -1, "w_in": -1, "b_in": -1,
           "wo": -2, "w_out": -2}


def _suffix(name):
    """A layer parameter's name without its ``layers.<i>.`` prefix."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "layers" else name


def shard_dims(name, tp_layout, moe=False):
    """(tp dim, ep dim) of the parameter ``name`` (None: not split over
    that axis)."""
    key = _suffix(name)
    tp_dim = tp_layout.get(key)
    ep_dim = 0 if moe and key in ("ffn.w1", "ffn.w2") else None
    return tp_dim, ep_dim


def _piece(t, dim, size, index):
    if dim is None or size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {size}")
    per = t.shape[dim] // size
    return t.narrow(dim, index * per, per)


def _set_param(module, name, value):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, value)


def split_module(model, build, axes, tp_layout, moe=False):
    """The shards of ``model`` the ranks ``axes`` holds, in list order:
    each a module from ``build()`` (built on the meta device) whose
    parameters are new contiguous tensors holding the rank's piece of
    the model's (a replicated parameter's copy whole). Ranks at one
    (tp, ep) coordinate, the sp ranks held in one process, share one
    shard: their gradients accumulate in it, the sum over sp."""
    built = {}
    for tp_i, ep_i in axes.coords():
        if (tp_i, ep_i) in built:
            continue
        shard = build()
        with torch.no_grad():
            for name, p in model.named_parameters():
                tp_dim, ep_dim = shard_dims(name, tp_layout, moe)
                t = _piece(p.detach(), tp_dim, axes.tp.size, tp_i)
                t = _piece(t, ep_dim, axes.ep.size, ep_i)
                _set_param(shard, name, nn.Parameter(
                    t.clone().contiguous(), requires_grad=p.requires_grad))
        built[(tp_i, ep_i)] = shard
    return nn.ModuleList(built[c] for c in axes.coords())


def merge_tensors(pieces, coords, name, tp_size, ep_size, tp_layout,
                  moe=False):
    """One parameter (or gradient) whole from its pieces at ``coords``
    ((tp, ep) index pairs covering the grid): concatenated along its tp
    and ep dims, a replicated one taken from coordinate (0, 0)."""
    tp_dim, ep_dim = shard_dims(name, tp_layout, moe)
    grid = dict(zip(coords, pieces))
    if tp_dim is None or tp_size == 1:
        rows = [grid[(0, e)] for e in range(ep_size)]
    else:
        rows = [torch.cat([grid[(t, e)] for t in range(tp_size)], dim=tp_dim)
                for e in range(ep_size)]
    if ep_dim is None or ep_size == 1:
        return rows[0]
    return torch.cat(rows, dim=ep_dim)


def merged(shards, axes, tp_layout, which="params", moe=False):
    """Every parameter (``which="grads"``: its gradient) of the whole
    model by name, from the shards of every (tp, ep) coordinate: the
    ranks held in one process, or gathered over the tp and ep groups
    between processes (every rank returns the whole)."""
    import torch.distributed as dist

    by_rank = [dict(s.named_parameters()) for s in shards]
    out = {}
    for name in by_rank[0]:
        grid = {c: (params[name] if which == "params"
                    else params[name].grad).detach()
                for c, params in zip(axes.coords(), by_rank)}
        for pos, axis in ((0, axes.tp), (1, axes.ep)):
            if axis.size == 1 or len(axis.indices) > 1:
                continue
            gathered = {}
            for c, t in grid.items():
                every = [torch.empty_like(t) for _ in range(axis.size)]
                dist.all_gather(every, t.contiguous(), group=axis.ring.group)
                for i, piece in enumerate(every):
                    gathered[(i, c[1]) if pos == 0 else (c[0], i)] = piece
            grid = gathered
        out[name] = merge_tensors(list(grid.values()), list(grid), name,
                                  axes.tp.size, axes.ep.size, tp_layout, moe)
    return out


# -- gradients ----------------------------------------------------------------

def _flat_reduce(transport, grads_by_rank):
    """Sum per-rank lists of gradients over ``transport``'s axis in one
    flat f32 buffer a rank; writes the sums back in place."""
    flats = [torch.cat([g.reshape(-1).float() for g in grads])
             for grads in grads_by_rank]
    sums = transport.all_reduce(flats)
    for grads, total in zip(grads_by_rank, sums):
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(total[offset:offset + n].view_as(g).to(g.dtype))
            offset += n


def reduce_grads(shards, axes, mesh, tp_partial,
                 data_axes=data_parallel.DATA_AXES):
    """After ``backward()``: each parameter named by ``tp_partial(name)``
    (a replicated parameter whose gradient each tp rank holds a part of)
    summed over tp, then every gradient over the mesh's data axes
    ``data_axes`` (dp and sp, or dp alone for a model whose sp ranks are
    replicas: ``data_parallel.data_groups``); one flat f32 buffer a
    group. A parameter without a gradient gets zeros."""
    for shard in shards:
        for p in shard.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
    if axes.tp.size > 1:
        partial = [[p.grad for name, p in shard.named_parameters()
                    if p.requires_grad and tp_partial(name)]
                   for shard in shards]
        if partial[0]:
            _flat_reduce(axes.tp, partial)
    unique = list({id(s): s for s in shards}.values())
    for group in data_parallel.data_groups(mesh, data_axes):
        for shard in unique:
            data_parallel.sync_grads(shard.parameters(), group=group)
