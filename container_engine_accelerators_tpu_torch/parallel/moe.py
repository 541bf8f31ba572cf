# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Mixture-of-experts FFN, the PyTorch port of
``container_engine_accelerators_tpu/parallel/moe.py``.

The same GShard/Switch routing: tokens go to a static (experts, capacity)
buffer through dense one-hot products, so every tensor has a fixed shape.
Each expert takes at most C = ceil(G·k·cf / E) tokens of a group; tokens
past it are dropped from that expert (combine weight 0). Routing runs in
f32; the expert products in the weights' dtype, as plain
``torch.einsum`` (the JAX package computes them outside any Pallas
kernel). The load-balancing aux loss is the Switch form.

Expert parallelism (:func:`moe_ffn_parallel`, JAX's ``moe_shardings``:
the expert dim of w1/w2 over ``ep``, their F dim over ``tp``) keeps
JAX's layout, the batch replicated over ep: every ep rank routes the
same tokens alike, runs only its E/ep experts on their (E/ep, C, D)
slots, and the combine's f32 partial sums are all-reduced over ep (and
tp). (Over ep, the input's gradient through the dispatch needs no f32
partials: a token's slot gradients are bf16 values, one a slot, so an
ep rank's part is exact and the sum over ep rounds once, as the whole
dispatch's does.)
The router's gradient has two parts: the local experts' combine
weights, whose cotangents are summed over ep and tp before they meet
the router (``tensor_parallel.copy_to`` on the gate values), and the aux
term, which every rank computes whole and keeps as it is. GSPMD lowers
the same layout to all-to-alls where the batch is sharded over ep; with
the batch replicated, the all-reduce of the combine is the collective.

Sequence parallelism (``axes.sp`` above 1) splits each group's tokens
over the sp ranks, rank r holding positions [r·G/sp, (r+1)·G/sp), and
routes each group whole, as JAX's GSPMD routes the sp-sharded
activations (:func:`_route_sharded`): the capacity of the whole group,
a token's slot in its expert's buffer the sum of the group's slot-j
hits before slot j on every rank, the slot-j hits on the ranks before
r and the local cumsum, and the aux over the whole group. The ranks
exchange their per-group hit counts (N · sp · k · E numbers), not
tokens: each runs the experts on its own tokens only, in buffers as
deep as its kept tokens need (:func:`_local_masks`), since a token's
expert output depends on no other token.
"""

import torch
import torch.nn.functional as F


def capacity(n_tokens, n_experts, top_k, capacity_factor):
    return max(1, int(-(-n_tokens * top_k * capacity_factor // n_experts)))


def sorted_top_k(probs, k):
    """``jax.lax.top_k`` along the last dim: values in descending order,
    ties to the lower index (a stable sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x, params, *, top_k=2, capacity_factor=1.25):
    """x (..., D) → (y (..., D), aux_loss scalar).

    2-D input routes the whole token set as one group. Higher-rank input
    (B, …, D) routes per leading-dim group (per sequence), with capacity
    per group, and the aux loss is the groups' mean: JAX's ``vmap`` over
    the leading dim."""
    if x.dim() > 2:
        y, aux = _moe_ffn_groups(
            x.reshape(x.shape[0], -1, x.shape[-1]), params, top_k,
            capacity_factor)
        return y.reshape(x.shape), aux.mean()
    y, aux = _moe_ffn_groups(x[None], params, top_k, capacity_factor)
    return y[0], aux[0]


def _route(x, router, k, capacity_factor):
    """The routing of N groups of G tokens, x (N, G, D), held whole in
    this process: (gate values (N, G, k) f32, the top-k slot masks (k of
    (N, G, E, C) f32, no gradient), the aux (N,)). JAX's
    ``_moe_ffn_flat`` up to the expert products (:func:`_route_sharded`
    over an sp axis of one)."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    (route,), (aux,), c = _route_sharded([x], [router], k, capacity_factor,
                                         tpar.Axes.in_process())
    return route[0], slot_masks(route, router.shape[1], c), aux


def _route_sharded(xs, routers, k, capacity_factor, axes):
    """The routing of groups whose tokens are split over ``axes.sp``:
    per rank held, its shards xs (N, G/sp, D) of N groups and the
    router. Returns (per rank (gate values (N, G/sp, k) f32, expert
    indices (N, G/sp, k), slots (N, G/sp, k): each token's position in
    its expert's buffer of the whole group, kept (N, G/sp, k): the slot
    within capacity), the aux per rank (N,), the capacity C of a whole
    group). JAX's ``_moe_ffn_flat`` on each whole group, up to the
    expert products."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    sp = axes.sp
    n_experts = routers[0].shape[1]
    seq = xs[0].shape[1] * sp.size
    c = capacity(seq, n_experts, k, capacity_factor)
    probs, tops, hits = [], [], []
    for j, (x, router) in enumerate(zip(xs, routers)):
        p = torch.softmax(x.float() @ router, dim=-1)  # (N, Gl, E)
        gate_vals, gate_idx = sorted_top_k(p, k)  # (N, Gl, k)
        onehot = F.one_hot(gate_idx, n_experts).float()  # (N, Gl, k, E)
        # This rank's slot-j hits per expert, at its place among the
        # ranks: the sum over sp is every rank's (sp, N, k, E).
        h = onehot.new_zeros(sp.size, x.shape[0], k, n_experts)
        h[axes.sp_index(j)] = onehot.sum(dim=1)
        probs.append(p)
        tops.append((gate_vals, gate_idx, onehot))
        hits.append(h)
    every = sp.all_reduce(hits)
    routes, fracs = [], []
    for j, ((gate_vals, gate_idx, onehot), h) in enumerate(zip(tops, every)):
        total = h.sum(dim=0)  # the group's slot-j hits (N, k, E)
        offset = (torch.cumsum(total, dim=1) - total
                  + h[:axes.sp_index(j)].sum(dim=0))
        pos = torch.cumsum(onehot, dim=1) - 1 + offset[:, None]
        slots = torch.gather(pos, -1, gate_idx[..., None])[..., 0].long()
        routes.append((gate_vals, gate_idx, slots, slots < c))
        fracs.append(total[:, 0] / seq)  # top-1 token fraction (N, E)
    # Switch load balance over the whole group: the probabilities' sum
    # over sp carries each rank's cotangent to every rank's router.
    prob_sums = tpar.sum_over(sp, [p.sum(dim=1) for p in probs])
    auxes = [n_experts * (frac * (s / seq)).sum(dim=-1)
             for frac, s in zip(fracs, prob_sums)]
    return routes, auxes, c


def slot_masks(route, n_experts, c):
    """The k slot masks (N, Gl, E, C) f32 of a rank's routed tokens in
    the whole group's buffers of static depth C (:func:`_route_sharded`'s
    route): the rows of the whole group's masks at the rank's
    positions."""
    _, gate_idx, slots, kept = route
    onehot = F.one_hot(gate_idx, n_experts).bool() & kept[..., None]
    at = F.one_hot(slots.clamp(0, c - 1), c).bool()
    return [(onehot[..., j, :, None] & at[..., j, None, :]).float()
            for j in range(gate_idx.shape[-1])]


def _local_masks(route, n_experts):
    """The k slot masks (N, Gl, E, Cl) f32 of a rank's kept tokens in
    buffers of its own: each expert's kept tokens in slot order (slot 0's
    tokens, then slot 1's), Cl the most any expert keeps on this rank
    (read back to the host; the static C of :func:`slot_masks` is what
    the serving programs' CUDA graphs replay)."""
    _, gate_idx, _, kept = route
    n, gl, k = gate_idx.shape
    onehot = F.one_hot(gate_idx, n_experts).float() * kept[..., None]
    flat = onehot.transpose(1, 2).reshape(n, k * gl, n_experts)
    pos = torch.cumsum(flat, dim=1) - 1
    depth = max(1, int(flat.sum(dim=1).max()))
    slots = torch.arange(depth, device=flat.device, dtype=flat.dtype)
    masks = ((pos[..., None] == slots) & (flat[..., None] > 0)).float()
    masks = masks.view(n, k, gl, n_experts, depth)
    return [masks[:, j] for j in range(k)]


def _experts(x, gate_vals, masks, w1, w2, first=0):
    """Experts [first, first + w1.shape[0]) on their slots: the f32
    combine (N, G, D) of their outputs, a partial sum where other ranks
    hold other experts or other columns of F."""
    last = first + w1.shape[0]
    dispatch = combine = 0.0
    for j, d in enumerate(masks):
        d = d[:, :, first:last]
        dispatch = dispatch + d
        combine = combine + gate_vals[..., j, None, None] * d
    dt = w1.dtype
    expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(dt), x)
    h = F.gelu(torch.einsum("necd,edf->necf", expert_in, w1).float(),
               approximate="tanh").to(dt)
    out = torch.einsum("necf,efd->necd", h, w2)
    return torch.einsum("ngec,necd->ngd", combine.float(), out.float())


def _moe_ffn_groups(x, params, k, capacity_factor):
    """x (N, G, D): N independent groups of G tokens → (y (N, G, D),
    aux (N,)). JAX's ``_moe_ffn_flat`` on each group."""
    gate_vals, masks, aux = _route(x, params["router"], k, capacity_factor)
    y = _experts(x, gate_vals, masks, params["w1"], params["w2"])
    return y.to(x.dtype), aux


def _groups(x):
    """x as (N, G, D) groups: per leading-dim group for (B, ..., D), one
    group for (G, D) (:func:`moe_ffn`'s rule)."""
    if x.dim() > 2:
        return x.reshape(x.shape[0], -1, x.shape[-1])
    return x[None]


def moe_ffn_parallel(xs, params, axes, *, top_k=2, capacity_factor=1.25):
    """:func:`moe_ffn` with the experts split over ``axes.ep``, their F
    dim over ``axes.tp`` and the groups' tokens over ``axes.sp``
    (``parallel/tensor_parallel.Axes``). Per rank held: x (..., D), the
    same on every rank of tp and ep, its sp rank's positions of each
    group; params {"router" (D, E) whole, "w1" (E/ep, D, F/tp), "w2"
    (E/ep, F/tp, D)} of the rank's experts [ep_index · E/ep, ...).
    Returns (ys, auxes) per rank held: the MoE output at the rank's
    tokens and the whole groups' aux."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    axis_list = [axes.tp, axes.ep]
    groups = [_groups(x) for x in xs]
    n_experts = params[0]["router"].shape[1]
    routes, aux_list, c = _route_sharded(
        groups, [p["router"] for p in params], top_k, capacity_factor, axes)
    gate_list = [r[0] for r in routes]
    # Over sp each rank's buffers hold its own kept tokens; in one group
    # the static C of the whole, which the serving programs' graphs need.
    masks_list = [_local_masks(r, n_experts) if axes.sp.size > 1
                  else slot_masks(r, n_experts, c) for r in routes]
    gates = tpar.copy_to(axis_list, gate_list)
    inputs = tpar.copy_to(axis_list, xs)
    parts = []
    for j, (x, p, masks) in enumerate(zip(inputs, params, masks_list)):
        first = axes.ep_index(j) * p["w1"].shape[0]
        parts.append(_experts(_groups(x), gates[j], masks, p["w1"],
                              p["w2"], first))
    ys = tpar.reduce_from(axis_list, parts)
    auxes = [a.mean() if x.dim() > 2 else a[0]
             for a, x in zip(aux_list, xs)]
    return [y.to(x.dtype).reshape(x.shape) for y, x in zip(ys, xs)], auxes
