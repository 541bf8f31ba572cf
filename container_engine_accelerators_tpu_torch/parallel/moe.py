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
    """The routing of N groups of G tokens, x (N, G, D): (gate values
    (N, G, k) f32, the top-k slot masks (k of (N, G, E, C) f32, no
    gradient), the aux (N,)). JAX's ``_moe_ffn_flat`` up to the expert
    products."""
    n_experts = router.shape[1]
    c = capacity(x.shape[1], n_experts, k, capacity_factor)

    logits = x.float() @ router  # (N, G, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = sorted_top_k(probs, k)  # (N, G, k)

    # (N, G, E, C) slot masks from per-slot cumsum positions. A position
    # outside [0, C) selects no slot, as jax.nn.one_hot gives.
    slots = torch.arange(c, device=x.device, dtype=torch.float32)
    masks = []
    counts = torch.zeros(x.shape[0], 1, n_experts, device=x.device)
    for j in range(k):
        onehot = F.one_hot(gate_idx[..., j], n_experts).float()
        pos = torch.cumsum(onehot, dim=1) - 1 + counts
        counts = counts + onehot.sum(dim=1, keepdim=True)
        within = (pos < c) & (onehot > 0)
        masks.append((pos[..., None] == slots).float() * within[..., None])

    # Switch load balance: E · Σ_e (mean router prob)·(top-1 token frac).
    token_frac = F.one_hot(gate_idx[..., 0], n_experts).float().mean(dim=1)
    prob_mean = probs.mean(dim=1)
    aux = n_experts * (token_frac * prob_mean).sum(dim=-1)
    return gate_vals, masks, aux


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
    """:func:`moe_ffn` with the experts split over ``axes.ep`` and their
    F dim over ``axes.tp`` (``parallel/tensor_parallel.Axes``). Per rank
    held: x (..., D), the same on every rank of both axes; params
    {"router" (D, E) whole, "w1" (E/ep, D, F/tp), "w2" (E/ep, F/tp, D)}
    of the rank's experts [ep_index · E/ep, ...). Returns (ys, auxes) per
    rank held, each the whole MoE output and aux."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    axis_list = [axes.tp, axes.ep]
    routed = [_route(_groups(x), p["router"], top_k, capacity_factor)
              for x, p in zip(xs, params)]
    gates = tpar.copy_to(axis_list, [r[0] for r in routed])
    inputs = tpar.copy_to(axis_list, xs)
    parts = []
    for j, (x, p, (_, masks, _)) in enumerate(zip(inputs, params, routed)):
        first = axes.ep_index(j) * p["w1"].shape[0]
        parts.append(_experts(_groups(x), gates[j], masks, p["w1"],
                              p["w2"], first))
    ys = tpar.reduce_from(axis_list, parts)
    auxes = [r[2].mean() if x.dim() > 2 else r[2][0]
             for r, x in zip(routed, xs)]
    return [y.to(x.dtype).reshape(x.shape) for y, x in zip(ys, xs)], auxes
