# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Mixture-of-experts FFN, the PyTorch port of
``container_engine_accelerators_tpu/parallel/moe.py`` on one device.

The same GShard/Switch routing: tokens go to a static (experts, capacity)
buffer through dense one-hot products, so every tensor has a fixed shape.
Each expert takes at most C = ceil(G·k·cf / E) tokens of a group; tokens
past it are dropped from that expert (combine weight 0). Routing runs in
f32; the expert products in the weights' dtype, as plain
``torch.einsum`` (the JAX package computes them outside any Pallas
kernel). The load-balancing aux loss is the Switch form.

Expert parallelism (experts sharded over an ``ep`` mesh axis) is not
ported: every expert lives on the one device.
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


def _moe_ffn_groups(x, params, k, capacity_factor):
    """x (N, G, D): N independent groups of G tokens → (y (N, G, D),
    aux (N,)). JAX's ``_moe_ffn_flat`` on each group."""
    n_experts = params["router"].shape[1]
    c = capacity(x.shape[1], n_experts, k, capacity_factor)

    logits = x.float() @ params["router"]  # (N, G, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = sorted_top_k(probs, k)  # (N, G, k)

    # (N, G, E, C) dispatch/combine from per-slot cumsum positions. A
    # position outside [0, C) selects no slot, as jax.nn.one_hot gives.
    slots = torch.arange(c, device=x.device, dtype=torch.float32)
    dispatch = combine = 0.0
    counts = torch.zeros(x.shape[0], 1, n_experts, device=x.device)
    for j in range(k):
        onehot = F.one_hot(gate_idx[..., j], n_experts).float()
        pos = torch.cumsum(onehot, dim=1) - 1 + counts
        counts = counts + onehot.sum(dim=1, keepdim=True)
        within = (pos < c) & (onehot > 0)
        d_j = (pos[..., None] == slots).float() * within[..., None]
        dispatch = dispatch + d_j
        combine = combine + gate_vals[..., j, None, None] * d_j

    dt = params["w1"].dtype
    expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(dt), x)
    h = F.gelu(torch.einsum("necd,edf->necf", expert_in, params["w1"])
               .float(), approximate="tanh").to(dt)
    out = torch.einsum("necf,efd->necd", h, params["w2"])
    y = torch.einsum("ngec,necd->ngd", combine.float(),
                     out.float()).to(x.dtype)

    # Switch load balance: E · Σ_e (mean router prob)·(top-1 token frac).
    token_frac = F.one_hot(gate_idx[..., 0], n_experts).float().mean(dim=1)
    prob_mean = probs.mean(dim=1)
    aux = n_experts * (token_frac * prob_mean).sum(dim=-1)
    return y, aux
