# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Pipeline parallelism: microbatched stage execution over a "pp" axis.

Port of ``container_engine_accelerators_tpu/parallel/pipeline.py``. Stage
i of N holds its own parameters; activations advance one stage a tick
and cotangents go back one stage a tick. Two entry points:

* :func:`pipeline_train_1f1b`, the training schedule. Forward and
  backward microbatches interleave, one of each per stage and tick: the
  forward of microbatch m on stage i at tick F(i, m) = i + m, its
  backward at B(i, m) = 2N − 2 − i + m, M + 2N − 2 ticks in all. The
  forward runs under ``torch.no_grad()``; a stage keeps only its INPUT
  per microbatch in flight, in a circular buffer of depth 2N − 1, and at
  B recomputes the stage forward under autograd from that input and
  backpropagates the cotangent (on the last stage d loss / d y of the
  microbatch's loss). Gradients and the loss accumulate in f32, are
  scaled by 1/M and cast to the parameters' dtype; the loss and the
  loss-parameter gradients end on every rank, as JAX's psums leave them.
  The last stage's forward and backward of a microbatch fall on the same
  tick, so it runs the stage forward once, under autograd, where JAX
  also computes the no-grad output that its ring sends nowhere.
* :func:`pipeline_apply`, the GPipe forward over M + N − 1 ticks as a
  ``torch.autograd.Function`` whose backward runs the reverse schedule
  (the cotangents go back stage by stage; each stage recomputes its
  forward from its saved inputs), as JAX's ``jax.grad`` through
  ``shard_map`` and ``ppermute`` does.

The transport is one of ``parallel/ring_attention.py``'s over the "pp"
ring (``ring_of(mesh, "pp")``): :class:`~.ring_attention.P2P` holds this
process's stage and moves y to stage i + 1 and dx to stage i − 1 in one
``batch_isend_irecv`` a tick (only the transfers the schedule reads; the
wrap-around pair of JAX's ``ppermute`` carries nothing a stage reads and
is dropped); :class:`~.ring_attention.InProcess` holds every stage in
one process (the CPU tests and the card check run so). Stage arguments
are lists with one entry per stage the transport holds, in its
``indices`` order.

Differences from the JAX package: stage 0 alone reads the input stack
(JAX shards it over the pp axis when M % N == 0 and rotates blocks to
stage 0), so nothing rotates; a stage still holds at most 2N − 1
microbatch inputs. Stage parameters are an ``nn.Module`` (its
``parameters()``), or a tensor, tuple, list or dict of tensors.
"""

import torch
from torch import nn


def _flatten(tree):
    """(leaves, rebuild) of a stage's parameters: an ``nn.Module``'s
    ``parameters()`` (rebuild gives the module itself, whose parameters
    are the leaves), or the tensors of a tensor / tuple / list / dict
    tree (rebuild(leaves) → the same structure over ``leaves``)."""
    if isinstance(tree, nn.Module):
        leaves = list(tree.parameters())
        return leaves, lambda _leaves: tree
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(t) for t in tree]
    else:
        raise TypeError(f"stage parameters of type {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(flat):
        out, at = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(flat[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return leaves, rebuild


def _unflatten_grads(tree, grads):
    """Gradients in the structure of ``tree``: a list aligned with
    ``parameters()`` for a module, the tree's own structure otherwise."""
    if isinstance(tree, nn.Module):
        return list(grads)
    return _flatten(tree)[1](list(grads))


def _differentiable(tree):
    """(leaves to differentiate, the parameters to call the stage with):
    a module's own parameters, or detached aliases of a tree's tensors
    that require grad (no copy)."""
    leaves, rebuild = _flatten(tree)
    if isinstance(tree, nn.Module):
        return leaves, tree
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    return leaves, rebuild(leaves)


def _vjp(stage_fn, params, x, ct):
    """Recompute ``stage_fn(params, x)`` under autograd from the saved
    input and pull the cotangent back: (parameter gradients, dx).
    ``ct`` is y's cotangent, or a function of y (detached) that gives
    it, cast to y's dtype. A parameter the stage does not reach gets
    zeros."""
    with torch.enable_grad():
        leaves, call = _differentiable(params)
        x = x.detach().requires_grad_(True)
        y = stage_fn(call, x)
        if callable(ct):
            ct = ct(y.detach()).to(y.dtype)
        grads = torch.autograd.grad(y, leaves + [x], grad_outputs=ct,
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves + [x], grads)]
    return grads[:-1], grads[-1]


def _device_of(stage_params):
    return _flatten(stage_params[0])[0][0].device


def pipeline_train_1f1b(stage_fn, loss_fn, stage_params, x_micro, targets,
                        transport, loss_params=None, return_dx=False):
    """One 1F1B training step: ``(loss, grads)``, then ``lp_grads`` with
    ``loss_params`` and ``dx_micro`` with ``return_dx``.

    ``stage_fn(params, x) -> y`` is shape-preserving. ``loss_fn(y, tgt)``
    (``loss_fn(y, tgt, loss_params)`` with ``loss_params``) → a scalar,
    applied on the last stage to each microbatch; ``loss_params`` (a dict
    of tensors, e.g. the LM head and final norm) are the same on every
    rank and their gradients come back summed over the stages.
    ``stage_params`` has one entry per stage the transport holds.
    ``x_micro`` is (M, mb, ...); only the rank holding stage 0 reads its
    values (elsewhere a tensor on the meta device of the same shape and
    dtype will do). ``targets`` (M, ...) is read on the last stage.

    Returns the mean loss (f32, every rank), ``grads`` (one entry per
    stage held, each in its parameters' structure and dtype), the
    loss-parameter gradients (every rank) and, with ``return_dx``,
    d loss / d x_micro (every rank: stage 0's, broadcast)."""
    n, held = transport.size, list(transport.indices)
    m_total = x_micro.shape[0]
    ticks = m_total + 2 * n - 2
    depth = 2 * n - 1
    last = n - 1
    device = _device_of(stage_params)
    micro_shape, micro_dtype = x_micro.shape[1:], x_micro.dtype
    have_lp = loss_params is not None
    lp = loss_params if have_lp else {}

    def lfn(y, tgt):
        return loss_fn(y, tgt, lp_call) if have_lp else loss_fn(y, tgt)

    def like():
        return torch.empty(micro_shape, dtype=micro_dtype, device=device)

    def head_cotangent(tgt):
        """d loss / d y of one microbatch's loss on the last stage; its
        loss-parameter gradients into ``lpacc`` and the loss into
        ``lacc``."""
        def dloss_dy(y):
            y.requires_grad_(True)
            loss_m = lfn(y, tgt)
            dy, *dlp = torch.autograd.grad(loss_m, [y] + lp_leaves,
                                           allow_unused=True)
            for acc, d in zip(lpacc, dlp):
                if d is not None:
                    acc += d.float()
            lacc.add_(loss_m.detach().float())
            return dy
        return dloss_dy

    # Gradients accumulate in f32 whatever the parameter dtype: M
    # similar-magnitude bf16 addends would lose about 2 decimal digits.
    gacc = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in _flatten(sp)[0]] for sp in stage_params]
    has_last = last in held
    lacc = torch.zeros((), dtype=torch.float32, device=device)
    lpacc = dxbuf = None
    if has_last:
        lp_leaves, lp_call = _differentiable(lp)
        lpacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in lp_leaves]
    if return_dx and 0 in held:
        dxbuf = torch.zeros(x_micro.shape, dtype=micro_dtype, device=device)
    resbuf = [[None] * depth for _ in held]
    carry_f = [None] * len(held)
    carry_b = [None] * len(held)

    for t in range(ticks):
        to_next, to_prev = [None] * len(held), [None] * len(held)
        want_prev, want_next = [False] * len(held), [False] * len(held)
        for j, i in enumerate(held):
            # Forward half: microbatch m_f enters or advances.
            m_f = t - i
            if 0 <= m_f < m_total:
                x_in = x_micro[m_f] if i == 0 else carry_f[j]
                resbuf[j][m_f % depth] = x_in
                if i < last:
                    with torch.no_grad():
                        to_next[j] = stage_fn(stage_params[j], x_in)
            # Backward half: microbatch m_b leaves the pipeline.
            m_b = t - (2 * n - 2 - i)
            if 0 <= m_b < m_total:
                x_res = resbuf[j][m_b % depth]
                resbuf[j][m_b % depth] = None
                ct = head_cotangent(targets[m_b]) if i == last \
                    else carry_b[j]
                dparams, dx = _vjp(stage_fn, stage_params[j], x_res, ct)
                for acc, d in zip(gacc[j], dparams):
                    acc += d.float()
                if i > 0:
                    to_prev[j] = dx
                elif dxbuf is not None:
                    dxbuf[m_b] = dx
            # What this stage reads next tick: stage i - 1's forward
            # output when its own forward is active then, stage i + 1's
            # input cotangent when its own backward is.
            want_prev[j] = i > 0 and 0 <= t + 1 - i < m_total
            want_next[j] = i < last and \
                0 <= t + 1 - (2 * n - 2 - i) < m_total
        if t < ticks - 1:
            got_prev, got_next = transport.pipe(
                to_next, to_prev, want_prev, want_next, like, tag=2 * t)
            carry_f = got_prev
            carry_b = got_next

    inv_m = 1.0 / m_total
    grads = [
        _unflatten_grads(sp, [(g * inv_m).to(p.dtype)
                              for g, p in zip(acc, _flatten(sp)[0])])
        for sp, acc in zip(stage_params, gacc)]
    loss = _share(transport, lacc, last) * inv_m
    out = (loss, grads)
    if have_lp:
        lp_flat, lp_rebuild = _flatten(lp)
        lp_grads = []
        for k, p in enumerate(lp_flat):
            g = (lpacc[k] * inv_m).to(p.dtype) if has_last else \
                torch.empty(p.shape, dtype=p.dtype, device=device)
            lp_grads.append(_share(transport, g, last))
        out += (lp_rebuild(lp_grads),)
    if return_dx:
        if dxbuf is None:
            dxbuf = torch.empty(x_micro.shape, dtype=micro_dtype,
                                device=device)
        # Only stage 0 wrote cotangents: JAX's psum is its broadcast.
        out += (_share(transport, dxbuf, 0) * inv_m,)
    return out


def _share(transport, tensor, src):
    """``tensor`` as the rank holding stage ``src`` has it, here: the
    value on that rank (in one process, the value), a buffer of its shape
    and dtype elsewhere."""
    return transport.share([tensor] * len(transport.indices), src)[0]


# -- GPipe forward with its reverse schedule ----------------------------------

class _PipelineApply(torch.autograd.Function):
    """The GPipe schedule: forward M + N − 1 ticks, the reverse schedule
    in the backward. Inputs: (stage_fn, transport, stage_params,
    x_micro, *leaves), leaves the stages' parameter leaves in order."""

    @staticmethod
    def forward(ctx, stage_fn, transport, stage_params, x_micro, *leaves):
        n, held = transport.size, list(transport.indices)
        m_total = x_micro.shape[0]
        last = n - 1
        device = _device_of(stage_params)
        shape, dtype = x_micro.shape[1:], x_micro.dtype
        saved = [[None] * m_total for _ in held]
        outputs = torch.zeros(x_micro.shape, dtype=dtype, device=device)
        carry = [None] * len(held)
        steps = m_total + n - 1
        for t in range(steps):
            to_next = [None] * len(held)
            want_prev = [False] * len(held)
            for j, i in enumerate(held):
                m = t - i
                if 0 <= m < m_total:
                    x_in = x_micro[m] if i == 0 else carry[j]
                    saved[j][m] = x_in
                    y = stage_fn(stage_params[j], x_in)
                    if i == last:
                        outputs[m] = y
                    else:
                        to_next[j] = y
                want_prev[j] = i > 0 and 0 <= t + 1 - i < m_total
            if t < steps - 1:
                carry, _ = transport.pipe(
                    to_next, [None] * len(held), want_prev,
                    [False] * len(held),
                    lambda: torch.empty(shape, dtype=dtype, device=device),
                    tag=2 * t)
        ctx.stage_fn, ctx.transport = stage_fn, transport
        ctx.stage_params, ctx.saved = stage_params, saved
        ctx.shape, ctx.dtype, ctx.device = shape, dtype, device
        return _share(transport, outputs, last)

    @staticmethod
    def backward(ctx, g_out):
        transport, stage_params = ctx.transport, ctx.stage_params
        n, held = transport.size, list(transport.indices)
        m_total = g_out.shape[0]
        last = n - 1
        gacc = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in _flatten(sp)[0]] for sp in stage_params]
        dx_micro = torch.zeros((m_total, *ctx.shape), dtype=ctx.dtype,
                               device=ctx.device)
        carry = [None] * len(held)
        steps = m_total + n - 1
        for s in range(steps):
            to_prev = [None] * len(held)
            want_next = [False] * len(held)
            for j, i in enumerate(held):
                m = s - (last - i)
                if 0 <= m < m_total:
                    ct = g_out[m] if i == last else carry[j]
                    dparams, dx = _vjp(ctx.stage_fn, stage_params[j],
                                       ctx.saved[j][m], ct.to(ctx.dtype))
                    ctx.saved[j][m] = None
                    for acc, d in zip(gacc[j], dparams):
                        acc += d.float()
                    if i > 0:
                        to_prev[j] = dx
                    else:
                        dx_micro[m] = dx
                want_next[j] = i < last and \
                    0 <= s + 1 - (last - i) < m_total
            if s < steps - 1:
                _, carry = transport.pipe(
                    [None] * len(held), to_prev, [False] * len(held),
                    want_next,
                    lambda: torch.empty(ctx.shape, dtype=ctx.dtype,
                                        device=ctx.device),
                    tag=2 * s)
        grads = [g.to(p.dtype) for sp, acc in zip(stage_params, gacc)
                 for g, p in zip(acc, _flatten(sp)[0])]
        dx_micro = _share(transport, dx_micro, 0)
        return (None, None, None,
                dx_micro if ctx.needs_input_grad[3] else None, *grads)


def pipeline_apply(stage_fn, stage_params, x_micro, transport):
    """Run ``x_micro`` (M, mb, ...) through the N stages, GPipe: returns
    the (M, mb, ...) outputs on every rank (the last stage's, broadcast).

    Differentiable: the backward runs the reverse schedule, each stage
    recomputing its forward from the inputs it saved, and gives each
    stage held its parameters' gradients and stage 0's dx (broadcast).
    The cotangent of the outputs is the last stage's: every rank's
    replica of the outputs stands for the one value, as the replicated
    output of JAX's ``pipeline_apply`` does, so a loss on it is the same
    on every rank and not summed over them."""
    leaves = [leaf for sp in stage_params for leaf in _flatten(sp)[0]]
    return _PipelineApply.apply(stage_fn, transport, stage_params, x_micro,
                                *leaves)
