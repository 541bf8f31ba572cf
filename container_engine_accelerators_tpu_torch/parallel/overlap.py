# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Latency-hiding collective matmuls: ring decompositions for tensor
parallelism.

Port of ``container_engine_accelerators_tpu/parallel/overlap.py``. A
monolithic all-gather (or reduce-scatter) leaves the link idle while the
product runs and the card idle while the tensor moves; decomposed into a
ring of per-shard steps, each hop travels while the previous chunk's
product runs, so the slower of the two bounds a step, not their sum:

  all-gather → matmul   becomes   :func:`allgather_matmul`: the
      activation shard rides the ring; every step multiplies the
      visiting shard into its output rows while the next shard is
      already in flight.
  matmul → reduce-scatter   becomes   :func:`matmul_reducescatter`: the
      output rows are chunked; a partial-sum f32 accumulator rides the
      ring, gaining one local chunk product per hop.

Both are exact up to the order of their f32 sums. ``bidirectional``
sends the lower half of each shard one way round the ring and the upper
half the other way (``BIDIR_MIN_RING``).

The transport is one of ``parallel/ring_attention.py``'s over the "tp"
ring (``ring_of(mesh, "tp")``): :class:`~.ring_attention.P2P` holds this
process's rank and moves shards by ``batch_isend_irecv``, posting hop
t + 1 before step t's products and waiting for it after them, so NCCL's
transfer runs while the product does; :class:`~.ring_attention.InProcess`
holds every rank of the ring in one process (the CPU tests and the card
check run so). Arguments are lists with one entry per rank the transport
holds, in its ``indices`` order, as the ring-attention and pipeline
loops take them.

Two API levels, as in JAX:

  * :func:`allgather_matmul` / :func:`matmul_reducescatter` — per-rank
    bodies over a transport (the transformer's ring-TP forward,
    ``models/tp_lm.py``). Differentiable: each is a
    ``torch.autograd.Function`` whose backward is the other ring. The
    backward of all-gather → matmul is matmul → reduce-scatter of
    ``dy · wᵀ`` and ``dW = x_gatheredᵀ · dy``; the backward re-gathers x
    round the ring (only the local shard is saved: a gathered copy would
    hold n times the activations for the whole step).
  * :func:`tp_allgather_matmul` / :func:`tp_matmul_reducescatter` —
    global-array wrappers: whole x and w in, the whole product out,
    sharded internally over the ``"tp"`` axis of ``mesh`` (a mapping of
    axis sizes: every rank in this process; or a DeviceMesh: this rank's
    ring over NCCL or gloo, the output gathered). They fall back to the
    plain ``x @ w`` where the mesh or the shape cannot ring (a missing or
    size-1 axis, M/N/K not divisible), and, with the span tracer or the
    collective instruments on, time the call at its boundary.

Chunk products (``_chunk_mm``) are plain matrix products, which JAX also
computes outside any Pallas kernel, with f32 accumulation; the int8
``Int8Weight`` branch is ``ops/int8_matmul.int8_mm`` (the hand-written
W8A16 kernel on CUDA tensors, its plain version on CPU ones). The
reduce-scatter partials are f32 (JAX's ``_chunk_mm(..., jnp.float32)``):
a bf16 chunk goes through ``torch.mm(..., out_dtype=torch.float32)`` on
CUDA (bf16 operands on the tensor cores, f32 out), through f32 operands
on the CPU; an int8 chunk through the kernel's f32 epilogue
(``int8_mm(..., out_dtype=torch.float32)``, the bf16 tensor-core product
with the scaled accumulator unrounded). The backward's weight gradients
are the same f32-output products, accumulated chunk by chunk in an f32
buffer. Quantized weights carry no gradient: they serve only.
"""

import math
import time

import torch

from container_engine_accelerators_tpu_torch.models.quantization import (
    Int8Weight,
)
from container_engine_accelerators_tpu_torch.obs import (
    collective as obs_collective,
)
from container_engine_accelerators_tpu_torch.obs import trace as obs_trace
from container_engine_accelerators_tpu_torch.ops import int8_matmul
from container_engine_accelerators_tpu_torch.parallel.ring_attention import (
    InProcess,
    P2P,
    ring_of,
)

# Rings of this size or larger default to the bidirectional variant under
# bidirectional="auto": below it one direction moves so few hops that the
# second direction's extra transfers buy nothing.
BIDIR_MIN_RING = 4


def _observe_eager():
    """Whether a tp_* call is timed at its boundary: only with the span
    tracer or the collective instruments on, since the measurement
    synchronizes the device."""
    return obs_trace.enabled() or obs_collective.enabled()


def _timed_ring(kind, fn, n, moved_bytes, device):
    """Run ``fn()`` synchronized, record a span and a collective-tier
    latency/bandwidth (algbw over ``moved_bytes``; bus = alg·(n-1)/n,
    the nccl-tests ring convention)."""
    t_tr = obs_trace.now()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    algbw = moved_bytes / dt / 1e9
    obs_trace.event(kind, t_tr, dt, ring=n, bytes=moved_bytes)
    obs_collective.record(kind, dt, msg_bytes=moved_bytes,
                          algbw_gbps=algbw, busbw_gbps=algbw * (n - 1) / n)
    return out


def _chunk_mm(x, w, out_dtype):
    """x @ w with f32 accumulation, cast to ``out_dtype``; an
    ``Int8Weight`` applies its per-output-channel scale to the f32
    product (``int8_mm``). The one implementation of the chunk product:
    ``transformer._mm``'s dense and int8 branches compute the same."""
    if isinstance(w, Int8Weight):
        # f32 partials: the kernel's f32 epilogue on the bf16 tensor-core
        # product, the scaled accumulator unrounded.
        return int8_matmul.int8_mm(x, w.q, w.scale, out_dtype=out_dtype)
    if out_dtype == x.dtype:
        return torch.matmul(x, w)
    if x.is_cuda:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=out_dtype)
        return y.view(*lead, w.shape[-1])
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))


def _w_rows(w):
    return w.q.shape[1] if isinstance(w, Int8Weight) else w.shape[0]


def _w_cols(w):
    return w.q.shape[0] if isinstance(w, Int8Weight) else w.shape[-1]


def _use_bidir(bidirectional, axis_size, rows):
    if bidirectional == "auto":
        return axis_size >= BIDIR_MIN_RING and rows % 2 == 0
    return bool(bidirectional) and axis_size > 1 and rows % 2 == 0


def _rows(x, row0, rows):
    return x[..., row0:row0 + rows, :]


def _hop(transport, shards, tag, backward=False):
    """Post one hop of per-rank tensors; ``_land`` returns them."""
    return transport.post([(s,) for s in shards], tag=tag, backward=backward)


def _land(transport, pending):
    return [s[0] for s in transport.wait(pending)]


def _gather_ring(xs, transport, bidir, visit):
    """Round the ring with every rank's row shard: ``visit(j, row0,
    piece)`` for each rank held (``j`` its place in ``indices``) and
    each shard piece that reaches it, ``row0`` the piece's first row in
    the gathered operand. Hop t + 1 is posted before step t's visits and
    waited for after them."""
    n = transport.size
    m_local = xs[0].shape[-2]
    if bidir:
        half = m_local // 2
        lo = [x[..., :half, :] for x in xs]
        hi = [x[..., half:, :] for x in xs]
        for t in range(n):
            if t < n - 1:
                fwd = _hop(transport, lo, tag=0)
                bwd = _hop(transport, hi, tag=1, backward=True)
            for j, r in enumerate(transport.indices):
                visit(j, ((r - t) % n) * m_local, lo[j])
                visit(j, ((r + t) % n) * m_local + half, hi[j])
            if t < n - 1:
                lo, hi = _land(transport, fwd), _land(transport, bwd)
        return
    cur = list(xs)
    for t in range(n):
        pending = _hop(transport, cur, tag=0) if t < n - 1 else None
        for j, r in enumerate(transport.indices):
            visit(j, ((r - t) % n) * m_local, cur[j])
        if pending is not None:
            cur = _land(transport, pending)


def _scatter_ring(pairs, transport, bidir, m):
    """The reduce-scatter ring: ``pairs`` has per rank held a list of
    (x (..., m, k_local), w (k_local, N)); returns per rank held the f32
    (..., m / n, N) row chunk of Σ over ranks and pairs of x @ w. The
    accumulator's hop is posted before the next chunk's product and
    waited for after it."""
    n = transport.size
    m_local = m // n

    def part(j, row0, rows):
        out = None
        for x, w in pairs[j]:
            p = _chunk_mm(_rows(x, row0, rows), w, torch.float32)
            out = p if out is None else out + p
        return out

    idx = transport.indices
    if bidir:
        half = m_local // 2

        def parts(t):
            lo = [part(j, ((r + n - 1 - t) % n) * m_local, half)
                  for j, r in enumerate(idx)]
            hi = [part(j, ((r - (n - 1 - t)) % n) * m_local + half, half)
                  for j, r in enumerate(idx)]
            return lo, hi

        acc_lo, acc_hi = parts(0)
        for t in range(1, n):
            fwd = _hop(transport, acc_lo, tag=0)
            bwd = _hop(transport, acc_hi, tag=1, backward=True)
            lo, hi = parts(t)
            acc_lo = [a + p for a, p in zip(_land(transport, fwd), lo)]
            acc_hi = [a + p for a, p in zip(_land(transport, bwd), hi)]
        return [torch.cat([a, b], dim=-2) for a, b in zip(acc_lo, acc_hi)]
    acc = [part(j, ((r + n - 1) % n) * m_local, m_local)
           for j, r in enumerate(idx)]
    for t in range(1, n):
        pending = _hop(transport, acc, tag=0)
        nxt = [part(j, ((r + n - 1 - t) % n) * m_local, m_local)
               for j, r in enumerate(idx)]
        acc = [a + p for a, p in zip(_land(transport, pending), nxt)]
    return acc


def _ag_forward(xs, wss, transport, bidir):
    """Per rank held, the tuple of gathered products (..., m_local · n,
    N_i) in x's dtype."""
    n = transport.size
    m_local = xs[0].shape[-2]
    lead = xs[0].shape[:-2]
    outs = [[torch.empty((*lead, m_local * n, _w_cols(w)), dtype=x.dtype,
                         device=x.device) for w in ws]
            for x, ws in zip(xs, wss)]

    def visit(j, row0, piece):
        for i, w in enumerate(wss[j]):
            _rows(outs[j][i], row0, piece.shape[-2]).copy_(
                _chunk_mm(piece, w, piece.dtype))

    _gather_ring(xs, transport, bidir, visit)
    return outs


def _flat(t):
    return t.reshape(-1, t.shape[-1])


class _AllgatherMatmul(torch.autograd.Function):
    """:func:`allgather_matmul` with its backward ring: dx is the
    reduce-scatter of Σ_i dy_i · w_iᵀ, dw_i = x_gatheredᵀ · dy_i with x
    re-gathered round the ring."""

    @staticmethod
    def forward(ctx, transport, bidir, n_held, n_w, *tensors):
        xs = list(tensors[:n_held])
        flat_ws = tensors[n_held:]
        wss = [tuple(flat_ws[j * n_w:(j + 1) * n_w]) for j in range(n_held)]
        outs = _ag_forward(xs, wss, transport, bidir)
        ctx.save_for_backward(*tensors)
        ctx.transport, ctx.bidir = transport, bidir
        ctx.n_held, ctx.n_w = n_held, n_w
        return tuple(o for per in outs for o in per)

    @staticmethod
    def backward(ctx, *gs):
        n_held, n_w, transport = ctx.n_held, ctx.n_w, ctx.transport
        saved = ctx.saved_tensors
        xs = list(saved[:n_held])
        wss = [saved[n_held + j * n_w:n_held + (j + 1) * n_w]
               for j in range(n_held)]
        gss = []
        for j in range(n_held):
            row = []
            for i in range(n_w):
                g = gs[j * n_w + i]
                if g is None:
                    g = torch.zeros((*xs[j].shape[:-1], _w_cols(wss[j][i])),
                                    dtype=xs[j].dtype, device=xs[j].device)
                row.append(g.contiguous())
            gss.append(row)
        m = gss[0][0].shape[-2]
        dxs = _scatter_ring(
            [[(g, w.T) for g, w in zip(gss[j], wss[j])]
             for j in range(n_held)], transport, ctx.bidir, m)
        dws = [[torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                for w in wss[j]] for j in range(n_held)]

        def visit(j, row0, piece):
            pt = _flat(piece).T
            for i, g in enumerate(gss[j]):
                dws[j][i] += _chunk_mm(
                    pt, _flat(_rows(g, row0, piece.shape[-2])), torch.float32)

        _gather_ring(xs, transport, ctx.bidir, visit)
        grads = [dx.to(x.dtype) for dx, x in zip(dxs, xs)]
        grads += [dw.to(w.dtype) for j in range(n_held)
                  for dw, w in zip(dws[j], wss[j])]
        return (None, None, None, None, *grads)


class _MatmulReducescatter(torch.autograd.Function):
    """:func:`matmul_reducescatter` with its backward ring: dy is
    gathered round the ring; dx = dy_gathered · wᵀ and dw = xᵀ ·
    dy_gathered, chunk by chunk."""

    @staticmethod
    def forward(ctx, transport, bidir, n_held, *tensors):
        xs, ws = list(tensors[:n_held]), list(tensors[n_held:])
        outs = _scatter_ring([[(x, w)] for x, w in zip(xs, ws)], transport,
                             bidir, xs[0].shape[-2])
        ctx.save_for_backward(*tensors)
        ctx.transport, ctx.bidir, ctx.n_held = transport, bidir, n_held
        return tuple(o.to(x.dtype) for o, x in zip(outs, xs))

    @staticmethod
    def backward(ctx, *gs):
        n_held = ctx.n_held
        saved = ctx.saved_tensors
        xs, ws = saved[:n_held], saved[n_held:]
        gs = [g.contiguous() if g is not None else torch.zeros(
            (*x.shape[:-2], x.shape[-2] // ctx.transport.size, w.shape[-1]),
            dtype=x.dtype, device=x.device) for g, x, w in zip(gs, xs, ws)]
        dxs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
               for x in xs]
        dws = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in ws]

        def visit(j, row0, piece):
            rows = piece.shape[-2]
            _rows(dxs[j], row0, rows).copy_(
                _chunk_mm(piece, ws[j].T, piece.dtype))
            dws[j] += _chunk_mm(_flat(_rows(xs[j], row0, rows)).T,
                                _flat(piece), torch.float32)

        _gather_ring(gs, ctx.transport, ctx.bidir, visit)
        return (None, None, None, *dxs,
                *[dw.to(w.dtype) for dw, w in zip(dws, ws)])


def _needs_grad(tensors):
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def allgather_matmul(xs, ws, transport, bidirectional="auto"):
    """Decomposed ``all_gather(x) @ w`` over ``transport``'s ring.

    xs: one (..., m_local, k) row shard per rank held (dim -2 sharded
    over the ring). ``ws``: per rank held one weight (k, n) or a tuple of
    them: a tuple shares ONE ring for several products of the same input
    (the q/k/v and w1/w3 fusions). Returns per rank held the matching
    structure of (..., m_local · size, n) full-row outputs in x's dtype.
    A ring of one is the plain product (no transfer)."""
    single = not isinstance(ws[0], (tuple, list))
    wss = [(w,) if single else tuple(w) for w in ws]
    n = transport.size
    if n == 1:
        outs = [tuple(_chunk_mm(x, w, x.dtype) for w in per)
                for x, per in zip(xs, wss)]
    else:
        bidir = _use_bidir(bidirectional, n, xs[0].shape[-2])
        flat_ws = [w for per in wss for w in per]
        if _needs_grad([*xs, *flat_ws]):
            if any(isinstance(w, Int8Weight) for w in flat_ws):
                raise ValueError("int8 weights serve only: no gradient "
                                 "flows through them")
            flat = _AllgatherMatmul.apply(transport, bidir, len(xs),
                                          len(wss[0]), *xs, *flat_ws)
            k = len(wss[0])
            outs = [tuple(flat[j * k:(j + 1) * k]) for j in range(len(xs))]
        else:
            outs = [tuple(o) for o in _ag_forward(xs, wss, transport, bidir)]
    return [o[0] for o in outs] if single else outs


def matmul_reducescatter(xs, ws, transport, bidirectional="auto"):
    """Decomposed ``reduce_scatter(x @ w)`` over ``transport``'s ring.

    xs: one (..., m, k_local) contraction shard per rank held; ws: the
    matching (k_local, n) row shards. Returns per rank held its row chunk
    (..., m / size, n) of the FULL x @ w (summed over every rank's k
    shard, f32-accumulated, cast to x's dtype). m must divide over the
    ring (callers fall back before reaching here); a ring of one is the
    plain product."""
    n = transport.size
    if n == 1:
        return [_chunk_mm(x, w, x.dtype) for x, w in zip(xs, ws)]
    m = xs[0].shape[-2]
    if m % n:
        raise ValueError(
            f"matmul_reducescatter: rows ({m}) must divide the ring ({n}); "
            f"use tp_matmul_reducescatter for the fallback path")
    bidir = _use_bidir(bidirectional, n, m // n)
    if _needs_grad([*xs, *ws]):
        if any(isinstance(w, Int8Weight) for w in ws):
            raise ValueError("int8 weights serve only: no gradient flows "
                             "through them")
        return list(_MatmulReducescatter.apply(transport, bidir, len(xs),
                                               *xs, *ws))
    outs = _scatter_ring([[(x, w)] for x, w in zip(xs, ws)], transport,
                         bidir, m)
    return [o.to(x.dtype) for o, x in zip(outs, xs)]


# -- global-array wrappers (shard, ring, assemble; exact fallback) ------------

def _ring_size(mesh, axis_name):
    """The ring's size along ``axis_name`` of ``mesh`` (a mapping of axis
    sizes or a DeviceMesh), 1 where the mesh is None or lacks it."""
    if mesh is None:
        return 1
    if isinstance(mesh, dict):
        return mesh.get(axis_name, 1)
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(axis_name)] if axis_name in names else 1


def _transport(mesh, axis_name, n):
    """(transport, the ring indices it holds): every rank in this process
    for a mapping of sizes, this process's rank of a DeviceMesh."""
    if isinstance(mesh, dict):
        return InProcess(n)
    return P2P(ring_of(mesh, axis_name))


def _split_cols(w, n):
    """w's column shards (an Int8Weight's q rows and scale with them),
    each made contiguous once."""
    if isinstance(w, Int8Weight):
        q, s = w.q.chunk(n, dim=0), w.scale.chunk(n, dim=1)
        return [Int8Weight(a.contiguous(), b.contiguous())
                for a, b in zip(q, s)]
    return [c.contiguous() for c in w.chunk(n, dim=-1)]


def _split_rows(w, n):
    """w's row (contraction) shards: an Int8Weight's q columns, made
    contiguous once, with the whole scale (every shard's channel scale
    is the same; applying it per partial is linear in the k-sum)."""
    if isinstance(w, Int8Weight):
        return [Int8Weight(a.contiguous(), w.scale)
                for a in w.q.chunk(n, dim=1)]
    return [r.contiguous() for r in w.chunk(n, dim=0)]


def _gather_world(transport, parts, dim):
    """The shards of every rank of the ring, concatenated along ``dim``:
    the list itself in one process, an all-gather between processes."""
    if isinstance(transport, InProcess):
        return torch.cat(parts, dim=dim)
    import torch.distributed as dist

    (part,) = parts
    every = [torch.empty_like(part) for _ in range(transport.size)]
    dist.all_gather(every, part.contiguous(), group=transport.ring.group)
    return torch.cat(every, dim=dim)


def tp_allgather_matmul(x, w, mesh, axis_name="tp", bidirectional="auto"):
    """Global-array form: exactly ``x @ w`` (x (..., M, K), w (K, N) or an
    Int8Weight), x's rows and w's columns sharded over ``axis_name`` and
    the row gather run as the ring. ``mesh``: a mapping of axis sizes
    (every rank in this process) or a DeviceMesh (this rank's ring; the
    output's column shards are gathered). Exact-match fallback: a
    missing or size-1 axis, or M or N not dividing over it, runs the
    plain product."""
    n = _ring_size(mesh, axis_name)
    if n <= 1 or x.dim() < 2 or x.shape[-2] % n or _w_cols(w) % n:
        return _chunk_mm(x, w, x.dtype)
    transport = _transport(mesh, axis_name, n)
    xs = [c.contiguous() for c in x.chunk(n, dim=-2)]
    ws = _split_cols(w, n)
    held = transport.indices

    def run():
        outs = allgather_matmul([xs[r] for r in held], [ws[r] for r in held],
                                transport, bidirectional=bidirectional)
        return _gather_world(transport, outs, dim=-1)

    if _observe_eager():
        # Gathered bytes: every rank ends up holding all of x.
        return _timed_ring("tp_allgather_matmul", run, n,
                           x.numel() * x.element_size(), x.device)
    return run()


def tp_matmul_reducescatter(x, w, mesh, axis_name="tp",
                            bidirectional="auto"):
    """Global-array form: exactly ``x @ w`` (x (..., M, K), w (K, N) or an
    Int8Weight), the contraction dim sharded over ``axis_name`` and the
    output rows ring-reduce-scattered. ``mesh`` as for
    :func:`tp_allgather_matmul`. Exact-match fallback: a missing or
    size-1 axis, or K or M not dividing over it, runs the plain
    product."""
    n = _ring_size(mesh, axis_name)
    if n <= 1 or x.dim() < 2 or _w_rows(w) % n or x.shape[-2] % n:
        return _chunk_mm(x, w, x.dtype)
    transport = _transport(mesh, axis_name, n)
    xs = [c.contiguous() for c in x.chunk(n, dim=-1)]
    ws = _split_rows(w, n)
    held = transport.indices

    def run():
        outs = matmul_reducescatter([xs[r] for r in held],
                                    [ws[r] for r in held], transport,
                                    bidirectional=bidirectional)
        return _gather_world(transport, outs, dim=-2)

    if _observe_eager():
        # Scattered bytes: the full (..., M, N) product rides the ring as
        # partial sums.
        out_bytes = math.prod(x.shape[:-1]) * _w_cols(w) * x.element_size()
        return _timed_ring("tp_matmul_reducescatter", run, n, out_bytes,
                           x.device)
    return run()
