# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Ring attention: exact attention over a sequence-parallel mesh axis.

Port of ``container_engine_accelerators_tpu/parallel/ring_attention.py``.
The sequence is sharded over a mesh axis ("sp"): each rank holds its
contiguous shard of queries, keys and values, ``(B, H, S/N, D)`` and
``(B, Hkv, S/N, D)``. Over N steps every rank's queries meet every
rank's K/V shard: at step t rank r holds the shard of rank
``(r - t) mod N`` and passes it on to rank r + 1
(``torch.distributed.batch_isend_irecv`` on the axis's group; the next
step's transfer is posted before the current step's kernel and waited
for after it, so it overlaps the kernel, as JAX's ppermute does).

``impl="flash"`` (JAX's ``_ring_flash``; ``"auto"`` picks it) runs the
flash kernels of ``ops/attention.py`` at GLOBAL positions: the forward
step (:func:`fwd_step`) calls ``flash_fwd`` with ``q_base = r·Sl`` and
``k_base = src·Sl`` and folds the result into an f32 (out, lse) pair by
the log-sum-exp combine; the backward step (:func:`bwd_step`) calls
``flash_bwd`` at the same bases with the forward's global lse and one δ
= rowsum(out ∘ dout), adds dq into an f32 accumulator and dk/dv into f32
accumulators that ride the ring with their K/V shard and land home after
N steps. Every (rank, step) calls the kernels, a wholly-future shard
included (it gives out = 0, lse = -1e30 and zero gradients, weighted 0
by the combine). On the CPU the kernels' plain versions run. The two
ring loops (:func:`ring_flash_forward`, :func:`ring_flash_backward`)
take a transport: :class:`P2P` moves one rank's shards between
processes (what :class:`RingFlash` uses), :class:`InProcess` rotates the
lists of every rank's shards in one process, so that one card can run a
whole ring's steps through the same loops. Both also carry the pipeline
schedule's neighbour transfers and broadcasts (``pipe`` and ``share``,
``parallel/pipeline.py``), and the all-reduces of tensor and expert
parallelism (``all_reduce``, ``parallel/tensor_parallel.py``).

``impl="plain"`` is the counterpart of JAX's ``"xla"`` block path: an
einsum block with the streaming-softmax combine on the same ring,
differentiable by autograd through a ring shift whose backward sends
the gradient the other way. JAX's ``unroll`` and ``AUTO_UNROLL_MAX`` are
XLA compile knobs (a statically unrolled or rolled loop) with no meaning
here: the ring is a Python loop.

Every rank must issue its transfers in the same order; under per-layer
remat the forward ring runs again inside the backward, which stays in
step because every rank recomputes the same layers in the same order
(``models/train_cli.py`` reduces gradients after ``backward()``, not in
hooks that would interleave collectives with the rings).
"""

import dataclasses

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.ops.attention import (
    flash_attention,
    flash_bwd,
    flash_fwd,
)

NEG_INF = -1e30
RING_IMPLS = ("auto", "flash", "plain")
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Ring:
    """One rank's view of a ring: the axis's process group, this rank's
    index along the axis, the axis size, and the GLOBAL ranks it sends to
    (``next``) and receives from (``prev``)."""

    group: object
    index: int
    size: int
    next: int
    prev: int


def ring_of(mesh, axis_name="sp"):
    """The :class:`Ring` of this rank along ``axis_name`` of a
    DeviceMesh. Peers are global ranks read from the mesh's rank grid
    along the axis (not rank ± 1, which is wrong once other axes are
    larger than 1)."""
    dim = mesh.mesh_dim_names.index(axis_name)
    coord = list(mesh.get_coordinate())
    index = coord[dim]
    coord[dim] = slice(None)
    ranks = mesh.mesh[tuple(coord)].tolist()
    size = len(ranks)
    return Ring(mesh.get_group(axis_name), index, size,
                ranks[(index + 1) % size], ranks[(index - 1) % size])


def _post(ring, tensors, tag, backward=False):
    """Post one ring transfer: each tensor to the next rank (the previous
    one when ``backward``), the same-shaped tensors from the other side.
    Returns (requests, received buffers, sent buffers); the caller holds
    the tuple until :func:`_wait` so the sent buffers outlive the
    transfer."""
    dst, src = (ring.prev, ring.next) if backward else (ring.next, ring.prev)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group=ring.group, tag=tag + i)
           for i, t in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, r, src, group=ring.group, tag=tag + i)
            for i, r in enumerate(recvs)]
    return dist.batch_isend_irecv(ops), recvs, sends


def _wait(pending):
    """Wait for a posted transfer; returns its received buffers."""
    for req in pending[0]:
        req.wait()
    return pending[1]


def _shift(ring, tensors, tag, backward=False):
    return _wait(_post(ring, tensors, tag, backward))


class P2P:
    """The flash ring's transport between processes: this process holds
    one rank of ``ring`` and moves its shards by ``batch_isend_irecv``.
    ``post`` takes and ``wait`` returns one tuple of tensors per rank
    held (here one)."""

    def __init__(self, ring):
        self.ring = ring
        self.size = ring.size
        self.indices = (ring.index,)

    def post(self, shards, tag, backward=False):
        (tensors,) = shards
        return _post(self.ring, tensors, tag, backward)

    def wait(self, pending):
        return [tuple(_wait(pending))]

    def pipe(self, to_next, to_prev, want_prev, want_next, like, tag):
        """One pipeline tick's transfers (``parallel/pipeline.py``), in
        one ``batch_isend_irecv``: per rank held, the tensor (or None)
        for the next stage and for the previous one, whether a tensor
        comes from the previous stage and from the next, and
        ``like(shape_source)`` → an empty buffer to receive into. The
        wrap-around pair is never used: the first stage sends nothing
        back, the last nothing on. Returns (from previous, from next)
        per rank held, None where nothing came."""
        ring = self.ring
        (send_next,), (send_prev,) = to_next, to_prev
        (take_prev,), (take_next,) = want_prev, want_next
        ops, got_prev, got_next = [], None, None
        if send_next is not None:
            ops.append(dist.P2POp(dist.isend, send_next.contiguous(),
                                  ring.next, group=ring.group, tag=tag))
        if send_prev is not None:
            ops.append(dist.P2POp(dist.isend, send_prev.contiguous(),
                                  ring.prev, group=ring.group, tag=tag + 1))
        if take_prev:
            got_prev = like()
            ops.append(dist.P2POp(dist.irecv, got_prev, ring.prev,
                                  group=ring.group, tag=tag))
        if take_next:
            got_next = like()
            ops.append(dist.P2POp(dist.irecv, got_next, ring.next,
                                  group=ring.group, tag=tag + 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [got_prev], [got_next]

    def share(self, tensors, src):
        """The value that the rank at index ``src`` holds, on every
        rank: ``tensors`` (one per rank held) is the value there and a
        buffer of its shape and dtype elsewhere; broadcast over the
        axis's group, in place. Returns the list."""
        (t,) = tensors
        dist.broadcast(t, dist.get_global_rank(self.ring.group, src),
                       group=self.ring.group)
        return [t]

    def all_reduce(self, tensors, op="sum"):
        """The sum (``op="max"``: the maximum) over the ring's ranks of
        ``tensors`` (one per rank held), on every rank, in a new buffer;
        a ring of one returns ``tensors`` as they are."""
        if self.size == 1:
            return list(tensors)
        (t,) = tensors
        out = t.contiguous().clone()
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.ring.group)
        return [out]


class InProcess:
    """Every rank of a ring of ``size`` in one process: a transfer is the
    rotation of the list of shards, rank r taking rank r - 1's (r + 1's
    when ``backward``). The same ring loops then run every rank's steps
    with the same combine and the same dk/dv travel."""

    def __init__(self, size):
        self.size = size
        self.indices = tuple(range(size))

    def post(self, shards, tag, backward=False):
        hop = -1 if backward else 1
        return [shards[(r - hop) % self.size] for r in range(self.size)]

    def wait(self, pending):
        return pending

    def pipe(self, to_next, to_prev, want_prev, want_next, like, tag):
        """:meth:`P2P.pipe` for every stage in one process: stage r
        takes stage r - 1's tensor for the next stage and stage r + 1's
        for the previous one, by reference."""
        n = self.size
        got_prev = [to_next[r - 1] if r > 0 and want_prev[r] else None
                    for r in range(n)]
        got_next = [to_prev[r + 1] if r < n - 1 and want_next[r] else None
                    for r in range(n)]
        return got_prev, got_next

    def share(self, tensors, src):
        """:meth:`P2P.share` in one process: every stage takes stage
        ``src``'s tensor."""
        return [tensors[src]] * self.size

    def all_reduce(self, tensors, op="sum"):
        """:meth:`P2P.all_reduce` in one process: the ranks' tensors
        summed (or their maximum) in rank order, one result a rank. A
        ring of one returns ``tensors`` as they are, however many ranks
        of another axis the list holds."""
        if self.size == 1:
            return list(tensors)
        total = tensors[0]
        for t in tensors[1:]:
            total = torch.maximum(total, t) if op == "max" else total + t
        return [total] * self.size


# -- the flash ring -----------------------------------------------------------

def fwd_step(q, k, v, out, lse, *, q_base, k_base, causal, sm_scale):
    """One forward ring step: ``flash_fwd`` of the local queries against
    the visiting K/V shard at global bases, folded into the running f32
    ``out`` (B, Hq, Sl, D) and ``lse`` (B, Hq, Sl) by JAX's combine
    (``logaddexp``; weights exp(lse - lse_new)). Returns the new (out,
    lse). A shard that no query sees arrives with lse_b = -1e30 and
    weight 0."""
    o_b, lse_b = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                           q_base=q_base, k_base=k_base)
    lse_new = torch.logaddexp(lse, lse_b)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_b - lse_new)[..., None]
    return out * w_old + o_b.float() * w_new, lse_new


def bwd_step(q, k, v, out, lse, g, delta, dq, dk, dv, *, q_base, k_base,
             causal, sm_scale):
    """One backward ring step: ``flash_bwd`` at the step's global bases
    with the forward's global ``lse`` and ``delta``; adds the block's dq
    into the local f32 ``dq`` and its dk/dv into the f32 accumulators
    ``dk``/``dv`` of the visiting shard, in place."""
    dq_b, dk_b, dv_b = flash_bwd(q, k, v, out, lse, g, causal=causal,
                                 sm_scale=sm_scale, q_base=q_base,
                                 k_base=k_base, delta=delta)
    dq += dq_b.float()
    dk += dk_b.float()
    dv += dv_b.float()


def delta_of(out, g):
    """The backward's δ = rowsum(out ∘ dout), f32, from the global out."""
    return (out.float() * g.float()).sum(dim=-1)


def ring_flash_forward(qs, ks, vs, transport, causal, sm_scale):
    """The forward ring of every rank ``transport`` holds (lists of
    their shards, in its ``indices`` order) → (outs in q's dtype, global
    lses f32). Each step posts the K/V transfer before its kernels and
    waits for it after them."""
    seq_l = qs[0].shape[2]
    outs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in qs]
    lses = [torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device) for q in qs]
    kv = list(zip(ks, vs))
    for t in range(transport.size):
        pending = None
        if t < transport.size - 1:
            pending = transport.post(kv, tag=0)
        for i, r in enumerate(transport.indices):
            src = (r - t) % transport.size
            outs[i], lses[i] = fwd_step(
                qs[i], *kv[i], outs[i], lses[i], q_base=r * seq_l,
                k_base=src * seq_l, causal=causal, sm_scale=sm_scale)
        if pending is not None:
            kv = transport.wait(pending)
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def ring_flash_backward(qs, ks, vs, outs, lses, gs, transport, causal,
                        sm_scale):
    """The backward ring of every rank ``transport`` holds → (dqs, dks,
    dvs) in the inputs' dtypes. dk/dv accumulate in f32 beside their K/V
    shard, take a hop after every step, and are home after N."""
    seq_l = qs[0].shape[2]
    deltas = [delta_of(o, g) for o, g in zip(outs, gs)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    dkv = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(k.shape, dtype=torch.float32, device=k.device))
           for k in ks]
    kv = list(zip(ks, vs))
    for t in range(transport.size):
        pending = None
        if t < transport.size - 1:
            pending = transport.post(kv, tag=0)
        for i, r in enumerate(transport.indices):
            src = (r - t) % transport.size
            bwd_step(qs[i], *kv[i], outs[i], lses[i], gs[i], deltas[i],
                     dqs[i], *dkv[i], q_base=r * seq_l, k_base=src * seq_l,
                     causal=causal, sm_scale=sm_scale)
        dkv = transport.wait(transport.post(dkv, tag=2))
        if pending is not None:
            kv = transport.wait(pending)
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)],
            [dk.to(k.dtype) for (dk, _), k in zip(dkv, ks)],
            [dv.to(v.dtype) for (_, dv), v in zip(dkv, vs)])


class RingFlash(torch.autograd.Function):
    """The flash ring of every rank a transport holds (``InProcess``: a
    whole ring in one process; ``P2P``: this process's rank) with its own
    backward ring (JAX's ``_ring_flash`` custom_vjp): ``apply(transport,
    causal, sm_scale, n, *qs, *ks, *vs)`` → the n ranks' outs, then their
    lses (not differentiable). Saves (q, k, v, out, lse) and recomputes
    the probabilities blockwise from the global lse over the same
    transport."""

    @staticmethod
    def forward(ctx, transport, causal, sm_scale, n, *qkv):
        qs, ks, vs = (list(qkv[i * n:(i + 1) * n]) for i in range(3))
        outs, lses = ring_flash_forward(qs, ks, vs, transport, causal,
                                        sm_scale)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.transport, ctx.causal, ctx.sm_scale, ctx.n = (
            transport, causal, sm_scale, n)
        ctx.mark_non_differentiable(*lses)
        return (*outs, *lses)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * n:(i + 1) * n])
                                  for i in range(5))
        gs = [torch.zeros_like(o) if g is None else g.contiguous()
              for g, o in zip(gs[:n], outs)]
        dqs, dks, dvs = ring_flash_backward(qs, ks, vs, outs, lses, gs,
                                            ctx.transport, ctx.causal,
                                            ctx.sm_scale)
        return (None, None, None, None, *dqs, *dks, *dvs)


def ring_attend(transport, impl="flash", causal=True):
    """Attention over a sequence-parallel axis for every rank
    ``transport`` holds: a function of the lists (qs, ks, vs) of their
    shards → their outs. ``impl`` "flash" (or "auto") runs
    :class:`RingFlash`; "plain" the block ring, which moves shards
    between processes only (a ``P2P`` transport)."""
    if impl not in RING_IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}; known: {RING_IMPLS}")
    if impl == "plain":
        if not isinstance(transport, P2P):
            raise ValueError("the plain ring moves shards between processes "
                             "only; a ring held in one process is flash")

        def plain(qs, ks, vs):
            return [ring_plain(q, k, v, transport.ring, causal)
                    for q, k, v in zip(qs, ks, vs)]
        return plain

    def flash(qs, ks, vs):
        sm_scale = 1.0 / (qs[0].shape[-1] ** 0.5)
        n = len(qs)
        return list(RingFlash.apply(transport, causal, sm_scale, n, *qs,
                                    *ks, *vs)[:n])
    return flash


# -- the plain ring -----------------------------------------------------------

def _block_attention(q, k, v, mask):
    """Unnormalized block attention with streaming-softmax residuals
    (JAX's ``_block_attention``): q (B, H, Sq, D), k/v (B, Hkv, Sk, D),
    mask (1, 1, Sq, Sk), True = attend. Returns (o, m, l): o = exp(s - m)
    @ v, m = the row max (clamped to -1e29 so a fully-masked row adds
    nothing), l = the row sum of exp. GQA folds the query heads into a
    group dim against the shared K/V heads."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    sm_scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, group, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * sm_scale
    s = torch.where(mask.unsqueeze(2), s, torch.full_like(s, NEG_INF))
    m_safe = s.amax(dim=-1, keepdim=True).clamp_min(-1e29)
    p = torch.exp(s - m_safe) * (s > NEG_INF / 2)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return (o.reshape(b, hq, sq, d), m_safe.reshape(b, hq, sq, 1),
            l.reshape(b, hq, sq, 1))


class _Shift(torch.autograd.Function):
    """K and V one hop along the ring; the gradients go one hop back."""

    @staticmethod
    def forward(ctx, ring, k, v):
        ctx.ring = ring
        k_next, v_next = _shift(ring, (k, v), tag=4)
        return k_next, v_next

    @staticmethod
    def backward(ctx, gk, gv):
        gk_prev, gv_prev = _shift(ctx.ring, (gk, gv), tag=4, backward=True)
        return None, gk_prev, gv_prev


def ring_plain(q, k, v, ring, causal):
    """The block ring (JAX's ``_ring_attention_local``): N - 1 shifting
    steps and a final accumulate, every step's block combined by the
    running max ``m``, sum ``l`` and f32 accumulator."""
    seq_l = q.shape[2]
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m_run = torch.full((*q.shape[:3], 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros_like(m_run)
    ids = torch.arange(seq_l, device=q.device)
    q_ids = ring.index * seq_l + ids
    k_cur, v_cur = k, v
    for t in range(ring.size):
        src = (ring.index - t) % ring.size
        if causal:
            mask = q_ids[:, None] >= (src * seq_l + ids)[None, :]
        else:
            mask = torch.ones(seq_l, seq_l, dtype=torch.bool,
                              device=q.device)
        o_b, m_b, l_b = _block_attention(q, k_cur, v_cur, mask[None, None])
        m_new = torch.maximum(m_run, m_b)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_b - m_new)
        acc = acc * alpha + o_b * beta
        l_run = l_run * alpha + l_b * beta
        m_run = m_new
        if t < ring.size - 1:
            k_cur, v_cur = _Shift.apply(ring, k_cur, v_cur)
    return (acc / l_run.clamp_min(1e-30)).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name="sp", causal=True, impl="auto"):
    """Exact attention with the sequence sharded over ``axis_name`` of
    ``mesh`` (a DeviceMesh; ``mesh=None`` or an axis of size 1 is one
    device). q (B, H, S/N, D), k/v (B, Hkv, S/N, D): this rank's shards,
    contiguous positions ``[r·S/N, (r+1)·S/N)``. Differentiable.
    ``impl``: "flash" (the kernels per ring step), "plain" (the einsum
    block ring), or "auto" = "flash"."""
    if impl not in RING_IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}; known: {RING_IMPLS}")
    ring = None if mesh is None else ring_of(mesh, axis_name)
    if impl != "plain" and (ring is None or ring.size == 1):
        return flash_attention(q, k, v, causal=causal,
                               sm_scale=1.0 / (q.shape[-1] ** 0.5))
    return ring_attend(P2P(ring or Ring(None, 0, 1, 0, 0)), impl,
                       causal)([q], [k], [v])[0]
