# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Flash attention for Hopper: the CUDA kernel's wrappers and plain versions.

Port of ``container_engine_accelerators_tpu/ops/attention.py``. Public
functions keep the JAX layout: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D),
grouped-query attention with ``Hq % Hkv == 0``.

  flash_fwd           counterpart of ``_flash_fwd``: CPU tensors go to
                      ``flash_fwd_reference``, CUDA tensors to the kernel
                      in csrc/flash_fwd.cu (there is no fallback)
  flash_bwd           counterpart of ``_flash_bwd``: CPU tensors go to
                      ``flash_bwd_reference``, CUDA tensors to the dq and
                      dk/dv kernels in csrc/flash_bwd.cu
  FlashAttention      autograd Function, counterpart of the ``_flash``
                      custom_vjp: flash_fwd forward, flash_bwd backward
  flash_attention     counterpart of ``flash_attention`` (differentiable)
  flash_fwd_reference plain version of the forward kernel (same masks,
                      constants and bf16 rounding of p)
  flash_bwd_reference plain version of the backward kernels (same masks,
                      constants and bf16 rounding of p and ds)
  decode_attention    single-token attention over a dense KV cache
  mha_reference       the plain oracle (GQA by repeating kv heads)

``flash_fwd_launches``, ``flash_dq_launches`` and ``flash_dkv_launches``
count kernel launches; each moves only where its wrapper launches its
kernel.
"""

import torch

# Finite, as in the JAX kernels: exp(NEG_INF - NEG_INF) = 1, never NaN.
NEG_INF = -1e30

# Kernel launches made by flash_fwd and flash_bwd (CUDA tensors only).
flash_fwd_launches = 0
flash_dq_launches = 0
flash_dkv_launches = 0


def mha_reference(q, k, v, causal=True, sm_scale=None):
    """Plain multi-head attention (the oracle); GQA by repeating kv
    heads. Scores and softmax in f32; the normalized probabilities are
    cast to v's dtype before the PV product, as the JAX oracle does."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        seq_q, seq_k = s.shape[-2], s.shape[-1]
        q_ids = torch.arange(seq_q, device=q.device)[:, None]
        k_ids = torch.arange(seq_k, device=q.device)[None, :]
        s = s.masked_fill(q_ids < k_ids, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def decode_attention(q, k_cache, v_cache, length):
    """q: (B, Hq, 1, hd); caches (B, Hkv, S, hd); attend to [0, length).

    ``length`` is a scalar or a (B,) vector. GQA without repeating the
    caches: the query heads fold into a group dim against the shared K/V
    heads. f32 scores, finite -1e30 mask."""
    b, hq, _, hd = q.shape
    hkv, seq = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) / (hd ** 0.5)
    lengths = torch.as_tensor(length, device=q.device).expand(b)
    mask = (
        torch.arange(seq, device=q.device)[None, None, None, :]
        < lengths[:, None, None, None]
    )
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, hd).to(q.dtype)


def _per_row(x):
    """An int as it is; a (B,) tensor as (B, 1, 1, 1), to broadcast one
    value per batch row over (B, H, Sq, Sk)."""
    return x.reshape(-1, 1, 1, 1) if torch.is_tensor(x) else x


def _visible(seq_q, seq_k, causal, q_base, k_base, kv_len, device):
    """(Sq, Sk) bool: key column j is visible to query row i. The causal
    compare is at GLOBAL positions (q_base + i >= k_base + j); columns at
    or past ``kv_len`` are the masked tail. ``q_base``, ``k_base`` and
    ``kv_len`` are ints, or (B,) tensors of one value per batch row, and
    then the mask is (B, 1, Sq, Sk)."""
    q_base, k_base, kv_len = (_per_row(x) for x in (q_base, k_base, kv_len))
    cols = torch.arange(seq_k, device=device)[None, :]
    vis = cols < (seq_k if kv_len is None else kv_len)
    if causal:
        rows = torch.arange(seq_q, device=device)[:, None]
        vis = vis & (q_base + rows >= k_base + cols)
    return vis


def _row_bases(base, seq_k, device):
    """(q_base, k_base, kv_len), each a (B,) int64 tensor on ``device``,
    from a (B, 3) ``base``; kv_len clamped to [0, seq_k] as the kernel
    clamps it."""
    q_base, k_base, kv_len = base.to(device=device, dtype=torch.long).unbind(1)
    return q_base, k_base, kv_len.clamp(0, seq_k)


def flash_fwd_reference(q, k, v, *, causal, sm_scale, q_base=0, k_base=0,
                        kv_len=None, base=None):
    """Plain version of the flash forward → (out, lse).

    ``base`` (B, 3) integers, when given, are per batch row [q_base,
    k_base, kv_len] in place of the three arguments (kv_len clamped to
    [0, Sk]), as the kernel reads them from device memory.

    out: (B, Hq, Sq, D) in q's dtype; lse: (B, Hq, Sq) f32. The same
    arithmetic as the kernel: f32 scores scaled after the product,
    finite NEG_INF masks, p = exp(s - m) cast to v's dtype before the
    PV product with f32 accumulation, out = acc / max(l, 1e-30) and
    lse = m + log(max(l, 1e-30)).

    Masked keys contribute p = 0. A row that sees no key at all (every
    key in its future, or all past ``kv_len``) gives out = 0 and
    lse = -1e30. The JAX kernel agrees wherever its loop for the row is
    empty; where a row is fully masked inside a tile it still visits,
    the JAX kernel's exp(-1e30 - -1e30) = 1 averages v over that tile
    instead (a value that depends on its block size and that ring
    attention weights by exp(lse) ≈ 0). Rows that see at least one key
    match the JAX kernel exactly up to summation order.

    The score matrix is formed one kv head (its whole query group) at a
    time, so an 8k × 8k causal call stays within a few GB."""
    batch, num_q_heads, seq_q, d = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    group = num_q_heads // num_kv_heads
    if base is not None:
        q_base, k_base, kv_len = _row_bases(base, seq_k, q.device)
    vis = _visible(seq_q, seq_k, causal, q_base, k_base, kv_len, q.device)
    out = torch.empty_like(q)
    lse = torch.empty(batch, num_q_heads, seq_q, dtype=torch.float32,
                      device=q.device)
    for h in range(num_kv_heads):
        heads = slice(h * group, (h + 1) * group)
        qh = q[:, heads].reshape(batch, group * seq_q, d).float()
        kh = k[:, h].float()
        s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
        s = s.view(batch, group, seq_q, seq_k).masked_fill_(~vis, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_().masked_fill_(~vis, 0.0)
        l_safe = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
        acc = torch.matmul(
            p.to(v.dtype).float().view(batch, group * seq_q, seq_k),
            v[:, h].float(),
        ).view(batch, group, seq_q, d)
        out[:, heads] = (acc / l_safe).to(q.dtype)
        lse[:, heads] = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def _check_attention_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch "
            f"or head dim"
        )
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"num_q_heads {q.shape[1]} must be a multiple of num_kv_heads "
            f"{k.shape[1]}"
        )


def flash_fwd(q, k, v, *, causal, sm_scale, q_base=0, k_base=0,
              kv_len=None, base=None):
    """Flash forward → (out, lse), the counterpart of JAX ``_flash_fwd``.

    ``q_base``/``k_base`` (ints) place the given rows/columns at global
    positions for the causal compare and the loop bound; ``kv_len``
    masks key columns at or past it. ``base``, the counterpart of the
    Pallas kernel's ``base_ref``, is a (B, 3) int32 tensor on q's device
    of one [q_base, k_base, kv_len] per batch row, used in place of the
    three arguments: the kernel reads it from device memory and nothing
    here reads it on the host, so a CUDA graph that captured this call
    follows the values the tensor holds at each replay. CPU tensors take
    the plain version; CUDA tensors launch the hand-written kernel
    (ops/csrc/flash_fwd.cu), which raises on what it does not take: there
    is no fallback. ``flash_fwd_launches`` counts the calls that launch
    the kernel here: not a call that a CUDA graph captures, nor its
    replays."""
    global flash_fwd_launches
    _check_attention_shapes(q, k, v)
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return flash_fwd_reference(
            q, k, v, causal=causal, sm_scale=sm_scale, q_base=q_base,
            k_base=k_base, kv_len=kv_len, base=base,
        )
    if devices != {"cuda"}:
        raise ValueError(f"q/k/v must all be on cpu or all on cuda, got "
                         f"{q.device}, {k.device}, {v.device}")
    from container_engine_accelerators_tpu_torch.ops import _ext

    seq_k = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    if base is None:
        kv_len = seq_k if kv_len is None else max(0, min(int(kv_len), seq_k))
        q_base, k_base = int(q_base), int(k_base)
    else:
        q_base = k_base = kv_len = 0  # read from ``base`` by the kernel
    _ext.flash_fwd(
        q, k, v, out, lse, causal=causal, sm_scale=sm_scale,
        q_base=q_base, k_base=k_base, kv_len=kv_len, base=base,
    )
    if not torch.cuda.is_current_stream_capturing():
        # A call under capture records the launch into a graph; its
        # replays launch it, and their callers count them.
        flash_fwd_launches += 1
    return out, lse


def flash_bwd_reference(q, k, v, out, lse, g, *, causal, sm_scale,
                        q_base=0, k_base=0, delta=None, kv_len=None,
                        only=None):
    """Plain version of the flash backward → (dq, dk, dv).

    The kernels' arithmetic: s = (q · kᵀ) * scale in f32, p = exp(s - lse)
    with masked keys contributing p = 0 (so a row that sees no key gets a
    zero gradient), dp = dO · vᵀ, ds = p * (dp - δ) * scale cast to q's
    dtype before ds · k and dsᵀ · q, p cast to dO's dtype before pᵀ · dO,
    f32 accumulation. dk and dv sum the GQA group in f32 and are rounded
    once; key columns at or past ``kv_len`` get dk = dv = 0. ``delta``
    (B, Hq, Sq) f32 defaults to rowsum(dO ∘ O). Formed one kv head (its
    whole query group) at a time, as ``flash_fwd_reference`` is.
    ``only="dq"`` or ``only="dkv"`` forms just one kernel's outputs (the
    others come back None), the plain counterpart of that one kernel."""
    batch, num_q_heads, seq_q, d = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    group = num_q_heads // num_kv_heads
    g = g.to(q.dtype)
    if delta is None:
        delta = (out.float() * g.float()).sum(dim=-1)
    hidden = ~_visible(seq_q, seq_k, causal, q_base, k_base, kv_len,
                       q.device)
    dq = None if only == "dkv" else torch.empty_like(q)
    dk = dv = None
    if only != "dq":
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    for h in range(num_kv_heads):
        heads = slice(h * group, (h + 1) * group)
        qh = q[:, heads].float()
        gh = g[:, heads].float()
        kh = k[:, h, None].float()
        vh = v[:, h, None].float()
        s = torch.matmul(qh, kh.transpose(-1, -2)).mul_(sm_scale)
        p = s.sub_(lse[:, heads, :, None]).exp_().masked_fill_(hidden, 0.0)
        ds = torch.matmul(gh, vh.transpose(-1, -2))
        ds = ds.sub_(delta[:, heads, :, None]).mul_(p).mul_(sm_scale)
        ds = ds.to(q.dtype).float()
        if dq is not None:
            dq[:, heads] = torch.matmul(ds, kh).to(q.dtype)
        if dk is None:
            continue
        # (B, G·Sq, Sk)ᵀ · (B, G·Sq, D): the group sum rides the product.
        rows = (batch, group * seq_q)
        dk[:, h] = torch.matmul(ds.view(*rows, seq_k).transpose(1, 2),
                                qh.reshape(*rows, d)).to(k.dtype)
        del ds
        p = p.to(g.dtype).float()
        dv[:, h] = torch.matmul(p.view(*rows, seq_k).transpose(1, 2),
                                gh.reshape(*rows, d)).to(v.dtype)
    return dq, dk, dv


def flash_bwd(q, k, v, out, lse, g, *, causal, sm_scale, q_base=0,
              k_base=0, delta=None, kv_len=None):
    """Flash backward → (dq, dk, dv), the counterpart of JAX ``_flash_bwd``.

    ``out``/``lse`` are the forward's; ``g`` is dL/dout (cast to q's
    dtype). δ = rowsum(dO ∘ O) is formed here in f32, as the JAX package
    forms it outside its kernels, unless ``delta`` is given. CPU tensors
    take the plain version; CUDA tensors launch the dq and the dk/dv
    kernels of ops/csrc/flash_bwd.cu, which raise on what they do not
    take: there is no fallback."""
    global flash_dq_launches, flash_dkv_launches
    _check_attention_shapes(q, k, v)
    if delta is None:
        delta = (out.float() * g.float()).sum(dim=-1)
    tensors = (q, k, v, out, lse, g, delta)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return flash_bwd_reference(
            q, k, v, out, lse, g, causal=causal, sm_scale=sm_scale,
            q_base=q_base, k_base=k_base, delta=delta, kv_len=kv_len,
        )
    if devices != {"cuda"}:
        raise ValueError(f"flash_bwd's tensors must all be on cpu or all on "
                         f"cuda, got {[str(t.device) for t in tensors]}")
    from container_engine_accelerators_tpu_torch.ops import _ext

    seq_k = k.shape[2]
    kv_len = seq_k if kv_len is None else max(0, min(int(kv_len), seq_k))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    args = (q, k, v, g.to(q.dtype).contiguous(), lse.contiguous(),
            delta.contiguous())
    kw = dict(causal=causal, sm_scale=sm_scale, q_base=int(q_base),
              k_base=int(k_base), kv_len=kv_len)
    _ext.flash_bwd_dq(*args, dq, **kw)
    flash_dq_launches += 1
    _ext.flash_bwd_dkv(*args, dk, dv, **kw)
    flash_dkv_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash`` custom_vjp: the forward saves
    (q, k, v, out, lse) and the backward recomputes the probabilities
    blockwise from lse, so no S × S matrix is ever kept."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g, causal=ctx.causal,
                               sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """Flash attention. q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D).

    Same results as the JAX wrapper for every shape, and differentiable
    (``FlashAttention``). The JAX wrapper end-pads unaligned sequences to
    a block multiple and masks the padded keys (by position when causal
    with seq_q <= seq_k, else by the kv_len tail mask); the CUDA kernels
    mask their ragged edges themselves, so here nothing is padded and
    keys past seq_k simply do not exist."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return FlashAttention.apply(q, k, v, causal, float(sm_scale))
