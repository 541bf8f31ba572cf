# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Llama-style decoder-only transformer, PyTorch port of the serving and
single-device training paths.

Port of ``container_engine_accelerators_tpu/models/transformer.py``:
RMSNorm, rotary embeddings, grouped-query attention, SwiGLU MLP, tied
output head, a dense KV cache and batched prefill + decode, the dense
continuous-batching programs (``prefill_into_slot``,
``prefill_chunk_into_slot``, ``decode_logits_multi`` and ``decode_chunk``
with its one step ``dense_decode_step``), the paged serving programs
(``paged_prefill_segment``, ``paged_decode_chunk`` and its one step
``paged_decode_step``, speculation's ``paged_verify_batch`` and its
one-row form ``paged_verify_chunk``), the static shape grid a server can
dispatch (``serving_shape_buckets``) and the training step (``loss_fn``,
``make_train_step``). Weights keep the
JAX layout ((in, out) matrices, so every projection is ``x @ w``); the
stacked layer dim becomes a ``ModuleList``. Prefill and training
attention go through ``ops.attention.flash_attention`` (the hand-written
CUDA kernels, forward and backward, on CUDA tensors; their plain
versions on CPU tensors), dense and paged prefill segments through
``ops.attention.flash_fwd`` at the segment's global ``q_base``, and the
verify through it at per-row bases read from device memory; decode
attention is plain PyTorch, as it is plain XLA in the JAX package. On
CUDA the decode steps run as captured CUDA graphs, one per shape bucket
(``models/serving_graphs.py``), the counterpart of the JAX package's
jitted serving programs. Every projection goes through ``_mm``, which
sends a layer matrix quantized by ``models/quantization.py``
(``Int8Weight``, ``--quantize int8``) to the W8A16 product of
``ops/int8_matmul.py`` (the hand-written kernel on CUDA tensors).
Parameters are trainable, dense ones only; the serving entry points run
under ``torch.inference_mode()``. With ``n_experts > 0`` every layer's
FFN is the mixture-of-experts block of ``parallel/moe.py`` (forward,
``loss_fn`` with the aux loss, ``make_train_step``, and every serving
program: each routes per leading-dim group of its input, as JAX's do;
under a mesh's "sp" axis each sequence is routed whole across its sp
ranks).

Training takes a DeviceMesh (``make_train_step(mesh=...)``, the JAX
step's ``mesh``): its "dp" axis splits the global batch's rows and its
"sp" axis the sequence, each rank running its shard of positions with
RoPE at global positions and attention as a ring over the sp axis
(``parallel/ring_attention.py``). A mesh with a "tp" or "ep" axis above
1 trains tensor- and expert-parallel (``models/tp_lm.py``: the Megatron
shards of JAX's ``param_shardings``, the ring collective matmuls of
``parallel/overlap.py`` where ``resolve_overlap`` gives "ring", the
experts of ``parallel/moe.py`` over ep). Pipeline parallelism is
``models/pipeline_lm.py``.
"""

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from container_engine_accelerators_tpu_torch.models.quantization import (
    Int8Weight,
    model_is_quantized,
)
from container_engine_accelerators_tpu_torch.ops import int8_matmul
from container_engine_accelerators_tpu_torch.ops import paged_attention as pa
from container_engine_accelerators_tpu_torch.ops.attention import (
    decode_attention,
    flash_attention,
    flash_fwd,
    flash_fwd_reference,
    mha_reference,
)
from container_engine_accelerators_tpu_torch.parallel import (
    data_parallel,
    moe,
    ring_attention,
    tensor_parallel,
)

# The dtype names a config takes (JAX's `jnp.dtype` reads any name; the
# port takes the three its kernels run, and refuses others by name).
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # Mixture-of-experts: n_experts > 0 replaces every layer's dense FFN
    # with the MoE FFN of parallel/moe.py (all experts on one device).
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Latency-hiding tensor parallelism: "auto"/"ring" run the tp-axis
    # matmul collectives as ring collective-matmul decompositions
    # (parallel/overlap.py) wherever legal, "off" keeps one all-reduce
    # after each row-parallel product. resolve_overlap() degrades what
    # cannot ring to the exact "off" path.
    overlap: str = "auto"

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        return _DTYPES[self.dtype]

    @classmethod
    def llama3_8b(cls):
        return cls(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=500000.0,
        )


def resolve_device(device="cuda"):
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when CUDA is asked for and absent; never drops to
    the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return device


def _rms_norm(x, scale, eps=1e-5):
    """f32 statistics, cast back to the activation dtype, then scale (the
    JAX cast order, which matters in bf16)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x, positions, theta):
    """x: (B, H, S, hd), positions: (B, S). Rotates split halves (not
    interleaved pairs) in f32."""
    hd = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, hd // 2, dtype=torch.float32, device=x.device)
        / (hd // 2)
    )
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return _rms_norm(x, self.weight)


def _weight(d_in, d_out, dtype, device):
    return nn.Parameter(torch.empty(d_in, d_out, dtype=dtype, device=device))


def _mm(x, w):
    """x @ w, the JAX ``_mm``: a dense weight is a plain product; an
    ``Int8Weight`` (``models/quantization.py``) goes to the W8A16 product
    ``ops.int8_matmul.int8_mm`` (the hand-written kernel on CUDA tensors,
    its plain version on CPU ones), which applies the per-output-channel
    f32 scale to the f32-accumulated product before the one cast to x's
    dtype."""
    if isinstance(w, Int8Weight):
        return int8_matmul.int8_mm(x, w.q, w.scale)
    return x @ w


class Attention(nn.Module):
    """q/k/v/o projections + rope; the attention itself is chosen by the
    caller (prefill: flash; decode: the dense cache)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
        self.cfg = cfg
        self.wq = _weight(d, cfg.n_heads * hd, dt, device)
        self.wk = _weight(d, cfg.n_kv_heads * hd, dt, device)
        self.wv = _weight(d, cfg.n_kv_heads * hd, dt, device)
        self.wo = _weight(cfg.n_heads * hd, d, dt, device)


def _split_heads(t, hd):
    """(B, S, H·hd) → (B, H, S, hd)."""
    batch, seq, width = t.shape
    return t.view(batch, seq, width // hd, hd).transpose(1, 2)


def _merge_heads(a):
    """(B, H, S, hd) → (B, S, H·hd)."""
    batch, heads, seq, hd = a.shape
    return a.transpose(1, 2).reshape(batch, seq, heads * hd)


class FeedForward(nn.Module):
    """Dense SwiGLU's weights (``block`` computes it: SiLU in f32, cast
    back before gate * up)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.w1 = _weight(d, f, dt, device)
        self.w3 = _weight(d, f, dt, device)
        self.w2 = _weight(f, d, dt, device)


class MoEFeedForward(nn.Module):
    """The MoE FFN (``parallel/moe.moe_ffn``, routed per sequence): an f32
    router (D, E) and per-expert GELU matrices w1 (E, D, F), w2 (E, F, D),
    JAX's ``moe_router``, ``moe_w1`` and ``moe_w2``."""

    def __init__(self, cfg, device):
        super().__init__()
        d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.torch_dtype
        self.cfg = cfg
        self.router = nn.Parameter(
            torch.empty(d, e, dtype=torch.float32, device=device))
        self.w1 = nn.Parameter(torch.empty(e, d, f, dtype=dt, device=device))
        self.w2 = nn.Parameter(torch.empty(e, f, d, dtype=dt, device=device))

    def forward(self, h, sp=None):
        """(B, S, D) → (the FFN's output, the layer's f32 aux loss).
        ``sp``: the transport of a sequence-parallel axis ``h``'s
        positions are this rank's shard of; each sequence is routed
        whole over it (``moe.moe_ffn_parallel``)."""
        params = {"router": self.router, "w1": self.w1, "w2": self.w2}
        kw = dict(top_k=self.cfg.expert_top_k,
                  capacity_factor=self.cfg.capacity_factor)
        if sp is None or sp.size == 1:
            return moe.moe_ffn(h, params, **kw)
        lone = ring_attention.InProcess(1)
        ys, auxes = moe.moe_ffn_parallel(
            [h], [params], tensor_parallel.Axes(lone, lone, sp), **kw)
        return ys[0], auxes[0]


def dense_products(hs, wss):
    """Per rank held, ``_mm(h, w)`` for each weight of its tuple: a block's
    entering products on whole weights."""
    return [tuple(_mm(h, w) for w in ws) for h, ws in zip(hs, wss)]


def dense_sums(xs, ws):
    """Per rank held, ``_mm(x, w)``: a block's leaving products on whole
    weights."""
    return [_mm(x, w) for x, w in zip(xs, ws)]


def each_rank(attend):
    """``block``'s ``attend`` from per-rank attention: ``attend(q, k, v)``
    on every rank held, or a list of each rank's own (the serving
    programs': each rank's cache holds its own heads)."""
    def run(qs, ks, vs):
        fns = attend if isinstance(attend, list) else [attend] * len(qs)
        return [a(q, k, v) for a, q, k, v in zip(fns, qs, ks, vs)]
    return run


def block(layers, xs, positions, attend, enter=dense_products,
          leave=dense_sums, moe_ffn=None, ffn_enter=None, ffn_leave=None):
    """One decoder block on every rank held: ``layers`` each rank's
    ``DecoderLayer`` (the whole one, or its tensor-parallel shard: the
    head counts follow the q/k/v widths), ``xs`` their (B, S, D) inputs
    at ``positions`` (B, S), or a list of each rank's.

    ``enter(hs, wss)`` computes the products the normed inputs enter, per
    rank a tuple for the tuple of weights (q/k/v, then w1/w3), and
    ``leave(xs, ws)`` the products that leave to the residual stream (wo,
    w2): plain products on one device; the column shards' products of a
    replicated input, then row-parallel partial sums over tp (the off
    path, ``models/tp_lm.py``); or the ring collective matmuls, which
    gather and scatter the sequence (the ring path). ``attend(qs, ks,
    vs)`` maps every rank's rope'd q/k/v (B, H, S, hd) at its positions
    to its (B, Hq, S, hd): :func:`each_rank`'s per-rank attention, or a
    sequence-parallel ring over the ranks (``ring_attention.ring_attend``).
    ``moe_ffn(hs)`` replaces an MoE layer's FFN across ranks (expert
    parallelism); without it each rank runs its layer's own.
    ``ffn_enter``/``ffn_leave`` (default ``enter``/``leave``) are the
    FFN's, where it is split otherwise than the attention.

    Returns (xs, the rope'd (k, v) per rank, the MoE aux per rank or
    None)."""
    hd = layers[0].attn.cfg.head_dim
    qkv = enter([lp.ln1(x) for x, lp in zip(xs, layers)],
                [(lp.attn.wq, lp.attn.wk, lp.attn.wv) for lp in layers])
    theta = layers[0].attn.cfg.rope_theta
    if not isinstance(positions, list):
        positions = [positions] * len(layers)
    qs, ks, vs = [], [], []
    for (q, k, v), pos in zip(qkv, positions):
        qs.append(_rope(_split_heads(q, hd), pos, theta).contiguous())
        ks.append(_rope(_split_heads(k, hd), pos, theta).contiguous())
        vs.append(_split_heads(v, hd).contiguous())
    kvs = list(zip(ks, vs))
    outs = leave([_merge_heads(o) for o in attend(qs, ks, vs)],
                 [lp.attn.wo for lp in layers])
    xs = [x + o for x, o in zip(xs, outs)]
    hs = [lp.ln2(x) for x, lp in zip(xs, layers)]
    aux = None
    if moe_ffn is not None:
        ys, aux = moe_ffn(hs)
    elif isinstance(layers[0].ffn, MoEFeedForward):
        ys, aux = map(list, zip(*(lp.ffn(h) for h, lp in zip(hs, layers))))
    else:
        gate_up = (ffn_enter or enter)(
            hs, [(lp.ffn.w1, lp.ffn.w3) for lp in layers])
        mids = [torch.nn.functional.silu(g.float()).to(g.dtype) * u
                for g, u in gate_up]
        ys = (ffn_leave or leave)(mids, [lp.ffn.w2 for lp in layers])
    return [x + y for x, y in zip(xs, ys)], kvs, aux


class DecoderLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.ffn = (MoEFeedForward if cfg.n_experts else FeedForward)(
            cfg, device)

    def forward(self, x, positions, attend, sp=None):
        """One block on (B, S, D) (``block`` on this one layer).
        ``attend(q, k, v)`` maps the rope'd q/k/v to (B, Hq, S, hd);
        ``sp`` routes an MoE FFN's sequences whole over that sequence-
        parallel transport (``MoEFeedForward.forward``). Returns (x,
        (k, v), aux): aux is the MoE FFN's load-balancing loss, None for
        a dense FFN."""
        moe_ffn = None
        if sp is not None and isinstance(self.ffn, MoEFeedForward):
            def moe_ffn(hs):
                y, aux = self.ffn(hs[0], sp)
                return [y], [aux]
        xs, kvs, aux = block([self], [x], positions, each_rank(attend),
                             moe_ffn=moe_ffn)
        return xs[0], kvs[0], None if aux is None else aux[0]


class Transformer(nn.Module):
    """The whole model. Parameters are created uninitialized on
    ``device``; use ``init_params`` or ``models.weights.params_from_jax``
    to fill them."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=dt, device=device)
        )
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.n_layers)
        )
        self.ln_f = RMSNorm(cfg.d_model, dt, device)

    # The serving programs' view of a model, which
    # ``models/tp_serving.ShardedModel`` (tensor-parallel serving) shares:
    # the tp size, the ranks this process holds, the K/V heads its caches
    # hold, the sum that leaves a row-parallel product and the MoE FFN
    # across ranks.
    tp = 1

    @property
    def device(self):
        return self.embed.device

    @property
    def ranks(self):
        return [self]

    @property
    def kv_heads(self):
        return self.cfg.n_kv_heads

    def leave(self, xs, ws):
        return dense_sums(xs, ws)

    def moe_ffn(self, layers):
        """``block``'s ``moe_ffn`` for ``layers``: None, each layer runs
        its own (whole) FFN."""
        return None


def init_params(cfg, device="cuda", seed=0):
    """A Transformer with random weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: the JAX ``init_params``
    distributions and scales (normal * fan_in ** -0.5, embed * 0.02,
    norms ones; an MoE FFN's router, w1 and w2 each by its fan in), drawn
    in f32 and cast, one tensor at a time — an 8B model is never built on
    the host. The numbers differ from
    ``jax.random``'s; tests bridge JAX's own weights instead."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device)

    def fill(p, scale):
        p.copy_(
            torch.randn(p.shape, generator=gen, device=device) * scale
        )

    with torch.no_grad():
        fill(model.embed, 0.02)
        for layer in model.layers:
            for w in (layer.attn.wq, layer.attn.wk, layer.attn.wv,
                      layer.attn.wo, *layer.ffn.parameters()):
                # (in, out), or (experts, in, out): the fan in is dim -2.
                fill(w, w.shape[-2] ** -0.5)
    return model


def axis_sizes(mesh):
    """A DeviceMesh's axis sizes by name (JAX's ``mesh.shape``); {} for
    no mesh."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names or (), mesh.mesh.shape))


def resolve_overlap(overlap, cfg, sizes, seq=None, batch=None,
                    attn_impl="flash"):
    """JAX's ``resolve_overlap``: the ``overlap`` switch ("auto" | "ring"
    | "off" | None → ``cfg.overlap``) resolved to the implementation that
    runs. ``sizes`` maps the mesh's axis names to sizes (``axis_sizes``,
    or a dict for ranks held in one process).

    "ring" needs a tp axis above 1, a dense FFN, no sp axis above 1 (the
    sp ring owns the sequence there), tp-divisible heads, d_ff and
    sequence, and a dp-divisible batch where dp shards it; anything else
    is the exact "off" path."""
    if overlap is None:
        overlap = cfg.overlap
    if overlap == "off":
        return "off"
    if overlap not in ("auto", "ring"):
        raise ValueError(f"unknown overlap mode {overlap!r}")
    n = (sizes or {}).get("tp", 1)
    if n <= 1 or cfg.n_experts:
        return "off"
    if sizes.get("sp", 1) > 1 or attn_impl == "ring":
        return "off"
    if cfg.n_heads % n or cfg.n_kv_heads % n or cfg.d_ff % n:
        return "off"
    if seq is None or seq % n:
        return "off"
    if batch is not None and batch % sizes.get("dp", 1):
        return "off"
    return "ring"


def _flash_attend(q, k, v):
    return flash_attention(q, k, v, causal=True)


def _plain_attend(q, k, v):
    out, _ = flash_fwd_reference(
        q, k, v, causal=True, sm_scale=1.0 / (q.shape[-1] ** 0.5)
    )
    return out


def _reference_attend(q, k, v):
    return mha_reference(q, k, v, causal=True)


ATTN_IMPLS = {"flash": _flash_attend, "plain": _plain_attend,
              "reference": _reference_attend}


def _ring_attend(sp, attn_impl):
    """Attention as a ring over the sequence-parallel transport ``sp``
    (``ring_attention.ring_attend`` of this process's rank): the flash
    ring for ``"flash"``, the plain block ring otherwise."""
    ring = ring_attention.ring_attend(
        sp, "flash" if attn_impl == "flash" else "plain")
    return lambda q, k, v: ring([q], [k], [v])[0]


def forward(model, tokens, positions=None, return_kv=False, logits_at=None,
            attn_impl="flash", remat=False, return_aux=False, mesh=None):
    """tokens: (B, S) int → logits (B, S, vocab) float32; differentiable.

    ``return_kv=True`` also returns the rope'd K/V stacks
    (L, B, Hkv, S, hd). ``logits_at`` restricts the head to one position:
    "last" for S - 1 or an int index; logits become (B, 1, vocab).
    ``attn_impl``: "flash" (the kernels on CUDA, their plain versions on
    the CPU), "plain" (the forward kernel's plain version on any device:
    the comparison the chip smoke makes for serving; not differentiable)
    or "reference" (``mha_reference``, the plain oracle, differentiable by
    autograd: the comparison for gradients). ``remat=True`` checkpoints
    each layer (its activations are recomputed in the backward pass).
    ``return_aux=True`` also returns the MoE aux loss averaged over the
    layers (an f32 0 for dense FFNs), last. ``mesh`` with an "sp" axis
    above 1: ``tokens`` is this rank's sequence shard, ``positions`` its
    global positions, and attention is the ring over that axis (the
    flash ring for "flash", the plain block ring otherwise), and an MoE
    FFN routes each sequence whole over that axis."""
    batch, seq = tokens.shape
    if positions is None:
        positions = torch.arange(seq, device=tokens.device).expand(batch, seq)
    sp = None
    attend = ATTN_IMPLS[attn_impl]
    if data_parallel.axis(mesh, "sp")[1] > 1:
        sp = ring_attention.P2P(ring_attention.ring_of(mesh, "sp"))
        attend = _ring_attend(sp, attn_impl)
    x = model.embed[tokens]
    ks, vs = [], []
    aux = None
    for layer in model.layers:
        if remat:
            x, (k, v), layer_aux = checkpoint(layer, x, positions, attend,
                                              sp, use_reentrant=False)
        else:
            x, (k, v), layer_aux = layer(x, positions, attend, sp)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux
        if return_kv:
            ks.append(k)
            vs.append(v)
    if logits_at is not None:
        # The norm is per position, so slicing before it is equivalent.
        idx = seq - 1 if isinstance(logits_at, str) else int(logits_at)
        x = x[:, idx:idx + 1]
    logits = lm_head(x, model.ln_f.weight, model.embed)
    out = (logits,)
    if return_kv:
        out += ((torch.stack(ks), torch.stack(vs)),)
    if return_aux:
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        out += (aux / max(model.cfg.n_layers, 1),)
    return out if len(out) > 1 else logits


def lm_head(x, ln_f, embed):
    """Final norm + tied output head: (B, S, D) → f32 logits."""
    return (_rms_norm(x, ln_f) @ embed.T).float()


# -- training ------------------------------------------------------------------

def softmax_xent(logits, targets):
    """Mean cross entropy as logsumexp − target logit (one reduction over
    the (B, S, V) logits, no materialized log-softmax)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - tgt).mean()


def loss_fn(model, batch, attn_impl="flash", remat=False, mesh=None):
    """Next-token cross entropy (+ ``moe_aux_weight`` × the MoE
    load-balance aux when the config has experts); batch = {"tokens":
    (B, S+1)} (a tensor or an integer array, moved to the model's
    device).

    ``mesh``: the batch is the GLOBAL one and this rank takes its rows
    (dp) and positions (sp) of ``inputs = tokens[:, :-1]`` and
    ``targets = tokens[:, 1:]`` (a shard's last target is the next
    shard's first input, so no token crosses ranks). The result is this
    rank's share of the global loss, its mean cross entropy scaled by its
    tokens over the global count: the ranks' shares sum to the global
    mean. A config with experts routes per sequence (JAX's ``vmap`` over
    the rows), so its aux is a mean of per-row terms and splits over dp
    shards as the cross entropy does. Over an sp axis each sequence is
    routed whole across its sp ranks (``moe.moe_ffn_parallel``), every
    sp rank holding the whole sequence's aux: scaled by the rank's share
    and summed over sp, each sequence's aux counts once, and the sum of
    the router probabilities over sp, whose backward sums the ranks'
    cotangents, brings it to each rank's router once."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    positions = None
    if mesh is not None:
        global_tokens = inputs.numel()
        seq = inputs.shape[1]
        sp_index, sp = data_parallel.axis(mesh, "sp")
        if seq % sp:
            raise ValueError(f"sequence length {seq} must divide by sp={sp}")
        local = seq // sp
        cols = slice(sp_index * local, (sp_index + 1) * local)
        inputs = data_parallel.shard_rows(inputs, mesh)[:, cols]
        targets = data_parallel.shard_rows(targets, mesh)[:, cols]
        positions = (sp_index * local + torch.arange(
            local, device=inputs.device)).expand(inputs.shape[0], local)
    logits, aux = forward(model, inputs, positions=positions,
                          attn_impl=attn_impl, remat=remat, mesh=mesh,
                          return_aux=True)
    loss = softmax_xent(logits, targets)
    if model.cfg.n_experts:
        loss = loss + model.cfg.moe_aux_weight * aux
    if mesh is None:
        return loss
    return loss * (targets.numel() / global_tokens)


def adamw(params):
    """optax ``adamw(3e-4, weight_decay=0.01)``: decoupled decay on every
    parameter, moments in the parameter dtype."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def _require_dense(model):
    """Training keeps bf16 (as in JAX): an int8 model's layer matrices are
    buffers no optimizer would update, so training one is refused."""
    if model_is_quantized(model):
        raise ValueError(
            "training needs dense weights: this model's layer matrices are "
            "int8 (quantize_params), which serve only")


def make_train_step(cfg, optimizer=None, remat=True, device="cuda",
                    mesh=None, overlap=None):
    """Returns (init_state, train_step). State = (model, optimizer).

    ``optimizer`` maps the parameters to a ``torch.optim.Optimizer``
    (default ``adamw``). ``remat=True`` checkpoints every layer, the
    counterpart of ``jax.checkpoint`` around the JAX loss: the numbers are
    the same, and the forward attention kernel launches twice per layer
    and step. ``init_state(seed)`` draws random weights on ``device``;
    ``init_state(model=m)`` starts from given ones (e.g. bridged from
    JAX). ``mesh`` (a DeviceMesh with "dp" and "sp" axes): each step
    takes the GLOBAL batch, runs this rank's shard (``loss_fn``) and sums
    the gradients and the loss over the data axes after ``backward()``
    (``parallel/data_parallel.train_step``); every rank must hold the
    same parameters, as the same seed gives them. A mesh with a "tp" or
    "ep" axis above 1 runs ``models/tp_lm.make_train_step`` on this
    rank's shards (state = (the shards, the optimizer)); ``overlap``
    (None → ``cfg.overlap``) picks its ring or off path."""
    sizes = axis_sizes(mesh)
    if sizes.get("tp", 1) > 1 or sizes.get("ep", 1) > 1:
        from container_engine_accelerators_tpu_torch.models import tp_lm

        return tp_lm.make_train_step(
            cfg, tensor_parallel.Axes.of_mesh(mesh), mesh=mesh,
            optimizer=optimizer, remat=remat, device=device, overlap=overlap)
    device = resolve_device(device)
    make_optimizer = optimizer or adamw

    def init_state(seed=0, model=None):
        if model is None:
            model = init_params(cfg, device=device, seed=seed)
        _require_dense(model)
        return model, make_optimizer(model.parameters())

    def train_step(state, batch):
        """One step; returns (state, loss). The update is in place on the
        parameters and the optimizer's moments, the counterpart of the JAX
        step's donated state (no copy of either per step)."""
        model, opt = state
        _require_dense(model)
        loss = data_parallel.train_step(
            model, opt, lambda: loss_fn(model, batch, remat=remat, mesh=mesh),
            mesh)
        return state, loss

    return init_state, train_step


# -- serving (KV-cache decode) ------------------------------------------------

def init_kv_cache(cfg, batch, device, kv_heads=None):
    """A zeroed dense cache {"k", "v"}: (L, batch, Hkv, S, hd), with
    ``kv_heads`` heads (default the config's; a tensor-parallel model's
    are the heads of the ranks it holds, ``model.kv_heads``)."""
    hkv = cfg.n_kv_heads if kv_heads is None else kv_heads
    hd = cfg.head_dim
    shape = (cfg.n_layers, batch, hkv, cfg.max_seq_len, hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
    }


def _length_bucket(n, cap):
    """Smallest power of two ≥ n (min 16), capped at the context length."""
    bucket = max(16, 1 << (n - 1).bit_length())
    return min(bucket, cap)


def _window_for(position_bound, cap):
    """Attended-window size for a decode step: the power-of-two bucket of
    the largest position it reaches, capped at the context length."""
    return _length_bucket(max(int(position_bound), 1), cap)


def serving_shape_buckets(cfg, prefill_chunk, decode_chunk,
                          block_size=None, speculate_widths=None):
    """The static shape grid a serving engine can dispatch, the port of
    the JAX ``serving_shape_buckets``: what warmup enumerates
    (``warmstart/warmup.py``).

    Returns ``{"prefill": [length buckets], "segment_windows":
    [chunked-prefill windows], "windows": [decode windows],
    "decode_steps": [chunk step counts]}``, each a sorted list of the
    power-of-two buckets ``_length_bucket``/``_window_for`` produce, so
    warmup and dispatch cannot drift apart.

    ``block_size`` (a paged engine's block size) adds ``"paged_prefill"``:
    the sorted ``[segment, window]`` pairs the paged segment prefill can
    dispatch. A segment may start at any block-aligned reused-prefix
    offset, so every window >= the segment is reachable.

    ``speculate_widths`` (a speculating engine's verify widths) adds
    ``"verify"``: the sorted ``[width, window]`` pairs of the verify step,
    every window >= the width (a verify starts at any decode position)."""
    S = cfg.max_seq_len
    # Single-shot buckets: the 16-token floor and the context cap belong
    # to dispatch; prompts longer than prefill_chunk go chunked.
    prefill_max = _length_bucket(min(prefill_chunk, S), S)
    prefill = sorted({_length_bucket(1, S)} | {
        b for b in (16 << i for i in range(S.bit_length()))
        if b <= prefill_max
    })
    windows = sorted({
        _window_for(p, S)
        for p in [1, S] + [16 << i for i in range(S.bit_length())
                           if (16 << i) <= S]
    })
    segment_windows = sorted({
        _window_for(min(off + prefill_chunk, S), S)
        for off in range(0, S, max(prefill_chunk, 1))
    }) if prefill_chunk < S else []
    steps = [1 << i for i in range(max(decode_chunk, 1).bit_length())
             if (1 << i) <= decode_chunk]
    out = {
        "prefill": prefill,
        "segment_windows": segment_windows,
        "windows": windows,
        "decode_steps": steps,
    }
    if block_size:
        out["paged_prefill"] = sorted(
            [c, w] for c in prefill for w in windows if w >= c
        )
    if speculate_widths:
        out["verify"] = sorted(
            [c, w]
            for c in sorted({_length_bucket(int(c), S)
                             for c in speculate_widths})
            for w in windows if w >= c
        )
    return out


def _heads(t, j, n):
    """Rank j's heads of a (B, H, ...) cache view holding the heads of n
    ranks: the K/V heads of rank j are the j-th of n equal runs (the
    column order of its wk/wv shard). One rank held: the whole view."""
    if n == 1:
        return t
    h = t.shape[1] // n
    return t[:, j * h:(j + 1) * h]


def _serve_stack(model, tokens, positions, attend_for):
    """The embedding and every layer of a serving program, on every rank
    ``model`` holds (``model.ranks``: the whole model, or its
    tensor-parallel shards, ``models/tp_serving.py``): ``tokens`` (B, S)
    at ``positions`` (B, S); ``attend_for(i, j, n)`` is layer i's
    ``attend`` for rank j of the n held, which writes the rank's K/V
    heads into the cache and reads them. Activations are replicated over
    tp, and the row-parallel products' partial sums all-reduced
    (``model.leave``; an MoE FFN's by ``model.moe_ffn``). → the (B, S, D)
    hidden states, equal on every rank."""
    ranks = model.ranks
    n = len(ranks)
    x = model.embed[tokens]
    xs = [x] * n
    for i in range(model.cfg.n_layers):
        layers = [r.layers[i] for r in ranks]
        xs, _, _ = block(layers, xs, positions,
                         each_rank([attend_for(i, j, n) for j in range(n)]),
                         leave=model.leave, moe_ffn=model.moe_ffn(layers))
    return xs[0]


def _decode_step(model, tokens, positions, attend_for):
    """One-token step through every layer, shared by the dense and the
    paged decode (the JAX ``_decode_step_impl``): tokens (B,) at
    positions (B, 1); ``attend_for(i, j, n)`` is layer i's ``attend`` for
    rank j of the n held (``_serve_stack``), which writes the step's K/V
    and reads the cache. → (B, V) f32 logits."""
    x = _serve_stack(model, tokens[:, None], positions, attend_for)
    return lm_head(x, model.ln_f.weight, model.embed)[:, 0, :]


def _prefill_forward(model, prompt, logits_at, overlap=None):
    """A prefill's forward → (logits (B, 1, V), (ks, vs) (L, B, Hkv, P,
    hd) with the heads the model's caches hold). A tensor-parallel model
    takes the ring collective matmuls where ``resolve_overlap`` allows
    (``overlap``, None → the config's), else the off path
    (``tp_serving.ShardedModel.prefill_forward``), as JAX's ``prefill``
    and ``prefill_into_slot`` with a mesh do."""
    if model.tp == 1:
        return forward(model, prompt, return_kv=True, logits_at=logits_at)
    return model.prefill_forward(prompt, logits_at, overlap=overlap)


@torch.inference_mode()
def decode_logits(model, cache, tokens, position, window=None):
    """One decode step at the shared ``position`` → (B, V) logits.

    ``position`` is a Python int, or a device scalar (a one-element int64
    tensor, read only on the device: the form a captured graph replays);
    with a tensor, the attended ``window`` must be given, else it is
    ``_window_for(position + 1)``. JAX is functional and returns a new
    cache; here the step writes its K/V into ``cache`` IN PLACE at slot
    ``position`` (``index_copy_`` along the sequence axis), then attends
    to [0, window) of the cache with length position + 1."""
    batch = tokens.shape[0]
    if window is None:
        if torch.is_tensor(position):
            raise ValueError("a device position needs its window")
        window = _window_for(position + 1, model.cfg.max_seq_len)
    if torch.is_tensor(position):
        position = position.reshape(1)
    else:
        # A fill, not a host-to-device copy: nothing waits for the stream.
        position = torch.full((1,), position, dtype=torch.long,
                              device=tokens.device)
    positions = position.view(1, 1).expand(batch, 1)

    def attend_for(i, j, n):
        k_cache = _heads(cache["k"][i], j, n)
        v_cache = _heads(cache["v"][i], j, n)

        def attend(q, k, v):
            k_cache.index_copy_(2, position, k)
            v_cache.index_copy_(2, position, v)
            return decode_attention(
                q, k_cache[:, :, :window], v_cache[:, :, :window],
                position + 1,
            )

        return attend

    return _decode_step(model, tokens, positions, attend_for)


@torch.inference_mode()
def prefill(model, prompt, true_len=None, return_logits=False, cache=None,
            overlap=None):
    """Single-pass batched prefill: one forward over the whole (B, P)
    prompt; each layer's K/V land in ``cache`` (a fresh one by default)
    at [0, P). With a right-padded (bucketed) prompt, ``true_len`` is the
    real length and the next token reads from position true_len - 1;
    decode overwrites slot p before any query attends it. Entries of a
    reused cache past P keep an earlier request's (finite) K/V, which
    the decode's length mask removes. A tensor-parallel model takes the
    ring path where ``overlap`` allows (``_prefill_forward``). Returns
    (next_tokens, cache), or ((B, V) logits, cache) with
    ``return_logits``."""
    batch, prompt_len = prompt.shape
    logits, (ks, vs) = _prefill_forward(
        model, prompt, "last" if true_len is None else true_len - 1,
        overlap=overlap,
    )
    if cache is None:
        cache = init_kv_cache(model.cfg, batch, prompt.device,
                              model.kv_heads)
    cache["k"][:, :, :, :prompt_len] = ks
    cache["v"][:, :, :, :prompt_len] = vs
    if return_logits:
        return logits[:, -1, :], cache
    return logits[:, -1, :].argmax(dim=-1), cache


def sample_token(logits, generator, temperature=0.0, top_k=0, top_p=1.0):
    """One sampling step on (B, V) logits → (B,) token ids.

    ``temperature == 0`` is greedy argmax (first maximum, as in JAX).
    ``top_k > 0`` keeps the k highest logits; ``top_p < 1`` keeps the
    smallest set whose cumulative probability reaches top_p. Sampling is
    the Gumbel-max form of JAX's ``random.categorical`` with noise from
    ``generator``; the numbers differ from ``jax.random``'s for the same
    seed, so sampled tokens differ between the two packages (greedy ones
    do not)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        # First index where the cumulative mass reaches top_p: its logit
        # is the inclusive threshold (the top-1 always stays).
        cutoff = (cum < top_p).sum(dim=-1, keepdim=True)
        kth = torch.gather(sorted_desc, -1, cutoff)
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits + gumbel).argmax(dim=-1)


@torch.inference_mode()
def generate(model, prompt, max_new_tokens=16, temperature=0.0, top_k=0,
             top_p=1.0, generator=None, *, decoder):
    """Generation: greedy by default; ``temperature > 0`` samples (see
    sample_token) with noise from ``generator``. prompt: (B, P) int64 on
    the model's device → (B, P + max_new_tokens).

    The prompt is right-padded to its length bucket and prefilled once
    into ``decoder.cache(B)``, a dense cache for B rows; each decode step
    is ``decoder.step(tokens, position)`` → (B, V) logits, and sampling
    runs after it. The serving decoder is
    ``serving_graphs.DenseDecodeGraphs(model)`` (on CUDA the replay of
    the step's graph for its (B, window), captured at its first use; on
    the CPU the same step run eagerly); a caller that serves many
    requests keeps one (``serve_cli.Model`` does)."""
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_seq_len ({cfg.max_seq_len})"
        )
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    bucket = _length_bucket(prompt_len, cfg.max_seq_len)
    padded = torch.nn.functional.pad(prompt, (0, bucket - prompt_len))
    logits, _ = prefill(model, padded, true_len=prompt_len,
                        return_logits=True, cache=decoder.cache(batch))
    pieces = [prompt]
    for step in range(max_new_tokens):
        if step:
            logits = decoder.step(tok, prompt_len + step - 1)
        tok = sample_token(logits, generator, temperature, top_k, top_p)
        pieces.append(tok[:, None])
    return torch.cat(pieces, dim=1)


# -- dense continuous-batching programs ---------------------------------------
#
# The slot-based engine on a dense cache (L, slots, Hkv, S, hd): every slot
# owns one cache row, requests prefill into a free row and decode together
# at per-row positions. Every function writes the cache IN PLACE and reads
# nothing of the device back to the host, so the decode step can be
# captured in a CUDA graph (``serving_graphs.DenseChunkGraphs``).


def _row_update(cache, new, positions, active=None):
    """Per-row cache write, the JAX ``_row_update``: cache (B, H, S, hd) ←
    new (B, H, 1, hd) at slot ``positions[b]`` of row b, in place.

    ``active`` (B,) bool masks the write per row: an inactive row writes
    the value already at its slot back (a gather, then ``where``), so a
    row mid-chunked-prefill can sit inactive in a decode chunk and keep
    its cache bit for bit."""
    batch, heads, _, hd = cache.shape
    idx = positions.view(batch, 1, 1, 1).expand(batch, heads, 1, hd)
    new = new.to(cache.dtype)
    if active is not None:
        old = torch.gather(cache, 2, idx)
        new = torch.where(active.view(batch, 1, 1, 1), new, old)
    cache.scatter_(2, idx, new)


@torch.inference_mode()
def decode_logits_multi(model, cache, tokens, positions, active=None,
                        window=None):
    """One decode step with PER-ROW positions, the continuous-batching
    step (the JAX ``decode_logits_multi``): tokens and positions (B,)
    int64 on the device. Row b writes its K/V at ``positions[b]`` of its
    own cache row (``_row_update``, masked by ``active``) and attends
    [0, positions[b] + 1) of it, reading the view ``cache[..., :window,
    :]`` (default: the whole context). JAX hands in a window copy of the
    cache and writes it back after the chunk; here the writes land in
    place, so neither copy exists. → (B, V) f32 logits."""
    if window is None:
        window = cache["k"].shape[3]

    def attend_for(i, j, n):
        k_cache = _heads(cache["k"][i], j, n)
        v_cache = _heads(cache["v"][i], j, n)

        def attend(q, k, v):
            _row_update(k_cache, k, positions, active)
            _row_update(v_cache, v, positions, active)
            return decode_attention(
                q, k_cache[:, :, :window], v_cache[:, :, :window],
                positions + 1,
            )

        return attend

    return _decode_step(model, tokens, positions[:, None], attend_for)


def dense_decode_step(model, cache, tokens, positions, active, window,
                      mask_writes=False):
    """One greedy step of ``decode_chunk`` (one iteration of the JAX
    chunk's ``scan`` body) → ((B, V) f32 logits, next tokens, next
    positions). Positions clamp to ``window - 1``; inactive rows keep
    their token and position, and with ``mask_writes`` their cache too.
    Reads nothing back to the host."""
    safe = positions.clamp(max=window - 1)
    logits = decode_logits_multi(
        model, cache, tokens, safe, active=active if mask_writes else None,
        window=window,
    )
    nxt = torch.where(active, logits.argmax(dim=-1), tokens)
    return logits, nxt, torch.where(active, positions + 1, positions)


@torch.inference_mode()
def decode_chunk(model, cache, tokens, positions, active, steps, window=None,
                 mask_writes=False):
    """``steps`` greedy continuous-batching steps over a dense cache, the
    counterpart of the JAX ``decode_chunk``.

    cache {"k", "v"}: (L, B, Hkv, S, hd), written IN PLACE; tokens and
    positions (B,) int64, active (B,) bool, on the model's device.
    ``window`` (default: the context) bounds every step's attended read;
    callers keep window > position + steps for every active row.
    ``mask_writes`` masks inactive rows' cache writes: required while a
    row is mid-chunked-prefill (an unmasked write would land inside its
    prefilled span), skipped otherwise (a free slot's position is 0, and
    its next occupant's prefill overwrites it before anything attends).
    JAX fuses the steps in one ``scan``; this is the eager loop of
    ``dense_decode_step``, which the engine replays as one captured graph
    per (window, mask_writes) instead (``serving_graphs.DenseChunkGraphs``).
    Returns (tokens (steps, B), last_tok (B,), positions (B,))."""
    if window is None:
        window = model.cfg.max_seq_len
    tok, pos, out = tokens, positions, []
    for _ in range(steps):
        _, tok, pos = dense_decode_step(model, cache, tok, pos, active,
                                        window, mask_writes)
        out.append(tok)
    return torch.stack(out), tok, pos


@torch.inference_mode()
def prefill_into_slot(model, cache, prompt, true_len, slot, overlap=None):
    """Prefill ONE request into cache row ``slot``, the counterpart of the
    JAX ``prefill_into_slot``: prompt (1, P) right-padded to a length
    bucket, the real tokens ending at ``true_len``. One forward through
    the flash kernel (``_prefill_forward``: on a tensor-parallel model
    the ring path where ``overlap`` allows, as JAX's with a mesh); the
    K/V land at cache[:, slot, :, :P] and every other row is left as it
    was, bit for bit. Returns the greedy first token as a 0-d tensor on
    the device."""
    batch, prompt_len = prompt.shape
    if batch != 1:
        raise ValueError(f"one request per slot, got batch {batch}")
    logits, (ks, vs) = _prefill_forward(model, prompt, true_len - 1,
                                        overlap=overlap)
    cache["k"][:, slot, :, :prompt_len] = ks[:, 0]
    cache["v"][:, slot, :, :prompt_len] = vs[:, 0]
    return logits[0, 0].argmax()


@torch.inference_mode()
def prefill_chunk_into_slot(model, cache, seg, offset, slot, true_pos, window,
                            want_logits=False, return_logits=False):
    """One segment of an incremental prefill into cache row ``slot``, the
    counterpart of the JAX ``prefill_chunk_into_slot``.

    seg: (1, C) tokens at global positions [offset, offset + C), the last
    segment right-padded. Each layer writes the segment's K/V at
    cache[i][slot, :, offset:offset + C], then runs
    ``ops.attention.flash_fwd`` causal at global positions (``q_base=
    offset``, ``k_base=0``) over the slot's cache [0, ``window``): the
    CUDA kernel on CUDA tensors, its plain version on CPU ones. The
    kernel takes contiguous tensors, and a window slice of a row is not
    one; the whole row (1, Hkv, S, hd) is, so it goes in with ``kv_len=
    window``. Keys past offset + C are masked causally either way, and
    the kernel's causal walk stops at the last row's diagonal, so it
    reads what the window holds and copies nothing. ``window`` is a
    power of two or a multiple of 128, at least C (JAX's rule; the
    kernel tiles for itself, so JAX's choice of block size has no
    counterpart).

    ``want_logits`` (the final segment): returns the greedy token read at
    global position ``true_pos`` as a 0-d tensor (with ``return_logits``,
    as (token, (V,) f32 logits)); earlier segments return None."""
    batch, seg_len = seg.shape
    if batch != 1:
        raise ValueError(f"one request per slot, got batch {batch}")
    if window < seg_len or (window % 128 and window & (window - 1)):
        raise ValueError(
            f"window ({window}) must be a power of two or 128-multiple "
            f">= segment ({seg_len})"
        )
    hd = model.cfg.head_dim
    positions = offset + torch.arange(seg_len, device=seg.device)[None, :]

    def attend_for(i, j, n):
        # One slot's rank-j heads: contiguous, as the kernel takes them.
        k_row = _heads(cache["k"][i][slot:slot + 1], j, n)
        v_row = _heads(cache["v"][i][slot:slot + 1], j, n)

        def attend(q, k, v):
            k_row[:, :, offset:offset + seg_len] = k
            v_row[:, :, offset:offset + seg_len] = v
            out, _ = flash_fwd(
                q, k_row, v_row, causal=True, sm_scale=1.0 / (hd ** 0.5),
                q_base=offset, k_base=0, kv_len=window,
            )
            return out

        return attend

    x = _serve_stack(model, seg, positions, attend_for)
    if not want_logits:
        return None
    idx = true_pos - offset
    logits = lm_head(x[:, idx:idx + 1], model.ln_f.weight, model.embed)[0, 0]
    tok = logits.argmax()
    return (tok, logits) if return_logits else tok


# -- paged (block-pool) serving programs --------------------------------------
#
# The device half of the kvcache subpackage: the same layers and the same
# attention functions as the dense paths, with the cache reads and writes
# swapped for block gathers and scatters (ops/paged_attention.py). Page
# tables, the radix prefix index, eviction and copy-on-write live on the
# host (kvcache/manager.py); these functions only consume its tables.
# Both update the pools they are given in place and read nothing of the
# device back to the host, so the engine can queue them behind each other.


def paged_decode_step(model, pools, tables, tokens, positions, active,
                      window, block_size):
    """One greedy step of ``paged_decode_chunk`` (one iteration of the
    JAX chunk's ``scan`` body) → ((B, V) f32 logits, next tokens, next
    positions). Writes its K/V into ``pools`` in place and reads nothing
    of the device back to the host, so it can be captured in a CUDA graph
    (``serving_graphs.PagedDecodeGraphs``)."""
    safe = positions.clamp(max=window - 1)
    bids = torch.gather(tables, 1, (safe // block_size)[:, None])[:, 0]
    bids = torch.where(active, bids, pa.NULL_BLOCK)
    offs = safe % block_size

    def attend_for(i, j, n):
        k_pool = _heads(pools["k"][i], j, n)
        v_pool = _heads(pools["v"][i], j, n)

        def attend(q, k, v):
            pa.paged_write(k_pool, k, bids, offs)
            pa.paged_write(v_pool, v, bids, offs)
            return pa.paged_decode_attention(
                q, k_pool, v_pool, tables, safe + 1, window, block_size,
            )

        return attend

    logits = _decode_step(model, tokens, safe[:, None], attend_for)
    nxt = torch.where(active, logits.argmax(dim=-1), tokens)
    return logits, nxt, torch.where(active, positions + 1, positions)


@torch.inference_mode()
def paged_decode_chunk(model, pools, tables, tokens, positions, active,
                       steps, window, block_size):
    """``steps`` greedy decode steps over a paged cache, the counterpart
    of the JAX ``paged_decode_chunk``.

    pools {"k", "v"}: (L, num_blocks, Hkv, bs, hd), written IN PLACE;
    tables (B, T) int64 page tables; tokens and positions (B,) int64,
    active (B,) bool, all on the model's device; ``window`` (a multiple
    of ``block_size``) bounds every step's gathered read. Each step
    clamps the positions to ``window - 1``; row b writes its K/V at block
    ``tables[b, pos // bs]`` (the null block for inactive rows), offset
    ``pos % bs``, and attends its own pages [0, window) with length
    pos + 1 through ``paged_decode_attention`` (the dense
    ``decode_attention`` on the gathered window). Inactive rows keep
    their token and position. JAX fuses the steps in one ``scan``; this
    is the eager loop of ``paged_decode_step``, which the serving engine
    replays as one captured graph per window instead
    (``serving_graphs.PagedDecodeGraphs``). Returns (tokens (steps, B),
    last_tok (B,), positions (B,))."""
    tok, pos, out = tokens, positions, []
    for _ in range(steps):
        _, tok, pos = paged_decode_step(model, pools, tables, tok, pos,
                                        active, window, block_size)
        out.append(tok)
    return torch.stack(out), tok, pos


@torch.inference_mode()
def paged_prefill_segment(model, pools, seg, offset, seg_ids, table_row,
                          true_pos, last_tok, slot, window, block_size,
                          want_logits=False, return_logits=False):
    """One prefill segment into a slot's paged blocks, the counterpart of
    the JAX ``paged_prefill_segment`` and the only prefill of the paged
    engine: every admission prefills in segments, the first at the
    radix-reused prefix length (a block multiple).

    seg: (1, C) int64 tokens at global positions [offset, offset + C), the
    last segment right-padded to its bucket C. ``seg_ids`` (C // bs,) are
    the blocks the segment writes (the null block for padding past the
    context end); ``table_row`` (T,) is the slot's page table. Each layer
    writes the segment's K/V with ``paged_write_segment``, gathers the
    slot's pages [0, window) into one contiguous (1, Hkv, window, hd)
    window and runs ``ops.attention.flash_fwd`` on it, causal at global
    positions (``q_base=offset``, ``k_base=0``): the CUDA kernel on CUDA
    tensors, its plain version on CPU ones. ``window`` is a power of two
    or a multiple of 128, at least C and a multiple of ``block_size``.

    ``want_logits`` (the final segment): the greedy token read at
    ``true_pos`` is written into ``last_tok[slot]`` on the device and
    returned as a 0-d tensor (with ``return_logits``, as (token, (V,) f32
    logits)); earlier segments return None. The pools are written in
    place."""
    batch, seg_len = seg.shape
    if batch != 1:
        raise ValueError(f"one request per slot, got batch {batch}")
    if window < seg_len or (window % 128 and window & (window - 1)):
        raise ValueError(
            f"window ({window}) must be a power of two or 128-multiple "
            f">= segment ({seg_len})"
        )
    if seg_len % block_size or window % block_size:
        raise ValueError(
            f"segment ({seg_len}) and window ({window}) must be multiples "
            f"of block_size ({block_size})"
        )
    hd = model.cfg.head_dim
    n_win = window // block_size
    tables = table_row[None, :]
    positions = offset + torch.arange(seg_len, device=seg.device)[None, :]

    def attend_for(i, j, n):
        k_pool = _heads(pools["k"][i], j, n)
        v_pool = _heads(pools["v"][i], j, n)

        def attend(q, k, v):
            pa.paged_write_segment(k_pool, k, seg_ids)
            pa.paged_write_segment(v_pool, v, seg_ids)
            k_win = pa.gather_block_kv(k_pool, tables, n_win)
            v_win = pa.gather_block_kv(v_pool, tables, n_win)
            out, _ = flash_fwd(
                q, k_win.to(q.dtype), v_win.to(q.dtype), causal=True,
                sm_scale=1.0 / (hd ** 0.5), q_base=offset, k_base=0,
            )
            return out

        return attend

    x = _serve_stack(model, seg, positions, attend_for)
    if not want_logits:
        return None
    idx = true_pos - offset
    logits = lm_head(x[:, idx:idx + 1], model.ln_f.weight, model.embed)[0, 0]
    tok = logits.argmax()
    last_tok[slot] = tok
    return (tok, logits) if return_logits else tok


@torch.inference_mode()
def paged_verify_batch(model, pools, segs, poss, block_ids, offsets, tables,
                       window, block_size, return_logits=False):
    """Score many rows' speculative proposal windows in one call, the
    counterpart of the JAX ``paged_verify_batch``.

    segs: (B, W) int64, row b's [current token, proposals, padding] at
    global positions [poss[b], poss[b] + W); poss (B,), block_ids and
    offsets (B, W) (per-position write targets, ``NULL_BLOCK`` for
    padding), tables (B, T) page tables, all on the model's device.
    Padding rows carry null targets and all-null tables: they write only
    the null block and their outputs are never read. Each layer writes
    the rows' K/V with ``paged_write_positions``, gathers each row's own
    pages [0, window) and runs ``flash_fwd`` causal at the per-row
    bases ``[poss[b], 0, window]``, a (B, 3) device tensor: nothing is
    read back to the host, so the call can be captured in a CUDA graph
    (``serving_graphs.PagedVerifyGraphs``) that replays at new positions.
    ``window`` must cover every row's [0, poss[b] + W).

    JAX runs the rows as a ``lax.scan`` of the one-row program; here they
    run as one batch. Rows write disjoint blocks (and the null block,
    whose garbage every reader masks), so per row the arithmetic is the
    same up to summation order. Returns the greedy (B, W) int64 tokens,
    ``greedy[b, i]`` the argmax after ``segs[b, i]`` (with
    ``return_logits``, also the (B, W, V) f32 logits). The pools are
    written in place."""
    batch, width = segs.shape
    if window < width or (window % 128 and window & (window - 1)):
        raise ValueError(
            f"window ({window}) must be a power of two or 128-multiple "
            f">= verify width ({width})"
        )
    if window % block_size:
        raise ValueError(
            f"window ({window}) must be a multiple of block_size "
            f"({block_size})"
        )
    if width & (width - 1):
        raise ValueError(f"verify width ({width}) must be a power of two")
    hd = model.cfg.head_dim
    n_win = window // block_size
    device = segs.device
    positions = poss[:, None] + torch.arange(width, device=device)[None, :]
    base = torch.stack([
        poss, torch.zeros_like(poss), torch.full_like(poss, window),
    ], dim=1).to(torch.int32)

    def attend_for(i, j, n):
        k_pool = _heads(pools["k"][i], j, n)
        v_pool = _heads(pools["v"][i], j, n)

        def attend(q, k, v):
            pa.paged_write_positions(k_pool, k, block_ids, offsets)
            pa.paged_write_positions(v_pool, v, block_ids, offsets)
            k_win = pa.gather_block_kv(k_pool, tables, n_win)
            v_win = pa.gather_block_kv(v_pool, tables, n_win)
            out, _ = flash_fwd(
                q, k_win.to(q.dtype), v_win.to(q.dtype), causal=True,
                sm_scale=1.0 / (hd ** 0.5), base=base,
            )
            return out

        return attend

    x = _serve_stack(model, segs, positions, attend_for)
    logits = lm_head(x, model.ln_f.weight, model.embed)
    greedy = logits.argmax(dim=-1)
    return (greedy, logits) if return_logits else greedy


def paged_verify_chunk(model, pools, seg, pos, block_ids, offsets,
                       table_row, window, block_size):
    """One row's verify, the counterpart of the JAX ``paged_verify_chunk``:
    seg (1, W) at global positions [pos, pos + W), block_ids and offsets
    (W,), table_row (T,); ``pos`` an int or a 0-d device tensor. The
    one-row ``paged_verify_batch``. Returns the greedy (W,) tokens; the
    pools are written in place."""
    batch = seg.shape[0]
    if batch != 1:
        raise ValueError(f"one row per verify call, got batch {batch}")
    poss = torch.as_tensor(pos, dtype=torch.long, device=seg.device)
    return paged_verify_batch(
        model, pools, seg, poss.reshape(1), block_ids[None], offsets[None],
        table_row[None], window, block_size,
    )[0]
