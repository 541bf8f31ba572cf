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
under ``torch.inference_mode()``.

Not in this port yet: MoE FFNs, tensor/sequence/pipeline parallelism
and ring attention (see ROADMAP.md).
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

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    # Mixture-of-experts FFNs are not ported yet; n_experts > 0 raises.
    n_experts: int = 0

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

    def qkv(self, h, positions):
        """(B, S, D) → rope'd q (B, Hq, S, hd), rope'd k and v
        (B, Hkv, S, hd), contiguous (the kernel's layout)."""
        cfg = self.cfg
        batch, seq, _ = h.shape
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = _mm(h, self.wq).view(batch, seq, hq, hd).transpose(1, 2)
        k = _mm(h, self.wk).view(batch, seq, hkv, hd).transpose(1, 2)
        v = _mm(h, self.wv).view(batch, seq, hkv, hd).transpose(1, 2)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def out(self, attn):
        """(B, Hq, S, hd) → (B, S, D) residual update."""
        batch, _, seq, _ = attn.shape
        return _mm(attn.transpose(1, 2).reshape(batch, seq, -1), self.wo)


class FeedForward(nn.Module):
    """Dense SwiGLU; SiLU runs in f32 and casts back before gate * up."""

    def __init__(self, cfg, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.w1 = _weight(d, f, dt, device)
        self.w3 = _weight(d, f, dt, device)
        self.w2 = _weight(f, d, dt, device)

    def forward(self, h):
        gate = torch.nn.functional.silu(_mm(h, self.w1).float()).to(h.dtype)
        return _mm(gate * _mm(h, self.w3), self.w2)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.ln1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, dt, device)
        self.ffn = FeedForward(cfg, device)

    def forward(self, x, positions, attend):
        """One block on (B, S, D). ``attend(q, k, v)`` maps the rope'd
        q/k/v to (B, Hq, S, hd); returns (x, (k, v))."""
        q, k, v = self.attn.qkv(self.ln1(x), positions)
        x = x + self.attn.out(attend(q, k, v))
        return x + self.ffn(self.ln2(x)), (k, v)


class Transformer(nn.Module):
    """The whole model. Parameters are created uninitialized on
    ``device``; use ``init_params`` or ``models.weights.params_from_jax``
    to fill them."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError(
                "MoE FFNs (n_experts > 0) are not ported yet; they belong "
                "to a later slice of the port (ROADMAP.md)"
            )
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=dt, device=device)
        )
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.n_layers)
        )
        self.ln_f = RMSNorm(cfg.d_model, dt, device)

    @property
    def device(self):
        return self.embed.device


def init_params(cfg, device="cuda", seed=0):
    """A Transformer with random weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: the JAX ``init_params``
    distributions and scales (normal * fan_in ** -0.5, embed * 0.02,
    norms ones), drawn in f32 and cast, one tensor at a time — an 8B
    model is never built on the host. The numbers differ from
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
                      layer.attn.wo, layer.ffn.w1, layer.ffn.w3,
                      layer.ffn.w2):
                fill(w, w.shape[0] ** -0.5)
    return model


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


def forward(model, tokens, positions=None, return_kv=False, logits_at=None,
            attn_impl="flash", remat=False):
    """tokens: (B, S) int → logits (B, S, vocab) float32; differentiable.

    ``return_kv=True`` also returns the rope'd K/V stacks
    (L, B, Hkv, S, hd). ``logits_at`` restricts the head to one position:
    "last" for S - 1 or an int index; logits become (B, 1, vocab).
    ``attn_impl``: "flash" (the kernels on CUDA, their plain versions on
    the CPU), "plain" (the forward kernel's plain version on any device:
    the comparison the chip smoke makes for serving; not differentiable)
    or "reference" (``mha_reference``, the plain oracle, differentiable by
    autograd: the comparison for gradients). ``remat=True`` checkpoints
    each layer (its activations are recomputed in the backward pass)."""
    batch, seq = tokens.shape
    if positions is None:
        positions = torch.arange(seq, device=tokens.device).expand(batch, seq)
    attend = ATTN_IMPLS[attn_impl]
    x = model.embed[tokens]
    ks, vs = [], []
    for layer in model.layers:
        if remat:
            x, (k, v) = checkpoint(layer, x, positions, attend,
                                   use_reentrant=False)
        else:
            x, (k, v) = layer(x, positions, attend)
        if return_kv:
            ks.append(k)
            vs.append(v)
    if logits_at is not None:
        # The norm is per position, so slicing before it is equivalent.
        idx = seq - 1 if isinstance(logits_at, str) else int(logits_at)
        x = x[:, idx:idx + 1]
    logits = lm_head(x, model.ln_f.weight, model.embed)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


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


def loss_fn(model, batch, attn_impl="flash", remat=False):
    """Next-token cross entropy; batch = {"tokens": (B, S+1)} (a tensor or
    an integer array, moved to the model's device)."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = forward(model, inputs, attn_impl=attn_impl, remat=remat)
    return softmax_xent(logits, targets)


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


def make_train_step(cfg, optimizer=None, remat=True, device="cuda"):
    """Returns (init_state, train_step). State = (model, optimizer).

    ``optimizer`` maps the parameters to a ``torch.optim.Optimizer``
    (default ``adamw``). ``remat=True`` checkpoints every layer, the
    counterpart of ``jax.checkpoint`` around the JAX loss: the numbers are
    the same, and the forward attention kernel launches twice per layer
    and step. ``init_state(seed)`` draws random weights on ``device``;
    ``init_state(model=m)`` starts from given ones (e.g. bridged from
    JAX)."""
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
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, remat=remat)
        loss.backward()
        opt.step()
        return state, loss.detach()

    return init_state, train_step


# -- serving (KV-cache decode) ------------------------------------------------

def init_kv_cache(cfg, batch, device):
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
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


def _decode_step(model, tokens, positions, attend_for):
    """One-token step through every layer, shared by the dense and the
    paged decode (the JAX ``_decode_step_impl``): tokens (B,) at
    positions (B, 1); ``attend_for(i)`` is layer i's ``attend``, which
    writes the step's K/V and reads the cache. → (B, V) f32 logits."""
    x = model.embed[tokens][:, None, :]  # (B, 1, D)
    for i, layer in enumerate(model.layers):
        x, _ = layer(x, positions, attend_for(i))
    return lm_head(x, model.ln_f.weight, model.embed)[:, 0, :]


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

    def attend_for(i):
        k_cache, v_cache = cache["k"][i], cache["v"][i]

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
def prefill(model, prompt, true_len=None, return_logits=False, cache=None):
    """Single-pass batched prefill: one forward over the whole (B, P)
    prompt; each layer's K/V land in ``cache`` (a fresh one by default)
    at [0, P). With a right-padded (bucketed) prompt, ``true_len`` is the
    real length and the next token reads from position true_len - 1;
    decode overwrites slot p before any query attends it. Entries of a
    reused cache past P keep an earlier request's (finite) K/V, which
    the decode's length mask removes. Returns (next_tokens, cache), or
    ((B, V) logits, cache) with ``return_logits``."""
    batch, prompt_len = prompt.shape
    logits, (ks, vs) = forward(
        model, prompt, return_kv=True,
        logits_at="last" if true_len is None else true_len - 1,
    )
    if cache is None:
        cache = init_kv_cache(model.cfg, batch, prompt.device)
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

    def attend_for(i):
        k_cache, v_cache = cache["k"][i], cache["v"][i]

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
def prefill_into_slot(model, cache, prompt, true_len, slot):
    """Prefill ONE request into cache row ``slot``, the counterpart of the
    JAX ``prefill_into_slot``: prompt (1, P) right-padded to a length
    bucket, the real tokens ending at ``true_len``. One forward through
    the flash kernel (``forward``); the K/V land at cache[:, slot, :, :P]
    and every other row is left as it was, bit for bit. Returns the
    greedy first token as a 0-d tensor on the device."""
    batch, prompt_len = prompt.shape
    if batch != 1:
        raise ValueError(f"one request per slot, got batch {batch}")
    logits, (ks, vs) = forward(model, prompt, return_kv=True,
                               logits_at=true_len - 1)
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
    x = model.embed[seg]
    for i, layer in enumerate(model.layers):
        k_row = cache["k"][i][slot:slot + 1]
        v_row = cache["v"][i][slot:slot + 1]

        def attend(q, k, v, k_row=k_row, v_row=v_row):
            k_row[:, :, offset:offset + seg_len] = k
            v_row[:, :, offset:offset + seg_len] = v
            out, _ = flash_fwd(
                q, k_row, v_row, causal=True, sm_scale=1.0 / (hd ** 0.5),
                q_base=offset, k_base=0, kv_len=window,
            )
            return out

        x, _ = layer(x, positions, attend)
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

    def attend_for(i):
        k_pool, v_pool = pools["k"][i], pools["v"][i]

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
    x = model.embed[seg]
    for i, layer in enumerate(model.layers):
        k_pool, v_pool = pools["k"][i], pools["v"][i]

        def attend(q, k, v, k_pool=k_pool, v_pool=v_pool):
            pa.paged_write_segment(k_pool, k, seg_ids)
            pa.paged_write_segment(v_pool, v, seg_ids)
            k_win = pa.gather_block_kv(k_pool, tables, n_win)
            v_win = pa.gather_block_kv(v_pool, tables, n_win)
            out, _ = flash_fwd(
                q, k_win.to(q.dtype), v_win.to(q.dtype), causal=True,
                sm_scale=1.0 / (hd ** 0.5), q_base=offset, k_base=0,
            )
            return out

        x, _ = layer(x, positions, attend)
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
    x = model.embed[segs]
    for i, layer in enumerate(model.layers):
        k_pool, v_pool = pools["k"][i], pools["v"][i]

        def attend(q, k, v, k_pool=k_pool, v_pool=v_pool):
            pa.paged_write_positions(k_pool, k, block_ids, offsets)
            pa.paged_write_positions(v_pool, v, block_ids, offsets)
            k_win = pa.gather_block_kv(k_pool, tables, n_win)
            v_win = pa.gather_block_kv(v_pool, tables, n_win)
            out, _ = flash_fwd(
                q, k_win.to(q.dtype), v_win.to(q.dtype), causal=True,
                sm_scale=1.0 / (hd ** 0.5), base=base,
            )
            return out

        x, _ = layer(x, positions, attend)
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
