# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""BERT-style bidirectional encoder with masked-language-model training,
the PyTorch port of ``container_engine_accelerators_tpu/models/bert.py``
on one device.

The same model: learned position and segment embeddings, post-LN
residuals with LayerNorm (f32 statistics, scale and bias in f32, one cast
at the end), a tanh-approximated GELU MLP (``jax.nn.gelu``'s default), no
GQA, and an f32 MLM head tied to the token embedding with a free bias.
Unmasked attention is ``ops.attention.flash_attention(causal=False)``:
the hand-written forward, dq and dk/dv kernels on CUDA tensors (the JAX
package's ``on_tpu`` branch), their plain versions on CPU tensors. With a
``pad_mask`` it is JAX's plain f32 path with the ``-1e30`` mask on every
device, as JAX does. Parameters are named after the JAX pytree's keys,
its stacked layer dim a ``ModuleList``, so ``models/weights.py`` bridges
JAX's weights leaf for leaf.

Not ported: the dp×tp shardings (``param_shardings``).
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from container_engine_accelerators_tpu_torch.models.transformer import (
    _DTYPES,
    resolve_device,
)
from container_engine_accelerators_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention,
)

MASK_TOKEN = 1  # vocab slot reserved for [MASK] in synthetic batches


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        return _DTYPES[self.dtype]

    @classmethod
    def bert_large(cls):
        return cls(
            vocab_size=30522, d_model=1024, n_layers=24, n_heads=16,
            d_ff=4096, max_seq_len=512,
        )


def _param(*shape, dtype, device):
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


class LayerNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x, eps=1e-5):
        """JAX's ``_layer_norm``: f32 statistics, scale and bias applied
        in f32, one cast back to x's dtype."""
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + eps)
        return (out * self.scale.float() + self.bias.float()).to(x.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param(d, d, dtype=dt, device=device))
        self.ln1 = LayerNorm(d, dt, device)
        self.w_in = _param(d, f, dtype=dt, device=device)
        self.b_in = nn.Parameter(torch.zeros(f, dtype=dt, device=device))
        self.w_out = _param(f, d, dtype=dt, device=device)
        self.b_out = nn.Parameter(torch.zeros(d, dtype=dt, device=device))
        self.ln2 = LayerNorm(d, dt, device)


class MlmHead(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        self.w = _param(d, d, dtype=dt, device=device)
        self.b = nn.Parameter(torch.zeros(d, dtype=dt, device=device))
        self.ln = LayerNorm(d, dt, device)
        self.out_bias = nn.Parameter(
            torch.zeros(cfg.vocab_size, dtype=torch.float32, device=device))


class Bert(nn.Module):
    """The whole model; parameters are created unfilled on ``device`` (use
    ``init_params`` or ``models.weights.load_jax_tree``)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype
        self.cfg = cfg
        self.embed = _param(cfg.vocab_size, d, dtype=dt, device=device)
        self.pos_embed = _param(cfg.max_seq_len, d, dtype=dt, device=device)
        self.type_embed = _param(cfg.type_vocab_size, d, dtype=dt,
                                 device=device)
        self.ln_embed = LayerNorm(d, dt, device)
        self.layers = nn.ModuleList(
            BertLayer(cfg, device) for _ in range(cfg.n_layers))
        self.mlm = MlmHead(cfg, device)

    @property
    def device(self):
        return self.embed.device


def init_params(cfg, device="cuda", seed=0):
    """A Bert with random weights drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, JAX's distributions: the
    embeddings normal * 0.02, every matrix normal * its last dim ** -0.5,
    biases zeros, LayerNorm scales ones. The numbers differ from
    ``jax.random``'s; tests bridge JAX's own weights instead."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Bert(cfg, device)

    def fill(p, scale):
        p.copy_(torch.randn(p.shape, generator=gen, device=device) * scale)

    with torch.no_grad():
        for p in (model.embed, model.pos_embed, model.type_embed):
            fill(p, 0.02)
        for layer in model.layers:
            for w in (layer.wq, layer.wk, layer.wv, layer.wo, layer.w_in,
                      layer.w_out):
                fill(w, w.shape[-1] ** -0.5)
        fill(model.mlm.w, model.mlm.w.shape[-1] ** -0.5)
    return model


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _attention(q, k, v, pad_mask, attn_impl):
    """Bidirectional attention; pad_mask (B, S) True = real token.
    ``attn_impl`` "flash" sends unmasked attention through the flash
    kernels; "reference" (and any pad_mask) takes JAX's plain f32 path."""
    if pad_mask is None and attn_impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=False)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (
        q.shape[-1] ** 0.5)
    if pad_mask is not None:
        s = torch.where(pad_mask[:, None, None, :].bool(), s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


ATTN_IMPLS = ("flash", "reference")


def forward(model, tokens, segment_ids=None, pad_mask=None,
            attn_impl="flash"):
    """tokens (B, S) → final hidden states (B, S, D); differentiable."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    cfg = model.cfg
    batch, seq = tokens.shape
    h, hd = cfg.n_heads, cfg.head_dim

    x = model.embed[tokens] + model.pos_embed[None, :seq, :]
    if segment_ids is None:
        x = x + model.type_embed[0][None, None, :]
    else:
        x = x + model.type_embed[segment_ids]
    x = model.ln_embed(x)
    for lp in model.layers:
        def heads(w):
            return (x @ w).view(batch, seq, h, hd).transpose(1, 2)

        attn = _attention(heads(lp.wq), heads(lp.wk), heads(lp.wv),
                          pad_mask, attn_impl)
        attn = attn.transpose(1, 2).reshape(batch, seq, h * hd)
        x = lp.ln1(x + attn @ lp.wo)  # post-LN
        act = gelu((x @ lp.w_in + lp.b_in).float())
        x = lp.ln2(x + (act.to(x.dtype) @ lp.w_out + lp.b_out))
    return x


def mlm_logits(model, hidden):
    """MLM head over every position (B, S, V) in f32."""
    m = model.mlm
    t = gelu((hidden @ m.w + m.b).float())
    t = m.ln(t.to(hidden.dtype))
    return t.float() @ model.embed.T.float() + m.out_bias


def loss_fn(model, batch, attn_impl="flash"):
    """Masked-LM cross entropy on the masked positions only. batch:
    tokens (B, S) with [MASK] already substituted, labels (B, S) the
    original tokens, mlm_mask (B, S) 1.0 where masked, and optionally
    segment_ids and pad_mask (tensors or arrays, moved to the model's
    device)."""
    dev = model.device

    def get(key):
        val = batch.get(key)
        return None if val is None else torch.as_tensor(val, device=dev)

    hidden = forward(model, get("tokens"), segment_ids=get("segment_ids"),
                     pad_mask=get("pad_mask"), attn_impl=attn_impl)
    logp = torch.log_softmax(mlm_logits(model, hidden), dim=-1)
    ll = torch.gather(logp, -1, get("labels")[..., None])[..., 0]
    mask = get("mlm_mask").float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def adamw(params):
    """optax ``adamw(1e-4, weight_decay=0.01)``, JAX BERT's optimizer:
    decoupled decay on every parameter."""
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def make_train_step(cfg, optimizer=None, device="cuda"):
    """Returns (init_state, train_step); state = (model, optimizer). No
    remat, as in JAX. ``init_state(seed)`` draws random weights on
    ``device``; ``init_state(model=m)`` starts from given ones."""
    device = resolve_device(device)
    make_optimizer = optimizer or adamw

    def init_state(seed=0, model=None):
        if model is None:
            model = init_params(cfg, device=device, seed=seed)
        return model, make_optimizer(model.parameters())

    def train_step(state, batch):
        """One step in place; returns (state, loss)."""
        model, opt = state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return state, loss.detach()

    return init_state, train_step


def synthetic_mlm_batch(rng, batch_size, cfg, mask_rate=0.15, device="cpu"):
    """Random labels in [MASK_TOKEN + 1, V) with ``mask_rate`` of the
    positions swapped to [MASK], drawn from the numpy generator ``rng``
    (the JAX package draws from ``jax.random``): tensors on ``device``."""
    labels = rng.integers(MASK_TOKEN + 1, cfg.vocab_size,
                          (batch_size, cfg.max_seq_len))
    mlm_mask = rng.random((batch_size, cfg.max_seq_len)) < mask_rate
    tokens = np.where(mlm_mask, MASK_TOKEN, labels)
    return {
        "tokens": torch.as_tensor(tokens, device=device),
        "labels": torch.as_tensor(labels, device=device),
        "mlm_mask": torch.as_tensor(mlm_mask, dtype=torch.float32,
                                    device=device),
    }
