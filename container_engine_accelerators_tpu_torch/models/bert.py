# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""BERT-style bidirectional encoder with masked-language-model training,
the PyTorch port of ``container_engine_accelerators_tpu/models/bert.py``.

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

Data parallel: ``make_train_step(mesh=...)`` runs this rank's rows of
the global batch and sums the gradients over the dp axis
(``parallel/data_parallel.py``); the parameters stay replicated, which
JAX's dp sharding computes the same numbers as. Tensor parallel (a mesh
"tp" axis above 1, or ``make_tp_train_step`` over ``Axes`` held in one
process): JAX's ``param_shardings`` (:102) in Megatron's form, wq, wk,
wv, w_in and b_in split by columns and wo, w_out by rows over tp, the
embeddings, norms and MLM head whole; activations stay replicated over
tp, with one all-reduce of each row-parallel product's f32 partials
(``parallel/tensor_parallel.row_parallel``), and attention runs the
non-causal flash kernels on the rank's n_heads/tp heads. Every replicated
parameter then sees every token on every tp rank, so its gradient is
whole there and only dp sums it. Where tp does not divide n_heads the
attention is held whole on every tp rank (``whole_parts``) and computed
there alike with no collective, its input gradient not summed over tp:
the function GSPMD computes where its shards of the d_model columns cut
through a head. Widths JAX's ``device_put`` cannot shard over tp (d_ff,
d_model) are refused as it fails (``make_tp_train_step``).
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
from container_engine_accelerators_tpu_torch.parallel import data_parallel
from container_engine_accelerators_tpu_torch.parallel import (
    tensor_parallel as tpar,
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
    """tokens (B, S) → final hidden states (B, S, D); differentiable
    (``tp_forward`` on the one whole model)."""
    return tp_forward([model], tpar.Axes.in_process(), tokens,
                      segment_ids=segment_ids, pad_mask=pad_mask,
                      attn_impl=attn_impl)[0]


def _embed(model, tokens, segment_ids):
    seq = tokens.shape[1]
    x = model.embed[tokens] + model.pos_embed[None, :seq, :]
    if segment_ids is None:
        x = x + model.type_embed[0][None, None, :]
    else:
        x = x + model.type_embed[segment_ids]
    return model.ln_embed(x)


def tp_forward(shards, axes, tokens, segment_ids=None, pad_mask=None,
               attn_impl="flash"):
    """The encoder on the tp shards of every rank held (``axes``; a lone
    whole model at tp 1, :func:`forward`): the final hidden states per
    rank, each the whole (B, S, D). Megatron's layout: the attention's
    heads and the FFN's columns split over tp, each leaving product's
    partial sums reduced over tp (``row_parallel``; the plain product at
    tp 1)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    tp = axes.tp
    cfg = shards[0].cfg
    batch, seq = tokens.shape
    whole = whole_parts(cfg, tp.size)
    attn_in, attn_out = _products(axes, "attn" not in whole)
    ffn_in, ffn_out = _products(axes, True)
    h = cfg.n_heads // (1 if "attn" in whole else tp.size)
    hd = cfg.head_dim
    xs = [_embed(s, tokens, segment_ids) for s in shards]
    for i in range(cfg.n_layers):
        lps = [s.layers[i] for s in shards]

        def heads(t):
            return t.view(batch, seq, h, hd).transpose(1, 2)

        outs = []
        for (q, k, v) in attn_in(xs, [(lp.wq, lp.wk, lp.wv) for lp in lps]):
            attn = _attention(heads(q), heads(k), heads(v), pad_mask,
                              attn_impl)
            outs.append(attn.transpose(1, 2).reshape(batch, seq, h * hd))
        outs = attn_out(outs, [lp.wo for lp in lps])
        xs = [lp.ln1(x + o) for x, o, lp in zip(xs, outs, lps)]
        outs = [gelu((u + lp.b_in).float()).to(x.dtype)
                for (u,), x, lp in zip(ffn_in(
                    xs, [(lp.w_in,) for lp in lps]), xs, lps)]
        outs = ffn_out(outs, [lp.w_out for lp in lps])
        xs = [lp.ln2(x + (o + lp.b_out)) for x, o, lp in zip(xs, outs, lps)]
    return xs


def whole_parts(cfg, tp):
    """The parts tp does not divide, each held whole on every tp rank and
    computed there alike with no collective (``tp_lm.whole_parts``'s
    rule): "attn" (wq, wk, wv, wo) unless tp divides n_heads."""
    return frozenset({"attn"} if cfg.n_heads % tp else ())


def layout(cfg, tp):
    """``tensor_parallel.BERT_TP`` without the whole parts' weights."""
    if "attn" not in whole_parts(cfg, tp):
        return dict(tpar.BERT_TP)
    return {name: dim for name, dim in tpar.BERT_TP.items()
            if name not in ("wq", "wk", "wv", "wo")}


def _products(axes, split):
    """(enter, leave) of a part: a split part's column shards and
    row-parallel sums over tp, a whole part's plain products (its input
    gradient whole already, so not summed over tp)."""
    if not split:
        return (lambda xs, wss: [tuple(x @ w for w in ws)
                                 for x, ws in zip(xs, wss)],
                lambda ys, ws: [y @ w for y, w in zip(ys, ws)])
    return (lambda xs, wss: tpar.column_products(xs, wss, [axes.tp]),
            lambda ys, ws: tpar.row_parallel(ys, ws, axes))


def split_params(model, axes):
    """The tp shards of ``model`` the ranks of ``axes`` hold (new
    tensors), an ``nn.ModuleList`` in list order: :func:`layout`'s
    parts split, the whole parts whole."""
    return tpar.split_module(model, lambda: Bert(model.cfg, "meta"), axes,
                             layout(model.cfg, axes.tp.size))


def merged(shards, axes, which="params"):
    """The whole model's parameters (``which="grads"``: gradients) by
    name from every rank's shards (``tensor_parallel.merged``)."""
    return tpar.merged(shards, axes, layout(shards[0].cfg, axes.tp.size),
                       which=which)


def mlm_logits(model, hidden):
    """MLM head over every position (B, S, V) in f32."""
    m = model.mlm
    t = gelu((hidden @ m.w + m.b).float())
    t = m.ln(t.to(hidden.dtype))
    return t.float() @ model.embed.T.float() + m.out_bias


def loss_fn(model, batch, attn_impl="flash", denom=None):
    """Masked-LM cross entropy on the masked positions only. batch:
    tokens (B, S) with [MASK] already substituted, labels (B, S) the
    original tokens, mlm_mask (B, S) 1.0 where masked, and optionally
    segment_ids and pad_mask (tensors or arrays, moved to the model's
    device). ``denom``: what the masked sum is divided by, by default
    this batch's masked count (at least 1); a rank of a data-parallel
    step passes the global batch's."""
    dev = model.device

    def get(key):
        val = batch.get(key)
        return None if val is None else torch.as_tensor(val, device=dev)

    hidden = forward(model, get("tokens"), segment_ids=get("segment_ids"),
                     pad_mask=get("pad_mask"), attn_impl=attn_impl)
    return _mlm_loss(model, hidden, get("labels"), get("mlm_mask"), denom)


def _mlm_loss(model, hidden, labels, mlm_mask, denom=None):
    logp = torch.log_softmax(mlm_logits(model, hidden), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = mlm_mask.float()
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    return -(ll * mask).sum() / denom


def adamw(params):
    """optax ``adamw(1e-4, weight_decay=0.01)``, JAX BERT's optimizer:
    decoupled decay on every parameter."""
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def local_loss(model, batch, mesh):
    """This rank's share of the global batch's loss: its rows' masked sum
    over the GLOBAL masked count, so the ranks' shares sum to the global
    loss. No mesh: the loss."""
    if mesh is None:
        return loss_fn(model, batch)
    mask = torch.as_tensor(batch["mlm_mask"], device=model.device).float()
    local = data_parallel.shard_batch(batch, mesh, model.device)
    return loss_fn(model, local, denom=mask.sum().clamp_min(1.0))


def make_train_step(cfg, optimizer=None, device="cuda", mesh=None):
    """Returns (init_state, train_step); state = (model, optimizer). No
    remat, as in JAX. ``init_state(seed)`` draws random weights on
    ``device``; ``init_state(model=m)`` starts from given ones. ``mesh``
    (a DeviceMesh with a "dp" axis): each step takes the GLOBAL batch,
    runs this rank's rows and sums the gradients and the loss over the
    world (``parallel/data_parallel.train_step``)."""
    if data_parallel.axis(mesh, "tp")[1] > 1:
        return make_tp_train_step(cfg, tpar.Axes.of_mesh(mesh), mesh=mesh,
                                  optimizer=optimizer, device=device)
    device = resolve_device(device)
    make_optimizer = optimizer or adamw

    def init_state(seed=0, model=None):
        if model is None:
            model = init_params(cfg, device=device, seed=seed)
        return model, make_optimizer(model.parameters())

    def train_step(state, batch):
        """One step in place; returns (state, loss)."""
        model, opt = state
        loss = data_parallel.train_step(
            model, opt, lambda: local_loss(model, batch, mesh), mesh,
            data_parallel.BATCH_AXES)
        return state, loss

    return init_state, train_step


def make_tp_train_step(cfg, axes, mesh=None, optimizer=None, device="cuda",
                       attn_impl="flash"):
    """Tensor-parallel (init_state, train_step) over ``axes``
    (``tensor_parallel.Axes``: its tp transport) and, for dp, ``mesh``.
    ``init_state(seed=0, model=None)`` draws or takes the whole model and
    keeps the shards of the ranks held: state = (the shards, an
    ``nn.ModuleList``; the optimizer over them). ``train_step(state,
    batch)`` takes the GLOBAL batch and returns (state, the global
    loss). A d_ff or a d_model that tp does not divide is refused, as
    JAX's ``device_put`` of ``param_shardings`` fails on it."""
    for name in ("d_model", "d_ff"):
        if getattr(cfg, name) % axes.tp.size:
            raise ValueError(f"tp={axes.tp.size} must divide {name}="
                             f"{getattr(cfg, name)}")
    device = resolve_device(device)
    make_optimizer = optimizer or adamw

    def init_state(seed=0, model=None):
        if model is None:
            model = init_params(cfg, device=device, seed=seed)
        shards = split_params(model, axes)
        return shards, make_optimizer(list(shards.parameters()))

    def train_step(state, batch):
        shards, opt = state
        opt.zero_grad(set_to_none=True)
        mask = torch.as_tensor(batch["mlm_mask"], device=device).float()
        local = batch if mesh is None else \
            data_parallel.shard_batch(batch, mesh, device)
        get = {k: None if local.get(k) is None else
               torch.as_tensor(local[k], device=device)
               for k in ("tokens", "segment_ids", "pad_mask", "labels",
                         "mlm_mask")}
        hidden = tp_forward(list(shards), axes, get["tokens"],
                            segment_ids=get["segment_ids"],
                            pad_mask=get["pad_mask"], attn_impl=attn_impl)
        denom = mask.sum().clamp_min(1.0)
        losses = [_mlm_loss(s, x, get["labels"], get["mlm_mask"], denom)
                  for s, x in zip(shards, hidden)]
        sum(losses).backward()
        tpar.reduce_grads(shards, axes, mesh, lambda name: False,
                          data_axes=data_parallel.BATCH_AXES)
        loss = data_parallel.sum_loss(losses[0], mesh,
                                      data_parallel.BATCH_AXES)
        opt.step()
        return state, loss

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
