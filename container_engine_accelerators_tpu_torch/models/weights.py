# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Bridge between the JAX package's parameter pytrees and the port's
modules, through numpy (no JAX import here).

The JAX transformer's ``init_params`` pytree is ``{"embed": (V, D),
"layers": {name: (L, ...)}, "ln_f": (D,)}`` with a stacked layer dim,
(in, out) weight matrices and the embedding tied to the output head. The
port keeps the (in, out) layout, so each stacked slice maps onto one
module parameter unchanged. This is how the tests run both packages on
identical weights; ``pp_params_from_jax`` and ``pp_split_jax`` do the
same for JAX ``pipeline_lm.split_params``' (stages, loss_params) pair,
and ``tp_params_from_jax`` / ``tp_to_jax`` (``bert_tp_to_jax``) split a
tree into the tensor- and expert-parallel shards of JAX's
``param_shardings`` and merge shards (or their gradients) back.
A tree from JAX ``quantization.quantize_params``
carries ``{"q": (L, din, dout) int8, "scale": (L, 1, dout) f32}`` leaves
for the quantized layer matrices; each slice becomes an ``Int8Weight``
with the same q and scale. With experts, the layer tree holds
``moe_router`` (L, D, E) f32, ``moe_w1`` (L, E, D, F) and ``moe_w2`` (L,
E, F, D) in place of ``w1``/``w3``/``w2``.

BERT, MNIST and ResNet name their parameters after the JAX trees' keys,
so ``load_jax_tree`` and ``jax_tree`` map them generically: nested dicts
are submodules, a stacked ``layers`` dict is a ``ModuleList`` (slice i to
layer i), and a 4-D leaf is a conv kernel, HWIO in JAX and OIHW here.
For ResNet the flax ``params`` tree fills the parameters and its
``batch_stats`` tree (``mean``, ``var``) the buffers.
"""

import dataclasses

import numpy as np
import torch
from torch import nn

from container_engine_accelerators_tpu_torch.models.quantization import (
    Int8Weight,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    Transformer,
    resolve_device,
)

# JAX pytree layer key → (submodule, parameter) of a DecoderLayer.
_ATTN_PARAMS = {
    "ln1": ("ln1", "weight"),
    "wq": ("attn", "wq"),
    "wk": ("attn", "wk"),
    "wv": ("attn", "wv"),
    "wo": ("attn", "wo"),
    "ln2": ("ln2", "weight"),
}
_DENSE_FFN_PARAMS = {
    "w1": ("ffn", "w1"),
    "w3": ("ffn", "w3"),
    "w2": ("ffn", "w2"),
}
_MOE_FFN_PARAMS = {
    "moe_router": ("ffn", "router"),
    "moe_w1": ("ffn", "w1"),
    "moe_w2": ("ffn", "w2"),
}
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32"}


def _layer_params(cfg):
    ffn = _MOE_FFN_PARAMS if cfg.n_experts else _DENSE_FFN_PARAMS
    return {**_ATTN_PARAMS, **ffn}


def _tensor(a, device, dtype):
    # Through f32: numpy has no native bfloat16 (JAX hands out ml_dtypes
    # arrays), and bf16 → f32 → bf16 (and f16 → f32 → f16) is exact.
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype
    )


def params_from_jax(tree, cfg, device="cuda", dtype=None):
    """A Transformer holding the weights of a JAX ``init_params`` pytree
    whose leaves are numpy arrays (``jax.tree.map(np.asarray, params)``),
    quantized layer matrices (``{"q", "scale"}`` leaves) and expert
    weights included. ``dtype`` defaults to the config's; an MoE router
    stays f32, as in JAX."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    layer_params = _layer_params(cfg)
    if set(layer_params) != set(tree["layers"]):
        raise ValueError(
            f"expected layer params {sorted(layer_params)}, got "
            f"{sorted(tree['layers'])}"
        )
    model = Transformer(
        dataclasses.replace(cfg, dtype=_DTYPE_NAMES[dtype]), device)
    with torch.no_grad():
        model.embed.copy_(_tensor(tree["embed"], device, dtype))
        model.ln_f.weight.copy_(_tensor(tree["ln_f"], device, dtype))
        for name, (sub, attr) in layer_params.items():
            stacked = tree["layers"][name]
            quantized = isinstance(stacked, dict)
            layers = (stacked["q"] if quantized else stacked).shape[0]
            if layers != cfg.n_layers:
                raise ValueError(f"{name}: {layers} layers, "
                                 f"config has {cfg.n_layers}")
            for i, layer in enumerate(model.layers):
                owner = getattr(layer, sub)
                if quantized:
                    delattr(owner, attr)
                    setattr(owner, attr, Int8Weight.from_jax_layout(
                        torch.from_numpy(np.array(stacked["q"][i])).to(
                            device),
                        _tensor(stacked["scale"][i], device, torch.float32),
                    ))
                else:
                    p = getattr(owner, attr)
                    p.copy_(_tensor(stacked[i], device, p.dtype))
    return model


def _to_jax(model, tensor_of):
    def arr(p):
        return tensor_of(p).detach().float().cpu().numpy()

    layers = {
        name: np.stack([
            arr(getattr(getattr(layer, sub), attr)) for layer in model.layers
        ])
        for name, (sub, attr) in _layer_params(model.cfg).items()
    }
    return {
        "embed": arr(model.embed),
        "layers": layers,
        "ln_f": arr(model.ln_f.weight),
    }


def params_to_jax(model):
    """The inverse: the model's weights as a JAX-layout pytree of float32
    numpy arrays (cast to the config dtype on the JAX side)."""
    return _to_jax(model, lambda p: p)


def grads_to_jax(model):
    """The parameters' ``.grad`` as a JAX-layout pytree of float32 numpy
    arrays, leaf for leaf the tree ``jax.grad`` gives over the JAX params
    (a parameter without a gradient gives zeros)."""
    return _to_jax(
        model, lambda p: p.grad if p.grad is not None else torch.zeros_like(p)
    )


def _named_to_jax(named, cfg):
    """A JAX-layout tree from the port's parameter names (the whole
    model's, e.g. ``tp_lm.merged``) → float32 numpy arrays."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    layers = {
        key: np.stack([arr(named[f"layers.{i}.{sub}.{attr}"])
                       for i in range(cfg.n_layers)])
        for key, (sub, attr) in _layer_params(cfg).items()
    }
    return {"embed": arr(named["embed"]), "layers": layers,
            "ln_f": arr(named["ln_f.weight"])}


def tp_params_from_jax(tree, cfg, axes, device="cuda", dtype=None):
    """The tensor- and expert-parallel shards of a JAX ``init_params``
    tree that the ranks of ``axes`` (``parallel/tensor_parallel.Axes``)
    hold: :func:`params_from_jax`, split as JAX's ``param_shardings``
    lays the tree out over tp and ep (``models/tp_lm.split_params``)."""
    from container_engine_accelerators_tpu_torch.models import tp_lm

    return tp_lm.split_params(
        params_from_jax(tree, cfg, device=device, dtype=dtype), axes)


def tp_to_jax(shards, axes, which="params"):
    """The inverse: the whole model's parameters (``which="grads"``: the
    gradients, leaf for leaf ``jax.grad``'s tree) as a JAX-layout tree of
    float32 numpy arrays, merged from every rank's shards (gathered over
    the tp and ep groups between processes)."""
    from container_engine_accelerators_tpu_torch.models import tp_lm

    return _named_to_jax(tp_lm.merged(shards, axes, which), shards[0].cfg)


def pp_params_from_jax(stages, loss_params, cfg, device="cuda", dtype=None):
    """A Transformer from JAX ``pipeline_lm.split_params``' pair: the
    stage leaves (N, L/N, ...) merged back to (L, ...), then
    :func:`params_from_jax`."""
    layers = {name: np.asarray(a).reshape((-1,) + np.shape(a)[2:])
              for name, a in stages.items()}
    return params_from_jax({"embed": loss_params["embed"], "layers": layers,
                            "ln_f": loss_params["ln_f"]}, cfg,
                           device=device, dtype=dtype)


def pp_split_jax(tree, n_stages):
    """A JAX-layout tree (:func:`params_to_jax`, :func:`grads_to_jax`)
    as JAX ``pipeline_lm.split_params`` splits it: (stages, loss_params),
    each layer leaf (L, ...) reshaped to (N, L/N, ...)."""
    stages = {name: a.reshape((n_stages, -1) + a.shape[1:])
              for name, a in tree["layers"].items()}
    return stages, {"embed": tree["embed"], "ln_f": tree["ln_f"]}


# -- BERT, MNIST, ResNet: parameters named after the JAX trees' keys ----------

def _conv_in(a):
    """A JAX leaf as the port lays it out: HWIO conv kernels → OIHW."""
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _conv_out(a):
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_jax_tree(module, tree):
    """Copy a JAX tree whose leaves are numpy arrays into ``module`` in
    place, key for key: a dict is a submodule (a stacked ``layers`` dict
    the ``ModuleList``'s slices), a leaf the parameter or buffer of that
    name, cast to its dtype. Raises on a missing name or a shape that
    differs. Returns the module."""
    with torch.no_grad():
        for key, val in tree.items():
            target = getattr(module, key)
            if isinstance(target, nn.ModuleList):
                for i, layer in enumerate(target):
                    load_jax_tree(layer, _slice(val, i))
            elif isinstance(val, dict):
                load_jax_tree(target, val)
            else:
                arr = _conv_in(val)
                if tuple(arr.shape) != tuple(target.shape):
                    raise ValueError(
                        f"{key}: JAX shape {np.shape(val)}, port "
                        f"{tuple(target.shape)}")
                target.copy_(_tensor(arr, target.device, target.dtype))
    return module


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def bert_tp_to_jax(shards, axes, which="params"):
    """:func:`tp_to_jax` for BERT's tp shards (``models/bert.py``): the
    merged parameters or gradients in ``jax_tree``'s layout."""
    from container_engine_accelerators_tpu_torch.models import bert

    named = bert.merged(shards, axes, which)
    model = bert.Bert(shards[0].cfg, "cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if which == "params":
                p.copy_(named[name])
            else:
                p.grad = named[name].to("cpu")
    return jax_tree(model, which)


def jax_tree(module, which="params"):
    """The inverse of ``load_jax_tree``: ``module``'s parameters
    (``which="params"``), their ``.grad`` (``"grads"``, zeros where there
    is none) or its buffers (``"buffers"``, flax's ``batch_stats``) as a
    JAX-layout tree of float32 numpy arrays; submodules without such
    leaves are left out."""
    if which == "buffers":
        leaves = module.named_buffers(recurse=False)
    else:
        leaves = module.named_parameters(recurse=False)
    out = {}
    for name, t in leaves:
        if which == "grads":
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        out[name] = _conv_out(t.detach().float().cpu().numpy())
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            trees = [jax_tree(layer, which) for layer in child]
            sub = _stack(trees) if trees and trees[0] else {}
        else:
            sub = jax_tree(child, which)
        if sub:
            out[name] = sub
    return out
