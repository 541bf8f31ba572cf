# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Bridge between the JAX package's parameter pytree and the port's
modules, through numpy (no JAX import here).

The JAX ``init_params`` pytree is ``{"embed": (V, D), "layers": {name:
(L, ...)}, "ln_f": (D,)}`` with a stacked layer dim, (in, out) weight
matrices and the embedding tied to the output head. The port keeps the
(in, out) layout, so each stacked slice maps onto one module parameter
unchanged. This is how the tests run both packages on identical weights.
"""

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.models.transformer import (
    Transformer,
    resolve_device,
)

# JAX pytree layer key → (submodule, parameter) of a DecoderLayer.
_LAYER_PARAMS = {
    "ln1": ("ln1", "weight"),
    "wq": ("attn", "wq"),
    "wk": ("attn", "wk"),
    "wv": ("attn", "wv"),
    "wo": ("attn", "wo"),
    "ln2": ("ln2", "weight"),
    "w1": ("ffn", "w1"),
    "w3": ("ffn", "w3"),
    "w2": ("ffn", "w2"),
}


def _tensor(a, device, dtype):
    # Through f32: numpy has no native bfloat16 (JAX hands out ml_dtypes
    # arrays), and bf16 → f32 → bf16 is exact.
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype
    )


def params_from_jax(tree, cfg, device="cuda", dtype=None):
    """A Transformer holding the weights of a JAX ``init_params`` pytree
    whose leaves are numpy arrays (``jax.tree.map(np.asarray, params)``).
    ``dtype`` defaults to the config's."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    missing = set(_LAYER_PARAMS) - set(tree["layers"])
    if missing or set(tree["layers"]) - set(_LAYER_PARAMS):
        raise ValueError(
            f"expected dense layer params {sorted(_LAYER_PARAMS)}, got "
            f"{sorted(tree['layers'])}"
        )
    model = Transformer(cfg, device).to(dtype)
    with torch.no_grad():
        model.embed.copy_(_tensor(tree["embed"], device, dtype))
        model.ln_f.weight.copy_(_tensor(tree["ln_f"], device, dtype))
        for name, (sub, attr) in _LAYER_PARAMS.items():
            stacked = tree["layers"][name]
            if stacked.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: {stacked.shape[0]} layers, "
                                 f"config has {cfg.n_layers}")
            for i, layer in enumerate(model.layers):
                getattr(getattr(layer, sub), attr).copy_(
                    _tensor(stacked[i], device, dtype)
                )
    return model


def _to_jax(model, tensor_of):
    def arr(p):
        return tensor_of(p).detach().float().cpu().numpy()

    layers = {
        name: np.stack([
            arr(getattr(getattr(layer, sub), attr)) for layer in model.layers
        ])
        for name, (sub, attr) in _LAYER_PARAMS.items()
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
