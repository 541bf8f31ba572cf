# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Weight-only int8 quantization for serving (W8A16), PyTorch port.

Port of ``container_engine_accelerators_tpu/models/quantization.py``.
Small-batch decode streams every layer matrix from device memory each
step; per-output-channel symmetric int8 halves those bytes. The product
stays in the activation dtype, with the channel scale applied to the
f32-accumulated output:

    y = ((x @ q) in f32 * scale).to(x.dtype)        # scale: (1, d_out)

On the card that product is the hand-written kernel of
``ops/int8_matmul.py`` (ops/csrc/int8_mm.cu); on the CPU its plain
version. ``quantize_params`` swaps a ``transformer.Transformer``'s layer
matrices for ``Int8Weight`` modules in place, which ``transformer._mm``
routes to that product. The embedding (tied to the output head) and the
norms stay dense, as in JAX; so do a mixture-of-experts layer's router
and experts: JAX's default keys name its attention matrices only (its
experts are ``moe_w1``/``moe_w2``), and the port's ``MoEFeedForward``
names its expert tensors ``w1``/``w2``, so the owners are chosen by
module (:func:`weight_owners`), not by key alone. Training keeps bf16
(``make_train_step`` refuses a quantized model).

``quantize_weight`` returns JAX's ``{"q": int8 (..., din, dout),
"scale": f32 (..., 1, dout)}``, bit for bit: the scale is rounded in the
weight's dtype before the division, as JAX computes it. ``Int8Weight``
keeps q transposed, (dout, din) with din contiguous, the kernel's
operand layout, and no other copy.
"""

import torch
from torch import nn

# Layer-stack weights quantized by default: the dense matmul operands.
DENSE_WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def quantize_weight(w, axis=-2, amax=None):
    """Symmetric per-output-channel int8: max|w| over the contraction
    axis → scale, round-to-nearest quantize. The scale is computed and
    rounded in w's dtype (bf16 for a bf16 weight), clamped to 1e-8, and
    only then widened to f32, in JAX's order. ``amax`` (w's dtype, keepdim
    over ``axis``) replaces w's own maxima: a row shard of a
    tensor-parallel weight takes the whole weight's
    (``models/tp_serving.quantize_shards``)."""
    if amax is None:
        amax = w.abs().amax(dim=axis, keepdim=True)
    scale = amax / 127.0
    scale = scale.clamp_min(1e-8)
    # A copy in f32 (``w.float()`` of an f32 weight would be w itself),
    # then divided, rounded and clipped in place.
    q = w.to(torch.float32, copy=True).div_(scale.float())
    q = q.round_().clamp_(-127, 127)
    return {"q": q.to(torch.int8), "scale": scale.float()}


def dequantize_weight(w):
    return w["q"].to(w["scale"].dtype) * w["scale"]


def is_quantized(w):
    return isinstance(w, Int8Weight) or (
        isinstance(w, dict) and "q" in w and "scale" in w)


class Int8Weight(nn.Module):
    """A quantized (din, dout) layer matrix: buffers ``q``, int8 (dout,
    din) with din contiguous (the transpose of JAX's q), and ``scale``,
    f32 (1, dout). Buffers, not parameters: an optimizer never sees
    them. ``transformer._mm`` runs the W8A16 product on them."""

    def __init__(self, q, scale):
        super().__init__()
        if q.dim() != 2 or q.dtype != torch.int8 or \
                tuple(scale.shape) != (1, q.shape[0]):
            raise ValueError(
                f"expected int8 q (dout, din) and f32 scale (1, dout), got "
                f"{q.dtype} {tuple(q.shape)} and {tuple(scale.shape)}")
        self.register_buffer("q", q.contiguous())
        self.register_buffer("scale", scale.float().contiguous())

    @classmethod
    def from_jax_layout(cls, q, scale):
        """From JAX's q (din, dout) and scale (1, dout)."""
        return cls(q.T.contiguous(), scale)


def weight_owners(cfg):
    """The names of a decoder layer's modules whose matrices
    ``quantize_params`` swaps: the attention's, and a dense FFN's. An MoE
    FFN keeps its router and experts in their dtypes, as JAX's
    ``quantize_params(params, DENSE_WEIGHT_KEYS)`` reaches none of
    them."""
    return ("attn",) if cfg.n_experts else ("attn", "ffn")


def quantize_params(model, keys=DENSE_WEIGHT_KEYS):
    """Quantize the transformer layer matrices named by ``keys`` in place
    and return the model. Layer by layer on the model's device: each
    dense matrix is replaced as soon as it is quantized, so its storage
    is freed then (if nothing else holds it) and the peak stays near the
    dense model plus one matrix's f32 temporaries. Keys a layer does not
    have, and matrices already quantized, are left as they are; so is an
    MoE layer's FFN (:func:`weight_owners`)."""
    with torch.no_grad():
        for layer in model.layers:
            for owner in (getattr(layer, name)
                          for name in weight_owners(model.cfg)):
                for key in keys:
                    w = getattr(owner, key, None)
                    if w is None or is_quantized(w):
                        continue
                    qw = quantize_weight(w.detach())
                    del w
                    delattr(owner, key)
                    setattr(owner, key,
                            Int8Weight.from_jax_layout(qw["q"], qw["scale"]))
    return model


def model_is_quantized(model):
    """Whether any layer matrix of ``model`` is an ``Int8Weight``."""
    return any(isinstance(m, Int8Weight) for m in model.modules())
