# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""MNIST CNN, the PyTorch port of
``container_engine_accelerators_tpu/models/mnist.py`` on one device.

f32: two SAME 3×3 convs, each followed by ReLU and a 2×2 max pool, then
two dense layers. Images arrive NHWC (B, 28, 28, 1), as in JAX; the
convs run NCHW, and the features are flattened in JAX's NHWC order
(7, 7, 64), so ``dense1``'s rows are JAX's. Conv kernels are OIHW
(``models/weights.py`` transposes JAX's HWIO); the dense matrices keep
JAX's (in, out) layout. SGD with momentum 0.9 (dampening 0) equals
optax's ``sgd(0.05, momentum=0.9)``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from container_engine_accelerators_tpu_torch.models.transformer import (
    resolve_device,
)


class Mnist(nn.Module):
    """Parameters named after JAX's keys, created unfilled on ``device``."""

    def __init__(self, device, dtype=torch.float32):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype,
                                            device=device))

        self.conv1 = param(32, 1, 3, 3)
        self.conv2 = param(64, 32, 3, 3)
        self.dense1 = param(7 * 7 * 64, 128)
        self.b1 = nn.Parameter(torch.zeros(128, dtype=dtype, device=device))
        self.dense2 = param(128, 10)
        self.b2 = nn.Parameter(torch.zeros(10, dtype=dtype, device=device))

    @property
    def device(self):
        return self.conv1.device


def init_params(device="cuda", seed=0):
    """JAX's distributions (convs normal * sqrt(2 / fan_in), dense
    normal * 0.02, biases zeros) from a ``torch.Generator``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Mnist(device)

    def fill(p, scale):
        p.copy_(torch.randn(p.shape, generator=gen, device=device) * scale)

    with torch.no_grad():
        for conv in (model.conv1, model.conv2):
            fill(conv, (2.0 / conv[0].numel()) ** 0.5)
        fill(model.dense1, 0.02)
        fill(model.dense2, 0.02)
    return model


def forward(model, images):
    """images (B, 28, 28, 1) NHWC → logits (B, 10)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(F.conv2d(x, model.conv1, padding=1)), 2)
    x = F.max_pool2d(F.relu(F.conv2d(x, model.conv2, padding=1)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ model.dense1 + model.b1)
    return x @ model.dense2 + model.b2


def loss_fn(model, batch):
    images = torch.as_tensor(batch["images"], device=model.device)
    labels = torch.as_tensor(batch["labels"], device=model.device)
    logp = torch.log_softmax(forward(model, images), dim=-1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


def sgd(params):
    """optax ``sgd(0.05, momentum=0.9)``."""
    return torch.optim.SGD(params, lr=0.05, momentum=0.9)


def make_train_step(optimizer=None, device="cuda"):
    """Returns (init_state, train_step); state = (model, optimizer)."""
    device = resolve_device(device)
    make_optimizer = optimizer or sgd

    def init_state(seed=0, model=None):
        if model is None:
            model = init_params(device=device, seed=seed)
        return model, make_optimizer(model.parameters())

    def train_step(state, batch):
        model, opt = state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return state, loss.detach()

    return init_state, train_step


def synthetic_batch(rng, batch_size, device="cpu"):
    """Normal images (B, 28, 28, 1) and labels in [0, 10) from the numpy
    generator ``rng`` (JAX draws from ``jax.random``)."""
    images = rng.standard_normal((batch_size, 28, 28, 1), dtype="float32")
    labels = rng.integers(0, 10, (batch_size,))
    return {"images": torch.as_tensor(images, device=device),
            "labels": torch.as_tensor(labels, device=device)}
