# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""ResNet with bottleneck blocks, the PyTorch port of
``container_engine_accelerators_tpu/models/resnet.py`` (flax linen) on
one device.

What flax does and torch's own layers do not, written out here:

  * Convs pad as flax's ``padding="SAME"``: for stride s and kernel k
    over n, pad_total = max((ceil(n / s) - 1)·s + k - n, 0), the low side
    pad_total // 2. A stride-2 3×3 conv on an even input pads (0, 1),
    not torch's symmetric 1. The stem (explicit 3) and the max pool
    (explicit 1, -inf) are symmetric.
  * BatchNorm is flax's: statistics over (N, H, W) in f32 with the fast
    variance E[x²] − E[x]² (clipped at 0), used both to normalise and to
    update ``var`` (torch's ``BatchNorm2d`` updates its running variance
    with the unbiased one), running stats ← 0.99 · running + 0.01 ·
    batch, eps 1e-5; ``scale`` and ``bias`` applied in f32.
  * The last BatchNorm of each block starts with scale 0; the ``Dense``
    head is f32.

Modules and parameters carry flax's names (``stem_conv``, ``stem_bn``,
``BottleneckBlock_i`` with ``Conv_j``, ``BatchNorm_j``, ``proj_conv``,
``proj_bn``, ``Dense_0``; ``kernel``, ``scale``, ``bias`` and the
buffers ``mean`` and ``var``), so ``models/weights.py`` bridges a
``{"params", "batch_stats"}`` tree leaf for leaf; conv kernels are OIHW.
Images arrive NHWC, as in JAX. Computation runs in the model's ``dtype``
with f32 parameters and statistics, as flax's ``dtype`` does.

Not ported: the data-parallel mesh placement.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from container_engine_accelerators_tpu_torch.models.transformer import (
    resolve_device,
)

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def same_pad(n, k, s):
    """flax's SAME padding of one spatial dim: (low, high)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A bias-free conv, ``kernel`` OIHW in f32; ``padding`` "SAME" or an
    explicit (low, high) per spatial dim."""

    def __init__(self, c_in, c_out, k, stride, device, padding="SAME"):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(c_out, c_in, k, k, device=device))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        k, s = self.kernel.shape[-1], self.stride
        if self.padding == "SAME":
            (top, bottom), (left, right) = (same_pad(n, k, s)
                                            for n in x.shape[-2:])
        else:
            (top, bottom), (left, right) = self.padding
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.kernel.to(x.dtype), stride=s)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` in training mode (batch statistics)."""

    def __init__(self, c, device, scale_init=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((c,), scale_init,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x):
        """x (N, C, H, W); updates ``mean``/``var`` in place. Statistics
        in at least f32, as flax promotes them."""
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = x32.mean(dim=(0, 2, 3))
        var = (x32.square().mean(dim=(0, 2, 3)) - mu.square()).clamp_min(0.0)
        with torch.no_grad():
            self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mu)
            self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)

        def per_channel(t):
            return t[None, :, None, None]

        scale, bias = (p.to(x32.dtype) for p in (self.scale, self.bias))
        mul = torch.rsqrt(per_channel(var) + BN_EPS) * per_channel(scale)
        y = (x32 - per_channel(mu)) * mul + per_channel(bias)
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, c_in, filters, strides, device):
        super().__init__()
        if c_in != filters * 4 or strides != 1:
            self.proj_conv = Conv(c_in, filters * 4, 1, strides, device)
            self.proj_bn = BatchNorm(filters * 4, device)
        self.Conv_0 = Conv(c_in, filters, 1, 1, device)
        self.BatchNorm_0 = BatchNorm(filters, device)
        self.Conv_1 = Conv(filters, filters, 3, strides, device)
        self.BatchNorm_1 = BatchNorm(filters, device)
        self.Conv_2 = Conv(filters, filters * 4, 1, 1, device)
        self.BatchNorm_2 = BatchNorm(filters * 4, device, scale_init=0.0)

    def forward(self, x):
        residual = x
        if hasattr(self, "proj_conv"):
            residual = self.proj_bn(self.proj_conv(residual))
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return F.relu(y + residual)


class Dense(nn.Module):
    def __init__(self, d_in, d_out, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


class ResNet(nn.Module):
    def __init__(self, stage_sizes, num_classes=1000,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(3, 64, 7, 2, device,
                              padding=((3, 3), (3, 3)))
        self.stem_bn = BatchNorm(64, device)
        c_in, i = 64, 0
        for stage, size in enumerate(stage_sizes):
            for block in range(size):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = 64 * 2 ** stage
                self.add_module(f"BottleneckBlock_{i}", BottleneckBlock(
                    c_in, filters, strides, device))
                c_in, i = filters * 4, i + 1
        self.n_blocks = i
        self.Dense_0 = Dense(c_in, num_classes, device)

    @property
    def device(self):
        return self.Dense_0.kernel.device

    def forward(self, images):
        """images (B, H, W, 3) NHWC → f32 logits (B, num_classes);
        training mode (batch statistics, running stats updated)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet50(num_classes=1000, dtype=torch.bfloat16, device="cuda"):
    return ResNet([3, 4, 6, 3], num_classes, dtype, resolve_device(device))


def resnet18_ish(num_classes=10, dtype=torch.float32, device="cuda"):
    """Small bottleneck net for hermetic tests and ``train_cli``."""
    return ResNet([1, 1], num_classes, dtype, resolve_device(device))


def init_params(model, seed=0):
    """Fill ``model`` in place with flax's initialisers from a
    ``torch.Generator``: every conv and the Dense kernel LeCun normal
    (truncated at 2 std, std sqrt(1 / fan_in) / 0.8796), BatchNorm
    scales as built (1, and 0 in each block's last), biases 0, running
    mean 0 and var 1. The numbers differ from ``jax.random``'s; tests
    bridge flax's own weights. Returns the model."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("kernel"):
                fan_in = p[0].numel() if p.dim() == 4 else p.shape[0]
                std = fan_in ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
    return model


def loss_fn(model, batch):
    images = torch.as_tensor(batch["images"], device=model.device)
    labels = torch.as_tensor(batch["labels"], device=model.device)
    logp = torch.log_softmax(model(images), dim=-1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


def sgd(params):
    """optax ``sgd(0.1, momentum=0.9, nesterov=True)``."""
    return torch.optim.SGD(params, lr=0.1, momentum=0.9, nesterov=True)


def make_train_step(build_model, optimizer=None):
    """Returns (init_state, train_step); state = (model, optimizer).
    ``build_model()`` makes an unfilled ResNet (e.g. ``resnet18_ish``);
    the running statistics are the model's buffers, updated by each
    step's forward as flax's ``mutable=["batch_stats"]`` returns them."""
    make_optimizer = optimizer or sgd

    def init_state(seed=0, model=None):
        if model is None:
            model = init_params(build_model(), seed=seed)
        return model, make_optimizer(model.parameters())

    def train_step(state, batch):
        model, opt = state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return state, loss.detach()

    return init_state, train_step
