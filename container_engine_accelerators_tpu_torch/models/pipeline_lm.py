# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Pipeline-parallel training of the decoder (1F1B over its layers).

Port of ``container_engine_accelerators_tpu/models/pipeline_lm.py``. The
layer stack splits into N contiguous stages (stage i holds layers
[i·L/N, (i+1)·L/N) of ``model.layers``); the embedding lookup runs
upstream of the pipeline on stage 0, and the tied LM head and final
norm ride the schedule as ``loss_params`` on the last stage
(``parallel/pipeline.py``'s ``pipeline_train_1f1b``). The embedding's
gradient has two parts, summed here: the head use (the pipeline's
loss-parameter gradient) and the lookup use (the pipeline's input
cotangent, every rank's, ``index_add``ed into the vocabulary rows the
tokens name). Every rank then steps the same ``embed`` and ``ln_f``.

Attention in a stage is ``transformer._flash_attend`` (the flash kernels
on CUDA tensors, their plain versions on CPU ones) at positions
``arange(S)``; a stage runs no per-layer remat, since the schedule
already recomputes the whole stage at its backward tick.
"""

import dataclasses

import torch
from torch import nn

from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.parallel.pipeline import (
    pipeline_train_1f1b,
)


def split_params(model, n_stages):
    """Transformer → (stages, loss_params): ``stages[i]`` an
    ``nn.ModuleList`` of the model's own layers [i·L/N, (i+1)·L/N), and
    ``loss_params`` = {"embed", "ln_f"} (the model's parameters, which
    the lookup upstream also reads). Nothing is copied."""
    cfg = model.cfg
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} must divide over {n_stages} stages")
    per = cfg.n_layers // n_stages
    stages = [nn.ModuleList(model.layers[i * per:(i + 1) * per])
              for i in range(n_stages)]
    return stages, {"embed": model.embed, "ln_f": model.ln_f.weight}


def merge_params(stages, loss_params):
    """The inverse of :func:`split_params`: a Transformer over the same
    layer modules and parameters (checkpoint and serving interop)."""
    layers = [layer for stage in stages for layer in stage]
    cfg = dataclasses.replace(layers[0].attn.cfg, n_layers=len(layers))
    model = tf.Transformer(dataclasses.replace(cfg, n_layers=0), "meta")
    model.cfg = cfg
    model.layers = nn.ModuleList(layers)
    model.embed = _as_parameter(loss_params["embed"])
    model.ln_f.weight = _as_parameter(loss_params["ln_f"])
    return model


def _as_parameter(t):
    return t if isinstance(t, nn.Parameter) else nn.Parameter(t)


def _stage_fn(stage, x):
    """One pipeline stage: its layers on (mb, S, D) at positions
    ``arange(S)``."""
    batch, seq, _ = x.shape
    positions = torch.arange(seq, device=x.device).expand(batch, seq)
    for layer in stage:
        x, _, _ = layer(x, positions, tf._flash_attend)
    return x


def _loss_fn(y, targets, lp):
    """Final norm + tied LM head + next-token cross entropy on one
    microbatch."""
    return tf.softmax_xent(tf.lm_head(y, lp["ln_f"], lp["embed"]), targets)


def make_pp_train_step(cfg, transport, optimizer=None, device="cuda"):
    """Returns (init_state, train_step) for 1F1B pipeline training over
    ``transport`` (``parallel/ring_attention.py``'s ``P2P`` over the "pp"
    ring, one stage a process, or ``InProcess``, every stage here).

    ``init_state(seed=0, model=None)`` draws the whole model from the
    seed on ``device`` (the unsplit step's weights for the same seed) or
    takes ``model``, keeps the stages the transport holds and the loss
    params, and builds the optimizer (default ``transformer.adamw``) over
    them: state = (stages, loss_params, optimizer), ``stages`` an
    ``nn.ModuleList`` of the held stages, ``loss_params`` an
    ``nn.ParameterDict`` of "embed" and "ln_f". ``train_step(state,
    batch)`` takes ``batch = {"tokens": (M, mb, S+1)}`` (M microbatches
    of mb sequences) and returns (state, loss); after it each parameter's
    ``.grad`` holds the step's gradient. MoE configs are refused."""
    if cfg.n_experts:
        raise ValueError("pipeline_lm supports dense FFN configs only")
    device = tf.resolve_device(device)
    make_optimizer = optimizer or tf.adamw

    def init_state(seed=0, model=None):
        if model is None:
            model = tf.init_params(cfg, device=device, seed=seed)
        tf._require_dense(model)
        stages, lp = split_params(model, transport.size)
        held = nn.ModuleList(stages[i] for i in transport.indices)
        loss_params = nn.ParameterDict(
            {"embed": lp["embed"], "ln_f": lp["ln_f"]})
        opt = make_optimizer(list(held.parameters())
                             + list(loss_params.parameters()))
        return held, loss_params, opt

    def train_step(state, batch):
        held, loss_params, opt = state
        embed = loss_params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=device)
        inputs, targets = tokens[..., :-1], tokens[..., 1:]
        micro = (*inputs.shape, embed.shape[1])
        if 0 in transport.indices:
            with torch.no_grad():
                x_micro = embed[inputs]
        else:
            x_micro = torch.empty(micro, dtype=embed.dtype, device="meta")
        loss, sgrads, lp_grads, dx = pipeline_train_1f1b(
            _stage_fn, _loss_fn, list(held), x_micro, targets, transport,
            loss_params=dict(loss_params), return_dx=True)
        # Tied embedding: the head's gradient (from the last stage) plus
        # the lookup's (the pipeline's input cotangent into the rows the
        # tokens name), summed in f32 and cast once.
        lookup = torch.zeros(embed.shape, dtype=torch.float32,
                             device=embed.device)
        lookup.index_add_(0, inputs.reshape(-1),
                          dx.reshape(-1, embed.shape[1]).float())
        lp_grads["embed"] = (lp_grads["embed"].float() + lookup).to(
            embed.dtype)
        for stage, grads in zip(held, sgrads):
            for p, g in zip(stage.parameters(), grads):
                p.grad = g
        for name, p in loss_params.items():
            p.grad = lp_grads[name]
        opt.step()
        return state, loss

    return init_state, train_step
