# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Where the training time goes on the card: a torch.profiler breakdown.

    python -m container_engine_accelerators_tpu_torch.models.train_profile
    python -m container_engine_accelerators_tpu_torch.models.train_profile tp

Builds full-width Llama-3-8B cut to 8 layers (bf16, random weights from
seed 0, the shape chip_smoke.py's train phase times) on the GPU, runs one
warm-up step of ``make_train_step`` (AdamW, per-layer remat, B 1 at the
full 8192 context), then profiles one more step and prints one JSON line
as ``serve_profile`` does: host wall time, summed device (kernel) time,
the device's idle share, the ops with the most device time and the
device time by kind. Then the same for one step of BERT-large MLM at
full width and depth (B 8, S 512, bf16, ``bert.make_train_step``: AdamW,
no remat), chip_smoke.py's train_bert shape.

``tp``: instead, one step of each tensor-parallel path (``models/tp_lm.py``
ring, then off) at chip_smoke.py's tensor_parallel shape: 4 Llama-3-8B
layers, tp 4 with every rank in this process, B 1 × S 4096, bf16.
"""

import dataclasses
import sys

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.models import bert, tp_lm
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.models.serve_profile import (
    _profiled,
)
from container_engine_accelerators_tpu_torch.parallel import (
    tensor_parallel,
)


def main(n_layers=8, top=15):
    device = tf.resolve_device("cuda")
    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=n_layers)
    seq = cfg.max_seq_len
    init_state, train_step = tf.make_train_step(cfg, device=device)
    state = init_state(seed=0)
    rng = np.random.default_rng(1)
    batches = [
        {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, seq + 1)), device=device)}
        for _ in range(2)
    ]
    state, loss = train_step(state, batches[0])  # warm (kernel build)
    loss.item()

    def step():
        nonlocal state
        state, loss = train_step(state, batches[1])
        loss.item()

    _profiled(f"train_step_{n_layers}_layers_s{seq}", step, top)
    del state, init_state, train_step
    torch.cuda.empty_cache()
    _profile_bert(device, top)
    return 0


def _profile_bert(device, top, batch_size=8):
    cfg = bert.BertConfig.bert_large()
    init_state, train_step = bert.make_train_step(cfg, device=device)
    state = init_state(seed=0)
    rng = np.random.default_rng(1)
    batches = [bert.synthetic_mlm_batch(rng, batch_size, cfg, device=device)
               for _ in range(2)]
    state, loss = train_step(state, batches[0])  # warm
    loss.item()

    def step():
        nonlocal state
        state, loss = train_step(state, batches[1])
        loss.item()

    _profiled(f"bert_large_step_b{batch_size}_s{cfg.max_seq_len}", step, top)


def profile_tp(n_layers=4, tp=4, seq=4096, top=15):
    """One warm step, then one profiled step, of each tp path."""
    device = tf.resolve_device("cuda")
    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=n_layers)
    axes = tensor_parallel.Axes.in_process(tp=tp)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, seq + 1)), device=device)}
    for overlap in ("ring", "off"):
        init_state, train_step = tp_lm.make_train_step(
            cfg, axes, device=device, overlap=overlap)
        state = init_state(seed=0)
        state, loss = train_step(state, batch)  # warm
        loss.item()

        def step():
            nonlocal state
            state, loss = train_step(state, batch)
            loss.item()

        _profiled(f"tp_{overlap}_step_{n_layers}_layers_tp{tp}_s{seq}", step,
                  top)
        del state, init_state, train_step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(profile_tp() if sys.argv[1:] == ["tp"] else main())
