# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Synthetic-data training CLI, PyTorch port of the transformer path of
``container_engine_accelerators_tpu/models/train_cli.py``.

Single device (no mesh): ``run_transformer`` builds the config from the
same flags as the JAX CLI, draws one batch of random tokens per step
from a numpy generator seeded with ``seed + 1 + step``, runs
``transformer.make_train_step`` (AdamW, per-layer remat, the flash
kernels on CUDA) and prints one JSON line with the JAX CLI's result
keys. The other models (mnist, resnet, bert) are not ported yet.

  python -m container_engine_accelerators_tpu_torch.models.train_cli \\
      --model transformer --steps 5

Not ported yet (ROADMAP.md): checkpoint and resume, the supervisor and
step watchdog, fault plans, and the metrics, trace, event-log and flight
recorder surfaces.
"""

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.models import transformer as tf

log = logging.getLogger("train_cli")

# The card the port targets and its dense bf16 tensor-core peak (NVIDIA's
# H100 SXM data sheet); est_mfu is 0 on any other card and on the CPU.
PEAK_CARD = "NVIDIA H100 80GB HBM3"
PEAK_BF16_FLOPS = 989e12


def _train_steps(args, init_state, train_step, make_batch, tokens_per_step,
                 device):
    """The step loop: init, run to --steps, return the result dict with
    the JAX CLI's numbers: ``units_per_s`` (tokens) and ``est_mfu`` of the
    last step, ``mean_step_s`` over all steps. Each step's time is host
    wall clock ending in the loss read, which waits for the device."""
    state = init_state(args.seed)
    n_params = sum(p.numel() for p in state[0].parameters())
    on_card = (device.type == "cuda"
               and torch.cuda.get_device_name(device) == PEAK_CARD)
    peak = PEAK_BF16_FLOPS if on_card else 0.0
    losses, step_s = [], []
    for step in range(args.steps):
        batch = make_batch(step)
        t0 = time.perf_counter()
        state, loss = train_step(state, batch)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        log.info("step %d loss %.4f (%.0f tok/s)", step, losses[-1],
                 tokens_per_step / step_s[-1])
    last = step_s[-1] if step_s else 0.0
    # 6*N*D: the dense-transformer FLOPs/token estimate.
    mfu = 6.0 * n_params * tokens_per_step / last / peak if peak and last \
        else 0.0
    return {
        "loss": losses[-1] if losses else None,
        "start_step": 0,
        "steps_run": len(losses),
        "units_per_s": round(tokens_per_step / last, 2) if last else 0.0,
        "mean_step_s": round(sum(step_s) / len(step_s), 5) if step_s
        else None,
        "est_mfu": round(mfu, 5),
    }


def config_from_args(args):
    return tf.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=max(args.n_heads // 2, 1),
        d_ff=args.d_model * 3,
        max_seq_len=args.seq_len,
        dtype=args.dtype,
    )


def run_transformer(args, device):
    cfg = config_from_args(args)
    init_state, train_step = tf.make_train_step(cfg, device=device)
    batch_size = args.batch_size or 2

    def make_batch(step):
        rng = np.random.default_rng(args.seed + 1 + step)
        tokens = rng.integers(0, cfg.vocab_size,
                              (batch_size, args.seq_len + 1))
        return {"tokens": torch.as_tensor(tokens, device=device)}

    result = _train_steps(args, init_state, train_step, make_batch,
                          batch_size * args.seq_len, device)
    return {**result, "batch_size": batch_size}


def _not_ported(name):
    def run(args, device):
        raise NotImplementedError(
            f"--model {name} is not ported yet (ROADMAP.md); the port "
            f"trains --model transformer"
        )
    return run


RUNNERS = {
    "bert": _not_ported("bert"),
    "mnist": _not_ported("mnist"),
    "resnet": _not_ported("resnet"),
    "transformer": run_transformer,
}


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=sorted(RUNNERS), default="mnist")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=0,
                   help="global batch; 0 = 2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--vocab-size", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions (tests). Without a GPU the default fails.")
    args = p.parse_args(argv)
    device = tf.resolve_device(args.device)
    log.info("device=%s", device)
    t0 = time.perf_counter()
    result = RUNNERS[args.model](args, device)
    result.update(
        model=args.model,
        steps=args.steps,
        n_devices=1,
        wall_s=round(time.perf_counter() - t0, 2),
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
