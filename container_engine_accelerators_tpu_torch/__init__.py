# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch/CUDA port of the compute half of the stack, for NVIDIA Hopper.

Sits beside ``container_engine_accelerators_tpu`` (the JAX reference) and
mirrors its module and function names, so each port function has an
obvious counterpart. The port imports ``torch`` and nothing of JAX or of
the JAX package; what it needs from there is copied.

  ops/attention.py       flash-attention forward (hand-written CUDA kernel
                         in ops/csrc/flash_fwd.cu) + its plain versions
  models/transformer.py  Llama-style decoder, dense KV cache, generate()
  models/serving_graphs.py  the serving decode as CUDA graphs per bucket
  models/weights.py      bridge from the JAX parameter pytree (tests)
  models/serve_cli.py    HTTP serving daemon (/generate, /healthz,
                         /metrics, /debug/flight)
  models/train_cli.py    synthetic-data training of every --model
                         (bert.py, mnist.py, resnet.py, the transformer)
                         with resume, the supervisor and fault plans
  parallel/moe.py        the mixture-of-experts FFN (one device)
  obs/                   metrics, events, spans, the device-time ledger,
                         the HBM model, the flight recorder, alert rules,
                         the goodput ledger
  utils/checkpointing.py step_<N>/ checkpoints, crash-safe resume
  utils/profiling.py     --profile-dir's torch.profiler bracket
  warmstart/warmup.py    the shape grid run before ready (--warmup=all)

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU and no such request they raise.
"""
