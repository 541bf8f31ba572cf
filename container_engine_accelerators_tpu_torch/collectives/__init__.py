# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Node qualification, the port of the JAX package's ``collectives``
subpackage:

  cards.py         the cards' nominal peaks and link ceiling (the
                   counterpart of ``topology/slice.GENERATIONS``)
  device_bench.py  the single-chip rows: bf16 and int8 matmul, HBM
                   patterns, decode, prefill, the serving engines, long
                   flash attention, train-step MFU
  bench.py         the collective sweep over ``torch.distributed`` (one
                   process per GPU, NCCL; gloo on the CPU)
  __main__.py      its CLI (``python -m
                   container_engine_accelerators_tpu_torch.collectives``)
  env_profiles.py  the NCCL/PyTorch environment profiles
"""
