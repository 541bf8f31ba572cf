# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Single-card node qualification, the port of the JAX package's
``collectives`` subpackage on one GPU:

  cards.py         the cards' nominal peaks (the counterpart of
                   ``topology/slice.GENERATIONS``)
  device_bench.py  the single-chip rows: bf16 and int8 matmul, HBM
                   patterns, decode, prefill, the serving engines, long
                   flash attention, train-step MFU

Not ported yet (ROADMAP.md, multi-GPU): the collective sweep
(``bench.py``), its CLI (``__main__.py``) and the NCCL environment
profiles (``env_profiles.py``).
"""
