# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Warm start of the serving engine: :mod:`.warmup`, the port of the JAX
``warmstart/warmup.py`` (the shape grid run before ``/healthz`` flips
ready). The JAX persistent compile cache (``warmstart/cache.py``) has no
counterpart: the CUDA kernels are built once into ``.torch_ext/``."""
