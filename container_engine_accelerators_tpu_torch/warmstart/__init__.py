# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Warm start, port of the JAX package's ``warmstart``:

  * :mod:`.cache` — the persistent compile cache (``--compile-cache-dir``):
    the kernel builds (nvcc libraries, Triton specialisations) keyed by
    topology, config and shape buckets, with hit/miss counters;
  * :mod:`.warmup` — the serving engine's shape grid run before
    ``/healthz`` flips ready.

``faults/storm.py`` is the acceptance drill: K kill/resume cycles must
charge compile badput once per binary, not once per restart.
"""
