# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Observability for the port's serving engine.

Copies of the JAX package's stdlib-only ``obs`` modules (that package's
``__init__`` pulls in more than these):

  * :mod:`.metrics` — Counter/Gauge/Histogram registry with Prometheus
    text exposition; a ``ContinuousEngine`` keeps its instruments on a
    registry of its own;
  * :mod:`.events` — the structured event stream (JSONL sink, bounded
    ring, per-kind counters) the engine and the fault plan emit on;
  * :mod:`.ports` — the stack's metrics-port assignments.

``trace``, ``goodput``, ``alerts``, ``devicetime`` and the ``/metrics``
endpoint are not ported yet (ROADMAP.md).
"""
