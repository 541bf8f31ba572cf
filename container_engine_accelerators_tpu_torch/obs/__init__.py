# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Observability for the port's serving engine and training loop.

Copies of the JAX package's stdlib-only ``obs`` modules (that package's
``__init__`` pulls in more than these):

  * :mod:`.metrics` — Counter/Gauge/Histogram registry with Prometheus
    text exposition; a ``ContinuousEngine`` keeps its instruments on a
    registry of its own, and ``serve_cli`` serves it on ``/metrics``;
  * :mod:`.events` — the structured event stream (JSONL sink, bounded
    ring, per-kind counters) the engine and the fault plan emit on;
  * :mod:`.ports` — the stack's metrics-port assignments;
  * :mod:`.trace` — the span tracer (``--trace-out``), W3C
    ``traceparent`` parsing, Chrome trace-event and JSONL export;
  * :mod:`.devicetime` — the device-time ledger (``--chip-accounting``):
    each dispatch's wall split pro rata over the rows it served, bubbles
    between dispatches, per-class shares;
  * :mod:`.flight` — the flight recorder (``--flight-recorder``) and its
    postmortem bundles;
  * :mod:`.alerts` — multi-window burn-rate alert rules
    (``--alert-rules``);
  * :mod:`.goodput` — the goodput ledger over an event log
    (``train_cli --event-log``'s ``goodput`` block), with :mod:`.fleet`,
    the per-host span-trace loaders it reads;
  * :mod:`.journey` — the request-journey stitcher (trace id →
    waterfall and the stage to blame) that ``fleet/journeydrill.py``
    judges with;

and :mod:`.hbm`, the HBM occupancy model (``--chip-accounting``),
adapted: its item sizes come from the port config's ``torch_dtype``, and
:mod:`.collective`, the collective and device-bench gauges
(``collectives/device_bench.py`` records its rows there once configured).

The port's fleet tier (``fleet/router.py``, ``fleet/autoscaler.py``,
``fleet/sim.py``, ``fleet/journeydrill.py``) emits and evaluates on
these copies.

:mod:`.postmortem`, the flight bundles' analyzer, is copied for the
port's flight drill (``fleet/flightdrill.py``). The JAX package's
jax-free reader ``capacity`` reads the port's event logs as they are
(its ``journey`` too; tests/test_torch_journey.py), so it is not
copied. :mod:`.baseline` is copied for the hostbench's
``--fingerprint-out``; the JAX package's ``merge`` CLI imports no JAX
and merges the port's trace files as they are (``obs/fleet.py``). The
lockstep engine link of tensor-parallel serving
(``models/serve_cli.py``) keeps its ``tpu_serving_link_*`` families on
the engine's registry and its ``link_wedged`` / ``link_desync`` events
on the engine's stream.
"""
