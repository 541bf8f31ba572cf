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

and :mod:`.hbm`, the HBM occupancy model (``--chip-accounting``),
adapted: its item sizes come from the port config's ``torch_dtype``.

Not ported yet (ROADMAP.md): the fleet-level modules ``capacity``,
``journey``, ``postmortem``, ``baseline`` and the ``merge`` CLI, the
link metrics of multi-GPU serving, and ``faults/reactor.FleetReactor``.
"""
