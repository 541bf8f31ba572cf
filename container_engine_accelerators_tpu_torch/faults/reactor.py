# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The node-local serving reaction to a chip going Unhealthy.

Copy of ``ServingDrainer`` from
``container_engine_accelerators_tpu/faults/reactor.py`` (with the
``_unread_tail`` helper it polls through, and the ``HEALTHY`` /
``UNHEALTHY`` states of ``kubeletapi``). On a ``health_transition``
event to Unhealthy it drains the local ``ContinuousEngine``: in-flight
requests migrate off their slots and re-prefill on fresh ones instead
of riding a wedged chip to a timeout
(``tpu_serving_requests_migrated_total``). ``FleetReactor`` (cordon and
gang drain through the scheduler and the Kubernetes API) and the
reactor CLI are not ported yet (ROADMAP.md).
"""

# The device plugin's health states (kubeletapi's constants).
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


def _unread_tail(stream, seen):
    """The records emitted on ``stream`` since ``seen`` total emits.

    Diffs the stream's monotonic ``emitted`` counter, NOT the ring
    length: once the bounded ring fills, len(events()) pins at capacity
    while records rotate, and a length-based cursor would read an empty
    tail forever. Records that rotated out before this poll are gone
    (bounded memory is the ring's contract); the cursor still advances
    past them. Returns (new_records, new_seen)."""
    records = stream.events()
    total = getattr(stream, "emitted", None)
    if total is None:
        total = len(records)
    n = max(0, min(total - seen, len(records)))
    return (records[len(records) - n:] if n else []), total


class ServingDrainer:
    """Node-local serving reaction: drain the continuous engine when a
    chip this process serves on flips Unhealthy, so in-flight requests
    re-prefill on healthy slots instead of hanging on a wedged chip."""

    def __init__(self, engine):
        self.engine = engine
        self._seen = 0

    def process(self, record):
        kind = record.get("kind") or record.get("event")
        if kind != "health_transition" or record.get("to") != UNHEALTHY:
            return 0
        return self.engine.drain(
            reason=f"chip {record.get('tpu', '?')} unhealthy"
        )

    def poll(self, stream):
        new, self._seen = _unread_tail(stream, self._seen)
        return sum(self.process(r) for r in new)
