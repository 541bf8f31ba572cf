# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Span tracer: contextvar-nested, thread-aware, zero-cost when off.

Copy of ``container_engine_accelerators_tpu/obs/trace.py``, its imports
rewritten to the port's package; the contracts are the same.

One process-wide ``Tracer`` (installed with :func:`configure`) records
complete spans — name, start, duration, track, attributes — and exports
them two ways:

  * :meth:`Tracer.write_chrome` — Chrome trace-event JSON (``ph: "X"``
    complete events), loadable in Perfetto / ``chrome://tracing``. The
    root metadata records the wall-clock epoch of t=0, so a trace can be
    aligned against an xprof capture taken in the same run (both clocks
    are derived from the host monotonic clock; match the epochs).
  * :meth:`Tracer.write_jsonl` — one JSON object per span per line, with
    the parent span name resolved (for grep/jq pipelines). The first
    line is a ``__trace_meta__`` record carrying host + epoch, which the
    fleet merger (``obs/fleet.py``) uses to place per-host files on one
    wall clock.

Nesting uses a ``contextvars.ContextVar`` so it is correct per-thread
(and across ``asyncio`` tasks, though the stack doesn't use them): each
thread gets its own span stack and its own track in the Chrome view.
Async lifecycles that don't fit a ``with`` block (a serving request whose
phases happen on the engine thread) record explicit complete spans via
:meth:`Tracer.add_event` on a *synthetic* track (any string), so one
request's queue/admit/prefill/decode spans nest on one timeline row.

When no tracer is configured, :func:`span` hands back a shared no-op
context manager and :func:`event` returns immediately — no allocation,
no locking, no timestamps.
"""

import contextvars
import json
import os
import socket
import threading
import time

_current = contextvars.ContextVar("obs_trace_span", default=None)

_tracer = None
_tracer_lock = threading.Lock()

# First line of every JSONL export: host + epoch metadata, so the fleet
# merger (obs/fleet.py) can place this file's spans on the wall clock and
# attribute them to a host without out-of-band context.
JSONL_META_NAME = "__trace_meta__"

DROPPED_COUNTER_NAME = "tpu_trace_dropped_events_total"

_dropped_counter = None
_dropped_lock = threading.Lock()


def _note_dropped():
    """Count a dropped span in the process metrics registry, so a
    truncated trace is visible in a scrape — not only in the trace
    file's own metadata (which nobody reads until it's too late).
    Creation is locked: concurrent first-drops from two recording
    threads must not race the check-then-register."""
    global _dropped_counter
    if _dropped_counter is None:
        from container_engine_accelerators_tpu_torch.obs import (
            metrics as obs_metrics,
        )

        with _dropped_lock:
            if _dropped_counter is None:
                _dropped_counter = obs_metrics.get_or_create(
                    obs_metrics.Counter,
                    DROPPED_COUNTER_NAME,
                    "Spans dropped after the tracer's max_events cap "
                    "(the exported trace kept the run's head)",
                )
    _dropped_counter.inc()


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):  # parity with _LiveSpan
        return self


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """An open span: records itself into the tracer on __exit__."""

    __slots__ = ("tracer", "name", "attrs", "t0", "parent", "_token")

    def __init__(self, tracer, name, attrs):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = None
        self.parent = None
        self._token = None

    def set(self, **attrs):
        """Attach attributes after entry (e.g. a result computed inside)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self.parent = _current.get()
        self._token = _current.set(self)
        self.t0 = self.tracer.now()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = self.tracer.now()
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.tracer.add_event(
            self.name, self.t0, end - self.t0,
            parent=self.parent.name if self.parent is not None else None,
            **self.attrs,
        )
        return False


# Default event cap: a long-lived daemon traced with --trace-out must
# not grow without bound (each event is a small dict; 500k ≈ low hundreds
# of MB worst case). Past the cap new events are counted but dropped —
# the trace keeps the RUN'S HEAD, and the export metadata reports the
# drop count so a truncated trace is never mistaken for a complete one.
DEFAULT_MAX_EVENTS = 500_000


class Tracer:
    """Collects complete spans; thread-safe; export-only (no sampling).
    Bounded: at most ``max_events`` spans are kept (see
    DEFAULT_MAX_EVENTS); ``dropped`` counts the overflow."""

    def __init__(self, max_events=DEFAULT_MAX_EVENTS):
        self._events = []
        self.max_events = max_events
        self.dropped = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # Wall-clock epoch of t=0, for aligning with xprof captures and
        # for the fleet merger's cross-host skew correction.
        self.epoch_ns = time.time_ns()
        self.pid = os.getpid()
        self.host = os.environ.get("HOSTNAME") or socket.gethostname()
        # Synthetic track name -> allocated tid (real thread idents are
        # large; synthetic tracks get small negative ids so they sort
        # first in Perfetto and can't collide with OS thread ids).
        self._tracks = {}

    def now(self):
        """Seconds since tracer start (monotonic)."""
        return time.perf_counter() - self._t0

    def _tid_for(self, track):
        if track is None:
            return threading.get_ident()
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = -(len(self._tracks) + 1)
                self._tracks[track] = tid
            return tid

    def add_event(self, name, start_s, dur_s, track=None, parent=None,
                  **attrs):
        """Record one complete span.

        ``track=None`` files it under the calling thread; a string files
        it under a named synthetic track (one timeline row in Perfetto).
        """
        ev = {
            "name": name,
            "ts": start_s,
            "dur": max(dur_s, 0.0),
            "tid": self._tid_for(track),
            "thread": track or threading.current_thread().name,
            "parent": parent,
            "args": attrs,
        }
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                dropped = True
            else:
                self._events.append(ev)
                dropped = False
        if dropped:
            _note_dropped()

    def span(self, name, **attrs):
        return _LiveSpan(self, name, attrs)

    def events(self):
        with self._lock:
            return list(self._events)

    # -- exporters ------------------------------------------------------------

    def to_chrome(self):
        """Chrome trace-event JSON object (ph "X" complete events)."""
        events = [{
            "name": "process_name",
            "ph": "M",
            "pid": self.pid,
            "tid": 0,
            "args": {"name": "tpu-workload",
                     "host": self.host,
                     "epoch_ns": self.epoch_ns,
                     "dropped_events": self.dropped},
        }]
        named = {}
        for ev in self.events():
            named.setdefault(ev["tid"], ev["thread"])
        for tid, label in sorted(named.items()):
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": self.pid,
                "tid": tid,
                "args": {"name": label},
            })
        for ev in self.events():
            args = dict(ev["args"])
            if ev["parent"]:
                args["parent"] = ev["parent"]
            events.append({
                "name": ev["name"],
                "ph": "X",
                "ts": round(ev["ts"] * 1e6, 3),
                "dur": round(ev["dur"] * 1e6, 3),
                "pid": self.pid,
                "tid": ev["tid"],
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def write_jsonl(self, path):
        with open(path, "w") as f:
            # Leading metadata record (same "name" key shape as span
            # lines, so line-by-line consumers need no special case):
            # the host + epoch the fleet merger aligns on.
            f.write(json.dumps({
                "name": JSONL_META_NAME,
                "host": self.host,
                "pid": self.pid,
                "epoch_ns": self.epoch_ns,
                "dropped_events": self.dropped,
            }) + "\n")
            for ev in self.events():
                f.write(json.dumps({
                    "name": ev["name"],
                    "start_s": round(ev["ts"], 6),
                    "dur_s": round(ev["dur"], 6),
                    "thread": ev["thread"],
                    "parent": ev["parent"],
                    **ev["args"],
                }) + "\n")


def configure(enabled=True, max_events=DEFAULT_MAX_EVENTS):
    """Install (or tear down) the process-wide tracer; returns it."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer(max_events=max_events) if enabled else None
        return _tracer


def get():
    """The installed tracer, or None when tracing is off."""
    return _tracer


def enabled():
    return _tracer is not None


def span(name, **attrs):
    """Context manager timing a nested span; free no-op when disabled."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def event(name, start_s, dur_s, track=None, **attrs):
    """Record an explicit complete span (async lifecycles, synthetic
    tracks); no-op when disabled. ``start_s`` is in tracer time
    (:func:`now`)."""
    t = _tracer
    if t is None:
        return
    t.add_event(name, start_s, dur_s, track=track, **attrs)


def now():
    """Tracer-relative timestamp, or perf_counter seconds when disabled
    (still monotonic, so durations computed from it stay correct)."""
    t = _tracer
    if t is None:
        return time.perf_counter()
    return t.now()


# -- W3C trace-context propagation (cross-process request identity) -----------
#
# The fleet router mints a trace context at ingress and carries it on
# every dispatch / hedge arm / re-issue / KV-handoff call; serve_cli
# adopts the inbound context as the parent of its request span track.
# The wire form is the W3C ``traceparent`` header:
#
#     00-<32 hex trace_id>-<16 hex span_id>-<2 hex flags>
#
# (flags bit 0 = sampled). These helpers are allocation-bearing by
# design — id generation and formatting — so callers MUST only reach
# them when tracing is armed (an inbound context exists or head
# sampling selected the request). The analyzer's zero-cost-hook pass
# registers them as hooks: their call-site arguments are checked for
# disarmed-path allocations like any other tracing hook.

TRACEPARENT_VERSION = "00"
TRACE_FLAG_SAMPLED = 0x01


def new_trace_id():
    """Random non-zero 128-bit trace id as 32 lowercase hex chars."""
    tid = os.urandom(16).hex()
    while int(tid, 16) == 0:  # pragma: no cover - 2^-128 chance
        tid = os.urandom(16).hex()
    return tid


def new_span_id():
    """Random non-zero 64-bit span id as 16 lowercase hex chars."""
    sid = os.urandom(8).hex()
    while int(sid, 16) == 0:  # pragma: no cover - 2^-64 chance
        sid = os.urandom(8).hex()
    return sid


def format_traceparent(trace_id, span_id, sampled=True):
    """Serialize a context to the ``traceparent`` wire form."""
    flags = "01" if sampled else "00"
    return f"{TRACEPARENT_VERSION}-{trace_id}-{span_id}-{flags}"


def parse_traceparent(header):
    """``(trace_id, span_id, sampled)`` from a ``traceparent`` value,
    or None for anything malformed (bad field widths, non-hex, the
    forbidden all-zero ids, version ``ff``). Unknown future versions
    are accepted per the W3C spec — the first four fields keep their
    meaning."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[:4]
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
        return None
    try:
        tid = int(trace_id, 16)
        sid = int(span_id, 16)
        fl = int(flags, 16)
    except ValueError:
        return None
    if tid == 0 or sid == 0:
        return None
    return trace_id, span_id, bool(fl & TRACE_FLAG_SAMPLED)
