# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Unified structured event stream: one record schema for the whole stack.

Copy of ``container_engine_accelerators_tpu/obs/events.py``, its imports
rewritten to the port's package; the contracts are the same.

The reference stack's signature observability feature is its health
pipeline — NVML Xid events become device-state flips that monitoring can
see. Before this module, our equivalents were scattered: the health
checker logged transitions as free text, the scheduler had a private
open/append JSONL writer, and the interconnect exporter only moved
gauges. ``EventStream`` is the one event pipeline all three now share:

  * **Schema** — every record is one flat JSON object:
    ``{ts, host, source, kind, severity, **attrs}``. ``ts`` is wall-clock
    epoch seconds (fleet tools correlate across hosts), ``host`` is this
    machine's identity, ``source`` names the emitting component
    (``deviceplugin.health``, ``scheduler``, ``tpumetrics.exporter``,
    ``train``…), ``kind`` is the event type within the source, and
    ``severity`` is one of :data:`SEVERITIES`.
  * **JSONL sink** — ``sink_path`` appends one line per event (the
    scheduler's ``--event-log`` contract, now shared). Write failures
    are logged, never raised: telemetry must not take down the daemon.
  * **Bounded ring buffer** — the last ``ring`` events stay queryable
    in-process (:meth:`EventStream.events`/:meth:`tail`) without any
    sink configured, so tests and debug endpoints see recent history
    with bounded memory.
  * **Per-kind counters** — when a metrics registry is attached, every
    emit increments ``tpu_obs_events_total{source,kind,severity}``, so
    a scrape sees event *rates* (health flaps, bind failures, error
    threshold crossings) even when nobody tails the JSONL.

Renaming the ``kind`` key: a component that predates this schema and has
an on-disk contract to keep (the scheduler's records use ``event``) can
pass ``kind_key`` so its existing jq/grep pipelines keep working; the
rest of the schema rides along additively.
"""

import collections
import json
import logging
import os
import socket
import threading
import time

from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

SEVERITIES = ("debug", "info", "warning", "error")

# Default ring capacity: enough for a post-mortem tail (a health flap, the
# scheduler passes around a failure) at a few hundred bytes per record.
DEFAULT_RING = 4096

EVENTS_COUNTER_NAME = "tpu_obs_events_total"

# Env fallbacks for slice/worker identity (the scheduler's worker-identity
# contract + the GKE multislice contract) — see host_identity().
_WORKER_ID_ENV = "TPU_WORKER_ID"
_SLICE_ENVS = ("TPU_SLICE_NAME", "MEGASCALE_SLICE_ID")
_HOST_COORDS_ENV = "TPU_HOST_COORDS"


def host_identity(env=None):
    """This process's fleet coordinates: ``{host, slice, worker_id,
    coords}`` (empty strings when unknown).

    ``host`` is the node identity every event/metric is tagged with;
    slice/worker/coords come from the env contract the gang scheduler
    stamps (``TPU_WORKER_ID``) and the multislice runtime provides
    (``MEGASCALE_SLICE_ID``), with ``TPU_SLICE_NAME``/``TPU_HOST_COORDS``
    as explicit overrides (the downward-API path for the node labels in
    ``topology/labels.py``)."""
    env = os.environ if env is None else env
    slice_name = ""
    for key in _SLICE_ENVS:
        if env.get(key):
            slice_name = env[key]
            break
    return {
        "host": env.get("HOSTNAME") or socket.gethostname(),
        "slice": slice_name,
        "worker_id": env.get(_WORKER_ID_ENV, ""),
        "coords": env.get(_HOST_COORDS_ENV, ""),
    }


def _events_counter(registry):
    """The shared per-kind counter in ``registry`` (created on first use;
    reused so several streams can share one registry without a duplicate
    registration error)."""
    return obs_metrics.get_or_create(
        obs_metrics.Counter,
        EVENTS_COUNTER_NAME,
        "Structured events emitted, by source, kind, and severity",
        labelnames=("source", "kind", "severity"),
        registry=registry,
    )


class EventStream:
    """One component's handle on the unified event pipeline.

    Thread-safe. ``registry=None`` skips the counters (ring + sink only
    — e.g. inside a process whose metrics live in prometheus_client).
    """

    def __init__(self, source, sink_path="", ring=DEFAULT_RING,
                 registry=None, host=None, kind_key="kind",
                 clock=time.time):
        self.source = source
        self.sink_path = sink_path
        self.kind_key = kind_key
        self.host = host if host is not None else host_identity()["host"]
        self.registry = registry
        self._clock = clock
        self._ring = collections.deque(maxlen=ring)
        # Total events ever emitted (monotonic, unlike len(ring) which
        # pins at the ring capacity): consumers that poll the ring for
        # unread tails (faults/reactor.py) diff this to stay correct
        # after the ring starts rotating.
        self.emitted = 0
        self._lock = threading.Lock()
        # Lazily-opened persistent append handle: emit sits on per-step
        # and per-request paths now, so an open/close per event would be
        # two syscalls of pure overhead per record. The sink has its OWN
        # lock: it exists to keep JSONL lines atomic across emitting
        # threads, and holding the ring lock across a disk write would
        # make every ring reader (the reactor's poll loop) wait out the
        # flush (the lock-discipline contract, enforced by the static
        # analyzer).
        self._sink = None
        self._sink_lock = threading.Lock()
        self._counter = (
            _events_counter(registry) if registry is not None else None
        )

    def emit(self, kind, severity="info", **attrs):
        """Record one event; returns the record dict.

        ``attrs`` land flat in the record (greppable/jq-able without a
        nested envelope); they must not collide with the schema keys."""
        if severity not in SEVERITIES:
            raise ValueError(
                f"severity {severity!r} not in {SEVERITIES}"
            )
        rec = {
            "ts": self._clock(),
            "host": self.host,
            "source": self.source,
            self.kind_key: kind,
            "severity": severity,
            **attrs,
        }
        with self._lock:
            self._ring.append(rec)
            self.emitted += 1
        if self._counter is not None:
            self._counter.labels(self.source, kind, severity).inc()
        if self.sink_path:
            try:
                with self._sink_lock:
                    if self._sink is None:
                        self._sink = open(self.sink_path, "a")
                    self._sink.write(
                        json.dumps(rec, default=str) + "\n"
                    )
                    self._sink.flush()
            except OSError:
                log.exception(
                    "event sink write failed (%s)", self.sink_path
                )
        return rec

    def close(self):
        """Close the sink handle (daemon shutdown); further emits
        reopen it."""
        with self._sink_lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:  # pragma: no cover - best-effort close
                    pass
                self._sink = None

    def events(self, kind=None):
        """Snapshot of the ring, optionally filtered by kind."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e.get(self.kind_key) == kind]
        return out

    def tail(self, n=20):
        with self._lock:
            return list(self._ring)[-n:]


def follow_jsonl(path, poll_s=1.0, stop=None, sleep=time.sleep, offset=0):
    """Yield records appended to a JSONL event log from byte ``offset``
    on, forever (or until ``stop()`` is truthy).

    Binary reads with a byte offset: a text-mode character count would
    desync ``seek`` on the first multi-byte character in an event.
    **Truncation/rotation-safe**: the cursor resets to 0 — instead of
    seeking past EOF (or mid-record) and silently losing events — when
    the file shrinks below the tracked offset (logrotate copytruncate,
    a restarted emitter re-creating its sink), when its inode changes
    between polls (rotate-and-recreate — the new file may already have
    grown past the stale offset by the next poll, so size alone cannot
    catch it), or when the byte before the offset is no longer a
    newline (recreate that REUSED the inode, e.g. on tmpfs: a valid
    resume offset always sits just after a record's ``\\n``). Load-
    bearing now that the fleet router tails every replica's event log
    for rotation-steering signals. Callers resuming a restarted
    reactor get their offset from ``FleetReactor.replay`` (history is
    coalesced, not re-acted)."""
    inode = None
    while not (stop and stop()):
        try:
            with open(path, "rb") as f:
                st = os.fstat(f.fileno())
                why = None
                if st.st_size < offset:
                    why = "shrunk below offset"
                elif inode is not None and st.st_ino != inode:
                    why = "new inode"
                elif offset:
                    f.seek(offset - 1)
                    if f.read(1) != b"\n":
                        why = "offset no longer on a record boundary"
                inode = st.st_ino
                if why is not None:
                    log.warning(
                        "event log %s truncated/rotated (%d bytes, "
                        "offset %d, %s); re-tailing from the top",
                        path, st.st_size, offset, why,
                    )
                    offset = 0
                f.seek(offset)
                for raw in f:
                    if not raw.endswith(b"\n"):
                        break  # partial trailing write; re-read next poll
                    offset += len(raw)
                    try:
                        yield json.loads(raw.decode("utf-8", "replace"))
                    except ValueError:
                        log.warning("skipping malformed event line")
        except OSError:
            pass  # file not there yet; keep waiting
        sleep(poll_s)


# -- process-wide default stream (the trace.configure pattern) ----------------

_stream = None
_stream_lock = threading.Lock()


def configure(source="process", sink_path="", ring=DEFAULT_RING,
              registry=None, enabled=True):
    """Install (or tear down) the process-wide stream; returns it."""
    global _stream
    with _stream_lock:
        _stream = (
            EventStream(source, sink_path=sink_path, ring=ring,
                        registry=registry)
            if enabled else None
        )
        return _stream


def get():
    """The installed stream, or None when events are off."""
    return _stream


def emit(kind, severity="info", **attrs):
    """Emit on the process-wide stream; free no-op when unconfigured."""
    s = _stream
    if s is None:
        return None
    return s.emit(kind, severity=severity, **attrs)
