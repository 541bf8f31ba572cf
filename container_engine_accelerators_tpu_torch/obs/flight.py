# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Always-on flight recorder: bounded delta snapshots, triggered dumps.

Copy of ``container_engine_accelerators_tpu/obs/flight.py``, its imports
rewritten to the port's package; the contracts are the same.

The stack can *detect* failure (link wedges, burn alerts, watchdog
fires) but the high-resolution state that explains it — the last seconds
of metric movement, the event tail, the in-flight request set — is gone
by the time an operator looks. The :class:`FlightRecorder` is the black
box that closes the gap:

  * **A bounded ring of delta snapshots.** Every ``interval_s`` (250ms
    by default, injectable clock) the recorder walks every watched
    metrics registry and records *changes only*: counter deltas,
    changed gauge samples, histogram bucket/sum deltas. An idle
    10k-series registry costs near-zero bytes per snapshot; memory is
    O(window), never O(runtime).
  * **Event + span fusion.** Each snapshot carries the unread tail of
    every watched :class:`~container_engine_accelerators_tpu_torch.obs.events
    .EventStream` (the ring + monotonic ``emitted`` cursor diff the
    fleet reactor uses) and the tracer's spans recorded since the last
    snapshot, so the timeline interleaves *what moved* with *what
    happened*.
  * **State providers.** Callables (an engine's ``stats()`` /
    ``kv_stats()``, tenant queue depths) sampled per snapshot — NOT at
    dump time — so the dump path never calls back into the host under
    a lock.
  * **Triggered postmortem bundles.** :func:`trigger` (armed hook sites:
    ``link_wedged``/``link_desync``, ``alert_fired``, the training
    watchdog, supervisor restarts, crash hooks, ``POST /debug/flight``
    / SIGUSR2) dumps the ring as a self-contained JSONL bundle,
    rate-limited and deduped per trigger kind, then emits
    ``flight_dump{trigger,path,snapshots}`` and bumps
    ``tpu_flight_dumps_total{trigger}`` (served on
    ``obs.ports.FLIGHT_PORT`` when armed via ``--flight-recorder``).
    ``python -m …obs.postmortem bundle.jsonl`` turns a bundle into a
    first-anomaly attribution report.

Zero-cost when disarmed: every hook site is one module-global
``is None`` check (the ``faults.tick`` contract, enforced by the
zero-cost analyzer pass), and trigger-site arguments never allocate.

Lock discipline: a snapshot briefly takes each instrument's child lock
(the same locks every ``inc()`` takes) from the recorder's own thread.
The *dump* path serializes already-captured plain dicts and writes one
file — it takes no metrics lock at all — so a crash dump fired from a
signal handler cannot deadlock against whatever the interrupted thread
was holding (``snapshot=False`` skips the final ring snapshot for
exactly that path; see tests/test_flight.py).
"""

import collections
import json
import logging
import os
import threading
import time

from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.obs import ports as obs_ports

log = logging.getLogger(__name__)

EVENT_SOURCE = "flight"

DUMPS_COUNTER_NAME = "tpu_flight_dumps_total"
DROPPED_COUNTER_NAME = "tpu_flight_dropped_snapshots_total"

DEFAULT_INTERVAL_S = 0.25
DEFAULT_WINDOW_S = 30.0
# Spans kept per snapshot (a tracer burst must not blow the ring's
# O(window) bound).
MAX_SPANS_PER_SNAPSHOT = 256
# Events kept per snapshot, same bound.
MAX_EVENTS_PER_SNAPSHOT = 512
# Per-trigger-kind dedup: a wedge cascade (one event per rank) must
# produce ONE bundle, not one per event.
DEFAULT_DEDUP_S = 30.0
# Hard cap on bundles per recorder lifetime (a crash-looping trigger
# must not fill the disk).
DEFAULT_MAX_DUMPS = 32

BUNDLE_VERSION = 1


def series_key(name, labelnames, values):
    """The bundle's stable series id: ``name{k=v,...}`` in labelnames
    order (no quoting — bundle keys are ids, not Prometheus text)."""
    if not labelnames:
        return name
    inner = ",".join(f"{k}={v}" for k, v in zip(labelnames, values))
    return name + "{" + inner + "}"


def _unread_tail(stream, seen):
    """Unread ring tail of ``stream`` after cursor ``seen`` (the
    reactor's poll-diff pattern); returns ``(records, new_cursor)``."""
    records = stream.events()
    emitted = stream.emitted
    fresh = emitted - seen
    if fresh <= 0:
        return [], emitted
    return records[-min(fresh, len(records)):], emitted


class FlightRecorder:
    """Per-host black box over a set of registries/streams/providers.

    ``clock`` is the snapshot/ dedup timebase (monotonic seconds;
    injectable for deterministic drills), ``wall_clock`` stamps bundle
    records with epoch seconds for cross-host correlation. The
    recorder's own instruments live in its private ``registry`` (serve
    it on :data:`obs.ports.FLIGHT_PORT` via :func:`wire_from_flags`)
    so a crash dump never touches a lock the host workload holds."""

    def __init__(self, dirpath, window_s=DEFAULT_WINDOW_S,
                 interval_s=DEFAULT_INTERVAL_S, clock=time.monotonic,
                 wall_clock=time.time, host=None,
                 dedup_s=None, max_dumps=DEFAULT_MAX_DUMPS,
                 sink_path=""):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.dirpath = dirpath
        self.window_s = float(window_s)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._wall = wall_clock
        self.dedup_s = (
            float(dedup_s) if dedup_s is not None else DEFAULT_DEDUP_S
        )
        self.max_dumps = int(max_dumps)
        depth = max(2, int(round(self.window_s / self.interval_s)))
        self._ring = collections.deque(maxlen=depth)
        self._ring_lock = threading.Lock()
        self._registries = []     # (name, Registry)
        self._streams = []        # [stream]; cursors in _cursors
        self._cursors = {}        # id(stream) -> emitted cursor
        self._tracer = None
        self._spans_seen = 0
        self._providers = []      # (name, fn)
        self._last = {}           # series key -> last counter/bucket value
        self._last_ts = None      # clock() of the last snapshot
        self._dump_lock = threading.Lock()
        self._last_dump = {}      # trigger kind -> clock() of last bundle
        self._dump_seq = 0
        self.last_bundle = None
        self._thread = None
        self._stop = threading.Event()
        self.registry = obs_metrics.Registry()
        self.events = obs_events.EventStream(
            EVENT_SOURCE, sink_path=sink_path, registry=self.registry,
            host=host,
        )
        self._m_dumps = obs_metrics.Counter(
            DUMPS_COUNTER_NAME,
            "Postmortem bundles dumped by the flight recorder, by "
            "trigger kind", labelnames=("trigger",),
            registry=self.registry,
        )
        self._m_dropped = obs_metrics.Counter(
            DROPPED_COUNTER_NAME,
            "Snapshot intervals the recorder missed (slow provider, "
            "blocked sink, or an overloaded host) — the ring keeps its "
            "cadence by skipping, never by stalling the host",
            registry=self.registry,
        )

    # -- wiring ---------------------------------------------------------------

    def watch_registry(self, name, registry):
        """Record deltas of every instrument in ``registry`` (the
        recorder's own registry is never watched — its counters would
        feed back into every snapshot)."""
        if registry is self.registry:
            return self
        self._registries.append((name, registry))
        return self

    def watch_events(self, stream):
        """Fuse ``stream``'s unread tail into every snapshot."""
        if stream is None or stream is self.events:
            return self
        self._streams.append(stream)
        self._cursors[id(stream)] = stream.emitted
        return self

    def watch_tracer(self, tracer):
        """Fuse spans recorded since the last snapshot into each one."""
        self._tracer = tracer
        if tracer is not None:
            self._spans_seen = len(tracer.events())
        return self

    def add_state_provider(self, name, fn):
        """Sample ``fn()`` (a cheap dict snapshot: ``stats()``,
        ``kv_stats()``, tenant queue depths) into every snapshot."""
        self._providers.append((name, fn))
        return self

    # -- snapshots ------------------------------------------------------------

    def _series_values(self):
        """``{series_key: (kind, value-or-counts)}`` across the watched
        registries — the raw material the delta pass diffs."""
        out = {}
        for reg_name, reg in self._registries:
            with reg._lock:
                metrics = list(reg._metrics.values())
            for metric in metrics:
                for values, child in metric._series():
                    key = series_key(metric.name, metric.labelnames,
                                     values)
                    if getattr(child, "_buckets", None) is not None:
                        with child._lock:
                            out[key] = (
                                "histogram",
                                (list(child._counts), child._sum),
                            )
                    elif metric.kind == "counter":
                        out[key] = ("counter", child.value)
                    else:
                        out[key] = ("gauge", child.value)
        return out

    def snapshot(self):
        """Take one delta snapshot into the ring; returns the record.

        Change-only: counters contribute ``delta`` entries when they
        moved, gauges a sample when the value changed, histograms
        nonzero per-bucket deltas plus sum/count deltas. Safe to call
        from any thread (and driven by the recorder thread when
        :meth:`start`\\ ed)."""
        now = self._clock()
        counters = {}
        gauges = {}
        histograms = {}
        for key, (kind, value) in self._series_values().items():
            prev = self._last.get(key)
            if kind == "histogram":
                counts, total = value
                prev_counts, prev_sum = prev if prev else (
                    [0] * len(counts), 0.0)
                dcount = sum(counts) - sum(prev_counts)
                if dcount:
                    histograms[key] = {
                        "count": dcount,
                        "sum": round(total - prev_sum, 9),
                        "buckets": {
                            str(i): c - p
                            for i, (c, p) in enumerate(
                                zip(counts, prev_counts))
                            if c - p
                        },
                    }
                self._last[key] = (counts, total)
            elif kind == "counter":
                delta = value - (prev or 0.0)
                if delta:
                    counters[key] = delta
                self._last[key] = value
            else:  # gauge: sample on change (consumers carry forward)
                if prev is None or value != prev:
                    gauges[key] = value
                self._last[key] = value
        events = []
        for stream in self._streams:
            tail, cursor = _unread_tail(
                stream, self._cursors[id(stream)])
            self._cursors[id(stream)] = cursor
            events.extend(tail[-MAX_EVENTS_PER_SNAPSHOT:])
        spans = []
        if self._tracer is not None:
            recorded = self._tracer.events()
            spans = recorded[self._spans_seen:][
                -MAX_SPANS_PER_SNAPSHOT:]
            self._spans_seen = len(recorded)
        state = {}
        for name, fn in self._providers:
            try:
                state[name] = fn()
            except Exception:  # noqa: BLE001 - telemetry must not raise
                log.exception("flight state provider %r failed", name)
        rec = {
            "record": "snapshot",
            "ts": now,
            "wall_ts": self._wall(),
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }
        if events:
            rec["events"] = events
        if spans:
            rec["spans"] = spans
        if state:
            rec["state"] = state
        with self._ring_lock:
            self._ring.append(rec)
        self._last_ts = now
        return rec

    def poll(self):
        """Take the snapshots now due; count intervals missed beyond
        one as drops (cadence holds by skipping, never by catching up
        with a burst or stalling the caller). Returns snapshots taken
        (0 or 1)."""
        now = self._clock()
        if self._last_ts is None:
            self.snapshot()
            return 1
        due = int((now - self._last_ts) / self.interval_s)
        if due <= 0:
            return 0
        if due > 1:
            self._m_dropped.inc(due - 1)
        self.snapshot()
        return 1

    # -- background driving ---------------------------------------------------

    def start(self):
        """Snapshot from a daemon thread every ``interval_s``."""
        if self._thread is not None:
            return self
        self._stop = threading.Event()
        stop = self._stop

        def loop():
            while not stop.wait(self.interval_s):
                try:
                    self.poll()
                except Exception:  # noqa: BLE001 - recorder must not die
                    log.exception("flight snapshot failed")

        self._thread = threading.Thread(
            target=loop, name="obs-flight", daemon=True
        )
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)

    # -- triggers / dumps -----------------------------------------------------

    def trigger(self, kind, snapshot=True, **attrs):
        """Dump a postmortem bundle for trigger ``kind``; returns the
        bundle path, or None when rate-limited/deduped.

        ``snapshot=False`` skips the final ring snapshot — the crash/
        signal path, which must not touch any metrics lock the
        interrupted thread may hold. Dump I/O happens on the CALLING
        thread (a watchdog, alert, or HTTP handler thread — never the
        engine's host loop), bounded by the dedup window."""
        if not self._dump_lock.acquire(blocking=False):
            return None  # a dump is already in flight
        try:
            now = self._clock()
            last = self._last_dump.get(kind)
            if last is not None and now - last < self.dedup_s:
                return None
            if self._dump_seq >= self.max_dumps:
                return None
            self._last_dump[kind] = now
            self._dump_seq += 1
            if snapshot:
                try:
                    self.snapshot()
                except Exception:  # noqa: BLE001 - dump what we have
                    log.exception("flight trigger snapshot failed")
            return self._dump(kind, now, attrs)
        finally:
            self._dump_lock.release()

    def _dump(self, kind, now, attrs):
        with self._ring_lock:
            snapshots = list(self._ring)
        path = os.path.join(
            self.dirpath, f"flight-{self._dump_seq:04d}-{kind}.jsonl"
        )
        meta = {
            "record": "meta",
            "version": BUNDLE_VERSION,
            "host": self.events.host,
            "window_s": self.window_s,
            "interval_s": self.interval_s,
            "trigger": kind,
            "ts": now,
            "wall_ts": self._wall(),
            "snapshots": len(snapshots),
            "registries": [name for name, _ in self._registries],
            "providers": [name for name, _ in self._providers],
        }
        trigger_rec = {
            "record": "trigger", "kind": kind, "ts": now,
            "wall_ts": meta["wall_ts"], **attrs,
        }
        try:
            os.makedirs(self.dirpath, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps(meta, default=str) + "\n")
                f.write(json.dumps(trigger_rec, default=str) + "\n")
                for rec in snapshots:
                    f.write(json.dumps(rec, default=str) + "\n")
        except OSError:
            log.exception("flight bundle write failed (%s)", path)
            return None
        self.last_bundle = path
        self._m_dumps.labels(kind).inc()
        self.events.emit(
            "flight_dump", severity="warning", trigger=kind,
            path=path, snapshots=len(snapshots),
        )
        log.warning(
            "flight recorder dumped %d snapshot(s) to %s (trigger %s)",
            len(snapshots), path, kind,
        )
        return path

    # -- crash hooks ----------------------------------------------------------

    def install_crash_hooks(self, signals=True):
        """Arm the unhandled-crash and on-demand dump paths: a chained
        ``sys.excepthook`` (trigger ``crash``, ring as-is) and, when
        ``signals`` and this is the main thread, SIGUSR2 (trigger
        ``signal`` — the on-demand poke for daemons without an HTTP
        surface). Both dump with ``snapshot=False``: handler context
        must not take metrics locks."""
        import sys

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                self.trigger(
                    "crash", snapshot=False,
                    error=getattr(exc_type, "__name__", "error"),
                )
            except Exception:  # noqa: BLE001 - never mask the crash
                pass
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook
        if signals and threading.current_thread() is threading.main_thread():
            import signal as _signal

            def on_signal(signum, frame):
                del signum, frame
                self.trigger("signal", snapshot=False)

            try:
                _signal.signal(_signal.SIGUSR2, on_signal)
            except (ValueError, OSError):  # non-main ctx / platform
                log.warning("SIGUSR2 flight hook not installed")
        return self


# -- process-global armed recorder (the faults.arm pattern) -------------------

_RECORDER = None
_recorder_lock = threading.Lock()


def install(recorder):
    """Install ``recorder`` as the process-wide armed one; returns it.
    Every :func:`trigger` hook site in the stack reaches it."""
    global _RECORDER
    with _recorder_lock:
        _RECORDER = recorder
    return recorder


def deactivate():
    """Disarm: every hook returns to its one-is-None-check no-op path."""
    global _RECORDER
    with _recorder_lock:
        _RECORDER = None


def get():
    """The armed recorder, or None."""
    return _RECORDER


def active():
    return _RECORDER is not None


def trigger(kind, **attrs):
    """Module-level trigger hook: None when disarmed — one ``is None``
    check, no allocation (the zero-cost contract, enforced by the
    zerocost analyzer pass; see tests/test_flight.py)."""
    r = _RECORDER
    if r is None:
        return None
    return r.trigger(kind, **attrs)


def last_bundle():
    """Path of the newest dumped bundle, or None (disarmed included) —
    the reactor attaches it to cordon/drain reaction events."""
    r = _RECORDER
    if r is None:
        return None
    return r.last_bundle


def wire_from_flags(enabled, dirpath, registries=(), streams=(),
                    tracer=None, providers=(), window_s=DEFAULT_WINDOW_S,
                    interval_s=DEFAULT_INTERVAL_S, host=None,
                    port=obs_ports.FLIGHT_PORT, crash_hooks=True,
                    start=True):
    """CLI wiring for ``--flight-recorder``/``--flight-window-s``/
    ``--flight-dir``: build, wire, arm, and start the recorder; serve
    its registry on ``port`` (:data:`obs.ports.FLIGHT_PORT`; best
    effort — two armed daemons on one host keep flying, only the scrape
    endpoint is lost). Returns ``None`` — creating NOTHING — when
    ``enabled`` is false: the disarmed path stays zero-cost."""
    if not enabled:
        return None
    rec = FlightRecorder(
        dirpath, window_s=window_s, interval_s=interval_s, host=host,
    )
    for name, reg in registries:
        rec.watch_registry(name, reg)
    for stream in streams:
        rec.watch_events(stream)
    if tracer is not None:
        rec.watch_tracer(tracer)
    for name, fn in providers:
        rec.add_state_provider(name, fn)
    install(rec)
    if crash_hooks:
        rec.install_crash_hooks()
    if port:
        try:
            obs_metrics.serve(
                port, registry=rec.registry,
                owner="flight-recorder tier (obs.flight "
                      "--flight-recorder)",
            )
        except obs_ports.PortConflictError as err:
            log.warning("flight metrics port not bound: %s", err)
    if start:
        rec.start()
    log.info(
        "flight recorder armed: %ss window @ %ss into %s",
        window_s, interval_s, dirpath,
    )
    return rec
