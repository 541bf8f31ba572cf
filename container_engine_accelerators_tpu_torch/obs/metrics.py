# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Dependency-light metrics: Counter/Gauge/Histogram + Prometheus text.

Copy of ``container_engine_accelerators_tpu/obs/metrics.py``, its imports
rewritten to the port's package; the contracts are the same.

The workload tier's answer to ``prometheus_client`` (which the node
exporters use but a stripped serving image may not carry): the same
``# HELP`` / ``# TYPE`` / sample text exposition the device plugin
(:2112) and interconnect exporter (:2114) emit, produced from stdlib
only, servable on a configurable port (:func:`serve`). Instruments are
thread-safe; gauges may be backed by a callable (``set_function``) so
scrapes always see live state.

Value formatting matches prometheus_client's (``1.0``, not ``1``), so
assertions and dashboards written against the node exporters carry over.
"""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from container_engine_accelerators_tpu_torch.obs import ports as obs_ports

_INF = float("inf")

# Non-finite samples (a NaN loss from a wedged step, an inf latency from
# a zero-duration division) are DROPPED instead of corrupting the
# exposition — a single NaN in a histogram sum poisons every rate()
# over it forever. Each drop is counted here, labeled by the instrument
# it was aimed at, in the same registry.
DROPPED_SAMPLES_NAME = "tpu_metrics_dropped_samples_total"


def _finite(v):
    return v == v and -_INF < v < _INF


def _fmt(v):
    """Prometheus float formatting: integral values render as '1.0'."""
    v = float(v)
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return f"{v:.1f}"
    return repr(v)


def _fmt_labels(names, values):
    if not names:
        return ""
    parts = []
    for k, v in zip(names, values):
        v = str(v).replace("\\", "\\\\").replace('"', '\\"')
        v = v.replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_exemplar(ex):
    """OpenMetrics exemplar suffix: `` # {trace_id="..."} value ts``.

    Rendered ONLY for series that recorded one — a registry with no
    exemplars exposes byte-identical text to the pre-exemplar stack, so
    plain Prometheus scrapers (and the render pins in the tests) never
    see the suffix unless tracing sampled a request into the bucket."""
    trace_id, value, ts = ex
    tid = str(trace_id).replace("\\", "\\\\").replace('"', '\\"')
    return f' # {{trace_id="{tid}"}} {_fmt(value)} {ts:.3f}'


class _Child:
    """One labeled time series of a parent instrument."""

    __slots__ = ("_lock", "_value", "_fn", "_buckets", "_counts", "_sum",
                 "_monotonic", "_owner", "_exemplar", "_bucket_exemplars")

    def __init__(self, buckets=None, monotonic=False, owner=None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = None
        self._buckets = buckets
        self._monotonic = monotonic
        self._owner = owner
        # OpenMetrics exemplars: the LAST sampled trace id per series
        # (counters) / per bucket (histograms), each a
        # (trace_id, value, wall_ts) triple. None until a caller passes
        # ``exemplar=`` — the common no-tracing path allocates nothing.
        self._exemplar = None
        self._bucket_exemplars = None
        if buckets is not None:
            self._counts = [0] * (len(buckets) + 1)  # +1 for +Inf
            self._sum = 0.0

    def _dropped(self):
        if self._owner is not None:
            self._owner._note_dropped()

    def inc(self, amount=1.0, exemplar=None):
        amount = float(amount)
        if not _finite(amount):
            self._dropped()
            return
        if self._monotonic and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount
            if exemplar is not None:
                self._exemplar = (str(exemplar), amount, time.time())

    def dec(self, amount=1.0):
        with self._lock:
            self._value -= amount

    def set(self, value):
        value = float(value)
        if not _finite(value):
            self._dropped()
            return
        with self._lock:
            self._value = value
            self._fn = None

    def set_function(self, fn):
        with self._lock:
            self._fn = fn

    def observe(self, value, exemplar=None):
        value = float(value)
        if not _finite(value):
            self._dropped()
            return
        with self._lock:
            self._sum += value
            idx = len(self._counts) - 1
            for i, b in enumerate(self._buckets):
                if value <= b:
                    idx = i
                    break
            self._counts[idx] += 1
            if exemplar is not None:
                if self._bucket_exemplars is None:
                    self._bucket_exemplars = [None] * len(self._counts)
                self._bucket_exemplars[idx] = (
                    str(exemplar), value, time.time()
                )

    @property
    def value(self):
        with self._lock:
            if self._fn is not None:
                return float(self._fn())
            return self._value


class _Instrument:
    kind = "untyped"
    # Counters set this so EVERY child (labeled ones included) rejects
    # negative increments, same as prometheus_client.
    monotonic = False

    def __init__(self, name, doc, labelnames=(), registry=None,
                 buckets=None):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children = {}
        if not self.labelnames:
            # Unlabeled: one implicit child, so inc()/set()/observe()
            # work directly on the instrument.
            self._children[()] = _Child(buckets=buckets,
                                        monotonic=self.monotonic,
                                        owner=self)
        self._registry = registry if registry is not None else REGISTRY
        self._registry.register(self)

    def _note_dropped(self):
        """Count a rejected non-finite sample in this instrument's own
        registry (dashboards see the gap; the exposition stays clean).
        The drop counter's unlabeled children never route back here, so
        there is no recursion."""
        get_or_create(
            Counter, DROPPED_SAMPLES_NAME,
            "Non-finite (NaN/Inf) samples dropped instead of corrupting "
            "the exposition, by target metric",
            labelnames=("name",), registry=self._registry,
        ).labels(self.name).inc()

    def labels(self, *values, **kv):
        if kv:
            values = tuple(kv[k] for k in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{values}"
            )
        values = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = _Child(buckets=self._buckets,
                               monotonic=self.monotonic, owner=self)
                self._children[values] = child
            return child

    def _only(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self._children[()]

    def clear(self):
        """Drop all labeled series (scrape-time resets, like the device
        plugin's per-sweep gauge clear)."""
        with self._lock:
            self._children = {} if self.labelnames else {(): _Child(
                buckets=self._buckets, monotonic=self.monotonic,
                owner=self)}

    def _series(self):
        with self._lock:
            return list(self._children.items())

    def render(self):
        lines = [
            f"# HELP {self.name} {self.doc}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for values, child in self._series():
            line = (
                f"{self.name}{_fmt_labels(self.labelnames, values)} "
                f"{_fmt(child.value)}"
            )
            if child._exemplar is not None:
                line += _fmt_exemplar(child._exemplar)
            lines.append(line)
        return lines


class Counter(_Instrument):
    """Monotonic counter; name should end in ``_total`` by convention."""

    kind = "counter"
    monotonic = True

    def inc(self, amount=1.0):
        self._only().inc(amount)

    @property
    def value(self):
        return self._only().value


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value):
        self._only().set(value)

    def inc(self, amount=1.0):
        self._only().inc(amount)

    def dec(self, amount=1.0):
        self._only().dec(amount)

    def set_function(self, fn):
        self._only().set_function(fn)

    @property
    def value(self):
        return self._only().value


class Histogram(_Instrument):
    """Cumulative histogram with EXPLICIT buckets (upper bounds)."""

    kind = "histogram"

    def __init__(self, name, doc, buckets, labelnames=(), registry=None):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError(f"{name}: explicit buckets required")
        super().__init__(name, doc, labelnames=labelnames,
                         registry=registry, buckets=buckets)

    def observe(self, value, exemplar=None):
        self._only().observe(value, exemplar=exemplar)

    @property
    def count(self):
        child = self._only()
        return sum(child._counts)

    @property
    def sum(self):
        return self._only()._sum

    def exemplars(self):
        """``{upper_bound: (trace_id, value, ts)}`` for every bucket of
        the unlabeled series holding an exemplar (the drills' hook for
        resolving a slow bucket to a concrete journey without parsing
        the text exposition)."""
        child = self._only()
        ex = child._bucket_exemplars
        if ex is None:
            return {}
        return {
            bound: e
            for bound, e in zip(self._buckets + (_INF,), ex)
            if e is not None
        }

    def render(self):
        lines = [
            f"# HELP {self.name} {self.doc}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for values, child in self._series():
            cum = 0
            exemplars = child._bucket_exemplars
            bounds = zip(self._buckets + (_INF,), child._counts)
            for i, (bound, n) in enumerate(bounds):
                cum += n
                labels = _fmt_labels(
                    self.labelnames + ("le",), values + (_fmt(bound),)
                )
                line = f"{self.name}_bucket{labels} {_fmt(cum)}"
                if exemplars is not None and exemplars[i] is not None:
                    line += _fmt_exemplar(exemplars[i])
                lines.append(line)
            labels = _fmt_labels(self.labelnames, values)
            lines.append(f"{self.name}_sum{labels} {_fmt(child._sum)}")
            lines.append(f"{self.name}_count{labels} {_fmt(cum)}")
        return lines


class Registry:
    """Ordered instrument collection -> one text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def register(self, metric):
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(
                    f"metric {metric.name!r} already registered"
                )
            self._metrics[metric.name] = metric

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def render(self):
        """Prometheus text exposition, as bytes (ready to serve)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return ("\n".join(lines) + "\n").encode()


# The process-wide default registry. Long-lived daemons use it; tests and
# multi-instance components (one registry per engine) create their own.
REGISTRY = Registry()


def get_or_create(cls, name, doc, registry=None, **kwargs):
    """The instrument named ``name`` in ``registry``, created if absent.

    For instruments shared by several owners of ONE registry (the event
    streams' ``tpu_obs_events_total``, the health checker's instruments
    when a caller supplies a pre-populated registry): plain construction
    would raise on the second owner. Safe under races: two threads
    creating the same first instrument concurrently both get the one
    that won registration (the loser's duplicate-name error is resolved
    by re-reading, never surfaced — the non-finite sample guard calls
    this from inside set()/observe(), whose contract is to never
    raise)."""
    reg = registry if registry is not None else REGISTRY
    existing = reg.get(name)
    if existing is not None:
        return existing
    try:
        return cls(name, doc, registry=reg, **kwargs)
    except ValueError:
        existing = reg.get(name)
        if existing is not None:
            return existing
        raise

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _make_handler(registry):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path.split("?")[0] != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = registry.render()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


class MetricsServer:
    """Handle on a running exposition endpoint.

    Before this existed, ``serve()`` returned the raw HTTP server and
    callers fired-and-forgot it: nothing ever released the port, so a
    component that wanted to rebind (a test, a drain/restart cycle) had
    to reach into http.server internals. The handle keeps the old
    surface (``server_address``, ``shutdown``) and adds :meth:`close`,
    which stops the serve loop AND closes the listening socket so the
    port is immediately rebindable. Every thread involved (the serve
    loop and the per-request handler threads) is a daemon: an exporter
    must never keep a finished workload process alive."""

    def __init__(self, httpd, thread):
        self._httpd = httpd
        self._thread = thread

    @property
    def server_address(self):
        return self._httpd.server_address

    @property
    def port(self):
        return self._httpd.server_address[1]

    def shutdown(self):
        """Stop serving (socket stays open; prefer :meth:`close`)."""
        self._httpd.shutdown()

    def close(self):
        """Stop serving and release the port."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def serve(port, registry=None, host="0.0.0.0",
          owner="workload metrics (obs.metrics)"):
    """Serve ``registry`` (default the process registry) on
    ``host:port/metrics`` from a daemon thread; returns a
    :class:`MetricsServer` handle (``.server_address[1]`` / ``.port``
    is the bound port — pass port 0 to pick; ``.close()`` releases it).

    A bind conflict raises :class:`obs.ports.PortConflictError` naming
    the stack's known port assignments, instead of a bare EADDRINUSE.
    """
    registry = registry if registry is not None else REGISTRY
    try:
        httpd = ThreadingHTTPServer((host, port), _make_handler(registry))
    except OSError as e:
        # Only genuine bind conflicts get the port-map diagnosis; an
        # EADDRNOTAVAIL or similar must not be misblamed on a colliding
        # exporter.
        if not obs_ports._is_bind_conflict(e):
            raise
        raise obs_ports.PortConflictError(
            obs_ports.conflict_message(port, owner, e)
        ) from e
    # Explicit, not inherited: per-request handler threads must be
    # daemons too, or one slow scraper pins the process at exit.
    httpd.daemon_threads = True
    thread = threading.Thread(
        target=httpd.serve_forever, name="obs-metrics", daemon=True
    )
    thread.start()
    return MetricsServer(httpd, thread)
