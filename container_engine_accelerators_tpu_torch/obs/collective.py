# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Collective-tier observability: latency histograms + bandwidth gauges.

Copy of ``container_engine_accelerators_tpu/obs/collective.py``, its
imports rewritten to the port's package; the contracts are the same. In
the port ``collectives/device_bench.py`` and the global-array wrappers
of ``parallel/overlap.py`` record here (the collective sweep is not
ported yet).

The node exporter sees the fabric's error counters; nothing sees the
*collectives riding it*. This module gives every collective execution
path one place to record (collective, latency, achieved bandwidth),
tagged with this host's fleet coordinates (host + slice from
``obs.events.host_identity``), so a fleet scrape can answer "which
host's ring hop is slow" next to "which chip flipped Unhealthy":

  * ``collectives/bench.py`` records every sweep point (the nccl-tests
    rows become time series, not just stdout);
  * ``collectives/device_bench.py`` records single-chip qualification
    results the same way;
  * ``parallel/overlap.py``'s global-array wrappers record their
    eager-mode executions (the host-side boundary of a ring
    collective-matmul), so serving/training hosts report achieved
    overlap bandwidth without running a benchmark.

Like ``obs.trace``, recording is a free no-op until :func:`configure`
installs the process-wide instance — benches configure it when asked to
export metrics; library code just calls :func:`record`.
"""

import threading

from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

# A CPU-mesh smoke collective (~100us) up to a DCN-tier transfer of
# hundreds of MB (~seconds).
COLLECTIVE_LATENCY_BUCKETS = (
    1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
)

_LABELS = ("collective", "host", "slice")


class CollectiveObs:
    """Per-collective instruments in one registry; thread-safe via the
    underlying instruments."""

    def __init__(self, registry=None, identity=None):
        reg = registry if registry is not None else obs_metrics.Registry()
        self.registry = reg
        ident = identity or obs_events.host_identity()
        self.host = ident["host"]
        self.slice = ident.get("slice", "")
        self.latency = obs_metrics.Histogram(
            "tpu_collective_latency_seconds",
            "Wall time of one collective execution (bench iteration or "
            "eager ring-overlap call)",
            buckets=COLLECTIVE_LATENCY_BUCKETS, labelnames=_LABELS,
            registry=reg)
        self.moved_bytes = obs_metrics.Counter(
            "tpu_collective_bytes_total",
            "Bytes moved through recorded collectives",
            labelnames=_LABELS, registry=reg)
        self.algbw = obs_metrics.Gauge(
            "tpu_collective_algorithm_bandwidth_gbps",
            "Achieved algorithmic bandwidth of the last recorded "
            "execution (GB/s)", labelnames=_LABELS, registry=reg)
        self.busbw = obs_metrics.Gauge(
            "tpu_collective_bus_bandwidth_gbps",
            "Achieved bus bandwidth of the last recorded execution "
            "(GB/s, nccl-tests convention)", labelnames=_LABELS,
            registry=reg)
        # Single-chip qualification numbers (collectives/device_bench)
        # on the same host/slice-tagged surface, so a fleet scrape can
        # rank chips by measured matmul/HBM/MFU next to their collective
        # behavior.
        bench_labels = ("name", "unit", "host", "slice")
        self.bench_value = obs_metrics.Gauge(
            "tpu_device_bench_value",
            "Latest device-benchmark result, labeled by bench name and "
            "unit", labelnames=bench_labels, registry=reg)
        self.bench_frac = obs_metrics.Gauge(
            "tpu_device_bench_frac_of_peak",
            "Latest device-benchmark result as a fraction of the "
            "generation's nominal peak (0 when the peak is unknown)",
            labelnames=bench_labels, registry=reg)

    def record(self, collective, seconds, msg_bytes=0, algbw_gbps=0.0,
               busbw_gbps=0.0):
        labels = (collective, self.host, self.slice)
        self.latency.labels(*labels).observe(seconds)
        if msg_bytes:
            self.moved_bytes.labels(*labels).inc(msg_bytes)
        if algbw_gbps:
            self.algbw.labels(*labels).set(algbw_gbps)
        if busbw_gbps:
            self.busbw.labels(*labels).set(busbw_gbps)

    def record_device_bench(self, name, value, unit, frac_of_peak=0.0):
        labels = (name, unit, self.host, self.slice)
        self.bench_value.labels(*labels).set(value)
        self.bench_frac.labels(*labels).set(frac_of_peak)


_obs = None
_lock = threading.Lock()


def configure(registry=None, enabled=True, identity=None):
    """Install (or tear down) the process-wide instance; returns it."""
    global _obs
    with _lock:
        _obs = (
            CollectiveObs(registry=registry, identity=identity)
            if enabled else None
        )
        return _obs


def get():
    return _obs


def enabled():
    return _obs is not None


def record(collective, seconds, msg_bytes=0, algbw_gbps=0.0,
           busbw_gbps=0.0):
    """Record on the process-wide instance; free no-op when off."""
    o = _obs
    if o is None:
        return
    o.record(collective, seconds, msg_bytes=msg_bytes,
             algbw_gbps=algbw_gbps, busbw_gbps=busbw_gbps)


def record_device_bench(name, value, unit, frac_of_peak=0.0):
    """Record a device-bench result; free no-op when off."""
    o = _obs
    if o is None:
        return
    o.record_device_bench(name, value, unit, frac_of_peak=frac_of_peak)
