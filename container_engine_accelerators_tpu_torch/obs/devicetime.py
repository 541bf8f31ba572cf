# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Chip accounting: the per-dispatch device-time ledger.

Copy of ``container_engine_accelerators_tpu/obs/devicetime.py``, its imports
rewritten to the port's package; the contracts are the same.

The reference stack's per-container GPU metrics layer answers "which
container consumed the accelerator" with an NVML sampler; this module
is the serving-engine twin. The continuous engine wraps every device
call in a host wall envelope already (the ``*_seconds_total`` phase
counters); the ledger splits each envelope **pro-rata by row-tokens**
across the rows the call served, so device-seconds roll up by tenant
class instead of only by phase:

    tpu_serving_device_seconds_total{phase, tenant_class}

Phase vocabulary (the engine's four dispatch families):

  * ``prefill`` — single-shot admission prefills (dense ``_admit``);
  * ``chunk``   — chunked-prefill segments (dense ``_advance_prefill``
    and the paged ``_advance_prefill_paged``);
  * ``decode``  — fused decode chunks (the dense loop's fused chunk
    and ``_dispatch_chunk_paged``);
  * ``verify``  — speculative verify batches.

Attribution invariant (pinned by tests/test_devicetime.py): the
per-row seconds of one :meth:`attribute` call sum **exactly** to the
measured wall — the last row takes the float remainder — so summing
the counter over every label equals total measured device wall.

The paged loop is async (dispatch at iteration N, sync at N+1): the
dispatch wall and the deferred sync wait are attributed separately,
both to the rows captured at dispatch (a generation-voided sync still
waited on the device — its wall is real work and must not leak out of
the ledger, or per-class sums stop matching the measured total).

**Bubbles** are first-class: the host-loop gap between one dispatch
envelope's end and the next envelope's start is accumulated in
``tpu_serving_device_bubble_seconds_total`` and exposed as a rolling
``tpu_serving_device_bubble_ratio`` gauge, so pipeline stalls are
measured, not inferred. Idle blocks (empty admission queue) reset the
envelope chain — an engine with no work is idle, not bubbling.

The **fairness audit** rides the same window: the rolling measured
device-share per class is ``tpu_tenant_device_share{tenant_class}``
and, for classes with a configured ``queue_share``,
``tpu_tenant_device_share_ratio{tenant_class}`` = measured/configured
— the drift gauge the ``tenant-share-drift`` example alert rule
(obs/alerts.py) watches.

Zero cost when disarmed: the engine holds ``devicetime=None`` by
default and every hook site is one ``is None`` check (the
``faults.tick`` contract; the analyzer's zero-cost pass covers the
ledger's hook names).
"""

import collections
import threading
import time

from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

# Rolling window for the share/bubble gauges: long enough to smooth
# per-dispatch jitter, short enough that a starved class shows up
# within one alert evaluation window.
DEFAULT_WINDOW_S = 30.0

# Label value for device wall that cannot be pinned on any row (an
# empty verify group, a batch whose rows all voided before sync
# bookkeeping could name them). Bounded: it is a fixed sentinel, not a
# request-supplied string.
UNATTRIBUTED = "unattributed"


class DeviceTimeLedger:
    """Pro-rata device-time attribution + bubble/fairness gauges.

    Writers are the engine loop (paged) or request threads (dense
    ``_admit``); readers are scrape threads via ``set_function`` — the
    lock covers the rolling window both sides touch.
    """

    def __init__(self, registry=None, tenants=None,
                 window_s=DEFAULT_WINDOW_S, clock=time.monotonic):
        reg = registry if registry is not None else obs_metrics.Registry()
        self.registry = reg
        self.tenants = tenants
        self.window_s = float(window_s)
        self.clock = clock
        self._lock = threading.Lock()
        # Rolling (ts, tenant_class, device_s) samples for the share
        # gauges and (ts, bubble_s) samples for the bubble ratio.
        self._samples = collections.deque()
        self._bubbles = collections.deque()
        # End of the last dispatch envelope; None = chain broken (just
        # armed, or the loop blocked idle on an empty queue).
        self._last_end = None
        # Lifetime totals (host floats, exact — the counters round-trip
        # through the exposition format).
        self.total_device_s = 0.0
        self.total_bubble_s = 0.0
        self.per_phase = collections.Counter()
        self.per_class = collections.Counter()
        # (phase, tenant_class) cross-product — the capacity report's
        # table grain; mirrors the counter's label pairs exactly.
        self.per_phase_class = collections.Counter()
        self._m_seconds = obs_metrics.get_or_create(
            obs_metrics.Counter, "tpu_serving_device_seconds_total",
            "Measured device-call wall attributed pro-rata (by "
            "row-tokens) to the rows each dispatch served, by engine "
            "phase and tenant class",
            registry=reg, labelnames=["phase", "tenant_class"])
        self._m_bubble = obs_metrics.get_or_create(
            obs_metrics.Counter,
            "tpu_serving_device_bubble_seconds_total",
            "Host-loop gap between consecutive dispatch envelopes "
            "(device idle while work was queued); idle blocks on an "
            "empty queue break the chain and do not count",
            registry=reg)
        obs_metrics.get_or_create(
            obs_metrics.Gauge, "tpu_serving_device_bubble_ratio",
            "Rolling bubble share of the host loop: bubble / (bubble "
            "+ attributed device wall) over the ledger window",
            registry=reg).set_function(self.bubble_ratio)
        self._m_share = obs_metrics.get_or_create(
            obs_metrics.Gauge, "tpu_tenant_device_share",
            "Rolling measured device-time share per tenant class "
            "(fraction of attributed device-seconds in the window)",
            registry=reg, labelnames=["tenant_class"])
        self._m_share_ratio = obs_metrics.get_or_create(
            obs_metrics.Gauge, "tpu_tenant_device_share_ratio",
            "Fairness drift: measured device share / configured "
            "queue_share per tenant class (1.0 = fair; the "
            "tenant-share-drift alert rule fires when a class holds "
            "below threshold during contention)",
            registry=reg, labelnames=["tenant_class"])
        # Pre-register one series per configured class so the fairness
        # surface exists (at 0) before the first dispatch and the
        # drift rule has a series to read during a total starvation.
        for name in self._configured_shares():
            self._m_share.labels(tenant_class=name).set_function(
                lambda n=name: self.measured_share(n))
            self._m_share_ratio.labels(tenant_class=name).set_function(
                lambda n=name: self.share_ratio(n))
        self._share_series = set(self._configured_shares())

    # -- configuration ------------------------------------------------

    def _configured_shares(self):
        """{class: normalized configured queue_share} (may be empty)."""
        classes = getattr(self.tenants, "classes", None)
        if not classes:
            return {}
        total = sum(c.queue_share for c in classes.values()) or 1.0
        return {
            name: c.queue_share / total for name, c in classes.items()
        }

    def _ensure_series(self, tenant):
        # Engine-loop path, lock held: first sighting of a class not in
        # the configured set (e.g. "default") still gets a share gauge.
        if tenant in self._share_series:
            return
        self._share_series.add(tenant)
        self._m_share.labels(tenant_class=tenant).set_function(
            lambda n=tenant: self.measured_share(n))

    # -- attribution --------------------------------------------------

    def attribute(self, phase, wall_s, parts, now=None):
        """Split ``wall_s`` across ``parts`` = [(row, weight), ...].

        ``row`` is the engine's in-flight row dict (or None); each
        row's slice lands on its ``device_s`` accumulator and on the
        counter under its tenant class. Weights are the row-tokens the
        dispatch advanced; non-positive/empty weights fall back to an
        equal split, and an empty ``parts`` books the whole wall under
        the bounded ``unattributed`` class — measured wall never leaks.
        """
        wall_s = float(wall_s)
        if wall_s <= 0.0:
            return
        ts = self.clock() if now is None else now
        parts = [(r, float(w)) for r, w in parts]
        total_w = sum(w for _, w in parts if w > 0.0)
        if parts and total_w <= 0.0:
            parts = [(r, 1.0) for r, _ in parts]
            total_w = float(len(parts))
        with self._lock:
            if not parts:
                self._book(phase, UNATTRIBUTED, wall_s, ts)
                return
            booked = 0.0
            for i, (row, w) in enumerate(parts):
                if i + 1 == len(parts):
                    # Float remainder to the last row: the per-batch
                    # attributed sum equals the measured wall exactly.
                    # Clamped at zero — a zero-weight last row can see
                    # a -1ulp remainder from the earlier slices.
                    secs = max(wall_s - booked, 0.0)
                else:
                    secs = wall_s * (max(w, 0.0) / total_w)
                booked += secs
                tenant = "default"
                if row is not None:
                    row["device_s"] = row.get("device_s", 0.0) + secs
                    bp = row.setdefault("device_by_phase", {})
                    bp[phase] = bp.get(phase, 0.0) + secs
                    tenant = str(row.get("tenant") or "default")
                self._book(phase, tenant, secs, ts)

    def _book(self, phase, tenant, secs, ts):
        # Lock held.
        self._m_seconds.labels(phase=phase, tenant_class=tenant).inc(secs)
        self.total_device_s += secs
        self.per_phase[phase] += secs
        self.per_class[tenant] += secs
        self.per_phase_class[(phase, tenant)] += secs
        self._ensure_series(tenant)
        self._samples.append((ts, tenant, secs))
        self._prune(ts)

    # -- dispatch envelopes / bubbles ---------------------------------

    def note_dispatch(self, t0):
        """A dispatch envelope opens at host time ``t0`` (perf clock of
        the caller): the gap since the previous envelope's end is
        bubble — host-loop time the device sat idle with work queued."""
        with self._lock:
            if self._last_end is not None:
                gap = t0 - self._last_end
                if gap > 0.0:
                    self._m_bubble.inc(gap)
                    self.total_bubble_s += gap
                    ts = self.clock()
                    self._bubbles.append((ts, gap))
                    self._prune(ts)
            self._last_end = t0

    def note_dispatch_end(self, t1):
        """The envelope (dispatch wall, or its deferred sync) closed."""
        with self._lock:
            self._last_end = t1

    def note_idle(self):
        """The loop blocked on an empty queue: break the envelope chain
        so wait-for-work is idle time, not a bubble."""
        with self._lock:
            self._last_end = None

    # -- rolling window reads -----------------------------------------

    def _prune(self, now):
        # Lock held.
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()
        while self._bubbles and self._bubbles[0][0] < cutoff:
            self._bubbles.popleft()

    def measured_share(self, tenant):
        """Rolling fraction of attributed device-seconds held by
        ``tenant`` (0.0 when the window is empty)."""
        with self._lock:
            self._prune(self.clock())
            total = 0.0
            mine = 0.0
            for _, t, secs in self._samples:
                total += secs
                if t == tenant:
                    mine += secs
            return mine / total if total > 0.0 else 0.0

    def share_ratio(self, tenant):
        """measured_share / configured queue_share (1.0 while the
        window is empty, so a drained engine never looks unfair)."""
        configured = self._configured_shares().get(tenant)
        if not configured:
            return 1.0
        with self._lock:
            self._prune(self.clock())
            total = sum(s for _, _, s in self._samples)
        if total <= 0.0:
            return 1.0
        return self.measured_share(tenant) / configured

    def bubble_ratio(self):
        """Rolling bubble / (bubble + device) over the window."""
        with self._lock:
            self._prune(self.clock())
            device = sum(s for _, _, s in self._samples)
            bubble = sum(s for _, s in self._bubbles)
        denom = device + bubble
        return bubble / denom if denom > 0.0 else 0.0

    # -- snapshots ----------------------------------------------------

    def snapshot(self):
        """Lifetime totals for stats()/capacity reports."""
        with self._lock:
            return {
                "device_s": round(self.total_device_s, 9),
                "bubble_s": round(self.total_bubble_s, 9),
                "per_phase": {
                    k: round(v, 9) for k, v in sorted(
                        self.per_phase.items())
                },
                "per_class": {
                    k: round(v, 9) for k, v in sorted(
                        self.per_class.items())
                },
                # Flattened "phase/class" keys: JSON-safe for the
                # event-log feed obs/capacity.py rebuilds tables from.
                "per_phase_class": {
                    f"{p}/{t}": round(v, 9) for (p, t), v in sorted(
                        self.per_phase_class.items())
                },
            }

    def emit_snapshot(self, events):
        """Book one ``chip_accounting`` event: the lifetime ledger
        totals, flattened for the capacity-report CLI (obs/capacity.py
        merges it with request_retired/hbm_snapshot records)."""
        if events is None:
            return None
        snap = self.snapshot()
        return events.emit(
            "chip_accounting",
            device_s=snap["device_s"],
            bubble_s=snap["bubble_s"],
            per_phase=snap["per_phase"],
            per_class=snap["per_class"],
            per_phase_class=snap["per_phase_class"],
        )
