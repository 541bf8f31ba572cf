# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Replica router: the fleet serving tier's front door.

One ``ContinuousEngine`` replica serves one slice; this module spreads
a fleet's traffic across N of them. Routing is a scoring policy over
three signals:

  * **queue depth / in-flight load** — the cheap ``/healthz`` snapshot
    every replica exports (queue depth + occupied slots, no metrics
    scrape) plus the router's own in-flight count per replica;
  * **prefix-cache affinity** — the hash of the prompt's leading
    tokens maps onto a consistent-hash ring of ready replicas, so
    requests sharing a system prompt land on the replica that already
    prefilled it (the KV prefix is warm there); affinity is advisory —
    when the owner's load exceeds the fleet minimum by more than
    ``affinity_slack`` the request spills to the least-loaded peer
    (a hot prefix must not melt one replica while others idle);
  * **health/SLO state** — consumed from each replica's health probe
    and its structured event stream (``request_shed`` rates,
    ``health_transition`` flips). Replicas that fail probes, flip
    Unhealthy, or exceed the shed-rate threshold are **ejected** from
    rotation (``replica_ejected``) and re-admitted on recovery
    (``replica_readmitted``).

A request that was dispatched to a replica that dies mid-flight is
**re-issued exactly once** to a peer, keyed by an idempotency key: the
router remembers the keys it already re-issued, so a double failure
fails the request rather than fanning it out (at-most-once re-issue is
the contract the exactly-once retire accounting in the chaos drill
pins).

Transport is pluggable — an HTTP POST in production (:func:`main`'s
CLI builds urllib transports from ``--replicas``), a direct in-process
engine call in the hermetic sim (:mod:`.sim`) — so the routing policy
itself runs (and is chaos-tested) in tier-1 with zero network.

CLI::

    python -m container_engine_accelerators_tpu_torch.fleet.router \
        --replicas http://r0:8000,http://r1:8000 --port 8100

serves POST /generate (routed), GET /healthz, GET /replicas (rotation
state), GET /metrics (``tpu_router_*``), probes every backend's
/healthz on ``--probe-interval-s``, and tails each replica's event log
given ``--replica-events``.

Copy of ``container_engine_accelerators_tpu/fleet/router.py``, its
imports pointed at the port's ``obs`` and ``kvcache/handoff`` copies, so
the port's fleet simulator (``fleet/sim.py``) routes port engines without
the JAX package. The wire contracts are JAX's: either package's router
serves either package's replicas.
"""

import argparse
import bisect
import collections
import hashlib
import itertools
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from container_engine_accelerators_tpu_torch.kvcache import handoff as kv_handoff
from container_engine_accelerators_tpu_torch.obs import alerts as obs_alerts
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import flight as obs_flight
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.obs import ports as obs_ports
from container_engine_accelerators_tpu_torch.obs import trace as obs_trace

log = logging.getLogger(__name__)

EVENT_SOURCE = "fleet.router"

# Rotation states (bounded label set for tpu_router_replicas{state}).
READY = "ready"
EJECTED = "ejected"
DRAINING = "draining"
STATES = (READY, EJECTED, DRAINING)

# Replica roles (disaggregated prefill/decode serving; bounded set).
# ``unified`` replicas take any work; ``prefill`` replicas take only
# the prefill leg of a split request (max_new_tokens=1 — the KV blocks
# are the product, shipped onward by handoff); ``decode`` replicas take
# the decode continuation of handed-off prompts plus ordinary traffic
# when no prefill tier exists.
ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLES = (ROLE_UNIFIED, ROLE_PREFILL, ROLE_DECODE)

# Handoff latency envelope: in-process/loopback transfers land in the
# sub-millisecond buckets, HTTP transfers in the tens of milliseconds.
HANDOFF_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
)

# Request latency through the router (backend decode + routing): same
# envelope as the serving tier's end-to-end latency histogram.
LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# Ceiling on the IMPLICIT replica-count scaling of the hedge budget:
# the allowed fraction of routed requests never exceeds
# max(--hedge-budget-pct itself, this) however many replicas are READY
# — a large fleet cannot silently talk itself into hedging everything,
# while an operator who explicitly configures a higher percentage gets
# exactly what they asked for (see _hedge_budget_ok).
HEDGE_FRACTION_CEILING = 0.5


class NoReadyReplicas(RuntimeError):
    """Every replica is ejected/draining: the fleet has no capacity to
    route to. The HTTP layer maps it to 503 (retriable)."""


class TransportError(RuntimeError):
    """A dispatch to a replica failed at the transport layer (backend
    died, connection refused, malformed reply) — the re-issuable
    failure class, distinct from a typed backend rejection."""


class BackendShed(RuntimeError):
    """The backend itself shed the request (HTTP 429 / QueueFull): the
    server CHOSE to reject — surfaced to the client as a 429, never
    re-issued (the peer would shed too under fleet-wide overload, and
    doubling the attempt rate amplifies the storm). Router-originated
    tenant-policy sheds (quota / class share) raise the same class
    with ``tenant`` naming the shedding class."""

    def __init__(self, message, reason="shed", tenant=""):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant


def prefix_key(tokens, n_tokens=16):
    """Stable hash of the prompt's leading ``n_tokens`` tokens — the
    prefix-affinity routing key. Requests sharing a system prompt share
    this key, so the ring sends them to the replica whose KV cache
    already holds the shared prefill."""
    head = ",".join(str(int(t)) for t in tokens[:n_tokens])
    return hashlib.sha256(head.encode()).hexdigest()


class PrefixRing:
    """Consistent-hash ring: prefix key -> owning replica.

    ``vnodes`` virtual points per replica keep the key space spread
    even with a handful of replicas, and consistency means a replica
    joining/leaving only remaps ~1/N of the prefixes — the rest keep
    their warm KV caches."""

    def __init__(self, vnodes=64):
        self.vnodes = vnodes
        self._points = []  # sorted [(hash_hex, replica_id), ...]

    def _hashes(self, replica_id):
        for v in range(self.vnodes):
            yield hashlib.sha256(
                f"{replica_id}#{v}".encode()
            ).hexdigest()

    def add(self, replica_id):
        for h in self._hashes(replica_id):
            bisect.insort(self._points, (h, replica_id))

    def remove(self, replica_id):
        self._points = [
            p for p in self._points if p[1] != replica_id
        ]

    def owner(self, key):
        """The replica owning ``key`` (first point clockwise), or None
        on an empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_left(self._points, (key, ""))
        if i == len(self._points):
            i = 0
        return self._points[i][1]


class PrefixDirectory:
    """Fleet-global prefix directory: prefix key -> the replica whose
    KV cache holds that prefix's blocks.

    This replaces prefix *affinity-as-a-guess* with recorded fact: the
    consistent-hash ring still spreads keys, but when a ring remap, a
    hedge, or membership churn sends a request somewhere the blocks do
    NOT live, the router consults this directory and triggers a KV
    HANDOFF from the recorded holder instead of letting the new target
    re-prefill — fleet-wide ``prefix_hit_ratio`` survives a membership
    storm instead of resetting per replica.

    Entries are advisory (the holder may have evicted or died); every
    consumer falls back to re-prefill when the handoff fails. Bounded:
    ``max_entries`` oldest-insertion eviction."""

    def __init__(self, max_entries=65536):
        self.max_entries = max_entries
        self._where = collections.OrderedDict()  # key -> replica_id
        self._lock = threading.Lock()

    def record(self, key, replica_id):
        """The prompt behind ``key`` was prefilled (or installed) on
        ``replica_id``: its blocks live there now."""
        with self._lock:
            self._where.pop(key, None)
            self._where[key] = replica_id
            while len(self._where) > self.max_entries:
                self._where.popitem(last=False)

    def locate(self, key):
        """Where ``key``'s blocks live, or None (never recorded /
        evicted / forgotten)."""
        with self._lock:
            return self._where.get(key)

    def forget_replica(self, replica_id):
        """Drop every entry pointing at ``replica_id`` (it left the
        fleet for good — deregistration, not ejection: an ejected
        replica's cache is usually still warm when it returns)."""
        with self._lock:
            dead = [
                k for k, r in self._where.items() if r == replica_id
            ]
            for k in dead:
                del self._where[k]
        return len(dead)

    def __len__(self):
        with self._lock:
            return len(self._where)


class _DaemonPool:
    """A minimal reusable worker pool of DAEMON threads.

    The hedged dispatch path needs fire-and-forget execution with
    worker reuse (per-request thread spawn is measurable churn) but
    must never pin the process alive: stdlib ThreadPoolExecutor joins
    its non-daemon workers at interpreter exit, so one transport
    wedged in a 120 s socket timeout would stall shutdown. Workers
    here are daemonic and spawned on demand up to ``max_workers``;
    beyond that, submissions queue behind busy workers."""

    def __init__(self, max_workers=128):
        import queue as _queue

        self._max = max_workers
        self._q = _queue.Queue()
        self._lock = threading.Lock()
        self._workers = 0
        self._idle = 0

    def _worker(self):
        while True:
            with self._lock:
                self._idle += 1
            fn, args = self._q.get()
            with self._lock:
                self._idle -= 1
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 - runners handle their own
                log.exception("hedge-pool task failed")

    def submit(self, fn, *args):
        self._q.put((fn, args))
        with self._lock:
            # Spawn on DEMAND (queued tasks exceeding idle workers),
            # not on idle==0: two submits racing one worker's
            # idle-mark window would otherwise both skip the spawn and
            # serialize behind a single in-flight transport. A stale
            # read here can only over-spawn (harmless — the extra
            # worker just idles).
            spawn = (self._q.qsize() > self._idle
                     and self._workers < self._max)
            if spawn:
                self._workers += 1
        if spawn:
            threading.Thread(
                target=self._worker, name="router-hedge", daemon=True,
            ).start()


class ReplicaHandle:
    """The router's view of one backend replica.

    ``transport(payload) -> result dict`` dispatches one generate
    request (raises on failure); ``probe() -> dict`` fetches the cheap
    /healthz snapshot (raises when unreachable). ``host`` is the
    identity stamped on the replica's event-stream records, so tailed
    events route back to this handle."""

    def __init__(self, replica_id, transport, probe=None, host=None,
                 node="", capacity=8, role=ROLE_UNIFIED,
                 kv_export=None, kv_install=None):
        self.replica_id = replica_id
        self.transport = transport
        self.probe = probe
        # Disaggregated-serving role (prefill/decode/unified; may also
        # be learned from the /healthz probe's ``role`` field) and the
        # optional KV handoff hooks: ``kv_export(tokens) -> frames``
        # serializes the replica's cached prefix of ``tokens``,
        # ``kv_install(frames) -> summary`` installs a shipped stream
        # (kvcache/handoff.py wire format). None = the backend cannot
        # take part in handoffs (dense engine, old serve_cli).
        self.role = role if role in ROLES else ROLE_UNIFIED
        self.kv_export = kv_export
        self.kv_install = kv_install
        self.host = host if host is not None else replica_id
        # The node this replica serves from (autoscaler cordons it on
        # scale-in; empty when unknown/hermetic).
        self.node = node
        # KV slots the backend engine runs (--max-slots): the
        # occupancy denominator the autoscaler's idle signal uses.
        self.capacity = capacity
        self.state = READY
        self.inflight = 0
        self.queue_depth = 0
        self.occupied_slots = 0
        # Paged-backend signals from the /healthz probe (None until a
        # paged replica reports them): the spill guard prefers the
        # REPORTED hit ratio over the blind assumption that the ring
        # owner's prefix cache is warm.
        self.prefix_hit_ratio = None
        self.free_blocks = None
        # Per-tenant-class queue depths from the /healthz probe ({}
        # until a tenant-aware replica reports them): class-level
        # pressure for the day drill's assertions and operators'
        # /replicas view.
        self.tenant_queues = {}
        self.probe_failures = 0
        self.probe_successes = 0
        self.retired = 0
        self.last_latency_s = 0.0
        # Timestamp log for the shed-rate signal; pruned to the
        # trailing window by _note_shed. The maxlen is a memory
        # backstop only — it caps the MEASURABLE rate at
        # maxlen/shed_window_s (409/s at the default 10 s window),
        # far above any sane ejection threshold.
        self.shed_times = collections.deque(maxlen=4096)

    def load(self):
        """The scoring load: backend queue + occupancy from the last
        probe, plus what the router itself has in flight there (the
        probe can lag; in-flight never does)."""
        return self.queue_depth + self.occupied_slots + self.inflight

    def snapshot(self):
        return {
            "replica": self.replica_id,
            "state": self.state,
            "role": self.role,
            "load": self.load(),
            "inflight": self.inflight,
            "queue_depth": self.queue_depth,
            "occupied_slots": self.occupied_slots,
            "retired": self.retired,
            "last_latency_s": round(self.last_latency_s, 6),
            "node": self.node,
            "prefix_hit_ratio": self.prefix_hit_ratio,
            "free_blocks": self.free_blocks,
            "tenant_queues": dict(self.tenant_queues),
        }


class ReplicaRouter:
    """Routing policy + rotation state over a set of replicas.

    Thread-safe: handler threads submit concurrently while probe and
    event-tail threads update health state. The table lock is only ever
    held for in-memory bookkeeping — never across a transport dispatch,
    an event emit, or any I/O (the lock-discipline contract)."""

    def __init__(self, replicas=(), events=None, registry=None,
                 affinity_tokens=16, affinity_slack=4, eject_after=3,
                 readmit_after=2, shed_rate_threshold=0.0,
                 shed_window_s=10.0, vnodes=64, clock=time.monotonic,
                 hedge_after_ms=0.0, hedge_budget_pct=5.0,
                 tenants=None, tenant_oversub=2.0, handoff=False,
                 handoff_timeout_s=2.0, trace_sample=0.0):
        self.affinity_tokens = affinity_tokens
        self.affinity_slack = affinity_slack
        self.eject_after = eject_after
        self.readmit_after = readmit_after
        self.shed_rate_threshold = shed_rate_threshold
        self.shed_window_s = shed_window_s
        # Request hedging (0 = off): when the primary dispatch of a
        # request exceeds max(hedge_after_ms, the rolling p95 latency),
        # ONE hedge fires to a non-affinity peer under the same
        # idempotency key — the key is burned first, so the existing
        # at-most-once re-issue machinery can never add a third
        # dispatch. hedge_budget_pct caps hedges at that percentage of
        # routed requests (a straggling FLEET must not double its own
        # load).
        self.hedge_after_ms = hedge_after_ms
        self.hedge_budget_pct = hedge_budget_pct
        # Per-tenant admission at the fleet door (fleet/tenants.py;
        # None = off): token-rate quotas and per-class shares of fleet
        # capacity (ready-slot sum x tenant_oversub — capacity plus
        # roughly one queued request per slot).
        self.tenants = tenants
        self.tenant_oversub = tenant_oversub
        # Cross-replica KV handoff (disaggregated prefill/decode;
        # False = the pre-directory affinity-only behavior). When
        # armed, the fleet-global prefix directory records where each
        # prefix's blocks live, and remaps/hedges/re-issues ship the
        # blocks to the new target instead of re-prefilling.
        self.handoff = handoff
        self.handoff_timeout_s = handoff_timeout_s
        # Distributed-tracing head sampling (0 = tracing off unless the
        # client sent its own ``traceparent``): the fraction of ingress
        # requests that mint a sampled trace context. The decision is a
        # stable hash of the idempotency key — deterministic for the
        # chaos drills, uniform for real traffic. Error/hedge/handoff
        # paths force-upgrade an unsampled context (_upgrade_context),
        # so the journeys worth debugging are always retained.
        self.trace_sample = trace_sample
        self._directory = PrefixDirectory()
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas = {}
        self._by_host = {}
        self._ring = PrefixRing(vnodes=vnodes)
        self._keys = itertools.count(1)
        # Idempotency keys already re-issued once: a second failure of
        # the same key fails the request (at-most-once re-issue).
        # Hedged keys are burned here at hedge time — the two
        # mechanisms share one budget (a request never exceeds two
        # dispatches total, whatever mix of hedge/re-issue fired).
        self._reissued = set()
        # Rolling successful-request latencies: the hedge trigger's
        # p95, cached and refreshed every 32nd finish (the sort runs
        # outside the table lock). Submitted counts feed the budget.
        self._latencies = collections.deque(maxlen=512)
        self._finished = 0
        self._p95 = 0.0
        self._submitted = 0
        self._hedges_fired = 0
        # Shared dispatch pool for the hedged path (lazy): per-request
        # bare threads would churn one spawn per routed request with
        # hedging armed; a pool reuses idle workers in the common
        # (primary-finishes-fast) case.
        self._hedge_pool = None
        # Per-class requests currently in flight through the router
        # (client requests, not dispatches: a hedge pair counts once).
        self._class_inflight = {}
        # Hosts whose events we already warned about (bounded).
        self._unknown_hosts = set()
        reg = registry if registry is not None else obs_metrics.Registry()
        self.registry = reg
        self.events = events
        self._m_requests = obs_metrics.Counter(
            "tpu_router_requests_total",
            "Requests routed through the fleet router, by outcome "
            "(ok: first dispatch served; reissued_ok: served by a peer "
            "after the first replica failed; shed: backend 429; "
            "error: failed after the re-issue budget, or no ready "
            "replica to dispatch to)",
            ["outcome"], registry=reg)
        self._m_reissues = obs_metrics.Counter(
            "tpu_router_reissues_total",
            "In-flight requests re-issued to a peer after a replica "
            "failure (at most once per request, idempotency-keyed)",
            registry=reg)
        self._m_ejections = obs_metrics.Counter(
            "tpu_router_ejections_total",
            "Replicas ejected from rotation, by reason", ["reason"],
            registry=reg)
        self._m_readmissions = obs_metrics.Counter(
            "tpu_router_readmissions_total",
            "Ejected replicas re-admitted to rotation after recovery",
            registry=reg)
        self._m_affinity = obs_metrics.Counter(
            "tpu_router_affinity_total",
            "Prefix-affinity routing decisions (hit: the ring owner "
            "took the request; spill: owner too loaded, least-loaded "
            "peer took it; none: no affinity applicable)",
            ["result"], registry=reg)
        self._m_replicas = obs_metrics.Gauge(
            "tpu_router_replicas",
            "Replicas known to the router, by rotation state",
            ["state"], registry=reg)
        self._m_inflight = obs_metrics.Gauge(
            "tpu_router_inflight",
            "Requests currently dispatched to some replica",
            registry=reg)
        self._m_inflight.set_function(self._total_inflight)
        self._m_latency = obs_metrics.Histogram(
            "tpu_router_request_latency_seconds",
            "Routed request latency (dispatch to reply, re-issue "
            "included)", buckets=LATENCY_BUCKETS, registry=reg)
        self._m_hedges = obs_metrics.Counter(
            "tpu_router_hedges_total",
            "Hedge decisions on straggling primaries (won: the hedge's "
            "reply served the client; lost: the primary finished "
            "first; budget_denied: --hedge-budget-pct exhausted, no "
            "hedge dispatched)", ["outcome"], registry=reg)
        self._m_hedge_wasted = obs_metrics.Counter(
            "tpu_router_hedge_wasted_total",
            "Hedge losers that completed anyway (duplicate backend "
            "work the client never saw; the day drill's exactly-once "
            "retire accounting subtracts these)", registry=reg)
        self._m_handoffs = obs_metrics.Counter(
            "tpu_serving_handoffs_total",
            "Cross-replica KV handoff attempts, by outcome (ok: blocks "
            "installed on the target; miss: the recorded holder had "
            "nothing cached to export; desync: the stream failed the "
            "op_seq/digest replay check; timeout: the transfer blew "
            "its budget; error: export/install failed — every non-ok "
            "outcome falls back to re-prefill, the request is never "
            "lost)", ["outcome"], registry=reg)
        self._m_handoff_bytes = obs_metrics.Counter(
            "tpu_serving_handoff_bytes_total",
            "Wire bytes of successfully delivered KV handoff streams "
            "(framed delta ops, kvcache/handoff.py)", registry=reg)
        self._m_handoff_blocks = obs_metrics.Counter(
            "tpu_serving_handoff_blocks_total",
            "KV blocks shipped by successful cross-replica handoffs "
            "(installed + deduplicated on the receiver)", registry=reg)
        self._m_handoff_latency = obs_metrics.Histogram(
            "tpu_serving_handoff_latency_seconds",
            "End-to-end KV handoff latency (export, wire, verify, "
            "install)", buckets=HANDOFF_LATENCY_BUCKETS, registry=reg)
        if tenants is not None:
            self._m_tenant_shed = obs_metrics.Counter(
                "tpu_router_tenant_shed_total",
                "Requests shed at the fleet door by per-tenant "
                "admission policy, by tenant class and reason "
                "(quota: token-rate bucket outrun — exact against "
                "the scripted clock; class_share: the class's slice "
                "of fleet capacity full)",
                ["tenant_class", "reason"], registry=reg)
        for r in replicas:
            self.register(r)

    # -- rotation -------------------------------------------------------------

    def _total_inflight(self):
        with self._lock:
            return sum(r.inflight for r in self._replicas.values())

    def _set_state_gauge(self):
        # Called with the lock held; Gauge.labels().set is lock-free
        # in-memory bookkeeping, not I/O.
        counts = collections.Counter(
            r.state for r in self._replicas.values()
        )
        for state in STATES:
            self._m_replicas.labels(state).set(counts.get(state, 0))

    def register(self, replica):
        """Add a replica to rotation (and the affinity ring)."""
        with self._lock:
            self._replicas[replica.replica_id] = replica
            self._by_host[replica.host] = replica.replica_id
            replica.state = READY
            self._ring.add(replica.replica_id)
            self._set_state_gauge()
        if self.events is not None:
            self.events.emit(
                "replica_registered", replica=replica.replica_id,
                node=replica.node,
            )
        log.info("replica %s registered (host %s)", replica.replica_id,
                 replica.host)

    def deregister(self, replica_id):
        """Remove a replica entirely (autoscaler scale-in's last step:
        the replica was already drained)."""
        with self._lock:
            replica = self._replicas.pop(replica_id, None)
            if replica is None:
                return None
            # Drop EVERY host alias of this replica (the registered
            # host plus any probe-learned --replica-id identity): a
            # stale alias would both misroute a replacement's tailed
            # events to the removed id and block the replacement from
            # ever re-learning the alias.
            self._by_host = {
                h: rid for h, rid in self._by_host.items()
                if rid != replica_id
            }
            self._ring.remove(replica_id)
            self._set_state_gauge()
        # Its blocks are gone with it: directory entries pointing here
        # would only buy failed handoffs (ejection, by contrast, keeps
        # the entries — an ejected replica's cache is usually warm when
        # it returns, which is the membership-storm survival path).
        self._directory.forget_replica(replica_id)
        if self.events is not None:
            self.events.emit(
                "replica_deregistered", replica=replica_id,
            )
        return replica

    def eject(self, replica_id, reason):
        """Take a replica out of rotation (probe failures, Unhealthy
        flip, shed storm). Idempotent; its in-flight requests fail at
        the transport and re-issue through :meth:`submit`'s at-most-
        once path."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None or replica.state == EJECTED:
                return False
            replica.state = EJECTED
            replica.probe_successes = 0
            self._ring.remove(replica_id)
            self._set_state_gauge()
        self._m_ejections.labels(reason).inc()
        if self.events is not None:
            self.events.emit(
                "replica_ejected", severity="warning",
                replica=replica_id, reason=reason,
            )
        log.warning("replica %s ejected from rotation (%s)",
                    replica_id, reason)
        return True

    def readmit(self, replica_id):
        """Return a recovered replica to rotation (and the ring)."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None or replica.state != EJECTED:
                return False
            replica.state = READY
            replica.probe_failures = 0
            self._ring.add(replica_id)
            self._set_state_gauge()
        self._m_readmissions.inc()
        if self.events is not None:
            self.events.emit(
                "replica_readmitted", replica=replica_id,
            )
        log.info("replica %s re-admitted to rotation", replica_id)
        return True

    def mark_draining(self, replica_id):
        """Stop routing NEW work to a replica while its in-flight work
        completes (the autoscaler's lossless scale-in gate). Returns
        the handle (or None)."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return None
            replica.state = DRAINING
            self._ring.remove(replica_id)
            self._set_state_gauge()
        if self.events is not None:
            self.events.emit(
                "replica_draining", replica=replica_id,
            )
        return replica

    def replicas(self, state=None):
        with self._lock:
            out = list(self._replicas.values())
        if state is not None:
            out = [r for r in out if r.state == state]
        return out

    def snapshot(self):
        """Rotation state for /replicas and the autoscaler."""
        with self._lock:
            return [r.snapshot() for r in self._replicas.values()]

    def occupancy(self):
        """Fleet-load fraction in [0, 1]: queued + in-flight work over
        total ready-replica count (the autoscaler's idle signal; 1.0 is
        clamped — the signal saturates, it does not rank overloads)."""
        with self._lock:
            ready = [
                r for r in self._replicas.values() if r.state == READY
            ]
            if not ready:
                return 0.0
            load = sum(r.load() for r in ready)
            cap = sum(max(1, r.capacity) for r in ready)
        return min(1.0, load / cap)

    # -- routing --------------------------------------------------------------

    def _has_role(self, role):
        """True when some READY replica is dedicated to ``role`` — the
        gate for running a split prefill/decode flow at all."""
        with self._lock:
            return any(
                r.state == READY and r.role == role
                for r in self._replicas.values()
            )

    def _pick(self, tokens, exclude=(), role=None):
        """Choose the target replica for one request; bumps its
        in-flight count under the lock so racing picks spread.
        Returns (replica, affinity_result). ``role`` narrows the
        candidate pool to replicas of that role (plus unified ones);
        the narrowing is advisory — when no replica of the wanted role
        is READY the full pool serves (a fleet must not 503 because
        its prefill tier is briefly empty)."""
        key = (
            prefix_key(tokens, self.affinity_tokens)
            if self.affinity_tokens > 0 else None
        )
        with self._lock:
            ready = [
                r for r in self._replicas.values()
                if r.state == READY and r.replica_id not in exclude
            ]
            if not ready:
                raise NoReadyReplicas(
                    "no ready replicas in rotation"
                )
            if role is not None:
                pool = [
                    r for r in ready
                    if r.role in (role, ROLE_UNIFIED)
                ]
                if pool:
                    ready = pool
            # Deterministic tie-break: stable sort by id, then pick the
            # minimum load.
            ready.sort(key=lambda r: r.replica_id)
            least = min(ready, key=lambda r: r.load())
            affinity = "none"
            chosen = least
            if key is not None:
                owner_id = self._ring.owner(key)
                owner = self._replicas.get(owner_id)
                if (
                    owner is not None and owner.state == READY
                    and owner.replica_id not in exclude
                    and owner in ready
                ):
                    # Spill guard: how much extra load may the prefix
                    # owner carry before the request spills to the
                    # least-loaded peer. When the owner's probe
                    # reports its ACTUAL prefix-cache hit ratio
                    # (serve_cli --kv-cache=paged /healthz), that
                    # evidence replaces the blind-hash assumption: a
                    # provably warm cache (ratio 1.0) earns up to 2x
                    # slack, a cold one (ratio 0 — e.g. a replacement
                    # replica whose blocks were never filled) spills
                    # at any load disadvantage. Dense backends report
                    # nothing and keep the flat slack.
                    slack = self.affinity_slack
                    ratio = owner.prefix_hit_ratio
                    if ratio is not None:
                        slack = self.affinity_slack * 2 * ratio
                    if owner.load() <= least.load() + slack:
                        chosen, affinity = owner, "hit"
                    else:
                        affinity = "spill"
            chosen.inflight += 1
        self._m_affinity.labels(affinity).inc()
        return chosen, affinity

    def _finish(self, replica, ok, latency_s=0.0):
        refresh = None
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)
            if ok:
                replica.retired += 1
                replica.last_latency_s = latency_s
                self._latencies.append(latency_s)
                self._finished += 1
                if self._finished % 32 == 0:
                    # Snapshot only under the lock; the O(n log n)
                    # sort happens OUTSIDE it (this lock serializes
                    # every pick/probe — a per-request sort inside it
                    # would throttle routing throughput).
                    refresh = list(self._latencies)
        if refresh is not None and len(refresh) >= 20:
            refresh.sort()
            self._p95 = refresh[min(len(refresh) - 1,
                                    int(0.95 * len(refresh)))]

    def _burn_key(self, key):
        """Mark ``key`` as having spent its one extra-dispatch budget
        (hedge or re-issue — they share it). Bounded: keys are
        single-use, so a full set only means very old keys lose their
        guard."""
        with self._lock:
            self._reissued.add(key)
            if len(self._reissued) > 65536:
                self._reissued.clear()
                self._reissued.add(key)

    # -- distributed tracing: context mint / propagate / upgrade --------------

    def _head_sampled(self, key):
        """Stable head-sampling decision for ``key``: a hash of the
        idempotency key against ``trace_sample`` — deterministic across
        reruns (the chaos drills pin journeys by seed), no RNG state."""
        if self.trace_sample >= 1.0:
            return True
        if self.trace_sample <= 0.0:
            return False
        h = hashlib.sha256(str(key).encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64 < self.trace_sample

    def _trace_context(self, payload, key):
        """Resolve this request's trace context at ingress.

        Returns ``(payload, ctx)``. ``ctx`` is None when tracing is off
        for this request — no inbound ``traceparent`` and no head
        sampling armed — and that path generates NO ids and formats NO
        headers (the disarmed-cost contract: one dict lookup and two
        float compares). With a context, the outgoing payload carries
        the router's own ``traceparent`` (same trace_id, a fresh router
        span_id the replica adopts as its parent)."""
        inbound = payload.get("traceparent")
        if inbound is None and self.trace_sample <= 0.0:
            return payload, None
        parsed = obs_trace.parse_traceparent(inbound) if inbound else None
        if parsed is not None:
            trace_id, parent_id, sampled = parsed
            sampled = sampled or self._head_sampled(key)
        else:
            if inbound is not None:
                log.debug("malformed traceparent %r; minting fresh",
                          inbound)
            trace_id = obs_trace.new_trace_id()
            parent_id = ""
            sampled = self._head_sampled(key)
        ctx = {
            "trace_id": trace_id,
            "span_id": obs_trace.new_span_id(),
            "parent_id": parent_id,
            "sampled": sampled,
        }
        tp = obs_trace.format_traceparent(
            trace_id, ctx["span_id"], sampled
        )
        return dict(payload, traceparent=tp), ctx

    def _upgrade_context(self, payload, ctx):
        """Force-sample a request's context: errors, hedges, re-issues
        and handoffs are exactly the journeys worth keeping, so the
        head-sampling decision is overridden at the first such signal.
        Returns the payload to dispatch (re-formatted header when the
        flag actually flipped)."""
        if ctx is None or ctx["sampled"]:
            return payload
        ctx["sampled"] = True
        tp = obs_trace.format_traceparent(
            ctx["trace_id"], ctx["span_id"], True
        )
        return dict(payload, traceparent=tp)

    def _traced_transport(self, replica, payload, ctx, leg):
        """One transport dispatch, with its client-side RPC envelope
        recorded as a ``dispatch`` span when the tracer is on. The
        envelope CONTAINS the replica's server-side processing span by
        construction — the RPC-edge bound the journey stitcher uses to
        tighten barrier-only clock-skew estimates."""
        if ctx is not None and obs_trace.enabled():
            return self._transport_spanned(replica, payload, ctx, leg)
        return replica.transport(payload)

    def _transport_spanned(self, replica, payload, ctx, leg):
        # Only reached armed (see _traced_transport): the f-string and
        # the span record are never built on the disarmed path.
        tid = ctx["trace_id"]
        track = f"req-{tid[:12]}"
        rid = replica.replica_id
        t0 = obs_trace.now()
        err = ""
        try:
            return replica.transport(payload)
        except Exception as e:
            err = type(e).__name__
            raise
        finally:
            obs_trace.event(
                "dispatch", t0, obs_trace.now() - t0, track=track,
                trace_id=tid, replica=rid, leg=leg, error=err,
            )

    def _route_span(self, ctx, tr0):
        """Close the router's client-envelope span for one request (the
        journey waterfall's root on the router host)."""
        tid = ctx["trace_id"]
        track = f"req-{tid[:12]}"
        sampled = ctx["sampled"]
        obs_trace.event(
            "route", tr0, obs_trace.now() - tr0, track=track,
            trace_id=tid, sampled=sampled,
        )

    # -- cross-replica KV handoff ---------------------------------------------

    def _request_key(self, tokens):
        if not tokens or self.affinity_tokens <= 0:
            return None
        return prefix_key(tokens, self.affinity_tokens)

    def prefix_holder(self, tokens):
        """Where the fleet-global prefix directory believes
        ``tokens``'s cached KV blocks live (replica id, or None when
        unknown/handoff disabled). Observability and test surface —
        dispatch consults the directory internally."""
        key = self._request_key(tokens)
        return self._directory.locate(key) if key else None

    def _record_prefix(self, first_row, replica):
        """A request just retired on ``replica``: its prompt's blocks
        live there now (the engine's retire path caches them in its
        radix tree) — record the fact in the fleet-global directory."""
        if not self.handoff:
            return
        key = self._request_key(first_row)
        if key is not None:
            self._directory.record(key, replica.replica_id)

    def _maybe_handoff_to(self, target, first_row, ctx=None):
        """Ring remap / hedge / re-issue landed this prompt on a
        replica its blocks do NOT live on: if the directory knows the
        holder, ship the blocks over instead of re-prefilling.
        Best-effort — False means the target will re-prefill (the
        request is never blocked on a failed transfer)."""
        if not self.handoff:
            return False
        key = self._request_key(first_row)
        if key is None:
            return False
        src_id = self._directory.locate(key)
        if src_id is None or src_id == target.replica_id:
            return False
        return self._kv_handoff(key, src_id, target, first_row, ctx)

    def _kv_handoff(self, key, src_id, target, tokens, ctx=None):
        """One export→wire→install transfer of ``tokens``'s cached
        prefix from ``src_id`` to ``target``. Success records the new
        holder; every failure emits ``kv_handoff_failed`` with the
        seconds the attempt burned (``lost_s`` — the goodput ledger
        charges it to ``drain_migration`` badput) and returns False so
        the caller falls back to re-prefill."""
        with self._lock:
            src = self._replicas.get(src_id)
        if (src is None or src.kv_export is None
                or target.kv_install is None):
            return False
        # A handoff is a journey-defining hop: force-sample the context
        # and ship it on the export/install calls (it rides the stream's
        # HELLO frame end to end), so the transfer leg stitches into the
        # request's waterfall on both replicas.
        tid = ""
        if ctx is not None:
            self._upgrade_context({}, ctx)
            tid = ctx["trace_id"]
        t0 = time.perf_counter()
        try:
            if ctx is not None:
                tp = obs_trace.format_traceparent(
                    tid, ctx["span_id"], True
                )
                frames = src.kv_export(tokens, traceparent=tp)
            else:
                frames = src.kv_export(tokens)
            frames = kv_handoff.perturb_frames(
                frames, timeout_s=self.handoff_timeout_s,
            )
            result = target.kv_install(frames)
        except kv_handoff.HandoffUnsupported:
            # Nothing cached at the recorded holder (evicted, or the
            # prompt was shorter than a block): a quiet miss, not a
            # failure — there were no blocks to lose.
            self._m_handoffs.labels("miss").inc()
            return False
        except Exception as e:  # noqa: BLE001 - fallback is re-prefill
            dt = time.perf_counter() - t0
            if isinstance(e, kv_handoff.HandoffTimeout):
                outcome = "timeout"
            elif isinstance(e, kv_handoff.HandoffDesync):
                outcome = "desync"
            else:
                outcome = "error"
            self._m_handoffs.labels(outcome).inc()
            if self.events is not None:
                self.events.emit(
                    "kv_handoff_failed", severity="warning", key=key,
                    src=src_id, dst=target.replica_id, reason=outcome,
                    error=str(e), lost_s=dt, trace_id=tid,
                )
            log.warning(
                "kv handoff %s -> %s failed (%s): %s; falling back to "
                "re-prefill", src_id, target.replica_id, outcome, e,
            )
            return False
        dt = time.perf_counter() - t0
        shipped = (result.get("installed_blocks", 0)
                   + result.get("duplicate_blocks", 0))
        nbytes = result.get("nbytes", 0)
        self._m_handoffs.labels("ok").inc()
        self._m_handoff_bytes.inc(nbytes)
        self._m_handoff_blocks.inc(shipped)
        self._m_handoff_latency.observe(dt)
        self._directory.record(key, target.replica_id)
        if self.events is not None:
            self.events.emit(
                "kv_handoff", key=key, src=src_id,
                dst=target.replica_id, blocks=shipped, nbytes=nbytes,
                latency_s=dt, trace_id=tid,
            )
        if obs_trace.enabled():
            # The handoff leg on the request's synthetic track — it
            # sits exactly where the re-prefill it replaced would.
            obs_trace.event(
                "kv_handoff", obs_trace.now() - dt, dt,
                track=f"req-{key[:12]}", src=src_id,
                dst=target.replica_id, blocks=shipped, trace_id=tid,
            )
        return True

    def _prepare_prefix(self, payload, first_row, target, ctx=None):
        """Make ``target``'s cache warm for this prompt before the
        main dispatch. Directory hit elsewhere -> handoff the blocks
        over. Cold prefix + a dedicated prefill tier -> run the
        prefill leg there first (max_new_tokens=1: the KV blocks are
        the product), then hand the blocks to ``target``. The resolved
        tenant class rides ``payload`` into the prefill leg, so
        admission/accounting follow the request across the split."""
        if not self.handoff:
            return
        key = self._request_key(first_row)
        if key is None:
            return
        src_id = self._directory.locate(key)
        if src_id == target.replica_id:
            return  # blocks already local: the directory's hit path
        if src_id is None:
            if (target.role == ROLE_PREFILL
                    or not self._has_role(ROLE_PREFILL)):
                return  # unified fleet: first touch just prefills
            try:
                pre, _ = self._pick(
                    first_row, exclude=(target.replica_id,),
                    role=ROLE_PREFILL,
                )
            except NoReadyReplicas:
                return
            try:
                self._traced_transport(
                    pre, dict(payload, max_new_tokens=1), ctx, "prefill",
                )
            except Exception as e:  # noqa: BLE001 - fall back to local
                self._finish(pre, ok=False)
                log.debug("prefill leg on %s failed (%s); %s will "
                          "prefill locally", pre.replica_id, e,
                          target.replica_id)
                return
            # Internal leg: undo the pick's in-flight bump without
            # feeding the hedge trigger's latency sample (ok=False is
            # bookkeeping-only — the leg is not a client request).
            self._finish(pre, ok=False)
            self._directory.record(key, pre.replica_id)
            src_id = pre.replica_id
        self._kv_handoff(key, src_id, target, first_row, ctx)

    # -- tenant admission at the fleet door -----------------------------------

    def _admit_tenant(self, payload, ctx=None):
        """Resolve + enforce the request's tenant class; returns the
        payload to dispatch (tenant resolved to its class name, so the
        backend's own admission sees the same bounded enum). Raises
        :class:`BackendShed` (→ 429) on a policy shed."""
        if self.tenants is None:
            return payload, None
        tcls = self.tenants.resolve(payload.get("tenant"))
        rows = len(payload.get("tokens") or [[]])
        # Class share FIRST, quota LAST: only work that passes every
        # other gate may consume bucket tokens — a share-shed request
        # (and its client's retries) must not drain the quota and
        # convert a transient capacity shed into a prolonged quota
        # outage.
        with self._lock:
            cap = sum(
                max(1, r.capacity)
                for r in self._replicas.values() if r.state == READY
            )
            cur = self._class_inflight.get(tcls.name, 0)
        bound = max(
            1, int(tcls.queue_share * cap * self.tenant_oversub)
        )
        if cur + rows > bound:
            self._shed_tenant(tcls, rows, "class_share", ctx)
        want = rows * int(payload.get("max_new_tokens", 16) or 0)
        if not self.tenants.try_consume(tcls.name, want):
            self._shed_tenant(tcls, rows, "quota", ctx)
        return dict(payload, tenant=tcls.name), tcls

    def _shed_tenant(self, tcls, rows, reason, ctx=None):
        self._m_requests.labels("shed").inc()
        self._m_tenant_shed.labels(tcls.name, reason).inc(rows)
        if self.events is not None:
            # A shed is an error-class outcome: force-sample so the
            # journey (however short) is always reconstructable.
            tid = ""
            if ctx is not None:
                self._upgrade_context({}, ctx)
                tid = ctx["trace_id"]
            self.events.emit(
                "tenant_shed", severity="warning",
                tenant_class=tcls.name, reason=reason, rows=rows,
                trace_id=tid,
            )
        raise BackendShed(
            f"tenant class {tcls.name} over its {reason} bound at the "
            f"fleet door; retry with backoff",
            reason=reason, tenant=tcls.name,
        )

    def _class_enter(self, tcls, rows):
        if tcls is None:
            return
        with self._lock:
            self._class_inflight[tcls.name] = (
                self._class_inflight.get(tcls.name, 0) + rows
            )

    def _class_exit(self, tcls, rows):
        if tcls is None:
            return
        with self._lock:
            self._class_inflight[tcls.name] = max(
                0, self._class_inflight.get(tcls.name, 0) - rows
            )

    # -- hedging --------------------------------------------------------------

    def _hedge_delay_s(self):
        """How long the primary may run before a hedge fires: the
        cached rolling p95 of successful request latencies (refreshed
        every 32nd finish), floored at ``hedge_after_ms`` (the floor
        alone until enough samples — a cold router must not hedge on
        noise)."""
        return max(self.hedge_after_ms / 1e3, self._p95)

    def _dispatch_async(self, fn, *args):
        """Run ``fn(*args)`` on the shared hedge pool (created lazily;
        bounded DAEMON worker reuse instead of one bare thread per
        request — and unlike ThreadPoolExecutor's non-daemon workers,
        a transport wedged mid-dispatch can never block process
        exit)."""
        with self._lock:
            if self._hedge_pool is None:
                self._hedge_pool = _DaemonPool(max_workers=128)
            pool = self._hedge_pool
        pool.submit(fn, *args)

    def _hedge_budget_ok(self):
        """True when one more hedge stays within the fleet's budget:
        ``hedge_budget_pct`` of routed requests PER READY REPLICA
        (cumulative over both — deterministic for the drill and
        converging to the rate under sustained traffic), hard-capped
        at ``HEDGE_FRACTION_CEILING`` of all routed requests.

        Denominated per replica because a hedge's cost is duplicate
        work landing on ONE peer, and the peer pool that absorbs it
        grows with the fleet: a 3-replica fleet at the 5% default
        absorbs hedges for up to 15% of requests while a
        single-replica fleet keeps the strict 5% (where a duplicate
        directly competes with the straggling primary). The ceiling
        caps only the IMPLICIT replica scaling — it keeps the backstop
        meaningful on large fleets (a 20-replica fleet at the 5%
        default caps at 50%, not 100%, of requests; the p95 trigger is
        the first line of defense, the budget the hard stop) without
        second-guessing an operator who explicitly configured a higher
        percentage. Replica count is read at decision time — a fleet
        that just lost replicas to ejection immediately tightens its
        own hedging."""
        pct = self.hedge_budget_pct / 100.0
        with self._lock:
            ready = sum(
                1 for r in self._replicas.values() if r.state == READY
            )
            fraction = min(
                pct * max(1, ready),
                max(pct, HEDGE_FRACTION_CEILING),
            )
            allowed = fraction * self._submitted
            if self._hedges_fired + 1 > allowed:
                return False
            self._hedges_fired += 1
            return True

    def submit(self, payload, key=None, tenant=None):
        """Route one generate request (``payload`` is the transport's
        request dict, e.g. the POST /generate body). On a transport
        failure the request is re-issued ONCE to a peer under the same
        idempotency key; a second failure raises. Backend sheds
        (:class:`BackendShed`) are never re-issued. With hedging armed
        (``hedge_after_ms > 0``) a straggling primary gets ONE hedge
        dispatch to a peer — hedge and re-issue share the same
        at-most-once key budget, so no request ever reaches a third
        dispatch."""
        if key is None:
            key = f"rk-{next(self._keys)}"
        if tenant is not None and "tenant" not in payload:
            payload = dict(payload, tenant=tenant)
        # Mint (or adopt) the trace context FIRST: even a tenant shed
        # at the door must carry the request's trace_id.
        payload, ctx = self._trace_context(payload, key)
        tr0 = None
        if ctx is not None and obs_trace.enabled():
            tr0 = obs_trace.now()
        payload, tcls = self._admit_tenant(payload, ctx)
        tokens = payload.get("tokens") or [[]]
        first_row = tokens[0] if tokens else []
        rows = len(tokens)
        with self._lock:
            self._submitted += 1
            burned = key in self._reissued
        self._class_enter(tcls, rows)
        t0 = time.perf_counter()
        try:
            # Decode requests go to decode capacity; prefill-only work
            # (max_new_tokens <= 1 — the KV blocks are the product, it
            # never enters a decode batch) goes to prefill capacity. A
            # unified replica counts as both, so role-less fleets see
            # the identical pick order.
            want_role = ROLE_DECODE
            if int(payload.get("max_new_tokens", 16) or 0) <= 1:
                want_role = ROLE_PREFILL
            try:
                replica, _ = self._pick(first_row, role=want_role)
            except NoReadyReplicas:
                # A total-capacity outage must still move the request
                # counter: the burn-rate scale-out rule computes
                # bad/total over this metric, and zero ready replicas
                # is exactly the moment it has to fire.
                self._m_requests.labels("error").inc()
                raise
            if want_role == ROLE_DECODE:
                self._prepare_prefix(payload, first_row, replica, ctx)
            if self.hedge_after_ms > 0 and not burned:
                return self._submit_hedged(
                    payload, key, replica, first_row, t0, ctx
                )
            try:
                out = self._traced_transport(
                    replica, payload, ctx, "primary",
                )
            except BackendShed:
                self._finish(replica, ok=False)
                self._m_requests.labels("shed").inc()
                raise
            except Exception as first_err:  # noqa: BLE001 - re-issue once
                self._finish(replica, ok=False)
                return self._reissue(
                    payload, key, replica, first_err, t0, first_row, ctx
                )
            dt = time.perf_counter() - t0
            self._finish(replica, ok=True, latency_s=dt)
            self._m_requests.labels("ok").inc()
            self._m_latency.observe(dt)
            self._record_prefix(first_row, replica)
            return out
        finally:
            self._class_exit(tcls, rows)
            if tr0 is not None:
                self._route_span(ctx, tr0)

    def _submit_hedged(self, payload, key, primary, first_row, t0,
                       ctx=None):
        """Primary dispatch with a budgeted hedge behind it.

        The primary runs on a worker thread; if it exceeds the hedge
        delay (rolling p95, floored at ``hedge_after_ms``) and the
        budget allows, the SAME payload goes to a non-affinity peer
        under the SAME (now burned) idempotency key. First success
        wins; the loser's late completion is discarded (its duplicate
        work counted in ``tpu_router_hedge_wasted_total``). With the
        key burned, neither arm may re-issue — two dispatches is the
        hard ceiling, whatever fails. A primary failing BEFORE any
        hedge fired falls through to the classic re-issue path (its
        key was never burned), so the two mechanisms compose to the
        same at-most-two-dispatch contract."""
        import queue as _queue

        results = _queue.Queue()
        state = {"decided": False}
        state_lock = threading.Lock()
        tid = ctx["trace_id"] if ctx is not None else ""
        # Seconds from primary dispatch to the hedge decision — emitted
        # on every request_hedged/request_reissued event so the goodput
        # ledger can charge the duplicate-dispatch wait to the request.
        elapsed = 0.0

        def run(name, replica, pl):
            out = err = None
            try:
                out = self._traced_transport(replica, pl, ctx, name)
            except Exception as e:  # noqa: BLE001 - routed to resolver
                err = e
            with state_lock:
                if not state["decided"]:
                    # put-under-lock: atomic with the decided check,
                    # so a completion races either INTO the queue
                    # (drained below) or into the loser path — never
                    # into neither.
                    results.put((name, replica, out, err))
                    return
            # Loser: the client already has its answer. Close the
            # bookkeeping; successful duplicates are wasted work.
            self._finish(replica, ok=False)
            if out is not None:
                self._m_hedge_wasted.inc()

        def close_loser(item):
            _, rep, out2, _ = item
            self._finish(rep, ok=False)
            if out2 is not None:
                self._m_hedge_wasted.inc()

        self._dispatch_async(run, "primary", primary, payload)
        try:
            first = results.get(timeout=self._hedge_delay_s())
        except _queue.Empty:
            first = None
        hedged = False
        if first is None:
            elapsed = time.perf_counter() - t0
            # Primary is straggling past the trigger: hedge if a peer
            # and the budget allow; otherwise keep waiting on the
            # primary. Peer first — a fleet with nowhere to hedge must
            # not burn budget on the attempt.
            try:
                peer, _ = self._pick(
                    first_row, exclude=(primary.replica_id,)
                )
            except NoReadyReplicas:
                peer = None
            if peer is not None and not self._hedge_budget_ok():
                self._finish(peer, ok=False)  # picked but never sent
                peer = None
                self._m_hedges.labels("budget_denied").inc()
                if self.events is not None:
                    self.events.emit(
                        "request_hedged", key=key,
                        outcome="budget_denied",
                        replica=primary.replica_id,
                        trace_id=tid, elapsed_s=elapsed,
                    )
            if peer is not None:
                hedged = True
                # A hedge is a journey-defining hop: force-sample the
                # context so the duplicate-dispatch race is always
                # reconstructable, and ship the upgraded traceparent
                # on the hedge arm.
                hedge_payload = self._upgrade_context(payload, ctx)
                # The hedge lands off the affinity owner by design:
                # ship the owner's KV blocks over rather than letting
                # the hedge arm pay a cold re-prefill (best-effort; a
                # failed handoff just means the peer prefills).
                self._maybe_handoff_to(peer, first_row, ctx)
                # Burn the key BEFORE the second dispatch: the
                # re-issue machinery sees it and will never add a
                # third attempt, whichever arm fails later.
                self._burn_key(key)
                self._dispatch_async(run, "hedge", peer, hedge_payload)
            first = results.get()
        name, replica, out, err = first
        if out is None and hedged:
            # First completion failed but the other arm is still in
            # flight — its result decides. Close the failed arm now.
            self._finish(replica, ok=False)
            errs = {name: err}
            name, replica, out, err = results.get()
            if out is None:
                # Both failed: the PRIMARY's error speaks for the
                # client — the hedge was the router's own duplicate
                # demand, and e.g. a hedge arm shed by a backend
                # tenant quota must not surface as a 429 the client
                # never earned.
                errs[name] = err
                err = errs.get("primary", err)
        # Decision point: everything after this is the winner's
        # accounting; late completions take the loser path themselves,
        # and anything that raced into the queue first is drained.
        with state_lock:
            state["decided"] = True
        while True:
            try:
                item = results.get_nowait()
            except _queue.Empty:
                break
            close_loser(item)
        if out is not None:
            dt = time.perf_counter() - t0
            self._finish(replica, ok=True, latency_s=dt)
            self._m_requests.labels("ok").inc()
            self._m_latency.observe(dt)
            self._record_prefix(first_row, replica)
            if hedged:
                outcome = "won" if name == "hedge" else "lost"
                self._m_hedges.labels(outcome).inc()
                if self.events is not None:
                    self.events.emit(
                        "request_hedged", key=key, outcome=outcome,
                        replica=replica.replica_id,
                        trace_id=tid, elapsed_s=elapsed,
                    )
            return out
        # No success anywhere.
        self._finish(replica, ok=False)
        if not hedged:
            if isinstance(err, BackendShed):
                self._m_requests.labels("shed").inc()
                raise err
            # Primary failed before any hedge fired: the classic
            # at-most-once re-issue machinery takes over (the key was
            # never burned on this path).
            return self._reissue(
                payload, key, primary, err, t0, first_row, ctx
            )
        # Both arms failed: the key is burned, nothing may fan out
        # further. Prefer the shed (a typed 429 the client backs off
        # from) over the transport error.
        self._m_hedges.labels("lost").inc()
        if self.events is not None:
            self.events.emit(
                "request_hedged", key=key, outcome="lost",
                replica=replica.replica_id,
                trace_id=tid, elapsed_s=elapsed,
            )
        if isinstance(err, BackendShed):
            self._m_requests.labels("shed").inc()
            raise err
        self._m_requests.labels("error").inc()
        raise TransportError(
            f"request {key} failed on both the primary and its hedge: "
            f"{err}"
        ) from err

    def _reissue(self, payload, key, failed, first_err, t0, first_row,
                 ctx=None):
        """The at-most-once re-issue path: dispatch the SAME request
        (same idempotency key) to a peer of the failed replica."""
        with self._lock:
            already = key in self._reissued
            if not already:
                self._reissued.add(key)
                if len(self._reissued) > 65536:
                    # Bounded memory: keys are single-use; a full set
                    # only means very old keys lose their guard.
                    self._reissued.clear()
                    self._reissued.add(key)
        if already:
            self._m_requests.labels("error").inc()
            raise TransportError(
                f"request {key} already re-issued once; not fanning "
                f"out further"
            ) from first_err
        try:
            peer, _ = self._pick(
                first_row, exclude=(failed.replica_id,)
            )
        except NoReadyReplicas:
            self._m_requests.labels("error").inc()
            raise
        # Count/emit only once a peer actually took the re-issue: a
        # no-peer failure is an outright error, not a re-issue that
        # never happened.
        self._m_reissues.inc()
        # A re-issue is an error-path hop: force-sample the context so
        # the retry always stitches, and ship the upgraded traceparent.
        elapsed = time.perf_counter() - t0
        tid = ctx["trace_id"] if ctx is not None else ""
        payload = self._upgrade_context(payload, ctx)
        if self.events is not None:
            self.events.emit(
                "request_reissued", severity="warning", key=key,
                replica=failed.replica_id, error=str(first_err),
                trace_id=tid, elapsed_s=elapsed,
            )
        # The re-issue peer is by construction NOT the replica whose
        # radix tree holds this prompt: hand the blocks over first so
        # the retry doesn't also pay a cold prefill.
        self._maybe_handoff_to(peer, first_row, ctx)
        try:
            out = self._traced_transport(peer, payload, ctx, "reissue")
        except BackendShed:
            self._finish(peer, ok=False)
            self._m_requests.labels("shed").inc()
            raise
        except Exception as second_err:  # noqa: BLE001 - budget spent
            self._finish(peer, ok=False)
            self._m_requests.labels("error").inc()
            raise TransportError(
                f"request {key} failed on {failed.replica_id} and on "
                f"the re-issue peer {peer.replica_id}: {second_err}"
            ) from second_err
        dt = time.perf_counter() - t0
        self._finish(peer, ok=True, latency_s=dt)
        self._m_requests.labels("reissued_ok").inc()
        self._m_latency.observe(dt)
        self._record_prefix(first_row, peer)
        return out

    # -- health intake --------------------------------------------------------

    def observe_probe(self, replica_id, ok, info=None):
        """One health-probe result for ``replica_id``. ``eject_after``
        consecutive failures eject it; ``readmit_after`` consecutive
        successes of an ejected replica re-admit it."""
        eject = readmit = False
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return
            if ok:
                replica.probe_failures = 0
                if info:
                    replica.queue_depth = int(
                        info.get("queue_depth", 0) or 0
                    )
                    replica.occupied_slots = int(
                        info.get("occupied_slots", 0) or 0
                    )
                    if info.get("max_slots"):
                        replica.capacity = int(info["max_slots"])
                    if info.get("prefix_hit_ratio") is not None:
                        replica.prefix_hit_ratio = float(
                            info["prefix_hit_ratio"]
                        )
                    if info.get("free_blocks") is not None:
                        replica.free_blocks = int(info["free_blocks"])
                    if info.get("role") in ROLES:
                        # Self-reported serving role (serve_cli
                        # --role): dispatch narrows picks by it.
                        replica.role = info["role"]
                    if isinstance(info.get("tenant_queues"), dict):
                        replica.tenant_queues = dict(
                            info["tenant_queues"]
                        )
                    # Learn the replica's self-reported identity
                    # (serve_cli --replica-id): its event-stream
                    # records carry THAT host, not the URL the CLI
                    # registered, so alias it or tailed events would
                    # drop as unknown-host.
                    ident = info.get("replica")
                    if ident and ident not in self._by_host:
                        self._by_host[ident] = replica.replica_id
                if replica.state == EJECTED:
                    replica.probe_successes += 1
                    readmit = (
                        replica.probe_successes >= self.readmit_after
                    )
            else:
                replica.probe_successes = 0
                replica.probe_failures += 1
                eject = (
                    replica.state == READY
                    and replica.probe_failures >= self.eject_after
                )
        if eject:
            self.eject(replica_id, reason="probe_failed")
        if readmit:
            self.readmit(replica_id)

    def _note_shed(self, replica_id):
        """Shed-rate tracking: a replica shedding faster than
        ``shed_rate_threshold`` per second over ``shed_window_s`` is
        overloaded beyond its admission bound — eject it so the ring
        stops feeding it (0 = disabled)."""
        if not self.shed_rate_threshold:
            return
        now = self._clock()
        eject = False
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return
            replica.shed_times.append(now)
            # Prune by timestamp (not a fixed count) so the window
            # holds every shed it should, and memory stays bounded by
            # the true rate x window.
            while (replica.shed_times
                   and replica.shed_times[0] < now - self.shed_window_s):
                replica.shed_times.popleft()
            rate = len(replica.shed_times) / self.shed_window_s
            eject = (
                replica.state == READY
                and rate > self.shed_rate_threshold
            )
        if eject:
            self.eject(replica_id, reason="shed_rate")

    def ingest_event(self, record):
        """Consume one record from a replica's event stream (tailed
        JSONL in the CLI, in-process ring in the sim). Dispatches on
        the unified-schema kind; the emitting replica is identified by
        the record's ``host``."""
        kind = record.get("kind") or record.get("event")
        host = record.get("host") or ""
        replica_id = self._by_host.get(host)
        if replica_id is None:
            # Loud (once per host): a silently dropped stream means a
            # sick replica stays in rotation. Usual cause: the backend
            # runs without --replica-id, or no probe has aliased its
            # identity yet.
            if host not in self._unknown_hosts:
                if len(self._unknown_hosts) >= 256:
                    # Bounded memory under identity churn; evicted
                    # hosts merely warn once more if seen again.
                    self._unknown_hosts.clear()
                self._unknown_hosts.add(host)
                log.warning(
                    "event from unknown replica host %r dropped (set "
                    "--replica-id on the backend / check the probe "
                    "aliasing); rotation cannot steer on its stream",
                    host,
                )
            return None
        if kind == "request_shed":
            # Only OVERLOAD sheds count toward ejection: a queue_full
            # storm means the replica's admission bound is saturated;
            # a deadline shed reflects the client's budget, not the
            # replica's health.
            if record.get("reason") == "queue_full":
                self._note_shed(replica_id)
            return "shed"
        if kind == "health_transition":
            to = record.get("to")
            if to == "Unhealthy":
                self.eject(replica_id, reason="unhealthy")
                return "ejected"
            if to == "Healthy":
                self.readmit(replica_id)
                return "readmitted"
            return None
        if kind == "request_retired":
            latency = record.get("latency_s")
            with self._lock:
                replica = self._replicas.get(replica_id)
                if replica is not None and latency is not None:
                    replica.last_latency_s = float(latency)
            return "retired"
        return None


# -- CLI ----------------------------------------------------------------------


def http_transport(base_url, timeout_s=120.0):
    """A :class:`ReplicaHandle` transport POSTing to a serve_cli
    backend; maps 429 to :class:`BackendShed` and everything else
    non-200 (or unreachable) to :class:`TransportError`."""
    import urllib.error
    import urllib.request

    def transport(payload):
        req = urllib.request.Request(
            base_url.rstrip("/") + "/generate",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code == 429:
                try:
                    body = json.loads(e.read())
                except ValueError:
                    body = {}
                raise BackendShed(
                    body.get("error", "backend shed"),
                    reason=body.get("shed", "shed"),
                ) from e
            raise TransportError(
                f"{base_url}: HTTP {e.code}"
            ) from e
        except (OSError, ValueError) as e:
            raise TransportError(f"{base_url}: {e}") from e

    return transport


def http_probe(base_url, timeout_s=2.0):
    """A cheap GET /healthz probe for :meth:`ReplicaRouter
    .observe_probe`; returns the parsed snapshot, raises when the
    replica is unreachable or not ready."""
    import urllib.request

    def probe():
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=timeout_s
        ) as resp:
            info = json.loads(resp.read())
        if info.get("status") != "ok":
            raise TransportError(
                f"{base_url}: not ready ({info.get('status')})"
            )
        return info

    return probe


def _http_kv_call(base_url, path, body, timeout_s):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base_url.rstrip("/") + path,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            out = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read() or b"{}").get("error", "")
        except (ValueError, OSError):
            detail = ""
        raise kv_handoff.HandoffError(
            f"{base_url}{path}: HTTP {e.code} {detail}".rstrip()
        ) from e
    except (OSError, ValueError) as e:
        raise kv_handoff.HandoffError(f"{base_url}{path}: {e}") from e
    if "error" in out:
        raise kv_handoff.HandoffError(f"{base_url}{path}: {out['error']}")
    return out


def http_kv_export(base_url, timeout_s=10.0):
    """POST /kv/export against a serve_cli backend: returns the framed
    handoff stream for a prompt's cached prefix (for
    :attr:`ReplicaHandle.kv_export`)."""

    def export(tokens, traceparent=None):
        body = {"tokens": [int(t) for t in tokens]}
        if traceparent is not None:
            body["traceparent"] = traceparent
        out = _http_kv_call(base_url, "/kv/export", body, timeout_s)
        frames = out.get("frames")
        if not frames:
            raise kv_handoff.HandoffUnsupported(
                f"{base_url}: no cached prefix to export"
            )
        return frames

    return export


def http_kv_install(base_url, timeout_s=10.0):
    """POST /kv/install against a serve_cli backend: verifies and
    installs a framed handoff stream into the replica's paged KV pool
    (for :attr:`ReplicaHandle.kv_install`)."""

    def install(frames):
        return _http_kv_call(
            base_url, "/kv/install", {"frames": frames}, timeout_s,
        )

    return install


def _probe_loop(router, interval_s, stop):
    while not stop.wait(interval_s):
        for replica in router.replicas():
            if replica.probe is None:
                continue
            try:
                info = replica.probe()
            except Exception as e:  # noqa: BLE001 - probe failure = signal
                log.debug("probe of %s failed: %s",
                          replica.replica_id, e)
                router.observe_probe(replica.replica_id, ok=False)
            else:
                router.observe_probe(
                    replica.replica_id, ok=True, info=info
                )


def _tail_loop(router, path, stop):
    for record in obs_events.follow_jsonl(
        path, poll_s=0.5, stop=stop.is_set
    ):
        router.ingest_event(record)


def make_handler(router):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                ready = len(router.replicas(state=READY))
                self._send(
                    {"status": "ok" if ready else "no-capacity",
                     "ready_replicas": ready},
                    200 if ready else 503,
                )
            elif self.path == "/replicas":
                self._send({"replicas": router.snapshot()})
            elif self.path == "/metrics":
                body = router.registry.render()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/generate":
                self._send({"error": "not found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                key = self.headers.get("Idempotency-Key")
                tenant = self.headers.get("X-Tenant-Class")
                # W3C trace context: the standard header joins the
                # payload so an upstream caller's trace continues
                # through the fleet (an explicit payload field wins).
                tp = self.headers.get("traceparent")
                if tp and "traceparent" not in payload:
                    payload["traceparent"] = tp
                out = router.submit(payload, key=key, tenant=tenant)
                self._send(out)
            except BackendShed as e:
                body = {"error": str(e), "shed": e.reason}
                if getattr(e, "tenant", ""):
                    body["tenant"] = e.tenant
                self._send(body, 429)
            except NoReadyReplicas as e:
                self._send({"error": str(e)}, 503)
            except Exception as e:  # noqa: BLE001 - surface as JSON
                log.exception("routed generate failed")
                self._send({"error": str(e)}, 502)

    return Handler


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8100,
                   help="front-end HTTP port (POST /generate routed "
                        "across the replicas)")
    p.add_argument("--replicas", required=True,
                   help="comma-separated backend base URLs "
                        "(http://host:port of serve_cli daemons)")
    p.add_argument("--replica-events", default="",
                   help="comma-separated JSONL event logs to tail "
                        "(each replica's --event-log), in --replicas "
                        "order; shed rates and health transitions "
                        "consumed from them steer rotation")
    p.add_argument("--probe-interval-s", type=float, default=1.0,
                   help="seconds between /healthz probes of every "
                        "replica")
    p.add_argument("--affinity-tokens", type=int, default=16,
                   help="prompt tokens hashed into the prefix-"
                        "affinity key (0 disables affinity routing)")
    p.add_argument("--affinity-slack", type=int, default=4,
                   help="extra load the prefix owner may carry over "
                        "the least-loaded replica before the request "
                        "spills off the ring")
    p.add_argument("--eject-after", type=int, default=3,
                   help="consecutive probe failures before a replica "
                        "is ejected from rotation")
    p.add_argument("--readmit-after", type=int, default=2,
                   help="consecutive probe successes before an "
                        "ejected replica is re-admitted")
    p.add_argument("--shed-rate-threshold", type=float, default=0.0,
                   help="eject a replica shedding faster than this "
                        "rate per second over --shed-window-s "
                        "(0 = disabled)")
    p.add_argument("--shed-window-s", type=float, default=10.0,
                   help="trailing window for the shed-rate signal")
    p.add_argument("--hedge-after-ms", type=float, default=0.0,
                   help="arm request hedging: a primary dispatch "
                        "exceeding max(this floor, the rolling p95 "
                        "latency) gets ONE hedge dispatch to a "
                        "non-affinity peer under the same (burned) "
                        "idempotency key; first success wins, the "
                        "loser is discarded, and the re-issue "
                        "machinery can never add a third dispatch "
                        "(0 = hedging off)")
    p.add_argument("--hedge-budget-pct", type=float, default=5.0,
                   help="cap hedges at this percentage of routed "
                        "requests (tpu_router_hedges_total{outcome="
                        "budget_denied} counts the deniers) — a "
                        "straggling fleet must not double its own "
                        "load")
    p.add_argument("--handoff", action="store_true",
                   help="arm cross-replica KV block handoff: a fleet-"
                        "global prefix directory records which replica "
                        "holds each prompt's cached blocks, and ring "
                        "remaps / hedges / re-issues ship the blocks "
                        "over (POST /kv/export -> /kv/install) instead "
                        "of re-prefilling; failed transfers fall back "
                        "to local prefill and are charged to badput")
    p.add_argument("--handoff-timeout-s", type=float, default=2.0,
                   help="per-transfer deadline for a KV handoff; past "
                        "it the transfer is abandoned and the decode "
                        "replica re-prefills locally")
    p.add_argument("--tenant-classes", default="",
                   help="per-tenant admission at the fleet door (same "
                        "JSON config as serve_cli --tenant-classes): "
                        "token-rate quotas and per-class shares of "
                        "fleet capacity enforced BEFORE dispatch; the "
                        "resolved class rides the payload to the "
                        "backend (empty = off)")
    p.add_argument("--event-log", default="",
                   help="append the router's own structured events "
                        "(replica_ejected / request_reissued / ...) "
                        "to this JSONL file")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve tpu_router_* on this dedicated port "
                        "(convention: "
                        f"{obs_ports.FLEET_ROUTER_PORT}, see "
                        "obs/ports.py; 0 = front-end /metrics only)")
    p.add_argument("--alert-rules", default="",
                   help="arm the burn-rate alert evaluator "
                        "(obs/alerts.py) over the router registry "
                        "with this JSON rule file — the autoscaler's "
                        "scale-out signal")
    p.add_argument("--alerts-out", default="",
                   help="append alert_fired/alert_resolved events to "
                        "this JSONL file (with --alert-rules)")
    p.add_argument("--trace-sample", type=float, default=0.0,
                   help="head-sample this fraction of ingress requests "
                        "into distributed traces (deterministic hash "
                        "of the request key; errors, hedges, handoffs "
                        "and sheds force-upgrade regardless). Inbound "
                        "traceparent headers are always honored. "
                        "0 = propagate-only, 1 = trace everything")
    p.add_argument("--trace-out", default="",
                   help="write the router's own spans (route / "
                        "dispatch / kv_handoff per request track) to "
                        "PATH.json (Chrome/Perfetto) and PATH.jsonl "
                        "(obs.journey input) on exit")
    p.add_argument("--flight-recorder", action="store_true",
                   help="arm the always-on flight recorder (obs/"
                        "flight.py) over the router registry + event "
                        "stream: a fired alert, crash or SIGUSR2 dumps "
                        "the last seconds of rotation/shed/hedge "
                        "movement as a postmortem bundle (obs."
                        "postmortem); recorder health on "
                        f":{obs_ports.FLIGHT_PORT}/metrics; zero cost "
                        "when off")
    p.add_argument("--flight-window-s", type=float,
                   default=obs_flight.DEFAULT_WINDOW_S,
                   help="flight-recorder ring depth in seconds")
    p.add_argument("--flight-dir", default="/tmp/tpu-flight",
                   help="directory postmortem bundles are dumped into")
    args = p.parse_args(argv)

    registry = obs_metrics.Registry()
    events = obs_events.EventStream(
        EVENT_SOURCE, sink_path=args.event_log, registry=registry,
    )
    from container_engine_accelerators_tpu_torch.fleet import (
        tenants as fleet_tenants,
    )

    router = ReplicaRouter(
        events=events, registry=registry,
        affinity_tokens=args.affinity_tokens,
        affinity_slack=args.affinity_slack,
        eject_after=args.eject_after,
        readmit_after=args.readmit_after,
        shed_rate_threshold=args.shed_rate_threshold,
        shed_window_s=args.shed_window_s,
        hedge_after_ms=args.hedge_after_ms,
        hedge_budget_pct=args.hedge_budget_pct,
        handoff=args.handoff,
        handoff_timeout_s=args.handoff_timeout_s,
        tenants=fleet_tenants.TenantClasses.from_flag(
            args.tenant_classes
        ),
        trace_sample=args.trace_sample,
    )
    tracer = obs_trace.configure() if args.trace_out else None
    urls = [u.strip() for u in args.replicas.split(",") if u.strip()]
    for i, url in enumerate(urls):
        kv_kwargs = {}
        if args.handoff:
            kv_kwargs = dict(
                kv_export=http_kv_export(
                    url, timeout_s=args.handoff_timeout_s),
                kv_install=http_kv_install(
                    url, timeout_s=args.handoff_timeout_s),
            )
        router.register(ReplicaHandle(
            f"replica-{i}", http_transport(url),
            probe=http_probe(url), host=url, **kv_kwargs,
        ))
    stop = threading.Event()
    threading.Thread(
        target=_probe_loop, args=(router, args.probe_interval_s, stop),
        daemon=True,
    ).start()
    if args.replica_events:
        paths = [
            s.strip() for s in args.replica_events.split(",")
            if s.strip()
        ]
        for path in paths:
            threading.Thread(
                target=_tail_loop, args=(router, path, stop),
                daemon=True,
            ).start()
    obs_alerts.wire_from_flags(
        [registry], args.alert_rules, alerts_out=args.alerts_out,
    )
    obs_flight.wire_from_flags(
        args.flight_recorder, args.flight_dir,
        registries=[("router", registry)], streams=[events],
        tracer=tracer, window_s=args.flight_window_s,
    )
    if args.metrics_port:
        obs_metrics.serve(
            args.metrics_port, registry=registry,
            owner="fleet router metrics (fleet.router --metrics-port)",
        )
        log.info("router metrics on :%d/metrics", args.metrics_port)
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port), make_handler(router)
    )
    log.info("fleet router listening on :%d (%d replicas)",
             server.server_address[1], len(urls))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        if tracer is not None:
            tracer.write_chrome(args.trace_out + ".json")
            tracer.write_jsonl(args.trace_out + ".jsonl")
            log.info("router trace written to %s.json/.jsonl",
                     args.trace_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
