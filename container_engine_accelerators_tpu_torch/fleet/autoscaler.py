# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""SLO-driven autoscaler: size the fleet on burn-rate alerts and idle.

The scale-out signal is the multi-window burn-rate evaluator
(``obs/alerts.py``): a fired burn alert means the error budget is being
spent faster than the fleet can absorb — add capacity. The scale-in
signal is sustained low occupancy: the router's fleet-load fraction
below ``idle_occupancy`` for ``idle_for_s`` straight, with no burn
alert active (hysteresis — a burning fleet never shrinks). Both
directions respect min/max replica bounds and per-direction cooldowns,
so a flapping alert cannot saw the fleet.

**Scale-in is lossless.** Before a replica is removed the autoscaler
drives the same cordon → drain → deregister path the fault reactor
uses for sick nodes — but as a *planned* removal of a *healthy*
replica: the cordon is stamped ``cordoned-by: tpu-autoscaler`` (so a
restarted reactor never lifts it, and an operator can tell a scale-in
cordon from an outage cordon), new routing stops
(``ReplicaRouter.mark_draining``), the engine's in-flight requests
migrate off via ``ContinuousEngine.drain(reason="autoscaler
scale-in")`` — a drain reason, never a health transition — and only a
fully idle replica is deregistered and terminated.

**Scale-out goes through the gang scheduler.** A new replica is not a
bare pod: :class:`GangPlacer` asks the real placement pass
(``scheduler.gang.place_gang_on_slice``) for an intact contiguous
sub-mesh before the lifecycle launches anything, so fleet growth
composes with topology-aware placement instead of racing it.

The replica *lifecycle* (launch/drain/terminate) is pluggable: the
hermetic sim provides fake-engine replicas, a k8s deployment would
create gated gang pods. Without a lifecycle the autoscaler runs in
**advisory mode** — it still consumes alerts and traffic events, runs
the full state machine, and emits ``scale_out`` / ``scale_in``
decision events, but moves nothing (the CLI's default posture)::

    python -m container_engine_accelerators_tpu_torch.fleet.autoscaler \
        --event-log router-events.jsonl --replicas 3

Copy of ``container_engine_accelerators_tpu/fleet/autoscaler.py``, its
imports pointed at the port's copies (``obs``, ``faults/reactor``,
``fleet``, ``scheduler``).
"""

import argparse
import logging
import sys
import threading
import time

from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

EVENT_SOURCE = "fleet.autoscaler"

# Value stamped in scheduler.k8s.CORDONED_BY_ANNOTATION on scale-in
# cordons: distinguishes a planned autoscaler removal from the fault
# reactor's outage cordons ("tpu-fault-reactor") and from an operator's
# manual cordon (no annotation at all) — each controller lifts only its
# own.
AUTOSCALER_ID = "tpu-autoscaler"


class GangPlacer:
    """Scale-out placement through the real gang scheduler.

    ``nodes_fn()`` returns the current ``NodeInfo`` inventory
    (schedulable, with free capacity) and ``gang_fn()`` the PodInfo
    gang one replica needs; :meth:`place` returns the scheduler's
    bindings for an intact contiguous sub-mesh, or None when no such
    sub-mesh exists — in which case the autoscaler blocks the
    scale-out (``scale_blocked``) instead of launching a replica that
    would land on fragmented capacity.

    ``inventory`` (scheduler/incremental.SubmeshInventory, already
    observed by ``nodes_fn``) serves the placement from the cached
    per-slice sub-mesh views instead of rescanning every node — an
    autoscaler launch on a quiet 1k-node fleet stops costing a full
    backtracking search (``fleet/lifecycle.cluster_placer`` wires
    this up)."""

    def __init__(self, nodes_fn, gang_fn, inventory=None):
        self.nodes_fn = nodes_fn
        self.gang_fn = gang_fn
        self.inventory = inventory

    def place(self):
        from container_engine_accelerators_tpu_torch.scheduler import gang

        return gang.place_gang_on_slice(
            self.gang_fn(), self.nodes_fn(), inventory=self.inventory
        )


class Autoscaler:
    """The fleet-sizing control loop.

    Event intake (:meth:`handle_event` / :meth:`poll`) consumes the
    unified stream — ``alert_fired`` / ``alert_resolved`` from the
    burn-rate evaluator, ``replica_ejected`` from the router (lost
    capacity is scale-out pressure), ``request_retired`` as the
    traffic heartbeat advisory mode uses for its idle signal — and
    :meth:`tick` applies the state machine. Drive tick from a timer
    (:meth:`start`) or directly with a fake clock in tests."""

    def __init__(self, router=None, lifecycle=None, events=None,
                 registry=None, min_replicas=1, max_replicas=8,
                 scale_out_cooldown_s=30.0, scale_in_cooldown_s=60.0,
                 idle_for_s=60.0, idle_occupancy=0.05, placer=None,
                 kube=None, clock=time.monotonic, replicas=0):
        self.router = router
        self.lifecycle = lifecycle
        self.placer = placer
        # KubeClient (or conformant fake) for the scale-in cordon;
        # None in hermetic/advisory runs where replicas map to no node.
        self.kube = kube
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_out_cooldown_s = scale_out_cooldown_s
        self.scale_in_cooldown_s = scale_in_cooldown_s
        self.idle_for_s = idle_for_s
        self.idle_occupancy = idle_occupancy
        self._clock = clock
        self._lock = threading.Lock()
        self._burning = set()      # active burn-alert rule names
        self._eject_pressure = 0   # replica_ejected since last scale-out
        self._idle_since = None
        self._last_out = None      # clock stamps for the cooldowns
        self._last_in = None
        self._last_traffic = None  # advisory-mode idle heartbeat
        self._seen = 0             # poll() ring cursor
        self._launches = 0
        # Advisory mode (no router): virtual replica count.
        self._virtual_replicas = replicas
        reg = registry if registry is not None else obs_metrics.Registry()
        self.registry = reg
        self.events = events
        self._m_replicas = obs_metrics.Gauge(
            "tpu_autoscaler_replicas",
            "Replicas the autoscaler currently targets",
            registry=reg)
        self._m_replicas.set_function(self.replica_count)
        self._m_scales = obs_metrics.Counter(
            "tpu_autoscaler_scale_events_total",
            "Fleet resize actions taken, by direction", ["direction"],
            registry=reg)
        self._m_blocked = obs_metrics.Counter(
            "tpu_autoscaler_blocked_total",
            "Resize decisions blocked, by reason (bounds, cooldown, "
            "no_placement, no_candidate, no_lifecycle, launch_failed)",
            ["reason"], registry=reg)
        self._m_burn = obs_metrics.Gauge(
            "tpu_autoscaler_burn_alerts_active",
            "Burn-rate alert rules currently firing (scale-out "
            "pressure)", registry=reg)
        self._m_burn.set_function(lambda: len(self._burning))

    # -- signals --------------------------------------------------------------

    def replica_count(self):
        if self.router is not None:
            return len(self.router.replicas())
        if self.lifecycle is not None and hasattr(
            self.lifecycle, "handles"
        ):
            # Router-less actuation (the CLI's kube mode): the
            # lifecycle's handle map is the fleet.
            return len(self.lifecycle.handles)
        return self._virtual_replicas

    def adopt_existing(self):
        """Crash-safe restart: reconcile desired-vs-actual from the
        cluster's ``tpu-topology.gke.io/fleet-replica`` pod labels
        BEFORE the first tick. Adopted replicas re-enter the router's
        rotation; orphaned pods were already deleted by the lifecycle.
        Returns the reconcile summary (None without a reconciling
        lifecycle) — a restarted autoscaler neither double-launches a
        surviving replica nor leaks a dead one's pods."""
        if self.lifecycle is None or not hasattr(
            self.lifecycle, "reconcile"
        ):
            return None
        summary = self.lifecycle.reconcile()
        if self.router is not None:
            known = {r.replica_id for r in self.router.replicas()}
            for rid in summary["adopted"]:
                if rid not in known:
                    self.router.register(self.lifecycle.handles[rid])
            # Desired == actual cuts BOTH ways: a router entry whose
            # pods vanished (an orphan the reconcile swept, or an
            # out-of-band deletion) must leave rotation, or the fleet
            # would keep dispatching into a void forever.
            live = set(self.lifecycle.handles)
            summary["deregistered"] = []
            for r in list(self.router.replicas()):
                if r.replica_id not in live:
                    self.router.deregister(r.replica_id)
                    summary["deregistered"].append(r.replica_id)
        return summary

    def _occupancy(self, now):
        """Fleet-load fraction for the idle signal: the router's view
        when present; in advisory mode, traffic recency (any retire
        within idle_for_s counts as busy — 1.0 — else 0.0)."""
        if self.router is not None:
            return self.router.occupancy()
        if self._last_traffic is None:
            return 0.0
        return 1.0 if now - self._last_traffic < self.idle_for_s else 0.0

    def handle_event(self, record):
        """Route one unified-stream record into the state machine."""
        kind = record.get("kind") or record.get("event")
        if kind == "alert_fired":
            rule = record.get("rule")
            with self._lock:
                self._burning.add(rule)
            log.warning("burn alert %s fired: scale-out pressure", rule)
            return "burn"
        if kind == "alert_resolved":
            rule = record.get("rule")
            with self._lock:
                self._burning.discard(rule)
            return "resolved"
        if kind == "replica_ejected":
            replica = record.get("replica")
            reason = record.get("reason")
            with self._lock:
                self._eject_pressure += 1
            log.warning(
                "replica %s ejected (%s): capacity lost, scale-out "
                "pressure", replica, reason,
            )
            return "pressure"
        if kind == "replica_readmitted":
            # The capacity came back: a flap's pressure must not
            # launch a replica nobody needs (or, at the max bound,
            # suppress idle scale-in forever).
            with self._lock:
                self._eject_pressure = max(0, self._eject_pressure - 1)
            return "recovered"
        if kind == "request_retired":
            with self._lock:
                self._last_traffic = self._clock()
            return "traffic"
        return None

    def poll(self, stream):
        """Consume the unread tail of an in-process EventStream ring
        (the reactor's cursor pattern), then run one tick."""
        from container_engine_accelerators_tpu_torch.faults.reactor import (
            _unread_tail,
        )

        new, self._seen = _unread_tail(stream, self._seen)
        for rec in new:
            self.handle_event(rec)
        return self.tick()

    # -- the state machine ----------------------------------------------------

    def tick(self, now=None):
        """One control-loop pass; returns the action taken (or None)."""
        now = self._clock() if now is None else now
        with self._lock:
            burning = bool(self._burning)
            pressure = self._eject_pressure
        n = self.replica_count()
        if burning or pressure:
            # Any scale-out demand clears the idle run: hysteresis.
            self._idle_since = None
            if n >= self.max_replicas:
                self._m_blocked.labels("bounds").inc()
                # Un-actionable ejection pressure is dropped here: a
                # stale ejection must not pin the fleet at max (and
                # block idle scale-in) forever. Burn alerts persist —
                # they resolve themselves via alert_resolved.
                with self._lock:
                    self._eject_pressure = 0
                return None
            if (
                self._last_out is not None
                and now - self._last_out < self.scale_out_cooldown_s
            ):
                self._m_blocked.labels("cooldown").inc()
                return None
            reason = "burn_rate" if burning else "replica_ejected"
            return self._scale_out(now, reason)
        occ = self._occupancy(now)
        if occ > self.idle_occupancy:
            self._idle_since = None
            return None
        if self._idle_since is None:
            # Advisory mode knows exactly when the traffic stopped:
            # backdate the idle run to the last retire so idle_for_s
            # measures quiet time, not quiet time after the busy
            # window already lapsed (which would double the wait).
            if self.router is None and self._last_traffic is not None:
                self._idle_since = self._last_traffic
            else:
                self._idle_since = now
        if now - self._idle_since < self.idle_for_s:
            return None
        if n <= self.min_replicas:
            return None  # idling at the floor is the steady state
        if (
            self._last_in is not None
            and now - self._last_in < self.scale_in_cooldown_s
        ):
            self._m_blocked.labels("cooldown").inc()
            return None
        return self._scale_in(now)

    def _scale_out(self, now, reason):
        placement = None
        if self.placer is not None:
            placement = self.placer.place()
            if placement is None:
                self._m_blocked.labels("no_placement").inc()
                if self.events is not None:
                    self.events.emit(
                        "scale_blocked", severity="warning",
                        reason="no_placement",
                    )
                log.warning(
                    "scale-out blocked: no intact sub-mesh for a new "
                    "replica"
                )
                return None
        replica = None
        if self.lifecycle is not None:
            self._launches += 1
            replica = self.lifecycle.launch(
                f"scaled-{self._launches}", placement
            )
            if replica is None:
                # A failed launch is a blocked scale-out, not a
                # scale-out: keep the eject pressure and leave the
                # cooldown disarmed so the next tick retries.
                self._m_blocked.labels("launch_failed").inc()
                if self.events is not None:
                    self.events.emit(
                        "scale_blocked", severity="warning",
                        reason="launch_failed",
                    )
                log.warning("scale-out blocked: replica launch failed")
                return None
            if self.router is not None:
                self.router.register(replica)
        else:
            self._virtual_replicas += 1
        with self._lock:
            self._eject_pressure = 0
        self._last_out = now
        n = self.replica_count()
        self._m_scales.labels("out").inc()
        if self.events is not None:
            self.events.emit(
                "scale_out", replicas=n, reason=reason,
                replica=(replica.replica_id if replica is not None
                         else ""),
            )
        log.info("scaled out to %d replicas (%s)", n, reason)
        return "scale_out"

    def _scale_in(self, now):
        if self.router is not None and self.lifecycle is None:
            # Without a lifecycle nothing can drain/terminate the
            # victim: marking it DRAINING would strand it out of
            # rotation forever while the metrics claim a scale-in
            # happened. Block loudly instead.
            self._m_blocked.labels("no_lifecycle").inc()
            return None
        victim = self._pick_victim()
        if victim is None and (
            self.router is not None or self.lifecycle is not None
        ):
            self._m_blocked.labels("no_candidate").inc()
            return None
        victim_id = victim.replica_id if victim is not None else ""
        node = getattr(victim, "node", "") if victim is not None else ""
        # Lossless removal: cordon (stamped as OURS — never the
        # reactor's), stop new routing, migrate in-flight work off the
        # engine with a drain reason (a planned scale-in is NOT a
        # health transition), then deregister + terminate.
        if self.kube is not None and node:
            self.kube.cordon_node(node, cordoned_by=AUTOSCALER_ID)
        if self.router is not None and victim is not None:
            self.router.mark_draining(victim_id)
        if self.lifecycle is not None and victim is not None:
            self.lifecycle.drain(victim, reason="autoscaler scale-in")
            if self.router is not None:
                self.router.deregister(victim_id)
            self.lifecycle.terminate(victim)
            if self.kube is not None and node:
                # The cordon only brackets the drain window (no new
                # placements while work migrates off): once the
                # replica is gone its sub-mesh is free inventory
                # again. Leaving the cordon would exhaust the
                # schedulable pool after enough in/out cycles.
                self.kube.uncordon_node(node)
        elif self.router is None and self.lifecycle is None:
            self._virtual_replicas = max(
                self.min_replicas, self._virtual_replicas - 1
            )
        self._last_in = now
        self._idle_since = None
        n = self.replica_count()
        self._m_scales.labels("in").inc()
        if self.events is not None:
            self.events.emit(
                "scale_in", replicas=n, replica=victim_id,
                reason="sustained_idle",
            )
        log.info("scaled in to %d replicas (drained %s)", n,
                 victim_id or "<virtual>")
        return "scale_in"

    def _pick_victim(self):
        """Least-loaded READY replica (drain cost is proportional to
        in-flight work); falls back to the lifecycle's handle map in
        router-less actuation; None in advisory mode."""
        if self.router is None:
            handles = list(
                getattr(self.lifecycle, "handles", {}).values()
            ) if self.lifecycle is not None else []
            if not handles:
                return None
            handles.sort(key=lambda h: (h.load(), h.replica_id))
            return handles[0]
        from container_engine_accelerators_tpu_torch.fleet import router as r

        ready = self.router.replicas(state=r.READY)
        if not ready:
            return None
        ready.sort(key=lambda h: (h.load(), h.replica_id))
        return ready[0]

    # -- background driving ---------------------------------------------------

    def start(self, interval_s=5.0, stream=None):
        """Tick (and drain ``stream``'s ring, when given) from a
        daemon thread every ``interval_s``; returns a stop Event."""
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    if stream is not None:
                        self.poll(stream)
                    else:
                        self.tick()
                except Exception:  # noqa: BLE001 - sizing must not crash
                    log.exception("autoscaler tick failed")

        threading.Thread(
            target=loop, name="fleet-autoscaler", daemon=True
        ).start()
        return stop


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--event-log", required=True,
                   help="JSONL event log to tail for alert_fired / "
                        "alert_resolved / replica_ejected / "
                        "request_retired signals (the router's "
                        "--event-log, or an --alerts-out file)")
    p.add_argument("--replicas", type=int, default=1,
                   help="current replica count the advisory state "
                        "machine starts from")
    p.add_argument("--min-replicas", type=int, default=1,
                   help="never scale in below this many replicas")
    p.add_argument("--max-replicas", type=int, default=8,
                   help="never scale out above this many replicas")
    p.add_argument("--scale-out-cooldown-s", type=float, default=30.0,
                   help="minimum seconds between scale-out actions")
    p.add_argument("--scale-in-cooldown-s", type=float, default=60.0,
                   help="minimum seconds between scale-in actions")
    p.add_argument("--idle-for-s", type=float, default=60.0,
                   help="occupancy must stay below --idle-occupancy "
                        "this long before a scale-in")
    p.add_argument("--idle-occupancy", type=float, default=0.05,
                   help="fleet-load fraction below which the fleet "
                        "counts as idle")
    p.add_argument("--tick-interval-s", type=float, default=5.0,
                   help="control-loop period")
    p.add_argument("--decisions-out", default="",
                   help="append scale_out/scale_in decision events to "
                        "this JSONL file (advisory mode's output)")
    p.add_argument("--advisory", action="store_true",
                   help="run the full state machine but move NOTHING "
                        "(decision events only). Without it the "
                        "autoscaler actuates: replica pods are "
                        "launched/terminated through the kube API "
                        "(KUBE_API_URL / in-cluster service account), "
                        "gang-placed on the live node inventory, and "
                        "reconciled from tpu-topology.gke.io/"
                        "fleet-replica pod labels at startup")
    p.add_argument("--namespace", default="default",
                   help="namespace replica pods live in (actuation "
                        "mode)")
    p.add_argument("--replica-image", default="tpu-workload:latest",
                   help="serving image for launched replica pods")
    p.add_argument("--gang-size", type=int, default=1,
                   help="pods per replica (multi-host replicas are a "
                        "gang; placement asks the gang scheduler for "
                        "a contiguous sub-mesh)")
    p.add_argument("--tpu-per-pod", type=int, default=4,
                   help="google.com/tpu resources each replica pod "
                        "requests (the device plugin's extended "
                        "resource)")
    p.add_argument("--replica-url-template", default="",
                   help="per-replica /healthz base URL template, e.g. "
                        "http://{replica}:8000 — arms real probes so "
                        "reconciliation can tell a live replica from "
                        "an orphaned pod set (empty: adopt by pod "
                        "record alone)")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="how long scale-in waits for a draining "
                        "replica to go idle before terminating it")
    args = p.parse_args(argv)

    registry = obs_metrics.Registry()
    events = obs_events.EventStream(
        EVENT_SOURCE, sink_path=args.decisions_out, registry=registry,
    )
    lifecycle = kube = None
    if not args.advisory:
        from container_engine_accelerators_tpu_torch.fleet import (
            lifecycle as fleet_lifecycle,
        )
        from container_engine_accelerators_tpu_torch.scheduler.k8s import (
            KubeClient,
        )

        kube = KubeClient()
        lifecycle = fleet_lifecycle.ReplicaLifecycle(
            kube,
            fleet_lifecycle.PodBackend(args.replica_url_template),
            namespace=args.namespace,
            placer=fleet_lifecycle.cluster_placer(
                kube, gang_size=args.gang_size,
                tpu_per_pod=args.tpu_per_pod,
                namespace=args.namespace,
            ),
            events=events, image=args.replica_image,
            gang_size=args.gang_size, tpu_per_pod=args.tpu_per_pod,
            drain_timeout_s=args.drain_timeout_s,
        )
    scaler = Autoscaler(
        lifecycle=lifecycle, kube=kube,
        placer=(lifecycle.placer if lifecycle is not None else None),
        events=events, registry=registry,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        scale_out_cooldown_s=args.scale_out_cooldown_s,
        scale_in_cooldown_s=args.scale_in_cooldown_s,
        idle_for_s=args.idle_for_s,
        idle_occupancy=args.idle_occupancy,
        replicas=args.replicas,
    )
    if lifecycle is not None:
        # Crash-safe restart: converge desired-vs-actual from the pod
        # labels BEFORE the first tick — surviving replicas are
        # adopted, orphaned pods deleted, and the launch counter can
        # never collide with a live replica's name.
        try:
            summary = scaler.adopt_existing()
        except Exception as e:  # noqa: BLE001 - named startup failure
            log.error(
                "cannot reach the kube API for startup "
                "reconciliation (%s); set KUBE_API_URL / run "
                "in-cluster, or pass --advisory to run without "
                "actuation", e,
            )
            return 2
        log.info("reconciled from pod labels: %s", summary)
    log.info(
        "fleet autoscaler (%s) tailing %s: %d replicas in [%d, %d]",
        "advisory" if args.advisory else "actuating",
        args.event_log, scaler.replica_count(), args.min_replicas,
        args.max_replicas,
    )
    # Tick from a timer thread, NOT from the tail loop: the idle
    # scale-in signal fires precisely when the log goes quiet and the
    # tail yields nothing.
    stop = scaler.start(interval_s=args.tick_interval_s)
    try:
        for record in obs_events.follow_jsonl(
            args.event_log, poll_s=min(1.0, args.tick_interval_s),
        ):
            scaler.handle_event(record)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
    return 0


if __name__ == "__main__":
    sys.exit(main())
