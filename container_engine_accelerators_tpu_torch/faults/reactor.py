# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The fleet reactor and the node-local serving reaction.

Copy of ``FleetReactor`` and ``ServingDrainer`` from
``container_engine_accelerators_tpu/faults/reactor.py`` (with the
``_unread_tail`` helper they poll through, and the ``HEALTHY`` /
``UNHEALTHY`` states of ``kubeletapi``), on the port's copies of the
gang scheduler, the Kubernetes client and the obs modules:

  * :class:`FleetReactor` cordons a node on a ``health_transition`` to
    Unhealthy, or on a ``link_wedged`` / ``link_desync`` record of the
    lockstep engine link naming it (an observer's self-report,
    ``culprit=False``, drains without cordoning), and drains every
    bound gang with a member there, losslessly, so the scheduler
    re-places it; it un-cordons on recovery (``fleet/linksim.py``'s
    reactor phase drives it against ``testing/kubeapi.py``);
  * :class:`ServingDrainer` drains the local ``ContinuousEngine`` on a
    ``health_transition`` to Unhealthy: in-flight requests migrate off
    their slots and re-prefill on fresh ones instead of riding a wedged
    chip to a timeout (``tpu_serving_requests_migrated_total``).

The reactor CLI (tailing a JSONL event log) is jax-free control plane
and is not copied: the JAX package's runs beside port replicas.
"""

import json
import logging

from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import flight as obs_flight
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.scheduler import gang
from container_engine_accelerators_tpu_torch.scheduler.k8s import (
    CORDONED_BY_ANNOTATION,
    KubeError,
)

log = logging.getLogger(__name__)

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


EVENT_SOURCE = "faults.reactor"

# Value stamped in CORDONED_BY_ANNOTATION: lets a restarted reactor
# recognize its own cordons (and never lift an operator's manual one).
REACTOR_ID = "tpu-fault-reactor"


def _default_node_of(record):
    """Map a health event to the node it concerns: the emitting host
    (the device plugin runs per-node, so its host identity IS the node
    name in clusters where HOSTNAME is the node name)."""
    return record.get("node") or record.get("host") or ""


class FleetReactor:
    """Consume health transitions; cordon + drain on Unhealthy,
    un-cordon on recovery. One instance per control loop; idempotent
    per node (a flapping chip cannot re-drain an already-drained
    node)."""

    def __init__(self, client, node_of=None, events=None, registry=None,
                 dry_run=False, drain_gangs=True,
                 trust_priority_annotation=True, on_alert=None):
        self.client = client
        self.node_of = node_of if node_of is not None else _default_node_of
        self.dry_run = dry_run
        self.drain_gangs = drain_gangs
        # Alert subscription (obs/alerts.py): alert_fired /
        # alert_resolved records on the tailed stream route here, so a
        # reaction policy ("drain the engine on a fast SLO burn") plugs
        # into the same loop that handles health transitions. None =
        # alerts pass through unhandled (logged only).
        self.on_alert = on_alert
        self.trust_priority_annotation = trust_priority_annotation
        self.events = events if events is not None else obs_events.EventStream(
            EVENT_SOURCE, registry=registry
        )
        reg = self.events.registry
        if reg is None:
            reg = obs_metrics.Registry()
        self.registry = reg
        self.cordons = obs_metrics.get_or_create(
            obs_metrics.Counter, "tpu_reactor_cordons_total",
            "Nodes cordoned after an Unhealthy chip transition",
            registry=reg)
        self.uncordons = obs_metrics.get_or_create(
            obs_metrics.Counter, "tpu_reactor_uncordons_total",
            "Nodes un-cordoned after their chips recovered",
            registry=reg)
        self.evictions = obs_metrics.get_or_create(
            obs_metrics.Counter, "tpu_reactor_pods_evicted_total",
            "Gang member pods drained off cordoned nodes", registry=reg)
        self.cordoned_gauge = obs_metrics.get_or_create(
            obs_metrics.Gauge, "tpu_reactor_cordoned_nodes",
            "Nodes currently cordoned by the reactor", registry=reg)
        self._cordoned = set()
        self._seen = 0  # poll() position in an EventStream ring

    # -- event intake ---------------------------------------------------------

    def process(self, record):
        """Route one event record; returns the action taken (or None).

        Accepts both the unified schema (``kind``) and legacy streams
        (``event``)."""
        kind = record.get("kind") or record.get("event")
        if kind in ("alert_fired", "alert_resolved"):
            if self.on_alert is None:
                log.info("alert %s: rule %s (no alert handler wired)",
                         kind, record.get("rule", "?"))
                return None
            try:
                return self.on_alert(record)
            except Exception:  # noqa: BLE001 - keep reacting to health
                # A broken alert policy must not take down the loop
                # that also cordons/drains on health transitions (the
                # same posture as every other reaction path here).
                log.exception("alert handler failed on %s (rule %s)",
                              kind, record.get("rule", "?"))
                return None
        if kind in ("link_wedged", "link_desync"):
            # Lockstep-link failures (serve_cli's supervised engine
            # link): a rank vanished mid-collective or the op stream
            # diverged. Either way the gang's lockstep is broken —
            # same reaction as an Unhealthy chip: cordon the culprit's
            # node (the event's ``node``, from the link's rank->host
            # map, else the emitting host) and drain the WHOLE gang
            # losslessly so the scheduler re-places it on healthy
            # capacity. There is no link-level recovery event: the
            # cordon lifts on the node's next Healthy chip transition
            # or by an operator.
            node = self.node_of(record)
            if not node:
                return None
            log.warning(
                "link %s on %s (rank %s, op_seq %s): treating as "
                "unhealthy", kind, node, record.get("rank"),
                record.get("op_seq"),
            )
            if record.get("culprit") is False:
                # Observer self-report (the watchdog backstop): the
                # event names the REPORTER, not the vanished rank —
                # cordoning it would fence a healthy node. Drain the
                # gang (it spans every rank, so the whole lockstep
                # group re-places) and leave node health to the chip
                # pipeline. Idempotent: a drained gang is gated, so a
                # repeat report finds nothing bound.
                drained = self._drain(node) if self.drain_gangs else 0
                if not drained:
                    return None
                self.events.emit(
                    "node_drained", severity="warning", node=node,
                    pods=drained, **self._forensics(),
                )
                return "drained"
            return self._on_unhealthy(node, record)
        if kind != "health_transition":
            return None
        node = self.node_of(record)
        if not node:
            return None
        to = record.get("to")
        if to == UNHEALTHY:
            return self._on_unhealthy(node, record)
        if to == HEALTHY:
            return self._on_healthy(node, record)
        return None

    def poll(self, stream):
        """Consume the unread tail of an in-process EventStream ring."""
        new, self._seen = _unread_tail(stream, self._seen)
        actions = [self.process(r) for r in new]
        return [a for a in actions if a]

    def replay(self, path):
        """Process a JSONL event log's EXISTING contents, coalesced to
        each node's LAST health transition: a restarted reactor
        reconstructs the fleet's current state without replaying
        long-resolved outages (acting a historical Unhealthy of a node
        that recovered hours ago would drain its perfectly healthy
        gangs). Returns the byte offset where live tailing resumes."""
        last, order = {}, []
        offset = 0
        try:
            with open(path, "rb") as f:
                for raw in f:
                    if not raw.endswith(b"\n"):
                        break  # partial trailing write: leave for tail
                    offset += len(raw)
                    try:
                        rec = json.loads(raw.decode("utf-8", "replace"))
                    except ValueError:
                        continue
                    kind = rec.get("kind") or rec.get("event")
                    if kind != "health_transition":
                        continue
                    node = self.node_of(rec)
                    if not node:
                        continue
                    if node not in last:
                        order.append(node)
                    last[node] = rec
        except OSError:
            return 0  # no log yet: tail from the start when it appears
        for node in order:
            self.process(last[node])
        return offset

    # -- reactions ------------------------------------------------------------

    @staticmethod
    def _forensics():
        """``{"bundle": path}`` when an armed flight recorder has
        dumped a postmortem bundle, ``{}`` otherwise — every automated
        cordon/drain reaction event carries a pointer to the black-box
        evidence that preceded it (analyze with obs.postmortem)."""
        bundle = obs_flight.last_bundle()
        return {"bundle": bundle} if bundle else {}

    def _on_unhealthy(self, node, record):
        if node in self._cordoned:
            return None  # already cordoned+drained; flaps must not re-drain
        if not self.dry_run:
            self.client.cordon_node(node, cordoned_by=REACTOR_ID)
        self._cordoned.add(node)
        self.cordons.inc()
        self.cordoned_gauge.set(len(self._cordoned))
        self.events.emit(
            "node_cordoned", severity="warning", node=node,
            tpu=record.get("tpu", ""), reason=record.get("reason", ""),
            **self._forensics(),
        )
        log.warning("cordoned node %s (chip %s unhealthy: %s)", node,
                    record.get("tpu", "?"), record.get("reason", ""))
        drained = self._drain(node) if self.drain_gangs else 0
        self.events.emit(
            "node_drained", severity="warning", node=node, pods=drained,
            **self._forensics(),
        )
        return "cordoned"

    def _on_healthy(self, node, record):
        if node not in self._cordoned and not self._ours(node):
            return None
        if not self.dry_run:
            self.client.uncordon_node(node)
        self._cordoned.discard(node)
        self.uncordons.inc()
        self.cordoned_gauge.set(len(self._cordoned))
        self.events.emit(
            "node_uncordoned", severity="info", node=node,
            tpu=record.get("tpu", ""),
        )
        log.info("un-cordoned node %s (chip recovered)", node)
        return "uncordoned"

    def _ours(self, node):
        """True when the LIVE node carries a reactor-applied cordon: a
        restarted reactor's in-memory set is empty, but the ownership
        annotation survives, so recovery can still lift OUR cordon while
        an operator's manual cordon (no marker) is never touched. Dry
        runs never wrote the marker, so only the in-memory set counts."""
        if self.dry_run:
            return False
        try:
            obj = self.client.get_node(node)
        except Exception:  # noqa: BLE001 - treat unknown as not ours
            return False
        return bool(
            obj.get("spec", {}).get("unschedulable")
            and (obj.get("metadata", {}).get("annotations") or {}).get(
                CORDONED_BY_ANNOTATION) == REACTOR_ID
        )

    def _drain(self, node):
        """Evict every bound gang with a member on ``node`` — the whole
        gang, not just the local member, so it re-forms and is re-placed
        atomically with consistent ranks/world-size (one member alone
        would rejoin a world that no longer matches its annotations)."""
        try:
            all_pods = self.client.list_pods()
        except Exception:  # noqa: BLE001 - keep reacting on API hiccups
            log.exception("drain of %s: pod list failed", node)
            return 0
        bound = gang.bound_gang_members(
            all_pods,
            trust_priority_annotation=self.trust_priority_annotation,
        )
        drained = 0
        for key, members in sorted(bound.items()):
            if not any(m.bound_node == node for m in members):
                continue
            log.warning(
                "draining gang %s off %s (%d members)", key, node,
                len(members),
            )
            for pod in members:
                try:
                    how = self._evict(pod)
                except Exception:  # noqa: BLE001 - drain the rest anyway
                    log.exception("drain eviction of %s/%s failed",
                                  pod.namespace, pod.name)
                    continue
                drained += 1
                self.evictions.inc()
                self.events.emit(
                    "pod_evicted", severity="warning",
                    pod=f"{pod.namespace}/{pod.name}", node=node,
                    gang=list(key), how=how,
                )
        return drained

    def _evict(self, pod):
        """Lossless eviction (the scheduler's evict_member contract):
        controller-owned pods are deleted for their controller to
        recreate gated; bare pods are recreated from their live manifest
        with the original gate restored."""
        if self.dry_run:
            return "dry-run"
        if pod.controller_owned:
            try:
                self.client.delete_pod(pod.namespace, pod.name, uid=pod.uid)
            except KubeError as err:
                if err.status in (404, 409):
                    return "gone"  # already replaced externally
                raise
            return "deleted"
        try:
            self.client.recreate_gated_pod(
                pod.namespace, pod.name, pod.gate,
                clear_annotations=(
                    gang.RANK_ANNOTATION, gang.SLICE_ANNOTATION,
                    gang.WORKER_HOSTNAMES_ANNOTATION,
                    gang.WORKER_COUNT_ANNOTATION, gang.GATE_ANNOTATION,
                ),
                expect_uid=pod.uid,
            )
        except KubeError as err:
            if err.status == 404:
                return "gone"
            raise
        return "recreated"


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
