# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""A scripted synthetic serving "day": the tenant-SLO acceptance drill.

Port of ``container_engine_accelerators_tpu/fleet/daysim.py`` on the
port's fleet tier: its router, autoscaler, lifecycle, tenant classes and
hermetic replicas (``fleet/sim.py``: a real ``ContinuousEngine`` over
fake device seams), its ``obs`` copies, ``serve_cli.ServingSLO``, the
k8s client and the in-process kube API server. The day, the verdict and
the CLI are JAX's; ``run_day(requests=...)`` runs a smaller day.

``fleet/sim.py``'s storm drill proves the fleet survives one replica
kill. This module drives the WHOLE production control loop through a
compressed mixed-tenant day — the acceptance scenario for the closed
k8s actuation loop:

  * **three tenant classes** (premium / standard / batch: priorities,
    weighted queue shares, a batch token-rate quota) enforced at the
    router door AND inside every engine's admission queue;
  * **diurnal traffic**: a batch-heavy night, a premium/standard
    morning ramp, a batch **burst hour** that must shed *itself*
    (deterministically, against the scripted-clock quota) while
    premium stays whole, a **replica-kill storm**, a straggler window
    that exercises budgeted request **hedging**, and an idle evening
    the autoscaler scales in from;
  * **real actuation**: replicas are REAL pods created/bound/deleted
    through the real :class:`~container_engine_accelerators_tpu_torch
    .scheduler.k8s.KubeClient` against the conformant in-process kube
    API server, placed by the real gang scheduler over a synthetic
    node inventory — only the serving *process* is the hermetic
    fake-jit engine;
  * a mid-run **autoscaler restart**: a fresh autoscaler + lifecycle
    reconcile desired-vs-actual from the
    ``tpu-topology.gke.io/fleet-replica`` pod labels — surviving
    replicas adopted (never re-launched), the dead one's pods swept
    (never leaked), the router's rotation converged.

Acceptance (``verdict["pass"]``): per-class SLO goodput (premium
≥ 99% good while batch absorbs the burst by shedding), the burst's
quota sheds EXACTLY equal to the scripted token budget, exactly-once
retires (fleet retires == client successes + discarded hedge
duplicates) with byte-exact greedy outputs, zero orphaned/duplicated
pods after the restart, and desired == actual replicas at the end.
Deterministic under ``CHAOS_SEED`` (quota arithmetic runs on the
scripted clock; kills fire from a seeded fault plan; every assertion
is structural, not timing-based).

CLI::

    python -m container_engine_accelerators_tpu_torch.fleet.daysim \
        --requests 150000 --json /tmp/tenant-drill.json
"""

import argparse
import json
import logging
import os
import random
import sys
import threading
import time

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.fleet import (
    autoscaler as fleet_autoscaler,
)
from container_engine_accelerators_tpu_torch.fleet import (
    lifecycle as fleet_lifecycle,
)
from container_engine_accelerators_tpu_torch.fleet import router as fleet_router
from container_engine_accelerators_tpu_torch.fleet import sim as fleet_sim
from container_engine_accelerators_tpu_torch.fleet import tenants as fleet_tenants
from container_engine_accelerators_tpu_torch.obs import (
    devicetime as obs_devicetime,
)
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

MAX_NEW = 4          # tokens per request (quota arithmetic multiplies)
ENGINE_SLOTS = 8
ENGINE_QUEUE = 64

# Traffic mix: fraction of the day's requests per (phase, class). The
# phases run in this order; the scripted clock jumps between them (the
# quota buckets refill in the jumps, never inside a phase — that's
# what makes the burst's shed count exact).
PHASES = (
    ("night",    0.0,   {"batch": 0.10, "standard": 0.05}),
    ("morning",  100.0, {"premium": 0.15, "standard": 0.10}),
    ("burst",    200.0, {"batch": 0.30, "premium": 0.10,
                         "standard": 0.05}),
    ("storm_a",  300.0, {"premium": 0.035, "standard": 0.015}),
    ("storm_b",  310.0, {"premium": 0.035, "standard": 0.015}),
    ("straggle", 330.0, {"premium": 0.02, "standard": 0.01}),
    ("evening",  400.0, {"premium": 0.01, "batch": 0.01}),
)


def engine_tenant_config():
    """The per-replica admission config: weighted queue shares + shed
    order (no rates — the fleet-door quota lives on the router so the
    scripted-clock arithmetic has ONE bucket per class)."""
    return {
        "premium":  {"priority": 0, "queue_share": 0.5},
        "standard": {"priority": 1, "queue_share": 0.3},
        "batch":    {"priority": 2, "queue_share": 0.15,
                     "default": True},
    }


def router_tenant_config(requests):
    """The fleet-door config: same classes/shares plus the batch
    token-rate quota sized so the burst hour's demand overruns it ~2.5x
    (burst batch tokens = 0.30 * requests * MAX_NEW; the bucket holds
    0.48 * requests tokens = 40% of that demand) while the night's
    batch load fits the full bucket exactly."""
    burst_tokens = 0.48 * requests * MAX_NEW / 4.0  # = 0.48 * requests
    return {
        "premium":  {"priority": 0, "queue_share": 0.5},
        "standard": {"priority": 1, "queue_share": 0.3},
        "batch":    {"priority": 2, "queue_share": 0.15,
                     "default": True,
                     "rate_tokens_per_s": burst_tokens / 50.0,
                     "burst_tokens": burst_tokens},
    }


def _prompt_for(cls, i):
    """Deterministic per-request prompt; premium shares a prefix (the
    affinity population), the others spread."""
    if cls == "premium":
        return [7, 7, (i % 11) + 1]
    if cls == "standard":
        return [(i % 13) + 1, (i % 5) + 1]
    return [(i % 9) + 2, (i % 7) + 1, (i % 3) + 1]


def metric_value(registry, name, **labels):
    """One child's value out of a registry (0.0 when absent)."""
    metric = registry.get(name)
    if metric is None:
        return 0.0
    if labels:
        values = tuple(labels[k] for k in metric.labelnames)
        with metric._lock:
            child = metric._children.get(tuple(str(v) for v in values))
        return child.value if child is not None else 0.0
    return metric.value


def day_verdict(records):
    """Summarize the CONTROL-PLANE event records (router / autoscaler /
    lifecycle / alert streams — the consumer side of the fleet event
    contract; high-volume per-request counts come from metrics, which
    never rotate)."""
    out = {
        "launched": 0, "terminated": 0, "adopted": 0,
        "ejections": 0, "readmissions": 0,
        "scale_outs": 0, "scale_ins": 0,
        "hedged": {"won": 0, "lost": 0, "budget_denied": 0},
        "hedged_keys": 0,
        "tenant_shed_classes": {},
        "reissued": 0,
    }
    for rec in records:
        kind = rec.get("kind") or rec.get("event")
        if kind == "replica_launched":
            out["launched"] += 1
        elif kind == "replica_terminated":
            out["terminated"] += 1
        elif kind == "replica_adopted":
            out["adopted"] += 1
        elif kind == "replica_ejected":
            out["ejections"] += 1
        elif kind == "replica_readmitted":
            out["readmissions"] += 1
        elif kind == "scale_out":
            out["scale_outs"] += 1
        elif kind == "scale_in":
            out["scale_ins"] += 1
        elif kind == "request_hedged":
            outcome = rec.get("outcome")
            if outcome in out["hedged"]:
                out["hedged"][outcome] += 1
            if rec.get("key") is not None:
                out["hedged_keys"] += 1
        elif kind == "tenant_shed":
            cls = rec.get("tenant_class")
            out["tenant_shed_classes"][cls] = (
                out["tenant_shed_classes"].get(cls, 0)
                + int(rec.get("rows") or 1)
            )
        elif kind == "request_reissued":
            out["reissued"] += 1
    return out


def fairness_audit(tag):
    """The chip-accounting fairness acceptance: one fake-jit replica
    under genuine device-time contention (saturated queue, all three
    classes flooding), snapshotted MID-BACKLOG so the weighted stride
    scheduler — not the demand mix — decides who holds the device.
    Measured ``tpu_tenant_device_share`` must track each class's
    configured ``queue_share`` within tolerance; then premium is
    deliberately starved (a window where only standard/batch submit)
    and the ``tenant-share-drift`` example rule must fire off the
    replica's own registry. The ledger runs on a scripted clock so the
    starvation window is a clean break, not a timing race.

    Returns ``(audit, failures, replica)`` — the replica so the day's
    event-log dump includes the audit's chip_accounting/hbm_snapshot
    records."""
    from container_engine_accelerators_tpu_torch.obs import alerts as obs_alerts
    from container_engine_accelerators_tpu_torch.obs import hbm as obs_hbm

    failures = []
    aclock = [0.0]
    tenants = fleet_tenants.TenantClasses.from_dict(
        engine_tenant_config()
    )
    holder = []

    def make_dt(reg, tenant_classes):
        led = obs_devicetime.DeviceTimeLedger(
            registry=reg, tenants=tenant_classes,
            clock=lambda: aclock[0],
        )
        holder.append(led)
        return led

    sr = fleet_sim.SimReplica(
        "audit-0", chunk_sleep_s=0.002, max_slots=2,
        tenants=tenants, devicetime=make_dt,
    )
    led = holder[0]
    classes = ("premium", "standard", "batch")
    per_class_n = 24

    def _retired():
        return metric_value(
            sr.registry, "tpu_obs_events_total",
            source="serve", kind="request_retired", severity="info",
        )

    def _flood(mix):
        threads = []
        # Interleave class submissions so every class queue is
        # backlogged within the first few admissions.
        for i in range(max(mix.values())):
            for cls, n in mix.items():
                if i >= n:
                    continue
                t = threading.Thread(
                    target=lambda c=cls, j=i: sr.engine.generate(
                        [_prompt_for(c, j)], MAX_NEW, tenant=c,
                    ),
                    daemon=True,
                )
                threads.append(t)
        for t in threads:
            t.start()
        return threads

    # Phase 1 — contention: equal demand per class, snapshot while
    # every queue still holds backlog. Who has device time by then is
    # the stride scheduler's doing, pro-rata by queue_share.
    threads = _flood(dict.fromkeys(classes, per_class_n))
    snap_at = 30  # of 72: premium backlog survives (0.53 * 30 < 24)
    deadline = time.monotonic() + 60
    while _retired() < snap_at and time.monotonic() < deadline:
        time.sleep(0.002)
    shares_mid = {c: led.measured_share(c) for c in classes}
    for t in threads:
        t.join(60)
    configured = led._configured_shares()
    for cls in classes:
        want = configured[cls]
        got = shares_mid[cls]
        if not (0.5 * want <= got <= 2.0 * want):
            failures.append(
                f"fairness audit: {cls} measured device share "
                f"{got:.4f} off configured {want:.4f} by more than "
                f"2x under contention {tag}"
            )
    # Phase 2 — deliberate starvation: a fresh ledger window (the
    # scripted clock jump prunes phase 1) where premium submits
    # nothing while the others run. Its share ratio collapses and the
    # example drift rule must fire.
    aclock[0] = 1000.0
    for t in _flood({"standard": 10, "batch": 10}):
        t.join(60)
    starved_ratio = led.share_ratio("premium")
    if starved_ratio >= 0.5:
        failures.append(
            f"fairness audit: starved premium share ratio "
            f"{starved_ratio:.4f} did not collapse below 0.5 {tag}"
        )
    drift = [
        obs_alerts.AlertRule.from_dict(r)
        for r in obs_alerts.example_rules()["rules"]
        if r["name"] == "tenant-share-drift"
    ]
    evclock = [0.0]
    ev = obs_alerts.AlertEvaluator(
        [sr.registry], drift, clock=lambda: evclock[0],
        registry=sr.registry,
    )
    ev.tick()
    evclock[0] = 31.0
    fired = ev.tick()
    if ("fired", "tenant-share-drift") not in fired:
        failures.append(
            f"fairness audit: tenant-share-drift rule did not fire "
            f"on the starved class (transitions {fired}) {tag}"
        )
    led.emit_snapshot(sr.events)
    obs_hbm.HbmModel(sr.engine, registry=sr.registry).emit_snapshot(
        sr.events
    )
    audit = {
        "measured_share_mid": {
            c: round(shares_mid[c], 6) for c in classes
        },
        "configured_share": {
            c: round(configured[c], 6) for c in classes
        },
        "starved_premium_ratio": round(starved_ratio, 6),
        "drift_rule_fired": ("fired", "tenant-share-drift") in fired,
    }
    return audit, failures, sr


def run_day(requests=120000, n_replicas=3, seed=None, workers=16,
            event_log=""):
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    # Storm kills fire from an armed fault plan at scripted dispatch
    # indices within the storm phases (one tick per storm request).
    storm_a = int(requests * 0.05)
    storm_b = int(requests * 0.05)
    faults.arm(faults.FaultPlan([
        {"kind": "host_vanish", "site": fleet_sim.FAULT_SITE,
         "at": max(1, storm_a // 3), "count": 1},
        {"kind": "host_vanish", "site": fleet_sim.FAULT_SITE,
         "at": storm_a + max(1, storm_b // 3), "count": 1},
    ], seed=seed))
    try:
        return _run_day_armed(
            requests, n_replicas, seed, tag, workers, event_log
        )
    finally:
        faults.disarm()


def _run_day_armed(requests, n_replicas, seed, tag, workers,
                   event_log=""):
    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.testing import kubeapi

    simclock = [0.0]
    rng = random.Random(seed)

    # -- the cluster: conformant kube API + synthetic 2x2 slice -------------
    server = kubeapi.KubeApiServer().start()
    try:
        from container_engine_accelerators_tpu_torch.scheduler.k8s import (
            KubeClient,
        )

        kube = KubeClient(base_url=server.url, token=None,
                          ca_cert=False)
        for i in range(4):
            raw = fleet_sim._raw_node(f"day-node-{i}", (i // 2, i % 2))
            raw.update({"apiVersion": "v1", "kind": "Node"})
            server.apply(raw)
        return _run_day_cluster(
            requests, n_replicas, seed, tag, workers, kube,
            simclock, rng, serve_cli, event_log=event_log,
        )
    finally:
        server.stop()


def _run_day_cluster(requests, n_replicas, seed, tag, workers,
                     kube, simclock, rng, serve_cli, event_log=""):
    registry = obs_metrics.Registry()
    router_events = obs_events.EventStream(
        fleet_router.EVENT_SOURCE, registry=registry,
    )
    lifecycle_events = obs_events.EventStream(
        fleet_lifecycle.EVENT_SOURCE, registry=registry,
    )

    engine_tenants = fleet_tenants.TenantClasses.from_dict(
        engine_tenant_config()
    )
    router_tenants = fleet_tenants.TenantClasses.from_dict(
        router_tenant_config(requests), clock=lambda: simclock[0],
    )
    slos = []

    def make_slo(reg):
        slo = serve_cli.ServingSLO(ttft_s=30.0, registry=reg)
        slos.append(slo)
        return slo

    # Chip accounting (obs/devicetime.py): every replica carries its
    # own ledger — per-class attributed device-seconds roll up on the
    # replica's registry, and the end-of-day exact-sum check below is
    # the drill's attribution acceptance.
    ledgers = []

    def make_devicetime(reg, tenant_classes):
        led = obs_devicetime.DeviceTimeLedger(
            registry=reg, tenants=tenant_classes,
        )
        ledgers.append(led)
        return led

    backend = fleet_sim.SimBackend(
        chunk_sleep_s=0.0, max_slots=ENGINE_SLOTS,
        max_queue=ENGINE_QUEUE,
        make_tenants=lambda: engine_tenants, make_slo=make_slo,
        make_devicetime=make_devicetime,
    )
    router = fleet_router.ReplicaRouter(
        events=router_events, registry=registry,
        eject_after=2, readmit_after=2,
        hedge_after_ms=40.0, hedge_budget_pct=50.0,
        tenants=router_tenants,
        # Generous capacity shares at the fleet door: the day's
        # binding batch constraint must be the TOKEN QUOTA (exact
        # against the scripted clock), not the timing-dependent
        # concurrency share — the share gates are exercised by the
        # engines' queue slices and the unit tests.
        tenant_oversub=16.0,
    )
    lifecycle = fleet_lifecycle.ReplicaLifecycle(
        kube, backend, placer=fleet_lifecycle.cluster_placer(kube),
        events=lifecycle_events,
    )
    scaler = fleet_autoscaler.Autoscaler(
        router=router, lifecycle=lifecycle, kube=kube,
        events=router_events, registry=registry,
        min_replicas=2, max_replicas=4,
        scale_out_cooldown_s=1.0, scale_in_cooldown_s=1.0,
        idle_for_s=5.0, idle_occupancy=0.05,
        placer=lifecycle.placer, clock=lambda: simclock[0],
    )
    for i in range(n_replicas):
        handle = lifecycle.launch(f"day-{i}")
        assert handle is not None, "initial launch failed"
        router.register(handle)

    # -- probe loop (runs through the whole day) ----------------------------
    stop_probes = threading.Event()

    def _probe_sweep():
        for sr in list(backend.replicas.values()):
            try:
                info = sr.probe()
            except Exception:  # noqa: BLE001 - dead replica = signal
                router.observe_probe(sr.replica_id, ok=False)
            else:
                router.observe_probe(sr.replica_id, ok=True, info=info)

    def _probe_loop():
        while not stop_probes.wait(0.02):
            _probe_sweep()

    threading.Thread(target=_probe_loop, daemon=True).start()

    # -- traffic machinery --------------------------------------------------
    outcomes = []       # (cls, status, tokens_or_reason, prompt)
    outcomes_lock = threading.Lock()
    killed = []

    def _maybe_kill():
        for spec in faults.tick(fleet_sim.FAULT_SITE):
            if spec.kind not in ("host_vanish", "chip_wedge"):
                continue
            live = [s for s in backend.replicas.values() if s.alive]
            if not live:
                return
            inflight = {
                snap["replica"]: snap["inflight"]
                for snap in router.snapshot()
            }
            target = max(
                live, key=lambda s: inflight.get(s.replica_id, 0),
            )
            target.kill()
            killed.append(target)
            log.warning("day: killed %s mid-storm", target.replica_id)

    def _run_traffic(specs, storm=False):
        """Drive one phase's request list through the router from
        ``workers`` client threads; every outcome is recorded."""
        def _client(i):
            cls, prompt = specs[i]
            if storm:
                _maybe_kill()
            try:
                out = router.submit(
                    {"tokens": [prompt], "max_new_tokens": MAX_NEW,
                     "tenant": cls},
                )
                rec = (cls, "ok", out["tokens"][0], prompt)
            except fleet_router.BackendShed as e:
                rec = (cls, "shed", e.reason, prompt)
            except Exception as e:  # noqa: BLE001 - verdict counts errors
                rec = (cls, "error", str(e), prompt)
            with outcomes_lock:
                outcomes.append(rec)

        def _worker(ids):
            for i in ids:
                _client(i)

        threads = [
            threading.Thread(
                target=_worker, args=(range(w, len(specs), workers),),
                daemon=True,
            )
            for w in range(workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)

    def _phase_specs(mix):
        specs = []
        for cls, frac in mix.items():
            n = int(requests * frac)
            specs.extend(
                (cls, _prompt_for(cls, i)) for i in range(n)
            )
        rng.shuffle(specs)  # interleave classes deterministically
        return specs

    def _retired_total():
        total = 0.0
        for sr in backend.replicas.values():
            total += metric_value(
                sr.registry, "tpu_obs_events_total",
                source="serve", kind="request_retired", severity="info",
            )
        return total

    def _settle(deadline_s=20.0):
        """Wait until nothing is in flight through the router (late
        hedge losers must land their bookkeeping before accounting)."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if router._total_inflight() == 0:
                return True
            time.sleep(0.01)
        return False

    failures = []
    checks = {}

    # -- the day ------------------------------------------------------------
    phase_shed = {}
    for name, t, mix in PHASES:
        simclock[0] = t
        specs = _phase_specs(mix)
        if name == "burst":
            # The quota ledger, before the burst: the bucket level (on
            # the frozen clock) decides EXACTLY how many batch tokens
            # admit. Quota is consumed only by requests that passed
            # the class-share gate, so the identity is
            #   quota_sheds == batch_n - class_share_sheds - admits
            # with admits = floor(level / MAX_NEW) — every quantity
            # but the share sheds fixed by the script, and those
            # measured from the reason-labeled counter.
            level = router_tenants.quota_level("batch")
            batch_n = sum(1 for cls, _ in specs if cls == "batch")
            quota_before = metric_value(
                registry, "tpu_router_tenant_shed_total",
                tenant_class="batch", reason="quota",
            )
            share_before = metric_value(
                registry, "tpu_router_tenant_shed_total",
                tenant_class="batch", reason="class_share",
            )
        if name == "straggle":
            # The lowest-id live replica turns straggler (the router's
            # deterministic tie-break sends the phase's first requests
            # there): they exceed the hedge trigger and a budgeted
            # hedge serves the client from a peer.
            straggler = min(
                (s for s in backend.replicas.values() if s.alive),
                key=lambda s: s.replica_id,
            )
            straggler.straggle_s = 0.3
        if name == "storm_b":
            # Part A's victim comes back between the two kills (the
            # storm is a sequence, not a simultaneous outage): probes
            # eject it first, then readmit after revival.
            for sr in killed:
                for _ in range(2):
                    router.observe_probe(sr.replica_id, ok=False)
                sr.revive()
            for _ in range(3):
                _probe_sweep()
        _run_traffic(specs, storm=name.startswith("storm"))
        if name == "burst":
            quota_after = metric_value(
                registry, "tpu_router_tenant_shed_total",
                tenant_class="batch", reason="quota",
            )
            share_after = metric_value(
                registry, "tpu_router_tenant_shed_total",
                tenant_class="batch", reason="class_share",
            )
            share_sheds = int(share_after - share_before)
            expected_quota_sheds = max(
                0, batch_n - share_sheds - int(level) // MAX_NEW
            )
            phase_shed["burst_quota"] = quota_after - quota_before
            phase_shed["burst_class_share"] = share_sheds
            checks["expected_quota_sheds"] = expected_quota_sheds
            if quota_after - quota_before != expected_quota_sheds:
                failures.append(
                    f"burst quota sheds {quota_after - quota_before} "
                    f"!= scripted budget {expected_quota_sheds} {tag}"
                )
        if name == "straggle":
            straggler.straggle_s = 0.0
            _settle()

    # Make the second kill's ejection durable on the record, then run
    # the control plane: the storm's ejections are capacity-loss
    # pressure -> scale-out through the REAL placer and lifecycle (a
    # new pod, gang-bound onto the free node).
    for sr in killed:
        if not sr.alive:
            for _ in range(2):
                router.observe_probe(sr.replica_id, ok=False)
    simclock[0] = 410.0
    scaler.poll(router_events)
    replicas_after_scale_out = len(router.replicas())

    # -- the autoscaler restart ---------------------------------------------
    # A fresh controller (new lifecycle + autoscaler, same cluster and
    # backend — the processes outlive their controller) reconciles
    # desired-vs-actual from the pod labels: surviving replicas
    # adopted, the dead victim's pods orphan-swept, the router
    # converged. No double launches, no leaked pods.
    pods_before = lifecycle.labeled_pods()
    lifecycle2 = fleet_lifecycle.ReplicaLifecycle(
        kube, backend,
        placer=fleet_lifecycle.cluster_placer(kube),
        events=lifecycle_events,
    )
    scaler2 = fleet_autoscaler.Autoscaler(
        router=router, lifecycle=lifecycle2, kube=kube,
        events=router_events, registry=obs_metrics.Registry(),
        min_replicas=2, max_replicas=4,
        scale_out_cooldown_s=1.0, scale_in_cooldown_s=1.0,
        idle_for_s=5.0, idle_occupancy=0.05,
        placer=lifecycle2.placer, clock=lambda: simclock[0],
    )
    reconcile = scaler2.adopt_existing()
    checks["reconcile"] = reconcile
    dead_ids = {s.replica_id for s in killed if not s.alive}
    pods_after = lifecycle2.labeled_pods()
    router_ids = {r.replica_id for r in router.replicas()}
    if set(pods_after) != set(lifecycle2.handles):
        failures.append(
            f"desired != actual after restart: pods {sorted(pods_after)}"
            f" vs handles {sorted(lifecycle2.handles)} {tag}"
        )
    if router_ids != set(lifecycle2.handles):
        failures.append(
            f"router rotation {sorted(router_ids)} != reconciled fleet "
            f"{sorted(lifecycle2.handles)} {tag}"
        )
    if reconcile["adopted"] and set(reconcile["adopted"]) & dead_ids:
        failures.append(f"adopted a dead replica {tag}")
    for rid in dead_ids:
        if rid in pods_after:
            failures.append(f"orphaned pods of {rid} leaked {tag}")
    for rid, pods in pods_after.items():
        names = [p["metadata"]["name"] for p in pods]
        if len(names) != len(set(names)) or len(names) != 1:
            failures.append(
                f"duplicated pods for {rid}: {names} {tag}"
            )
    if set(pods_before) - set(pods_after) != dead_ids:
        failures.append(
            f"restart removed {sorted(set(pods_before) - set(pods_after))}"
            f", expected exactly the dead {sorted(dead_ids)} {tag}"
        )

    # -- evening scale-in (the restarted controller acts) -------------------
    simclock[0] = 500.0
    scaler2.tick()   # quiet fleet: the idle run starts
    simclock[0] = 520.0
    scaler2.tick()   # sustained idle -> cordon, drain, scale-in
    stop_probes.set()
    _settle()

    # -- accounting ---------------------------------------------------------
    by_class = {}
    corrupted = 0
    for cls, status, val, prompt in outcomes:
        c = by_class.setdefault(
            cls, {"ok": 0, "shed": 0, "error": 0}
        )
        c[status] += 1
        if status == "ok" and val != fleet_sim.expected_output(
            prompt, MAX_NEW
        ):
            corrupted += 1
    oks = sum(c["ok"] for c in by_class.values())
    retired = _retired_total()
    wasted = metric_value(registry, "tpu_router_hedge_wasted_total")
    records = []
    for stream in (router_events, lifecycle_events):
        records.extend(stream.events())
    verdict = day_verdict(records)
    verdict.update(checks)
    verdict["by_class"] = by_class
    verdict["phase_shed"] = phase_shed

    prem = by_class.get("premium", {"ok": 0, "shed": 0, "error": 0})
    prem_total = sum(prem.values())
    prem_goodput = prem["ok"] / prem_total if prem_total else 0.0
    batch = by_class.get("batch", {"ok": 0, "shed": 0, "error": 0})
    if corrupted:
        failures.append(f"{corrupted} corrupted outputs {tag}")
    if prem_goodput < 0.99:
        failures.append(
            f"premium goodput {prem_goodput:.4f} < 0.99 "
            f"({prem}) {tag}"
        )
    if batch["shed"] < verdict.get("expected_quota_sheds", 1):
        failures.append(
            f"batch sheds {batch['shed']} did not absorb the burst "
            f"{tag}"
        )
    if retired != oks + wasted:
        failures.append(
            f"retires ({retired:.0f}) != served ({oks}) + discarded "
            f"hedge duplicates ({wasted:.0f}): lost or double-retired "
            f"{tag}"
        )
    if len(killed) < 2:
        failures.append(f"storm killed {len(killed)} < 2 {tag}")
    if killed and verdict["ejections"] < 2:
        failures.append(f"kills were not ejected {tag}")
    if verdict["readmissions"] < 1:
        failures.append(f"revived replica never re-admitted {tag}")
    if verdict["scale_outs"] < 1 or replicas_after_scale_out < 4:
        failures.append(f"storm did not scale the fleet out {tag}")
    if verdict["scale_ins"] < 1:
        failures.append(f"idle evening did not scale in {tag}")
    if not lifecycle2.drained:
        failures.append(f"scale-in skipped the lossless drain {tag}")
    won = verdict["hedged"]["won"]
    if won < 1:
        failures.append(f"straggler window produced no hedge win {tag}")
    # Desired == actual at the end of the day.
    final_pods = lifecycle2.labeled_pods()
    final_router = {r.replica_id for r in router.replicas()}
    if set(final_pods) != final_router or \
            set(final_pods) != set(lifecycle2.handles):
        failures.append(
            f"end-of-day drift: pods {sorted(final_pods)} vs router "
            f"{sorted(final_router)} vs handles "
            f"{sorted(lifecycle2.handles)} {tag}"
        )
    # Per-class SLO exposition: the scrapeable contract — every class
    # classified under its own label on the engines it ran on.
    slo_good = {}
    for cls in ("premium", "standard", "batch"):
        slo_good[cls] = sum(
            metric_value(
                slo.registry, "tpu_serving_slo_requests_total",
                outcome="good", tenant_class=cls,
            )
            for slo in slos
        )
    verdict["slo_good"] = slo_good
    for cls, good in slo_good.items():
        if good < 1:
            failures.append(
                f"no good-outcome SLO series for class {cls} {tag}"
            )

    # -- chip accounting ----------------------------------------------------
    # Attribution acceptance: on every replica's ledger the per-class
    # attributed device-seconds must sum back to the measured device
    # wall within 1% (the ledger's exact-sum invariant, checked here on
    # real mixed-tenant traffic rather than unit fixtures). Each
    # replica also emits its lifetime chip_accounting / hbm_snapshot
    # records so the event log carries everything obs.capacity needs.
    from container_engine_accelerators_tpu_torch.obs import hbm as obs_hbm

    chip = {
        "device_s": 0.0, "bubble_s": 0.0,
        "per_class": {}, "per_phase": {}, "replicas": 0,
    }
    for sr in backend.replicas.values():
        if sr.devicetime is None:
            continue
        snap = sr.devicetime.snapshot()
        chip["replicas"] += 1
        chip["device_s"] += snap["device_s"]
        chip["bubble_s"] += snap["bubble_s"]
        for cls, secs in snap["per_class"].items():
            chip["per_class"][cls] = (
                chip["per_class"].get(cls, 0.0) + secs
            )
        for phase, secs in snap["per_phase"].items():
            chip["per_phase"][phase] = (
                chip["per_phase"].get(phase, 0.0) + secs
            )
        booked = sum(snap["per_class"].values())
        if abs(booked - snap["device_s"]) > 0.01 * snap["device_s"]:
            failures.append(
                f"chip accounting on {sr.replica_id}: per-class sum "
                f"{booked:.6f}s != measured device wall "
                f"{snap['device_s']:.6f}s beyond 1% {tag}"
            )
        sr.devicetime.emit_snapshot(sr.events)
        obs_hbm.HbmModel(
            sr.engine, registry=sr.registry,
        ).emit_snapshot(sr.events)
    if chip["device_s"] <= 0.0:
        failures.append(
            f"chip accounting attributed no device time across the "
            f"day ({chip['replicas']} armed replicas) {tag}"
        )
    chip["device_s"] = round(chip["device_s"], 6)
    chip["bubble_s"] = round(chip["bubble_s"], 6)
    chip["per_class"] = {
        c: round(v, 6) for c, v in sorted(chip["per_class"].items())
    }
    chip["per_phase"] = {
        p: round(v, 6) for p, v in sorted(chip["per_phase"].items())
    }
    verdict["chip_accounting"] = chip

    # -- fairness audit -----------------------------------------------------
    # The day itself runs with instant fake device calls, so measured
    # share tracks the traffic mix; the audit replica re-runs the
    # share contract under genuine contention where the stride
    # scheduler — not demand — allocates the device.
    audit, audit_failures, audit_sr = fairness_audit(tag)
    verdict["fairness_audit"] = audit
    failures.extend(audit_failures)

    if event_log:
        for sr in backend.replicas.values():
            records.extend(sr.events.events())
        records.extend(audit_sr.events.events())
        with open(event_log, "w") as f:
            for rec in sorted(records, key=lambda r: r.get("ts", 0.0)):
                f.write(json.dumps(rec, sort_keys=True, default=str))
                f.write("\n")
        log.info("wrote %d event records to %s", len(records),
                 event_log)

    verdict.update({
        "seed": seed,
        "requests_total": len(outcomes),
        "served": oks,
        "retired": retired,
        "hedge_wasted": wasted,
        "premium_goodput": round(prem_goodput, 6),
        "replicas_final": len(router.replicas()),
        "failures": failures,
        "pass": not failures,
    })
    return verdict


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--requests", type=int, default=150000,
                   help="total requests across the day's phases (the "
                        "mix fractions scale with it)")
    p.add_argument("--replicas", type=int, default=3,
                   help="fleet size the day starts with (pods "
                        "launched through the real lifecycle)")
    p.add_argument("--workers", type=int, default=16,
                   help="concurrent client threads")
    p.add_argument("--seed", type=int, default=None,
                   help="chaos seed (default: CHAOS_SEED env, else 0)")
    p.add_argument("--json", default="",
                   help="write the machine-readable verdict here")
    p.add_argument("--event-log", default="",
                   help="dump every event record (router, lifecycle, "
                        "per-replica serve streams incl. the "
                        "chip_accounting/hbm_snapshot ledgers) as "
                        "JSONL here — the obs.capacity report input")
    args = p.parse_args(argv)
    verdict = run_day(
        requests=args.requests, n_replicas=args.replicas,
        seed=args.seed, workers=args.workers,
        event_log=args.event_log,
    )
    out = json.dumps(verdict, indent=2, sort_keys=True, default=str)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if not verdict["pass"]:
        for failure in verdict["failures"]:
            log.error("day drill failure: %s", failure)
        return 1
    log.info(
        "tenant day drill passed: %d requests, premium goodput %.4f, "
        "%d batch sheds, %d hedge wins, scale out->restart->in "
        "complete",
        verdict["requests_total"], verdict["premium_goodput"],
        verdict["by_class"].get("batch", {}).get("shed", 0),
        verdict["hedged"]["won"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
