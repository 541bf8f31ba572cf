# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's fleet tier against the JAX package's: the chaos drill
(JAX ``tests/test_fleet_chaos.py``'s assertions on the port's
``fleet/sim.py`` over port engines), its verdict against JAX's drill on
the structural fields, the membership storm, the gang placement copy
(``scheduler/gang.py``, ``topology/``) against JAX's, and the router and
autoscaler copies driven by the same scripted records in both
packages. Hermetic: fake device seams, the CPU, ``CHAOS_SEED``."""

import json
import os

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu import faults as jfaults  # noqa: E402
from container_engine_accelerators_tpu.fleet import autoscaler as jauto  # noqa: E402
from container_engine_accelerators_tpu.fleet import router as jrouter  # noqa: E402
from container_engine_accelerators_tpu.fleet import sim as jsim  # noqa: E402
from container_engine_accelerators_tpu.obs import events as jevents  # noqa: E402
from container_engine_accelerators_tpu.obs import metrics as jmetrics  # noqa: E402
from container_engine_accelerators_tpu.scheduler import gang as jgang  # noqa: E402
from container_engine_accelerators_tpu_torch import faults  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import autoscaler as tauto  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import router as trouter  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import sim  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import events as tevents  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from container_engine_accelerators_tpu_torch.scheduler import gang as tgang  # noqa: E402

SEED = int(os.environ.get("CHAOS_SEED", "0"))
TAG = f"(chaos seed={SEED}; rerun with CHAOS_SEED={SEED})"


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


# -- JAX's test_fleet_chaos.py, on the port ----------------------------------


def test_fleet_storm_replica_kill_drill():
    """Kill one of three replicas mid-storm: every accepted request
    retires exactly once with byte-exact greedy output, the router
    ejects and re-admits the replica, and the autoscaler scales out on
    the fired burn-rate alert then drains-and-scales-in on sustained
    idle."""
    verdict = sim.run_drill(n_replicas=3, requests=24, seed=SEED)
    assert verdict["pass"], "\n".join(verdict["failures"])
    assert verdict["retired"] == verdict["served"], TAG
    assert verdict["served"] + verdict["shed"] + verdict["errors"] \
        == verdict["requests"], TAG
    keys = verdict["reissued_keys"]
    assert len(keys) == len(set(keys)), TAG
    assert verdict["ejections"] >= 1, TAG
    assert verdict["readmissions"] >= 1, TAG
    assert verdict["scale_outs"] >= 1, TAG
    assert verdict["scale_ins"] >= 1, TAG


def test_drill_cli_writes_machine_readable_verdict(tmp_path):
    out = tmp_path / "verdict.json"
    rc = sim.main([
        "--replicas", "3", "--requests", "16", "--json", str(out),
    ])
    assert rc == 0
    verdict = json.loads(out.read_text())
    assert verdict["pass"] is True
    assert verdict["requests"] == 16


def test_fault_plan_can_name_the_victim_replica():
    """The fleet.replica site honors the spec's ``node`` scoping: the
    named replica dies, not the busiest."""
    faults.arm(faults.FaultPlan([
        {"kind": "host_vanish", "site": sim.FAULT_SITE, "at": 0,
         "count": 1, "node": "replica-2"},
    ], seed=SEED))
    try:
        verdict = sim._run_drill_armed(
            3, 12, 6, SEED, TAG, 0.004, 8, 0.02, 5.0, 2, 5,
        )
    finally:
        faults.disarm()
    assert verdict["pass"], "\n".join(verdict["failures"])


def test_drill_verdict_counts_the_fleet_event_kinds():
    records = [
        {"kind": "request_retired", "latency_s": 0.1},
        {"kind": "request_retired", "latency_s": 0.2},
        {"kind": "request_reissued", "key": "rk-1"},
        {"kind": "replica_ejected", "replica": "r0",
         "reason": "probe_failed"},
        {"kind": "replica_readmitted", "replica": "r0"},
        {"kind": "scale_out", "replicas": 4, "reason": "burn_rate"},
        {"kind": "scale_in", "replicas": 3, "replica": "r1",
         "reason": "sustained_idle"},
        {"kind": "request_migrated", "reason": "autoscaler scale-in"},
        {"event": "request_retired", "latency_s": 0.3},  # legacy key
    ]
    v = sim.drill_verdict(records)
    assert v == jsim.drill_verdict(records)
    assert v["retired"] == 3
    assert v["reissued"] == 1 and v["reissued_keys"] == ["rk-1"]
    assert v["ejections"] == 1 and v["readmissions"] == 1
    assert v["scale_outs"] == 1 and v["last_scale_out_replicas"] == 4
    assert v["scale_ins"] == 1 and v["last_scale_in_replicas"] == 3
    assert v["migrated"] == 1


def test_membership_storm_prefix_hits_survive_via_kv_handoff():
    """A membership storm keeps the fleet-wide prefix hit ratio high
    because remapped prompts arrive via KV handoff (real pool bytes on
    the port), not re-prefill."""
    verdict = sim.run_membership_storm(seed=SEED)
    assert verdict["pass"], "\n".join(verdict["failures"]) + " " + TAG
    assert verdict["kv_handoffs"] >= verdict["rounds"], TAG
    assert verdict["kv_handoff_failures"] == 0, TAG
    assert verdict["storm_hit_ratio"] >= 0.85, TAG
    assert verdict["errors"] == 0, TAG


def test_membership_storm_without_handoff_reprefills():
    verdict = sim.run_membership_storm(seed=SEED, handoff=False)
    assert verdict["kv_handoffs"] == 0, TAG
    assert verdict["errors"] == 0, TAG
    with_handoff = sim.run_membership_storm(seed=SEED)
    assert with_handoff["storm_hit_ratio"] \
        > verdict["storm_hit_ratio"], TAG


@pytest.mark.parametrize("kv_cache", ["paged", "dense"])
def test_fake_engine_is_the_real_engine_with_scripted_device_calls(
        kv_cache):
    eng = sim.make_fake_engine(kv_cache=kv_cache)
    try:
        (got,) = eng.generate([[3, 4, 5]], 6)
        assert got == sim.expected_output([3, 4, 5], 6)
        assert eng.device.type == "cpu"
    finally:
        eng.shutdown()


def test_fake_engine_speculating_with_a_draft_is_byte_exact():
    eng = sim.make_fake_engine(
        speculate="draft", spec_proposer=sim.FakeDraftProposer(
            wrong_every=3))
    try:
        (got,) = eng.generate([[3, 4, 5]], 12)
        assert got == sim.expected_output([3, 4, 5], 12)
        assert eng.stats()["spec_verifies"] >= 1
    finally:
        eng.shutdown()


def test_killed_replica_fails_fast_and_revives_clean():
    sr = sim.SimReplica("r0")
    assert sr.transport(
        {"tokens": [[1, 2]], "max_new_tokens": 3}
    ) == {"tokens": [sim.expected_output([1, 2], 3)]}
    sr.kill()
    with pytest.raises(trouter.TransportError):
        sr.transport({"tokens": [[1, 2]], "max_new_tokens": 3})
    with pytest.raises(trouter.TransportError):
        sr.probe()
    sr.revive()
    assert sr.transport(
        {"tokens": [[5]], "max_new_tokens": 2}
    ) == {"tokens": [sim.expected_output([5], 2)]}
    assert sr.probe()["status"] == "ok"


def test_engine_killed_mid_call_keeps_its_pools_and_serves_after():
    """The port's own failure path under a kill: the seam raises at
    dispatch, the engine fails the call's rows and keeps its pools, and
    a revived replica serves byte-exact from them (the drill's
    re-issue relies on this)."""
    sr = sim.SimReplica("r0", chunk_sleep_s=0.0)
    prompt = list(range(1, 14))
    assert sr.transport({"tokens": [prompt], "max_new_tokens": 4}) == \
        {"tokens": [sim.expected_output(prompt, 4)]}
    cached = sr.engine.kv_stats()["cached_blocks"]
    alive = [True]
    sr.engine._paged_chunk, chunk = (
        lambda *a, **k: (_ for _ in ()).throw(ConnectionError("down"))
        if not alive[0] else chunk(*a, **k)), sr.engine._paged_chunk
    alive[0] = False
    with pytest.raises(RuntimeError, match="down"):
        sr.engine.generate([[7, 8]], 4)
    assert sr.engine.kv_stats()["cached_blocks"] == cached
    alive[0] = True
    assert sr.engine.generate([prompt], 4) == \
        [sim.expected_output(prompt, 4)]
    assert sr.engine.kv_stats()["prefix_hit_tokens"] >= 12


# -- the drills against JAX's ---------------------------------------------------

# Verdict fields that are the drill's structure (not its timing).
STRUCTURAL = ("pass", "requests", "served", "shed", "errors", "retired",
              "ejections", "readmissions", "scale_outs", "scale_ins",
              "last_scale_out_replicas", "last_scale_in_replicas",
              "replicas_final", "kv_handoffs", "kv_handoff_failures")


def _kinds(verdict):
    """The event kinds the drill saw (its nonzero counts)."""
    return {k for k in ("retired", "reissued", "ejections",
                        "readmissions", "scale_outs", "scale_ins",
                        "migrated", "kv_handoffs", "kv_handoff_failures")
            if verdict[k]}


def _drill_killing_replica_2(faults_mod, sim_mod):
    """The drill with the victim named and the kill at the first
    dispatch, so it lands while the storm has most of its requests
    ahead (JAX's test_fault_plan_can_name_the_victim_replica)."""
    faults_mod.arm(faults_mod.FaultPlan([
        {"kind": "host_vanish", "site": sim_mod.FAULT_SITE, "at": 0,
         "count": 1, "node": "replica-2"},
    ], seed=SEED))
    try:
        return sim_mod._run_drill_armed(
            3, 12, 6, SEED, TAG, 0.004, 8, 0.02, 5.0, 2, 5,
        )
    finally:
        faults_mod.disarm()


def test_chaos_drill_verdict_agrees_with_jax_s():
    """The same drill on JAX's engines and the port's: the structural
    fields and the event kinds agree. The number of re-issued requests
    is the rows in flight on the victim when it died, a matter of
    timing in either package, and is not compared."""
    port = _drill_killing_replica_2(faults, sim)
    ref = _drill_killing_replica_2(jfaults, jsim)
    assert {k: port.get(k) for k in STRUCTURAL} == \
        {k: ref.get(k) for k in STRUCTURAL}, (ref["failures"], TAG)
    assert _kinds(port) == _kinds(ref), TAG
    assert port["retired"] == port["served"] == port["requests"], TAG


@pytest.mark.parametrize("handoff", [True, False])
def test_membership_storm_verdict_equals_jax_s(handoff):
    """Sequential traffic makes the storm exact: the same churn, the same
    handoffs and the same fleet hit ratios as JAX's."""
    port = sim.run_membership_storm(seed=SEED, handoff=handoff)
    ref = jsim.run_membership_storm(seed=SEED, handoff=handoff)
    assert port == ref, TAG


# -- the gang placement copy --------------------------------------------------


def _inventory(gang_mod, n_nodes, tpu=4, busy=()):
    nodes = []
    for i in range(n_nodes):
        raw = sim._raw_node(f"sim-node-{i}", (i // 2, i % 2), tpu=tpu)
        usage = {"google.com/tpu": 4.0} if i in busy else None
        nodes.append(gang_mod.node_info(raw, usage=usage))
    return nodes


def _gang(gang_mod, size, tpu=4):
    pods = [sim._raw_pod(f"fleet-replica-{i}", tpu=tpu)
            for i in range(size)]
    return [gang_mod.pod_info(p, gang_mod.find_gate(p)) for p in pods]


PLACEMENTS = {
    # (nodes, gang size, busy node indices)
    "sim_1xN_slice": (4, 2, ()),
    "full_slice": (4, 4, ()),
    "one_node_gang": (4, 1, (0,)),
    "around_a_busy_node": (4, 2, (0,)),
    "does_not_fit": (4, 3, (1, 2)),
    "too_big": (4, 5, ()),
}


@pytest.mark.parametrize("case", sorted(PLACEMENTS))
def test_placement_equals_jax_s(case):
    n_nodes, size, busy = PLACEMENTS[case]
    got = {}
    for name, gang_mod in (("jax", jgang), ("port", tgang)):
        out = gang_mod.place_gang_on_slice(
            _gang(gang_mod, size), _inventory(gang_mod, n_nodes, busy=busy))
        got[name] = None if out is None else [
            (b.pod.name, b.node, b.rank, b.slice_name) for b in out]
    assert got["port"] == got["jax"]
    assert (got["port"] is None) == (case in ("does_not_fit", "too_big"))


def test_sim_placer_places_through_the_port_s_gang():
    bindings = sim.sim_placer().place()
    assert [(b.node, b.rank) for b in bindings] == \
        [(b.node, b.rank) for b in jsim.sim_placer().place()]


# -- the router and autoscaler copies, scripted ---------------------------------


def _scripted_router(router_mod, events_mod, metrics_mod):
    """Three replicas on pure transports; a script of submissions,
    probe failures (an ejection), recoveries (a re-admission) and
    prefix lookups. Returns which replica served each request, the
    emitted records without their clocks, and the final snapshot."""
    registry = metrics_mod.Registry()
    events = events_mod.EventStream(router_mod.EVENT_SOURCE,
                                    registry=registry)
    router = router_mod.ReplicaRouter(events=events, registry=registry,
                                      eject_after=2, readmit_after=2)
    served = []

    def transport_for(rid):
        def transport(payload):
            served.append(rid)
            toks = payload["tokens"][0]
            return {"tokens": [sim.expected_output(
                toks, payload["max_new_tokens"])]}
        return transport

    for i in range(3):
        router.register(router_mod.ReplicaHandle(
            f"replica-{i}", transport_for(f"replica-{i}"),
            host=f"replica-{i}", capacity=4))
    prompts = [[7, 7, i] for i in range(6)] + [[i, i + 1] for i in range(6)]
    for p in prompts:
        router.submit({"tokens": [p], "max_new_tokens": 2})
    for _ in range(2):
        router.observe_probe("replica-1", ok=False)
    for p in prompts:
        router.submit({"tokens": [p], "max_new_tokens": 2})
    for _ in range(2):
        router.observe_probe("replica-1", ok=True,
                             info={"status": "ok", "queue_depth": 0,
                                   "occupied_slots": 0, "max_slots": 4})
    for p in prompts[:4]:
        router.submit({"tokens": [p], "max_new_tokens": 2})
    holders = [router.prefix_holder(p) for p in prompts]
    records = [{k: v for k, v in r.items() if k not in ("ts", "latency_s")}
               for r in events.events()]
    snap = [{k: v for k, v in s.items() if "latency" not in k}
            for s in router.snapshot()]
    return served, records, holders, snap


def test_router_copy_routes_a_script_as_jax_s_does():
    port = _scripted_router(trouter, tevents, tmetrics)
    ref = _scripted_router(jrouter, jevents, jmetrics)
    assert port == ref
    kinds = {r["kind"] for r in port[1]}
    assert {"replica_ejected", "replica_readmitted"} <= kinds


def _scripted_autoscaler(auto_mod, events_mod, metrics_mod):
    clock = [0.0]
    registry = metrics_mod.Registry()
    events = events_mod.EventStream(auto_mod.EVENT_SOURCE,
                                    registry=registry)
    scaler = auto_mod.Autoscaler(
        events=events, registry=registry, min_replicas=1, max_replicas=3,
        scale_out_cooldown_s=5.0, scale_in_cooldown_s=5.0,
        idle_for_s=10.0, clock=lambda: clock[0], replicas=1)
    script = [
        (0.0, {"kind": "request_retired"}),
        (1.0, {"kind": "alert_fired", "rule": "burn"}),
        (2.0, None),
        (3.0, {"kind": "replica_ejected", "replica": "r0",
               "reason": "probe_failed"}),
        (8.0, None),
        (9.0, {"kind": "alert_resolved", "rule": "burn"}),
        (9.5, {"kind": "replica_readmitted", "replica": "r0"}),
        (10.0, {"kind": "request_retired"}),
        (15.0, None), (21.0, None), (27.0, None), (40.0, None),
    ]
    actions = []
    for t, rec in script:
        clock[0] = t
        if rec is not None:
            actions.append(scaler.handle_event(rec))
        actions.append(scaler.tick())
    records = [{k: v for k, v in r.items() if k != "ts"}
               for r in events.events()]
    return actions, records, scaler.replica_count()


def test_autoscaler_copy_decides_a_script_as_jax_s_does():
    port = _scripted_autoscaler(tauto, tevents, tmetrics)
    ref = _scripted_autoscaler(jauto, jevents, jmetrics)
    assert port == ref
    kinds = [r["kind"] for r in port[1]]
    assert "scale_out" in kinds and "scale_in" in kinds


# -- the lifecycle copy against the conformant kube API -------------------------


@pytest.fixture()
def cluster():
    """JAX's conformant fake kube API with four nodes of the sim's 2×2
    slice, and the port's REST client on it."""
    from container_engine_accelerators_tpu.testing import kubeapi
    from container_engine_accelerators_tpu_torch.scheduler.k8s import (
        KubeClient,
    )

    server = kubeapi.KubeApiServer().start()
    try:
        kube = KubeClient(base_url=server.url, token=None, ca_cert=False)
        for i in range(4):
            raw = sim._raw_node(f"n{i}", (i // 2, i % 2))
            raw.update({"apiVersion": "v1", "kind": "Node"})
            server.apply(raw)
        yield server, kube
    finally:
        server.stop()


def _lifecycle(kube, backend=None):
    from container_engine_accelerators_tpu_torch.fleet import (
        lifecycle as tlife,
    )

    backend = backend or sim.SimBackend(chunk_sleep_s=0.0)
    events = tevents.EventStream(tlife.EVENT_SOURCE,
                                 registry=tmetrics.Registry())
    lc = tlife.ReplicaLifecycle(kube, backend,
                                placer=tlife.cluster_placer(kube),
                                events=events)
    return lc, backend, events


def test_lifecycle_launches_bound_pods_of_the_port_s_server(cluster):
    """The port's lifecycle, cluster placer (``scheduler/incremental.py``
    over the port's gang placement) and REST client: a launch creates a
    gated pod running the port's serve_cli, binds it to a free node, and
    its replica serves; launches fill the four nodes and then find no
    sub-mesh."""
    from container_engine_accelerators_tpu_torch.fleet import (
        lifecycle as tlife,
    )

    _, kube = cluster
    lc, _, events = _lifecycle(kube)
    handle = lc.launch("rep-a")
    (pod,) = kube.list_pods(label_selector=tlife.FLEET_REPLICA_LABEL)
    assert pod["spec"]["schedulingGates"] == []
    assert pod["spec"]["nodeSelector"]["kubernetes.io/hostname"] == \
        handle.node
    assert "container_engine_accelerators_tpu_torch.models.serve_cli" in \
        pod["spec"]["containers"][0]["command"]
    out = handle.transport({"tokens": [[1, 2, 3]], "max_new_tokens": 4})
    assert out["tokens"][0] == sim.expected_output([1, 2, 3], 4)
    handles = [handle] + [lc.launch(f"rep-{i}") for i in range(3)]
    assert len({h.node for h in handles}) == 4
    assert lc.launch("rep-overflow") is None
    lc.terminate(handles[0])
    assert "rep-a" not in lc.labeled_pods()
    kinds = [e["kind"] for e in events.events()]
    assert {"replica_launched", "replica_terminated"} <= set(kinds)


def test_lifecycle_reconcile_adopts_survivors_and_sweeps_orphans(cluster):
    _, kube = cluster
    backend = sim.SimBackend(chunk_sleep_s=0.0)
    lc, _, _ = _lifecycle(kube, backend)
    lc.launch("rep-live")
    lc.launch("rep-dead")
    backend.stop("rep-dead")
    lc2, _, _ = _lifecycle(kube, backend)
    assert lc2.reconcile() == {"adopted": ["rep-live"],
                               "orphaned": ["rep-dead"]}
    assert set(lc2.labeled_pods()) == {"rep-live"}
    assert lc2.reconcile() == {"adopted": [], "orphaned": []}
