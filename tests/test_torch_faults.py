# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's copies of the fault plan, the event stream, the metrics
registry, the port map and the serving drainer against the JAX
package's modules (stdlib only, no tolerance: every result is exact).

  * ``faults/plan.py``: the same ``FaultSpec`` list fires at the same
    hook hits with the same exception kinds and messages, stragglers
    sleep the same delays, ``from_json`` reads the same file, and each
    package's armed plan is its own;
  * ``obs/events.py``: the same emits give the same records (on a fixed
    clock and host), the same ring, the same JSONL lines and the same
    ``follow_jsonl`` reads;
  * ``obs/metrics.py``: the same operations on counters, gauges and
    histograms render the same exposition text;
  * ``obs/ports.py``: the same assignments and conflict message;
  * ``faults/reactor.ServingDrainer``: the same records drain an engine
    with the same reasons.
"""

import json

import numpy as np
import pytest

from container_engine_accelerators_tpu import faults as jfaults
from container_engine_accelerators_tpu.faults import reactor as jreactor
from container_engine_accelerators_tpu.kubeletapi import HEALTHY, UNHEALTHY
from container_engine_accelerators_tpu.obs import events as jevents
from container_engine_accelerators_tpu.obs import metrics as jmetrics
from container_engine_accelerators_tpu.obs import ports as jports
from container_engine_accelerators_tpu_torch import faults as tfaults
from container_engine_accelerators_tpu_torch.faults import (
    reactor as treactor,
)
from container_engine_accelerators_tpu_torch.obs import events as tevents
from container_engine_accelerators_tpu_torch.obs import metrics as tmetrics
from container_engine_accelerators_tpu_torch.obs import ports as tports

SITES = ("serving.prefill", "serving.chunk", "serving.verify", "train.step")

PLANS = {
    "one_timeout": [
        {"kind": "collective_timeout", "site": "serving.prefill",
         "at": 1, "count": 1},
    ],
    "overlapping": [
        {"kind": "collective_timeout", "site": "serving.chunk", "at": 0,
         "count": 3},
        {"kind": "chip_wedge", "site": "serving.chunk", "at": 2,
         "count": 2},
        {"kind": "preemption", "site": "serving.verify", "at": 4},
    ],
    "straggler_then_fault": [
        {"kind": "straggler", "site": "serving.prefill", "at": 0,
         "count": 2, "delay_s": 0.25},
        {"kind": "host_vanish", "site": "serving.prefill", "at": 1,
         "node": "n1"},
        {"kind": "drop", "site": "train.step", "at": 3},
    ],
}


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.disarm()
    tfaults.disarm()
    yield
    jfaults.disarm()
    tfaults.disarm()


def _fire_log(faults_mod, specs, hits, seed):
    """Fire the sites of ``hits`` in order on a plan of ``specs``; the
    (site, index, kinds active, exception type and message, sleeps)
    of every hit."""
    sleeps = []
    plan = faults_mod.FaultPlan(specs, seed=seed, sleep=sleeps.append)
    log = []
    for site in hits:
        index = plan.site_index(site)
        before = len(sleeps)
        try:
            active = plan.fire(site, slot=3)
            exc = None
        except faults_mod.InjectedFault as e:
            active, exc = None, (type(e).__name__, e.kind, str(e))
        log.append((site, index,
                    None if active is None else [s.kind for s in active],
                    exc, sleeps[before:]))
    return log, plan


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plans_fire_alike(name):
    rng = np.random.default_rng(len(name))
    hits = [SITES[i] for i in rng.integers(0, len(SITES), 40)]
    want, jplan = _fire_log(jfaults, PLANS[name], hits, seed=7)
    got, tplan = _fire_log(tfaults, PLANS[name], hits, seed=7)
    assert got == want
    assert any(entry[3] is not None for entry in got)
    assert tplan.to_dict() == jplan.to_dict()
    strip = [{k: v for k, v in e.items() if k not in ("ts", "host")}
             for e in jplan.events.events()]
    assert [{k: v for k, v in e.items() if k not in ("ts", "host")}
            for e in tplan.events.events()] == strip


@pytest.mark.parametrize("spec,match", [
    ({"kind": "meteor", "site": "serving.chunk"}, "unknown fault kind"),
    ({"kind": "straggler", "site": "serving.chunk", "count": 0},
     "count must be >= 1"),
])
def test_fault_spec_validation_matches(spec, match):
    with pytest.raises(ValueError, match=match) as want:
        jfaults.FaultSpec(**spec)
    with pytest.raises(ValueError, match=match) as got:
        tfaults.FaultSpec(**spec)
    assert str(got.value) == str(want.value)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


def test_from_json_reads_the_same_plan(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 11,
                                "faults": PLANS["overlapping"]}))
    jplan = jfaults.FaultPlan.from_json(str(path))
    tplan = tfaults.FaultPlan.from_json(str(path))
    assert tplan.to_dict() == jplan.to_dict()
    assert tplan.seed == 11 and len(tplan.faults) == 3


def test_arm_from_flag_sinks_injections_to_the_event_log(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"faults": PLANS["one_timeout"]}))
    sink = tmp_path / "events.jsonl"
    plan = tfaults.arm_from_flag(str(path), sink_path=str(sink))
    assert tfaults.active() is plan and jfaults.active() is None
    tfaults.fire("serving.prefill")
    with pytest.raises(tfaults.CollectiveTimeoutFault):
        tfaults.fire("serving.prefill", slot=0)
    records = [json.loads(line) for line in sink.read_text().splitlines()]
    assert [(r["kind"], r["site"], r["hit"]) for r in records] == [
        ("fault_injected", "serving.prefill", 1)]
    assert plan.injections.labels("collective_timeout",
                                  "serving.prefill").value == 1.0


@pytest.mark.parametrize("armed", ["port", "jax"])
def test_each_package_arms_its_own_plan(armed):
    specs = [{"kind": "collective_timeout", "site": "serving.chunk"}]
    mine, other = (tfaults, jfaults) if armed == "port" else \
        (jfaults, tfaults)
    mine.arm(mine.FaultPlan(specs))
    assert other.active() is None
    assert other.fire("serving.chunk") == ()
    assert other.tick("serving.chunk") == ()
    with pytest.raises(mine.CollectiveTimeoutFault):
        mine.fire("serving.chunk")
    mine.disarm()
    assert mine.fire("serving.chunk") == ()


def _emit_all(events_mod, metrics_mod, sink):
    clock = iter(range(100, 200))
    reg = metrics_mod.Registry()
    stream = events_mod.EventStream("serve", sink_path=sink, ring=4,
                                    registry=reg, host="h0",
                                    clock=lambda: float(next(clock)))
    recs = [
        stream.emit("request_shed", severity="warning",
                    reason="queue_full", rows=3),
        stream.emit("step_retry", severity="warning", phase="prefill",
                    attempt=1, backoff_s=0.05),
        stream.emit("request_migrated", severity="warning", rid=7,
                    slot=1, reason="chip accel0 unhealthy", generated=5),
        stream.emit("migration_replayed", rid=7, slot=0, lost_s=0.25),
        stream.emit("tenant_shed", severity="warning", tenant_class="b",
                    reason="class_share", rows=2),
    ]
    with pytest.raises(ValueError, match="severity"):
        stream.emit("x", severity="fatal")
    stream.close()
    return recs, stream, reg


def test_event_streams_record_alike(tmp_path):
    jsink, tsink = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    want, jstream, jreg = _emit_all(jevents, jmetrics, str(jsink))
    got, tstream, treg = _emit_all(tevents, tmetrics, str(tsink))
    assert got == want
    assert tstream.events() == jstream.events()
    assert len(tstream.events()) == 4 and tstream.emitted == 5
    assert tstream.events("step_retry") == jstream.events("step_retry")
    assert tstream.tail(2) == jstream.tail(2)
    assert tsink.read_text() == jsink.read_text()
    assert treg.render() == jreg.render()
    assert tevents.host_identity({"HOSTNAME": "n", "TPU_WORKER_ID": "2"}) \
        == jevents.host_identity({"HOSTNAME": "n", "TPU_WORKER_ID": "2"})


def test_follow_jsonl_reads_alike(tmp_path):
    path = tmp_path / "log.jsonl"
    path.write_text('{"a": 1}\n{"a": 2}\nnot json\n{"a": 3}\n{"a": 4')

    def read(mod):
        stops = iter([False, True])
        return list(mod.follow_jsonl(str(path), stop=lambda: next(stops),
                                     sleep=lambda s: None))

    assert read(tevents) == read(jevents) == [{"a": 1}, {"a": 2},
                                              {"a": 3}]


def _exercise(metrics_mod):
    reg = metrics_mod.Registry()
    shed = metrics_mod.Counter("tpu_serving_requests_shed_total", "sheds",
                               ["reason"], registry=reg)
    retries = metrics_mod.Counter("tpu_serving_step_retries_total",
                                  "retries", registry=reg)
    wait = metrics_mod.Histogram("tpu_serving_queue_wait_seconds", "wait",
                                 buckets=(0.001, 0.01, 0.1, 1.0),
                                 registry=reg)
    depth = metrics_mod.Gauge("tpu_serving_engine_queue_depth", "depth",
                              registry=reg)
    live = metrics_mod.Gauge("tpu_live", "live", registry=reg)
    rng = np.random.default_rng(3)
    for reason in rng.choice(["queue_full", "deadline", "quota"], 20):
        shed.labels(str(reason)).inc()
    shed.labels(reason="class_share").inc(3)
    retries.inc()
    retries.inc(2)
    for v in rng.exponential(0.05, 50):
        wait.observe(float(v))
    wait.observe(float("nan"))
    depth.set(4)
    depth.dec()
    live.set_function(lambda: 2.5)
    with pytest.raises(ValueError, match="only go up"):
        retries.inc(-1)
    with pytest.raises(ValueError, match="already registered"):
        metrics_mod.Counter("tpu_serving_step_retries_total", "x",
                            registry=reg)
    again = metrics_mod.get_or_create(
        metrics_mod.Counter, "tpu_serving_step_retries_total", "x",
        registry=reg)
    assert again is retries
    return reg, wait


def test_metrics_render_the_same_exposition():
    jreg, jwait = _exercise(jmetrics)
    treg, twait = _exercise(tmetrics)
    assert treg.render() == jreg.render()
    assert (twait.count, twait.sum) == (jwait.count, jwait.sum)
    assert b"tpu_metrics_dropped_samples_total" in treg.render()


def test_port_map_matches():
    assert tports.KNOWN_PORTS == jports.KNOWN_PORTS
    assert tports.conflict_message(2116, "serve") == \
        jports.conflict_message(2116, "serve")
    assert tports.describe(1) == jports.describe(1)


class _DrainRecorder:
    def __init__(self):
        self.calls = []

    def drain(self, slots=None, reason="unhealthy"):
        self.calls.append((slots, reason))
        return 2


RECORDS = [
    {"kind": "health_transition", "to": UNHEALTHY, "tpu": "accel0"},
    {"kind": "health_transition", "to": HEALTHY, "tpu": "accel0"},
    {"event": "health_transition", "to": UNHEALTHY},
    {"kind": "request_shed", "to": UNHEALTHY},
]


def test_serving_drainer_reacts_alike():
    assert (treactor.HEALTHY, treactor.UNHEALTHY) == (HEALTHY, UNHEALTHY)
    want, got = _DrainRecorder(), _DrainRecorder()
    jdrain, tdrain = jreactor.ServingDrainer(want), \
        treactor.ServingDrainer(got)
    assert [tdrain.process(r) for r in RECORDS] == \
        [jdrain.process(r) for r in RECORDS] == [2, 0, 2, 0]
    assert got.calls == want.calls
    # poll() reads the stream's unread tail once.
    jstream = jevents.EventStream("deviceplugin.health", ring=2, host="h")
    tstream = tevents.EventStream("deviceplugin.health", ring=2, host="h")
    for stream in (jstream, tstream):
        for r in RECORDS[:3]:
            stream.emit(r.get("kind") or r["event"],
                        **{k: v for k, v in r.items()
                           if k not in ("kind", "event")})
    assert tdrain.poll(tstream) == jdrain.poll(jstream) == 2
    assert tdrain.poll(tstream) == jdrain.poll(jstream) == 0
