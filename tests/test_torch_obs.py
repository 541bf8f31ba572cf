# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's observability modules against the JAX package's (CPU).

``obs/trace.py``, ``obs/devicetime.py``, ``obs/flight.py`` and
``obs/alerts.py`` are copies: each test runs the same calls on the JAX
module and on the port's (parametrised over both) and holds both to the
same result, or runs them side by side and compares what they export.
``obs/hbm.py`` is adapted (item sizes from ``torch_dtype``): its figures
equal the port's tensors' bytes exactly and JAX's model on an engine of
the same shape. ``ServingSLO`` and the engine's ``stats()`` view are held
to JAX's on the tiny f32 model of ``tests/test_obs_serving.py``.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from container_engine_accelerators_tpu.fleet import tenants as jtenants  # noqa: E402
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.obs import alerts as jalerts  # noqa: E402
from container_engine_accelerators_tpu.obs import devicetime as jdevicetime  # noqa: E402
from container_engine_accelerators_tpu.obs import events as jevents  # noqa: E402
from container_engine_accelerators_tpu.obs import flight as jflight  # noqa: E402
from container_engine_accelerators_tpu.obs import hbm as jhbm  # noqa: E402
from container_engine_accelerators_tpu.obs import metrics as jmetrics  # noqa: E402
from container_engine_accelerators_tpu.obs import trace as jtrace  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import tenants as ttenants  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import alerts as talerts  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    devicetime as tdevicetime,
)
from container_engine_accelerators_tpu_torch.obs import events as tevents  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import flight as tflight  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import hbm as thbm  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import trace as ttrace  # noqa: E402

# The tiny f32 config of tests/test_obs_serving.py.
SHAPE = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
             n_kv_heads=1, d_ff=64, max_seq_len=64, dtype="float32")
# The JAX engine's stats() key set (tests/test_obs_serving.py's
# STATS_KEYS), and what a speculating port engine adds (ROADMAP Queue 3).
STATS_KEYS = {
    "steps_done", "n_prefills", "n_chunks", "occupied_slots",
    "queue_depth", "t_prefill_s", "t_chunk_s", "t_idle_s",
    "occupied_steps", "tenant_queues",
}
SPEC_KEYS = {"spec_proposed", "spec_accepted", "spec_verifies",
             "spec_acceptance"}

# (trace, devicetime, flight, alerts, events, metrics, tenants) per side.
SIDES = {
    "jax": dict(trace=jtrace, devicetime=jdevicetime, flight=jflight,
                alerts=jalerts, events=jevents, metrics=jmetrics,
                tenants=jtenants),
    "port": dict(trace=ttrace, devicetime=tdevicetime, flight=tflight,
                 alerts=talerts, events=tevents, metrics=tmetrics,
                 tenants=ttenants),
}
SIDE_NAMES = sorted(SIDES)


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    jtrace.configure(False)
    ttrace.configure(False)
    jflight.deactivate()
    tflight.deactivate()


@pytest.fixture(scope="module")
def models():
    """(JAX Model, port Model) on identical weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


class FakeClock:
    def __init__(self, start=100.0):
        self.now = start

    def __call__(self):
        return self.now


# -- trace ---------------------------------------------------------------------

def _record_spans(mod):
    """The same spans on ``mod``'s tracer: nested live spans on this
    thread, explicit events on a synthetic request track, a traceparent
    round trip. Returns the tracer."""
    tracer = mod.configure()
    with mod.span("outer", rows=2):
        with mod.span("inner", step=1) as sp:
            sp.set(extra="x")
    t = mod.now()
    mod.event("queue", t, 0.25, track="req-1", trace_id="ab" * 16)
    mod.event("prefill", t + 0.25, 0.5, track="req-1", tokens=7)
    mod.event("request", t, 1.0, track="req-1", rid=1)
    return tracer


def _strip_times(chrome):
    out = []
    for ev in chrome["traceEvents"]:
        ev = {k: v for k, v in ev.items()
              if k not in ("ts", "dur", "pid", "tid")}
        ev["args"] = {k: v for k, v in ev.get("args", {}).items()
                      if k not in ("host", "epoch_ns")}
        out.append(ev)
    return out


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_trace_records_nested_spans_and_request_tracks(side):
    mod = SIDES[side]["trace"]
    tracer = _record_spans(mod)
    evs = {e["name"]: e for e in tracer.events()}
    assert set(evs) == {"outer", "inner", "queue", "prefill", "request"}
    assert evs["inner"]["parent"] == "outer"
    assert evs["inner"]["args"] == {"step": 1, "extra": "x"}
    req = evs["request"]
    for name in ("queue", "prefill"):
        assert evs[name]["tid"] == req["tid"] < 0  # synthetic track
        assert req["ts"] <= evs[name]["ts"]
        assert evs[name]["ts"] + evs[name]["dur"] <= \
            req["ts"] + req["dur"] + 1e-9
    assert evs["outer"]["tid"] != req["tid"]


def test_trace_exports_equal_jax_minus_timestamps(tmp_path):
    docs = {}
    for side in SIDE_NAMES:
        tracer = _record_spans(SIDES[side]["trace"])
        path = tmp_path / f"{side}.json"
        tracer.write_chrome(str(path))
        tracer.write_jsonl(str(path) + ".jsonl")
        lines = [json.loads(ln) for ln in
                 (tmp_path / f"{side}.json.jsonl").read_text().splitlines()]
        docs[side] = (
            _strip_times(json.loads(path.read_text())),
            [{k: v for k, v in ln.items()
              if k not in ("start_s", "dur_s", "host", "pid", "epoch_ns")}
             for ln in lines],
        )
    assert docs["port"] == docs["jax"]
    assert docs["port"][1][0]["name"] == ttrace.JSONL_META_NAME


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_traceparent_round_trip_and_rejects(side):
    mod = SIDES[side]["trace"]
    tid, sid = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    header = mod.format_traceparent(tid, sid, sampled=True)
    assert header == f"00-{tid}-{sid}-01"
    assert mod.parse_traceparent(header) == (tid, sid, True)
    assert mod.parse_traceparent(f"00-{tid}-{sid}-00")[2] is False
    for bad in ("", "garbage", f"00-{'0' * 32}-{sid}-01",
                f"00-{tid}-{sid}"):
        assert mod.parse_traceparent(bad) is None


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_trace_is_a_no_op_when_off(side):
    mod = SIDES[side]["trace"]
    mod.configure(False)
    assert not mod.enabled() and mod.get() is None
    with mod.span("x") as sp:
        sp.set(a=1)
    assert mod.event("x", 0.0, 1.0) is None
    t = time.perf_counter()
    assert abs(mod.now() - t) < 1.0  # perf_counter seconds, not tracer


# -- devicetime ----------------------------------------------------------------

def _ledger(side, **kw):
    mod = SIDES[side]
    reg = mod["metrics"].Registry()
    return mod["devicetime"].DeviceTimeLedger(registry=reg, **kw), reg


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_devicetime_attribution_sums_exactly(side):
    led, reg = _ledger(side)
    rows = [{"tenant": "a"}, {"tenant": "b"}, {}]
    wall = 0.123456789
    led.attribute("decode", wall, [(rows[0], 7), (rows[1], 3),
                                   (rows[2], 1)])
    # One call's slices sum to its wall exactly (the last row takes the
    # remainder).
    assert rows[0]["device_s"] + rows[1]["device_s"] + \
        rows[2]["device_s"] == wall
    led.attribute("verify", 0.3, [(rows[0], 0), (rows[1], 0)])
    led.attribute("chunk", 0.05, [])
    assert rows[0]["device_by_phase"]["verify"] + \
        rows[1]["device_by_phase"]["verify"] == 0.3
    assert led.total_device_s == pytest.approx(wall + 0.35, abs=1e-15)
    snap = led.snapshot()
    assert set(snap["per_phase_class"]) == {
        "decode/a", "decode/b", "decode/default", "verify/a", "verify/b",
        "chunk/unattributed"}
    assert rows[0]["device_by_phase"]["verify"] == 0.15
    series = reg.get("tpu_serving_device_seconds_total")._series()
    assert abs(sum(c.value for _, c in series) - led.total_device_s) < 1e-12


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_devicetime_bubble_chain(side):
    clock = FakeClock()
    led, _ = _ledger(side, clock=clock)
    led.note_dispatch(10.0)                      # first: no bubble
    led.attribute("decode", 1.0, [({}, 1)])
    led.note_dispatch_end(11.0)
    led.note_dispatch(11.5)                      # 0.5 s bubble
    led.attribute("decode", 1.0, [({}, 1)])
    led.note_dispatch_end(12.5)
    led.note_idle()                              # idle breaks the chain
    led.note_dispatch(20.0)
    assert led.total_bubble_s == 0.5
    assert led.bubble_ratio() == 0.5 / 2.5
    led.note_dispatch_end(21.0)
    led.note_dispatch(20.5)                      # negative gap: none
    assert led.total_bubble_s == 0.5


def test_devicetime_exposition_equals_jax():
    texts = {}
    for side in SIDE_NAMES:
        mod = SIDES[side]
        classes = mod["tenants"].TenantClasses.from_dict({
            "gold": {"queue_share": 0.75}, "bulk": {"queue_share": 0.25}})
        led, reg = _ledger(side, tenants=classes, clock=FakeClock())
        led.note_dispatch(1.0)
        led.attribute("prefill", 0.2, [({"tenant": "gold"}, 10)])
        led.note_dispatch_end(1.2)
        led.note_dispatch(1.3)
        led.attribute("decode", 0.4, [({"tenant": "gold"}, 4),
                                      ({"tenant": "bulk"}, 4)])
        led.note_dispatch_end(1.7)
        texts[side] = (reg.render().decode(), led.snapshot())
    assert texts["port"] == texts["jax"]
    assert "tpu_tenant_device_share_ratio" in texts["port"][0]


# -- flight --------------------------------------------------------------------

def _flight_bundle(side, dirpath):
    """One registry, one event stream and a tracer under a recorder with
    an injected clock; two snapshots and an on-demand dump. Returns the
    bundle's records."""
    mod = SIDES[side]
    reg = mod["metrics"].Registry()
    c = mod["metrics"].Counter("tpu_unit_total", "u", ["k"], registry=reg)
    h = mod["metrics"].Histogram("tpu_unit_seconds", "u", buckets=(0.1, 1),
                                 registry=reg)
    stream = mod["events"].EventStream("serve", registry=reg, host="unit")
    tracer = mod["trace"].configure()
    clock = FakeClock()
    rec = mod["flight"].FlightRecorder(
        str(dirpath), window_s=2.0, interval_s=0.25, clock=clock,
        wall_clock=lambda: 5.0, host="unit")
    rec.watch_registry("engine", reg).watch_events(stream)
    rec.watch_tracer(tracer)
    rec.add_state_provider("stats", lambda: {"queue_depth": 3})
    rec.snapshot()
    c.labels("a").inc(2)
    h.observe(0.5)
    stream.emit("request_retired", rid=7)
    mod["trace"].event("request", 0.0, 1.0, track="req-7")
    clock.now += 0.25
    path = rec.trigger("on_demand")
    assert path is not None and path.startswith(str(dirpath))
    assert rec.trigger("on_demand") is None  # deduped
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_flight_bundle_holds_deltas_events_spans_and_state(side, tmp_path):
    records = _flight_bundle(side, tmp_path)
    meta, trig, *snaps = records
    assert meta["record"] == "meta" and meta["registries"] == ["engine"]
    assert trig == {"record": "trigger", "kind": "on_demand", "ts": 100.25,
                    "wall_ts": 5.0}
    last = snaps[-1]
    assert last["counters"] == {
        "tpu_unit_total{k=a}": 2.0,
        "tpu_obs_events_total{source=serve,kind=request_retired,"
        "severity=info}": 1.0}
    assert last["histograms"]["tpu_unit_seconds"]["count"] == 1
    assert [e["kind"] for e in last["events"]] == ["request_retired"]
    assert [s["name"] for s in last["spans"]] == ["request"]
    assert last["state"] == {"stats": {"queue_depth": 3}}


def test_flight_bundle_equals_jax_minus_timestamps(tmp_path):
    def strip(records):
        out = []
        for r in records:
            r = dict(r)
            for e in r.get("events", ()):
                e.pop("ts", None)
            for s in r.get("spans", ()):
                s.pop("tid", None)
            r.pop("wall_ts", None)
            out.append(r)
        return out

    got = {side: strip(_flight_bundle(side, tmp_path / side))
           for side in SIDE_NAMES}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_flight_disarmed_is_zero_cost(side):
    mod = SIDES[side]["flight"]
    assert mod.wire_from_flags(False, "/nonexistent") is None
    assert mod.get() is None and mod.trigger("x") is None
    assert mod.last_bundle() is None


# -- alerts --------------------------------------------------------------------

def _burn(side):
    """Sustained 50 % bad requests against a 10 % budget, then clean
    traffic: the rule's transitions and the alert instruments."""
    mod = SIDES[side]
    reg = mod["metrics"].Registry()
    c = mod["metrics"].Counter("tpu_serving_slo_requests_total", "d",
                               ["outcome", "tenant_class"], registry=reg)
    stream = mod["events"].EventStream("alerts", registry=reg, host="unit")
    rule = mod["alerts"].AlertRule.from_dict({
        "name": "slo-burn", "kind": "burn_rate",
        "bad_metric": "tpu_serving_slo_requests_total",
        "bad_labels": {"outcome": ["shed", "slow_ttft", "slow_tpot"]},
        "total_metric": "tpu_serving_slo_requests_total",
        "objective": 0.9, "windows": [[10.0, 1.0], [2.0, 1.0]],
        "severity": "error",
    })
    clock = [0.0]
    ev = mod["alerts"].AlertEvaluator([reg], [rule], events=stream,
                                      clock=lambda: clock[0], registry=reg)
    transitions = []
    for i in range(20):
        clock[0] += 1.0
        if i < 6:
            c.labels("good", "default").inc(5)
            c.labels("shed", "default").inc(5)
        else:
            c.labels("good", "default").inc(10)
        transitions += [(clock[0], t) for t in ev.tick()]
    text = "\n".join(ln for ln in reg.render().decode().splitlines()
                     if ln.startswith("tpu_alerts"))
    kinds = [e["kind"] for e in stream.events()]
    return transitions, text, kinds


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_alert_burn_rule_fires_and_resolves(side):
    transitions, text, kinds = _burn(side)
    assert [t for _, t in transitions] == [("fired", "slo-burn"),
                                           ("resolved", "slo-burn")]
    assert kinds == ["alert_fired", "alert_resolved"]
    assert 'tpu_alerts_fired_total{rule="slo-burn"} 1.0' in text


def test_alerts_equal_jax():
    assert _burn("port") == _burn("jax")


@pytest.mark.parametrize("side", SIDE_NAMES)
def test_alerts_unconfigured_create_nothing(side):
    assert SIDES[side]["alerts"].wire_from_flags([], "") is None


# -- HBM model -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_bytes_equal_the_port_parameters(dtype):
    cfg = ttf.TransformerConfig(**{**SHAPE, "n_layers": 2, "dtype": dtype})
    model = ttf.Transformer(cfg, "cpu")
    params = list(model.parameters())
    assert thbm.weights_bytes(cfg) == sum(
        p.numel() * p.element_size() for p in params)
    assert thbm.weights_params(cfg) == sum(p.numel() for p in params)
    jcfg = jtf.TransformerConfig(**{**SHAPE, "n_layers": 2, "dtype": dtype})
    assert thbm.weights_bytes(cfg) == jhbm.weights_bytes(jcfg)
    assert thbm.scratch_bytes(cfg, 4, 16) == jhbm.scratch_bytes(jcfg, 4, 16)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_kv_pool_equals_the_cache_nbytes(models, kv):
    extra = dict(kv_cache="paged", kv_block_size=4) if kv == "paged" else {}
    eng = tserve.ContinuousEngine(models[1], max_slots=2, chunk=4,
                                  start_loop=False, **extra)
    model = thbm.HbmModel(eng)
    # The pools hold every block, the null block included.
    assert model.kv_pool == sum(t.nbytes for t in eng.cache.values())
    if kv == "paged":
        assert eng.cache["k"].shape[1] == eng.kv.num_blocks


def _hbm_lines(registry):
    return [ln for ln in registry.render().decode().splitlines()
            if ln.startswith("tpu_hbm")]


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_hbm_gauges_equal_jax(models, kv):
    extra = dict(kv_cache="paged", kv_block_size=4) if kv == "paged" else {}
    jeng = jserve.ContinuousEngine(models[0], max_slots=2, chunk=4,
                                   prefill_chunk=16, start_loop=False,
                                   **extra)
    teng = tserve.ContinuousEngine(models[1], max_slots=2, chunk=4,
                                   prefill_chunk=16, start_loop=False,
                                   **extra)
    jeng.hbm = jhbm.HbmModel(jeng)
    teng.hbm = thbm.HbmModel(teng)
    assert _hbm_lines(teng.registry) == _hbm_lines(jeng.registry)
    assert any('component="weights"' in ln for ln in
               _hbm_lines(teng.registry))
    if kv == "paged":
        # Live reads follow the pool: two blocks held by slot 0.
        for eng in (jeng, teng):
            eng.kv.admit(0, list(range(1, 8)))
            eng.kv.ensure_blocks(0, 8)
        assert _hbm_lines(teng.registry) == _hbm_lines(jeng.registry)
        assert teng.hbm.kv_used_blocks() == 2


# -- ServingSLO ----------------------------------------------------------------

SLO_SEQUENCES = {
    "ttft_and_tpot": [(0.05, 0.01, "default", None), (0.3, 0.01, "a", None),
                      (0.05, 0.2, "a", None), (0.05, None, "b", None),
                      (None, None, "a", "queue_full")],
    "sheds_only": [(None, None, "default", "deadline")] * 3,
    "all_good": [(0.01, 0.001, None, None)] * 4,
}


@pytest.mark.parametrize("seq", sorted(SLO_SEQUENCES))
def test_serving_slo_matches_jax(seq):
    out = {}
    for name, mod in (("jax", jserve), ("port", tserve)):
        slo = mod.ServingSLO(ttft_s=0.2, tpot_s=0.1)
        outcomes = []
        for ttft, tpot, tenant, shed in SLO_SEQUENCES[seq]:
            if shed is not None:
                outcomes.append(slo.record_shed(shed, tenant))
            else:
                outcomes.append(slo.classify_retired(ttft, tpot, tenant))
        out[name] = (outcomes, slo.goodput_ratio(),
                     slo.registry.render().decode())
    assert out["port"] == out["jax"]


def test_serving_slo_goodput_starts_at_one():
    assert tserve.ServingSLO(ttft_s=0.1).goodput_ratio() == 1.0


# -- stats() -------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_stats_key_set_is_jax_s(models, kv):
    extra = dict(kv_cache="paged", kv_block_size=4) if kv == "paged" else {}
    jeng = jserve.ContinuousEngine(models[0], max_slots=2, chunk=4,
                                   start_loop=False, **extra)
    teng = tserve.ContinuousEngine(models[1], max_slots=2, chunk=4,
                                   start_loop=False, **extra)
    s = teng.stats()
    assert set(s) == set(jeng.stats()) == STATS_KEYS
    for k in ("steps_done", "n_prefills", "n_chunks", "occupied_slots",
              "queue_depth", "occupied_steps"):
        assert isinstance(s[k], int), k
    for k in ("t_prefill_s", "t_chunk_s", "t_idle_s"):
        assert isinstance(s[k], float), k
    spec = tserve.ContinuousEngine(models[1], max_slots=2, chunk=4,
                                   start_loop=False, kv_cache="paged",
                                   kv_block_size=4, speculate="ngram")
    assert set(spec.stats()) == STATS_KEYS | SPEC_KEYS


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_stats_is_a_view_over_the_registry(models, kv):
    extra = dict(kv_cache="paged", kv_block_size=4) if kv == "paged" else {}
    eng = tserve.ContinuousEngine(models[1], max_slots=2, chunk=4, **extra)
    try:
        out = eng.generate([[1, 2, 3]], 6)
        assert len(out[0]) == 9
        s = eng.stats()
    finally:
        eng.shutdown()
    assert s["n_prefills"] >= 1 and s["steps_done"] >= 5
    assert s["t_prefill_s"] > 0 and s["t_chunk_s"] > 0
    text = eng.registry.render().decode()
    for key, family in (("n_prefills", "prefills"), ("steps_done", "steps"),
                        ("n_chunks", "chunks"),
                        ("occupied_steps", "occupied_steps")):
        assert (f"tpu_serving_engine_{family}_total "
                f"{float(s[key])}") in text, key
    assert f"tpu_serving_engine_chunk_seconds_total {s['t_chunk_s']!r}" \
        in text
    assert eng._m_t_prefill.value == s["t_prefill_s"] == pytest.approx(
        eng.t_prefill_dispatch_s + eng.t_prefill_wait_s)
