# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's serving observability against the JAX server's (CPU, f32).

One scripted scenario (4 greedy requests over HTTP, one prefilled in
segments, one of a single token) runs through JAX's ``ContinuousEngine``
and the port's, dense and paged (JAX's paged seams made synchronous, see
ROADMAP Housekeeping), with every obs surface armed: the SLO, the
device-time ledger, the HBM model, the event stream and both tracers.
The two must render the same ``/metrics`` families with the same label
names, count the same requests, tokens, prefills, chunks and steps, the
same TTFT and TPOT observations, emit ``request_retired`` records with
the same keys, the same span names per request, and book the ledger
under the same (phase, tenant class) labels. Then the HTTP and CLI
surface: ``GET /metrics``, ``--metrics-port``, ``POST /debug/flight``,
``--trace-out``, ``--profile-dir``, the flags' defaults, and nothing
registered with every flag off.

``SERVING_FAMILIES`` pins the ``tpu_serving_*`` families the JAX server
renders with ``--chip-accounting --slo-ttft-ms --slo-tpot-ms`` for each
engine mode; ``chip_smoke.py``'s serve_obs phase reads it from here (it
parses this file: it imports nothing of JAX).
"""

import argparse
import functools
import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.obs import devicetime as jdevicetime  # noqa: E402
from container_engine_accelerators_tpu.obs import events as jevents  # noqa: E402
from container_engine_accelerators_tpu.obs import hbm as jhbm  # noqa: E402
from container_engine_accelerators_tpu.obs import metrics as jmetrics  # noqa: E402
from container_engine_accelerators_tpu.obs import trace as jtrace  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    devicetime as tdevicetime,
)
from container_engine_accelerators_tpu_torch.obs import events as tevents  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import flight as tflight  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import hbm as thbm  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import trace as ttrace  # noqa: E402
from container_engine_accelerators_tpu_torch.utils import profiling  # noqa: E402

# The tiny f32 config of tests/test_obs_serving.py.
SHAPE = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
             n_kv_heads=1, d_ff=64, max_seq_len=64, dtype="float32")
TINY_FLAGS = ["--seq-len", "64", "--d-model", "32", "--n-layers", "1",
              "--n-heads", "2", "--vocab-size", "64", "--dtype", "float32"]
ENGINES = {
    "dense": dict(max_slots=2, chunk=4, prefill_chunk=16),
    "paged": dict(max_slots=2, chunk=4, prefill_chunk=16, kv_cache="paged",
                  kv_block_size=4),
    "paged_ngram": dict(max_slots=2, chunk=4, prefill_chunk=16,
                        kv_cache="paged", kv_block_size=4,
                        speculate="ngram"),
}
# (prompt, max_new): the third prefills in two segments of 16, the last
# is a one-token request (no TPOT, no decode span).
SCENARIO = [
    ([5, 6, 7], 6),
    ([1, 2, 3, 1, 2, 3, 1, 2], 8),
    (list(range(3, 23)), 5),
    ([9, 4], 1),
]
SLO = dict(ttft_s=0.2, tpot_s=0.05)
TIMEOUT_S = 120

# The tpu_serving_* families the JAX server renders (ServingMetrics and
# the engine's registry) under --continuous-batching --chip-accounting
# --slo-ttft-ms --slo-tpot-ms --event-log, per engine mode; pinned to
# the JAX server by test_serving_families_are_the_jax_server_s.
_COMMON = [
    "tpu_serving_device_bubble_ratio",
    "tpu_serving_device_bubble_seconds_total",
    "tpu_serving_device_seconds_total",
    "tpu_serving_engine_batch_size",
    "tpu_serving_engine_chunk_seconds_total",
    "tpu_serving_engine_chunks_total",
    "tpu_serving_engine_idle_seconds_total",
    "tpu_serving_engine_occupied_slots",
    "tpu_serving_engine_occupied_steps_total",
    "tpu_serving_engine_prefill_seconds_total",
    "tpu_serving_engine_prefills_total",
    "tpu_serving_engine_queue_depth",
    "tpu_serving_engine_steps_total",
    "tpu_serving_generated_tokens_total",
    "tpu_serving_queue_wait_seconds",
    "tpu_serving_request_latency_seconds",
    "tpu_serving_requests_migrated_total",
    "tpu_serving_requests_shed_total",
    "tpu_serving_requests_total",
    "tpu_serving_slo_goodput_ratio",
    "tpu_serving_slo_requests_total",
    "tpu_serving_step_retries_total",
    "tpu_serving_tpot_seconds",
    "tpu_serving_ttft_seconds",
]
_PAGED = [
    "tpu_serving_kv_blocks_cached",
    "tpu_serving_kv_blocks_free",
    "tpu_serving_kv_cow_copies_total",
    "tpu_serving_prefix_cache_hit_tokens_total",
    "tpu_serving_prefix_cache_miss_tokens_total",
]
_SPEC = [
    "tpu_serving_engine_verify_seconds_total",
    "tpu_serving_spec_acceptance_ratio",
    "tpu_serving_spec_accepted_tokens_total",
    "tpu_serving_spec_proposed_tokens_total",
    "tpu_serving_spec_verify_steps_total",
]
SERVING_FAMILIES = {
    "dense": sorted(_COMMON),
    "paged": sorted(_COMMON + _PAGED),
    "paged_ngram": sorted(_COMMON + _PAGED + _SPEC),
}


@pytest.fixture(autouse=True)
def _obs_off():
    yield
    jtrace.configure(False)
    ttrace.configure(False)
    tflight.deactivate()


@pytest.fixture(scope="module")
def models():
    """(JAX Model, port Model) on identical weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


def families(text):
    """{(family, label names)} of a Prometheus text exposition (a
    histogram's ``le`` left out)."""
    kinds = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, labels = line.split(" ")[0].partition("{")
        if name not in kinds:
            name = re.sub(r"_(bucket|sum|count)$", "", name)
        names = frozenset(re.findall(r'(\w+)="', labels)) - {"le"}
        out.add((name, names))
    return out | {(name, None) for name in kinds}


def family_names(text):
    return sorted({f for f, labels in families(text) if labels is None})


def _sample(text, series):
    """The value of one sample line ``series value`` in ``text``."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split(" ")[-1])
    raise AssertionError(f"{series} not in the exposition")


def _post(port, body, headers=None, path="/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path="/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT_S) as resp:
        return resp.read().decode()


def _wait_for(cond, what):
    deadline = time.monotonic() + TIMEOUT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _synchronous(fn):
    return lambda *args, **kwargs: jax.block_until_ready(fn(*args, **kwargs))


def _build(side, models, mode):
    """An engine of ``mode`` on ``side`` with every obs surface armed,
    its loop not started, behind an HTTP server on a free port. Returns
    (engine, metrics, server, start_loop)."""
    mods = {
        "jax": (jserve, jmetrics, jevents, jdevicetime, jhbm, jtrace),
        "port": (tserve, tmetrics, tevents, tdevicetime, thbm, ttrace),
    }[side]
    serve, metrics_mod, events_mod, devicetime_mod, hbm_mod, trace_mod = mods
    trace_mod.configure()
    reg = metrics_mod.Registry()
    eng = serve.ContinuousEngine(
        models[0 if side == "jax" else 1], start_loop=False, registry=reg,
        events=events_mod.EventStream("serve", registry=reg, host="unit"),
        slo=serve.ServingSLO(registry=reg, **SLO),
        devicetime=devicetime_mod.DeviceTimeLedger(registry=reg),
        **ENGINES[mode])
    eng.hbm = hbm_mod.HbmModel(eng)
    if side == "jax" and mode != "dense":
        # JAX's paged loop advances host arrays right after an
        # asynchronous dispatch; on the CPU backend a call may read the
        # advanced values. Its device calls are made synchronous here.
        seams = ["_paged_prefill", "_paged_chunk", "_copy_blocks"]
        if mode == "paged_ngram":
            seams.append("_paged_verify")
        for seam in seams:
            setattr(eng, seam, _synchronous(getattr(eng, seam)))
    metrics = serve.ServingMetrics(eng)
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0), serve.make_handler(eng, {"ready": True}, metrics))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    loop = eng._loop if eng.kv is None else eng._loop_paged

    def start_loop():
        thread = threading.Thread(target=loop, daemon=True)
        if side == "port":
            eng._thread = thread  # shutdown() stops it
        thread.start()

    return eng, metrics, server, start_loop


def _run_scenario(side, models, mode):
    """The scenario through ``side``'s engine over HTTP: every request
    queued (in order) before the loop starts. Returns what the two
    engines are held to."""
    eng, metrics, server, start_loop = _build(side, models, mode)
    port = server.server_address[1]
    trace_mod = jtrace if side == "jax" else ttrace
    out = [None] * len(SCENARIO)
    threads = []
    try:
        for i, (prompt, max_new) in enumerate(SCENARIO):
            def post(i=i, prompt=prompt, max_new=max_new):
                out[i] = _post(port, {"tokens": [prompt],
                                      "max_new_tokens": max_new})
            threads.append(threading.Thread(target=post, daemon=True))
            threads[-1].start()
            _wait_for(lambda n=i + 1: eng._q.qsize() == n, "the enqueue")
        start_loop()
        for t in threads:
            t.join(TIMEOUT_S)
            assert not t.is_alive()
        text = _get(port)
    finally:
        server.shutdown()
        server.server_close()
    assert [code for code, _ in out] == [200] * len(SCENARIO)
    tracks = {}
    for ev in trace_mod.get().events():
        if ev["thread"].startswith("req-"):
            tracks.setdefault(int(ev["thread"][4:]), []).append(ev["name"])
    retired = eng.events.events(kind="request_retired")
    got = {
        "families": families(text),
        "counts": {
            name: _sample(text, name) for name in (
                'tpu_serving_requests_total{outcome="ok"}',
                "tpu_serving_generated_tokens_total",
                "tpu_serving_engine_prefills_total",
                "tpu_serving_engine_chunks_total",
                "tpu_serving_engine_steps_total",
                "tpu_serving_ttft_seconds_count",
                "tpu_serving_tpot_seconds_count",
            )},
        "retired_keys": sorted(sorted(r) for r in retired),
        "spans": [sorted(tracks[rid]) for rid in sorted(tracks)],
        "ledger": sorted(eng.devicetime.per_phase_class),
        "tokens": [body["tokens"] for _, body in out],
    }
    device_s = sum(c.value for _, c in eng.registry.get(
        "tpu_serving_device_seconds_total")._series())
    phase_s = eng._m_t_prefill.value + eng._m_t_chunk.value + (
        eng._m_t_verify.value if mode == "paged_ngram" else 0.0)
    if side == "port":
        eng.shutdown()
    return got, device_s, phase_s, text


@pytest.fixture(scope="module")
def scenario(models):
    cache = {}

    def run(side, mode):
        if (side, mode) not in cache:
            cache[side, mode] = _run_scenario(side, models, mode)
        return cache[side, mode]

    yield run
    jtrace.configure(False)
    ttrace.configure(False)


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_scenario_families_and_labels_equal_jax(scenario, mode):
    want, got = scenario("jax", mode)[0], scenario("port", mode)[0]
    assert got["families"] == want["families"]


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_scenario_counts_equal_jax(scenario, mode):
    want, got = scenario("jax", mode)[0], scenario("port", mode)[0]
    assert got["counts"] == want["counts"]
    assert got["tokens"] == want["tokens"]
    counts = got["counts"]
    assert counts['tpu_serving_requests_total{outcome="ok"}'] == 4
    assert counts["tpu_serving_generated_tokens_total"] == \
        sum(n for _, n in SCENARIO)
    assert counts["tpu_serving_ttft_seconds_count"] == 4
    # TPOT is observed for rows with more than one token.
    assert counts["tpu_serving_tpot_seconds_count"] == 3


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_scenario_retired_records_and_spans_equal_jax(scenario, mode):
    want, got = scenario("jax", mode)[0], scenario("port", mode)[0]
    assert got["retired_keys"] == want["retired_keys"]
    assert len(got["retired_keys"]) == 4
    assert "slo" in got["retired_keys"][0]
    assert got["spans"] == want["spans"]
    for names in got["spans"]:
        assert {"queue", "admit", "prefill", "retire", "request"} <= \
            set(names)
    chunked = got["spans"][2]
    assert chunked.count("prefill") == 2


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_scenario_ledger_labels_equal_jax(scenario, mode):
    want, got = scenario("jax", mode)[0], scenario("port", mode)[0]
    assert got["ledger"] == want["ledger"]


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_ledger_sums_to_the_measured_envelopes(scenario, mode):
    """The chip-accounting invariant: the device seconds over every
    label equal the phase counters' seconds (the envelopes they book)."""
    _, device_s, phase_s, _ = scenario("port", mode)
    assert device_s > 0
    assert abs(device_s - phase_s) < 1e-9


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_serving_families_are_the_jax_server_s(scenario, mode):
    """SERVING_FAMILIES (read by chip_smoke.py) is what the JAX server
    renders, and the port renders it too."""
    for side in ("jax", "port"):
        text = scenario(side, mode)[3]
        got = [f for f in family_names(text)
               if f.startswith("tpu_serving_")]
        assert got == SERVING_FAMILIES[mode], side


# -- HTTP ----------------------------------------------------------------------

@pytest.fixture
def served(models):
    """A port engine (dense or paged) behind ``start_server``."""
    made = []

    def make(kv="dense", **kwargs):
        eng = tserve.ContinuousEngine(models[1], **ENGINES[kv], **kwargs)
        server, state = tserve.start_server(eng, port=0, host="127.0.0.1")
        made.append((eng, server))
        tserve.wait_ready(state, timeout=TIMEOUT_S)
        return eng, server.server_address[1]

    yield make
    for eng, server in made:
        server.shutdown()
        server.server_close()
        eng.shutdown()


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_metrics_endpoint_serves_the_engine_registry(served, kv):
    eng, port = served(kv)
    code, body = _post(port, {"tokens": [[1, 2, 3]], "max_new_tokens": 4})
    assert code == 200
    text = _get(port)
    assert 'tpu_serving_requests_total{outcome="ok"} 1.0' in text
    assert "tpu_serving_generated_tokens_total 4.0" in text
    assert "tpu_serving_ttft_seconds_bucket" in text
    # Warmup and the request.
    assert _sample(text, "tpu_serving_ttft_seconds_count") == 2
    assert f"tpu_serving_engine_steps_total " \
        f"{float(eng.stats()['steps_done'])}" in text


def test_serving_metrics_renders_engine_registry_too(models):
    eng = tserve.ContinuousEngine(models[1], max_slots=2, chunk=4,
                                  start_loop=False)
    sm = tserve.ServingMetrics(eng)
    sm.observe(True, 0.2, 4)
    sm.observe(False, 0.0, 0)
    sm.observe(False, 0.0, 0, outcome="shed")
    body = sm.render().decode()
    for outcome in ("ok", "error", "shed"):
        assert f'tpu_serving_requests_total{{outcome="{outcome}"}} 1.0' \
            in body
    assert "tpu_serving_generated_tokens_total 4.0" in body
    assert "tpu_serving_request_latency_seconds_bucket" in body
    assert "tpu_serving_ttft_seconds_bucket" in body
    assert "tpu_serving_engine_steps_total" in body


def test_traceparent_reaches_the_request_track_and_retire_record(served):
    tracer = ttrace.configure()
    eng, port = served(events=tevents.EventStream("serve", host="unit"))
    tid = "0af7651916cd43dd8448eb211c80319c"
    code, _ = _post(port, {"tokens": [[4, 5, 6]], "max_new_tokens": 3},
                    headers={"traceparent": f"00-{tid}-b7ad6b7169203331-01"})
    assert code == 200
    (rec,) = [r for r in eng.events.events(kind="request_retired")
              if r["trace_id"]]
    assert rec["trace_id"] == tid
    spans = [e for e in tracer.events() if e["args"].get("trace_id") == tid]
    assert {"queue", "admit", "prefill", "decode", "retire", "request"} <= \
        {e["name"] for e in spans}
    # A sampled trace leaves its id as the TTFT exemplar.
    assert tid in eng.registry.render().decode()


def test_debug_flight_writes_a_bundle(served, monkeypatch, tmp_path):
    eng, port = served(events=tevents.EventStream("serve", host="unit"))
    assert _post(port, {}, path="/debug/flight")[0] == 503
    monkeypatch.setattr(tflight, "wire_from_flags", functools.partial(
        tflight.wire_from_flags, port=0, crash_hooks=False))
    ttrace.configure()
    metrics = tserve.ServingMetrics(eng)
    args = argparse.Namespace(flight_recorder=True, flight_dir=str(tmp_path),
                              flight_window_s=5.0)
    rec = tserve._wire_flight(args, eng, metrics)
    try:
        assert _post(port, {"tokens": [[1, 2]], "max_new_tokens": 3})[0] \
            == 200
        code, body = _post(port, {}, path="/debug/flight")
    finally:
        rec.close()
    assert code == 200 and body["bundle"].startswith(str(tmp_path))
    with open(body["bundle"]) as f:
        records = [json.loads(ln) for ln in f]
    assert records[0]["registries"] == ["serving", "engine"]
    assert records[0]["providers"] == ["stats", "kv_stats"]
    snaps = [r for r in records if r["record"] == "snapshot"]
    counters = {k for s in snaps for k in s["counters"]}
    assert any(k.startswith("tpu_serving_engine_steps_total")
               for k in counters)
    assert any(e["kind"] == "request_retired"
               for s in snaps for e in s.get("events", ()))
    assert any(sp["name"] == "request"
               for s in snaps for sp in s.get("spans", ()))


def test_batching_model_observes_coalesced_batches():
    """The micro-batcher's instruments, JAX's families (a stub model)."""

    class StubCfg:
        vocab_size = 64
        max_seq_len = 64

    class StubModel:
        cfg = StubCfg()

        def generate(self, tokens, max_new, **kw):
            return [list(r) + [0] * max_new for r in tokens]

    texts = []
    for serve in (tserve, jserve):
        bm = serve.BatchingModel(StubModel(), window_ms=50.0)
        assert bm.generate([[1, 2]], 3) == [[1, 2, 0, 0, 0]]
        assert bm._m_queue_wait.count == 1
        text = bm.registry.render().decode()
        assert "tpu_serving_batch_rows 1.0" in text
        texts.append(families(text))
        if serve is tserve:
            bm.shutdown()
    assert texts[0] == texts[1]


# -- the CLI -------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_metrics_port_serves_the_same_exposition(monkeypatch):
    metrics_port = _free_port()
    seen = {}
    real = tserve.post_generate

    def post_and_scrape(port, *args, **kwargs):
        out = real(port, *args, **kwargs)
        seen["main"] = _get(port)
        seen["own"] = _get(metrics_port)
        return out

    monkeypatch.setattr(tserve, "post_generate", post_and_scrape)
    rc = tserve.main(["--once", "--continuous-batching", "--device", "cpu",
                      "--port", "0", "--metrics-port", str(metrics_port),
                      "--chip-accounting", "--slo-ttft-ms", "200",
                      *TINY_FLAGS])
    assert rc == 0
    assert families(seen["own"]) == families(seen["main"])
    assert family_names(seen["own"]) == family_names(seen["main"])
    names = family_names(seen["own"])
    assert "tpu_serving_requests_total" in names
    assert "tpu_hbm_bytes" in names and "tpu_serving_slo_goodput_ratio" \
        in names
    with pytest.raises(urllib.error.URLError):
        _get(metrics_port)  # released at exit


def test_cli_once_trace_out_smoke(tmp_path):
    """``--once --trace-out``: Chrome trace-event JSON whose request
    spans nest their admit, prefill and decode spans on their track."""
    trace_path = tmp_path / "serve_trace.json"
    rc = tserve.main(["--once", "--continuous-batching", "--device", "cpu",
                      "--port", "0", "--decode-chunk", "4",
                      "--trace-out", str(trace_path), *TINY_FLAGS])
    assert rc == 0
    doc = json.loads(trace_path.read_text())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    requests = [e for e in spans if e["name"] == "request"]
    assert len(requests) >= 2  # the warmup's and --once's
    by_tid = {r["tid"]: r for r in requests}
    nested = 0
    for ph in spans:
        req = by_tid.get(ph["tid"])
        if req is None or ph["name"] not in ("admit", "prefill", "decode"):
            continue
        assert req["ts"] - 1 <= ph["ts"]
        assert ph["ts"] + ph["dur"] <= req["ts"] + req["dur"] + 1
        nested += 1
    assert nested >= 6
    assert any(e["name"] == "decode_chunk" for e in spans)
    meta = doc["traceEvents"][0]
    assert meta["ph"] == "M" and meta["args"]["epoch_ns"] > 0
    lines = (tmp_path / "serve_trace.json.jsonl").read_text().splitlines()
    assert any(json.loads(ln)["name"] == "request" for ln in lines)


def test_cli_profile_dir_brackets_the_run(monkeypatch, tmp_path):
    """``--profile-dir`` wraps the run in ``profiling.trace_or_null``."""
    import contextlib

    seen = []

    @contextlib.contextmanager
    def fake(d):
        seen.append(d)
        yield

    monkeypatch.setattr(profiling, "trace_or_null", fake)
    monkeypatch.setattr(tserve, "_serve", lambda args: 0)
    assert tserve.main(["--profile-dir", str(tmp_path / "prof")]) == 0
    assert seen == [str(tmp_path / "prof")]


def test_cli_profile_dir_writes_a_torch_profiler_trace(tmp_path):
    prof = tmp_path / "prof"
    rc = tserve.main(["--once", "--continuous-batching", "--device", "cpu",
                      "--port", "0", "--profile-dir", str(prof),
                      *TINY_FLAGS])
    assert rc == 0
    (name,) = os.listdir(prof)
    assert name.endswith(profiling.TRACE_SUFFIX)
    doc = json.loads((prof / name).read_text())
    assert doc["baseTimeNanoseconds"] > 0
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


def test_profiling_without_a_directory_is_a_null_context():
    with profiling.trace_or_null("") as prof:
        assert prof is None


OBS_FLAGS = ("slo_ttft_ms", "slo_tpot_ms", "alert_rules", "alerts_out",
             "trace_out", "chip_accounting", "flight_recorder",
             "flight_window_s", "flight_dir", "metrics_port", "profile_dir")


@pytest.mark.parametrize("argv", [
    [],
    ["--slo-ttft-ms", "200", "--slo-tpot-ms", "50", "--chip-accounting",
     "--flight-recorder", "--flight-window-s", "10", "--metrics-port",
     "2116", "--alert-rules", "r.json", "--alerts-out", "a.jsonl"],
])
def test_cli_obs_flags_parse_as_jax_s(monkeypatch, argv):
    got = {}
    for name, mod in (("jax", jserve), ("port", tserve)):
        monkeypatch.setattr(
            mod, "_serve", lambda args, name=name: got.setdefault(name, args)
            and 0)
        assert mod.main(["--continuous-batching", *argv]) == 0
    for flag in OBS_FLAGS:
        assert getattr(got["port"], flag) == getattr(got["jax"], flag), flag


def test_cli_chip_accounting_and_slo_arm_the_engine(monkeypatch):
    built = []

    class Stop(Exception):
        pass

    def capture(model, **kwargs):
        built.append(model)
        raise Stop

    monkeypatch.setattr(tserve, "start_server", capture)
    with pytest.raises(Stop):
        tserve.main(["--continuous-batching", "--kv-cache", "paged",
                     "--kv-block-size", "4", "--device", "cpu",
                     "--port", "0", "--chip-accounting",
                     "--slo-tpot-ms", "50", *TINY_FLAGS])
    (eng,) = built
    try:
        assert eng.slo is not None and eng.slo.tpot_s == 0.05
        assert eng.slo.ttft_s == 0.0
        assert eng.devicetime is not None and eng.hbm is not None
        assert eng.chip_stats() == eng.devicetime.snapshot()
        assert eng.hbm.kv_pool == sum(t.nbytes for t in eng.cache.values())
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_flags_off_register_nothing_beyond_the_instruments(models, kv):
    """Every obs flag off: no SLO, ledger or HBM model, ``chip_stats()``
    None, and the registry holds the JAX engine's default families."""
    args = argparse.Namespace(slo_ttft_ms=0.0, slo_tpot_ms=0.0,
                              chip_accounting=False, flight_recorder=False)
    reg = tmetrics.Registry()
    assert tserve._make_slo(args, reg) is None
    assert tserve._make_devicetime(args, reg, None) is None
    extra = dict(kv_cache="paged", kv_block_size=4) if kv == "paged" else {}
    eng = tserve.ContinuousEngine(models[1], max_slots=2, chunk=4,
                                  start_loop=False, registry=reg, **extra)
    assert tserve._attach_hbm(args, eng) is None
    assert tserve._wire_flight(args, eng, tserve.ServingMetrics(eng)) is None
    assert eng.slo is None and eng.devicetime is None and eng.hbm is None
    assert eng.chip_stats() is None
    jeng = jserve.ContinuousEngine(models[0], max_slots=2, chunk=4,
                                   start_loop=False, **extra)
    assert families(reg.render().decode()) == \
        families(jeng.registry.render().decode())
    names = family_names(reg.render().decode())
    assert not [n for n in names if n.startswith((
        "tpu_serving_slo_", "tpu_serving_device_", "tpu_hbm", "tpu_tenant"))]


# -- chip_smoke's serve_obs helpers ----------------------------------------------

def test_chip_smoke_reads_the_pinned_families():
    import chip_smoke

    assert chip_smoke.serving_families() == SERVING_FAMILIES


def test_chip_smoke_exposition_reads_every_family(served):
    import chip_smoke

    tid = "0af7651916cd43dd8448eb211c80319c"
    ttrace.configure()
    eng, port = served()
    # A sampled trace leaves exemplars on the TTFT buckets.
    _post(port, {"tokens": [[1, 2, 3]], "max_new_tokens": 3},
          headers={"traceparent": f"00-{tid}-b7ad6b7169203331-01"})
    text = _get(port)
    assert f'trace_id="{tid}"' in text
    got = chip_smoke.exposition(text)
    assert sorted(got) == family_names(text)
    assert got["tpu_serving_requests_total"] == \
        {'tpu_serving_requests_total{outcome="ok"}': 1.0}
    assert got["tpu_serving_ttft_seconds"][
        "tpu_serving_ttft_seconds_count"] == 2.0  # warmup and the request
