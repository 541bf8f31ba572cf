# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's request-journey drill (``fleet/journeydrill.py``) and its
copy of ``obs/journey.py`` against the JAX package's, and the JAX
package's jax-free readers over the port's artifacts.

The drill runs at JAX's tier-1 size (``tests/test_journey.py``:
measured 6, straggled 3, max_new 8, no wall-clock gate) on the port's
fleet: every measured request stitches, a hedged journey carries its
leg, a handed-off one its transfer, and the forced-slow request's TTFT
exemplar resolves to a journey blaming ``prefill``. Both packages' runs
agree on the structural fields. Left out of that comparison, because
they depend on timing: the number of hedged and handed-off journeys (a
hedge's winner is a race between the straggling primary and the hedge,
and the prefix directory moves a family to whichever replica answered),
the stage percentiles' values, the stage-sum mismatches and the trace
ids (random). The copy of ``obs/journey.py`` stitches the port's drill
artifacts into the same report as the original.

The readers: JAX's ``obs/capacity.py``, ``obs/journey.py`` and
``obs/postmortem.py`` read the port's ``serve_cli --event-log`` and
``--trace-out`` and a bundle of the port's flight recorder over a
training run's registry, events and spans, as they read the JAX
package's own: rc 0, and the same summary keys.
"""

import contextlib
import functools
import importlib
import io
import json
import os

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu.fleet import journeydrill as jjd  # noqa: E402
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import train_cli as jtrain  # noqa: E402
from container_engine_accelerators_tpu.obs import capacity as jcapacity  # noqa: E402
from container_engine_accelerators_tpu.obs import journey as jjourney  # noqa: E402
from container_engine_accelerators_tpu.obs import postmortem as jpostmortem  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import journeydrill as tjd  # noqa: E402
from container_engine_accelerators_tpu_torch.models import serve_cli as tserve  # noqa: E402
from container_engine_accelerators_tpu_torch.models import train_cli as ttrain  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import journey as tjourney  # noqa: E402

SEED = int(os.environ.get("CHAOS_SEED", "0"))
TWIN = dict(measured=6, straggled=3, max_new=8, strict_timing=False)


@pytest.fixture(scope="module")
def drills():
    """{"port": ..., "jax": ...}: each package's tier-1 drill, as
    (verdict, report, trace, records)."""
    return {"port": tjd.run_drill(seed=SEED, **TWIN),
            "jax": jjd.run_drill(seed=SEED, **TWIN)}


def test_port_twin_stitches_every_request(drills):
    verdict, report, trace, records = drills["port"]
    assert verdict["pass"], verdict["failures"]
    assert verdict["stitch_ratio"] == 1.0
    assert verdict["hedged_with_leg"] >= 1
    assert verdict["handoff_journeys"] >= 1
    assert verdict["exemplar"]["resolved"]
    assert verdict["exemplar"]["guilty_stage"] == "prefill"
    ex = tjourney.find_journey(report, verdict["exemplar"]["trace_id"])
    assert ex is not None and ex["complete"]
    assert trace.spans and records


def _structure(verdict, report):
    counts = verdict["journeys"]
    return {
        "pass": verdict["pass"], "measured": verdict["measured"],
        "stitched": verdict["stitched"],
        "stitch_ratio": verdict["stitch_ratio"], "bad": verdict["bad"],
        "exemplar": {k: verdict["exemplar"][k]
                     for k in ("resolved", "guilty_stage")},
        "journeys": {k: counts[k] for k in ("journeys", "complete",
                                             "retired", "reissued")},
        "hedged_seen": verdict["hedged_with_leg"] >= 1,
        "handoff_seen": verdict["handoff_journeys"] >= 1,
        "stages": sorted(verdict["stage_percentiles"]),
        "report_keys": sorted(report),
        "journey_keys": sorted({k for j in report["journeys"] for k in j}),
    }


def test_structural_fields_equal_jax_s(drills):
    got = {name: _structure(v, r) for name, (v, r, _, _) in drills.items()}
    assert got["port"] == got["jax"]


def test_journey_copy_stitches_the_drill_as_the_original(drills):
    _, _, trace, records = drills["port"]
    port, _ = tjourney.build_report([trace], events=records)
    ref, _ = jjourney.build_report([trace], events=records)
    assert json.dumps(port, sort_keys=True, default=str) == \
        json.dumps(ref, sort_keys=True, default=str)


def test_drill_artifacts_stitch_with_either_journey_cli(drills, tmp_path):
    """``--out-dir``'s files (the drill's spans and events, re-stitched
    by the port's journey CLI) read by JAX's journey CLI: the same
    report."""
    _, _, trace, records = drills["port"]
    out = tmp_path / "port"
    assert tjd._write_artifacts(str(out), trace, records) == 0
    ref = tmp_path / "jax.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jjourney.main([str(out / "fleet.jsonl"), "--events",
                              str(out / "events.jsonl"), "--summary-json",
                              str(ref)]) == 0
    port = json.loads((out / "report.json").read_text())
    assert port == json.loads(ref.read_text())
    assert port["counts"]["journeys"] >= TWIN["measured"]


def test_cli_writes_the_verdict_and_artifacts(tmp_path, monkeypatch):
    # The CLI's wall-clock gate is for a quiet machine; tier 1 runs
    # the structure only, as JAX's twin does.
    monkeypatch.setattr(tjd, "run_drill",
                        functools.partial(tjd.run_drill,
                                          strict_timing=False))
    out = tmp_path / "verdict.json"
    rc = tjd.main(["--measured", "3", "--straggled", "2", "--max-new", "4",
                   "--json", str(out), "--out-dir", str(tmp_path / "art")])
    verdict = json.loads(out.read_text())
    assert rc == 0 and verdict["pass"], verdict["failures"]
    assert sorted(os.listdir(tmp_path / "art")) == [
        "events.jsonl", "fleet.jsonl", "journeys.json", "report.json"]


# -- JAX's readers over the port's artifacts ---------------------------------

SERVE_FLAGS = ["--once", "--continuous-batching", "--port", "0",
               "--decode-chunk", "4", "--chip-accounting", "--seq-len", "64",
               "--d-model", "32", "--n-layers", "1", "--n-heads", "2",
               "--vocab-size", "64", "--dtype", "float32"]
PACKAGES = {"port": "container_engine_accelerators_tpu_torch",
            "jax": "container_engine_accelerators_tpu"}


def _flight_bundle(side, flight_dir):
    """A bundle of the package's flight recorder over a training run's
    registry, event stream and tracer: five observed steps, then the
    trigger the supervisor fires on a restart."""
    pkg = PACKAGES[side]
    flight = importlib.import_module(f"{pkg}.obs.flight")
    events = importlib.import_module(f"{pkg}.obs.events")
    trace = importlib.import_module(f"{pkg}.obs.trace")
    train = ttrain if side == "port" else jtrain
    metrics = train.TrainMetrics(128, "tok")
    stream = events.EventStream("train", registry=metrics.registry)
    tracer = trace.configure()
    rec = flight.wire_from_flags(
        True, str(flight_dir), registries=[("train", metrics.registry)],
        streams=[stream], tracer=tracer, port=0, crash_hooks=False,
        start=False)
    try:
        for step in range(5):
            with trace.span("step", step=step):
                metrics.observe_step(0.01, 2.0 - 0.1 * step)
            stream.emit("train_step", step=step, dur_s=0.01)
            rec.snapshot()
        return flight.trigger("supervisor_restart", attempt=1)
    finally:
        rec.close()
        flight.deactivate()
        trace.configure(enabled=False)


def _artifacts(side, tmp_path):
    """One package's serving event log and span file (``serve_cli
    --once --chip-accounting --event-log --trace-out``) and a flight
    bundle."""
    d = tmp_path / side
    d.mkdir()
    serve = tserve if side == "port" else jserve
    cpu = ["--device", "cpu"] if side == "port" else []
    with contextlib.redirect_stdout(io.StringIO()):
        assert serve.main([*SERVE_FLAGS, *cpu, "--event-log",
                           str(d / "serve.jsonl"), "--trace-out",
                           str(d / "trace.json")]) == 0
    bundle = _flight_bundle(side, d / "flight")
    return d / "serve.jsonl", d / "trace.json.jsonl", bundle


def _keys(obj, depth=2):
    """The nested key structure of a summary, ``depth`` levels deep."""
    if not isinstance(obj, dict) or depth == 0:
        return type(obj).__name__
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


def _read(paths, tmp_path, tag):
    events, spans, bundle = paths
    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, main, argv in (
            ("capacity", jcapacity.main, ["report", str(events)]),
            ("journey", jjourney.main, [str(spans), "--events",
                                        str(events)]),
            ("postmortem", jpostmortem.main, [str(bundle)]),
        ):
            summary = tmp_path / f"{tag}_{name}.json"
            assert main([*argv, "--summary-json", str(summary)]) == 0, name
            out[name] = json.loads(summary.read_text())
    return out


def test_jax_readers_read_the_port_s_logs_trace_and_flight_bundle(tmp_path):
    got = {side: _read(_artifacts(side, tmp_path), tmp_path, side)
           for side in ("port", "jax")}
    for name in ("capacity", "journey", "postmortem"):
        assert _keys(got["port"][name]) == _keys(got["jax"][name]), name
    # The same record kinds feed the capacity table (how many requests
    # each CLI's warmup retires is the serving engines' business).
    assert sorted(got["port"]["capacity"]["counts"]) == \
        sorted(got["jax"]["capacity"]["counts"])
    assert got["port"]["postmortem"]["trigger"]["kind"] == \
        got["jax"]["postmortem"]["trigger"]["kind"] == "supervisor_restart"
