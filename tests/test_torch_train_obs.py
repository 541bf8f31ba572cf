# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's training observability against the JAX package's: the
``tpu_training_*`` families of ``TrainMetrics``, and one scripted
faulted run on each package's ``train_cli`` (mnist, a preemption at
train.step hit 3, checkpoints every 2 steps, one restart; then the
newest step corrupted and the run resumed): the same result keys, the
same event kinds with the same fields (``train_step``,
``train_recovery``, ``fault_injected``, ``checkpoint_fallback``), the
same span names, and the ``goodput`` block with JAX's keys. Also the
copies of ``obs/goodput.py`` and ``obs/fleet.py`` against the
originals on the same event log and span files."""

import contextlib
import io
import json
import os

import pytest

torch = pytest.importorskip("torch")

from container_engine_accelerators_tpu import faults as jfaults  # noqa: E402
from container_engine_accelerators_tpu.models import (  # noqa: E402
    train_cli as jtrain_cli,
)
from container_engine_accelerators_tpu.obs import fleet as jfleet  # noqa: E402
from container_engine_accelerators_tpu.obs import goodput as jgoodput  # noqa: E402
from container_engine_accelerators_tpu.obs import trace as jtrace  # noqa: E402
from container_engine_accelerators_tpu_torch import faults as tfaults  # noqa: E402
from container_engine_accelerators_tpu_torch.collectives import (  # noqa: E402
    cards,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    train_cli as ttrain_cli,
)
from container_engine_accelerators_tpu_torch.obs import fleet as tfleet  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import goodput as tgoodput  # noqa: E402


def _families(registry):
    """{name: type} of a rendered registry."""
    out = {}
    for line in registry.render().decode().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            out[name] = kind
    return out


def test_train_metrics_families_equal_jax_s():
    port = ttrain_cli.TrainMetrics(128, "tok")
    ref = jtrain_cli.TrainMetrics(128, "tok")
    for m in (port, ref):
        m.observe_step(0.5, 2.0)
    assert _families(port.registry) == _families(ref.registry)
    assert sorted(_families(port.registry)) == [
        "tpu_training_estimated_mfu", "tpu_training_loss",
        "tpu_training_step_seconds", "tpu_training_steps_total",
        "tpu_training_units_per_second"]
    assert port.summary() == ref.summary()


def test_est_mfu_needs_the_card_s_peak(monkeypatch):
    m = ttrain_cli.TrainMetrics(1000, "tok")
    m.calibrate((torch.nn.Linear(10, 10),), torch.device("cpu"))
    m.observe_step(0.001, 1.0)
    assert m.summary()["est_mfu"] == 0.0
    # On the H100 (its name monkeypatched in) the card table's peak.
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: cards.H100_SXM.name)
    m.calibrate((torch.nn.Linear(10, 10),), torch.device("cuda", 0))
    peak = cards.H100_SXM.bf16_tflops * 1e12
    m.observe_step(0.001, 1.0)
    want = 6.0 * 110 * 1000 / 0.001 / peak
    assert m.summary()["est_mfu"] == round(want, 5)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _shape(records):
    """{kind: sorted field names} over the records (the timestamp and
    host vary)."""
    shape = {}
    for r in records:
        shape.setdefault(r["kind"], set()).update(r)
    return {k: sorted(v) for k, v in shape.items()}


def _spans(path):
    with open(path) as f:
        return sorted({ev["name"] for ev in json.load(f)["traceEvents"]
                       if ev.get("ph") == "X"})


def _run(main, argv):
    """main(argv) → its last stdout line as JSON."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _scripted_run(main, workdir, device_flags=()):
    """The faulted run, then a resume past a corrupted newest step.
    Returns (first result, second result, events, span names)."""
    os.makedirs(workdir)
    plan = os.path.join(workdir, "plan.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"kind": "preemption", "site": "train.step",
                               "at": 3}]}, f)
    ev = os.path.join(workdir, "ev.jsonl")
    trace = os.path.join(workdir, "trace.json")
    base = ["--model", "mnist", "--batch-size", "8", "--checkpoint-dir",
            os.path.join(workdir, "ckpt"), "--checkpoint-every", "2",
            "--event-log", ev, "--trace-out", trace, *device_flags]
    first = _run(main, base + ["--steps", "5", "--max-restarts", "1",
                               "--restart-backoff-s", "0.001",
                               "--fault-plan", plan])
    spans = _spans(trace)
    for root, _, files in os.walk(os.path.join(workdir, "ckpt", "step_5")):
        for fn in files:
            with open(os.path.join(root, fn), "wb") as f:
                f.write(b"garbage")
    second = _run(main, base + ["--steps", "6"])
    return first, second, _events(ev), spans


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_obs")
    try:
        ref = _scripted_run(jtrain_cli.main, str(root / "jax"))
    finally:
        # The JAX CLI leaves its plan armed and its tracer on.
        jfaults.disarm()
        jtrace.configure(enabled=False)
    port = _scripted_run(ttrain_cli.main, str(root / "port"),
                         ("--device", "cpu"))
    # The port's CLI leaves nothing armed.
    assert tfaults.active() is None
    return {"jax": ref, "port": port, "root": root}


def test_scripted_run_results_have_jax_s_keys(runs):
    (jfirst, jsecond, _, _), (pfirst, psecond, _, _) = \
        runs["jax"], runs["port"]
    assert sorted(pfirst) == sorted(jfirst)
    assert sorted(psecond) == sorted(jsecond)
    for res in (jfirst, pfirst):
        assert res["restarts"] == 1 and res["start_step"] == 2
        assert res["steps_run"] == 3
    for res in (jsecond, psecond):
        assert res["start_step"] == 4 and res["steps_run"] == 2


def test_scripted_run_events_have_jax_s_kinds_and_fields(runs):
    jshape = _shape(runs["jax"][2])
    pshape = _shape(runs["port"][2])
    for kind in ("train_step", "train_recovery", "fault_injected",
                 "checkpoint_fallback"):
        assert kind in pshape, kind
    assert pshape == jshape
    for name in ("jax", "port"):
        kinds = [r["kind"] for r in runs[name][2]]
        assert kinds.count("train_recovery") == 1
        assert kinds.count("checkpoint_fallback") == 1
        # Steps 0-2, then 2-4 after the restart, then 4-5 on resume.
        assert [r["step"] for r in runs[name][2]
                if r["kind"] == "train_step"] == [0, 1, 2, 2, 3, 4, 4, 5]


def test_scripted_run_spans_are_jax_s(runs):
    assert runs["port"][3] == runs["jax"][3]
    assert set(runs["port"][3]) >= {"init_state", "restore", "step",
                                    "checkpoint"}


def test_goodput_block_has_jax_s_keys(runs):
    for i in (0, 1):
        jg, pg = runs["jax"][i]["goodput"], runs["port"][i]["goodput"]
        assert sorted(pg) == sorted(jg) == ["badput_s", "ratio"]
        assert set(pg["badput_s"]) <= set(tgoodput.CAUSES)
        assert 0.0 < pg["ratio"] <= 1.0
    assert "restart_backoff" in runs["port"][0]["goodput"]["badput_s"]


def test_goodput_copy_equals_jax_s_on_the_same_log(runs):
    """The copied ledger reads a port event log as the original does."""
    path = os.path.join(runs["root"], "port", "ev.jsonl")
    got, _ = tgoodput.report_files([path])
    want, _ = jgoodput.report_files([path])
    assert got == want


def test_fleet_copy_equals_jax_s_on_the_same_spans(runs):
    """The copied trace merger reads the port's span JSONL as the
    original does."""
    path = os.path.join(runs["root"], "port", "trace.json.jsonl")
    got = tfleet.summarize([tfleet.load_host_trace(path)])
    want = jfleet.summarize([jfleet.load_host_trace(path)])
    assert got == want
