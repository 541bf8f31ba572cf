# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The serving warm start's two reference contracts, port against JAX.

``warmup_done``: ``warm_engine(engine, mode, events, max_tasks)`` ends
with one record carrying JAX's attrs (``tasks``, ``compiled``,
``skipped``, ``dropped``, ``dur_s``, ``cache_hits``, ``cache_misses``;
JAX's ``emit_done`` carries no ``mode``), ``max_tasks`` cuts the grid as
JAX's cuts its own, and the port's goodput ledger charges the record to
``compile``. The counts differ from JAX's where the plans differ, and
only there: the port warms one decode graph per window where JAX warms
one program per (steps, window) (``tests/test_torch_graphs.py`` pins the
plans), so each record's ``tasks`` and ``dropped`` are its own plan's.

The ready line: ``warmup(model, state, health_log, mode)`` appends JAX's
``tpu-serving ready warmup_s=<s>`` once warmup succeeds and writes
nothing after one that raised; ``--health-log`` defaults to
``$HEALTH_CHECK_LOG_FILE``; the CLI writes the line and the event log
the record.

The JAX engine is the paged ``ContinuousEngine`` on the 8-device CPU
mesh (tiny f32 model, context 64, block 4); the port's on the same
weights on the CPU.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.obs import events as jevents  # noqa: E402
from container_engine_accelerators_tpu.warmstart import warmup as jwarmup  # noqa: E402
from container_engine_accelerators_tpu_torch.models import serve_cli as tserve  # noqa: E402
from container_engine_accelerators_tpu_torch.models import transformer as ttf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import events as tevents  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import goodput  # noqa: E402
from container_engine_accelerators_tpu_torch.warmstart import warmup as twarmup  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=256, d_model=64, n_layers=1, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=32, kv_block_size=4,
              kv_cache="paged")
# The attrs JAX's emit_done puts on the record.
DONE_ATTRS = {"tasks", "compiled", "skipped", "dropped", "dur_s",
              "cache_hits", "cache_misses"}
READY_RE = re.compile(r"^tpu-serving ready warmup_s=\d+\.\d\n$")


@pytest.fixture(scope="module")
def models():
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


def _schema_keys(stream, record):
    """The attrs of a record: everything but the stream's envelope."""
    envelope = {"ts", "source", "host", "severity", stream.kind_key}
    return set(record) - envelope


@pytest.fixture(scope="module")
def records(models, tmp_path_factory):
    """Both packages' warmup_done records, whole grid and capped at 3
    tasks, and the port's event log of the whole-grid run."""
    jmodel, tmodel = models
    log_path = str(tmp_path_factory.mktemp("warm") / "events.jsonl")
    out = {}
    for cap in (None, 3):
        jstream = jevents.EventStream("serve")
        jeng = jserve.ContinuousEngine(jmodel, start_loop=False, **ENGINE)
        jsum = jwarmup.warm_engine(jeng, mode="all", events=jstream,
                                   max_tasks=cap)
        tstream = tevents.EventStream(
            "serve", sink_path=log_path if cap is None else "")
        teng = tserve.ContinuousEngine(tmodel, **ENGINE)
        try:
            tsum = twarmup.warm_engine(teng, mode="all", events=tstream,
                                       max_tasks=cap)
        finally:
            teng.shutdown()
        out[cap] = {
            "jax": (jstream, jstream.events("warmup_done"), jsum,
                    len(jwarmup.warm_plan(jeng))),
            "port": (tstream, tstream.events("warmup_done"), tsum,
                     len(twarmup.warm_plan(teng))),
        }
    out["log"] = log_path
    return out


@pytest.mark.parametrize("cap", [None, 3])
def test_warmup_done_carries_jax_s_attrs(records, cap):
    for side in ("jax", "port"):
        stream, done, summary, _ = records[cap][side]
        assert len(done) == 1, side
        assert _schema_keys(stream, done[0]) == DONE_ATTRS, side
        for key in DONE_ATTRS:
            assert done[0][key] == summary[key], (side, key)
        assert done[0]["skipped"] == 0 and summary["mode"] == "all"
    jstream, (jdone,), _, _ = records[cap]["jax"]
    tstream, (tdone,), _, _ = records[cap]["port"]
    assert tdone[tstream.kind_key] == jdone[jstream.kind_key] == "warmup_done"
    assert tdone["source"] == jdone["source"] == "serve"


@pytest.mark.parametrize("cap", [None, 3])
def test_max_tasks_drops_as_jax_does(records, cap):
    """Each package runs min(cap, plan) tasks and counts the rest as
    dropped; the plans differ only in their decode tasks (one per
    window in the port, one per (steps, window) in JAX)."""
    for side in ("jax", "port"):
        _, (done,), _, plan = records[cap][side]
        ran = plan if cap is None else min(cap, plan)
        assert done["tasks"] == done["compiled"] == ran, side
        assert done["dropped"] == plan - ran, side
    if cap is not None:
        assert records[cap]["port"][1][0]["dropped"] > 0
        assert records[cap]["jax"][1][0]["dropped"] > 0


def test_port_plan_differs_from_jax_only_in_decode_tasks(models):
    jeng = jserve.ContinuousEngine(models[0], start_loop=False, **ENGINE)
    teng = tserve.ContinuousEngine(models[1], start_loop=False, **ENGINE)
    jlabels = [t.label for t in jwarmup.warm_plan(jeng)]
    tlabels = [t.label for t in twarmup.warm_plan(teng)]
    assert [lab for lab in tlabels if not lab.startswith("pdecode/")] == [
        lab for lab in jlabels if not lab.startswith("pdecode/")]


def test_goodput_charges_warmup_done_to_compile(records):
    summary, _ = goodput.report_files([records["log"]])
    (done,) = records[None]["port"][1]
    seconds = summary["total"]["seconds"]
    assert seconds["compile"] == pytest.approx(done["dur_s"], abs=1e-6)
    assert seconds.get("productive", 0) == 0


def test_lazy_mode_emits_nothing(models):
    stream = tevents.EventStream("serve")
    eng = tserve.ContinuousEngine(models[1], start_loop=False, **ENGINE)
    summary = twarmup.warm_engine(eng, mode="lazy", events=stream)
    assert summary["tasks"] == 0 and not stream.events()


# -- the ready line ------------------------------------------------------------

def test_ready_line_constant_is_jax_s():
    assert tserve.READY_LINE == jserve.READY_LINE == "tpu-serving ready"


def test_ready_line_is_jax_s_text(models, tmp_path):
    jmodel, tmodel = models
    lines = {}
    for side, serve, model in (("jax", jserve, jmodel),
                               ("port", tserve, tmodel)):
        path = tmp_path / f"{side}.log"
        path.write_text("earlier line\n")
        state = {"ready": False}
        serve.warmup(model, state, str(path), "lazy")
        assert state["ready"] and "error" not in state, side
        first, line = path.read_text().split("\n", 1)
        assert first == "earlier line", side  # appended, never truncated
        assert READY_RE.match(line), (side, line)
        lines[side] = line.split("=")[0]
    assert lines["port"] == lines["jax"]


class _Failing:
    def generate(self, prompts, max_new_tokens):
        raise RuntimeError("the device fell over")


@pytest.mark.parametrize("serve", [jserve, tserve], ids=["jax", "port"])
def test_failed_warmup_writes_no_ready_line(serve, tmp_path):
    path = tmp_path / "health.log"
    state = {"ready": False}
    serve.warmup(_Failing(), state, str(path), "lazy")
    assert not state["ready"] and "fell over" in state["error"]
    assert not path.exists()


def test_health_log_defaults_to_the_env(monkeypatch):
    monkeypatch.setenv("HEALTH_CHECK_LOG_FILE", "/var/log/health.log")
    args = tserve.build_parser().parse_args([])
    assert args.health_log == "/var/log/health.log"
    monkeypatch.delenv("HEALTH_CHECK_LOG_FILE")
    assert tserve.build_parser().parse_args([]).health_log == ""


def test_cli_writes_the_ready_line_and_the_warmup_record(tmp_path):
    health, events = tmp_path / "health.log", tmp_path / "ev.jsonl"
    env = {**os.environ, "HEALTH_CHECK_LOG_FILE": str(health)}
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", "--n-layers", "1",
         "--d-model", "64", "--n-heads", "2", "--seq-len", "64",
         "--vocab-size", "256", "--continuous-batching", "--kv-cache",
         "paged", "--kv-block-size", "4", "--max-slots", "2",
         "--decode-chunk", "4", "--prefill-chunk", "16", "--warmup", "all",
         "--event-log", str(events)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert READY_RE.match(health.read_text())
    records = [json.loads(line) for line in events.read_text().splitlines()]
    (done,) = [r for r in records if r.get("kind") == "warmup_done"]
    assert DONE_ATTRS <= set(done) and done["tasks"] == 9
    assert done["dropped"] == 0
