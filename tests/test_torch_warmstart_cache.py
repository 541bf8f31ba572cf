# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's persistent compile cache (``warmstart/cache.py``) against
the JAX package's: the key, the memos, the counters and the snapshots;
the nvcc build hook (``ops/_ext.py``) with a stub ``nvcc`` on ``PATH``
across two processes; the Triton count; ``--compile-cache-dir`` on both
CLIs keyed as JAX keys it; the supervisor's per-attempt deltas; and the
warm start's ``cache_hits``/``cache_misses``."""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from container_engine_accelerators_tpu.fleet import sim as jsim  # noqa: E402
from container_engine_accelerators_tpu.faults import storm as jstorm  # noqa: E402
from container_engine_accelerators_tpu.models import (  # noqa: E402
    supervisor as jsupervisor,
)
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import train_cli as jtrain  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.obs import events as jevents  # noqa: E402
from container_engine_accelerators_tpu.obs import metrics as jmetrics  # noqa: E402
from container_engine_accelerators_tpu.warmstart import cache as jcache  # noqa: E402
from container_engine_accelerators_tpu_torch.faults import storm as tstorm  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import sim as tsim  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    supervisor as tsupervisor,
)
from container_engine_accelerators_tpu_torch.models import serve_cli as tserve  # noqa: E402
from container_engine_accelerators_tpu_torch.models import train_cli as ttrain  # noqa: E402
from container_engine_accelerators_tpu_torch.models import transformer as ttf  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import events as tevents  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import _ext  # noqa: E402
from container_engine_accelerators_tpu_torch.ops import stream  # noqa: E402
from container_engine_accelerators_tpu_torch.warmstart import cache as tcache  # noqa: E402
from container_engine_accelerators_tpu_torch.warmstart import warmup as twarmup  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=32, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
             d_ff=32, max_seq_len=128, dtype="float32")


@pytest.fixture(autouse=True)
def _unarmed():
    tcache.deactivate()
    jcache.deactivate()
    yield
    tcache.deactivate()
    jcache.deactivate()


KEY_CASES = {
    "empty": {},
    "topology_only": {"topology": "1xgpu"},
    "dict_cfg": {"topology": "8xcpu", "cfg": {"d_model": 16, "n_layers": 1}},
    "buckets": {"topology": "1xgpu", "cfg": {"model": "bert"},
                "buckets": [("prefill", (16, 32)), ("windows", (64,))]},
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_cache_key_equals_jax_s(case):
    kw = KEY_CASES[case]
    assert tcache.cache_key(**kw) == jcache.cache_key(**kw)
    assert len(tcache.cache_key(**kw)) == 12


def test_cache_key_of_a_config_equals_jax_s_with_its_overlap_field():
    """Both packages' TransformerConfig have ``overlap`` at JAX's default
    (``--overlap auto``), so the keys of one config agree."""
    jcfg, tcfg = jtf.TransformerConfig(**SHAPE), ttf.TransformerConfig(**SHAPE)
    assert dataclasses.asdict(jcfg) == {**dataclasses.asdict(tcfg),
                                        "overlap": "auto"}
    assert tcache.cache_key("1xgpu", {**dataclasses.asdict(tcfg),
                                      "overlap": "auto"}) == \
        jcache.cache_key("1xgpu", jcfg)


def test_memo_race_records_one_miss(tmp_path):
    cache = tcache.CompileCache(str(tmp_path), key="k",
                                registry=tmetrics.Registry())
    n = 8
    start = threading.Barrier(n)
    hits = []

    def first():
        start.wait()
        hits.append(cache.memo("prog/x"))

    threads = [threading.Thread(target=first) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert sorted(hits) == [False] + [True] * (n - 1)
    assert cache.snapshot() == {"hits": n - 1, "misses": 1}
    assert cache.memo_names() == ["prog/x"]


def test_memo_snapshot_and_names_match_jax(tmp_path):
    caches = {
        "jax": jcache.CompileCache(str(tmp_path / "j"), key="k",
                                   registry=jmetrics.Registry()),
        "port": tcache.CompileCache(str(tmp_path / "t"), key="k",
                                    registry=tmetrics.Registry()),
    }
    seen = {}
    for name, cache in caches.items():
        s0 = cache.snapshot()
        got = [cache.memo(label) for label in ("a", "b/c", "a", "d e")]
        s1 = cache.snapshot()
        seen[name] = (got, {k: s1[k] - s0[k] for k in s0},
                      cache.memo_names(), os.listdir(cache.dir))
    assert seen["port"][:3] == seen["jax"][:3]
    assert sorted(seen["port"][3]) == sorted(seen["jax"][3])
    assert seen["port"][1] == {"hits": 1, "misses": 3}


def test_global_snapshot_arm_and_deactivate(tmp_path):
    assert tcache.active() is None
    assert tcache.snapshot() == {"hits": 0, "misses": 0}
    cache = tcache.CompileCache(str(tmp_path), registry=tmetrics.Registry())
    assert tcache.arm(cache) is cache and tcache.active() is cache
    cache.memo("x")
    assert tcache.snapshot() == {"hits": 0, "misses": 1}
    # arm() leaves the build hooks alone (the drills' simulated compiles).
    assert _ext.BUILD_DIR == _ext.DEFAULT_BUILD_DIR
    tcache.deactivate()
    assert tcache.active() is None
    assert tcache.snapshot() == {"hits": 0, "misses": 0}


def test_configure_points_the_build_hooks_and_emits_jax_s_event(
        tmp_path, monkeypatch):
    monkeypatch.delenv(tcache.TRITON_ENV, raising=False)
    reg = tmetrics.Registry()
    events = tevents.EventStream(tcache.EVENT_SOURCE, registry=reg)
    cache = tcache.configure(str(tmp_path), key="abc", registry=reg,
                             events=events)
    assert cache.dir == str(tmp_path / "abc")
    assert _ext.BUILD_DIR == tmp_path / "abc" / "torch_ext"
    assert os.environ[tcache.TRITON_ENV] == str(tmp_path / "abc" / "triton")
    (rec,) = events.events(kind="compile_cache_configured")
    assert {k: rec[k] for k in ("dir", "key", "runtime_cache")} == \
        {"dir": cache.dir, "key": "abc", "runtime_cache": True}
    assert "tpu_compile_cache_hits_total" in reg.render().decode()
    tcache.deactivate()
    assert _ext.BUILD_DIR == _ext.DEFAULT_BUILD_DIR


def test_configure_after_triton_compiled_says_so(tmp_path, monkeypatch):
    monkeypatch.setattr(stream, "compiled_specialisations", lambda: 2)
    events = tevents.EventStream(tcache.EVENT_SOURCE,
                                 registry=tmetrics.Registry())
    tcache.configure(str(tmp_path), registry=tmetrics.Registry(),
                     events=events)
    (rec,) = events.events(kind="compile_cache_configured")
    assert rec["runtime_cache"] is False


def test_count_triton_tells_hits_from_misses(tmp_path):
    """A launch that compiles (the in-memory count grows) is a miss when
    Triton's directory gained an entry, a hit when it did not; a launch
    of a specialisation already in memory counts neither way; nothing
    counts with no cache armed."""
    compiled = [0]

    def launch(new_entry):
        def run():
            compiled[0] += 1
            if new_entry:
                os.makedirs(os.path.join(cache.triton_dir,
                                         f"k{compiled[0]}"))
            return "launched"
        return run

    cache = tcache.CompileCache(str(tmp_path), registry=tmetrics.Registry())
    assert tcache.count_triton(lambda: compiled[0], launch(True)) == \
        "launched"
    assert cache.snapshot() == {"hits": 0, "misses": 0}
    tcache.arm(cache)
    tcache.count_triton(lambda: compiled[0], launch(True))
    tcache.count_triton(lambda: compiled[0], launch(False))
    tcache.count_triton(lambda: compiled[0], lambda: "in memory")
    assert cache.snapshot() == {"hits": 1, "misses": 1}


def test_stream_kernels_count_nothing_before_their_first_launch():
    assert stream.compiled_specialisations() == 0


STUB_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo stub > "$out"
"""

BUILD_CODE = """
import json, sys
from container_engine_accelerators_tpu_torch.ops import _ext
from container_engine_accelerators_tpu_torch.warmstart import cache
c = cache.configure(sys.argv[1], key="k")
_ext.build()
print(json.dumps({"snap": c.snapshot(),
                  "paths": sorted(i["path"] for i in _ext.build_info.values()),
                  "seconds": {k: i["seconds"] for k, i in
                              _ext.build_info.items()}}))
"""


def test_a_second_process_on_an_armed_cache_runs_no_nvcc(tmp_path):
    """A stub ``nvcc`` on PATH writes its ``-o`` file and logs its call:
    the first process builds the three libraries into the cache (3
    misses), the second finds them (3 hits) and runs no nvcc."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(log=log))
    nvcc.chmod(0o755)
    env = {**os.environ, "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}"}
    env.pop("PYTHONPATH", None)
    runs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", BUILD_CODE, str(tmp_path / "cc")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        runs[-1]["nvcc_calls"] = len(log.read_text().splitlines())
    first, second = runs
    assert first["snap"] == {"hits": 0, "misses": len(_ext.SOURCES)}
    assert first["nvcc_calls"] == len(_ext.SOURCES)
    assert second["snap"] == {"hits": len(_ext.SOURCES), "misses": 0}
    assert second["nvcc_calls"] == len(_ext.SOURCES)  # none added
    assert set(second["seconds"].values()) == {0.0}
    ext_dir = tmp_path / "cc" / "k" / "torch_ext"
    assert first["paths"] == second["paths"]
    assert all(p.startswith(str(ext_dir)) for p in first["paths"])
    assert sorted(os.listdir(ext_dir)) == sorted(
        os.path.basename(p) for p in first["paths"])


def test_build_counts_nothing_with_no_cache_armed(tmp_path, monkeypatch):
    """Unarmed, a library found is no hit, as JAX counts nothing without
    a configured cache."""
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path)
    for name in _ext.SOURCES:
        _ext._library_path(name).write_text("stub")
    cache = tcache.CompileCache(str(tmp_path / "cc"),
                                registry=tmetrics.Registry())
    _ext.build()
    assert cache.snapshot() == {"hits": 0, "misses": 0}
    tcache.arm(cache)
    _ext.build()
    assert cache.snapshot() == {"hits": len(_ext.SOURCES), "misses": 0}


class _KeySeen(Exception):
    pass


def _capture_keys(monkeypatch, module, seen):
    """Record ``module.cache_key``'s kwargs and stop the CLI at its
    ``configure_from_flag``."""
    real = module.cache_key

    def cache_key(**kw):
        seen.update(kw)
        return real(**kw)

    def configure_from_flag(base_dir, key="", **kw):
        seen["key"] = key
        raise _KeySeen

    monkeypatch.setattr(module, "cache_key", cache_key)
    monkeypatch.setattr(module, "configure_from_flag", configure_from_flag)


def _same_key(jseen, tseen):
    """The port's key is JAX's cache_key over JAX's config and buckets
    at the port's topology (the device views differ: JAX's CPU mesh has
    8 devices)."""
    n, platform = tseen["topology"].split("x")
    assert int(n) >= 1 and platform == jseen["topology"].split("x")[1]
    jcfg = jseen["cfg"]
    if dataclasses.is_dataclass(jcfg):
        jcfg = dataclasses.asdict(jcfg)
    assert tseen["cfg"] == jcfg
    assert tseen.get("buckets", ()) == jseen.get("buckets", ())
    assert tseen["key"] == jcache.cache_key(
        topology=tseen["topology"], cfg=jcfg,
        buckets=jseen.get("buckets", ()))


TRAIN_ARGS = {
    "defaults": [],
    "bert": ["--model", "bert", "--batch-size", "4", "--seq-len", "64",
             "--d-model", "64", "--n-layers", "1", "--dtype", "float32"],
    "transformer_moe": ["--model", "transformer", "--n-experts", "4",
                        "--vocab-size", "256"],
}


@pytest.mark.parametrize("case", sorted(TRAIN_ARGS))
def test_train_cli_flag_keys_as_jax_keys(tmp_path, monkeypatch, case):
    argv = ["--compile-cache-dir", str(tmp_path), *TRAIN_ARGS[case]]
    jseen, tseen = {}, {}
    _capture_keys(monkeypatch, jcache, jseen)
    _capture_keys(monkeypatch, tcache, tseen)
    with pytest.raises(_KeySeen):
        jtrain.main(argv)
    with pytest.raises(_KeySeen):
        ttrain.main(argv + ["--device", "cpu"])
    assert tseen["topology"] == "1xcpu"
    _same_key(jseen, tseen)


SERVE_ARGS = {
    "dense": ["--continuous-batching", "--prefill-chunk", "48"],
    "paged": ["--continuous-batching", "--kv-cache", "paged",
              "--kv-block-size", "8"],
    "ngram": ["--continuous-batching", "--kv-cache", "paged",
              "--speculate", "ngram", "--speculate-k", "6"],
    "not_continuous": ["--speculate", "ngram"],
}


@pytest.mark.parametrize("case", sorted(SERVE_ARGS))
def test_serve_cli_flag_keys_as_jax_keys(tmp_path, monkeypatch, case):
    argv = ["--compile-cache-dir", str(tmp_path), "--port", "0",
            "--seq-len", "128", "--d-model", "32", "--n-layers", "1",
            "--n-heads", "2", "--vocab-size", "64", "--dtype", "float32",
            *SERVE_ARGS[case]]
    jseen, tseen = {}, {}
    _capture_keys(monkeypatch, jcache, jseen)
    _capture_keys(monkeypatch, tcache, tseen)
    with pytest.raises(_KeySeen):
        jserve.main(argv)
    with pytest.raises(_KeySeen):
        tserve.main(argv + ["--device", "cpu"])
    assert tseen["topology"] == "1xcpu"
    _same_key(jseen, tseen)


def test_cli_deactivates_its_cache_when_it_returns(tmp_path):
    out = ttrain.main(["--compile-cache-dir", str(tmp_path), "--steps", "1",
                       "--model", "mnist", "--device", "cpu"])
    assert out == 0
    assert tcache.active() is None
    assert _ext.BUILD_DIR == _ext.DEFAULT_BUILD_DIR
    (key,) = os.listdir(tmp_path)
    assert len(key) == 12


def test_recovery_events_carry_the_attempt_s_deltas(tmp_path):
    """With a cache armed, each package's ``train_recovery`` event
    carries the failed attempt's hits and misses: the first attempt pays
    (a miss), the retry replays (a hit)."""
    got = {}
    for name, (cache_mod, supervisor, events_mod, metrics_mod) in {
        "jax": (jcache, jsupervisor, jevents, jmetrics),
        "port": (tcache, tsupervisor, tevents, tmetrics),
    }.items():
        cache = cache_mod.arm(cache_mod.CompileCache(
            str(tmp_path / name), registry=metrics_mod.Registry()))
        calls = {"n": 0}

        def run(cache=cache, calls=calls, supervisor=supervisor):
            calls["n"] += 1
            cache.memo("train/step_program")
            supervisor.beat(calls["n"])
            if calls["n"] <= 2:
                raise RuntimeError("boom")
            return {"ok": True}

        stream = events_mod.EventStream("test.supervisor")
        assert supervisor.supervise(
            run, max_restarts=2, backoff_base_s=0.001, seed=1,
            events=stream, sleep=lambda _s: None,
        ) == {"ok": True, "restarts": 2}
        got[name] = [
            ({k: r[k] for k in ("cache_hits", "cache_misses")}, sorted(r))
            for r in stream.events(kind="train_recovery")
        ]
        cache_mod.deactivate()
    assert got["port"] == got["jax"]
    assert [d for d, _ in got["port"]] == [
        {"cache_hits": 0, "cache_misses": 1},
        {"cache_hits": 1, "cache_misses": 0},
    ]


def test_sim_warm_counts_match_jax_s_for_the_same_grid(tmp_path):
    """The hermetic warm start (``SimReplica.warm`` through the cache
    memo) gives JAX's warmup_done counts for the same labels: a cold
    replica misses each, its replacement hits each."""
    labels = ["prefill/b16", "pprefill/c64/w64/logits", "pdecode/s4/w64"]
    got = {}
    for name, (cache_mod, sim, storm, metrics_mod) in {
        "jax": (jcache, jsim, jstorm, jmetrics),
        "port": (tcache, tsim, tstorm, tmetrics),
    }.items():
        cache = cache_mod.CompileCache(str(tmp_path / name), key="k",
                                       registry=metrics_mod.Registry())
        summaries = []
        for rid in ("cold", "warm"):
            replica = sim.SimReplica(
                rid, chunk_sleep_s=0.0,
                compile_sim=storm.make_compile_sim(cache, 0.0))
            summary = replica.warm(labels)
            summary.pop("dur_s")
            summaries.append(summary)
            (rec,) = replica.events.events(kind="warmup_done")
            assert rec["cache_hits"] == summary["cache_hits"]
            if name == "port":
                replica.engine.shutdown()
        got[name] = summaries
    assert got["port"] == got["jax"]
    assert [(s["cache_hits"], s["cache_misses"]) for s in got["port"]] == \
        [(0, 3), (3, 0)]


def test_warm_engine_counts_the_armed_cache_s_deltas(tmp_path):
    """JAX's meaning of warmup_done's counts: the armed cache's deltas
    over the pass (0 with none armed), whatever the tasks build; the
    decode graphs (none on the CPU) are not counted there."""
    eng = tsim.make_fake_engine(start_loop=True)
    try:
        # The segments: the fake engine's decode graphs have no model.
        plan = twarmup.warm_plan(eng)
        n_segments = sum(t.label.startswith("pprefill/") for t in plan)
        assert plan[n_segments].label.startswith("pdecode/")
        assert twarmup.warm_engine(eng, max_tasks=n_segments)[
            "cache_misses"] == 0
        cache = tcache.arm(tcache.CompileCache(
            str(tmp_path), registry=tmetrics.Registry()))
        cache.memo("before the pass")
        seg = eng._paged_prefill

        def building_prefill(*args, **kwargs):
            # A task that builds a kernel once and finds it after.
            cache.memo("kernel")
            return seg(*args, **kwargs)

        eng._paged_prefill = building_prefill
        events = tevents.EventStream("serve-test")
        summary = twarmup.warm_engine(eng, events=events,
                                      max_tasks=n_segments)
        assert n_segments >= 2
        assert (summary["cache_hits"], summary["cache_misses"]) == \
            (n_segments - 1, 1)
        (rec,) = events.events(kind="warmup_done")
        assert (rec["cache_hits"], rec["cache_misses"]) == \
            (n_segments - 1, 1)
    finally:
        eng.shutdown()
