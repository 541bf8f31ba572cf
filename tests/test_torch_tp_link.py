# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's linked ``--tp`` serving on one host vs the JAX package (CPU,
f32).

JAX's one-host ``--tp`` is one process over its 8-device CPU mesh
(``tests/conftest.py``), with no engine link, so its paged engine
speculates, hands KV off and retries. The port's ``--tp 2`` is a linked
world of two gloo processes (``tests/torch_dist_worker.py`` scenario
``serve_link``, one world shared by the tests here), on JAX's weights
(``weights.params_from_jax``):

  * greedy streams under ``--speculate ngram`` and ``draft`` equal JAX's
    one-host ``Model(tp=2)`` paged engine's and the port's own
    non-speculating stream, and every rank's page tables, pool, radix
    index and device tokens stay equal;
  * a stream the linked engine exports installs into JAX's unsplit
    engine, JAX's tp-2 export installs into the linked world, and both
    continuations equal JAX's tokens; a corrupt frame leaves every
    rank as it was (nothing announced);
  * a fault at ``serving.chunk`` before the announce is retried once
    (``tpu_serving_step_retries_total`` 1), as JAX's engine retries it;
  * a world across two hosts refuses all three, with JAX's messages.
"""

import copy
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from container_engine_accelerators_tpu import faults as jfaults  # noqa: E402
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch import faults  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import linksim, sim  # noqa: E402
from container_engine_accelerators_tpu_torch.kvcache import handoff  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

# serve_cli's flags of the world: 16 q heads, 8 kv heads, d_ff 192.
FLAGS = ["--seq-len", "64", "--d-model", "64", "--n-layers", "2",
         "--n-heads", "16", "--vocab-size", "128", "--dtype", "float32"]
SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=16,
             n_kv_heads=8, d_ff=192, max_seq_len=64, dtype="float32")
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16, kv_cache="paged",
              kv_block_size=4)
LINK = ["--continuous-batching", "--kv-cache", "paged", "--kv-block-size",
        "4", "--max-slots", "2", "--decode-chunk", "4", "--prefill-chunk",
        "16", "--link-timeout-s", "120"]
# Repeating prompts, so the ngram proposer has something to propose.
CASES = [([3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5], 9),
         ([7, 8, 9, 7, 8, 9, 7, 8], 7),
         ([11, 12, 13, 14, 15], 6)]
PROMPT = list(range(20, 41))  # 5 full blocks of 4 and one token
NEW = 6
PLAN = [{"kind": "collective_timeout", "site": "serving.chunk", "at": 1}]
TIMEOUT_S = 60.0


def _jax_engine(jmodel, **kw):
    """JAX's paged engine with its device calls made synchronous through
    their seams (its paged engine gives other greedy tokens from run to
    run on the CPU otherwise: tests/test_torch_recovery.py)."""
    jeng = jserve.ContinuousEngine(jmodel, start_loop=False,
                                   **{**ENGINE, **kw})
    for seam in ("_paged_prefill", "_paged_chunk", "_copy_blocks",
                 "_paged_verify"):
        fn = getattr(jeng, seam, None)
        if fn is not None:
            setattr(jeng, seam, lambda *a, _fn=fn, **k:
                    jax.block_until_ready(_fn(*a, **k)))
    threading.Thread(target=jeng._loop_paged, daemon=True).start()
    return jeng


def _corrupt(frames):
    bad = copy.deepcopy(frames)
    block = next(f for f in bad if f["op"] == "BLOCK")
    block["payload"]["tokens"][0] += 1
    return bad


@pytest.fixture(scope="module")
def jax_side():
    """JAX's one-host tp=2 server and its paged engine (one engine, run
    synchronously): its weights, PROMPT's tokens and export, then CASES'
    tokens and the retry count under PLAN. JAX's greedy streams are the
    same with and without speculation (tests/test_torch_spec.py holds
    JAX's speculating engine to them), so these are the reference of the
    port's speculating world too."""
    jcfg = jtf.TransformerConfig(**SHAPE)
    jmodel = jserve.Model(jcfg, tp=2)
    out = {"jcfg": jcfg, "tree": jax.device_get(jmodel.params)}
    jeng = _jax_engine(jmodel, step_retries=2)
    try:
        out["prompt"] = jeng.generate([PROMPT], NEW)[0]
        out["frames"] = jeng.kv_export(PROMPT, timeout_s=TIMEOUT_S)
        jfaults.arm(jfaults.FaultPlan(PLAN))
        try:
            out["tokens"] = [jeng.generate([p], m)[0] for p, m in CASES]
        finally:
            jfaults.disarm()
    finally:
        jeng.shutdown()
    out["retries"] = int(jeng._m_retries.value)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_side):
    """One linked --tp 2 world, four phases: ngram (with --warmup=all and
    an export of PROMPT), draft, install (a corrupt stream, then JAX's),
    and off under PLAN with --step-retries 2."""
    phases = [
        {"argv": LINK + ["--speculate", "ngram", "--warmup", "all"],
         "cases": CASES + [(PROMPT, NEW)], "export": PROMPT},
        {"argv": LINK + ["--speculate", "draft"], "cases": CASES},
        {"argv": LINK, "cases": [],
         "corrupt": _corrupt(jax_side["frames"]),
         "install": jax_side["frames"], "continue": (PROMPT, NEW)},
        {"argv": LINK + ["--step-retries", "2"], "cases": CASES,
         "plan": PLAN},
    ]
    workdir = tmp_path_factory.mktemp("serve_link")
    runs = worker.serve_world(
        {"cfg": SHAPE, "tree": jax_side["tree"], "flags": FLAGS,
         "phases": phases}, str(workdir), scenario="serve_link",
        timeout=300)
    for rank, (rc, out, log) in enumerate(runs):
        assert rc == 0 and out is not None, f"rank {rank}:\n{log[-4000:]}"
    lead, follow = runs[0][1], runs[1][1]
    return dict(zip(("ngram", "draft", "install", "off"), lead["phases"])), \
        follow["states"]


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_linked_world_speculates_with_jax_tokens(world, jax_side, mode):
    phases, _ = world
    got = phases[mode]["tokens"]
    assert got[:len(CASES)] == jax_side["tokens"] == phases["off"]["tokens"]
    if mode == "ngram":
        assert got[-1] == jax_side["prompt"]
    assert phases[mode]["stats"]["spec_verifies"] > 0


def test_every_rank_replays_the_same_state(world):
    phases, states = world
    assert len(states) == 4
    for name, state in zip(("ngram", "draft", "install", "off"), states):
        assert phases[name]["state"] == state, name


def test_linked_export_installs_into_the_jax_unsplit_engine(world, jax_side):
    frames = world[0]["ngram"]["frames"]
    assert [f["op"] for f in frames] == ["HELLO"] + ["BLOCK"] * 5 + \
        ["COMMIT"]
    junsplit = jserve.Model(jax_side["jcfg"])
    junsplit.params = jax.device_put(jax_side["tree"])
    jeng = _jax_engine(junsplit)
    try:
        assert jeng.kv_install(frames, timeout_s=TIMEOUT_S)[
            "installed_blocks"] == 5
        hit0 = jeng.kv_stats()["prefix_hit_tokens"]
        assert jeng.generate([PROMPT], NEW)[0] == jax_side["prompt"]
        assert jeng.kv_stats()["prefix_hit_tokens"] - hit0 >= 20
    finally:
        jeng.shutdown()


def test_jax_tp_export_installs_into_the_linked_world(world, jax_side):
    phase = world[0]["install"]
    assert phase["installed"]["installed_blocks"] == 5
    assert phase["continued"] == jax_side["prompt"]
    assert phase["hit"] >= 20


def test_corrupt_frame_leaves_every_rank_unchanged(world):
    phase = world[0]["install"]
    assert phase["corrupt"].startswith("HandoffDesync")
    # Nothing was announced and rank 0 is as it was; the followers'
    # replayed state equals rank 0's at the phase's end.
    assert phase["corrupt_unchanged"] is True


def test_pre_launch_fault_is_retried_like_jax(world, jax_side):
    phase = world[0]["off"]
    assert phase["retries"] == jax_side["retries"] == 1
    assert phase["tokens"] == jax_side["tokens"]


# -- a world across hosts refuses all three, as JAX's link does ------------------

@pytest.fixture
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def test_world_across_hosts_refuses_with_jax_messages(_disarmed):
    from container_engine_accelerators_tpu.fleet import sim as jsim

    # JAX's engine checks only that a link is present.
    with pytest.raises(ValueError) as jerr:
        jserve.ContinuousEngine(jsim._StubModel(jsim._sim_cfg()),
                                kv_cache="paged", speculate="ngram",
                                link=object(), start_loop=False)
    link = tserve.LockstepEngineLink(
        sim._sim_cfg(), 2, transport=linksim.LoopbackTransport(1),
        rank_hosts=["node-a", "node-b"])
    assert link.spans_hosts
    with pytest.raises(ValueError) as err:
        tserve.ContinuousEngine(sim._StubModel(sim._sim_cfg()),
                                kv_cache="paged", speculate="ngram",
                                link=link, start_loop=False)
    assert str(err.value) == str(jerr.value)
    # The link drill's harness names one node a rank: a world across
    # hosts.
    h = linksim.LinkHarness(n_followers=1, timeout_s=5.0)
    eng = h.engine
    eng.step_retries = 2
    try:
        assert h.link.spans_hosts
        for call in (lambda: eng.kv_export([1, 2, 3, 4, 5]),
                     lambda: eng.kv_install([])):
            with pytest.raises(handoff.HandoffUnsupported,
                               match="multi-host paged engine: KV handoff "
                                     "not supported over the lockstep link"):
                call()
        faults.arm(faults.FaultPlan(PLAN))
        with pytest.raises(RuntimeError, match="decode chunk failed"):
            h.generate([5, 6, 7], 6)
        assert int(eng._m_retries.value) == 0
    finally:
        faults.disarm()
        h.shutdown()


def test_main_keeps_speculation_on_one_host_only(monkeypatch):
    from container_engine_accelerators_tpu_torch.parallel import bootstrap

    env = {bootstrap.WORKER_HOSTNAMES_ENV: "127.0.0.1"}
    assert not tserve.tp_world_spans_hosts(env)
    env[bootstrap.WORKER_HOSTNAMES_ENV] = "host-a,host-b"
    assert tserve.tp_world_spans_hosts(env)
    assert not tserve.tp_world_spans_hosts({})
