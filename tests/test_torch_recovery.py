# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Overload and failure handling on the port's engines (CPU, f32).

The properties of the JAX package's tests/test_serving_recovery.py on
the port's dense and paged ``ContinuousEngine`` (2 slots, decode chunk
4, prefill chunk 16, block 4) serving the tiny model of the other port
tests on the JAX ``init_params`` weights, every served stream equal to
JAX ``Model.generate``'s (tokens exact):

  * bounded admission: a full queue sheds ``QueueFull``, typed and
    counted, and the default stays unbounded; an expired deadline sheds
    at admission, a live one serves;
  * step retries: armed prefill and chunk faults are retried (the retry
    counter equals the faults injected), an exhausted budget fails the
    request and not the engine;
  * drains: in-flight rows migrate losslessly, emit
    ``request_migrated``, keep their TTFT and are never shed by their
    deadline; a drain of an idle engine does nothing; ``ServingDrainer``
    drains on a health transition to Unhealthy;

and the port's own rules for its in-place state: a verify fault is
retried on the speculating engine; no retry after a sync failure, nor
of a chunk once one of its steps was launched; a retried paged chunk
holds the blocks of an unretried one; a drain with syncs pending and a
verify in flight; control calls outside the admission bound. Then the
slice against JAX's ``ContinuousEngine`` on one scripted scenario, the
HTTP surface (429 with the shed reason, a client that hangs up), and
the CLI's defaults and flags.
"""

import functools
import json
import logging
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from container_engine_accelerators_tpu import faults as jfaults  # noqa: E402
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch import faults  # noqa: E402
from container_engine_accelerators_tpu_torch import spec as tspec  # noqa: E402
from container_engine_accelerators_tpu_torch.faults import (  # noqa: E402
    reactor,
)
from container_engine_accelerators_tpu_torch.fleet import (  # noqa: E402
    tenants as tt,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    events as tevents,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--n-layers", "1", "--d-model", "64", "--n-heads", "2",
              "--seq-len", "64", "--vocab-size", "256"]
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
ENGINES = {
    "dense": dict(max_slots=2, chunk=4, prefill_chunk=16),
    "paged": dict(max_slots=2, chunk=4, prefill_chunk=16, kv_block_size=4,
                  kv_cache="paged"),
}
KV = sorted(ENGINES)
# The device seam a decode chunk goes through, and admission, per engine.
CHUNK_SEAM = {"dense": "_chunk", "paged": "_paged_chunk"}
ADMIT = {"dense": "_admit", "paged": "_admit_paged"}
BACKOFF_S = 0.005
TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture(scope="module")
def models():
    """(JAX Model, port Model) on identical weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def expect(models):
    """JAX ``Model.generate``'s greedy row for (prompt, max_new)."""
    jmodel = models[0]

    @functools.lru_cache(maxsize=None)
    def want(prompt, max_new):
        return jmodel.generate([list(prompt)], max_new)[0]

    return lambda prompt, max_new: want(tuple(prompt), max_new)


@pytest.fixture
def engine(models):
    engines = []

    def make(kv, **kwargs):
        kwargs.setdefault("retry_backoff_s", BACKOFF_S)
        eng = tserve.ContinuousEngine(models[1], **ENGINES[kv], **kwargs)
        engines.append(eng)
        return eng

    yield make
    for eng in engines:
        eng.shutdown()


class Request(threading.Thread):
    """``engine.generate(...)`` on a thread of its own: ``out`` or
    ``err`` once joined."""

    def __init__(self, engine, rows, max_new, **kwargs):
        super().__init__(daemon=True)
        self.args = (engine, rows, max_new, kwargs)
        self.out = self.err = None

    def run(self):
        engine, rows, max_new, kwargs = self.args
        try:
            self.out = engine.generate(rows, max_new, **kwargs)
        except Exception as e:  # noqa: BLE001 - read by the test
            self.err = e

    def result(self):
        self.join(TIMEOUT_S)
        assert not self.is_alive(), "request did not finish"
        if self.err is not None:
            raise self.err
        return self.out


def _wait_for(cond, what):
    deadline = time.monotonic() + TIMEOUT_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def _start_loop(eng):
    """Start the loop of an engine built with ``start_loop=False``
    (shutdown() stops it)."""
    eng._thread = threading.Thread(
        target=eng._loop if eng.kv is None else eng._loop_paged,
        daemon=True)
    eng._thread.start()


def _before_first_call(eng, seam, action):
    """Wrap ``eng``'s device seam: ``action()`` runs once, on the loop
    thread, just before the seam's first call."""
    real, done = getattr(eng, seam), []

    def wrapped(*args, **kwargs):
        if not done:
            done.append(1)
            action()
        return real(*args, **kwargs)

    setattr(eng, seam, wrapped)


def _shed_text(eng, reason):
    return (f'tpu_serving_requests_shed_total{{reason="{reason}"}}'
            in eng.registry.render().decode())


# -- bounded admission queue ------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
def test_queue_full_shed_is_typed_and_counted(engine, kv):
    eng = engine(kv, start_loop=False, max_queue=2)
    with pytest.raises(tserve.QueueFull) as err:
        eng.generate([[1], [2], [3]], 4)
    assert err.value.reason == "queue_full"
    assert isinstance(err.value, tserve.ShedError)
    assert eng._q.qsize() == 0  # nothing half-enqueued
    text = eng.registry.render().decode()
    assert ('tpu_serving_requests_shed_total{reason="queue_full"} 3.0'
            in text)


@pytest.mark.parametrize("kv", KV)
def test_unbounded_queue_preserved_by_default(engine, kv):
    eng = engine(kv, start_loop=False)
    assert eng.max_queue == 0 and eng.step_retries == 0
    req = Request(eng, [[1]] * 50, 1)
    req.start()
    _wait_for(lambda: eng._q.qsize() == 50, "50 queued rows")
    eng.shutdown()
    with pytest.raises(RuntimeError, match="engine shut down"):
        req.result()


# -- per-request deadlines --------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
def test_expired_deadline_sheds_at_admission(engine, kv):
    eng = engine(kv, start_loop=False)
    req = Request(eng, [[1, 2]], 4, deadline_s=0.01)
    req.start()
    row = eng._q.get(timeout=TIMEOUT_S)
    time.sleep(0.05)
    getattr(eng, ADMIT[kv])(0, row)
    with pytest.raises(tserve.DeadlineExceeded) as err:
        req.result()
    assert err.value.reason == "deadline"
    assert eng.occupied[0] is None  # the slot was never consumed
    text = eng.registry.render().decode()
    assert 'tpu_serving_requests_shed_total{reason="deadline"} 1.0' in text


@pytest.mark.parametrize("kv", KV)
def test_live_deadline_serves_normally(engine, expect, kv):
    eng = engine(kv, deadline_s=30.0)
    assert eng.generate([[7]], 3) == [expect([7], 3)]
    assert eng.generate([[8, 9]], 3, deadline_s=30.0) == \
        [expect([8, 9], 3)]
    assert not _shed_text(eng, "deadline")
    assert eng._m_queue_wait.count == 2


# -- transient-step retry -----------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
def test_transient_prefill_fault_retried_with_backoff(engine, expect, kv):
    events = tevents.EventStream("serve-test")
    eng = engine(kv, step_retries=1, events=events)
    faults.arm(faults.FaultPlan([
        {"kind": "collective_timeout", "site": "serving.prefill",
         "at": 0, "count": 1},
    ]))
    assert eng.generate([[2, 3]], 4) == [expect([2, 3], 4)]
    assert int(eng._m_retries.value) == 1
    (retry,) = events.events(kind="step_retry")
    assert (retry["phase"], retry["attempt"]) == ("prefill", 1)
    assert BACKOFF_S / 2 <= retry["backoff_s"] <= BACKOFF_S
    assert "injected collective_timeout" in retry["error"]


@pytest.mark.parametrize("kv", KV)
def test_transient_chunk_fault_retried(engine, expect, kv):
    eng = engine(kv, step_retries=2)
    faults.arm(faults.FaultPlan([
        {"kind": "collective_timeout", "site": "serving.chunk",
         "at": 0, "count": 2},
    ]))
    assert eng.generate([[5]], 6) == [expect([5], 6)]
    assert int(eng._m_retries.value) == 2


@pytest.mark.parametrize("kv", KV)
def test_retry_budget_exhausted_fails_request_not_engine(engine, expect,
                                                         kv):
    eng = engine(kv, step_retries=1)
    faults.arm(faults.FaultPlan([
        {"kind": "collective_timeout", "site": "serving.prefill",
         "at": 0, "count": 10},
    ]))
    with pytest.raises(RuntimeError, match="prefill failed"):
        eng.generate([[2]], 2)
    assert int(eng._m_retries.value) == 1
    faults.disarm()
    assert eng.generate([[2]], 2) == [expect([2], 2)]  # still serves
    assert eng.stats()["occupied_slots"] == 0


@pytest.mark.parametrize("kv", KV)
def test_dense_and_paged_segments_retry_a_dispatch_error(engine, expect,
                                                         kv):
    """A long prompt's segment that raises at dispatch is retried (a
    dense segment has no fault site, as in JAX: its seam raises)."""
    eng = engine(kv, step_retries=1)
    seam = "_prefill_seg" if kv == "dense" else "_paged_prefill"
    real, raised = getattr(eng, seam), []

    def failing_once(*args, **kwargs):
        if not raised:
            raised.append(1)
            raise RuntimeError("transient segment error")
        return real(*args, **kwargs)

    setattr(eng, seam, failing_once)
    prompt = list(range(1, 30))
    assert eng.generate([prompt], 5) == [expect(prompt, 5)]
    assert int(eng._m_retries.value) == 1


# -- the port's in-place state ----------------------------------------------------

@pytest.mark.parametrize("kv", KV)
def test_no_retry_after_a_sync_failure(engine, expect, kv):
    """A device error that surfaces at a sync resets the engine and is
    never retried, whatever the budget."""
    eng = engine(kv, step_retries=3)
    to_host, failed = eng._to_host, []

    class Faulted:
        def numpy(self):
            raise RuntimeError("injected sync fault")

        __int__ = numpy

    def to_host_failing_at_the_chunk(tensor):
        if not failed and tensor.dim() == 2:  # a chunk's tokens
            failed.append(1)
            return Faulted(), None
        return to_host(tensor)

    eng._to_host = to_host_failing_at_the_chunk
    with pytest.raises(RuntimeError, match="sync failed"):
        eng.generate([[1, 2, 3]], 6)
    assert int(eng._m_retries.value) == 0
    assert eng.generate([[4, 5, 6]], 6) == [expect([4, 5, 6], 6)]


@pytest.mark.parametrize("kv", KV)
def test_chunk_failed_after_a_launch_is_not_retried(engine, expect, kv):
    """A chunk whose steps were launched (the step state advanced in
    place) fails its rows instead of retrying; the engine serves on."""
    eng = engine(kv, step_retries=3)
    graphs = eng.chunk_graphs if kv == "dense" else eng.decode_graphs
    real, raised = getattr(eng, CHUNK_SEAM[kv]), []

    def launch_then_raise(*args, **kwargs):
        out = real(*args, **kwargs)
        if not raised:
            raised.append(graphs.launched)
            raise RuntimeError("error after the launch")
        return out

    setattr(eng, CHUNK_SEAM[kv], launch_then_raise)
    with pytest.raises(RuntimeError, match="decode chunk failed"):
        eng.generate([[1, 2, 3]], 6)
    assert raised[0] > 0 and int(eng._m_retries.value) == 0
    assert eng.generate([[4, 5, 6]], 6) == [expect([4, 5, 6], 6)]


def test_retried_paged_chunk_holds_the_blocks_of_an_unretried_one(
        engine, expect):
    """Allocation and copy-on-write run once before the retries: a run
    with two retried chunk faults ends with the pool of a run without."""
    prompts = [list(range(3, 14)), list(range(3, 10)) + [40, 41]]
    stats = []
    for plan in ([], [{"kind": "collective_timeout",
                       "site": "serving.chunk", "at": 1, "count": 2}]):
        eng = engine("paged", step_retries=2)
        faults.arm(faults.FaultPlan(plan))
        for p in prompts:
            assert eng.generate([p], 9) == [expect(p, 9)]
        faults.disarm()
        stats.append((eng.kv_stats(), int(eng._m_retries.value)))
    (plain, zero), (retried, two) = stats
    assert (zero, two) == (0, 2)
    assert retried == plain


# -- speculation ------------------------------------------------------------------

class _Oracle(tspec.Proposer):
    """Proposes the true continuation (``truth``: prompt tuple -> the
    full greedy sequence)."""

    source = "oracle"

    def __init__(self, truth):
        self.truth, self.ctx = truth, {}

    def admit(self, slot, ctx):
        self.ctx[slot] = list(ctx)

    def observe(self, slot, tokens):
        if slot in self.ctx:
            self.ctx[slot].extend(int(t) for t in tokens)

    def propose(self, slot, k):
        ctx = self.ctx.get(slot)
        if ctx is None:
            return []
        full = next(seq for p, seq in self.truth.items()
                    if ctx[:len(p)] == list(p))
        return full[len(ctx):len(ctx) + k]

    def release(self, slot):
        self.ctx.pop(slot, None)


def _spec_engine(engine, expect, prompts, max_new, **kwargs):
    truth = {tuple(p): expect(p, max_new) for p in prompts}
    return engine("paged", speculate="ngram", spec_proposer=_Oracle(truth),
                  **kwargs)


def test_verify_fault_retried_on_the_speculating_engine(engine, expect):
    prompt = list(range(50, 60))
    eng = _spec_engine(engine, expect, [prompt], 12, step_retries=1)
    faults.arm(faults.FaultPlan([
        {"kind": "collective_timeout", "site": "serving.verify",
         "at": 0, "count": 1},
    ]))
    assert eng.generate([prompt], 12) == [expect(prompt, 12)]
    assert int(eng._m_retries.value) == 1
    assert eng.stats()["spec_verifies"] > 0


def test_drain_with_syncs_pending_and_a_verify_in_flight(engine, expect):
    """A drain requested as a verify dispatches: the loop syncs the
    pending records, then migrates; the in-flight verify's record is
    voided (the row's bumped sync generation) and the re-prefill
    regenerates its tokens."""
    prompts = [list(range(50, 60)), list(range(70, 79))]
    eng = _spec_engine(engine, expect, prompts, 16)
    seen = {}

    def drain_now():
        seen["pending_syncs"] = len(eng._pending_syncs)
        seen["targeted"] = eng.drain(reason="test")

    _before_first_call(eng, "_paged_verify", drain_now)
    apply = eng._apply_drains

    def apply_recording():
        if eng._drain_requests:
            seen["verifies_in_flight"] = len(eng._spec_pending)
        apply()

    eng._apply_drains = apply_recording
    reqs = [Request(eng, [p], 16) for p in prompts]
    for r in reqs:
        r.start()
    outs = [r.result()[0] for r in reqs]
    assert outs == [expect(p, 16) for p in prompts]
    assert seen["verifies_in_flight"] >= 1
    assert int(eng._m_migrated.value) == seen["targeted"] >= 1
    assert not eng._spec_owner and eng.stats()["occupied_slots"] == 0
    kv = eng.kv_stats()
    assert kv["free_blocks"] + kv["cached_blocks"] == kv["total_blocks"]


# -- drain / migration ----------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
def test_drain_migrates_in_flight_requests_losslessly(engine, expect, kv):
    events = tevents.EventStream("serve-test")
    eng = engine(kv, events=events)
    prompts = [[9, 10], [11, 12, 13]]
    targeted = []
    _before_first_call(eng, CHUNK_SEAM[kv], lambda: targeted.append(
        eng.drain(reason="test chip unhealthy")))
    # Greedy decode of the same context: the migrated streams equal
    # undisturbed ones.
    assert eng.generate(prompts, 24) == [expect(p, 24) for p in prompts]
    occupied = targeted[0]
    assert occupied >= 1 and int(eng._m_migrated.value) == occupied
    migrated = events.events(kind="request_migrated")
    assert len(migrated) == occupied
    assert {m["reason"] for m in migrated} == {"test chip unhealthy"}
    assert migrated[0]["severity"] == "warning"
    replayed = events.events(kind="migration_replayed")
    assert len(replayed) == occupied
    assert all(r["lost_s"] > 0 for r in replayed)
    assert eng.stats()["occupied_slots"] == 0


@pytest.mark.parametrize("kv", KV)
def test_drain_idle_engine_is_a_noop(engine, expect, kv):
    eng = engine(kv)
    assert eng.drain() == 0
    assert eng.generate([[4]], 2) == [expect([4], 2)]
    assert int(eng._m_migrated.value) == 0


@pytest.mark.parametrize("kv", KV)
def test_migrated_row_keeps_its_ttft_and_is_never_deadline_shed(
        engine, expect, kv):
    """A row drained after its first token, past its deadline, is
    re-admitted (its decode state is paid for) and keeps the TTFT of its
    first slot."""
    events = tevents.EventStream("serve-test")
    eng = engine(kv, deadline_s=0.05, events=events)

    def late_drain():
        time.sleep(0.1)
        eng.drain()

    _before_first_call(eng, CHUNK_SEAM[kv], late_drain)
    assert eng.generate([[21, 22, 23]], 12) == [expect([21, 22, 23], 12)]
    assert int(eng._m_migrated.value) == 1
    assert not _shed_text(eng, "deadline")
    assert len(eng.ttft_s) == 1
    assert len(events.events(kind="migration_replayed")) == 1
    assert not events.events(kind="request_shed")


@pytest.mark.parametrize("kv", KV)
def test_serving_drainer_reacts_to_health_event(engine, expect, kv):
    eng = engine(kv)
    drainer = reactor.ServingDrainer(eng)
    _before_first_call(eng, CHUNK_SEAM[kv], lambda: drainer.process({
        "kind": "health_transition", "to": reactor.UNHEALTHY,
        "tpu": "accel0"}))
    assert eng.generate([[6]], 24) == [expect([6], 24)]
    assert int(eng._m_migrated.value) == 1


@pytest.mark.parametrize("kv", KV)
def test_control_calls_are_not_counted_against_max_queue(engine, expect,
                                                         kv):
    """A ``run_on_loop`` call waits in its own queue: it never counts
    toward the admission bound, and it runs while requests wait."""
    eng = engine(kv, max_queue=1)
    release, running = threading.Event(), threading.Event()

    def hold():
        running.set()
        release.wait(TIMEOUT_S)
        return "held"

    holder = threading.Thread(
        target=lambda: eng.run_on_loop(hold), daemon=True)
    holder.start()
    running.wait(TIMEOUT_S)
    second = []
    waiter = threading.Thread(
        target=lambda: second.append(eng.run_on_loop(lambda: 7)),
        daemon=True)
    waiter.start()
    _wait_for(lambda: eng._calls.qsize() == 1, "the queued control call")
    req = Request(eng, [[3, 4]], 4)
    req.start()
    _wait_for(lambda: eng._q.qsize() == 1, "the queued request")
    assert eng.stats()["queue_depth"] == 1
    with pytest.raises(tserve.QueueFull):
        eng.generate([[5]], 4)
    release.set()
    assert req.result() == [expect([3, 4], 4)]
    waiter.join(TIMEOUT_S)
    assert second == [7]


# -- the slice against JAX ------------------------------------------------------

# (prompt, deadline_s) of each request, in arrival order; max_queue 4.
SCENARIO = [
    ([5, 17, 42, 8, 99], 0.001),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9], None),
    ([200, 100, 50, 25, 12, 6, 3, 1, 30, 60, 90, 120], None),
    (list(range(40, 60)), None),
    ([7, 7, 7, 7, 7, 7, 7], None),
    ([8, 9, 10, 11, 12, 13, 14, 15], None),
]
SCENARIO_NEW = 10
SCENARIO_PLAN = [
    {"kind": "collective_timeout", "site": "serving.prefill", "at": 0},
    {"kind": "collective_timeout", "site": "serving.chunk", "at": 1},
]


def _synchronous(fn):
    return lambda *args, **kwargs: jax.block_until_ready(fn(*args, **kwargs))


def _run_scenario(serve_mod, faults_mod, eng, start, seam):
    """A bounded queue (4) and a burst of six requests: the first four
    queue (the first with a deadline of 1 ms) while the loop is stopped,
    the last two shed at the door; then the loop starts, past the first
    request's deadline, with one prefill fault and one chunk fault armed
    and a drain just before the first chunk. Returns (each request's
    shed reason or tokens, retries, migrations)."""
    faults_mod.arm(faults_mod.FaultPlan(SCENARIO_PLAN))
    _before_first_call(eng, seam, eng.drain)
    reqs = []
    for i, (prompt, deadline) in enumerate(SCENARIO[:4]):
        reqs.append(Request(eng, [prompt], SCENARIO_NEW, deadline_s=deadline))
        reqs[-1].start()
        _wait_for(lambda n=i + 1: eng._q.qsize() == n, "the enqueue")
    outcomes = []
    for prompt, deadline in SCENARIO[4:]:
        with pytest.raises(serve_mod.ShedError) as err:
            eng.generate([prompt], SCENARIO_NEW, deadline_s=deadline)
        outcomes.append(err.value.reason)
    time.sleep(0.02)  # the first request's deadline passes in the queue
    start()
    served = []
    for r in reqs:
        r.join(TIMEOUT_S)
        assert not r.is_alive()
        served.append(r.err.reason if isinstance(r.err, serve_mod.ShedError)
                      else r.out[0])
    faults_mod.disarm()
    return (served + outcomes, int(eng._m_retries.value),
            int(eng._m_migrated.value))


@pytest.mark.parametrize("kv", KV)
def test_scenario_matches_jax_engine(models, engine, expect, kv):
    """The same scenario through JAX's ``ContinuousEngine`` and the
    port's: the same shed reason per request, the same tokens for every
    served row (exact, f32), and the same retry and migration counts."""
    jmodel, _ = models
    kw = dict(ENGINES[kv], max_queue=4, step_retries=1,
              retry_backoff_s=BACKOFF_S)
    jeng = jserve.ContinuousEngine(jmodel, start_loop=False, **kw)
    jloop = jeng._loop if kv == "dense" else jeng._loop_paged
    if kv == "paged":
        # JAX's paged loop advances host arrays (positions, page tables)
        # right after an asynchronous dispatch; on the CPU backend
        # jnp.asarray may alias them, so a call can read the advanced
        # values. Its device calls are made synchronous here, through
        # their seams, so the reference is deterministic.
        for seam in ("_paged_prefill", "_paged_chunk", "_copy_blocks"):
            setattr(jeng, seam, _synchronous(getattr(jeng, seam)))
    want = _run_scenario(
        jserve, jfaults, jeng,
        lambda: threading.Thread(target=jloop, daemon=True).start(),
        CHUNK_SEAM[kv])
    eng = engine(kv, start_loop=False, max_queue=4, step_retries=1)
    got = _run_scenario(tserve, faults, eng, lambda: _start_loop(eng),
                        CHUNK_SEAM[kv])
    assert got == want
    outcomes, retries, migrated = got
    assert outcomes[0] == "deadline" and outcomes[4:] == ["queue_full"] * 2
    assert outcomes[1:4] == [expect(p, SCENARIO_NEW)
                             for p, _ in SCENARIO[1:4]]
    # The deadline shed spent slot 0's admission of the first iteration,
    # as in JAX: one row decodes at the first chunk, and migrates.
    assert retries == 2 and migrated == 1


# -- HTTP --------------------------------------------------------------------------

def _post(port, body, headers=None, timeout=TIMEOUT_S):
    """POST /generate: (status, decoded body)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def server():
    servers = []

    def start(eng):
        srv, state = tserve.start_server(eng, port=0, host="127.0.0.1")
        servers.append(srv)
        tserve.wait_ready(state, timeout=TIMEOUT_S)
        return srv.server_address[1]

    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _hold_loop(eng):
    """Occupy the engine loop with a control call until the returned
    event is set."""
    release, running = threading.Event(), threading.Event()

    def hold():
        running.set()
        release.wait(TIMEOUT_S)

    threading.Thread(target=lambda: eng.run_on_loop(hold),
                     daemon=True).start()
    running.wait(TIMEOUT_S)
    return release


@pytest.mark.parametrize("kv", KV)
def test_http_full_queue_answers_429_with_its_reason(engine, server, expect,
                                                     kv):
    eng = engine(kv, max_queue=1)
    port = server(eng)
    release = _hold_loop(eng)
    first = []
    waiter = threading.Thread(target=lambda: first.append(_post(
        port, {"tokens": [[3, 1, 4]], "max_new_tokens": 4})), daemon=True)
    waiter.start()
    _wait_for(lambda: eng._q.qsize() == 1, "the queued request")
    code, body = _post(port, {"tokens": [[2, 7]], "max_new_tokens": 4})
    assert code == 429 and body["shed"] == "queue_full"
    assert "admission queue full" in body["error"] and "tenant" not in body
    release.set()
    waiter.join(TIMEOUT_S)
    assert first[0][0] == 200
    assert first[0][1]["tokens"] == [expect([3, 1, 4], 4)]


def test_http_burst_of_concurrent_clients_all_reach_admission(engine,
                                                              server):
    """64 clients posting at once while the loop is held: every request
    is queued (none reset in the listen backlog), then every one served."""
    eng = engine("dense")
    port = server(eng)
    release = _hold_loop(eng)
    n = 64
    start = threading.Barrier(n)
    results = [None] * n

    def post(i):
        start.wait()
        results[i] = _post(port, {"tokens": [[1 + i % 7, 2]],
                                  "max_new_tokens": 1})

    threads = [threading.Thread(target=post, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    _wait_for(lambda: eng._q.qsize() == n, "every request queued")
    release.set()
    for t in threads:
        t.join(TIMEOUT_S)
    assert [r[0] for r in results] == [200] * n


def test_http_deadline_and_tenant_sheds_name_them(engine, server):
    tc = tt.TenantClasses.from_dict({
        "a": {"priority": 0, "queue_share": 0.75},
        "b": {"priority": 1, "queue_share": 0.25},
    })
    eng = engine("dense", max_queue=4, tenants=tc)
    port = server(eng)
    code, body = _post(port, {"tokens": [[1], [2]], "max_new_tokens": 2},
                       headers={"X-Tenant-Class": "b"})
    assert code == 429
    assert (body["shed"], body["tenant"]) == ("class_share", "b")
    release = _hold_loop(eng)
    late = []
    waiter = threading.Thread(target=lambda: late.append(_post(
        port, {"tokens": [[5, 6]], "max_new_tokens": 2, "deadline_s": 0.001,
               "tenant": "a"})), daemon=True)
    waiter.start()
    _wait_for(lambda: eng._q.qsize() == 1, "the queued request")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        health = json.loads(r.read())
    assert health["tenant_queues"] == {"a": 1, "b": 0}
    time.sleep(0.01)
    release.set()
    waiter.join(TIMEOUT_S)
    code, body = late[0]
    assert code == 429 and body["shed"] == "deadline" and "tenant" not in body


def test_http_client_hang_up_is_no_failure(engine, server, expect, caplog):
    """A client that closes its socket (with a reset) before the response
    is written leaves the server serving; the request is logged as a
    disconnect, not as a failed generate."""
    eng = engine("dense")
    port = server(eng)
    release = _hold_loop(eng)
    body = json.dumps({"tokens": [[4, 4, 4]], "max_new_tokens": 3}).encode()
    with caplog.at_level(logging.INFO, logger="serve_cli"):
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=TIMEOUT_S)
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: " + str(len(body)).encode()
                     + b"\r\n\r\n" + body)
        _wait_for(lambda: eng._q.qsize() == 1, "the queued request")
        # Close with a reset: the server's response write then fails.
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
        release.set()
        _wait_for(lambda: "client disconnected" in caplog.text,
                  "the disconnect log line")
        code, resp = _post(port, {"tokens": [[4, 4, 4]],
                                  "max_new_tokens": 3})
    assert code == 200 and resp["tokens"] == [expect([4, 4, 4], 3)]
    assert "generate failed" not in caplog.text


# -- the CLI ---------------------------------------------------------------------

def test_cli_engine_defaults_are_jax_s(monkeypatch):
    """``--continuous-batching`` builds the engine with the JAX server's
    defaults: --max-queue 256, --step-retries 1, no deadline, no tenant
    classes, no event log."""
    built = []

    class Stop(Exception):
        pass

    def capture(model, **kwargs):
        built.append(model)
        raise Stop

    monkeypatch.setattr(tserve, "start_server", capture)
    with pytest.raises(Stop):
        tserve.main(["--continuous-batching", "--device", "cpu",
                     "--port", "0", *TINY_FLAGS])
    (eng,) = built
    try:
        assert (eng.max_queue, eng.step_retries, eng.deadline_s) == \
            (256, 1, 0.0)
        assert eng.tenants is None and eng.events is None
        assert eng.retry_backoff_s == 0.05
    finally:
        eng.shutdown()


def test_cli_fault_plan_retries_and_logs_events(tmp_path):
    """``--fault-plan`` arms the port's plan before the server starts;
    with the default one retry the armed chunk fault is retried, the
    request served, and the event log holds the injection and the
    retry."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"kind": "collective_timeout", "site": "serving.chunk", "at": 0}]}))
    log_path = tmp_path / "events.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", "--continuous-batching",
         "--fault-plan", str(plan), "--event-log", str(log_path),
         *TINY_FLAGS],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["tokens"][0][:2] == [5, 6]
    records = [json.loads(line) for line in log_path.read_text().splitlines()]
    kinds = [(r["source"], r["kind"]) for r in records]
    assert ("faults", "fault_injected") in kinds
    assert ("serve", "step_retry") in kinds
    assert "fault plan armed" in proc.stderr


def test_cli_tenant_classes_flag_reaches_the_engine(monkeypatch, tmp_path):
    built = []

    class Stop(Exception):
        pass

    def capture(model, **kwargs):
        built.append(model)
        raise Stop

    classes = tmp_path / "classes.json"
    classes.write_text('{"a": {"queue_share": 0.75}, "b": '
                       '{"queue_share": 0.25}}')
    monkeypatch.setattr(tserve, "start_server", capture)
    with pytest.raises(Stop):
        tserve.main(["--continuous-batching", "--device", "cpu",
                     "--port", "0", "--kv-cache", "paged",
                     "--tenant-classes", str(classes), "--max-queue", "8",
                     "--request-deadline-s", "2.5", "--step-retries", "3",
                     *TINY_FLAGS])
    (eng,) = built
    try:
        assert eng.tenants.names() == ["a", "b"]
        assert (eng.max_queue, eng.deadline_s, eng.step_retries) == \
            (8, 2.5, 3)
        assert eng.stats()["tenant_queues"] == {"a": 0, "b": 0}
    finally:
        eng.shutdown()
