# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's copy of ``fleet/tenants.py`` against the JAX package's,
and tenant admission on the port's engines (CPU, f32, exact).

  * ``TenantClasses.from_dict`` / ``from_flag``: the same classes and
    resolutions, and the same errors, on the configs of the JAX tests;
  * ``TenantQueue``: the same pop order and depths over a seeded
    sequence of puts and gets;
  * token buckets: the same admits and levels over a seeded sequence of
    consumes on an injected clock;
  * the engine, dense and paged (2 slots, the tiny model of the other
    port tests on the JAX ``init_params`` weights): a quota shed names
    its class, emits ``tenant_shed`` and counts under JAX's instrument
    names; a class's share bounds its slice of the queue while another
    class is served, tokens equal to JAX ``Model.generate``'s.
"""

import concurrent.futures
import functools
import queue
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from container_engine_accelerators_tpu.fleet import tenants as jt  # noqa: E402
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
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

SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
ENGINES = {
    "dense": dict(max_slots=2, chunk=4, prefill_chunk=16),
    "paged": dict(max_slots=2, chunk=4, prefill_chunk=16, kv_block_size=4,
                  kv_cache="paged"),
}
THREE = {
    "premium": {"priority": 0, "queue_share": 0.5},
    "standard": {"priority": 1, "queue_share": 0.3},
    "batch": {"priority": 2, "queue_share": 0.2,
              "rate_tokens_per_s": 10.0, "burst_tokens": 20.0,
              "default": True},
}
GOOD = {
    "three": THREE,
    "lowest_priority_default": {
        "hi": {"priority": 0, "queue_share": 0.5},
        "lo": {"priority": 9, "queue_share": 0.5},
    },
    "one": {"a": {"queue_share": 1.0}},
    "implied_shares": {"x": {}, "y": {"priority": 3},
                       "z": {"rate_tokens_per_s": 5}},
}
BAD = {
    "empty": ({}, "at least one"),
    "over_one": ({"a": {"queue_share": 0.8}, "b": {"queue_share": 0.8}},
                 "sum"),
    "unknown_key": ({"a": {"qshare": 1.0}}, "unknown keys"),
    "two_defaults": ({"a": {"queue_share": 0.4, "default": True},
                      "b": {"queue_share": 0.4, "default": True}},
                     "one tenant class"),
    "too_many": ({f"c{i}": {"queue_share": 1.0 / 32}
                  for i in range(jt.MAX_CLASSES + 1)}, "caps the enum"),
    "not_an_object": ({"a": 1.0}, "must be an object"),
    "zero_share": ({"a": {"queue_share": 0.0}}, "must be > 0"),
}


def _classes(tc):
    return {n: (c.priority, c.queue_share, c.rate, c.burst, c.default)
            for n, c in tc.classes.items()}


@pytest.mark.parametrize("name", sorted(GOOD))
def test_parse_and_resolve_match_jax(name):
    want = jt.TenantClasses.from_dict(GOOD[name])
    got = tt.TenantClasses.from_dict(GOOD[name])
    assert got.names() == want.names()
    assert _classes(got) == _classes(want)
    for tenant in [None, "", "stranger", *GOOD[name]]:
        assert got.resolve(tenant).name == want.resolve(tenant).name


@pytest.mark.parametrize("name", sorted(BAD))
def test_parse_errors_match_jax(name):
    config, match = BAD[name]
    with pytest.raises(ValueError, match=match) as want:
        jt.TenantClasses.from_dict(config)
    with pytest.raises(ValueError, match=match) as got:
        tt.TenantClasses.from_dict(config)
    assert str(got.value) == str(want.value)


def test_from_flag_inline_file_and_empty(tmp_path):
    assert tt.TenantClasses.from_flag("") is None
    inline = '{"a": {"queue_share": 1.0}}'
    assert tt.TenantClasses.from_flag(inline).names() == \
        jt.TenantClasses.from_flag(inline).names() == ["a"]
    path = tmp_path / "classes.json"
    path.write_text('{"b": {"queue_share": 1.0}}')
    assert tt.TenantClasses.from_flag(str(path)).names() == ["b"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_queue_pops_in_jax_order(seed):
    config = {"a": {"priority": 0, "queue_share": 0.6},
              "b": {"priority": 1, "queue_share": 0.2, "default": True},
              "c": {"priority": 2, "queue_share": 0.2}}
    jq = jt.TenantQueue(jt.TenantClasses.from_dict(config))
    tq = tt.TenantQueue(tt.TenantClasses.from_dict(config))
    for q in (jq, tq):
        with pytest.raises(queue.Empty):
            q.get_nowait()
    rng = np.random.default_rng(seed)
    want, got = [], []
    for i in range(300):
        if rng.random() < 0.55:
            row = {"tenant": str(rng.choice(["a", "b", "c", "who"])),
                   "i": i}
            jq.put(dict(row))
            tq.put(dict(row))
            continue
        for q, out in ((jq, want), (tq, got)):
            try:
                out.append(q.get_nowait()["i"])
            except queue.Empty:
                out.append(None)
        assert tq.depths() == jq.depths()
        assert tq.qsize() == jq.qsize()
    assert got == want
    assert any(i is not None for i in got)


@pytest.mark.parametrize("seed", [0, 1])
def test_quota_consumes_and_refills_as_jax_on_the_clock(seed):
    clock = [0.0]
    jc = jt.TenantClasses.from_dict(THREE, clock=lambda: clock[0])
    tc = tt.TenantClasses.from_dict(THREE, clock=lambda: clock[0])
    rng = np.random.default_rng(seed)
    results = []
    for _ in range(200):
        clock[0] += float(rng.choice([0.0, 0.0, 0.1, 0.5, 2.0]))
        name = str(rng.choice(["batch", "premium"]))
        n = int(rng.integers(1, 12))
        got, want = tc.try_consume(name, n), jc.try_consume(name, n)
        assert got == want
        assert tc.quota_level(name) == jc.quota_level(name)
        results.append(got)
    assert True in results and False in results


# -- engine integration -----------------------------------------------------------

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
    jmodel = models[0]

    @functools.lru_cache(maxsize=None)
    def want(prompt, max_new):
        return jmodel.generate([list(prompt)], max_new)[0]

    return lambda prompt, max_new: want(tuple(prompt), max_new)


@pytest.fixture
def engine(models):
    engines = []

    def make(kv, **kwargs):
        eng = tserve.ContinuousEngine(models[1], **ENGINES[kv], **kwargs)
        engines.append(eng)
        return eng

    yield make
    for eng in engines:
        eng.shutdown()


@pytest.mark.parametrize("kv", sorted(ENGINES))
def test_engine_quota_shed_names_tenant_and_emits_event(engine, expect, kv):
    clock = [0.0]
    tc = tt.TenantClasses.from_dict(THREE, clock=lambda: clock[0])
    events = tevents.EventStream("serve-test")
    eng = engine(kv, tenants=tc, max_queue=8, events=events)
    for _ in range(5):
        assert eng.generate([[1, 2]], 4, tenant="batch") == \
            [expect([1, 2], 4)]
    with pytest.raises(tserve.QuotaExceeded) as exc:
        eng.generate([[1, 2]], 4, tenant="batch")
    assert exc.value.tenant == "batch" and exc.value.reason == "quota"
    # Other classes keep serving; unknown tenants map to the default
    # class (batch) and so shed too.
    assert eng.generate([[1, 2]], 4, tenant="premium") == \
        [expect([1, 2], 4)]
    with pytest.raises(tserve.QuotaExceeded):
        eng.generate([[1, 2]], 4, tenant="who-is-this")
    shed = events.events(kind="tenant_shed")
    assert [(e["tenant_class"], e["reason"], e["rows"]) for e in shed] == \
        [("batch", "quota", 1)] * 2
    assert not events.events(kind="request_shed")
    text = eng.registry.render().decode()
    assert ('tpu_serving_tenant_shed_total{tenant_class="batch",'
            'reason="quota"} 2.0') in text
    assert 'tpu_serving_requests_shed_total{reason="quota"} 2.0' in text
    assert eng.stats()["tenant_queues"] == {"batch": 0, "premium": 0,
                                            "standard": 0}


@pytest.mark.parametrize("kv", sorted(ENGINES))
def test_engine_class_share_bounds_the_queue_slice(engine, expect, kv):
    tc = tt.TenantClasses.from_dict({
        "gold": {"priority": 0, "queue_share": 0.5},
        "bulk": {"priority": 1, "queue_share": 0.25, "default": True},
    })
    eng = engine(kv, tenants=tc, max_queue=8)
    # bulk's slice: 0.25 * 8 = 2 queued rows; a 3-row request overruns
    # it at the door while gold's headroom is untouched.
    with pytest.raises(tserve.ClassShareExceeded) as exc:
        eng.generate([[1], [2], [3]], 2, tenant="bulk")
    assert exc.value.tenant == "bulk" and exc.value.reason == "class_share"
    assert eng.generate([[1, 2]], 2, tenant="gold") == [expect([1, 2], 2)]
    assert eng.generate([[4], [5]], 2, tenant="bulk") == \
        [expect([4], 2), expect([5], 2)]
    text = eng.registry.render().decode()
    assert ('tpu_serving_tenant_shed_total{tenant_class="bulk",'
            'reason="class_share"} 3.0') in text


@pytest.mark.parametrize("kv", sorted(ENGINES))
def test_engine_concurrent_burst_keeps_each_class_in_its_share(
        engine, expect, kv, monkeypatch):
    """Twelve requests posted at once while the loop is held (4 of
    class a, share 0.75, then 8 of class b, share 0.25, max_queue 8):
    b queues its 2 rows and sheds the other 6 as ``class_share``, a
    queues all 4, and nothing is shed as ``queue_full``. A sleep in the
    share check lets the handlers interleave there, as a loaded host
    does."""
    tc = tt.TenantClasses.from_dict({"a": {"priority": 0,
                                           "queue_share": 0.75},
                                     "b": {"priority": 1,
                                           "queue_share": 0.25}})
    eng = engine(kv, tenants=tc, max_queue=8)
    depth = eng._q.depth

    def slow_depth(name):
        got = depth(name)
        time.sleep(0.01)
        return got

    monkeypatch.setattr(eng._q, "depth", slow_depth)
    classes = ["a"] * 4 + ["b"] * 8
    prompts = [[i + 1, i + 2] for i in range(len(classes))]
    release, running = threading.Event(), threading.Event()
    holder = threading.Thread(target=lambda: eng.run_on_loop(
        lambda: (running.set(), release.wait(60))))
    holder.start()
    assert running.wait(60)
    start = threading.Barrier(len(classes))

    def post(i):
        start.wait()
        try:
            return eng.generate([prompts[i]], 2, tenant=classes[i])
        except tserve.ShedError as e:
            return e.reason

    try:
        with concurrent.futures.ThreadPoolExecutor(len(classes)) as pool:
            futures = [pool.submit(post, i) for i in range(len(classes))]
            deadline = time.monotonic() + 60
            while eng._q.qsize() + sum(
                    f.done() for f in futures) < len(classes):
                assert time.monotonic() < deadline
                time.sleep(0.002)
            depths = eng.stats()["tenant_queues"]
            release.set()
            results = [f.result(60) for f in futures]
    finally:
        release.set()
        holder.join(60)
    assert depths == {"a": 4, "b": 2}
    assert results[:4] == [[expect(p, 2)] for p in prompts[:4]]
    served = [(p, r) for p, r in zip(prompts[4:], results[4:])
              if r != "class_share"]
    assert len(served) == 2
    assert [r for _, r in served] == [[expect(p, 2)] for p, _ in served]
