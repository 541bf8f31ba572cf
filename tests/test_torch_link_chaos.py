# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's lockstep engine link and its chaos drill (fake-device ranks).

Twins of ``tests/test_link_chaos.py`` on the port's ``fleet/linksim.py``,
``models/serve_cli.py`` link and engines:

  * leader and follower ranks over the loopback link serve greedy outputs
    equal to the single-rank paged engine, radix-hit re-admissions
    included, and every follower's replayed page tables, pool and device
    token vector equal the leader's;
  * a killed follower never blocks the leader past the link timeout:
    ``link_wedged{rank, op_seq}`` fires, the goodput ledger charges the
    stall to badput, and a bounded restart re-joins the rank;
  * a corrupted or dropped broadcast is detected (digest / op_seq) as
    ``link_desync`` and the follower aborts before dispatching;
  * bring-up config drift fails by name (``LinkConfigMismatch``);
  * the link's hooks cost nothing when disarmed, and the watchdog does
    not exist at ``timeout_s=0``.

The drill's verdict is held to the JAX package's ``run_link_drill`` at
the same ``CHAOS_SEED`` on its structural fields.
"""

import os
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu.fleet import (  # noqa: E402
    linksim as jlinksim,
)
from container_engine_accelerators_tpu.obs import lint as obs_lint  # noqa: E402
from container_engine_accelerators_tpu_torch import faults  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import (  # noqa: E402
    linksim,
    sim,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli,
)
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    goodput as obs_goodput,
)

SEED = int(os.environ.get("CHAOS_SEED", "0"))
TAG = f"(chaos seed={SEED}; rerun with CHAOS_SEED={SEED})"

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def make_harness(n_followers=2, timeout_s=0.5, **kw):
    return linksim.LinkHarness(
        n_followers=n_followers, timeout_s=timeout_s, **kw
    )


# -- the tier-1 drill twin ----------------------------------------------------

@pytest.fixture(scope="module")
def verdicts():
    """The port's and the JAX package's drill verdicts at SEED."""
    faults.disarm()
    port = linksim.run_link_drill(requests=8, seed=SEED)
    jax_verdict = jlinksim.run_link_drill(requests=8, seed=SEED)
    return port, jax_verdict


def test_link_chaos_drill_tier1_twin(verdicts):
    """Every phase (byte identity, follower kill + reactor + restart,
    corrupt broadcast, leader stall) must pass."""
    verdict, _ = verdicts
    assert verdict["pass"], "\n".join(verdict["failures"])
    assert verdict["link"]["wedges"] >= 2, (verdict, TAG)
    assert verdict["link"]["desyncs"] >= 1, (verdict, TAG)
    assert verdict["radix_hit_tokens"] > 0, (verdict, TAG)
    assert verdict["badput_wedged_s"] > 0, (verdict, TAG)


def test_drill_verdict_agrees_with_jax_s(verdicts):
    """The structural fields of the two packages' verdicts at one seed:
    both pass (cordon and re-place included), the same radix-hit tokens,
    restarts and final rank outcomes, and each reaches the wedge, desync
    and badput floors. The wedge and desync counts themselves may differ
    with host timing (a watchdog backstop's observer report)."""
    port, want = verdicts
    assert port["pass"] and want["pass"], (port, want)
    for key in ("radix_hit_tokens", "restarts", "rank_outcomes",
                "followers", "requests", "seed"):
        assert port[key] == want[key], (key, port[key], want[key])
    for v in (port, want):
        assert v["link"]["wedges"] >= 2 and v["link"]["desyncs"] >= 1
        assert v["badput_wedged_s"] > 0
        assert 1 in v["link"]["wedged_ranks"]
        assert 0 in v["link"]["wedged_ranks"]


# -- leader/follower byte-identity property -----------------------------------

def test_leader_follower_byte_identity_vs_single_host():
    """Randomized shared-prefix mixes with exact repeats: the multi-host
    (leader + 2 replaying followers) paged engine serves byte-identical
    greedy outputs to the single-host paged engine, reuses the same
    radix-hit tokens, and the followers' replayed page tables / pool /
    last_dev byte-match the leader's after quiesce."""
    rng = np.random.RandomState(SEED)
    cases = linksim._drill_cases(rng, 16)
    solo = sim.make_fake_engine(kv_cache="paged", max_slots=4)
    h = make_harness()
    try:
        for i, c in enumerate(cases):
            want = solo.generate([c], 6)[0]
            got = h.generate(c, 6)
            assert want == got == sim.expected_output(c, 6), \
                (i, c, TAG)
        assert h.engine.kv.hit_tokens == solo.kv.hit_tokens, TAG
        assert h.engine.kv.hit_tokens > 0, \
            f"no radix-hit re-admissions exercised {TAG}"
        assert h.quiesce(), TAG
        assert h.mirror_errors() == [], (h.mirror_errors(), TAG)
    finally:
        h.shutdown()


def test_concurrent_requests_byte_exact_over_link():
    """A small concurrent storm through the linked engine: outputs stay
    byte-exact (follower replay order == leader dispatch order even
    when handler threads race)."""
    h = make_harness(n_followers=1)
    try:
        rng = np.random.RandomState(SEED + 1)
        cases = [rng.randint(1, 30, 3 + rng.randint(6)).tolist()
                 for _ in range(10)]
        outcomes = [None] * len(cases)

        def worker(ids):
            for i in ids:
                outcomes[i] = h.generate(cases[i], 5)

        threads = [
            threading.Thread(target=worker,
                             args=(range(w, len(cases), 4),),
                             daemon=True)
            for w in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for i, out in enumerate(outcomes):
            assert out == sim.expected_output(cases[i], 5), (i, TAG)
        assert h.quiesce(), TAG
        assert h.mirror_errors() == [], (h.mirror_errors(), TAG)
    finally:
        h.shutdown()


# -- wedge detection / supervision --------------------------------------------

def test_killed_follower_bounds_leader_and_charges_badput():
    """The headline hang: a vanished follower rank produces link_wedged
    within the timeout (never an eternal block), the request completes
    byte-exact on the surviving ranks, and the goodput ledger charges
    the stall to `wedged`."""
    h = make_harness(timeout_s=0.3)
    try:
        h.generate([1, 2, 3], 4)  # warm traffic
        faults.arm(faults.FaultPlan([
            {"kind": "follower_vanish",
             "site": serve_cli.LINK_FAULT_SITE, "at": 4, "count": 1,
             "node": "1"},
        ], seed=SEED))
        res = {}
        t = threading.Thread(
            target=lambda: res.update(out=h.generate([5, 6], 24)),
            daemon=True,
        )
        t.start()
        t.join(30)
        assert not t.is_alive(), f"request hung on a dead rank {TAG}"
        assert res["out"] == sim.expected_output([5, 6], 24), TAG
        wedged = h.link_events("link_wedged")
        assert any(rec.get("rank") == 1 for rec in wedged), \
            (wedged, TAG)
        rec = [r for r in wedged if r.get("rank") == 1][0]
        assert rec["node"] == "link-node-1", rec
        assert rec["stalled_s"] >= 0.29, rec
        assert rec["severity"] == "error", rec
        totals = obs_goodput.build_ledger(
            h.events.events()
        ).ledger.totals()
        assert totals["wedged"] > 0, (totals, TAG)
        # Supervisor restart: the rank re-joins and state re-mirrors.
        h.restart_rank(1)
        assert h.generate([7, 8], 4) == sim.expected_output([7, 8], 4)
        assert h.quiesce() and h.mirror_errors() == [], TAG
    finally:
        faults.disarm()
        h.shutdown()


def test_corrupt_broadcast_desyncs_before_dispatch():
    """An injected corrupt_payload makes the delivered bytes disagree
    with the announced digest: the follower emits link_desync and its
    replay thread aborts WITHOUT dispatching the divergent op."""
    h = make_harness(n_followers=1, timeout_s=0.3)
    try:
        faults.arm(faults.FaultPlan([
            {"kind": "corrupt_payload",
             "site": serve_cli.LINK_FAULT_SITE, "at": 2, "count": 1},
        ], seed=SEED))
        out = h.generate([4, 5, 6], 6)
        faults.disarm()
        assert out == sim.expected_output([4, 5, 6], 6), TAG
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                h.ranks[1].outcome is None:
            time.sleep(0.02)
        assert h.ranks[1].outcome == "desync", \
            (h.ranks[1].outcome, h.ranks[1].error, TAG)
        desyncs = h.link_events("link_desync")
        assert desyncs and desyncs[0]["rank"] == 1, (desyncs, TAG)
        assert "op_seq" in desyncs[0], desyncs[0]
        assert "digest" in desyncs[0]["reason"], desyncs[0]
    finally:
        faults.disarm()
        h.shutdown()


def test_dropped_broadcast_detected_as_seq_gap():
    """A drop fault skips one broadcast entirely: the follower sees the
    next op's sequence number as a gap — the monotone op_seq is what
    makes a silent hole visible."""
    h = make_harness(n_followers=1, timeout_s=0.3)
    try:
        faults.arm(faults.FaultPlan([
            {"kind": "drop", "site": serve_cli.LINK_FAULT_SITE,
             "at": 1, "count": 1},
        ], seed=SEED))
        out = h.generate([2, 3], 4)
        faults.disarm()
        assert out == sim.expected_output([2, 3], 4), TAG
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                h.ranks[1].outcome is None:
            time.sleep(0.02)
        assert h.ranks[1].outcome == "desync", (h.ranks[1].error, TAG)
        desyncs = h.link_events("link_desync")
        assert desyncs and "gap" in desyncs[0]["reason"], desyncs
    finally:
        faults.disarm()
        h.shutdown()


def test_follower_payload_recv_raises_typed_wedge():
    """A follower blocked mid-op on a vanished leader unblocks with
    the typed LinkWedgedError once the (5x) transport bound expires —
    the supervisor-facing half of the wedge contract."""
    transport = linksim.LoopbackTransport(1)
    view = transport.follower_view(1)
    t0 = time.monotonic()
    with pytest.raises(serve_cli.LinkWedgedError, match="mid-op"):
        view.recv(None, timeout_s=0.2)
    assert 0.15 < time.monotonic() - t0 < 5.0
    # No timeout (the idle header phase): blocks until delivery.
    transport.send(("hdr",), None)
    assert view.recv(None) == ("hdr",)


def test_wedge_events_carry_culprit_attribution():
    """Transport-detected wedges name the culprit rank
    (culprit=True); watchdog self-reports are marked culprit=False so
    the reactor drains without cordoning the observer's node."""
    h = make_harness(n_followers=1, timeout_s=0.3)
    try:
        faults.arm(faults.FaultPlan([
            {"kind": "follower_vanish",
             "site": serve_cli.LINK_FAULT_SITE, "at": 2, "count": 1,
             "node": "1"},
        ], seed=SEED))
        h.generate([1, 2], 12)
        faults.disarm()
        wedged = [r for r in h.link_events("link_wedged")
                  if r.get("rank") == 1]
        assert wedged and wedged[0]["culprit"] is True, wedged
    finally:
        faults.disarm()
        h.shutdown()


def test_handshake_config_mismatch_fails_by_name():
    """A follower built from drifted flags must die at bring-up with
    LinkConfigMismatch, not a shape-mismatch crash mid-traffic."""
    transport = linksim.LoopbackTransport(1)
    follower_eng = sim.make_fake_engine(
        kv_cache="paged", max_slots=2, start_loop=False,
    )
    flink = serve_cli.LockstepEngineLink(
        follower_eng.cfg, 2, transport=transport.follower_view(1),
        rank=1,
    )
    outcome = {}

    def run():
        try:
            serve_cli.engine_follower_loop(follower_eng, flink)
        except serve_cli.LinkConfigMismatch as e:
            outcome["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    # Leader with DIFFERENT max_slots: its ctor handshake must kill
    # the follower by name.
    link = serve_cli.LockstepEngineLink(
        follower_eng.cfg, 4, transport=transport, rank=0,
    )
    sim.make_fake_engine(kv_cache="paged", max_slots=4, link=link,
                         start_loop=False)
    t.join(10)
    assert not t.is_alive(), TAG
    assert isinstance(outcome.get("err"), serve_cli.LinkConfigMismatch)


def test_restart_budget_is_bounded():
    h = make_harness(n_followers=1, max_restarts=1)
    try:
        h.restart_rank(1)
        with pytest.raises(RuntimeError, match="restart budget"):
            h.restart_rank(1)
    finally:
        h.shutdown()


# -- observability + zero-cost contracts --------------------------------------

def test_link_metrics_registered_and_lint_clean():
    h = make_harness(n_followers=1)
    try:
        h.generate([1, 2], 3)
        text = h.registry.render().decode()
        assert 'tpu_serving_link_ops_total{op="kv_admit"}' in text
        assert 'tpu_serving_link_ops_total{op="paged_chunk"}' in text
        assert "tpu_serving_link_wedges_total 0.0" in text
        assert "tpu_serving_link_desyncs_total 0.0" in text
        assert "tpu_serving_link_op_wait_seconds_bucket" in text
        assert obs_lint.lint_registries({"link": h.registry}) == []
    finally:
        h.shutdown()


def test_link_fault_site_zero_cost_when_disarmed():
    """The serving.link hooks keep the faults.tick contract: disarmed
    calls return (), leave no counter behind, and a later-armed plan
    starts the site at hit 0."""
    assert faults.active() is None
    for _ in range(50):
        assert faults.tick(serve_cli.LINK_FAULT_SITE) == ()
    plan = faults.arm(faults.FaultPlan([
        {"kind": "drop", "site": serve_cli.LINK_FAULT_SITE, "at": 0},
    ], seed=SEED))
    assert [s.kind for s in faults.tick(serve_cli.LINK_FAULT_SITE)] \
        == ["drop"]
    assert plan.site_index(serve_cli.LINK_FAULT_SITE) == 1


def test_watchdog_absent_at_timeout_zero():
    """--link-timeout-s 0 (the default) must cost nothing: no watchdog
    object, no thread, no arming on the hot path — the historical link
    behavior bit for bit."""
    link = serve_cli.LockstepEngineLink(sim._sim_cfg(), 2)
    assert link._watchdog is None
    armed = serve_cli.LockstepEngineLink(
        sim._sim_cfg(), 2, timeout_s=1.0,
    )
    assert armed._watchdog is not None
    # Lazily threaded: no thread until the first arm.
    assert armed._watchdog._thread is None


def test_link_config_digest_sensitivity():
    cfg = sim._sim_cfg()
    base = serve_cli.link_config_digest(cfg, 4, 64, 4,
                                        kv_cache="paged",
                                        kv_block_size=4, kv_blocks=65)
    same = serve_cli.link_config_digest(cfg, 4, 64, 4,
                                        kv_cache="paged",
                                        kv_block_size=4, kv_blocks=65)
    assert base == same
    assert base != serve_cli.link_config_digest(
        cfg, 8, 64, 4, kv_cache="paged", kv_block_size=4,
        kv_blocks=65,
    )
    assert base != serve_cli.link_config_digest(
        cfg, 4, 64, 4, kv_cache="dense",
    )
