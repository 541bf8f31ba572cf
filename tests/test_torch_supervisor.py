# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's training supervisor (``models/supervisor.py``, a copy of
the JAX package's) held to JAX's ``tests/test_supervisor.py``: each
primitive contract runs on both packages' modules (with each package's
event stream), so the copy cannot drift from the original. The JAX
file's compile-cache case has a port counterpart: the port has no
compile cache, so its recovery events carry no cache attributes."""

import threading
import time

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu.models import (  # noqa: E402
    supervisor as jsupervisor,
)
from container_engine_accelerators_tpu.obs import (  # noqa: E402
    events as jevents,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    supervisor as tsupervisor,
)
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    events as tevents,
)

PACKAGES = {"jax": (jsupervisor, jevents), "port": (tsupervisor, tevents)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]

def test_beat_is_a_noop_without_a_supervisor(pkg):
    """The trace_or_null contract: an unsupervised train loop's
    heartbeat costs one thread-attribute lookup and does nothing."""
    supervisor, obs_events = pkg
    assert getattr(
        threading.current_thread(), supervisor._MONITOR_ATTR, None
    ) is None
    supervisor.beat(7)  # must not raise, must not install anything
    assert getattr(
        threading.current_thread(), supervisor._MONITOR_ATTR, None
    ) is None


def test_zombie_attempt_heartbeat_cannot_defeat_new_watchdog(pkg):
    """An abandoned (wedged) attempt that wakes up later beats its OWN
    dead monitor — never the new attempt's, whose watchdog must still
    fire on a genuine second wedge."""
    supervisor, obs_events = pkg
    attempt = {"n": 0}
    release_zombie = threading.Event()

    def run():
        attempt["n"] += 1
        if attempt["n"] == 1:
            supervisor.beat(0)
            release_zombie.wait(10)  # wedge; later wakes as a zombie...
            for step in range(1, 50):
                supervisor.beat(step)  # ...and beats furiously
                time.sleep(0.01)
            return {"ok": "zombie"}
        supervisor.beat(0)
        release_zombie.set()  # zombie wakes DURING this attempt
        time.sleep(60)  # second genuine wedge

    with pytest.raises(supervisor.WatchdogTimeout):
        supervisor.supervise(
            run, watchdog_s=0.3, max_restarts=1, init_grace_s=0.3,
            backoff_base_s=0.001, poll_s=0.01,
        )


def test_success_passes_result_through_with_restart_count(pkg):
    supervisor, obs_events = pkg
    res = supervisor.supervise(lambda: {"loss": 1.0})
    assert res == {"loss": 1.0, "restarts": 0}


def test_crash_restarts_with_escalating_jittered_backoff(pkg):
    supervisor, obs_events = pkg
    calls = {"n": 0}
    slept = []

    def run():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError(f"boom {calls['n']}")
        return {"ok": True}

    stream = obs_events.EventStream("test.supervisor")
    res = supervisor.supervise(
        run, max_restarts=2, backoff_base_s=1.0, seed=3, events=stream,
        sleep=slept.append,
    )
    assert res == {"ok": True, "restarts": 2}
    # Escalating (base, 2*base) with jitter in [0.5, 1.0]x.
    assert 0.5 <= slept[0] <= 1.0 < slept[1] <= 2.0
    recs = stream.events(kind="train_recovery")
    assert [r["action"] for r in recs] == ["restart", "restart"]
    assert "boom 1" in recs[0]["reason"]


def test_budget_exhaustion_reraises_and_emits_give_up(pkg):
    supervisor, obs_events = pkg
    stream = obs_events.EventStream("test.supervisor")

    def run():
        raise ValueError("persistent")

    with pytest.raises(ValueError, match="persistent"):
        supervisor.supervise(
            run, max_restarts=1, backoff_base_s=0.001, events=stream,
        )
    assert stream.events(kind="train_recovery")[-1]["action"] == "give_up"


def test_watchdog_abandons_wedged_run(pkg):
    supervisor, obs_events = pkg
    def wedge():
        supervisor.beat(0)
        time.sleep(60)

    with pytest.raises(supervisor.WatchdogTimeout, match="step_watchdog"):
        supervisor.supervise(wedge, watchdog_s=0.2, poll_s=0.01)


def test_init_grace_outlasts_the_step_watchdog(pkg):
    """A slow init (compile/restore) must not trip a tight per-step
    watchdog before the first beat — else a restart could never reach
    step 1."""
    supervisor, obs_events = pkg
    def slow_init():
        time.sleep(0.5)  # longer than watchdog_s, under init grace
        supervisor.beat(0)
        return {"ok": True}

    res = supervisor.supervise(
        slow_init, watchdog_s=0.1, init_grace_s=5.0, poll_s=0.01,
    )
    assert res == {"ok": True, "restarts": 0}


def test_backoff_resets_after_sustained_healthy_steps(pkg):
    """Regression: the escalating backoff exponent used to be
    monotone for the process lifetime. With backoff_reset_steps, an
    attempt that sustains N healthy steps before failing pays BASE
    backoff on its restart, not the exponent accumulated by earlier
    trouble."""
    supervisor, obs_events = pkg
    calls = {"n": 0}
    slept = []

    def run():
        calls["n"] += 1
        if calls["n"] <= 2:
            # Two early crashes: 1 step each (below the reset bar).
            supervisor.beat(1)
            raise RuntimeError(f"early {calls['n']}")
        if calls["n"] == 3:
            # Sustained healthy (>= reset bar), then a transient fault.
            for step in range(1, 13):
                supervisor.beat(step)
            raise RuntimeError("transient days later")
        return {"ok": True}

    stream = obs_events.EventStream("test.supervisor")
    res = supervisor.supervise(
        run, max_restarts=4, backoff_base_s=1.0, backoff_max_s=100.0,
        seed=3, events=stream, backoff_reset_steps=10,
        sleep=slept.append,
    )
    assert res == {"ok": True, "restarts": 3}
    # Escalation for the unhealthy crashes, then RESET to base after
    # the sustained-healthy attempt (jitter is [0.5, 1.0]x the level).
    assert 0.5 <= slept[0] <= 1.0 < slept[1] <= 2.0
    assert slept[2] <= 1.0 < slept[1]
    recs = stream.events(kind="train_recovery")
    assert [r["healthy_steps"] for r in recs] == [1, 1, 12]


def test_backoff_stays_monotone_when_reset_disabled(pkg):
    """backoff_reset_steps=0 keeps the historical behavior: the
    exponent never decays, however healthy the attempts were."""
    supervisor, obs_events = pkg
    calls = {"n": 0}
    slept = []

    def run():
        calls["n"] += 1
        if calls["n"] <= 3:
            for step in range(1, 13):
                supervisor.beat(step)
            raise RuntimeError("boom")
        return {"ok": True}

    res = supervisor.supervise(
        run, max_restarts=4, backoff_base_s=1.0, backoff_max_s=100.0,
        seed=3, backoff_reset_steps=0, sleep=slept.append,
    )
    assert res == {"ok": True, "restarts": 3}
    assert 0.5 <= slept[0] <= 1.0 < slept[1] <= 2.0 < slept[2] <= 4.0


def test_port_recovery_events_carry_no_cache_attrs():
    """The JAX package's restart events add per-attempt compile-cache
    deltas when a cache is armed; the port has none, so its events carry
    the keys JAX's carry without one."""
    keys = {}
    for name, (supervisor, obs_events) in PACKAGES.items():
        calls = {"n": 0}

        def run(supervisor=supervisor, calls=calls):
            calls["n"] += 1
            if calls["n"] == 1:
                supervisor.beat(1)
                raise RuntimeError("boom")
            return {"ok": True}

        stream = obs_events.EventStream("test.supervisor")
        assert supervisor.supervise(
            run, max_restarts=1, backoff_base_s=0.001, seed=1,
            events=stream, sleep=lambda _s: None,
        ) == {"ok": True, "restarts": 1}
        keys[name] = [sorted(r) for r in stream.events(kind="train_recovery")]
    assert tsupervisor._compile_cache_snapshot() is None
    assert keys["port"] == keys["jax"]
    assert "cache_hits" not in keys["port"][0]
