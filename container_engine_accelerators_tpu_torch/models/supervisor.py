# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Training supervision: step watchdog + bounded auto-resume.

MegaScale-style automated recovery for the training tier: the reference
stack leaves a wedged trainer to the operator; here a supervisor wraps
the run and closes the loop. Three failure shapes are handled:

  * **Crash** — the run raises (an injected ``WedgedChipFault``, a real
    XLA runtime error): restart.
  * **Wedge** — no step completes within ``watchdog_s`` (a hung
    collective, a stuck host): the run thread is abandoned and the run
    restarted. A wedged device call cannot be cancelled from Python —
    abandonment plus a fresh run is exactly what a pod restart does,
    minus the pod.
  * **Preemption** — a ``PreemptionFault`` (or anything else the run
    raises after checkpointing): restart, resume.

Restarts are *resumes*: the supervised ``run_fn`` must be restartable,
which ``train_cli``'s ``--checkpoint-dir`` provides (the latest
``step_<N>`` is restored and training continues from N). Restart count
is bounded (``max_restarts``) with escalating jittered backoff between
attempts, and every recovery action is a ``train_recovery`` event on
the unified stream — the fleet view shows what the supervisor did, not
just that throughput dipped.

The step heartbeat is the same zero-cost-hook pattern as the fault
injectors: ``_train_loop`` calls :func:`beat` every step, which is one
thread-attribute lookup until the calling thread is a supervised
attempt.

Copy of ``container_engine_accelerators_tpu/models/supervisor.py``, its
imports rewritten to the port's package (the flight recorder is the
port's ``obs/flight.py``). The port has no compile cache, so
``_compile_cache_snapshot`` is always None and a restart event never
carries ``cache_hits``/``cache_misses``. A watchdog-abandoned attempt
keeps the device memory it holds (its model, optimizer state and
activations) until its thread ends: a wedged CUDA call cannot be
cancelled from Python, so a restart on the same card allocates beside
it.
"""

import logging
import random
import threading
import time

from container_engine_accelerators_tpu_torch.obs import flight as obs_flight

log = logging.getLogger("train.supervisor")

EVENT_SOURCE = "train.supervisor"


class WatchdogTimeout(RuntimeError):
    """No step completed within the watchdog deadline."""


class RetryBudgetExhausted(RuntimeError):
    """The run kept failing past ``max_restarts`` resumes."""


class StepMonitor:
    """Step-completion heartbeat shared between the run thread (writes)
    and the supervisor (reads)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._last = clock()
        self.step = -1
        # First step this ATTEMPT completed: (step - first_step + 1) is
        # the attempt's sustained-healthy run, which is what decides
        # whether the restart backoff has earned a reset (see
        # supervise's backoff_reset_steps).
        self.first_step = None

    def beat(self, step):
        with self._lock:
            self._last = self._clock()
            self.step = step
            if self.first_step is None:
                self.first_step = step

    def healthy_steps(self):
        """Steps completed by this attempt (0 before its first beat)."""
        with self._lock:
            if self.first_step is None:
                return 0
            return self.step - self.first_step + 1

    def stalled_for(self):
        with self._lock:
            return self._clock() - self._last


# Attribute carrying the attempt's monitor on its OWN thread object.
# Thread-bound, not module-global, on purpose: an abandoned (wedged)
# attempt's thread can wake up later and keep calling beat() — routed
# through a global it would refresh the NEW attempt's heartbeat and a
# genuinely wedged restart would never trip the watchdog again.
_MONITOR_ATTR = "_supervisor_monitor"


def beat(step):
    """Heartbeat hook for the training loop: free no-op unless the
    CALLING THREAD is a supervised attempt (the trace_or_null
    contract — one getattr on the current thread)."""
    m = getattr(threading.current_thread(), _MONITOR_ATTR, None)
    if m is None:
        return
    m.beat(step)


def _compile_cache_snapshot():
    """Persistent-compile-cache counters: always None in the port, which
    has no compile cache (its kernels are built once per checkout by
    ``ops/_ext.py``), so a recovery event carries what the JAX
    package's carries without ``--compile-cache-dir``."""
    return None


def _compile_cache_attrs(before):
    """Per-ATTEMPT hit/miss deltas for the recovery event (restart N+1
    sharing restart N's compiles is the warmstart contract; each
    event's delta is the evidence — cumulative process totals would
    make every event after the first unreadable in isolation). Empty
    when nothing is armed — the attrs are optional on the contract."""
    snap = _compile_cache_snapshot()
    if snap is None:
        return {}
    before = before or {"hits": 0, "misses": 0}
    return {"cache_hits": snap["hits"] - before["hits"],
            "cache_misses": snap["misses"] - before["misses"]}


def supervise(run_fn, watchdog_s=0.0, max_restarts=0, backoff_base_s=1.0,
              backoff_max_s=30.0, init_grace_s=120.0, seed=0, events=None,
              backoff_reset_steps=0,
              clock=time.monotonic, sleep=time.sleep, poll_s=0.05):
    """Run ``run_fn()`` to completion under a step watchdog with bounded
    auto-resume.

    ``run_fn`` runs in a worker thread; the supervisor polls its step
    heartbeat (:func:`beat`). On a crash or a stall longer than
    ``watchdog_s`` (0 = watchdog off), the attempt is abandoned and —
    within ``max_restarts`` — re-run after an escalating jittered
    backoff. Returns ``run_fn``'s result, with ``restarts`` recorded
    when the result is a dict. Raises :class:`WatchdogTimeout` /
    the run's own error once the budget is exhausted.

    Before the FIRST step of an attempt beats, the stall budget is
    ``max(watchdog_s, init_grace_s)``: init/compile/checkpoint-restore
    legitimately dwarfs a per-step deadline (especially on the restart
    whose recompile the tight watchdog would otherwise kill forever —
    a restart loop that can never reach step 1).

    A wedged attempt's thread is a daemon and is left behind — the
    in-process analogue of the pod restart this supervisor replaces; a
    genuinely stuck device call is unreachable from Python either way.
    Its heartbeats stay bound to its own (abandoned) monitor, so a
    zombie waking up later can never satisfy a newer attempt's watchdog.

    ``backoff_reset_steps``: the escalating backoff used to be monotone
    for the process lifetime — a job that weathered a bad hour on day 1
    paid the accumulated exponent for a transient blip on day 3. When
    an attempt completes at least this many steps before failing, the
    backoff exponent resets to base (0 = never reset, the historical
    behavior). The ``max_restarts`` budget stays monotone either way —
    the reset is about *how long* to wait, not *whether* to retry.

    Attempts share the process, so they share the kernels ``ops/_ext.py``
    built and loaded: restart N+1 builds nothing. (The JAX package's
    events also carry compile-cache hit/miss deltas; the port has no
    compile cache.)
    """
    rng = random.Random(seed)
    restarts = 0
    backoff_level = 0
    while True:
        monitor = StepMonitor(clock=clock)
        cache_before = _compile_cache_snapshot()
        box = {}

        def target(monitor=monitor):
            setattr(threading.current_thread(), _MONITOR_ATTR, monitor)
            try:
                box["result"] = run_fn()
            except BaseException as e:  # noqa: BLE001 - surface to parent
                box["error"] = e

        thread = threading.Thread(
            target=target, name=f"train-attempt-{restarts}", daemon=True
        )
        thread.start()
        wedged = False
        while thread.is_alive():
            thread.join(poll_s)
            budget = (
                watchdog_s if monitor.step >= 0
                else max(watchdog_s, init_grace_s)
            )
            if (
                watchdog_s
                and thread.is_alive()
                and monitor.stalled_for() > budget
            ):
                wedged = True
                break
        if not wedged and "error" not in box:
            result = box.get("result")
            if isinstance(result, dict):
                result["restarts"] = restarts
            return result
        if wedged:
            reason = (
                f"step_watchdog: no step completed in {watchdog_s:.1f}s "
                f"(last step {monitor.step})"
            )
            # Dump the flight ring while the wedge's lead-up is still
            # in it (no-op when disarmed).
            obs_flight.trigger("watchdog", last_step=monitor.step)
        else:
            reason = f"{type(box['error']).__name__}: {box['error']}"
        # Time since the attempt's last heartbeat at the recovery
        # decision: the wall clock the failure burned before the
        # supervisor could act (the goodput ledger's `wedged` cause —
        # for a crash it's the partially-run step, for a wedge the full
        # watchdog stall).
        stalled_s = monitor.stalled_for()
        restarts += 1
        if restarts > max_restarts:
            if events is not None:
                events.emit(
                    "train_recovery", severity="error", action="give_up",
                    restarts=restarts - 1, reason=reason,
                    stalled_s=round(stalled_s, 3),
                )
            log.error("retry budget exhausted (%d restarts): %s",
                      restarts - 1, reason)
            if wedged:
                raise WatchdogTimeout(reason)
            raise box["error"]
        # Backoff decay: a sustained-healthy attempt proves the earlier
        # trouble passed — its failure pays base backoff, not the
        # exponent the process accumulated days ago.
        healthy = monitor.healthy_steps()
        if backoff_reset_steps and healthy >= backoff_reset_steps:
            backoff_level = 0
        backoff = min(
            backoff_base_s * (2 ** backoff_level), backoff_max_s
        ) * (0.5 + rng.random() / 2)
        backoff_level += 1
        if events is not None:
            events.emit(
                "train_recovery", severity="warning", action="restart",
                attempt=restarts, reason=reason,
                backoff_s=round(backoff, 3), last_step=monitor.step,
                stalled_s=round(stalled_s, 3),
                healthy_steps=healthy,
                **_compile_cache_attrs(cache_before),
            )
        obs_flight.trigger("supervisor_restart", attempt=restarts)
        log.warning(
            "training attempt %d failed (%s); resuming from latest "
            "checkpoint in %.2fs", restarts, reason, backoff,
        )
        sleep(backoff)
