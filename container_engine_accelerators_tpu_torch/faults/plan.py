# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Deterministic, seedable fault injection for the whole stack.

Copy of ``container_engine_accelerators_tpu/faults/plan.py``, its imports
rewritten to the port's package; the contracts are the same. The armed
plan (``arm``/``fire``) is this module's own global, independent of the
JAX package's.

The reference stack's robustness story stops at *detection* (Xid events
flip a device Unhealthy); testing the *reaction* requires faults that
happen on demand, reproducibly. This module is the one fault source
every layer shares:

  * A :class:`FaultPlan` is a scripted schedule of :class:`FaultSpec`
    entries — chip wedges, host vanishes, straggler delays, collective
    timeouts, preemption signals — each pinned to an injection *site*
    and a window of hook hits at that site. Plans are seedable and pure
    data (``from_json``/``to_dict`` round-trip), so a chaos scenario is
    reproducible from ``(plan, seed)`` alone and the seed can be quoted
    in a failure message.

  * Injection *hooks* live on the stack's hot paths (the device-plugin
    health sweep, the serving engine's prefill/chunk dispatches, the
    training step loop, the scheduler's node view). Every hook is
    **zero-cost when no plan is armed**: one module-global ``is None``
    check, no counter bumps, no allocation — the exact contract
    ``utils/profiling.trace_or_null`` set for profiling hooks, pinned by
    tests/test_faults.py.

  * Arming is process-global (:func:`arm`/:func:`disarm`) so a CLI flag
    (``--fault-plan plan.json``) arms every hook in the process at once.

Sites (by convention ``<layer>.<operation>``):

  ``deviceplugin.health``   one tick per health sweep; ``chip_wedge``
                            injects an error code, ``host_vanish`` makes
                            chip device nodes disappear from the sweep
  ``serving.prefill``       one tick per admission prefill dispatch
  ``serving.chunk``         one tick per fused decode-chunk dispatch
  ``serving.link``          one tick per lockstep-link op announce;
                            ``drop``/``delay``/``corrupt_payload``/
                            ``follower_vanish`` exercise the link's
                            watchdog + desync detection (see
                            FAULT_KINDS below)
  ``train.step``            one tick per training step
  ``scheduler.nodes``       one tick per scheduling pass; ``host_vanish``
                            removes the named node from the pass's view

Faulting kinds raise typed :class:`InjectedFault` subclasses from
:func:`fire` (compute sites); ``straggler`` sleeps ``delay_s`` instead.
Sites that interpret specs themselves (health sweep, scheduler node
view) use :func:`tick`, which only advances the site counter and
returns the active specs.
"""

import dataclasses
import json
import random
import threading
import time

from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

FAULT_KINDS = (
    "chip_wedge",
    "host_vanish",
    "straggler",
    "collective_timeout",
    "preemption",
    # Lockstep-link kinds, interpreted at the ``serving.link`` site
    # (models/serve_cli.LockstepEngineLink.announce — a tick site like
    # the health sweep): ``drop`` skips one broadcast (followers see a
    # sequence gap -> link_desync), ``delay`` stalls the collective
    # delay_s inside the watchdog window (link_wedged past
    # --link-timeout-s), ``corrupt_payload`` delivers bytes that no
    # longer match the announced digest (link_desync before any
    # divergent dispatch), ``follower_vanish`` makes the rank named by
    # ``node`` stop consuming (drill transports only — the real
    # analogue is the host crashing mid-collective).
    "drop",
    "delay",
    "corrupt_payload",
    "follower_vanish",
)

EVENT_SOURCE = "faults"


class InjectedFault(RuntimeError):
    """Base of every fault raised by an armed plan (typed, so recovery
    paths can tell an injected fault from a genuine one in tests while
    handling both identically in production code)."""

    kind = "fault"


class WedgedChipFault(InjectedFault):
    kind = "chip_wedge"


class CollectiveTimeoutFault(InjectedFault):
    kind = "collective_timeout"


class HostVanishFault(InjectedFault):
    kind = "host_vanish"


class PreemptionFault(InjectedFault):
    kind = "preemption"


_EXC_BY_KIND = {
    "chip_wedge": WedgedChipFault,
    "collective_timeout": CollectiveTimeoutFault,
    "host_vanish": HostVanishFault,
    "preemption": PreemptionFault,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: fire at hook hits ``[at, at+count)`` of
    ``site``. ``chip``/``node`` scope device/host faults; ``delay_s`` is
    the straggler's injected delay; ``error_code`` the wedge's injected
    health error (must be in the health checker's critical set to flip
    the chip)."""

    kind: str
    site: str
    at: int = 0
    count: int = 1
    chip: str = ""
    node: str = ""
    delay_s: float = 0.0
    error_code: str = "runtime_wedged"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}"
            )
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")

    def active_at(self, index):
        return self.at <= index < self.at + self.count


class FaultPlan:
    """A deterministic schedule of faults over named injection sites.

    Thread-safe: hooks fire from the serving engine thread, the health
    sweep thread, and HTTP handler threads concurrently. ``seed`` feeds
    the plan's private RNG (used for jittering straggler delays when
    ``jitter`` is on) and is quoted in every injected exception so a
    failing chaos scenario names its reproduction recipe.
    """

    def __init__(self, faults=(), seed=0, events=None, registry=None,
                 sleep=time.sleep):
        self.seed = seed
        self.faults = [
            f if isinstance(f, FaultSpec) else FaultSpec(**f)
            for f in faults
        ]
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counters = {}
        # Recovery/chaos observability: every fired fault is an event +
        # a counter, same as every recovery action it provokes.
        self.events = events if events is not None else obs_events.EventStream(
            EVENT_SOURCE, registry=registry
        )
        reg = self.events.registry
        self.injections = (
            obs_metrics.get_or_create(
                obs_metrics.Counter,
                "tpu_fault_injections_total",
                "Faults fired by the armed fault plan, by kind and site",
                labelnames=("kind", "site"),
                registry=reg,
            )
            if reg is not None
            else None
        )

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_dict(cls, data, **kwargs):
        return cls(
            faults=data.get("faults", ()),
            seed=int(data.get("seed", 0)),
            **kwargs,
        )

    @classmethod
    def from_json(cls, path, **kwargs):
        with open(path) as f:
            return cls.from_dict(json.load(f), **kwargs)

    def to_dict(self):
        return {
            "seed": self.seed,
            "faults": [dataclasses.asdict(s) for s in self.faults],
        }

    # -- hook surface ---------------------------------------------------------

    def tick(self, site):
        """Advance ``site``'s hit counter; return the specs active at
        this hit (callers at interpreting sites — health sweep,
        scheduler node view — act on them)."""
        with self._lock:
            index = self._counters.get(site, 0)
            self._counters[site] = index + 1
        active = [
            s for s in self.faults if s.site == site and s.active_at(index)
        ]
        for spec in active:
            if self.injections is not None:
                self.injections.labels(spec.kind, site).inc()
            # delay_s rides the event so the goodput ledger can
            # attribute an injected straggler's sleep as badput (the
            # sleep hides inside the step/chunk duration otherwise).
            self.events.emit(
                "fault_injected", severity="warning", fault=spec.kind,
                site=site, hit=index, seed=self.seed,
                chip=spec.chip, node=spec.node, delay_s=spec.delay_s,
            )
        return active

    def fire(self, site, **ctx):
        """tick + default behavior for compute sites: stragglers sleep
        ``delay_s``, faulting kinds raise their typed exception (the
        seed rides the message so any failure names its repro)."""
        active = self.tick(site)
        for spec in active:
            if spec.kind == "straggler":
                self._sleep(spec.delay_s)
        for spec in active:
            exc = _EXC_BY_KIND.get(spec.kind)
            if exc is not None:
                raise exc(
                    f"injected {spec.kind} at {site} "
                    f"(plan seed {self.seed}{', ' + repr(ctx) if ctx else ''})"
                )
        return active

    def site_index(self, site):
        """Hits seen at ``site`` so far (test/debug introspection)."""
        with self._lock:
            return self._counters.get(site, 0)


# -- process-global armed plan (the trace.configure pattern) ------------------

_PLAN = None
_plan_lock = threading.Lock()


def arm(plan):
    """Install ``plan`` as the process-wide armed plan; returns it."""
    global _PLAN
    with _plan_lock:
        _PLAN = plan
    return plan


def disarm():
    """Remove the armed plan; every hook returns to its no-op path."""
    global _PLAN
    with _plan_lock:
        _PLAN = None


def active():
    """The armed plan, or None."""
    return _PLAN


def tick(site):
    """Module-level tick: () when disarmed — one ``is None`` check, no
    side effects (the zero-cost contract; see tests/test_faults.py)."""
    plan = _PLAN
    if plan is None:
        return ()
    return plan.tick(site)


def fire(site, **ctx):
    """Module-level fire: () when disarmed, same zero-cost contract."""
    plan = _PLAN
    if plan is None:
        return ()
    return plan.fire(site, **ctx)


def arm_from_flag(path, sink_path=""):
    """Arm a plan from a CLI ``--fault-plan`` flag with its injections
    wired into the process's observability: ``fault_injected`` events
    append to ``sink_path`` (pass the CLI's ``--event-log``, so a chaos
    drill's causes interleave with the reactions they provoke) and
    ``tpu_fault_injections_total{kind,site}`` registers in the
    process-default metrics registry. Returns the armed plan."""
    plan = FaultPlan.from_json(
        path,
        events=obs_events.EventStream(
            EVENT_SOURCE, sink_path=sink_path,
            registry=obs_metrics.REGISTRY,
        ),
    )
    return arm(plan)
