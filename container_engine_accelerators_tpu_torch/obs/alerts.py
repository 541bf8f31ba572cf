# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Multi-window burn-rate alerting over the in-process metrics registry.

Copy of ``container_engine_accelerators_tpu/obs/alerts.py``, its imports
rewritten to the port's package; the contracts are the same.

SRE practice evaluates SLOs with *burn rates* — how fast the error
budget is being spent — over **multiple windows at once**: a fast-burn
rule (short window, high threshold) pages on sudden outages, a
slow-burn rule (long window, low threshold) catches the quiet leak, and
requiring BOTH a long and a short window above threshold keeps a rule
from staying red long after the incident ended (the short window
recovers first → the alert resolves). This module is that evaluator,
dependency-free, over the stack's own ``obs.metrics`` registries.

Rules are **data** (a JSON file for ``--alert-rules``, or dicts in
tests), three kinds:

  ``burn_rate``    error-budget burn of ``bad`` over ``total`` counter
                   series against ``objective``; fires when EVERY
                   ``(window_s, burn)`` pair exceeds its threshold
  ``gauge_below``  a gauge (e.g. a goodput ratio) below ``threshold``
                   continuously for ``for_s``
  ``rate_above``   a counter's per-second rate over ``window_s`` above
                   ``threshold`` (health-flap rate,
                   ``tpu_trace_dropped_events_total`` growth)

Series are addressed by metric name plus label constraints; a
constraint value may be a list (the matching children are summed), so
"every non-good SLO outcome" is one rule, not three.

State transitions emit ``alert_fired`` / ``alert_resolved`` events on
the unified stream (source ``alerts``) — the same pipeline the fleet
reactor tails, so a reaction can subscribe to alerts exactly like it
subscribes to health transitions — and are mirrored as
``tpu_alerts_active{rule}`` / ``tpu_alerts_fired_total{rule}``.

Wired into the CLIs as ``--alert-rules rules.json --alerts-out
alerts.jsonl`` (serve_cli, train_cli, schedule-daemon); like every
other obs hook, the whole machinery is zero-cost when the flag is
absent (:func:`wire_from_flags` returns ``None`` without creating a
thread, an instrument, or a stream).
"""

import collections
import dataclasses
import json
import logging
import threading
import time

from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import flight as obs_flight
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

EVENT_SOURCE = "alerts"

RULE_KINDS = ("burn_rate", "gauge_below", "rate_above")

# Default multi-window pairs (window_s, burn threshold): the SRE
# workbook's fast/slow pages scaled to a daemon's lifetime. Rule files
# override them freely (tests use second-scale windows).
DEFAULT_WINDOWS = ((3600.0, 1.0), (300.0, 1.0))

ACTIVE_GAUGE_NAME = "tpu_alerts_active"
FIRED_COUNTER_NAME = "tpu_alerts_fired_total"


@dataclasses.dataclass
class AlertRule:
    """One alert rule; pure data, JSON round-trippable."""

    name: str
    kind: str
    # Series addressing. burn_rate uses bad/total; the others `metric`.
    metric: str = ""
    labels: dict = dataclasses.field(default_factory=dict)
    bad_metric: str = ""
    bad_labels: dict = dataclasses.field(default_factory=dict)
    total_metric: str = ""
    total_labels: dict = dataclasses.field(default_factory=dict)
    # burn_rate: the SLO objective (0.99 = 1% error budget) and the
    # (window_s, burn) pairs that must ALL exceed to fire.
    objective: float = 0.99
    windows: tuple = DEFAULT_WINDOWS
    # gauge_below / rate_above.
    threshold: float = 0.0
    window_s: float = 300.0
    for_s: float = 0.0
    severity: str = "warning"

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"rule {self.name!r}: unknown kind {self.kind!r}; "
                f"known: {RULE_KINDS}"
            )
        if self.kind == "burn_rate":
            if not self.bad_metric or not self.total_metric:
                raise ValueError(
                    f"rule {self.name!r}: burn_rate needs bad_metric "
                    f"and total_metric"
                )
            if not 0.0 < self.objective < 1.0:
                raise ValueError(
                    f"rule {self.name!r}: objective must be in (0, 1), "
                    f"got {self.objective}"
                )
            self.windows = tuple(
                (float(w), float(b)) for w, b in self.windows
            )
            if not self.windows:
                raise ValueError(
                    f"rule {self.name!r}: at least one (window_s, "
                    f"burn) pair required"
                )
        elif not self.metric:
            raise ValueError(
                f"rule {self.name!r}: {self.kind} needs a metric"
            )
        if self.severity not in obs_events.SEVERITIES:
            raise ValueError(
                f"rule {self.name!r}: severity {self.severity!r} not "
                f"in {obs_events.SEVERITIES}"
            )

    @classmethod
    def from_dict(cls, data):
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"rule {data.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)}; known: {sorted(known)}"
            )
        if "windows" in data:
            data = {**data, "windows": tuple(
                tuple(w) for w in data["windows"]
            )}
        return cls(**data)


def load_rules(path):
    """``(rules, interval_s)`` from a JSON rule file:
    ``{"interval_s": 5.0, "rules": [{...}, ...]}``."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "rules" not in data:
        raise ValueError(
            f"{path}: expected a JSON object with a 'rules' list"
        )
    rules = [AlertRule.from_dict(r) for r in data["rules"]]
    if not rules:
        raise ValueError(f"{path}: no rules defined")
    return rules, float(data.get("interval_s", 5.0))


def example_rules():
    """The documented starter rule set (docs/observability.md): SLO
    burn, goodput drop, health-flap rate, trace-drop growth, and the
    chip-accounting fairness drift."""
    return {
        "interval_s": 5.0,
        "rules": [
            {"name": "serving-slo-burn", "kind": "burn_rate",
             "bad_metric": "tpu_serving_slo_requests_total",
             "bad_labels": {
                 "outcome": ["shed", "slow_ttft", "slow_tpot"]},
             "total_metric": "tpu_serving_slo_requests_total",
             "objective": 0.99,
             "windows": [[3600, 1.0], [300, 1.0]],
             "severity": "error"},
            {"name": "goodput-drop", "kind": "gauge_below",
             "metric": "tpu_serving_slo_goodput_ratio",
             "threshold": 0.9, "for_s": 60.0},
            {"name": "health-flap-rate", "kind": "rate_above",
             "metric": "tpu_device_health_flaps_total",
             "threshold": 0.01, "window_s": 600.0},
            {"name": "trace-drops", "kind": "rate_above",
             "metric": "tpu_trace_dropped_events_total",
             "threshold": 0.0, "window_s": 300.0},
            # Fairness drift (chip accounting, obs/devicetime.py): a
            # class's measured device share held below half its
            # configured queue_share for 30s — a starved tenant. The
            # ratio reads 1.0 on an idle engine, so a drained fleet
            # never pages.
            {"name": "tenant-share-drift", "kind": "gauge_below",
             "metric": "tpu_tenant_device_share_ratio",
             "labels": {"tenant_class": "premium"},
             "threshold": 0.5, "for_s": 30.0},
        ],
    }


def _matches(labelnames, values, constraints):
    for key, want in constraints.items():
        if key not in labelnames:
            return False
        got = values[labelnames.index(key)]
        if isinstance(want, (list, tuple, set)):
            if got not in {str(w) for w in want}:
                return False
        elif got != str(want):
            return False
    return True


def read_series(registries, metric, constraints=None):
    """Sum of the matching children's values across ``registries``
    (histograms contribute their observation count), or ``None`` when
    the metric exists nowhere yet."""
    constraints = constraints or {}
    found = False
    total = 0.0
    for reg in registries:
        m = reg.get(metric)
        if m is None:
            continue
        found = True
        for values, child in m._series():
            if not _matches(m.labelnames, values, constraints):
                continue
            if getattr(child, "_buckets", None) is not None:
                total += sum(child._counts)
            else:
                total += child.value
    return total if found else None


class AlertEvaluator:
    """Evaluates rules over sampled registry state; call :meth:`tick`
    periodically (or :meth:`start` a daemon thread).

    Window rates come from an in-memory sample history per series (one
    sample per tick, retained for the longest window a rule asks for),
    so the evaluator needs no TSDB — the same dependency posture as the
    rest of ``obs/``."""

    def __init__(self, registries, rules, events=None,
                 clock=time.monotonic, registry=None):
        if not isinstance(registries, (list, tuple)):
            registries = [registries]
        self.registries = list(registries)
        self.rules = list(rules)
        self.events = events
        self._clock = clock
        self._hist = collections.defaultdict(collections.deque)
        self._below_since = {}
        self.active = {}  # rule name -> fired-state dict
        self._thread = None
        self._stop = threading.Event()
        reg = registry
        if reg is None:
            reg = events.registry if events is not None else None
        if reg is None and self.registries:
            reg = self.registries[0]
        self._m_active = obs_metrics.get_or_create(
            obs_metrics.Gauge, ACTIVE_GAUGE_NAME,
            "Alert rules currently firing", labelnames=("rule",),
            registry=reg) if reg is not None else None
        self._m_fired = obs_metrics.get_or_create(
            obs_metrics.Counter, FIRED_COUNTER_NAME,
            "Alert rule fire transitions", labelnames=("rule",),
            registry=reg) if reg is not None else None

    # -- sampling -------------------------------------------------------------

    def _sample(self, key, metric, constraints, now, retain_s):
        v = read_series(self.registries, metric, constraints)
        dq = self._hist[key]
        if v is not None:
            dq.append((now, v))
        while dq and dq[0][0] < now - retain_s - 1e-9:
            dq.popleft()
        return v

    def _rate(self, key, window_s, now):
        """Per-second increase over the trailing window (0.0 until two
        samples within the window exist)."""
        dq = self._hist[key]
        then = None
        for t, v in dq:
            if t >= now - window_s - 1e-9:
                then = (t, v)
                break
        if then is None or not dq:
            return 0.0
        t_now, v_now = dq[-1]
        if t_now <= then[0]:
            return 0.0
        return (v_now - then[1]) / (t_now - then[0])

    # -- evaluation -----------------------------------------------------------

    def _eval(self, rule, now):
        """(firing, detail) for one rule at ``now``."""
        if rule.kind == "burn_rate":
            retain = max(w for w, _ in rule.windows)
            self._sample((rule.name, "bad"), rule.bad_metric,
                         rule.bad_labels, now, retain)
            self._sample((rule.name, "total"), rule.total_metric,
                         rule.total_labels, now, retain)
            budget = 1.0 - rule.objective
            burns = []
            for window_s, thresh in rule.windows:
                bad = self._rate((rule.name, "bad"), window_s, now)
                total = self._rate((rule.name, "total"), window_s, now)
                ratio = bad / total if total > 0 else 0.0
                burns.append((ratio / budget, thresh))
            # Fire on the EXACT burn; rounding is display-only (a burn
            # of 1.00004 against threshold 1.0 must still page).
            firing = all(b > t for b, t in burns)
            return firing, {"burn_rates": [round(b, 4)
                                           for b, _ in burns]}
        if rule.kind == "gauge_below":
            v = read_series(self.registries, rule.metric, rule.labels)
            if v is None:
                self._below_since.pop(rule.name, None)
                return False, {}
            if v >= rule.threshold:
                self._below_since.pop(rule.name, None)
                return False, {"value": round(v, 6)}
            since = self._below_since.setdefault(rule.name, now)
            return now - since >= rule.for_s, {"value": round(v, 6)}
        # rate_above
        self._sample((rule.name, "m"), rule.metric, rule.labels, now,
                     rule.window_s)
        r = self._rate((rule.name, "m"), rule.window_s, now)
        return r > rule.threshold, {"rate": round(r, 6)}

    def tick(self, now=None):
        """Evaluate every rule once; returns the transitions
        (``[("fired"|"resolved", rule_name), ...]``)."""
        now = self._clock() if now is None else now
        transitions = []
        for rule in self.rules:
            firing, detail = self._eval(rule, now)
            was = rule.name in self.active
            if firing and not was:
                self.active[rule.name] = {"since": now, **detail}
                transitions.append(("fired", rule.name))
                if self._m_fired is not None:
                    self._m_fired.labels(rule.name).inc()
                if self._m_active is not None:
                    self._m_active.labels(rule.name).set(1)
                if self.events is not None:
                    self.events.emit(
                        "alert_fired", severity=rule.severity,
                        rule=rule.name, kind_of_rule=rule.kind, **detail,
                    )
                # A firing alert is the canonical "state worth keeping"
                # moment: dump the flight ring (no-op when disarmed,
                # deduped per kind when armed).
                obs_flight.trigger("alert_fired", rule=rule.name)
            elif not firing and was:
                since = self.active.pop(rule.name)["since"]
                transitions.append(("resolved", rule.name))
                if self._m_active is not None:
                    self._m_active.labels(rule.name).set(0)
                if self.events is not None:
                    self.events.emit(
                        "alert_resolved", severity="info",
                        rule=rule.name,
                        active_s=round(now - since, 3), **detail,
                    )
        return transitions

    # -- background driving ---------------------------------------------------

    def start(self, interval_s=5.0):
        """Tick from a daemon thread every ``interval_s``; returns
        self. Restartable: a fresh stop event per start, so a closed
        evaluator can be re-armed."""
        if self._thread is not None:
            return self
        self._stop = threading.Event()
        stop = self._stop

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - alerting must not crash
                    import logging

                    logging.getLogger(__name__).exception(
                        "alert tick failed"
                    )

        self._thread = threading.Thread(
            target=loop, name="obs-alerts", daemon=True
        )
        self._thread.start()
        return self

    def close(self):
        """Stop the tick thread and wait it out, so callers' teardown
        (train_cli's finally) can't race a tick still reading their
        registries."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)


def wire_from_flags(registries, rules_path, alerts_out="",
                    source=EVENT_SOURCE, registry=None, start=True):
    """CLI wiring for ``--alert-rules``/``--alerts-out``: load the rule
    file, attach an event stream (JSONL sink at ``alerts_out``, counters
    into ``registry`` or the first monitored registry), start the tick
    thread, return the evaluator. Returns ``None`` — creating nothing —
    when ``rules_path`` is empty: the unconfigured path stays
    zero-cost."""
    if not rules_path:
        return None
    rules, interval_s = load_rules(rules_path)
    if not isinstance(registries, (list, tuple)):
        registries = [registries]
    reg = registry if registry is not None else (
        registries[0] if registries else None
    )
    events = obs_events.EventStream(
        source, sink_path=alerts_out, registry=reg,
    )
    ev = AlertEvaluator(registries, rules, events=events, registry=reg)
    if start:
        ev.start(interval_s)
    logging.getLogger(__name__).info(
        "alert rules armed from %s (%d rules, tick %.1fs)",
        rules_path, len(rules), interval_s,
    )
    return ev
