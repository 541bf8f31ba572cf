# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Postmortem bundle analyzer: first-anomaly attribution, no deps.

Copy of ``container_engine_accelerators_tpu/obs/postmortem.py`` (pure
stdlib), its module paths the port's; the analysis is the same.

``python -m container_engine_accelerators_tpu_torch.obs.postmortem
bundle.jsonl`` takes a flight-recorder bundle (see ``obs/flight.py``)
and answers the operator's first question — *what moved first?* — by:

  * reconstructing per-series timelines from the delta snapshots
    (counter deltas default to 0 when absent, gauge samples carry
    forward, histograms contribute ``:count`` and ``:mean`` series);
  * running changepoint detection over each series — rolling
    median/MAD with relative and absolute sigma floors, pure stdlib —
    and naming the **first anomalous series and its timestamp**
    relative to the trigger;
  * correlating the fused event tail: ``fault_injected`` (was chaos
    armed? which site?), ``health_transition``, ``alert_fired``,
    ``link_wedged``/``link_desync``, and the bundle's own
    ``flight_dump`` record;
  * cross-linking any ``trace_id``s present so the journey stitcher
    (``obs.journey``) can pick up where the bundle stops.

Self-detection series are excluded by default: the recorder's own
instruments and the per-kind event counter *mirror* the event tail and
the dump itself — they always move at the trigger, so attributing the
anomaly to them would tell the operator nothing the trigger record
didn't (override with ``--include-series`` when hunting recorder bugs).

Exit codes follow the merge/journey CLI posture: 0 analyzed (even when
no series is anomalous — that itself is a finding), 2 on unreadable /
empty / meta-less bundles with a named error, never a raw traceback.
"""

import argparse
import json
import re
import sys

# Series whose movement restates the trigger rather than explaining it.
DEFAULT_EXCLUDED_SERIES = frozenset({
    "tpu_obs_events_total",
    "tpu_metrics_dropped_samples_total",
    "tpu_flight_dumps_total",
    "tpu_flight_dropped_snapshots_total",
})

# Error-class series win timestamp ties against whatever they dragged
# along (a queue gauge jumping in the same snapshot as the wedge
# counter is a symptom, not a cause).
ERROR_CLASS_RE = re.compile(
    r"wedge|desync|error|fault|fail|drop|shed|retr|restart|evict|"
    r"stale|dead|abort"
)

DEFAULT_K = 8.0
MIN_PRIOR_POINTS = 4
ROLLING_WINDOW = 40
SCORE_CAP = 1e9
# Absolute sigma floor for duration (``*_seconds``) series: sub-ms
# movement is scheduler noise on any real host, never the postmortem
# headline — a wedge/stall moves these series by whole timeouts.
DURATION_FLOOR_S = 1e-3


class PostmortemError(ValueError):
    """Named analysis error (bad bundle, not a bug) — rc 2."""


def _median(xs):
    ordered = sorted(xs)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def load_bundle(path):
    """Parse a bundle into ``(meta, trigger, snapshots)``; raises
    :class:`PostmortemError` on empty / meta-less / malformed input."""
    meta = None
    trigger = None
    snapshots = []
    try:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise PostmortemError(
                        f"{path}:{lineno}: not JSONL ({e.msg})"
                    ) from e
                record = rec.get("record")
                if record == "meta":
                    meta = rec
                elif record == "trigger":
                    trigger = rec
                elif record == "snapshot":
                    snapshots.append(rec)
    except OSError as e:
        raise PostmortemError(f"cannot read bundle: {e}") from e
    if meta is None and trigger is None and not snapshots:
        raise PostmortemError(
            f"{path}: no flight-recorder records (is this a bundle? "
            f"expected JSONL with a 'record' field)"
        )
    if meta is None:
        raise PostmortemError(
            f"{path}: no meta record — bundle is torn or not from "
            f"obs.flight (re-dump, or pass the right file)"
        )
    if trigger is None:
        raise PostmortemError(f"{path}: no trigger record")
    if not snapshots:
        raise PostmortemError(
            f"{path}: no snapshots — the recorder dumped an empty "
            f"ring (trigger fired before the first poll?)"
        )
    return meta, trigger, snapshots


def base_series_name(key):
    """Metric name of a bundle series key (labels and the ``:count`` /
    ``:mean`` derivation stripped)."""
    return key.split("{", 1)[0].split(":", 1)[0]


def build_timelines(snapshots, excluded=DEFAULT_EXCLUDED_SERIES):
    """``{series_key: [(ts, value), ...]}`` across the snapshot ring.

    Counters are per-interval deltas (absent means 0); gauges carry
    their last sample forward; histograms become ``key:count`` (delta,
    counter semantics) and ``key:mean`` (per-interval mean, gauge
    semantics, only at observed points)."""
    counter_keys = set()
    gauge_keys = set()
    for snap in snapshots:
        counter_keys.update(snap.get("counters", ()))
        for key in snap.get("histograms", ()):
            counter_keys.add(key + ":count")
        gauge_keys.update(snap.get("gauges", ()))
    counter_keys = {
        k for k in counter_keys if base_series_name(k) not in excluded
    }
    gauge_keys = {
        k for k in gauge_keys if base_series_name(k) not in excluded
    }
    series = {k: [] for k in counter_keys | gauge_keys}
    last_gauge = {}
    for snap in snapshots:
        ts = snap.get("ts", 0.0)
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        histograms = snap.get("histograms", {})
        for key in counter_keys:
            if key.endswith(":count"):
                hist = histograms.get(key[:-len(":count")])
                value = hist.get("count", 0) if hist else 0
            else:
                value = counters.get(key, 0.0)
            series[key].append((ts, float(value)))
        for key, hist in histograms.items():
            if base_series_name(key) in excluded:
                continue
            count = hist.get("count", 0)
            if count:
                series.setdefault(key + ":mean", []).append(
                    (ts, hist.get("sum", 0.0) / count)
                )
        for key in gauge_keys:
            if key in gauges:
                last_gauge[key] = float(gauges[key])
            if key in last_gauge:
                series[key].append((ts, last_gauge[key]))
    return {k: pts for k, pts in series.items() if pts}


def detect_anomalies(points, k=DEFAULT_K, min_prior=MIN_PRIOR_POINTS,
                     window=ROLLING_WINDOW, abs_floor=1e-6):
    """Changepoints of one ``[(ts, value), ...]`` series.

    For each point with >= ``min_prior`` priors: robust sigma =
    max(1.4826*MAD, 0.25*|median|, half the prior range, ``abs_floor``)
    over the rolling prior window; anomalous when |x - median| / sigma
    > ``k`` (duration series get :data:`DURATION_FLOOR_S` via
    :func:`rank_anomalies`). The relative floor keeps constant-rate counters (delta
    4,4,4,5,...) quiet; the MAD term absorbs real jitter; the
    half-range floor absorbs heavy-tailed/bimodal noise MAD
    underestimates (wall-clock duration means blip 10x without being
    changepoints — a value near the historically seen range is not
    news); an all-zero baseline keeps every floor at zero, so any jump
    scores ~1e6 — exactly the step-function shape a wedge/desync
    counter produces."""
    out = []
    for i in range(min_prior, len(points)):
        prior = [v for _, v in points[max(0, i - window):i]]
        med = _median(prior)
        mad = _median([abs(v - med) for v in prior])
        sigma = max(1.4826 * mad, 0.25 * abs(med),
                    (max(prior) - min(prior)) / 2.0, abs_floor)
        score = min(abs(points[i][1] - med) / sigma, SCORE_CAP)
        if score > k:
            out.append({
                "ts": points[i][0],
                "value": points[i][1],
                "median": med,
                "score": round(score, 3),
            })
    return out


def rank_anomalies(timelines, k=DEFAULT_K):
    """Each series' FIRST anomaly, ranked: earliest timestamp wins;
    ties go to error-class series (the wedge counter beats the queue
    gauge it moved with), then higher score, then name."""
    firsts = []
    for key, points in sorted(timelines.items()):
        floor = (
            DURATION_FLOOR_S
            if base_series_name(key).endswith("_seconds") else 1e-6
        )
        found = detect_anomalies(points, k=k, abs_floor=floor)
        if found:
            first = found[0]
            firsts.append({"series": key, **first})
    firsts.sort(key=lambda a: (
        a["ts"],
        0 if ERROR_CLASS_RE.search(a["series"]) else 1,
        -a["score"],
        a["series"],
    ))
    return firsts


def correlate_events(snapshots, trigger):
    """Notable tail records (chaos, health, alerts, link, dumps) as
    ``[{"kind", "ts", "rel_s", "note"}]`` ordered by time, plus any
    trace_ids seen (events first, then span args)."""
    trigger_wall = trigger.get("wall_ts", trigger.get("ts", 0.0))
    notes = []
    trace_ids = []
    seen_ids = set()

    def _note_id(value):
        if value and value not in seen_ids:
            seen_ids.add(value)
            trace_ids.append(value)

    records = []
    for snap in snapshots:
        records.extend(snap.get("events", ()))
    for rec in records:
        kind = rec.get("kind") or rec.get("event")
        ts = rec.get("ts", 0.0)
        _note_id(rec.get("trace_id"))
        if kind == "fault_injected":
            note = (
                f"chaos fault {rec.get('fault')} at site "
                f"{rec.get('site')} (delay_s={rec.get('delay_s')})"
            )
        elif kind == "health_transition":
            note = f"health transition to {rec.get('to')}"
        elif kind == "alert_fired":
            note = f"alert {rec.get('rule')} fired"
        elif kind == "link_wedged":
            note = (
                f"link wedged at rank {rec.get('rank')} op "
                f"{rec.get('op')} (stalled_s={rec.get('stalled_s')})"
            )
        elif kind == "link_desync":
            note = (
                f"link desync at rank {rec.get('rank')}: "
                f"{rec.get('reason')}"
            )
        elif kind == "flight_dump":
            note = (
                f"flight dump ({rec.get('trigger')}) -> "
                f"{rec.get('path')}"
            )
        else:
            continue
        notes.append({
            "kind": kind,
            "ts": ts,
            "rel_s": round(ts - trigger_wall, 3),
            "note": note,
        })
    for snap in snapshots:
        for span in snap.get("spans", ()):
            args = span.get("args")
            if isinstance(args, dict):
                _note_id(args.get("trace_id"))
    notes.sort(key=lambda n: n["ts"])
    return notes, trace_ids


def analyze(path, k=DEFAULT_K, excluded=DEFAULT_EXCLUDED_SERIES):
    """Full analysis of one bundle -> summary dict (see main())."""
    meta, trigger, snapshots = load_bundle(path)
    timelines = build_timelines(snapshots, excluded=excluded)
    ranked = rank_anomalies(timelines, k=k)
    notes, trace_ids = correlate_events(snapshots, trigger)
    trigger_ts = trigger.get("ts", 0.0)
    first = None
    if ranked:
        first = dict(ranked[0])
        first["rel_to_trigger_s"] = round(first["ts"] - trigger_ts, 6)
    n_events = sum(len(s.get("events", ())) for s in snapshots)
    n_spans = sum(len(s.get("spans", ())) for s in snapshots)
    return {
        "bundle": path,
        "host": meta.get("host"),
        "trigger": {
            "kind": trigger.get("kind"),
            "ts": trigger_ts,
            "wall_ts": trigger.get("wall_ts"),
        },
        "window_s": meta.get("window_s"),
        "interval_s": meta.get("interval_s"),
        "snapshots": len(snapshots),
        "series": len(timelines),
        "events": n_events,
        "spans": n_spans,
        "first_anomaly": first,
        "anomalies": ranked,
        "correlated_events": notes,
        "trace_ids": trace_ids,
    }


def render_report(summary):
    lines = []
    trig = summary["trigger"]
    lines.append(f"postmortem: {summary['bundle']}")
    lines.append(
        f"trigger: {trig['kind']} at recorder ts "
        f"{trig['ts']:.3f} (wall {trig.get('wall_ts')})"
    )
    lines.append(
        f"window: {summary['window_s']}s @ {summary['interval_s']}s "
        f"-> {summary['snapshots']} snapshots, {summary['series']} "
        f"series, {summary['events']} events, {summary['spans']} spans"
    )
    lines.append("")
    first = summary["first_anomaly"]
    if first is None:
        lines.append(
            "first anomaly: NONE — no recorded series deviates from "
            "its rolling median beyond the noise bands. The cause is "
            "outside the recorded window or outside these registries."
        )
    else:
        lines.append(
            f"first anomaly: {first['series']} at ts "
            f"{first['ts']:.3f} ({first['rel_to_trigger_s']:+.3f}s vs "
            f"trigger), value {first['value']:g} vs median "
            f"{first['median']:g}, score {first['score']:g}"
        )
    extra = summary["anomalies"][1:6]
    if extra:
        lines.append("then:")
        for a in extra:
            lines.append(
                f"  {a['series']} at ts {a['ts']:.3f} "
                f"(value {a['value']:g} vs median {a['median']:g}, "
                f"score {a['score']:g})"
            )
    if summary["correlated_events"]:
        lines.append("")
        lines.append("correlated events:")
        for n in summary["correlated_events"][:20]:
            lines.append(f"  {n['rel_s']:+8.3f}s  {n['note']}")
    if summary["trace_ids"]:
        lines.append("")
        joined = ", ".join(str(t) for t in summary["trace_ids"][:8])
        lines.append(
            f"trace ids in tail: {joined} — stitch with "
            f"python -m container_engine_accelerators_tpu_torch.obs.journey"
        )
    return "\n".join(lines) + "\n"


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m container_engine_accelerators_tpu_torch.obs."
             "postmortem",
        description="Analyze a flight-recorder postmortem bundle: "
                    "first-anomaly attribution + event correlation.",
    )
    parser.add_argument("bundle", help="bundle JSONL from obs.flight")
    parser.add_argument(
        "--summary-json", default="",
        help="also write the machine-readable summary to this path",
    )
    parser.add_argument(
        "--k", type=float, default=DEFAULT_K,
        help="anomaly threshold in robust sigmas (default %(default)s)",
    )
    parser.add_argument(
        "--include-series", action="append", default=[],
        metavar="NAME",
        help="un-exclude a self-detection series (repeatable)",
    )
    args = parser.parse_args(argv)
    excluded = frozenset(
        DEFAULT_EXCLUDED_SERIES - set(args.include_series)
    )
    try:
        summary = analyze(args.bundle, k=args.k, excluded=excluded)
        sys.stdout.write(render_report(summary))
        if args.summary_json:
            with open(args.summary_json, "w") as f:
                json.dump(summary, f, indent=2, sort_keys=True)
                f.write("\n")
    except (PostmortemError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
