# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Goodput accounting: attribute every wall-clock second of a run.

Copy of ``container_engine_accelerators_tpu/obs/goodput.py``, its imports
rewritten to the port's package; the contracts are the same. ``train_cli``
reads its ``report_files`` over the run's ``--event-log``.

A production TPU fleet is judged by *goodput* — the fraction of
wall-clock time spent making forward progress — not by raw throughput
in the good minutes. MegaScale (Jiang et al., NSDI'24) runs this
accounting continuously: every second of a training run is attributed
to productive work or to a *diagnosable* badput cause, so a 2% MFU
regression has a name attached. This module is that layer for the
stack: it consumes the telemetry the earlier tiers already emit — the
unified event stream (``train_step``, ``train_recovery``,
``fault_injected``, ``request_retired``, ``step_retry``,
``migration_replayed``, ``warmup_done``, ``checkpoint_fallback``,
``link_wedged``) and
the span traces (``checkpoint`` / ``restore`` / ``init_state`` /
``warmup``) — and produces a :class:`TimeLedger`
whose categories sum to the run's wall clock exactly.

Badput-cause taxonomy (``CAUSES``):

  ``productive``       a train step / a served request was running
  ``compile``          model init + first-compile spans (``init_state``)
  ``checkpoint``       checkpoint save/restore spans
  ``restart_backoff``  deliberate recovery sleeps (supervisor restart
                       backoff, serving step-retry backoff)
  ``wedged``           time lost to a stalled, crashed, or slowed
                       attempt: the gap from the last completed work to
                       the recovery decision, plus injected/observed
                       straggler delay
  ``drain_migration``  extra latency a request paid for being migrated
                       off an unhealthy slot (re-admission + re-prefill)
  ``idle``             none of the above (uncovered wall clock)

Overlaps resolve by precedence (badput causes outrank ``productive``:
a straggler sleep inside a step is badput even though the step's
duration envelope covers it); uncovered time is ``idle``. On top of the
category ledger, ``fault_injected`` events let the report charge the
recovery seconds each fault *caused* back to the fault kind
(``by_fault``: chip_wedge / preemption / straggler / …), so a chaos
drill shows not just how much badput there was but which injected
fault class bought it. ``by_fault`` is *causal charging*, not a
partition: only the category table is guaranteed to sum to wall clock
— when two faults' damage windows overlap (a straggler sleeping inside
a stall another fault provoked), each is charged its full cost, so
``sum(by_fault)`` may exceed the unioned badput seconds.

Report CLI (merges per-host event logs and span-trace JSONL twins,
reusing ``obs/fleet.py``'s clock-skew correction)::

    python -m container_engine_accelerators_tpu_torch.obs.goodput report \
        host0.jsonl host0_trace.json.jsonl [--summary-json s.json]

Exported metrics (``TimeLedger.export`` / ``report --serve-port``):
``tpu_goodput_ratio`` and ``tpu_badput_seconds_total{cause}``.
"""

import argparse
import json
import os
import sys

from container_engine_accelerators_tpu_torch.obs import fleet as obs_fleet
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.obs import trace as obs_trace

CAUSES = (
    "productive",
    "compile",
    "checkpoint",
    "restart_backoff",
    "wedged",
    "drain_migration",
    "reissue_wait",
    "idle",
)

# Overlap resolution, highest precedence first. Badput causes outrank
# productive: the time a straggler slept inside a step's duration
# envelope was NOT productive, even though the step span covers it.
PRECEDENCE = (
    "wedged",
    "restart_backoff",
    "drain_migration",
    "reissue_wait",
    "checkpoint",
    "compile",
    "productive",
)

# Span names -> causes (the train loop's spans; serving phases are
# accounted through events instead — concurrent requests overlap in
# wall time, but their event records carry explicit durations).
SPAN_CAUSES = {
    "checkpoint": "checkpoint",
    "restore": "checkpoint",
    "init_state": "compile",
    "compile": "compile",
    "warmup": "compile",
}

GOODPUT_RATIO_NAME = "tpu_goodput_ratio"
BADPUT_SECONDS_NAME = "tpu_badput_seconds_total"


class TimeLedger:
    """Attributes wall-clock intervals to causes.

    ``attribute(start, end, cause)`` records one interval; ``totals()``
    sweeps the timeline once, resolving overlaps by :data:`PRECEDENCE`
    (same-cause overlaps count once — re-attributing the same work from
    two telemetry sources is harmless) and attributing every uncovered
    second of the ledger's span to ``idle``. By construction the
    category totals sum to the wall clock exactly.
    """

    def __init__(self, start=None, end=None):
        # Optional explicit span; defaults to the attributed extent.
        self.start = start
        self.end = end
        self._intervals = []  # (start, end, cause)

    def attribute(self, start, end, cause):
        if cause not in PRECEDENCE:
            raise ValueError(
                f"unknown cause {cause!r}; attributable: {PRECEDENCE}"
            )
        start, end = float(start), float(end)
        if end <= start:
            return
        self._intervals.append((start, end, cause))

    @property
    def empty(self):
        return not self._intervals and self.start is None

    def span(self):
        """The ledger's wall-clock extent ``(start, end)``."""
        if self._intervals:
            lo = min(s for s, _, _ in self._intervals)
            hi = max(e for _, e, _ in self._intervals)
        else:
            lo = hi = 0.0
        if self.start is not None:
            lo = min(lo, self.start) if self._intervals else self.start
        if self.end is not None:
            hi = max(hi, self.end) if self._intervals else self.end
        return lo, hi

    def totals(self):
        """``{cause: seconds}`` over every cause in :data:`CAUSES`
        (idle included); values sum to ``wall_s()`` exactly."""
        lo, hi = self.span()
        out = {c: 0.0 for c in CAUSES}
        if hi <= lo:
            return out
        # Boundary sweep: +1/-1 per cause at each interval edge, one
        # O(n log n) pass regardless of overlap depth.
        edges = []
        idx = {c: i for i, c in enumerate(PRECEDENCE)}
        for s, e, c in self._intervals:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            edges.append((s, 1, idx[c]))
            edges.append((e, -1, idx[c]))
        edges.sort(key=lambda t: t[0])
        active = [0] * len(PRECEDENCE)
        prev = lo
        i = 0
        while i <= len(edges):
            t = edges[i][0] if i < len(edges) else hi
            if t > prev:
                cause = "idle"
                for j, c in enumerate(PRECEDENCE):
                    if active[j] > 0:
                        cause = c
                        break
                out[cause] += t - prev
                prev = t
            if i == len(edges):
                break
            active[edges[i][2]] += edges[i][1]
            i += 1
        if hi > prev:
            out["idle"] += hi - prev
        return out

    def wall_s(self):
        lo, hi = self.span()
        return max(hi - lo, 0.0)

    def goodput_ratio(self):
        wall = self.wall_s()
        return self.totals()["productive"] / wall if wall > 0 else 0.0

    def export(self, registry=None):
        """One-shot export into ``registry`` (default the process
        registry): ``tpu_goodput_ratio`` gauge +
        ``tpu_badput_seconds_total{cause}`` counter. Call once per
        finished run — the counter accumulates across exports by
        design (Prometheus counters only go up)."""
        reg = registry if registry is not None else obs_metrics.REGISTRY
        ratio = obs_metrics.get_or_create(
            obs_metrics.Gauge, GOODPUT_RATIO_NAME,
            "Fraction of the accounted wall clock spent productive "
            "(train steps / served requests)", registry=reg,
        )
        ratio.set(self.goodput_ratio())
        badput = obs_metrics.get_or_create(
            obs_metrics.Counter, BADPUT_SECONDS_NAME,
            "Wall-clock seconds attributed to a non-productive cause "
            "(badput taxonomy: docs/observability.md)",
            labelnames=("cause",), registry=reg,
        )
        for cause, secs in self.totals().items():
            if cause != "productive" and secs > 0:
                badput.labels(cause).inc(secs)
        return reg


def _kind(rec):
    """Event kind under either schema key (``kind`` / legacy
    ``event``)."""
    return rec.get("kind") or rec.get("event")


class LedgerBuilder:
    """Feeds unified-stream events and trace spans into one ledger,
    charging recovery seconds back to the fault that caused them.

    Events must be fed in timestamp order for ``by_fault`` attribution
    (each recovery is charged to the most recent faulting injection);
    :func:`build_ledger` sorts for you.
    """

    def __init__(self):
        self.ledger = TimeLedger()
        self.by_fault = {}
        self._last_fault = None
        self.counts = {}
        # Radix prefix reuse (paged serving engine): tokens whose
        # prefill the cache avoided and the engine's estimate of the
        # seconds that prefill would have cost. Reused-prefix prefill
        # is SUBTRACTED from the attribution math by construction —
        # the productive envelope of a retired request covers only the
        # latency it actually paid, and the avoided seconds are
        # reported separately (never added to productive or compile)
        # so the demand a cache-less engine would have had to serve is
        # still reconstructible as productive + reused_prefill_s.
        self.prefix_hit_tokens = 0
        self.reused_prefill_s = 0.0
        # Speculative-decoding credit: each accepted token is one
        # sequential decode device step the engine did not dispatch
        # (the verify that carried it was already counted as a step).
        # Reported alongside prefix_reuse — informational, never
        # folded into the time attribution.
        self.spec_accepted_tokens = 0
        # Chip accounting (obs/devicetime.py): attributed device
        # seconds summed off request_retired's device_s attr. The
        # device_utilization rollup (device_s / productive wall) is
        # informational exactly like speculation.saved_steps — the
        # attribution math above is untouched.
        self.device_s = 0.0
        # Tail-tolerance spend (fleet router): seconds requests waited
        # on a straggling primary before the hedge arm fired, and
        # seconds burned on failed primaries before an at-most-once
        # re-issue. The hedge wait is informational (the request's wall
        # time already sits inside its productive envelope); the
        # re-issue wait is real badput — the failed attempt bought
        # nothing — so it is ALSO attributed as ``reissue_wait`` and
        # charged back to the provoking fault like a failed handoff.
        self.hedge_wait_s = 0.0
        self.reissue_wait_s = 0.0

    def _charge(self, seconds):
        if seconds > 0 and self._last_fault is not None:
            self.by_fault[self._last_fault] = (
                self.by_fault.get(self._last_fault, 0.0) + seconds
            )

    def add_event(self, rec, offset_s=0.0):
        kind = _kind(rec)
        ts = rec.get("ts")
        if kind is None or ts is None:
            return
        ts = float(ts) + offset_s
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if kind == "train_step":
            dur = float(rec.get("dur_s") or 0.0)
            self.ledger.attribute(ts - dur, ts, "productive")
        elif kind == "request_retired":
            dur = float(rec.get("latency_s") or 0.0)
            self.ledger.attribute(ts - dur, ts, "productive")
            self.prefix_hit_tokens += int(
                rec.get("prefix_hit_tokens") or 0
            )
            self.reused_prefill_s += float(
                rec.get("reused_prefill_s") or 0.0
            )
            self.spec_accepted_tokens += int(
                rec.get("spec_accepted_tokens") or 0
            )
            self.device_s += float(rec.get("device_s") or 0.0)
        elif kind == "migration_replayed":
            lost = float(rec.get("lost_s") or 0.0)
            self.ledger.attribute(ts - lost, ts, "drain_migration")
            self._charge(lost)
        elif kind == "kv_handoff_failed":
            # A cross-replica KV block transfer died mid-wire
            # (fleet/router.py --handoff): the request survived — it
            # fell back to a local re-prefill — but the seconds the
            # doomed transfer burned are extra latency that request
            # paid, the same shape as a drain migration's replay.
            lost = float(rec.get("lost_s") or 0.0)
            self.ledger.attribute(ts - lost, ts, "drain_migration")
            self._charge(lost)
        elif kind == "request_hedged":
            self.hedge_wait_s += float(rec.get("elapsed_s") or 0.0)
        elif kind == "request_reissued":
            lost = float(rec.get("elapsed_s") or 0.0)
            self.ledger.attribute(ts - lost, ts, "reissue_wait")
            self._charge(lost)
            self.reissue_wait_s += lost
        elif kind == "train_recovery":
            stalled = float(rec.get("stalled_s") or 0.0)
            backoff = float(rec.get("backoff_s") or 0.0)
            self.ledger.attribute(ts - stalled, ts, "wedged")
            self.ledger.attribute(ts, ts + backoff, "restart_backoff")
            self._charge(stalled + backoff)
        elif kind == "step_retry":
            backoff = float(rec.get("backoff_s") or 0.0)
            self.ledger.attribute(ts, ts + backoff, "restart_backoff")
            self._charge(backoff)
        elif kind == "link_wedged":
            # A lockstep collective stalled past --link-timeout-s
            # (serve_cli's supervised engine link): the whole gang was
            # blocked for stalled_s before the watchdog fired — pure
            # wedge badput, charged back to the provoking fault.
            stalled = float(rec.get("stalled_s") or 0.0)
            self.ledger.attribute(ts - stalled, ts, "wedged")
            self._charge(stalled)
        elif kind == "warmup_done":
            # AOT warmup before /healthz flips ready: deliberate
            # compile time (warmstart/warmup.py). A cache-hit replay
            # still emits the event — with near-zero dur_s, which is
            # exactly the "charged once per binary" signal the
            # restart-storm drill asserts on.
            dur = float(rec.get("dur_s") or 0.0)
            self.ledger.attribute(ts - dur, ts, "compile")
        elif kind == "checkpoint_fallback":
            # A failed restore attempt before the walk fell back to the
            # prior step (utils/checkpointing.restore_latest): time
            # spent reading a checkpoint that turned out unreadable.
            dur = float(rec.get("dur_s") or 0.0)
            self.ledger.attribute(ts - dur, ts, "checkpoint")
            self._charge(dur)
        elif kind == "fault_injected":
            fault = rec.get("fault") or "unknown"
            delay = float(rec.get("delay_s") or 0.0)
            if fault == "straggler":
                # The injected sleep happens inside the step/chunk that
                # envelopes it; precedence carves it out of productive.
                self.ledger.attribute(ts, ts + delay, "wedged")
                self.by_fault[fault] = (
                    self.by_fault.get(fault, 0.0) + delay
                )
            else:
                # Charged when the recovery it provokes lands.
                self._last_fault = fault
                self.by_fault.setdefault(fault, 0.0)

    def add_span(self, name, wall_start, dur_s, offset_s=0.0):
        cause = SPAN_CAUSES.get(name)
        if cause is None:
            if name == "step":
                cause = "productive"
            else:
                return
        start = float(wall_start) + offset_s
        self.ledger.attribute(start, start + float(dur_s), cause)


def build_ledger(records=(), spans=(), offset_s=0.0):
    """One host's ledger from event records and/or
    ``(name, wall_start_s, dur_s)`` span rows. Returns the builder
    (``.ledger``, ``.by_fault``, ``.counts``)."""
    b = LedgerBuilder()
    for rec in sorted(records, key=lambda r: r.get("ts") or 0.0):
        b.add_event(rec, offset_s=offset_s)
    for name, start, dur in spans:
        b.add_span(name, start, dur, offset_s=offset_s)
    return b


# -- file loading + per-host report -------------------------------------------


class GoodputInputError(ValueError):
    """Unusable report input; the message names the file and the fix."""


def load_file(path):
    """Split one JSONL file into ``(host, events, span_rows, epoch_s,
    meta)``; span rows keep their FULL records (including occurrence
    attrs like ``step``) so skew alignment matches the fleet merger's.

    Accepts both input shapes the stack writes: unified event logs
    (``--event-log``) and span-trace twins (``--trace-out``'s
    ``.jsonl``, meta line included). ``host`` comes from the trace
    meta, the events' ``host`` field, or the file stem."""
    host = os.path.splitext(os.path.basename(path))[0]
    events, span_rows = [], []
    meta = None
    epoch_s = 0.0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as err:
                raise GoodputInputError(
                    f"{path}:{lineno}: not JSON ({err}); expected an "
                    f"--event-log or --trace-out .jsonl file"
                ) from err
            if rec.get("name") == obs_trace.JSONL_META_NAME:
                meta = rec
                host = rec.get("host", host)
                epoch_s = int(rec.get("epoch_ns", 0)) * 1e-9
            elif "start_s" in rec and "dur_s" in rec and "name" in rec:
                span_rows.append(rec)
            elif "ts" in rec and _kind(rec):
                events.append(rec)
                if rec.get("host"):
                    host = rec["host"]
    if not events and not span_rows:
        raise GoodputInputError(
            f"{path}: no event or span records (empty or unrelated "
            f"JSONL); pass --event-log files and/or --trace-out "
            f".jsonl twins"
        )
    return host, events, span_rows, epoch_s, meta


def report_files(paths, align_span=None):
    """The CLI's core: per-host ledgers + a merged fleet summary.

    Span-trace inputs are clock-skew corrected exactly like the fleet
    merger (``obs/fleet.py``): a barrier-backed span shared by every
    traced host aligns the clocks, and each host's offset shifts its
    events too (event logs and trace twins from one host share that
    host's clock)."""
    per_host = {}  # host -> {"events": [...], "spans": [...]}
    traces = []  # fleet.HostTrace rows for skew estimation
    for path in paths:
        host, events, rows, epoch_s, meta = load_file(path)
        d = per_host.setdefault(host, {"events": [], "spans": []})
        d["events"].extend(events)
        d["spans"].extend(
            (r["name"], epoch_s + float(r["start_s"]),
             float(r["dur_s"]))
            for r in rows
        )
        if meta is not None:
            # The RAW span records ride along: the occurrence attrs
            # (step/pass/seq) are what lets fleet._align_occurrences
            # pair the same barrier occurrence across hosts — reducing
            # to (name, start) tuples would silently degrade alignment
            # to positional matching.
            traces.append(obs_fleet.HostTrace(
                host=host,
                epoch_ns=int(meta.get("epoch_ns", 0)),
                spans=rows,
                path=path,
            ))
    offsets = {}
    if len(traces) > 1:
        offsets = obs_fleet.estimate_offsets(traces,
                                             align_span=align_span)
    hosts = {}
    total = TimeLedger()
    total_by_fault = {}
    total_hit_tokens = 0
    total_reused_s = 0.0
    total_spec_saved = 0
    total_hedge_wait = 0.0
    total_reissue_wait = 0.0
    total_device_s = 0.0
    for host in sorted(per_host):
        d = per_host[host]
        off = offsets.get(host, 0.0)
        b = build_ledger(d["events"], d["spans"], offset_s=off)
        totals = b.ledger.totals()
        wall = b.ledger.wall_s()
        hosts[host] = {
            "wall_s": round(wall, 6),
            "goodput_ratio": round(b.ledger.goodput_ratio(), 6),
            "seconds": {c: round(v, 6) for c, v in totals.items()},
            "by_fault": {k: round(v, 6) for k, v in b.by_fault.items()},
            "events": b.counts,
            "prefix_reuse": {
                "hit_tokens": b.prefix_hit_tokens,
                "reused_prefill_s": round(b.reused_prefill_s, 6),
            },
            "speculation": {
                "saved_steps": b.spec_accepted_tokens,
            },
            "tail_tolerance": {
                "hedge_wait_s": round(b.hedge_wait_s, 6),
                "reissue_wait_s": round(b.reissue_wait_s, 6),
            },
            "device_utilization": {
                "device_s": round(b.device_s, 6),
                "ratio": round(
                    b.device_s / totals.get("productive", 0.0), 6
                ) if totals.get("productive", 0.0) > 0 else 0.0,
            },
        }
        total_device_s += b.device_s
        total_hit_tokens += b.prefix_hit_tokens
        total_reused_s += b.reused_prefill_s
        total_spec_saved += b.spec_accepted_tokens
        total_hedge_wait += b.hedge_wait_s
        total_reissue_wait += b.reissue_wait_s
        for s, e, c in b.ledger._intervals:
            total.attribute(s, e, c)
        lo, hi = b.ledger.span()
        total.start = lo if total.start is None else min(total.start, lo)
        total.end = hi if total.end is None else max(total.end, hi)
        for k, v in b.by_fault.items():
            total_by_fault[k] = total_by_fault.get(k, 0.0) + v
    # The merged ledger spans the union of per-host timelines; per-host
    # numbers are authoritative for "what did THIS host do", the total
    # for "what did the fleet's wall clock buy".
    summary = {
        "hosts": hosts,
        "clock_offsets_s": {h: round(o, 6) for h, o in offsets.items()},
        "total": {
            "wall_s": round(total.wall_s(), 6),
            "goodput_ratio": round(total.goodput_ratio(), 6),
            "seconds": {
                c: round(v, 6) for c, v in total.totals().items()
            },
            "by_fault": {
                k: round(v, 6) for k, v in total_by_fault.items()
            },
            "prefix_reuse": {
                "hit_tokens": total_hit_tokens,
                "reused_prefill_s": round(total_reused_s, 6),
            },
            "speculation": {
                "saved_steps": total_spec_saved,
            },
            "tail_tolerance": {
                "hedge_wait_s": round(total_hedge_wait, 6),
                "reissue_wait_s": round(total_reissue_wait, 6),
            },
            "device_utilization": {
                "device_s": round(total_device_s, 6),
                "ratio": round(
                    total_device_s / total.totals().get("productive", 0.0),
                    6,
                ) if total.totals().get("productive", 0.0) > 0 else 0.0,
            },
        },
    }
    return summary, total


def _print_report(summary, out=sys.stdout):
    w = out.write
    hosts = summary["hosts"]
    w(f"# goodput: {len(hosts)} host(s): {', '.join(hosts)}\n")
    offs = summary.get("clock_offsets_s", {})
    if offs:
        w("# clock offsets vs reference host:\n")
        for h, o in offs.items():
            w(f"#   {h}: {o:+.6f}s\n")
    w(f"{'host':<20}{'wall s':>10}{'goodput':>9}  causes (s)\n")
    rows = list(hosts.items()) + [("TOTAL", summary["total"])]
    for host, row in rows:
        causes = "  ".join(
            f"{c}={row['seconds'][c]:.3f}"
            for c in CAUSES if row["seconds"].get(c, 0.0) > 0
        )
        w(f"{host:<20}{row['wall_s']:>10.3f}"
          f"{row['goodput_ratio']:>9.4f}  {causes}\n")
    by_fault = summary["total"].get("by_fault", {})
    if by_fault:
        w("# badput charged to injected/observed faults:\n")
        for k in sorted(by_fault):
            w(f"#   {k}: {by_fault[k]:.3f}s\n")
    reuse = summary["total"].get("prefix_reuse", {})
    if reuse.get("hit_tokens"):
        w(f"# prefix reuse: {reuse['hit_tokens']} prompt tokens served "
          f"from the radix cache; ~{reuse['reused_prefill_s']:.3f}s of "
          f"prefill avoided (subtracted — not in productive/compile)\n")
    spec = summary["total"].get("speculation", {})
    if spec.get("saved_steps"):
        w(f"# speculation: {spec['saved_steps']} accepted tokens — "
          f"that many sequential decode device steps never "
          f"dispatched\n")
    devu = summary["total"].get("device_utilization", {})
    if devu.get("device_s"):
        w(f"# device utilization: {devu['device_s']:.3f}s attributed "
          f"device wall inside retired requests "
          f"({devu['ratio']:.4f} of productive serving wall; "
          f"chip-accounting informational rollup)\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m container_engine_accelerators_tpu_torch.obs.goodput",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report", help="merge per-host event logs / span twins into a "
                       "goodput report")
    rep.add_argument("inputs", nargs="+",
                     help="per-host JSONL files: --event-log outputs "
                          "and/or --trace-out .jsonl twins")
    rep.add_argument("--align", default=None,
                     help="barrier span name for clock-skew correction "
                          "(obs/fleet.py semantics)")
    rep.add_argument("--summary-json", default="",
                     help="also write the full report as JSON here")
    rep.add_argument("--serve-port", type=int, default=0,
                     help="serve tpu_goodput_ratio / "
                          "tpu_badput_seconds_total for this report on "
                          "a /metrics port and block (convention: 2120, "
                          "see obs/ports.py; 0 = print and exit)")
    args = p.parse_args(argv)

    try:
        summary, total = report_files(args.inputs,
                                      align_span=args.align)
    except (GoodputInputError, OSError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.summary_json:
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=2)
    _print_report(summary)
    if args.serve_port:
        reg = obs_metrics.Registry()
        total.export(reg)
        server = obs_metrics.serve(
            args.serve_port, registry=reg, owner="goodput/SLO report "
            "(obs.goodput report --serve-port)",
        )
        print(f"# serving goodput metrics on "
              f":{server.server_address[1]}/metrics (ctrl-C to stop)")
        try:
            import threading

            threading.Event().wait()
        except KeyboardInterrupt:
            server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
