# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Fleet request-journey stitcher: trace_id -> waterfall + blame.

Copy of ``container_engine_accelerators_tpu/obs/journey.py``, its
imports rewritten to the port's package; the contracts are the same.

    python -m container_engine_accelerators_tpu_torch.obs.journey \
        router.jsonl host*.jsonl -o journeys.json \
        [--events events.jsonl] [--summary-json report.json] \
        [--trace-id HEX] [--serve-port N]

The fleet router mints a W3C trace context at ingress
(``--trace-sample``) and every hop carries it: the router's ``route``
envelope and per-leg ``dispatch`` spans, the ``kv_handoff`` transfer
leg, and the serving engine's ``queue -> admit -> prefill -> decode ->
retire`` track all record a ``trace_id`` attribute (obs/trace.py).
This module groups the merged per-host span files by that id — ONE
journey per request, across every replica it touched — and answers the
question a latency page actually asks: *which stage ate the TTFT?*

  * **stitching** — spans from N host files, clock-skew corrected by
    :func:`refine_offsets`: the barrier-median estimate from
    ``obs/fleet.py`` tightened with RPC-edge bounds. A router-side
    ``dispatch`` span CONTAINS the server-side ``request`` span it
    invoked, so for each traced edge the server's offset must land in
    ``[dispatch_start - request_start, dispatch_end - request_end]``;
    intersecting the intervals across edges bounds the skew to the RPC
    envelope overhead, usually far tighter than a barrier median.
  * **attribution** — each complete journey's route envelope is
    partitioned into the critical-path stages (STAGES below): the sum
    reconstructs the client-observed latency, and the largest
    TTFT-side stage is named ``guilty_stage`` — the journey the
    TTFT-histogram exemplars (obs/metrics.py) resolve to.
  * **waterfall** — ``-o`` writes one Chrome/Perfetto document: a
    process per journey, a thread row per (host, request track), and
    flow arrows linking every router dispatch to the server-side run
    it invoked.

Stage taxonomy (docs/observability.md has the full table)::

  router_queue     route start -> first serving dispatch (admission
                   control, affinity pick, prefill-leg + handoff wait)
  hedge_wait       first dispatch -> the WINNING dispatch (hedge fire
                   delay, or a failed primary's spend before re-issue)
  transport        winning dispatch envelope minus the server-side
                   request span (wire + marshalling overhead)
  admission_queue  server-side queue wait (enqueue -> admit)
  admit            slot admission (KV admit, prefix reuse)
  prefill          prompt prefill chunks (sum)
  decode           decode chunks, first token -> retirement
  interleave_gap   server-side request time not covered by the above
                   (chunked-prefill interleaving, loop scheduling)
  post_route       winning dispatch return -> route return (directory
                   updates, bookkeeping)
"""

import argparse
import json
import sys

from container_engine_accelerators_tpu_torch.obs import fleet
from container_engine_accelerators_tpu_torch.obs import ports as obs_ports

# The stages whose durations sum to the client-observed route latency,
# in critical-path order. The TTFT prefix is everything a first token
# waits on; decode and the trailing bookkeeping only shape TPOT.
TTFT_STAGES = (
    "router_queue", "hedge_wait", "transport",
    "admission_queue", "admit", "prefill",
)
STAGES = TTFT_STAGES + ("decode", "interleave_gap", "post_route")


def _overlap(a0, a1, b0, b1):
    """Signed overlap of two intervals (negative = disjoint)."""
    return min(a1, b1) - max(a0, b0)


# -- clock-skew refinement -----------------------------------------------------


def refine_offsets(traces, offsets=None):
    """Tighten barrier-median clock offsets with RPC-edge bounds.

    Convention: the FIRST trace is the reference (offset 0.0) — pass
    the router's file first; its ``dispatch`` spans are the client
    envelopes. For every other host, each (dispatch, request) pair of
    one trace_id yields an interval the host's true offset must lie
    in (containment: the server span happened INSIDE the dispatch
    envelope); the intersection across all edges brackets the skew,
    and the barrier estimate is clamped into it. Returns
    ``(offsets, info)`` — info records per-host edge counts and
    bounds for the report's ``clock`` section.
    """
    if offsets is None:
        offsets = fleet.estimate_offsets(traces)
    names = fleet.display_names(traces)
    refined = dict(offsets)
    info = {}
    if len(traces) < 2:
        return refined, info
    ref = traces[0]
    dispatches = {}
    for sp in ref.spans:
        if sp.get("name") != "dispatch":
            continue
        tid = sp.get("trace_id")
        if not tid:
            continue
        d0 = ref.wall_start(sp)
        dispatches.setdefault(tid, []).append(
            (d0, d0 + float(sp.get("dur_s") or 0.0),
             str(sp.get("replica") or ""))
        )
    for tr, disp in zip(traces[1:], names[1:]):
        lo, hi, edges = float("-inf"), float("inf"), 0
        for sp in tr.spans:
            if sp.get("name") != "request":
                continue
            cands = dispatches.get(sp.get("trace_id") or "")
            if not cands:
                continue
            s0 = tr.wall_start(sp)
            s1 = s0 + float(sp.get("dur_s") or 0.0)
            named = [c for c in cands if c[2] == tr.host]
            # When the dispatch's replica attr doesn't name this host
            # (hand-built files, NATed replicas), the WIDEST candidate
            # envelope is the safe pair: a wrong narrow pick would
            # fabricate bounds no correct clock satisfies.
            d0, d1, _ = max(named or cands, key=lambda c: c[1] - c[0])
            if (d1 - d0) < (s1 - s0):
                continue  # envelope can't contain the span: bad pair
            lo = max(lo, d0 - s0)
            hi = min(hi, d1 - s1)
            edges += 1
        base = refined.get(disp, 0.0)
        row = {"edges": edges, "barrier_offset_s": round(base, 6)}
        if edges and lo <= hi:
            clamped = min(max(base, lo), hi)
            refined[disp] = clamped
            row["lo_s"] = round(lo, 6)
            row["hi_s"] = round(hi, 6)
            row["refined_offset_s"] = round(clamped, 6)
            row["adjusted"] = clamped != base
        elif edges:
            # Bounds crossed: clock DRIFT within the window (or a
            # mismatched pair survived) — keep the barrier estimate.
            row["inconsistent"] = True
        info[disp] = row
    return refined, info


# -- stitching -----------------------------------------------------------------


def collect(traces, offsets):
    """Group trace_id-attributed spans across hosts: ``{trace_id:
    [span + host/wall_s/end_s, ...]}`` sorted by corrected wall
    start. Spans without a trace_id attr (untraced requests, barrier
    spans) don't journey."""
    names = fleet.display_names(traces)
    groups = {}
    for tr, disp in zip(traces, names):
        off = offsets.get(disp, 0.0)
        for sp in tr.spans:
            tid = sp.get("trace_id")
            if not tid:
                continue
            rec = dict(sp)
            rec["host"] = disp
            rec["wall_s"] = tr.wall_start(sp) + off
            rec["end_s"] = rec["wall_s"] + float(sp.get("dur_s") or 0.0)
            groups.setdefault(tid, []).append(rec)
    for spans in groups.values():
        spans.sort(key=lambda s: (s["wall_s"], s["end_s"]))
    return groups


def attribute(tid, spans):
    """One journey's critical-path decomposition (see STAGES).

    The winning dispatch is the earliest-finishing successful serving
    leg (hedges race; re-issues follow a failure); its server-side
    ``request`` span — matched by interval overlap — anchors the
    engine phases, which the engine files on one synthetic
    ``req-<rid>`` track per run, so (host, thread) separates a
    hedge's two runs."""
    route = None
    dispatches, requests, handoffs = [], [], []
    for sp in spans:
        n = sp.get("name")
        if n == "route":
            if route is None or sp["wall_s"] < route["wall_s"]:
                route = sp
        elif n == "dispatch":
            dispatches.append(sp)
        elif n == "request":
            requests.append(sp)
        elif n == "kv_handoff":
            handoffs.append(sp)
    legs = [{
        "leg": str(d.get("leg") or ""),
        "replica": str(d.get("replica") or ""),
        "start_s": round(d["wall_s"], 6),
        "dur_s": round(d["end_s"] - d["wall_s"], 6),
        "error": str(d.get("error") or ""),
    } for d in dispatches]
    serving = [d for d in dispatches if (d.get("leg") or "") != "prefill"]
    ok = [d for d in serving if not d.get("error")]
    winner = min(ok, key=lambda d: d["end_s"]) if ok else None
    req = None
    if requests and winner is not None:
        w0, w1 = winner["wall_s"], winner["end_s"]
        # The winner's run is CONTAINED in its dispatch envelope by
        # construction; raw overlap alone ties when a straggling
        # primary's long run also covers the hedge window. Fall back
        # to overlap only when clock correction broke containment.
        contained = [r for r in requests
                     if r["wall_s"] >= w0 - 1e-6
                     and r["end_s"] <= w1 + 1e-6]
        req = max(contained or requests, key=lambda r: _overlap(
            r["wall_s"], r["end_s"], w0, w1,
        ))
    elif requests:
        req = max(requests, key=lambda r: r["end_s"] - r["wall_s"])
    j = {
        "trace_id": tid,
        "n_spans": len(spans),
        "hosts": sorted({s["host"] for s in spans}),
        "hedged": any(leg["leg"] == "hedge" for leg in legs),
        "reissued": any(leg["leg"] == "reissue" for leg in legs),
        "handoffs": len(handoffs),
        "handoff_s": round(
            sum(h["end_s"] - h["wall_s"] for h in handoffs), 6,
        ),
        "legs": legs,
        "complete": bool(
            route is not None and winner is not None and req is not None
        ),
    }
    if route is not None:
        r0, r1 = route["wall_s"], route["end_s"]
    elif req is not None:
        r0, r1 = req["wall_s"], req["end_s"]
    else:
        r0 = min(s["wall_s"] for s in spans)
        r1 = max(s["end_s"] for s in spans)
    j["start_wall_s"] = round(r0, 6)
    j["client_latency_s"] = round(r1 - r0, 6)
    stages = {}
    prefill_end = None
    if req is not None:
        run_host, run_track = req["host"], req.get("thread")
        sq = sa = spf = sd = 0.0
        # Chip-accounting annotation: when the engine ran with
        # --chip-accounting, prefill/decode spans carry the attributed
        # device wall (obs/devicetime.py) — summed here so the stage
        # table can split host stage time into device vs loop overhead.
        dev_pf = dev_dec = 0.0
        for s in spans:
            if s["host"] != run_host or s.get("thread") != run_track:
                continue
            d = s["end_s"] - s["wall_s"]
            n = s.get("name")
            if n == "queue":
                sq += d
            elif n == "admit":
                sa += d
            elif n == "prefill":
                spf += d
                dev_pf += float(s.get("device_s") or 0.0)
                if prefill_end is None or s["end_s"] > prefill_end:
                    prefill_end = s["end_s"]
            elif n == "decode":
                sd += d
                dev_dec += float(s.get("device_s") or 0.0)
        if dev_pf or dev_dec:
            j["device_s"] = {
                "prefill": round(dev_pf, 6),
                "decode": round(dev_dec, 6),
            }
        s0, s1 = req["wall_s"], req["end_s"]
        stages["admission_queue"] = sq
        stages["admit"] = sa
        stages["prefill"] = spf
        stages["decode"] = sd
        stages["interleave_gap"] = max(
            0.0, (s1 - s0) - (sq + sa + spf + sd),
        )
        if route is not None and winner is not None:
            f0 = min(d["wall_s"] for d in serving)
            w0, w1 = winner["wall_s"], winner["end_s"]
            stages["router_queue"] = max(0.0, f0 - r0)
            stages["hedge_wait"] = max(0.0, w0 - f0)
            stages["transport"] = max(0.0, (w1 - w0) - (s1 - s0))
            stages["post_route"] = max(0.0, r1 - w1)
            j["winner_leg"] = str(winner.get("leg") or "")
            j["winner_replica"] = str(winner.get("replica") or "")
    j["stages"] = {k: round(v, 6) for k, v in stages.items()}
    j["stage_sum_s"] = round(sum(stages.values()), 6)
    if prefill_end is not None:
        j["ttft_s"] = round(prefill_end - r0, 6)
    blame = {k: v for k, v in stages.items()
             if k in TTFT_STAGES and v > 0}
    if blame:
        j["guilty_stage"] = max(blame, key=blame.get)
    return j


def fold_event(journeys, rec):
    """Annotate stitched journeys with unified-stream facts: the
    retirement (client latency cross-check), hedge/re-issue decisions
    with their straggler-wait ``elapsed_s``, handoff outcomes,
    migrations and sheds. Events without a matching journey (untraced
    requests, pre-trace history) fold to nothing."""
    kind = rec.get("kind") or rec.get("event")
    if kind == "request_retired":
        j = journeys.get(rec.get("trace_id") or "")
        if j is None:
            return
        j["retired"] = True
        j["retired_latency_s"] = float(rec.get("latency_s") or 0.0)
        j["tokens"] = int(rec.get("tokens") or 0)
        j["tenant"] = str(rec.get("tenant_class") or "default")
    elif kind == "request_hedged":
        j = journeys.get(rec.get("trace_id") or "")
        if j is None:
            return
        j["hedged"] = True
        j.setdefault("hedge_events", []).append({
            "outcome": str(rec.get("outcome") or ""),
            "replica": str(rec.get("replica") or ""),
            "elapsed_s": float(rec.get("elapsed_s") or 0.0),
        })
    elif kind == "request_reissued":
        j = journeys.get(rec.get("trace_id") or "")
        if j is None:
            return
        j["reissued"] = True
        j.setdefault("reissue_events", []).append({
            "replica": str(rec.get("replica") or ""),
            "error": str(rec.get("error") or ""),
            "elapsed_s": float(rec.get("elapsed_s") or 0.0),
        })
    elif kind == "kv_handoff":
        j = journeys.get(rec.get("trace_id") or "")
        if j is None:
            return
        j.setdefault("handoff_events", []).append({
            "src": str(rec.get("src") or ""),
            "dst": str(rec.get("dst") or ""),
            "blocks": int(rec.get("blocks") or 0),
            "latency_s": float(rec.get("latency_s") or 0.0),
        })
    elif kind == "kv_handoff_failed":
        j = journeys.get(rec.get("trace_id") or "")
        if j is None:
            return
        j.setdefault("handoff_failures", []).append({
            "src": str(rec.get("src") or ""),
            "dst": str(rec.get("dst") or ""),
            "reason": str(rec.get("reason") or ""),
            "lost_s": float(rec.get("lost_s") or 0.0),
        })
    elif kind == "request_migrated":
        j = journeys.get(rec.get("trace_id") or "")
        if j is None:
            return
        j.setdefault("migrations", 0)
        j["migrations"] += 1
        j.setdefault("migration_reasons", []).append(
            str(rec.get("reason") or "")
        )
    elif kind == "tenant_shed":
        j = journeys.get(rec.get("trace_id") or "")
        if j is None:
            return
        j.setdefault("sheds", []).append({
            "tenant_class": str(rec.get("tenant_class") or ""),
            "reason": str(rec.get("reason") or ""),
        })


def stage_rollups(journeys):
    """Per-stage duration percentiles across complete journeys — the
    fleet's critical-path profile."""
    out = {}
    for stage in STAGES:
        vals = sorted(
            j["stages"][stage] for j in journeys
            if stage in j.get("stages", {})
        )
        if not vals:
            continue
        out[stage] = {
            "count": len(vals),
            "p50_ms": round(fleet._percentile(vals, 0.50) * 1e3, 3),
            "p99_ms": round(fleet._percentile(vals, 0.99) * 1e3, 3),
            "max_ms": round(vals[-1] * 1e3, 3),
        }
    return out


def build_report(traces, events=(), align_span=None):
    """Stitch + attribute: ``(report, groups)``.

    ``report`` is the JSON-ready summary (journeys, per-stage
    percentiles, clock info, counts); ``groups`` the raw per-journey
    span lists :func:`journeys_chrome` renders."""
    offsets = fleet.estimate_offsets(traces, align_span=align_span)
    offsets, clock_info = refine_offsets(traces, offsets)
    groups = collect(traces, offsets)
    journeys = {tid: attribute(tid, spans)
                for tid, spans in groups.items()}
    for rec in sorted(events, key=lambda r: float(r.get("ts") or 0.0)):
        fold_event(journeys, rec)
    rows = sorted(journeys.values(),
                  key=lambda j: (j.get("start_wall_s", 0.0),
                                 j["trace_id"]))
    names = fleet.display_names(traces)
    return {
        "hosts": names,
        "clock": {
            "offsets_s": {
                n: round(offsets.get(n, 0.0), 6) for n in names
            },
            "rpc_edges": clock_info,
        },
        "journeys": rows,
        "stage_percentiles": stage_rollups(rows),
        "counts": {
            "journeys": len(rows),
            "complete": sum(1 for j in rows if j["complete"]),
            "retired": sum(1 for j in rows if j.get("retired")),
            "hedged": sum(1 for j in rows if j.get("hedged")),
            "reissued": sum(1 for j in rows if j.get("reissued")),
            "handoffs": sum(j.get("handoffs", 0) for j in rows),
        },
    }, groups


def find_journey(report, trace_id):
    """The journey for ``trace_id`` (full 32-hex id or a prefix —
    exemplar labels and Perfetto row names truncate), or None."""
    for j in report["journeys"]:
        if j["trace_id"] == trace_id or (
            trace_id and j["trace_id"].startswith(trace_id)
        ):
            return j
    return None


# -- Perfetto waterfall --------------------------------------------------------


def journeys_chrome(groups, journeys=None):
    """One Chrome trace-event document: a process per journey (named
    by trace_id + guilty stage), a thread row per (host, request
    track), and ``s``/``f`` flow arrows linking each router dispatch
    to the server-side run it invoked — the hop edges Perfetto draws
    across rows."""
    journeys = journeys or {}
    events = []
    if not groups:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base = min(
        s["wall_s"] for spans in groups.values() for s in spans
    )
    order = sorted(
        groups, key=lambda t: (min(s["wall_s"] for s in groups[t]), t),
    )
    for pid, tid in enumerate(order, start=1):
        spans = groups[tid]
        j = journeys.get(tid, {})
        label = f"journey {tid[:16]}"
        guilty = j.get("guilty_stage")
        if guilty:
            label += f" [{guilty}]"
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label, "trace_id": tid},
        })
        rows = {}
        for sp in spans:
            key = (sp["host"], str(sp.get("thread") or ""))
            row = rows.get(key)
            if row is None:
                row = len(rows) + 1
                rows[key] = row
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": row,
                    "args": {"name": f"{key[0]}/{key[1]}"},
                })
            args = {
                k: v for k, v in sp.items()
                if k not in ("name", "start_s", "dur_s", "thread",
                             "parent", "wall_s", "end_s")
            }
            events.append({
                "name": sp.get("name") or "?", "cat": "journey",
                "ph": "X", "pid": pid, "tid": row,
                "ts": (sp["wall_s"] - base) * 1e6,
                "dur": max(sp["end_s"] - sp["wall_s"], 0.0) * 1e6,
                "args": args,
            })
        flows = 0
        requests = [s for s in spans if s.get("name") == "request"]
        for d in spans:
            if d.get("name") != "dispatch" or not requests:
                continue
            r = max(requests, key=lambda s: _overlap(
                s["wall_s"], s["end_s"], d["wall_s"], d["end_s"],
            ))
            if _overlap(r["wall_s"], r["end_s"],
                        d["wall_s"], d["end_s"]) <= 0:
                continue
            fid = f"{tid[:12]}:{flows}"
            flows += 1
            events.append({
                "name": "rpc", "cat": "journey", "ph": "s", "id": fid,
                "pid": pid,
                "tid": rows[(d["host"], str(d.get("thread") or ""))],
                "ts": (d["wall_s"] - base) * 1e6,
            })
            events.append({
                "name": "rpc", "cat": "journey", "ph": "f", "bp": "e",
                "id": fid, "pid": pid,
                "tid": rows[(r["host"], str(r.get("thread") or ""))],
                "ts": (r["wall_s"] - base) * 1e6,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- CLI -----------------------------------------------------------------------


def load_events(paths):
    """Unified-stream JSONL records from ``paths`` (the event-log
    twins the drills and ``obs/events.py`` sinks write); non-dict
    lines are skipped, parse errors raise ValueError like the span
    loader."""
    records = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if isinstance(rec, dict):
                    records.append(rec)
    return records


def _print_journey(j, out=None):
    # Resolve sys.stdout at CALL time (a def-time default would pin
    # whatever stream was installed at import).
    w = (out or sys.stdout).write
    w(f"# journey {j['trace_id']}\n")
    w(f"#   client latency {j['client_latency_s'] * 1e3:.3f} ms"
      f" (stage sum {j['stage_sum_s'] * 1e3:.3f} ms)"
      + (f", TTFT {j['ttft_s'] * 1e3:.3f} ms" if "ttft_s" in j else "")
      + "\n")
    dev = j.get("device_s") or {}
    for stage in STAGES:
        if stage in j["stages"]:
            mark = " <- guilty" if j.get("guilty_stage") == stage else ""
            note = ""
            if stage in dev:
                note = f" (device {dev[stage] * 1e3:.3f} ms)"
            w(f"#   {stage:<16}{j['stages'][stage] * 1e3:>10.3f} ms"
              f"{note}{mark}\n")
    for leg in j["legs"]:
        w(f"#   leg {leg['leg']:<8}-> {leg['replica']} "
          f"{leg['dur_s'] * 1e3:.3f} ms"
          + (f" ERROR {leg['error']}" if leg["error"] else "") + "\n")


def _print_report(report, out=None):
    w = (out or sys.stdout).write
    c = report["counts"]
    w(f"# journeys: {c['journeys']} stitched ({c['complete']} "
      f"complete) across {len(report['hosts'])} host file(s); "
      f"{c['hedged']} hedged, {c['reissued']} re-issued, "
      f"{c['handoffs']} handoffs\n")
    refined = [h for h, row in
               report["clock"]["rpc_edges"].items()
               if row.get("adjusted")]
    if refined:
        w(f"# clock: RPC-edge refinement adjusted "
          f"{', '.join(refined)}\n")
    w(f"{'stage':<18}{'count':>7}{'p50 ms':>10}{'p99 ms':>10}"
      f"{'max ms':>10}\n")
    for stage in STAGES:
        row = report["stage_percentiles"].get(stage)
        if row is None:
            continue
        w(f"{stage:<18}{row['count']:>7}{row['p50_ms']:>10.3f}"
          f"{row['p99_ms']:>10.3f}{row['max_ms']:>10.3f}\n")
    slow = sorted(
        (j for j in report["journeys"] if j["complete"]),
        key=lambda j: -j["client_latency_s"],
    )[:5]
    if slow:
        w("# slowest journeys:\n")
        for j in slow:
            flags = "".join(
                f" {f}" for f in ("hedged", "reissued")
                if j.get(f)
            )
            w(f"#   {j['trace_id'][:16]} "
              f"{j['client_latency_s'] * 1e3:.3f} ms "
              f"guilty={j.get('guilty_stage', '?')}{flags}\n")


def serve_report(report, port, out=None):
    """Serve the stitched report over HTTP (GET anything returns the
    JSON). The conventional port is the registry's JOURNEY_PORT —
    conflicts fail with the stack's port map, not a bare
    EADDRINUSE."""
    import http.server

    body = json.dumps(report).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    try:
        httpd = http.server.ThreadingHTTPServer(("", port), Handler)
    except OSError as e:
        raise obs_ports.PortConflictError(obs_ports.conflict_message(
            port, "request-journey tier (obs.journey --serve-port)", e,
        )) from e
    (out or sys.stdout).write(f"# serving journey report on :{port} "
              f"({obs_ports.describe(port)})\n")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m container_engine_accelerators_tpu_torch.obs.journey",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("traces", nargs="+",
                   help="per-host span JSONL files (--trace-out twins; "
                        "pass the ROUTER's file first — it is the "
                        "clock reference and holds the dispatch "
                        "envelopes the RPC-edge refinement needs)")
    p.add_argument("-o", "--out", default="",
                   help="per-journey Chrome/Perfetto waterfall JSON "
                        "with flow arrows (load in ui.perfetto.dev)")
    p.add_argument("--events", action="append", default=[],
                   metavar="JSONL",
                   help="unified event-stream JSONL(s) to fold into "
                        "the journeys (retirements, hedges, handoffs; "
                        "repeatable)")
    p.add_argument("--align", default=None,
                   help="barrier span name for the coarse clock "
                        "alignment RPC edges then refine (default: "
                        "auto-pick)")
    p.add_argument("--summary-json", default="",
                   help="write the stitched report as JSON here")
    p.add_argument("--trace-id", default="",
                   help="print one journey's stage breakdown (full "
                        "32-hex id or a prefix, e.g. from a metrics "
                        "exemplar)")
    p.add_argument("--serve-port", type=int, default=0,
                   help="serve the report over HTTP on this port "
                        "(0 = off; the port map reserves "
                        f"{obs_ports.JOURNEY_PORT} for this tier)")
    args = p.parse_args(argv)
    try:
        traces = [fleet.load_host_trace(path) for path in args.traces]
        fleet.check_mergeable(traces, strict_meta=True)
        events = load_events(args.events)
        report, groups = build_report(
            traces, events=events, align_span=args.align,
        )
    except (fleet.TraceInputError, OSError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    except ValueError as err:  # malformed JSON line
        print(f"error: unparseable input ({err}); expected --trace-out "
              f".jsonl span files / event-stream JSONLs",
              file=sys.stderr)
        return 2
    try:
        if args.out:
            doc = journeys_chrome(
                groups, {j["trace_id"]: j for j in report["journeys"]},
            )
            with open(args.out, "w") as f:
                json.dump(doc, f)
        if args.summary_json:
            with open(args.summary_json, "w") as f:
                json.dump(report, f, indent=2)
    except OSError as err:  # unwritable output is a named error, not
        print(f"error: {err}", file=sys.stderr)  # a traceback
        return 2
    _print_report(report)
    if args.trace_id:
        j = find_journey(report, args.trace_id)
        if j is None:
            print(f"error: no journey matches trace id "
                  f"{args.trace_id!r}", file=sys.stderr)
            return 2
        _print_journey(j)
    if args.out:
        print(f"# journey waterfall written to {args.out}")
    if args.serve_port:
        try:
            serve_report(report, args.serve_port)
        except obs_ports.PortConflictError as err:
            print(f"error: {err}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
