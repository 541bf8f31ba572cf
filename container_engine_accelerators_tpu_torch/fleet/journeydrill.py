# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Request-journey chaos drill: every retired request must stitch.

Port of ``container_engine_accelerators_tpu/fleet/journeydrill.py`` onto
the port's fleet: the ``fleet/sim.py`` replicas (the engine's host side
over fake device calls), the router copy, ``obs/trace.py``,
``obs/events.py`` and ``obs/journey.py``; the exemplar phase rests on
the port's ``serve_cli._observe_ttft``.

The disagg bench's observability twin: run a
split prefill/decode fleet with KV handoff armed, full head sampling
(``trace_sample=1.0``) and a straggler window that fires budgeted
hedges — then stitch the process-global tracer's spans plus the
unified event stream back into journeys (``obs/journey.py``) and hold
the stack to its tracing contract:

  * **coverage** — >= 99% of the measured requests reconstruct into
    exactly one COMPLETE journey (route envelope + winning dispatch +
    server-side run), retirement event folded in; hedged requests
    carry their hedge leg and handed-off requests their transfer edge.
  * **attribution** — each stitched journey's summed stage durations
    reproduce the client-observed ``router.submit`` wall latency
    within 5% (plus one OS timeslice: the in-process drill shares a
    GIL with its fleet).
  * **exemplars** — a deliberately slow request (prefill sleep >> SLO
    TTFT bound) sent with an UNSAMPLED traceparent still lands a
    TTFT-histogram exemplar (the SLO-violation force-upgrade in
    serve_cli._observe_ttft), and that exemplar's trace_id resolves to
    a journey naming ``prefill`` as the guilty stage.

Deterministic across ``CHAOS_SEED`` (no randomness beyond thread
interleaving; the seed only tags the verdict for rerun parity with the
other drills).

CLI::

    python -m container_engine_accelerators_tpu_torch.fleet.journeydrill \
        --json /tmp/journey-verdict.json --out-dir /tmp/journey
"""

import argparse
import json
import logging
import os
import sys
import time

from container_engine_accelerators_tpu_torch.fleet import router as fleet_router
from container_engine_accelerators_tpu_torch.fleet import sim
from container_engine_accelerators_tpu_torch.models import serve_cli
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import fleet as obs_fleet
from container_engine_accelerators_tpu_torch.obs import journey as obs_journey
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.obs import trace as obs_trace

log = logging.getLogger(__name__)

V = sim.SIM_VOCAB

# Same prompt-space split as the disagg bench: measured families lead
# with token 31, cold fillers with 1..30 — no radix/directory overlap.
PROMPT_LEN = 13


def _family_prompt(f):
    return [31] + [((f * 7 + j) % (V - 1)) + 1
                   for j in range(PROMPT_LEN - 1)]


def _mk_fleet(roles, handoff, trace_sample, chunk_sleep_s,
              prefill_sleep_s, hedge_after_ms=0.0, slo=None):
    registry = obs_metrics.Registry()
    events = obs_events.EventStream(
        fleet_router.EVENT_SOURCE, registry=registry,
    )
    router = fleet_router.ReplicaRouter(
        events=events, registry=registry, handoff=handoff,
        trace_sample=trace_sample, hedge_after_ms=hedge_after_ms,
        hedge_budget_pct=100.0,
    )
    replicas = []
    for i, role in enumerate(roles):
        sr = sim.SimReplica(
            f"{role}-{i}", role=role, chunk_sleep_s=chunk_sleep_s,
            prefill_sleep_s=prefill_sleep_s, slo=slo,
        )
        replicas.append(sr)
        router.register(sr.handle())
    return router, replicas, events


def _submit_traced(router, prompt, max_new, bad):
    """One measured request under a drill-minted trace context:
    returns ``(trace_id, client wall seconds)``. The router adopts the
    inbound context (parent), so the journey is addressable by the id
    the CLIENT chose — the cross-process contract."""
    tid = obs_trace.new_trace_id()
    span_id = obs_trace.new_span_id()
    tp = obs_trace.format_traceparent(tid, span_id, True)
    t0 = time.perf_counter()
    out = router.submit({
        "tokens": [prompt], "max_new_tokens": max_new,
        "traceparent": tp,
    })
    wall = time.perf_counter() - t0
    if out["tokens"][0] != sim.expected_output(prompt, max_new):
        bad.append(prompt)
    return tid, wall


def _wait_idle(replicas, timeout_s=15.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if all(sr.idle() for sr in replicas):
            return True
        time.sleep(0.01)
    return False


def _host_trace(tracer, host="fleet"):
    """The tracer's spans as one in-memory HostTrace — the same record
    shape ``write_jsonl`` serializes, so file-based and in-process
    stitching exercise identical code."""
    spans = []
    for ev in tracer.events():
        rec = {
            "name": ev["name"], "start_s": round(ev["ts"], 6),
            "dur_s": round(ev["dur"], 6), "thread": ev["thread"],
            "parent": ev["parent"],
        }
        rec.update(ev["args"])
        spans.append(rec)
    return obs_fleet.HostTrace(
        host=host, epoch_ns=tracer.epoch_ns, spans=spans,
        dropped=tracer.dropped,
    )


def _exemplar_phase(chunk_sleep_s, bad):
    """The forced-slow_ttft request: unsampled inbound context, SLO
    TTFT bound far under the injected prefill sleep. Returns the
    trace_id, the decode-side TTFT exemplars, and the replica list
    (their events fold into the shared report)."""
    slo_ttft_s = 0.004
    router, replicas, events = _mk_fleet(
        ["unified"], handoff=False, trace_sample=0.0,
        chunk_sleep_s=chunk_sleep_s, prefill_sleep_s=0.03,
        slo=lambda reg: serve_cli.ServingSLO(
            ttft_s=slo_ttft_s, registry=reg,
        ),
    )
    tid = obs_trace.new_trace_id()
    span_id = obs_trace.new_span_id()
    tp = obs_trace.format_traceparent(
        tid, span_id, False,  # sampled flag OFF
    )
    out = router.submit({
        "tokens": [_family_prompt(9)], "max_new_tokens": 4,
        "traceparent": tp,
    })
    if out["tokens"][0] != sim.expected_output(_family_prompt(9), 4):
        bad.append("exemplar-phase output")
    _wait_idle(replicas)
    exemplars = replicas[0].engine._m_ttft.exemplars()
    records = list(events.events())
    for sr in replicas:
        records.extend(sr.events.events())
    return tid, exemplars, records


def run_drill(seed=None, families=3, measured=14, straggled=4,
              max_new=16, chunk_sleep_s=0.002, prefill_sleep_s=0.02,
              straggle_s=0.35, strict_timing=True):
    """The full drill; ``verdict["pass"]`` is the acceptance bit.
    ``strict_timing=False`` skips the wall-clock stage-sum gate (the
    tier-1 twin runs structure-only; the CLI times)."""
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    failures = []
    bad = []
    tracer = obs_trace.configure()
    try:
        router, replicas, events = _mk_fleet(
            ["prefill", "decode", "decode"], handoff=True,
            trace_sample=1.0, chunk_sleep_s=chunk_sleep_s,
            prefill_sleep_s=prefill_sleep_s, hedge_after_ms=150.0,
        )
        measured_walls = {}
        # Warm the families: cold prompts pay the prefill tier + a KV
        # handoff onto their decode owner, and the directory learns
        # the holders.
        for f in range(families):
            tid, wall = _submit_traced(
                router, _family_prompt(f), max_new, bad,
            )
            measured_walls[tid] = wall
        # Steady-state measured load: warm families round-robin.
        for i in range(measured):
            tid, wall = _submit_traced(
                router, _family_prompt(i % families), max_new, bad,
            )
            measured_walls[tid] = wall
        # Straggler window: slow ONE decode replica's transport past
        # the hedge delay and hit a family it owns, so the affinity
        # primary straggles and the budgeted hedge serves the client
        # from the other decode replica.
        owner = None
        for f in range(families):
            holder = router.prefix_holder(_family_prompt(f))
            sr = next(
                (r for r in replicas
                 if r.replica_id == holder and r.role == "decode"),
                None,
            )
            if sr is not None:
                owner, owner_family = sr, f
                break
        if owner is None:
            failures.append(
                f"no decode replica owns a warm family — the handoff "
                f"directory never learned a holder {tag}"
            )
        else:
            owner.straggle_s = straggle_s
            try:
                for _ in range(straggled):
                    tid, wall = _submit_traced(
                        router, _family_prompt(owner_family), max_new,
                        bad,
                    )
                    measured_walls[tid] = wall
            finally:
                owner.straggle_s = 0.0
        # Let hedge losers drain (their transport sleeps straggle_s
        # before the engine even sees the request) so their spans and
        # retirement events are on the record before stitching.
        time.sleep(straggle_s + 0.1)
        _wait_idle(replicas)
        exemplar_tid, exemplars, extra_records = _exemplar_phase(
            chunk_sleep_s, bad,
        )
        records = list(events.events())
        for sr in replicas:
            records.extend(sr.events.events())
        records.extend(extra_records)
        trace = _host_trace(tracer)
        report, groups = obs_journey.build_report(
            [trace], events=records,
        )
        del groups  # the report carries everything the verdict needs
    finally:
        obs_trace.configure(enabled=False)
    by_tid = {j["trace_id"]: j for j in report["journeys"]}

    stitched = 0
    sum_mismatches = []
    for tid, wall in measured_walls.items():
        j = by_tid.get(tid)
        if j is None or not j["complete"] or not j.get("retired"):
            continue
        stitched += 1
        # One OS timeslice of absolute slack on top of the 5%: the
        # drill's client, router and engines share one GIL, and a
        # single preemption inside (or outside) the route envelope
        # shows up whole in a ~50ms request.
        if strict_timing and abs(j["stage_sum_s"] - wall) > (
            0.05 * wall + 0.010
        ):
            sum_mismatches.append(
                f"{tid[:12]}: stages sum to {j['stage_sum_s']:.4f}s "
                f"vs client {wall:.4f}s"
            )
    total = len(measured_walls)
    ratio = stitched / total if total else 0.0
    if ratio < 0.99:
        failures.append(
            f"only {stitched}/{total} measured requests stitched into "
            f"a complete retired journey {tag}"
        )
    if sum_mismatches:
        failures.append(
            f"{len(sum_mismatches)} journeys' stage sums diverged "
            f">5% + one timeslice from the client-observed latency: "
            f"{'; '.join(sum_mismatches[:3])} {tag}"
        )
    hedged = [j for j in report["journeys"]
              if j.get("hedged") and j["trace_id"] in measured_walls]
    hedged_with_leg = [
        j for j in hedged
        if any(leg["leg"] == "hedge" for leg in j["legs"])
        and j.get("hedge_events")
    ]
    if not hedged_with_leg:
        failures.append(
            f"no stitched journey carries a hedge leg + hedge event "
            f"({len(hedged)} hedged journeys seen) {tag}"
        )
    handed = [
        j for j in report["journeys"]
        if j["trace_id"] in measured_walls
        and j.get("handoffs", 0) >= 1 and j.get("handoff_events")
    ]
    if not handed:
        failures.append(
            f"no stitched journey carries a KV handoff edge (span + "
            f"event) {tag}"
        )
    # Exemplar resolution: the forced slow_ttft request's histogram
    # exemplar names its trace, and the journey names the guilty
    # stage.
    exemplar_hit = any(
        ex[0] == exemplar_tid for ex in exemplars.values()
    )
    exemplar_journey = by_tid.get(exemplar_tid)
    guilty = (exemplar_journey or {}).get("guilty_stage", "")
    if not exemplar_hit:
        failures.append(
            f"the forced-slow request left no TTFT exemplar for its "
            f"trace id {exemplar_tid[:12]} (unsampled context should "
            f"be force-upgraded on SLO violation) {tag}"
        )
    if exemplar_journey is None or not exemplar_journey["complete"]:
        failures.append(
            f"the forced-slow request's trace id did not stitch into "
            f"a complete journey {tag}"
        )
    elif guilty != "prefill":
        failures.append(
            f"the forced-slow journey blames {guilty!r}, expected "
            f"'prefill' (the injected 30ms prefill sleep) {tag}"
        )
    if bad:
        failures.append(
            f"{len(bad)} corrupted/failed requests during the drill "
            f"{tag}"
        )
    verdict = {
        "seed": seed,
        "measured": total,
        "stitched": stitched,
        "stitch_ratio": round(ratio, 4),
        "journeys": report["counts"],
        "hedged_with_leg": len(hedged_with_leg),
        "handoff_journeys": len(handed),
        "stage_percentiles": report["stage_percentiles"],
        "exemplar": {
            "trace_id": exemplar_tid,
            "resolved": exemplar_hit,
            "guilty_stage": guilty,
        },
        "sum_mismatches": len(sum_mismatches),
        "bad": len(bad),
        "failures": failures,
        "pass": not failures,
    }
    return verdict, report, trace, records


def _write_artifacts(out_dir, trace, records):
    """Dogfood the file path: dump the span/event JSONLs and re-run
    the journey CLI over them, so ``--out-dir`` produces the
    same artifacts an operator would stitch by hand."""
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "fleet.jsonl")
    with open(trace_path, "w") as f:
        f.write(json.dumps({
            "name": obs_trace.JSONL_META_NAME,
            "host": trace.host,
            "pid": 0,
            "epoch_ns": trace.epoch_ns,
            "dropped_events": trace.dropped,
        }) + "\n")
        for sp in trace.spans:
            f.write(json.dumps(sp) + "\n")
    events_path = os.path.join(out_dir, "events.jsonl")
    with open(events_path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    rc = obs_journey.main([
        trace_path, "--events", events_path,
        "-o", os.path.join(out_dir, "journeys.json"),
        "--summary-json", os.path.join(out_dir, "report.json"),
    ])
    return rc


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=None,
                   help="chaos seed (default: CHAOS_SEED env, else 0)")
    p.add_argument("--measured", type=int, default=14,
                   help="steady-state measured requests")
    p.add_argument("--straggled", type=int, default=4,
                   help="requests submitted inside the straggler "
                        "window (the hedge provocations)")
    p.add_argument("--max-new", type=int, default=16,
                   help="tokens decoded per measured request")
    p.add_argument("--json", default="",
                   help="write the machine-readable verdict here")
    p.add_argument("--out-dir", default="",
                   help="also dump the span/event JSONLs and run the "
                        "journey CLI over them (fleet.jsonl, "
                        "events.jsonl, journeys.json, report.json)")
    args = p.parse_args(argv)
    verdict, report, trace, records = run_drill(
        seed=args.seed, measured=args.measured,
        straggled=args.straggled, max_new=args.max_new,
    )
    del report  # the verdict summarizes it; --out-dir re-stitches
    out = json.dumps(verdict, indent=2, sort_keys=True)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if args.out_dir:
        _write_artifacts(args.out_dir, trace, records)
    if not verdict["pass"]:
        for failure in verdict["failures"]:
            log.error("journey drill failure: %s", failure)
        return 1
    log.info(
        "journey drill passed: %d/%d stitched (%.1f%%), %d hedged "
        "journeys with legs, %d handoff journeys, exemplar %s -> "
        "guilty=%s",
        verdict["stitched"], verdict["measured"],
        100.0 * verdict["stitch_ratio"], verdict["hedged_with_leg"],
        verdict["handoff_journeys"],
        verdict["exemplar"]["trace_id"][:12],
        verdict["exemplar"]["guilty_stage"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
