# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Flight-recorder chaos drill: wedge a link, read the black box.

Port of ``container_engine_accelerators_tpu/fleet/flightdrill.py`` on the
port's lockstep engine link: its link harness (``fleet/linksim.py``, the
real ``ContinuousEngine`` and ``engine_follower_loop`` over fake device
seams), its fault plan, flight recorder and postmortem analyzer
(``obs/flight.py``, ``obs/postmortem.py``); the scenario, the verdict and
the CLI are JAX's.

The acceptance scenario for ``obs/flight.py`` + ``obs/postmortem.py``:
arm a :class:`~container_engine_accelerators_tpu_torch.obs.flight
.FlightRecorder` over the hermetic multi-rank link harness
(:mod:`~container_engine_accelerators_tpu_torch.fleet.linksim`), run a jittered
baseline request mix, then inject a ``delay`` fault at the
``serving.link`` site that stalls a collective past the watchdog
deadline. The drill passes when:

  * the ``link_wedged`` hook dumps **exactly one** bundle (the per-kind
    dedup window collapses the wedge cascade);
  * the postmortem analyzer's **first anomaly names the wedge/op-wait
    series** (``tpu_serving_link_wedges_total``), not one of the dozens
    of ordinary serving series that moved in the same window;
  * the first anomaly lands **within one snapshot interval of the
    trigger** (the recorder clock is injected, so this bound is exact,
    not wall-clock-lucky);
  * the fused event tail correlates the injected fault
    (``fault_injected`` at ``serving.link``) and the wedge itself —
    the bundle alone reconstructs cause and effect;
  * serving survives: the wedged request still completes byte-exact
    against the sim oracle.

Deterministic under ``CHAOS_SEED`` (the recorder is polled manually on
a fake clock; the request mix and fault schedule derive from the seed).
CLI::

    python -m container_engine_accelerators_tpu_torch.fleet.flightdrill \
        --dir /tmp/tpu-flight-drill --json /tmp/flight-verdict.json
"""

import argparse
import json
import logging
import os
import shutil
import sys

import numpy as np

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.fleet import linksim
from container_engine_accelerators_tpu_torch.fleet import sim
from container_engine_accelerators_tpu_torch.models import serve_cli
from container_engine_accelerators_tpu_torch.obs import flight as obs_flight
from container_engine_accelerators_tpu_torch.obs import postmortem

log = logging.getLogger(__name__)

# Baseline snapshots before the wedge: enough priors for the analyzer's
# rolling median (MIN_PRIOR_POINTS) on every series, with room to spare
# so one-off early movements (first radix hit, first admission) fall
# inside the no-prior warmup where they cannot score.
BASELINE_REQUESTS = 10


class _FakeClock:
    """Injected recorder timebase: the drill advances it one interval
    per baseline request, so snapshot timestamps — and the first-anomaly
    bound the verdict checks — are exact, not scheduler-dependent."""

    def __init__(self, start=100.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _baseline_cases(rng, n):
    """Jittered shared-prefix mix. Every case rides the shared prefix
    (with an occasional exact repeat) so the radix/hit counters move on
    EVERY snapshot with natural variance — a series that first moves
    late in the baseline would hand the analyzer a fake changepoint."""
    prefix = [(j % 9) + 1 for j in range(16)]
    cases = []
    for i in range(n):
        if i % 4 == 1:
            cases.append(list(cases[i - 1]))  # exact radix repeat
        else:
            p = prefix + rng.randint(1, 30, 1 + rng.randint(8)).tolist()
            cases.append(p[:40])
    return cases


def run_flight_drill(dirpath, seed=None, interval_s=0.25,
                     timeout_s=0.5):
    """Run the drill; returns the verdict dict (``verdict["pass"]`` is
    the acceptance bit, failures carry the seed for reproduction)."""
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    failures = []
    faults.disarm()
    obs_flight.deactivate()
    rng = np.random.RandomState(seed)
    if os.path.isdir(dirpath):
        shutil.rmtree(dirpath)
    os.makedirs(dirpath, exist_ok=True)

    # A deliberate 5ms per-chunk sleep gives every wall-time series
    # (tpot, op-wait, queue-wait) a dominant stable timescale, so
    # scheduler hiccups on a loaded box are small RELATIVE noise the
    # analyzer's floors absorb, not 10x blips posing as changepoints.
    h = linksim.LinkHarness(n_followers=2, timeout_s=timeout_s,
                            chunk_sleep_s=0.005)
    clock = _FakeClock()
    rec = obs_flight.FlightRecorder(
        dirpath, window_s=30.0, interval_s=interval_s, clock=clock,
        host="flight-drill",
    )
    rec.watch_registry("serve", h.registry)
    rec.watch_events(h.events)
    rec.add_state_provider("stats", h.engine.stats)
    obs_flight.install(rec)
    summary = None
    try:
        # -- baseline: jittered traffic, one snapshot per request ----------
        rec.snapshot()  # absorb handshake-time counter levels
        cases = _baseline_cases(rng, BASELINE_REQUESTS)
        for i, case in enumerate(cases):
            max_new = 2 + (i % 3)
            out = h.generate(case, max_new)
            if out != sim.expected_output(case, max_new):
                failures.append(f"baseline case {i} diverged {tag}")
            clock.advance(interval_s)
            rec.poll()
        if not h.quiesce():
            failures.append(f"baseline never quiesced {tag}")

        # -- the wedge: a delay fault stalls a collective ------------------
        # One interval past the last baseline snapshot: the trigger's
        # final snapshot is the ring's newest point and the analyzer
        # must place the first anomaly exactly there.
        clock.advance(interval_s)
        plan = faults.arm(faults.FaultPlan([
            {"kind": "delay", "site": serve_cli.LINK_FAULT_SITE,
             "at": 3, "count": 1, "delay_s": 6.0 * timeout_s},
        ], seed=seed))
        rec.watch_events(plan.events)  # chaos tail into the bundle
        out_w = h.generate([14, 15, 16], 8)
        faults.disarm()
        if out_w != sim.expected_output([14, 15, 16], 8):
            failures.append(
                f"output diverged under the wedge fault {tag}"
            )
        h.shutdown()

        # -- the black box: exactly one bundle, correctly attributed ------
        bundles = sorted(
            f for f in os.listdir(dirpath)
            if f.startswith("flight-") and f.endswith(".jsonl")
        )
        if len(bundles) != 1:
            failures.append(
                f"expected exactly one bundle, got {bundles} {tag}"
            )
        if not bundles:
            return _verdict(failures, seed, None, rec)
        bundle = os.path.join(dirpath, bundles[0])
        if rec.last_bundle != bundle:
            failures.append(
                f"last_bundle {rec.last_bundle} != dumped bundle {tag}"
            )
        try:
            summary = postmortem.analyze(bundle)
        except postmortem.PostmortemError as e:
            failures.append(f"bundle unanalyzable: {e} {tag}")
            return _verdict(failures, seed, None, rec)
        if summary["trigger"]["kind"] != "link_wedged":
            failures.append(
                f"trigger kind {summary['trigger']['kind']} != "
                f"link_wedged {tag}"
            )
        first = summary["first_anomaly"]
        if first is None:
            failures.append(f"analyzer found no anomaly at all {tag}")
        else:
            base = postmortem.base_series_name(first["series"])
            if not ("wedge" in base or "op_wait" in base):
                failures.append(
                    f"first anomaly {first['series']} is not the "
                    f"wedge/op-wait series {tag}"
                )
            if abs(first["rel_to_trigger_s"]) > interval_s:
                failures.append(
                    f"first anomaly {first['rel_to_trigger_s']:+.3f}s "
                    f"from trigger — outside one interval "
                    f"({interval_s}s) {tag}"
                )
        kinds = {n["kind"] for n in summary["correlated_events"]}
        if "fault_injected" not in kinds:
            failures.append(
                f"injected fault not correlated in the tail {tag}"
            )
        if "link_wedged" not in kinds:
            failures.append(
                f"wedge event not correlated in the tail {tag}"
            )
        return _verdict(failures, seed, summary, rec)
    finally:
        faults.disarm()
        obs_flight.deactivate()
        rec.close()


def _verdict(failures, seed, summary, rec):
    first = summary["first_anomaly"] if summary else None
    return {
        "pass": not failures,
        "failures": failures,
        "seed": seed,
        "bundle": rec.last_bundle,
        "trigger": summary["trigger"]["kind"] if summary else None,
        "snapshots": summary["snapshots"] if summary else 0,
        "first_anomaly": first["series"] if first else None,
        "first_anomaly_rel_s": (
            first["rel_to_trigger_s"] if first else None
        ),
        "correlated_kinds": sorted(
            {n["kind"] for n in summary["correlated_events"]}
        ) if summary else [],
    }


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", default="/tmp/tpu-flight-drill",
                   help="bundle directory (wiped per run)")
    p.add_argument("--interval-s", type=float, default=0.25,
                   help="recorder snapshot interval (fake clock)")
    p.add_argument("--timeout-s", type=float, default=0.5,
                   help="link timeout the delay fault must exceed")
    p.add_argument("--json", default="",
                   help="write the verdict JSON here as well")
    args = p.parse_args(argv)
    verdict = run_flight_drill(
        args.dir, interval_s=args.interval_s, timeout_s=args.timeout_s,
    )
    print(json.dumps(verdict, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(verdict, f, indent=2)
    if not verdict["pass"]:
        for failure in verdict["failures"]:
            log.error("FAIL: %s", failure)
        return 1
    log.info(
        "flight drill passed: %s attributed first in %s",
        verdict["first_anomaly"], verdict["bundle"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
