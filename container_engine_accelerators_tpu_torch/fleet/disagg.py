# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Disaggregated prefill/decode bench: split fleet vs unified fleet.

Port of ``container_engine_accelerators_tpu/fleet/disagg.py``, on the
port's engines (``fleet/sim.py``) and its handoff wire, which is JAX's
byte for byte. The DistServe/Splitwise question, answered hermetically
(fake-seam engines on the CPU, zero compiles, CHAOS_SEED-deterministic):
does moving prefill
onto dedicated replicas — shipping the KV blocks to decode replicas
over the handoff wire (``kvcache/handoff.py``) instead of recomputing
them — keep decode p99 TPOT flat while the offered prefill QPS
doubles?

Four phases, one verdict:

  ``baseline``   an idle decode fleet (warm prefixes, no prefill
                 traffic): the p99 TPOT floor.
  ``unified``    the same fleet with a paced cold-prompt load mixed
                 in: every prefill runs on the engine loop BETWEEN the
                 in-flight decode chunks, and TPOT inflates — the
                 interference the SLO classifier calls ``slow_tpot``.
  ``split``      a prefill tier + a decode tier (``--role``), KV
                 handoff armed, the cold-prompt load DOUBLED: prefill
                 burns elsewhere, handed-off decode output stays
                 byte-exact vs local prefill, and p99 TPOT holds
                 within 5% of the idle baseline (plus one OS
                 timeslice of per-token scheduler jitter — the
                 in-process bench shares a GIL with its load
                 drivers, and a single preemption in one measured
                 request lands entirely in the p99 sample).
  ``storm``      the membership-storm drill
                 (:func:`fleet.sim.run_membership_storm`): fleet-wide
                 ``prefix_hit_ratio`` survives churn via handoff, and
                 a mid-transfer corrupt + timeout fault pair proves
                 the fallback-to-re-prefill path is byte-exact and
                 charged to ``drain_migration`` badput.

CLI::

    python -m container_engine_accelerators_tpu_torch.fleet.disagg \
        --json /tmp/disagg-verdict.json
"""

import argparse
import json
import logging
import os
import sys
import threading
import time

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.fleet import (
    router as fleet_router,
)
from container_engine_accelerators_tpu_torch.fleet import sim
from container_engine_accelerators_tpu_torch.kvcache import (
    handoff as kv_handoff,
)
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import goodput as obs_goodput
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

V = sim.SIM_VOCAB

# 12-token shared prefix (3 cached blocks at the sim block size of 4)
# + 1 suffix token. Measured families lead with token 31; the cold
# population leads with 1..30 — the two prompt spaces never collide in
# the radix tree or the prefix directory.
PROMPT_LEN = 13


def _family_prompt(f):
    return [31] + [((f * 7 + j) % (V - 1)) + 1 for j in range(PROMPT_LEN - 1)]


def _cold_prompt(i):
    return [(i % 30) + 1, ((i // 30) % (V - 1)) + 1] + [
        ((i + j) % (V - 1)) + 1 for j in range(PROMPT_LEN - 2)
    ]


def _percentile(vals, q):
    if not vals:
        return 0.0
    vals = sorted(vals)
    idx = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
    return vals[idx]


def _mk_fleet(roles, handoff, chunk_sleep_s, prefill_sleep_s,
              handoff_timeout_s=2.0):
    registry = obs_metrics.Registry()
    events = obs_events.EventStream(
        fleet_router.EVENT_SOURCE, registry=registry,
    )
    router = fleet_router.ReplicaRouter(
        events=events, registry=registry, handoff=handoff,
        handoff_timeout_s=handoff_timeout_s,
    )
    replicas = []
    for i, role in enumerate(roles):
        sr = sim.SimReplica(
            f"{role}-{i}", role=role, chunk_sleep_s=chunk_sleep_s,
            prefill_sleep_s=prefill_sleep_s,
        )
        replicas.append(sr)
        router.register(sr.handle())
    return router, replicas, events


def _submit_checked(router, prompt, max_new, bad):
    out = router.submit({"tokens": [prompt], "max_new_tokens": max_new})
    if out["tokens"][0] != sim.expected_output(prompt, max_new):
        bad.append(prompt)
    return out


def _measure(router, families, repeats, max_new, bad):
    """Sequential measured decode requests (one in flight at a time,
    so latency is engine time, not queueing): per-token TPOT samples
    in seconds."""
    tpots = []
    for _ in range(repeats):
        for f in range(families):
            t0 = time.perf_counter()
            _submit_checked(router, _family_prompt(f), max_new, bad)
            tpots.append((time.perf_counter() - t0) / max_new)
    return tpots


def _cold_loop(router, interval_s, stop, counter, bad, offset=0):
    """Paced cold-prompt (prefill-only, ``max_new_tokens=1``) load:
    one unique prompt every ``interval_s`` until ``stop``."""
    i = 0
    while not stop.is_set():
        try:
            _submit_checked(
                router, _cold_prompt(offset + i), 1, bad,
            )
            counter[0] += 1
        except Exception as e:  # noqa: BLE001 - verdict counts failures
            log.warning("cold prompt failed: %s", e)
            bad.append(("cold-error", str(e)))
        i += 1
        if stop.wait(interval_s):
            break


def _interference_phase(roles, handoff, cold_interval_s, families,
                        repeats, max_new, chunk_sleep_s,
                        prefill_sleep_s, cold_offset, n_drivers=1):
    """Warm the families, then measure decode TPOT while the paced
    cold-prompt load runs (``n_drivers`` concurrent clients, each at
    ``cold_interval_s`` pacing — offered prefill QPS scales with the
    driver count); returns the phase's verdict bits."""
    router, replicas, events = _mk_fleet(
        roles, handoff, chunk_sleep_s, prefill_sleep_s,
    )
    bad = []
    for f in range(families):
        _submit_checked(router, _family_prompt(f), max_new, bad)
    stop = threading.Event()
    counter = [0]
    drivers = []
    if cold_interval_s:
        for d in range(n_drivers):
            drivers.append(threading.Thread(
                target=_cold_loop,
                args=(router, cold_interval_s, stop, counter, bad,
                      cold_offset + d * 400),
                daemon=True,
            ))
        for t in drivers:
            t.start()
    t0 = time.perf_counter()
    tpots = _measure(router, families, repeats, max_new, bad)
    window = time.perf_counter() - t0
    stop.set()
    for t in drivers:
        t.join(10)
    records = list(events.events())
    for sr in replicas:
        records.extend(sr.events.events())
    verdict = sim.drill_verdict(records)
    return {
        "p99_tpot_s": round(_percentile(tpots, 0.99), 6),
        "p50_tpot_s": round(_percentile(tpots, 0.50), 6),
        "cold_prompts": counter[0],
        "cold_qps": round(counter[0] / window, 3) if window else 0.0,
        "window_s": round(window, 4),
        "kv_handoffs": verdict["kv_handoffs"],
        "kv_handoff_failures": verdict["kv_handoff_failures"],
        "bad": len(bad),
    }


def _handoff_exactness(chunk_sleep_s, prefill_sleep_s, max_new):
    """Byte-exactness across the wire: the same fresh prompt decoded
    (a) on a split fleet, its KV blocks prefilled remotely and handed
    off, and (b) on a lone unified replica prefilling locally — the
    outputs must be identical."""
    prompt = _cold_prompt(10_000)
    router, replicas, _ = _mk_fleet(
        ["prefill", "decode"], True, chunk_sleep_s, prefill_sleep_s,
    )
    handed = router.submit(
        {"tokens": [prompt], "max_new_tokens": max_new},
    )["tokens"][0]
    handoffs = sum(
        sr.engine.kv_stats()["prefix_hit_tokens"]
        for sr in replicas if sr.role == "decode"
        if sr.engine.kv_stats() is not None
    )
    local_eng = sim.make_fake_engine(chunk_sleep_s=chunk_sleep_s)
    (local,) = local_eng.generate([prompt], max_new)
    return {
        "handed_off": handed,
        "local": local,
        "byte_exact": handed == local,
        "decode_hit_tokens": handoffs,
    }


def _fault_phase(seed, chunk_sleep_s, max_new):
    """Corrupt one transfer mid-wire and time a second one out: both
    requests must fall back to local re-prefill with byte-exact
    output, and the seconds each doomed transfer burned must land in
    the goodput ledger as ``drain_migration`` badput."""
    router, replicas, events = _mk_fleet(
        ["unified"] * 3, True, chunk_sleep_s, 0.0,
        handoff_timeout_s=0.5,
    )
    bad = []
    # Warm two families onto their ring owners; the directory learns
    # the holders.
    for f in (0, 1):
        _submit_checked(router, _family_prompt(f), max_new, bad)
    holders = {router.prefix_holder(_family_prompt(f)) for f in (0, 1)}
    holders.discard(None)
    for h in holders:
        router.eject(h, reason="disagg fault drill")
    faults.arm(faults.FaultPlan([
        {"kind": "corrupt_payload",
         "site": kv_handoff.HANDOFF_FAULT_SITE, "at": 0, "count": 1},
        {"kind": "delay", "site": kv_handoff.HANDOFF_FAULT_SITE,
         "at": 1, "count": 1, "delay_s": 99.0},
    ], seed=seed))
    try:
        for f in (0, 1):
            _submit_checked(router, _family_prompt(f), max_new, bad)
    finally:
        faults.disarm()
    records = list(events.events())
    fails = [r for r in records
             if (r.get("kind") or r.get("event")) == "kv_handoff_failed"]
    builder = obs_goodput.build_ledger(records)
    badput = builder.ledger.totals().get("drain_migration", 0.0)
    return {
        "handoff_failures": len(fails),
        "failure_reasons": sorted(r.get("reason") for r in fails),
        "byte_exact": not bad,
        "drain_migration_s": round(badput, 6),
    }


def run_bench(seed=None, families=4, repeats=40, max_new=24,
              chunk_sleep_s=0.004, prefill_sleep_s=0.001,
              cold_interval_s=0.02, strict_timing=True):
    """The full bench; returns the verdict dict (``verdict["pass"]``
    is the acceptance bit). ``strict_timing=False`` skips the
    wall-clock thresholds (the tier-1 twin runs structure-only; the
    full timing run is the CLI's default)."""
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    failures = []

    # Phase 1: idle decode floor — no cold load, no handoff needed.
    base = _interference_phase(
        ["unified"] * 2, False, 0.0, families, repeats, max_new,
        chunk_sleep_s, prefill_sleep_s, cold_offset=0,
    )
    # Phase 2: the unified fleet eats the cold-prompt load inline.
    unified = _interference_phase(
        ["unified"] * 2, False, cold_interval_s, families, repeats,
        max_new, chunk_sleep_s, prefill_sleep_s, cold_offset=1000,
    )
    # Phase 3: split fleet, DOUBLE the offered prefill QPS (two
    # paced cold clients instead of one).
    split = _interference_phase(
        ["prefill", "prefill", "decode", "decode"], True,
        cold_interval_s, families, repeats, max_new,
        chunk_sleep_s, prefill_sleep_s, cold_offset=2000,
        n_drivers=2,
    )
    exact = _handoff_exactness(chunk_sleep_s, prefill_sleep_s, 8)
    storm = sim.run_membership_storm(seed=seed)
    fault = _fault_phase(seed, chunk_sleep_s, max_new=6)

    for name, phase in (("baseline", base), ("unified", unified),
                        ("split", split)):
        if phase["bad"]:
            failures.append(
                f"{phase['bad']} corrupted/failed requests in the "
                f"{name} phase {tag}"
            )
    if split["kv_handoffs"] < families:
        failures.append(
            f"split fleet performed only {split['kv_handoffs']} KV "
            f"handoffs for {families} warm families {tag}"
        )
    if not exact["byte_exact"]:
        failures.append(
            f"handed-off decode diverged from local prefill: "
            f"{exact['handed_off']} != {exact['local']} {tag}"
        )
    if not storm["pass"]:
        failures.extend(storm["failures"])
    if fault["handoff_failures"] < 2:
        failures.append(
            f"fault drill produced {fault['handoff_failures']} "
            f"handoff failures, wanted 2 (corrupt + timeout) {tag}"
        )
    if not fault["byte_exact"]:
        failures.append(
            f"fallback-to-re-prefill output was not byte-exact {tag}"
        )
    if fault["drain_migration_s"] <= 0.0:
        failures.append(
            f"failed handoffs charged no drain_migration badput {tag}"
        )
    if strict_timing:
        # 5% relative slack plus one CFS timeslice (~10ms) amortized
        # over a request's max_new tokens: a single OS preemption in
        # one measured request inflates exactly the sample p99 picks,
        # and at the tiny-model TPOT scale (~2ms/token on CPU) that
        # jitter alone exceeds 5%. At production TPOT scales the
        # relative term dominates and the gate is the documented 5%.
        slack = base["p99_tpot_s"] * 0.05 + 0.010 / max_new
        if split["p99_tpot_s"] > base["p99_tpot_s"] + slack:
            failures.append(
                f"split-fleet p99 TPOT {split['p99_tpot_s']*1e3:.3f}ms "
                f"exceeds the idle-decode baseline "
                f"{base['p99_tpot_s']*1e3:.3f}ms + 5% + one timeslice "
                f"of per-token jitter ({slack*1e3:.3f}ms) {tag}"
            )
        if split["cold_qps"] < 1.8 * unified["cold_qps"]:
            failures.append(
                f"split fleet absorbed {split['cold_qps']} cold QPS, "
                f"wanted >= 1.8x the unified phase's "
                f"{unified['cold_qps']} {tag}"
            )
        if unified["p99_tpot_s"] < split["p99_tpot_s"]:
            failures.append(
                f"unified-fleet p99 TPOT {unified['p99_tpot_s']} beat "
                f"the split fleet's {split['p99_tpot_s']} under HALF "
                f"the prefill load — disaggregation bought nothing "
                f"{tag}"
            )
    verdict = {
        "seed": seed,
        "baseline": base,
        "unified": unified,
        "split": split,
        "exactness": exact,
        "storm": {k: storm[k] for k in (
            "storm_hit_ratio", "warm_hit_ratio", "kv_handoffs",
            "kv_handoff_failures", "pass",
        )},
        "fault": fault,
        "tpot_inflation_unified": round(
            unified["p99_tpot_s"] / base["p99_tpot_s"], 4,
        ) if base["p99_tpot_s"] else 0.0,
        "tpot_inflation_split": round(
            split["p99_tpot_s"] / base["p99_tpot_s"], 4,
        ) if base["p99_tpot_s"] else 0.0,
        "failures": failures,
        "pass": not failures,
    }
    return verdict


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=None,
                   help="chaos seed (default: CHAOS_SEED env, else 0)")
    p.add_argument("--families", type=int, default=4,
                   help="shared-prefix families the decode load "
                        "measures TPOT over")
    p.add_argument("--repeats", type=int, default=40,
                   help="measured decode requests per family per "
                        "phase (the p99 needs a real sample count: "
                        "families x repeats TPOT samples)")
    p.add_argument("--max-new", type=int, default=24,
                   help="tokens decoded per measured request")
    p.add_argument("--cold-interval-s", type=float, default=0.02,
                   help="pacing of the unified phase's cold-prompt "
                        "(prefill-only) load; the split phase offers "
                        "DOUBLE this QPS")
    p.add_argument("--json", default="",
                   help="write the machine-readable verdict here")
    args = p.parse_args(argv)
    verdict = run_bench(
        seed=args.seed, families=args.families, repeats=args.repeats,
        max_new=args.max_new, cold_interval_s=args.cold_interval_s,
    )
    out = json.dumps(verdict, indent=2, sort_keys=True)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if not verdict["pass"]:
        for failure in verdict["failures"]:
            log.error("disagg bench failure: %s", failure)
        return 1
    log.info(
        "disagg bench passed: split p99 TPOT %.3fms vs idle baseline "
        "%.3fms (%.1f%%) at %.1f cold QPS (unified: %.3fms at %.1f "
        "QPS); storm hit ratio %.3f; %d handoffs, fallback byte-exact",
        verdict["split"]["p99_tpot_s"] * 1e3,
        verdict["baseline"]["p99_tpot_s"] * 1e3,
        100.0 * verdict["tpot_inflation_split"],
        verdict["split"]["cold_qps"],
        verdict["unified"]["p99_tpot_s"] * 1e3,
        verdict["unified"]["cold_qps"],
        verdict["storm"]["storm_hit_ratio"],
        verdict["split"]["kv_handoffs"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
