# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Restart-storm chaos drill: restart-to-ready must be warm, not cold.

Port of ``container_engine_accelerators_tpu/faults/storm.py``. The
supervisor and the autoscaler make restarts *survivable*; ``warmstart/``
makes them *cheap*. This drill is the acceptance scenario for that
claim: it kills and resumes
a training run K times and replaces a serving replica mid-storm, then
judges the wreckage with the goodput :class:`TimeLedger`:

  * **compile badput is charged once per binary, not once per
    restart** — the first attempt pays the (simulated) compile and
    stamps the persistent compile cache
    (:meth:`~container_engine_accelerators_tpu_torch.warmstart.cache
    .CompileCache.memo`); every resume replays it
    (``tpu_compile_cache_hits_total`` > 0 on every attempt after the
    first) and the ledger's ``compile`` seconds stay ~one compile
    despite K+1 attempts.
  * **warm restart-to-ready beats cold boot** — each resume's
    time-to-ready (compile + checkpoint restore) is strictly below the
    first attempt's, and the replacement serving replica's AOT warmup
    (``SimReplica.warm``, the ``--warmup=all`` path) is strictly
    faster than the cold replica's first-request compile stall.
  * **a corrupt latest checkpoint costs one step of history, never a
    crash loop** — mid-storm the drill corrupts the newest
    ``step_<N>``; the next resume quarantines it
    (``checkpoint_fallback`` event, ``step_N.corrupt`` on disk) and
    restores the prior step, and the run still completes.

Hermetic: CPU-only (the training state is torch tensors on the CPU, the
serving engine the fake-seam one of ``fleet/sim.py``), the simulated
compiles routed through the exact counter/event plumbing the real
persistent cache feeds (``warmstart/cache.py``), REAL checkpoints in the
port's format (``utils/checkpointing.py``: ``step_<N>/state.pt``,
quarantine to ``step_N.corrupt``), the REAL supervisor restart path, and
the REAL goodput ledger as judge. Deterministic under ``CHAOS_SEED``.

CLI::

    python -m container_engine_accelerators_tpu_torch.faults.storm \
        --restarts 3 --json /tmp/restart-storm.json
"""

import argparse
import json
import logging
import os
import sys
import time

import torch

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.models import supervisor
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import goodput as obs_goodput
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.utils import checkpointing
from container_engine_accelerators_tpu_torch.warmstart import cache as ws_cache

log = logging.getLogger(__name__)

# Fault site: one tick per training step; `preemption` specs at scripted
# hit indices are the storm's kill schedule.
TRAIN_SITE = "train.storm"

EVENT_SOURCE = "storm"


def corrupt_step(ckpt_dir, step):
    """Simulate on-disk corruption of one saved step: every file in the
    step dir (the port's ``state.pt``) is overwritten with garbage, so
    the next restore of it must fail — the crash-loop bait the
    quarantine path defuses."""
    root_dir = os.path.join(ckpt_dir, f"step_{step}")
    for root, _, files in os.walk(root_dir):
        for fn in files:
            with open(os.path.join(root, fn), "wb") as f:
                f.write(b"garbage")
    return root_dir


def make_compile_sim(cache, cost_s, prefix="serve"):
    """A ``fleet/sim.py`` ``compile_sim`` hook: the first use of each
    static shape in THIS cache's lifetime pays ``cost_s`` of simulated
    compile; every later use (any process, any replica) is a memo
    hit and free — the persistent-cache contract, hermetically."""

    def compile_sim(label):
        if not cache.memo(f"{prefix}/{label}"):
            time.sleep(cost_s)

    # SimReplica.warm reads hit/miss deltas from the cache its
    # compile_sim writes to — not the process-global armed one, which
    # a caller may never have armed.
    compile_sim.cache = cache
    return compile_sim


def run_drill(n_kills=3, steps=12, ckpt_every=2, kill_every=5,
              corrupt_on_restart=2, compile_cost_s=0.12,
              serve_compile_cost_s=0.05, step_s=0.003, requests=8,
              max_new=6, seed=None, work_dir=None):
    """The restart-storm drill; returns the verdict dict
    (``verdict["pass"]`` is the acceptance bit, every failed check a
    line in ``verdict["failures"]`` quoting the chaos seed)."""
    import tempfile

    from container_engine_accelerators_tpu_torch.fleet import sim as fleet_sim

    if n_kills < 2:
        raise ValueError("n_kills must be >= 2 (the corruption rides "
                         "a mid-storm restart)")
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    work_dir = work_dir or tempfile.mkdtemp(prefix="restart-storm-")
    ckpt_dir = os.path.join(work_dir, "ckpt")

    registry = obs_metrics.Registry()
    train_events = obs_events.EventStream(
        EVENT_SOURCE, host="trainer", registry=registry,
    )
    cache = ws_cache.CompileCache(
        os.path.join(work_dir, "compile-cache"),
        key=ws_cache.cache_key(topology="sim", cfg={"drill": "storm"}),
        registry=registry, events=train_events,
    )
    plan = faults.FaultPlan(
        [{"kind": "preemption", "site": TRAIN_SITE,
          "at": kill_every * (i + 1), "count": 1}
         for i in range(n_kills)],
        seed=seed, events=train_events, registry=registry,
    )
    faults.arm(plan)
    ws_cache.arm(cache)
    try:
        return _run_drill_armed(
            n_kills, steps, ckpt_every, corrupt_on_restart,
            compile_cost_s, serve_compile_cost_s, step_s, requests,
            max_new, seed, tag, ckpt_dir, registry, train_events,
            cache, fleet_sim,
        )
    finally:
        ws_cache.deactivate()
        faults.disarm()


def _run_drill_armed(n_kills, steps, ckpt_every, corrupt_on_restart,
                     compile_cost_s, serve_compile_cost_s, step_s,
                     requests, max_new, seed, tag, ckpt_dir, registry,
                     train_events, cache, fleet_sim):
    span_rows = []  # (name, wall_start_s, dur_s) for the ledger
    attempt_stats = []
    like_state = {"w": torch.zeros(8, dtype=torch.float32),
                  "step": torch.tensor(0, dtype=torch.int32)}

    def run_fn():
        """One training-binary attempt: (simulated) compile, crash-safe
        restore, step loop with real checkpoints — restartable, the
        supervisor contract."""
        t_ready = time.monotonic()
        snap0 = cache.snapshot()
        t0 = time.monotonic()
        if not cache.memo("train/step_program"):
            # First compile of this binary's program in the cache's
            # lifetime: pay the (simulated) compile. Every restart
            # replays it from the cache for free.
            time.sleep(compile_cost_s)
        compile_dur = time.monotonic() - t0
        span_rows.append(
            ("init_state", time.time() - compile_dur, compile_dur)
        )
        restored, start = checkpointing.restore_latest(
            ckpt_dir, like_state, events=train_events,
        )
        state = restored if restored is not None else like_state
        start = start or 0
        snap1 = cache.snapshot()
        attempt_stats.append({
            "ready_s": round(time.monotonic() - t_ready, 6),
            "compile_s": round(compile_dur, 6),
            "cache_hits": snap1["hits"] - snap0["hits"],
            "cache_misses": snap1["misses"] - snap0["misses"],
            "resumed_from": start,
        })
        for step in range(start + 1, steps + 1):
            t_s = time.monotonic()
            # The storm's kill schedule: a preemption spec active at
            # this site hit raises out of the attempt.
            faults.fire(TRAIN_SITE, step=step)
            time.sleep(step_s)
            state = {"w": state["w"] + 1.0,
                     "step": torch.tensor(step, dtype=torch.int32)}
            supervisor.beat(step)
            train_events.emit(
                "train_step", step=step,
                dur_s=round(time.monotonic() - t_s, 6),
            )
            if step % ckpt_every == 0 or step == steps:
                t_ck = time.monotonic()
                checkpointing.save(ckpt_dir, step, state)
                ck_dur = time.monotonic() - t_ck
                span_rows.append(
                    ("checkpoint", time.time() - ck_dur, ck_dur)
                )
        return {"final_step": steps}

    # -- serving tier: a cold replica takes the first half of the
    # traffic; mid-storm it dies and a WARM replacement takes over.
    compile_sim = make_compile_sim(cache, serve_compile_cost_s)
    replicas = {
        "cold": fleet_sim.SimReplica(
            "replica-cold", chunk_sleep_s=0.0, compile_sim=compile_sim,
        ),
    }
    outputs = []  # (replica, prompt, out)
    serve_timing = {}

    def _serve(replica, prompt):
        out = replicas[replica].engine.generate([prompt], max_new)[0]
        outputs.append((replica, prompt, out))

    prompts = [[(i % 13) + 1, (i % 5) + 1, 3] for i in range(requests)]
    t0 = time.monotonic()
    _serve("cold", prompts[0])
    # Cold boot cost: the first request's wall time INCLUDES its lazy
    # first-compiles (--warmup=lazy on an empty cache).
    serve_timing["cold_first_s"] = round(time.monotonic() - t0, 6)
    for prompt in prompts[1 : requests // 2]:
        _serve("cold", prompt)

    corrupted = []

    def storm_sleep(backoff_s):
        """The supervisor's between-attempts sleep — where the storm
        does its mid-storm damage (deterministically, attempt-indexed:
        no race against the training thread, which is parked here)."""
        restart = len(attempt_stats)  # completed attempts so far
        if restart == 1:
            # Mid-storm replica replacement: the cold replica dies; the
            # replacement AOT-warms every shape the fleet already
            # compiled (the memo names) BEFORE taking traffic.
            replicas["cold"].kill()
            t0 = time.monotonic()
            warm = fleet_sim.SimReplica(
                "replica-warm", chunk_sleep_s=0.0,
                compile_sim=compile_sim,
            )
            labels = [
                n.split("serve/", 1)[1]
                for n in cache.memo_names() if n.startswith("serve/")
            ]
            serve_timing["warmup"] = warm.warm(labels)
            replicas["warm"] = warm
            _serve("warm", prompts[requests // 2])
            serve_timing["warm_ready_s"] = round(
                time.monotonic() - t0, 6,
            )
            for prompt in prompts[requests // 2 + 1:]:
                _serve("warm", prompt)
        if restart == corrupt_on_restart:
            step = checkpointing.latest_step(ckpt_dir)
            if step is not None:
                corrupt_step(ckpt_dir, step)
                corrupted.append(step)
                log.warning(
                    "storm: corrupted newest checkpoint step_%d %s",
                    step, tag,
                )
        time.sleep(min(backoff_s, 0.05))

    result = supervisor.supervise(
        run_fn, watchdog_s=0.0, max_restarts=n_kills + 2,
        backoff_base_s=0.01, backoff_max_s=0.05, seed=seed,
        events=train_events, sleep=storm_sleep,
    )

    # -- the judge: goodput ledger over everything the storm emitted.
    records = list(train_events.events())
    for sr in replicas.values():
        records.extend(sr.events.events())
    builder = obs_goodput.build_ledger(records, spans=span_rows)
    totals = builder.ledger.totals()
    cache_totals = cache.snapshot()

    failures = []
    if result.get("restarts") != n_kills:
        failures.append(
            f"expected {n_kills} restarts, supervisor recorded "
            f"{result.get('restarts')} {tag}"
        )
    if checkpointing.latest_step(ckpt_dir) != steps:
        failures.append(
            f"final checkpoint is step "
            f"{checkpointing.latest_step(ckpt_dir)}, not {steps} {tag}"
        )
    # Compile charged once per binary: attempt 1 misses and pays; every
    # later attempt hits (counter > 0) and pays ~nothing.
    if not attempt_stats or attempt_stats[0]["cache_misses"] < 1:
        failures.append(f"first attempt never paid a compile {tag}")
    for i, a in enumerate(attempt_stats[1:], start=2):
        if a["cache_hits"] < 1:
            failures.append(
                f"attempt {i} resumed without a compile-cache hit "
                f"(tpu_compile_cache_hits_total stayed 0) {tag}"
            )
        if a["ready_s"] >= attempt_stats[0]["ready_s"]:
            failures.append(
                f"attempt {i} restart-to-ready "
                f"({a['ready_s']:.3f}s) not below cold boot "
                f"({attempt_stats[0]['ready_s']:.3f}s) {tag}"
            )
    train_compile_s = sum(
        dur for name, _, dur in span_rows if name == "init_state"
    )
    if train_compile_s >= 2 * compile_cost_s:
        failures.append(
            f"compile badput {train_compile_s:.3f}s across "
            f"{len(attempt_stats)} attempts — charged per restart, "
            f"not per binary (one compile = {compile_cost_s}s) {tag}"
        )
    # Corruption: exactly one quarantine, resume from the PRIOR step,
    # run completed (no crash loop, nothing lost but the bad step).
    fallbacks = [r for r in records
                 if (r.get("kind") or r.get("event"))
                 == "checkpoint_fallback"]
    if len(fallbacks) != 1:
        failures.append(
            f"expected exactly 1 checkpoint_fallback, saw "
            f"{len(fallbacks)} {tag}"
        )
    elif corrupted:
        resumed = attempt_stats[corrupt_on_restart]["resumed_from"]
        if resumed != corrupted[0] - ckpt_every:
            failures.append(
                f"post-corruption resume from step {resumed}, expected "
                f"{corrupted[0] - ckpt_every} (the prior step) {tag}"
            )
        if not os.path.isdir(
            os.path.join(ckpt_dir, f"step_{corrupted[0]}.corrupt")
        ):
            failures.append(
                f"corrupted step_{corrupted[0]} was not quarantined "
                f"on disk {tag}"
            )
    # Serving replacement: warm strictly beats cold, warmed from cache
    # hits, and every response byte-exact.
    warmup = serve_timing.get("warmup") or {}
    if warmup.get("cache_hits", 0) < 1:
        failures.append(
            f"replacement replica warmup had no cache hits {tag}"
        )
    if serve_timing.get("warm_ready_s", 1e9) >= \
            serve_timing.get("cold_first_s", 0.0):
        failures.append(
            f"warm replica ready ({serve_timing.get('warm_ready_s')}s)"
            f" not below cold boot "
            f"({serve_timing.get('cold_first_s')}s) {tag}"
        )
    if not any(r == "warm" for r, _, _ in outputs):
        failures.append(f"replacement replica served nothing {tag}")
    bad = [
        (r, p, o) for r, p, o in outputs
        if o != fleet_sim.expected_output(p, max_new)
    ]
    if bad:
        failures.append(
            f"{len(bad)} corrupted serving outputs (first from "
            f"{bad[0][0]}) {tag}"
        )
    wall = builder.ledger.wall_s()
    if abs(sum(totals.values()) - wall) > max(0.01 * wall, 1e-6):
        failures.append(
            f"ledger categories ({sum(totals.values()):.3f}s) do not "
            f"sum to wall clock ({wall:.3f}s) {tag}"
        )

    verdict = {
        "seed": seed,
        "restarts": result.get("restarts"),
        "attempts": attempt_stats,
        "corrupted_step": corrupted[0] if corrupted else None,
        "checkpoint_fallbacks": len(fallbacks),
        "serve_timing": serve_timing,
        "served": len(outputs),
        "compile_cache": cache_totals,
        "ledger": {
            "wall_s": round(wall, 6),
            "goodput_ratio": round(builder.ledger.goodput_ratio(), 6),
            "seconds": {c: round(v, 6) for c, v in totals.items()},
            "by_fault": {
                k: round(v, 6) for k, v in builder.by_fault.items()
            },
        },
        "train_compile_s": round(train_compile_s, 6),
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
    p.add_argument("--restarts", type=int, default=3,
                   help="how many times the storm kills the trainer "
                        "(K >= 2; the checkpoint corruption rides a "
                        "mid-storm restart)")
    p.add_argument("--steps", type=int, default=12,
                   help="training steps the run must complete")
    p.add_argument("--kill-every", type=int, default=5,
                   help="site-hit spacing of the kill schedule (kill i "
                        "fires at step-hit kill_every*(i+1); must be "
                        "reachable within --steps re-runs)")
    p.add_argument("--requests", type=int, default=8,
                   help="serving requests split across the cold "
                        "replica and its warm replacement")
    p.add_argument("--compile-cost-s", type=float, default=0.12,
                   help="simulated compile cost the first (and "
                        "only the first) training attempt pays")
    p.add_argument("--seed", type=int, default=None,
                   help="chaos seed (default: CHAOS_SEED env, else 0)")
    p.add_argument("--work-dir", default="",
                   help="checkpoint + compile-cache root (default: a "
                        "fresh temp dir)")
    p.add_argument("--json", default="",
                   help="write the machine-readable verdict here")
    args = p.parse_args(argv)
    verdict = run_drill(
        n_kills=args.restarts, steps=args.steps,
        kill_every=args.kill_every, requests=args.requests,
        compile_cost_s=args.compile_cost_s, seed=args.seed,
        work_dir=args.work_dir or None,
    )
    out = json.dumps(verdict, indent=2, sort_keys=True)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if not verdict["pass"]:
        for failure in verdict["failures"]:
            log.error("drill failure: %s", failure)
        return 1
    log.info(
        "restart storm passed: %d restarts, compile paid once "
        "(%.3fs across %d attempts), warm ready %.3fs vs cold %.3fs, "
        "%d checkpoint fallback, %d served",
        verdict["restarts"], verdict["train_compile_s"],
        len(verdict["attempts"]),
        verdict["serve_timing"].get("warm_ready_s", -1),
        verdict["serve_timing"].get("cold_first_s", -1),
        verdict["checkpoint_fallbacks"], verdict["served"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
