# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's restart storm (``faults/storm.py``), JAX
``tests/test_restart_storm.py``'s assertions on the port's supervisor,
checkpoints (``step_<N>/state.pt``), compile cache and goodput ledger:
compile badput charged once per binary, warm restart-to-ready below
cold boot, a corrupted newest checkpoint quarantined and fallen back
from. Hermetic: the CPU, fake-seam serving, simulated compiles through
the compile-cache memo."""

import json
import os

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu.faults import storm as jstorm  # noqa: E402
from container_engine_accelerators_tpu.warmstart import cache as jcache  # noqa: E402
from container_engine_accelerators_tpu_torch import faults  # noqa: E402
from container_engine_accelerators_tpu_torch.faults import storm  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import sim as fleet_sim  # noqa: E402
from container_engine_accelerators_tpu_torch.utils import checkpointing  # noqa: E402
from container_engine_accelerators_tpu_torch.warmstart import (  # noqa: E402
    cache as ws_cache,
)

SEED = int(os.environ.get("CHAOS_SEED", "0"))
TAG = f"(chaos seed={SEED}; rerun with CHAOS_SEED={SEED})"


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    ws_cache.deactivate()
    jcache.deactivate()
    yield
    faults.disarm()
    ws_cache.deactivate()
    jcache.deactivate()


def test_restart_storm_drill(tmp_path):
    """K=3 kills, JAX's acceptance criteria end to end."""
    verdict = storm.run_drill(n_kills=3, seed=SEED, work_dir=str(tmp_path))
    assert verdict["pass"], "\n".join(verdict["failures"])
    assert verdict["restarts"] == 3, TAG
    attempts = verdict["attempts"]
    assert len(attempts) == 4, TAG
    assert verdict["train_compile_s"] < 2 * 0.12, TAG
    assert attempts[0]["cache_misses"] >= 1, TAG
    for a in attempts[1:]:
        assert a["cache_hits"] >= 1, (a, TAG)
        assert a["ready_s"] < attempts[0]["ready_s"], (a, TAG)
    assert verdict["checkpoint_fallbacks"] == 1, TAG
    assert verdict["corrupted_step"] is not None, TAG
    assert os.path.isdir(
        tmp_path / "ckpt" / f"step_{verdict['corrupted_step']}.corrupt"
    ), TAG
    t = verdict["serve_timing"]
    assert t["warmup"]["cache_hits"] >= 1, TAG
    assert t["warmup"]["cache_misses"] == 0, TAG
    assert t["warm_ready_s"] < t["cold_first_s"], TAG
    led = verdict["ledger"]
    assert sum(led["seconds"].values()) == pytest.approx(
        led["wall_s"], rel=0.01,
    ), TAG
    assert led["seconds"]["compile"] == pytest.approx(
        verdict["train_compile_s"], rel=0.05,
    ), TAG


def test_storm_cli_writes_machine_readable_verdict(tmp_path):
    out = tmp_path / "verdict.json"
    rc = storm.main([
        "--restarts", "2", "--steps", "8", "--kill-every", "3",
        "--requests", "6",
        "--work-dir", str(tmp_path / "work"), "--json", str(out),
    ])
    assert rc == 0
    verdict = json.loads(out.read_text())
    assert verdict["pass"] is True
    assert verdict["restarts"] == 2


def test_sim_replica_warm_accounts_against_its_own_cache(tmp_path):
    cache = ws_cache.CompileCache(str(tmp_path / "cc"), key="k")
    assert ws_cache.active() is None
    first = fleet_sim.SimReplica(
        "r1", chunk_sleep_s=0.0,
        compile_sim=storm.make_compile_sim(cache, 0.0),
    )
    summary = first.warm(["a", "b"])
    assert summary["cache_misses"] == 2
    assert summary["cache_hits"] == 0
    replacement = fleet_sim.SimReplica(
        "r2", chunk_sleep_s=0.0,
        compile_sim=storm.make_compile_sim(cache, 0.0),
    )
    labels = [n.split("serve/", 1)[1] for n in cache.memo_names()]
    summary = replacement.warm(labels)
    assert summary["cache_hits"] == 2
    assert summary["cache_misses"] == 0
    first.engine.shutdown()
    replacement.engine.shutdown()


def test_corrupt_step_makes_the_port_s_checkpoint_unreadable(tmp_path):
    import torch

    state = {"w": torch.arange(4.0), "step": torch.tensor(2)}
    checkpointing.save(str(tmp_path), 2, state)
    checkpointing.save(str(tmp_path), 4, state)
    storm.corrupt_step(str(tmp_path), 4)
    assert (tmp_path / "step_4" / checkpointing.STATE_FILE).read_bytes() \
        == b"garbage"
    restored, step = checkpointing.restore_latest(str(tmp_path), state)
    assert step == 2 and torch.equal(restored["w"], state["w"])
    assert (tmp_path / "step_4.corrupt").is_dir()


def test_storm_verdict_agrees_with_jax_s(tmp_path):
    """Both packages' storms on the same seed and schedule: the same
    restarts, resume points, corrupted step, fallbacks, hit/miss counts,
    requests served, faults charged and ledger categories. Nothing that
    depends on timing is compared: ``pass`` folds in wall-clock checks
    (each resume's ready time below the first attempt's, the warm
    replica below the cold one), and ``wedged`` holds the seconds from
    the last heartbeat to the recovery decision, rounded to the
    millisecond, which on the port's fast ``torch.save`` are 0.000 to
    0.002 per restart and so may sum to nothing."""
    got = {}
    for name, mod in (("jax", jstorm), ("port", storm)):
        v = mod.run_drill(n_kills=3, seed=SEED,
                          work_dir=str(tmp_path / name))
        got[name] = {
            "restarts": v["restarts"],
            "attempts": [{k: a[k] for k in ("cache_hits", "cache_misses",
                                            "resumed_from")}
                         for a in v["attempts"]],
            "corrupted_step": v["corrupted_step"],
            "checkpoint_fallbacks": v["checkpoint_fallbacks"],
            "served": v["served"], "compile_cache": v["compile_cache"],
            "warmup": {k: v["serve_timing"]["warmup"][k]
                       for k in ("tasks", "compiled", "cache_hits",
                                 "cache_misses")},
            "faults": sorted(v["ledger"]["by_fault"]),
            "categories": sorted(
                c for c, s in v["ledger"]["seconds"].items()
                if s > 0 and c not in ("idle", "wedged")
            ),
        }
    assert got["port"] == got["jax"], TAG
