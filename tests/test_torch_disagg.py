# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's disaggregated prefill/decode bench (``fleet/disagg.py``)
on port engines: JAX ``tests/test_disagg.py``'s fleet-level assertions
(the prefix directory, role-aware routing, handoff on a remap, the
split fleet's byte-exact output, the fault fallback charged to
``drain_migration``, the fast twin), and the fast twin's verdict against
JAX's on its structural fields.

JAX's wire-format and manager tests (export/install round trips,
idempotent installs, corrupt and dropped frames, torn streams, block
size mismatches, the loopback transport, the engine's export/install
through the loop, the dense engine's refusal) are not repeated here:
``tests/test_torch_handoff.py`` holds the port's handoff to JAX's on
the same cases, byte for byte."""

import os

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu import faults as jfaults  # noqa: E402
from container_engine_accelerators_tpu.fleet import disagg as jdisagg  # noqa: E402
from container_engine_accelerators_tpu_torch import faults  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import disagg  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import router  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import sim  # noqa: E402

SEED = int(os.environ.get("CHAOS_SEED", "0"))
FAST = dict(families=2, repeats=3, max_new=6, chunk_sleep_s=0.0,
            prefill_sleep_s=0.0, cold_interval_s=0.005, strict_timing=False)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def test_prefix_directory_records_locates_and_forgets():
    d = router.PrefixDirectory(max_entries=3)
    for i in range(4):
        d.record(f"k{i}", f"replica-{i % 2}")
    assert d.locate("k0") is None  # evicted, bounded
    assert d.locate("k3") == "replica-1"
    assert len(d) == 3
    assert d.forget_replica("replica-1") == 2
    assert d.locate("k3") is None


def test_router_records_holder_and_hands_off_on_remap():
    rt, replicas, events = disagg._mk_fleet(
        ["unified"] * 2, True, 0.0, 0.0)
    bad = []
    prompt = disagg._family_prompt(0)
    disagg._submit_checked(rt, prompt, 4, bad)
    holder = rt.prefix_holder(prompt)
    assert holder in {r.replica_id for r in replicas}
    # Eject the holder: the remapped target pulls the blocks (with the
    # pools' bytes) over the wire instead of re-prefilling.
    rt.eject(holder, reason="test remap")
    disagg._submit_checked(rt, prompt, 4, bad)
    assert not bad
    kinds = [r.get("kind") for r in events.events()]
    assert "kv_handoff" in kinds and "kv_handoff_failed" not in kinds
    assert rt.prefix_holder(prompt) != holder


def test_prefill_only_requests_route_to_prefill_capacity():
    rt, replicas, _ = disagg._mk_fleet(
        ["prefill", "decode"], True, 0.0, 0.0)
    roles = {r.replica_id: r.role for r in replicas}
    p0 = disagg._cold_prompt(0)
    out = rt.submit({"tokens": [p0], "max_new_tokens": 1})
    assert out["tokens"][0] == sim.expected_output(p0, 1)
    assert roles[rt.prefix_holder(p0)] == "prefill"
    p1 = disagg._cold_prompt(1)
    out = rt.submit({"tokens": [p1], "max_new_tokens": 8})
    assert out["tokens"][0] == sim.expected_output(p1, 8)
    assert roles[rt.prefix_holder(p1)] == "decode"


def test_split_fleet_output_is_byte_exact():
    out = disagg._handoff_exactness(0.0, 0.0, 8)
    assert out["byte_exact"]
    # The decode replica served the handed-off prefix from its cache.
    assert out["decode_hit_tokens"] >= 12


def test_handoff_failure_falls_back_byte_exact_and_charges_badput():
    out = disagg._fault_phase(SEED, 0.0, 6)
    assert out["byte_exact"]
    assert out["handoff_failures"] == 2
    assert out["failure_reasons"] == ["desync", "timeout"]
    assert out["drain_migration_s"] > 0


def test_disagg_bench_fast_twin_passes():
    verdict = disagg.run_bench(seed=SEED, **FAST)
    assert verdict["pass"], "\n".join(verdict["failures"])
    assert verdict["split"]["kv_handoffs"] >= 2
    assert verdict["exactness"]["byte_exact"]
    assert verdict["storm"]["pass"]
    assert verdict["fault"]["failure_reasons"] == ["desync", "timeout"]


def test_fast_twin_verdict_agrees_with_jax_s():
    """Both packages' fast twins: the same pass bit, handoff counts,
    exact outputs, storm and fault outcomes (latencies and QPS are not
    compared)."""
    got = {}
    for name, mod in (("jax", jdisagg), ("port", disagg)):
        v = mod.run_bench(seed=SEED, **FAST)
        got[name] = {
            "pass": v["pass"],
            "bad": [v[p]["bad"] for p in ("baseline", "unified", "split")],
            "baseline_handoffs": v["baseline"]["kv_handoffs"],
            "exactness": v["exactness"],
            "storm": v["storm"],
            "fault": {k: v["fault"][k] for k in ("handoff_failures",
                                                 "failure_reasons",
                                                 "byte_exact")},
        }
    assert got["port"] == got["jax"]
