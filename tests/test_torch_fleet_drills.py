# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's flight drill (``fleet/flightdrill.py``) and day drill
(``fleet/daysim.py``) against the JAX package's, on the CPU.

Each drill runs once, through its CLI, in a module fixture its tests
share:

  * the flight drill wedges the lockstep link of the port's hermetic
    harness (``fleet/linksim.py``) and reads the one bundle the flight
    recorder dumps; its verdict passes on the structural fields JAX's
    twin (``tests/test_flight.py``) asserts, no wall time read, and
    JAX's ``postmortem.analyze`` reads the port's bundle to the summary
    the port's copy gives;
  * the day drill runs a reduced day (``--requests 3000``, where JAX's
    twin ``tests/test_tenant_drill.py`` runs 20000) on the port's router,
    autoscaler, lifecycle and hermetic replicas; it passes on the twin's
    headline checks, and JAX's ``day_verdict`` over the port's
    control-plane records equals the port's.
"""

import json

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu.fleet import daysim as jdaysim  # noqa: E402
from container_engine_accelerators_tpu.fleet import flightdrill as jflightdrill  # noqa: E402
from container_engine_accelerators_tpu.obs import postmortem as jpostmortem  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import daysim  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import flightdrill  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import postmortem  # noqa: E402

INTERVAL_S = 0.25
DAY_REQUESTS = 3000


@pytest.fixture(scope="module")
def flight(tmp_path_factory):
    """The port's drill through its CLI: (exit code, verdict)."""
    root = tmp_path_factory.mktemp("flight")
    out = root / "verdict.json"
    rc = flightdrill.main(["--dir", str(root / "bundles"), "--json",
                           str(out), "--interval-s", str(INTERVAL_S)])
    return rc, json.loads(out.read_text())


def test_flight_drill_passes_on_its_structural_fields(flight):
    rc, verdict = flight
    assert rc == 0 and verdict["pass"], verdict["failures"]
    assert verdict["trigger"] == "link_wedged"
    assert verdict["bundle"].endswith("flight-0001-link_wedged.jsonl")
    base = postmortem.base_series_name(verdict["first_anomaly"])
    assert "wedge" in base or "op_wait" in base, verdict
    assert abs(verdict["first_anomaly_rel_s"]) <= INTERVAL_S
    assert {"fault_injected", "link_wedged"} <= \
        set(verdict["correlated_kinds"])
    # The verdict carries JAX's keys.
    assert set(verdict) == set(jflightdrill._verdict(
        [], 0, None, type("R", (), {"last_bundle": None})))


def test_jax_postmortem_reads_the_port_bundle_as_the_port_copy_does(flight):
    _, verdict = flight
    got = postmortem.analyze(verdict["bundle"])
    want = jpostmortem.analyze(verdict["bundle"])
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    assert got["first_anomaly"]["series"] == verdict["first_anomaly"]


@pytest.fixture(scope="module")
def day(tmp_path_factory):
    """A reduced day through the port's CLI: (exit code, verdict, the
    event log's records)."""
    root = tmp_path_factory.mktemp("day")
    out, events = root / "verdict.json", root / "events.jsonl"
    rc = daysim.main(["--requests", str(DAY_REQUESTS), "--json", str(out),
                      "--event-log", str(events)])
    records = [json.loads(line) for line in events.read_text().splitlines()]
    return rc, json.loads(out.read_text()), records


def test_reduced_day_passes_the_twin_s_headline_checks(day):
    rc, verdict, _ = day
    assert rc == 0 and verdict["pass"], verdict["failures"]
    assert verdict["requests_total"] == DAY_REQUESTS
    assert verdict["premium_goodput"] >= 0.99
    assert verdict["by_class"]["premium"]["shed"] == 0
    assert verdict["by_class"]["batch"]["shed"] >= \
        verdict["expected_quota_sheds"] > 0
    assert verdict["phase_shed"]["burst_quota"] == \
        verdict["expected_quota_sheds"]
    assert verdict["retired"] == verdict["served"] + verdict["hedge_wasted"]
    assert verdict["hedged"]["won"] >= 1
    assert verdict["scale_outs"] >= 1 and verdict["scale_ins"] >= 1
    assert verdict["reconcile"]["adopted"] and \
        verdict["reconcile"]["orphaned"]
    assert all(v >= 1 for v in verdict["slo_good"].values())
    chip = verdict["chip_accounting"]
    assert set(chip["per_class"]) == {"premium", "standard", "batch"}
    assert abs(sum(chip["per_class"].values()) - chip["device_s"]) <= \
        0.01 * chip["device_s"]
    audit = verdict["fairness_audit"]
    assert audit["drift_rule_fired"] and audit["starved_premium_ratio"] < 0.5


def test_jax_day_verdict_on_the_port_records_equals_the_port_s(day):
    _, verdict, records = day
    control = [r for r in records
               if r.get("source") in ("fleet.router", "fleet.lifecycle")]
    assert control
    got = daysim.day_verdict(control)
    assert got == jdaysim.day_verdict(control)
    # The day's own verdict was computed from these records.
    assert {k: verdict[k] for k in got} == json.loads(json.dumps(got))
