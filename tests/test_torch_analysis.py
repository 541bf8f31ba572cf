# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The JAX package's static contract analyzer (``analysis/``) over the
port's package: the event, metric, zero-cost-hook, lock-discipline and
port passes, whose defaults name the JAX package's files, run with the
same options pointed at the port's copies. Findings that belong to what
the port does not copy (yet) are grandfathered in
``tests/torch_analysis_baseline.json``, each with its reason; any other
finding fails, and so does a baseline entry that matches nothing."""

import os

import pytest

from container_engine_accelerators_tpu import analysis
from container_engine_accelerators_tpu.analysis import (
    events_pass,
    ports_pass,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "container_engine_accelerators_tpu_torch")
BASELINE = os.path.join(REPO, "tests", "torch_analysis_baseline.json")
JAX_PREFIX = "container_engine_accelerators_tpu/"


def _port_paths(jax_paths):
    """JAX's default paths that the port has a copy of, relative to the
    port's package."""
    rels = [p[len(JAX_PREFIX):] for p in jax_paths
            if p.startswith(JAX_PREFIX)]
    return [r for r in rels if os.path.exists(os.path.join(PORT, r))]


OPTIONS = {
    # The port's obs/ports.py is its authoritative port map.
    "port_exempt": _port_paths(ports_pass.DEFAULT_PORT_EXEMPT),
    "cli_modules": _port_paths(ports_pass.DEFAULT_CLI_MODULES),
    "event_consumers": _port_paths(events_pass.DEFAULT_CONSUMERS),
}


@pytest.fixture(scope="module")
def findings():
    project = analysis.Project.for_plain_dir(PORT, options=OPTIONS)
    return analysis.run_passes(project)


def test_options_point_at_the_port_s_copies():
    assert OPTIONS["port_exempt"] == ["obs/ports.py"]
    assert {"models/serve_cli.py", "models/train_cli.py",
            "fleet/router.py", "fleet/sim.py", "fleet/disagg.py",
            "faults/storm.py"} <= set(OPTIONS["cli_modules"])
    assert {"obs/goodput.py", "fleet/router.py", "fleet/autoscaler.py",
            "fleet/sim.py"} <= set(OPTIONS["event_consumers"])


def test_port_is_clean_against_its_baseline(findings):
    entries = analysis.load_baseline(BASELINE)
    kept, suppressed, stale = analysis.apply_baseline(findings, entries)
    assert not kept, "\n".join(f.render() for f in kept)
    assert not stale, f"stale baseline entries (delete them): {stale}"
    assert suppressed


def test_every_baseline_entry_has_a_reason():
    # load_baseline refuses an entry without pass, path, contains and a
    # non-empty reason.
    entries = analysis.load_baseline(BASELINE)
    assert entries and all(e["reason"].strip() for e in entries)


def test_serve_cli_emits_nothing_under_the_admission_lock(findings):
    held = [f for f in findings
            if f.path == "models/serve_cli.py"
            and f.pass_id == "lock-discipline"]
    assert not held, "\n".join(f.render() for f in held)


def test_serve_cli_trace_hooks_are_zero_cost(findings):
    hooks = [f for f in findings
             if f.path == "models/serve_cli.py"
             and f.pass_id == "zero-cost-hook"]
    assert not hooks, "\n".join(f.render() for f in hooks)
