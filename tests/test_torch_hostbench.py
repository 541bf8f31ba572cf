# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's host-loop microbench (``kvcache/hostbench.py``): the six
properties of the JAX package's tests/test_hostbench.py on the port's
``ContinuousEngine`` with fake device seams, on the CPU. Host overhead
per retired token stays under a pinned budget, so a host-loop regression
(a sync on the hot path, a per-token allocation) fails fast."""

import json

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu_torch.kvcache import (  # noqa: E402
    hostbench,
)

# Pinned budget: measured 11.8-20.8 us/token (paged), 7.6-11.2 (dense)
# and 28.1-46.1 (paged + ngram) over five runs each on the CPU of the
# development container; 200 leaves about 10x headroom over the plain
# rows, as JAX's 400 does over its 38, for loaded CI hosts, while still
# catching a per-token sync or allocation.
BUDGET_US = 200.0


def test_paged_host_overhead_under_budget():
    result = hostbench.run_hostbench(requests=32, max_new=32)
    assert result["host_us_per_token"] < BUDGET_US, result
    assert result["tokens"] == 32 * 32
    # The shared-prefix storm reused prefixes (steady-state lap: the warm
    # lap filled the radix cache).
    assert result["prefix_hit_ratio"] > 0.3, result


def test_dense_host_overhead_under_budget():
    result = hostbench.run_hostbench(requests=32, max_new=32,
                                     kv_cache="dense")
    assert result["host_us_per_token"] < BUDGET_US, result
    assert result["prefix_hit_ratio"] == 0.0


def test_spec_bench_step_reduction_and_budget():
    """Speculative decoding on repetitive-suffix drill traffic retires
    tokens in <= 0.5 sequential device steps per generated token without
    bloating the host loop."""
    result = hostbench.run_hostbench(requests=24, max_new=32,
                                     speculate="ngram")
    assert result["speculate"] == "ngram"
    assert result["device_steps_per_token"] <= 0.5, result
    assert result["verify_steps"] > 0
    assert result["acceptance_ratio"] > 0.0, result
    # Doubled, as in JAX: each verify round adds proposer work and
    # operand staging to the host loop.
    assert result["host_us_per_token"] < 2 * BUDGET_US, result


def test_hostbench_outputs_are_verified_byte_exact():
    # run_hostbench raises on any corrupted output: a passing run IS the
    # verification.
    result = hostbench.run_hostbench(requests=8, max_new=8, seed=3)
    assert result["seed"] == 3
    assert hostbench.expected([30, 31], 3) == [30, 31, 0, 1, 2]


def test_hostbench_cli_budget_gate(tmp_path):
    out = tmp_path / "r.json"
    rc = hostbench.main([
        "--requests", "8", "--max-new", "8",
        "--budget-us", "1000000", "--json", str(out),
    ])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["host_us_per_token"] > 0
    # An absurd budget fails loudly with rc 1.
    rc = hostbench.main([
        "--requests", "8", "--max-new", "8", "--budget-us", "0.0001",
    ])
    assert rc == 1


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_hostbench_deterministic_workload(mode):
    a = hostbench.run_hostbench(requests=8, max_new=4, kv_cache=mode,
                                seed=5)
    b = hostbench.run_hostbench(requests=8, max_new=4, kv_cache=mode,
                                seed=5)
    assert a["tokens"] == b["tokens"]
    assert a["requests"] == b["requests"]
