# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``kvcache/hostbench.py --fingerprint-out`` against the JAX
package's: the file the port writes is read and gated by JAX's
``obs.baseline``, with JAX's bench names, series keys and meta."""

import json

import pytest

pytest.importorskip("torch")

from container_engine_accelerators_tpu.kvcache import (  # noqa: E402
    hostbench as jax_hostbench,
)
from container_engine_accelerators_tpu.obs import (  # noqa: E402
    baseline as jax_baseline,
)
from container_engine_accelerators_tpu_torch.kvcache import (  # noqa: E402
    hostbench,
)
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    baseline,
)

ARGS = ["--requests", "6", "--max-new", "6", "--seed", "2"]


@pytest.mark.parametrize("speculate", ["off", "ngram"])
def test_fingerprint_read_by_jax(tmp_path, speculate):
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    argv = ARGS + ["--speculate", speculate]
    assert hostbench.main(argv + ["--fingerprint-out", str(ours)]) == 0
    assert jax_hostbench.main(argv + ["--fingerprint-out",
                                      str(theirs)]) == 0
    got = jax_baseline.load_fingerprint(str(ours))
    want = jax_baseline.load_fingerprint(str(theirs))
    assert got["bench"] == want["bench"] == (
        "spec-bench" if speculate == "ngram" else "hostbench")
    assert set(got["series"]) == set(want["series"])
    assert got["meta"] == want["meta"]
    assert set(got) == set(want)
    # JAX's gate takes the port's fingerprint against a baseline seeded
    # from it (every series inside its own band).
    base = tmp_path / "base.json"
    base.write_text(json.dumps(jax_baseline.seed_baseline(got)))
    assert jax_baseline.gate(str(ours), str(base)) == 0


def test_baseline_copy_matches_jax():
    """The copy's series, bands and fingerprint layout are JAX's."""
    result = hostbench.run_hostbench(requests=4, max_new=4)
    assert baseline.hostbench_series(result) == \
        jax_baseline.hostbench_series(result)
    for name in ("host_us_per_token", "device_steps_per_token",
                 "prefix_hit_ratio", "device_calls", "wall_s"):
        assert baseline.default_band(name) == jax_baseline.default_band(name)
    assert baseline.FINGERPRINT_VERSION == jax_baseline.FINGERPRINT_VERSION
