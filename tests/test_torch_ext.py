# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The kernel build's bookkeeping (ops/_ext.py), on the CPU without nvcc."""

import pytest

torch = pytest.importorskip("torch")

from container_engine_accelerators_tpu_torch.ops import _ext  # noqa: E402


@pytest.mark.parametrize("edited", ["kern.cu", "common.cuh"])
def test_library_name_follows_the_source_and_every_shared_header(
        tmp_path, monkeypatch, edited):
    """An edit of the source or of a header it includes names a new
    library, so a kept ``.torch_ext/`` never serves a stale build."""
    monkeypatch.setattr(_ext, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _ext._library_path("kern")
    assert _ext._library_path("kern") == first
    assert first.parent == _ext.BUILD_DIR
    (tmp_path / edited).write_text((tmp_path / edited).read_text() + "// v2\n")
    assert _ext._library_path("kern") != first


def test_port_sources_include_the_hashed_hopper_header():
    assert (_ext.CSRC / "sm90.cuh").exists()
    assert '#include "sm90.cuh"' in (_ext.CSRC / "flash_fwd.cu").read_text()


def test_a_build_with_extra_defines_is_a_library_of_its_own(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(_ext, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text("// kernel\n")
    plain = _ext._library_path("kern")
    instrumented = _ext._library_path("kern", ("KERN_PHASE_CLOCKS",))
    assert instrumented != plain
    assert instrumented == _ext._library_path("kern", ("KERN_PHASE_CLOCKS",))
