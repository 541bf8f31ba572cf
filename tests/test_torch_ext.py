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


def test_flash_bwd_builds_a_phase_clock_library_of_its_own(monkeypatch):
    """``flash_bwd_dq``/``flash_bwd_dkv`` take ``defines`` as
    ``flash_fwd`` does, and the instrumented backward is its own library
    (the source has a FLASH_BWD_PHASE_CLOCKS build)."""
    from container_engine_accelerators_tpu_torch.ops import flash_phases

    defines = flash_phases.BWD_DEFINES
    assert "#ifdef FLASH_BWD_PHASE_CLOCKS" in (
        _ext.CSRC / "flash_bwd.cu").read_text()
    assert _ext._library_path("flash_bwd", defines) != \
        _ext._library_path("flash_bwd")
    loaded = []

    def load(name, defines=()):
        loaded.append((name, defines))
        raise LookupError("no nvcc here")

    monkeypatch.setattr(_ext, "load", load)
    monkeypatch.setattr(_ext, "_check", lambda *a: None)
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 8, 32, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 8)
    kw = dict(causal=True, sm_scale=0.1, q_base=0, k_base=0, kv_len=8,
              defines=defines)
    with pytest.raises(LookupError):
        _ext.flash_bwd_dq(q, k, k, q, rows, rows, q, **kw)
    with pytest.raises(LookupError):
        _ext.flash_bwd_dkv(q, k, k, q, rows, rows, k, k, **kw)
    assert loaded == [("flash_bwd", defines)] * 2


TILE_WALK_SHAPES = [
    # (Sq, Sk, group, causal, q_base, k_base, kv_len)
    (2048, 2048, 4, True, 0, 0, None),
    (300, 700, 4, True, 400, 0, None),
    (129, 255, 8, True, 0, 0, None),
    (200, 300, 4, True, 0, 0, 50),
    (200, 200, 2, True, 0, 150, None),
    (65, 191, 1, False, 0, 0, 150),
    (512, 2048, 4, True, 1536, 0, None),
]


def _tiles_with_a_visible_pair(shape, rows, keys):
    """(rows-row q tile, keys-key tile) pairs of one head that hold a
    visible (query, key) pair, counted over ``attention._visible``."""
    from container_engine_accelerators_tpu_torch.ops import attention

    seq_q, seq_k, _, causal, q_base, k_base, kv_len = shape
    vis = attention._visible(seq_q, seq_k, causal, q_base, k_base, kv_len,
                             "cpu").expand(seq_q, seq_k)
    return sum(
        bool(vis[q0:q0 + rows, k0:k0 + keys].any())
        for k0 in range(0, seq_k, keys)
        for q0 in range(0, seq_q, rows)
    )


@pytest.mark.parametrize("shape", TILE_WALK_SHAPES)
def test_dkv_tiles_visited_are_the_tiles_with_a_visible_pair(shape):
    """The dk/dv kernel's walk (key blocks x GQA heads x q tiles from the
    causal first tile) visits exactly the (128-key block, 64-row q tile)
    pairs that hold a visible (query, key) pair, for each q head."""
    from container_engine_accelerators_tpu_torch.ops import flash_phases as fp

    seq_q, seq_k, group, causal, q_base, k_base, kv_len = shape
    brute = _tiles_with_a_visible_pair(shape, fp.DKV_Q_TILE, fp.DKV_KEYS)
    assert fp.dkv_tiles_visited(seq_q, seq_k, group, causal, q_base, k_base,
                                kv_len) == brute * group


@pytest.mark.parametrize("shape", TILE_WALK_SHAPES)
def test_dq_tiles_visited_are_the_tiles_with_a_visible_pair(shape):
    """The dq kernel's walk (K/V tiles from the first up to the causal
    diagonal of each 128-row block's last real row) visits exactly the
    (128-row block, 64-key tile) pairs that hold a visible pair."""
    from container_engine_accelerators_tpu_torch.ops import flash_phases as fp

    seq_q, seq_k, _, causal, q_base, k_base, kv_len = shape
    brute = _tiles_with_a_visible_pair(shape, fp.DQ_ROWS, fp.DQ_KEY_TILE)
    assert fp.dq_tiles_visited(seq_q, seq_k, causal, q_base, k_base,
                               kv_len) == brute
