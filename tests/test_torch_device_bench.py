# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's single-card qualification rows (``collectives/
device_bench.py``) on the CPU at tiny sizes, against the JAX package's.

Twins of ``tests/test_device_bench.py`` on the port (names, detail keys,
the n == k rule, per-shape degradation, the MFU accounting, the int8 and
decode rows, the overhead-dominated flags), then parity with the JAX
package on the same numpy inputs: the int8 chain bit for bit, the bf16
chain, one step of every HBM pattern (int8 exact, f32 and bf16 within
one unit in the last place of the dtype), the FLOP and parameter count,
the decode row's tokens against JAX ``generate``, the ``obs.collective``
registry, and the card table (``detect_generation``, ``TrainMetrics.
calibrate``). The kernels' plain versions run throughout: every tensor
lies on the CPU. The card's own checks are in ``tests/test_torch_cuda.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from container_engine_accelerators_tpu.collectives import (  # noqa: E402
    device_bench as jdb,
)
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.obs import (  # noqa: E402
    collective as jcollective,
)
from container_engine_accelerators_tpu_torch.collectives import (  # noqa: E402
    cards,
)
from container_engine_accelerators_tpu_torch.collectives import (  # noqa: E402
    device_bench as db,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    train_cli as ttrain_cli,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    collective as tcollective,
)
from container_engine_accelerators_tpu_torch.ops import stream  # noqa: E402

CPU = "cpu"
TINY = dict(vocab_size=128, d_model=64, n_layers=1, n_heads=4, n_kv_heads=2,
            d_ff=128, dtype="float32")
# Significand bits after the point: one unit in the last place of v is
# 2 ** (floor(log2 |v|) - bits).
MANTISSA_BITS = {torch.bfloat16: 7, torch.float32: 23}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
       torch.int8: jnp.int8}


def _tiny_cfg(max_seq_len):
    return ttf.TransformerConfig(**TINY, max_seq_len=max_seq_len)


# -- twins of tests/test_device_bench.py --------------------------------------


def test_matmul_sweep_reports_per_shape(monkeypatch):
    seconds = []
    median_run = db._median_run

    def recording(run, iters, repeats):
        seconds.append(median_run(run, iters, repeats))
        return seconds[-1]

    monkeypatch.setattr(db, "_median_run", recording)
    r = db.bench_matmul(sweep=((64, 128, 128, 4), (128, 128, 128, 4)),
                        repeats=1, device=CPU)
    assert r.name == "matmul_bf16" and r.unit == "TFLOP/s"
    assert set(r.detail["per_shape"]) == {"64x128x128", "128x128x128"}
    assert r.value == max(r.detail["per_shape"].values())
    # The per-shape values are rounded to 2 decimals, which a loaded CPU
    # can take to 0.0; the rates before rounding are positive.
    assert len(seconds) == 2 and all(s > 0 for s in seconds)
    assert r.peak == 0.0 and r.frac_of_peak == 0.0  # no card on the CPU


def test_matmul_chain_requires_square_kn():
    with pytest.raises(ValueError, match="n == k"):
        db.bench_matmul_shape(64, 128, 256, iters=2, device=CPU)
    with pytest.raises(ValueError, match="n == k"):
        db.bench_matmul_int8(m=64, k=128, n=256, iters=2, device=CPU)


def test_hbm_patterns_reported():
    r = db.bench_hbm_bandwidth(nbytes=1 << 16, iters=4, repeats=1,
                               device=CPU)
    assert r.name == "hbm_bandwidth"
    # detail values are rounded to 0.1 for display; allow that error
    assert r.value == pytest.approx(
        max(r.detail["rw_gbps"], r.detail["triad_gbps"]), abs=0.06
    )
    assert r.value > 0


def test_hbm_pattern_sweep_reports_every_pattern(monkeypatch):
    # The sweep's fixed 256 MiB size cut to 64 KiB for the CPU.
    monkeypatch.setattr(db, "PATTERN_SIZES", (("256M", 1 << 16),
                                              ("1G", None)))
    r = db.bench_hbm_pattern_sweep(nbytes=1 << 17, iters=3, repeats=1,
                                   device=CPU)
    assert r.name == "hbm_pattern_sweep" and r.unit == "GB/s"
    assert set(r.detail) == {f"{p}_{d}_{s}" for p in ("read", "copy")
                             for d in ("bf16", "f32", "i8")
                             for s in ("256M", "1G")}
    assert r.value == pytest.approx(max(r.detail.values()), abs=0.06)


def test_train_step_mfu_accounting():
    cfg = _tiny_cfg(32)
    r = db.bench_train_step_mfu(batch_size=2, steps=2, cfg=cfg, device=CPU)
    assert r.name == "train_step_mfu"
    assert r.detail["n_params"] > 0
    assert r.detail["tokens_per_s"] > 0
    # flops accounting: 6N + attention term, times tokens/s, equals value
    flops_per_tok = 6 * r.detail["n_params"] + 12 * 1 * 32 * 64
    assert r.value == pytest.approx(
        flops_per_tok * r.detail["tokens_per_s"] / 1e12, rel=0.05
    )


def test_matmul_int8_tiny():
    r = db.bench_matmul_int8(m=64, k=128, n=128, iters=4, repeats=1,
                             device=CPU)
    assert r.name == "matmul_int8" and r.unit == "TOPS"
    assert r.value > 0
    assert r.detail["shape"] == "64x128x128"
    assert r.detail["epilogue_ms"] > 0


def test_matmul_sweep_degrades_per_shape(monkeypatch):
    """One failing shape must not zero the headline metric."""
    calls = []

    def fake_shape(m, k, n, iters, repeats=3, device=None):
        calls.append((m, k, n))
        if m == 64:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory: fake")
        return 123.0

    monkeypatch.setattr(db, "bench_matmul_shape", fake_shape)
    r = db.bench_matmul(sweep=((64, 128, 128, 4), (32, 128, 128, 4)),
                        device=CPU)
    assert r.value == 123.0
    assert "error" in str(r.detail["per_shape"]["64x128x128"])
    assert calls == [(64, 128, 128), (32, 128, 128)]


def test_decode_throughput_tiny():
    cfg = _tiny_cfg(64)
    r = db.bench_decode_throughput(batch_size=2, prompt_len=8, steps=16,
                                   cfg=cfg, device=CPU)
    assert r.name == "decode_throughput"
    assert r.value > 0
    assert r.detail["batch"] == 2
    assert r.detail["ms_per_step"] > 0
    # Steps at positions 8..23 attend windows 16 then 32 (JAX's form).
    assert r.detail["segments"] == [[8, 16], [8, 32]]
    assert r.detail["window"] == 32
    r8 = db.bench_decode_throughput(batch_size=2, prompt_len=8, steps=16,
                                    cfg=cfg, quantize=True, device=CPU)
    assert r8.detail["quantize"] == "int8" and r8.value > 0
    # On the CPU the product is the plain version and the steps run
    # eagerly: no kernel launches, no graphs.
    assert r8.detail["int8_mm_launches"] == 0
    assert (r8.detail["graph_captures"], r8.detail["graph_replays"]) == (0, 0)
    full = db.bench_decode_throughput(batch_size=2, prompt_len=8, steps=16,
                                      cfg=cfg, use_window=False, device=CPU)
    assert full.detail["segments"] == [[16, 64]]


def test_flash_long_context_publishes_raw_and_overhead_flags(monkeypatch):
    """The row publishes the raw (unsubtracted) per-iter time and flags
    rounds where the dispatch overhead probe exceeds half the window."""
    monkeypatch.setattr(db, "_measure_dispatch_overhead",
                        lambda device, repeats=2: 1e6)
    r = db.bench_flash_long_context(seq=256, iters=1, device=CPU)
    d = r.detail
    assert d["fwd_ms_raw"] > 0 and d["fwd_bwd_ms_raw"] > 0
    assert d["fwd_overhead_dominated_rounds"] == 3
    assert d["fwd_bwd_overhead_dominated_rounds"] == 3
    assert d["suspect"] is True
    assert d["fwd_ms"] <= d["fwd_ms_raw"]
    # The CPU runs the plain versions: no kernel launched.
    assert (d["flash_fwd_launches"], d["flash_dq_launches"],
            d["flash_dkv_launches"]) == (0, 0, 0)


def test_rows_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        db.bench_matmul_shape(64, 128, 128, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        db.bench_hbm_bandwidth(nbytes=1 << 12, iters=1)


def test_serving_rows_read_the_engine_s_stats_keys():
    """The engine rows on the CPU: every stats() key they read exists
    under JAX's name, and the phase attribution adds up."""
    cfg = _tiny_cfg(512)
    r = db.bench_continuous_serving(n_requests=4, max_slots=2, chunk=4,
                                    max_new=8, cfg=cfg, versus_batcher=True,
                                    device=CPU)
    assert r.name == "continuous_serving_mixed"
    assert r.detail["device_calls"] > 0 and r.detail["tokens"] > 0
    assert 0 < r.detail["occupancy_frac"] <= 1
    assert r.detail["window_batcher_tok_per_s"] > 0
    s = db.bench_continuous_serving_shared_prefix(
        n_requests=4, max_slots=2, chunk=4, max_new=8, prefix_len=20,
        cfg=cfg, device=CPU)
    assert s.detail["prefix_hit_tokens"] > 0
    assert "paged_speedup_vs_dense" in s.detail
    c = db.bench_engine_chunk_step(max_slots=2, steps=4, window=32,
                                   prompt_len=16, cfg=cfg, device=CPU)
    assert c.detail["ms_per_step"] > 0
    sat = db.bench_continuous_serving_saturated(
        max_slots=2, chunk=4, rounds_per_worker=2, max_new=8, cfg=cfg,
        device=CPU)
    assert sat.detail["tokens"] == 2 * 2 * 8
    # How full the slots run depends on the host's scheduling of the
    # workers (1.0 on the card; lower on a loaded CPU).
    assert 0 < sat.detail["occupancy_frac"] <= 1


# -- parity with the JAX package ---------------------------------------------


def test_int8_chain_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 127, (64, 128), dtype=np.int8)
    b = rng.integers(-127, 127, (128, 128), dtype=np.int8)

    @jax.jit
    def jax_chain(acc, b):
        # JAX device_bench.bench_matmul_int8's step, three times.
        for i in range(3):
            out = jax.lax.dot_general(
                acc, b, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            acc = jax.lax.shift_right_arithmetic(
                out + jnp.int32(i), jnp.int32(7)
            ).astype(jnp.int8)
        return acc

    want = np.asarray(jax_chain(jnp.asarray(a), jnp.asarray(b)))
    # b column-major, as the row holds it.
    ta, tb = torch.from_numpy(a), torch.from_numpy(b.T.copy()).t()
    out32 = torch.empty(64, 128, dtype=torch.int32)
    acc = torch.empty_like(ta)
    src = ta
    for i in range(3):
        src = db.int8_chain_step(src, tb, i, out32, acc)
    assert src.dtype == torch.int8
    np.testing.assert_array_equal(src.numpy(), want)
    assert np.abs(want.astype(np.int32)).max() > 0  # not a trivial chain


def test_bf16_chain_matches_jax():
    """Three chained 64×128×128 products: both round each product to
    bf16 (relative step 2^-8) after an f32 sum in another order; after
    three steps the relative L2 gap stays under 1e-2."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((64, 128)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((128, 128)) / np.sqrt(128)).astype(np.float32)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    jb = jnp.asarray(b).astype(jnp.bfloat16)
    acc = ja
    for _ in range(3):
        acc = jnp.dot(acc, jb, preferred_element_type=jnp.bfloat16)
    want = np.asarray(acc.astype(jnp.float32))
    got = db.bf16_matmul_chain(torch.from_numpy(a).to(torch.bfloat16),
                               torch.from_numpy(b).to(torch.bfloat16),
                               3).float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel


def _ulp(v, dtype):
    """One unit in the last place of |v| in ``dtype`` (float64 numpy)."""
    bits = MANTISSA_BITS[dtype]
    tiny = np.finfo(np.float32).tiny
    mag = np.maximum(np.abs(v), tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - bits)


def _assert_within_one_ulp(got, want, dtype):
    """int8: equal; float: |got - want| <= one ulp of the larger."""
    got = got.float().numpy().astype(np.float64) if dtype != torch.int8 \
        else got.numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)).astype(
        np.float64) if dtype != torch.int8 else np.asarray(want)
    if dtype == torch.int8:
        np.testing.assert_array_equal(got, want)
        return
    ulp = _ulp(np.maximum(np.abs(got), np.abs(want)), dtype)
    worst = float((np.abs(got - want) / ulp).max())
    assert worst <= 1.0, worst


def _buffer(dtype, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return rng.integers(-127, 127, n, dtype=np.int8)
    return rng.standard_normal(n).astype(np.float32)


def _pair(arr, dtype):
    """The same values as a port tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(arr).to(dtype)
    j = jnp.asarray(arr).astype(JNP[dtype])
    return t, j


STEP = 5  # the loop index i of the step compared


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rw_step_matches_jax(dtype):
    t, j = _pair(_buffer(dtype), dtype)
    jd = JNP[dtype]
    want = jax.jit(lambda v, i: v + i.astype(jd) * jnp.asarray(1e-9, jd))(
        j, jnp.int32(STEP))
    s = db.step_scales(STEP + 1, dtype)[STEP]
    _assert_within_one_ulp(db.rw_step(t.clone(), s), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_triad_step_matches_jax(dtype):
    """JAX rounds each operation to the dtype; the port's triad (the
    kernel's plain version on the CPU) computes in f32 and rounds once."""
    (tx, jx), (ty, jy), (tz, jz) = (_pair(_buffer(dtype, seed=s), dtype)
                                    for s in (0, 1, 2))
    jd = JNP[dtype]

    @jax.jit
    def jax_step(i, x, y, z):
        return (
            x
            + y * (i.astype(jd) * jnp.asarray(1e-9, jd))
            + z * jnp.asarray(1e-9, jd)
        )

    want = jax_step(jnp.int32(STEP), jx, jy, jz)
    s = db.step_scales(STEP + 1, dtype)[STEP]
    eps = db.step_eps(dtype)
    out = torch.empty_like(tz)
    _assert_within_one_ulp(stream.triad(tx, ty, tz, s, eps, out), want,
                           dtype)
    # In place, as the row runs it.
    _assert_within_one_ulp(stream.triad(tx, ty, tz, s, eps, out=tz), want,
                           dtype)


def _jax_read_step(i, acc, x):
    # JAX device_bench.bench_hbm_pattern_sweep's read step.
    return acc + jnp.sum(jnp.abs(
        x.astype(jnp.float32) + i.astype(jnp.float32) * 1e-9
    ))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_read_step_matches_jax(dtype):
    """At i = 0 on values every dtype holds exactly (multiples of 2^-6
    within ±2, or int8), every partial sum is exact in f32, so the two
    orders of summation agree exactly."""
    arr = _buffer(dtype)
    if dtype != torch.int8:
        arr = np.clip(np.round(arr * 64) / 64, -2, 2).astype(np.float32)
    t, j = _pair(arr, dtype)
    want = jax.jit(_jax_read_step)(jnp.int32(0), jnp.float32(1.5), j)
    acc = torch.full((1,), 1.5)
    got = stream.stream_read(t, acc, db.read_bias(0))
    assert got is acc
    assert float(got[0]) == float(want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_read_step_with_its_addend_matches_jax(dtype):
    """At i = 7 the addend 7e-9 rounds each |x + b| in f32, and the two
    sums run in other orders: within 4096 (the count) × 2^-24 of the
    total."""
    t, j = _pair(_buffer(dtype, seed=3), dtype)
    want = float(jax.jit(_jax_read_step)(jnp.int32(7), jnp.float32(0), j))
    acc = torch.zeros(1)
    got = float(stream.stream_read(t, acc, db.read_bias(7))[0])
    assert got == pytest.approx(want, rel=4096 * 2.0 ** -24)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_copy_step_matches_jax(dtype):
    tx, jx = _pair(_buffer(dtype, seed=4), dtype)
    tz, jz = _pair(_buffer(dtype, seed=5), dtype)
    jd = JNP[dtype]

    @jax.jit
    def jax_step(i, z, x):
        # JAX device_bench.bench_hbm_pattern_sweep's copy step.
        if jd == jnp.int8:
            return x + i.astype(jnp.int8) + z[:1]
        return x * (
            jnp.asarray(1, jd) + i.astype(jd) * jnp.asarray(1e-9, jd)
        ) + z[:1] * jnp.asarray(1e-9, jd)

    for i in (STEP, 300):  # 300 wraps in int8; 1 + 3e-7 is not 1 in f32
        want = jax_step(jnp.int32(i), jz, jx)
        scales = None if dtype == torch.int8 else \
            db.copy_scales(i + 1, dtype)
        eps = None if dtype == torch.int8 else db.step_eps(dtype)
        dst = torch.empty_like(tx)
        got = db.copy_step(tx, tz, i, scales, eps, dst)
        assert got is dst
        _assert_within_one_ulp(got, want, dtype)


def _assert_rounded_f32_sum(got, exact, magnitude, dtype):
    """``got`` against the exact (f64) value of a short f32 expression:
    its f32 evaluation errs by at most 2 × 2^-24 of the terms' summed
    magnitude, then one rounding to the dtype by one ulp of the result."""
    got = got.double().numpy()
    bound = _ulp(np.maximum(np.abs(got), np.abs(exact)), dtype) \
        + 2 * 2.0 ** -24 * magnitude
    assert (np.abs(got - exact) <= bound).all(), \
        float((np.abs(got - exact) / bound).max())


def test_step_formulas_at_constants_that_move_every_term():
    """JAX's constants (1e-9) leave the small terms below a bf16 step;
    here every term moves the result: the triad, the read and the copy
    against numpy in f64 (the read: f32 sums in another order, within
    the count × 2^-24)."""
    rng = np.random.default_rng(7)
    x, y, z = (rng.standard_normal(1000).astype(np.float32)
               for _ in range(3))
    for dtype in (torch.bfloat16, torch.float32):
        tx, ty, tz = (torch.from_numpy(a).to(dtype) for a in (x, y, z))
        fx, fy, fz = (t.double().numpy() for t in (tx, ty, tz))
        got = stream.triad(tx, ty, tz, 0.375, -0.25, torch.empty_like(tx))
        _assert_rounded_f32_sum(
            got, fx + fy * 0.375 - fz * 0.25,
            np.abs(fx) + np.abs(fy * 0.375) + np.abs(fz * 0.25), dtype)
        acc = torch.full((1,), 2.0)
        total = float(stream.stream_read(tx, acc, 0.125)[0])
        assert total == pytest.approx(2.0 + np.abs(fx + 0.125).sum(),
                                      rel=1000 * 2.0 ** -24)
        scales = [0.0, 1.5]
        z0 = float(tz[0]) * 0.5
        got = db.copy_step(tx, tz, 1, scales, 0.5, torch.empty_like(tx))
        _assert_rounded_f32_sum(got, fx * 1.5 + z0,
                                np.abs(fx * 1.5) + abs(z0), dtype)


def test_stream_copy_refuses_what_its_kernel_cannot_take():
    """Every program of the copy kernel reads src[0], so out may not hold
    it; the three buffers share dtype and length; int8's k is an int8."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"src\[0\]"):
        stream.stream_copy(x, x, x)
    with pytest.raises(ValueError, match="share dtype"):
        stream.stream_copy(x, x.float(), torch.empty_like(x))
    i8 = torch.zeros(64, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 value"):
        stream.stream_copy(i8, i8, torch.empty_like(i8), k=128)
    out = torch.empty_like(i8)
    assert stream.stream_copy(i8 + 120, i8 + 20, out, k=-3) is out
    assert (out == 137 - 256).all()  # 120 + 20 - 3 = 137, wrapped


def test_flops_and_params_equal_jax_s():
    cfg_j = jtf.TransformerConfig(**TINY, max_seq_len=32)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = _tiny_cfg(32)
    model = weights.params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                                    device=CPU)
    assert db._transformer_flops_per_token(model, cfg_t) == \
        jdb._transformer_flops_per_token(params, cfg_j)


@pytest.mark.parametrize("use_window", [True, False])
def test_decode_row_tokens_equal_jax_generate(monkeypatch, use_window):
    """The tokens bench_decode_throughput's timed runs decode (its prompt,
    drawn on the device, and every run's tokens, recorded through
    ``decode_runner``) equal JAX ``generate``'s greedy tokens on the same
    weights."""
    cfg_j = jtf.TransformerConfig(**{**TINY, "n_layers": 2},
                                  max_seq_len=64)
    cfg_t = ttf.TransformerConfig(**{**TINY, "n_layers": 2}, max_seq_len=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    model = weights.params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                                    device=CPU)
    seen = []
    runner = db.decode_runner

    def recording(model, prompt, steps, use_window=True):
        run, windows, graphs = runner(model, prompt, steps, use_window)

        def recorded():
            out = run()
            seen.append((prompt.clone(), out.clone()))
            return out

        return recorded, windows, graphs

    monkeypatch.setattr(db, "decode_runner", recording)
    steps = 16
    r = db.bench_decode_throughput(batch_size=2, prompt_len=8, steps=steps,
                                   cfg=cfg_t, params=model, rounds=2,
                                   use_window=use_window)
    assert r.detail["window"] == (32 if use_window else 64)
    assert len(seen) == 3  # the warm run and two timed rounds
    prompt = seen[0][0].numpy()
    want = np.asarray(jtf.generate(params, jnp.asarray(prompt), cfg_j,
                                   max_new_tokens=steps + 1))[:, 8:]
    for p, toks in seen:
        np.testing.assert_array_equal(p.numpy(), prompt)
        np.testing.assert_array_equal(toks.numpy(), want)


def _host_free(text):
    return re.sub(r'host="[^"]*"', 'host=""', text)


def test_obs_collective_renders_jax_s_families():
    ident = {"host": "h0", "slice": "s0"}
    jobs = jcollective.configure(identity=dict(ident, host="jax-host"))
    tobs = tcollective.configure(identity=ident)
    try:
        for mod, result in ((jcollective, jdb.DeviceBenchResult),
                            (tcollective, db.DeviceBenchResult)):
            mod.record_device_bench("hbm_bandwidth", 3000.5, "GB/s",
                                    frac_of_peak=0.9)
            mod.record("all_reduce", 0.002, msg_bytes=1 << 20,
                       algbw_gbps=12.5, busbw_gbps=21.0)
            result("matmul_bf16", 700.25, "TFLOP/s", 989.0, 0.708)
        jtext = jobs.registry.render().decode()
        ttext = tobs.registry.render().decode()
    finally:
        jcollective.configure(enabled=False)
        tcollective.configure(enabled=False)
    assert "tpu_device_bench_frac_of_peak" in ttext
    assert 'name="matmul_bf16"' in ttext
    assert _host_free(ttext) == _host_free(jtext)
    assert 'host="h0"' in ttext and 'slice="s0"' in ttext


def test_obs_collective_is_a_no_op_until_configured():
    assert tcollective.get() is None and not tcollective.enabled()
    tcollective.record("all_reduce", 0.1)
    tcollective.record_device_bench("x", 1.0, "GB/s")
    db.DeviceBenchResult("x", 1.0, "GB/s", 0.0, 0.0)


def test_to_json_keys_equal_jax_s():
    port = db.DeviceBenchResult("x", 1.0, "GB/s", 2.0, 0.5, {"a": 1})
    ref = jdb.DeviceBenchResult("x", 1.0, "GB/s", 2.0, 0.5, {"a": 1})
    assert port.to_json() == ref.to_json()


def test_public_names_equal_jax_s():
    def public(mod):
        return {n for n in dir(mod) if n.startswith("bench_")} | {
            "DeviceBenchResult", "detect_generation",
            "DEFAULT_MATMUL_SWEEP"}

    assert public(jdb) <= set(dir(db))
    assert {n for n in dir(db) if n.startswith("bench_")} == \
        {n for n in dir(jdb) if n.startswith("bench_")}
    assert db.DEFAULT_MATMUL_SWEEP == jdb.DEFAULT_MATMUL_SWEEP
    cfg_j, cfg_t = jdb._bench_cfg(), db._bench_cfg()
    for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "dtype"):
        assert getattr(cfg_t, field) == getattr(cfg_j, field), field


# -- the card table -----------------------------------------------------------


def test_detect_generation_reads_the_card_table(monkeypatch):
    assert db.detect_generation("cpu") is None
    if not torch.cuda.is_available():
        assert db.detect_generation() is None
    names = {}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: names["now"])
    names["now"] = "NVIDIA H100 80GB HBM3"
    card = db.detect_generation(torch.device("cuda", 0))
    assert card is cards.H100_SXM
    assert (card.bf16_tflops, card.int8_tops, card.hbm_gbps,
            card.hbm_gib) == (989.0, 1979.0, 3350.0, 80.0)
    names["now"] = "NVIDIA A100-SXM4-80GB"
    assert db.detect_generation(torch.device("cuda", 0)) is None


def test_train_metrics_calibrate_takes_the_table_s_peak(monkeypatch):
    m = ttrain_cli.TrainMetrics(1000, "tok")
    state = (torch.nn.Linear(10, 10),)
    m.calibrate(state, torch.device("cpu"))
    assert m._peak_flops == 0.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    m.calibrate(state, torch.device("cuda", 0))
    assert m._peak_flops == cards.H100_SXM.bf16_tflops * 1e12
