# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Single-card microbenchmarks: matmul, HBM bandwidth, serving, train MFU.

Port of ``container_engine_accelerators_tpu/collectives/device_bench.py``
on one GPU, with its functions, defaults and ``DeviceBenchResult``:
node qualification measures the card against the nominal peaks of
``collectives/cards.py``. Every ``bench_*`` runs on ``cuda`` unless the
caller passes ``device="cpu"`` (the tests do, at tiny sizes); with no GPU
and no such request it raises. No row moves to another device on its
own, and a kernel that fails to build or launch raises; the per-shape and
per-point degradation of ``bench_matmul``, ``bench_hbm_pattern_sweep``,
``bench_decode_sweep`` and ``bench_decode_window_benefit`` is the JAX
package's.

Timing: JAX chains K data-dependent iterations in one jitted
``fori_loop`` and stops the clock after a host fetch. PyTorch runs
eagerly, so here a run is K launches of the step on the stream (or K
replays of captured decode steps), each reading what the last one
wrote, and the clock stops after ``.item()`` of a scalar of the result,
the hard sync; ``_median_run`` takes the median over ``repeats`` runs
and divides by K. The dispatch-overhead protocol is JAX's: a trivial
kernel and a fetch, measured per round, subtracted, with the same floors
and ``suspect`` flags. On a local card it reads tens of microseconds.

What each row launches, and what its counts credit (eager PyTorch fuses
nothing, where XLA fused each step into one program):
  * bf16 matmul: one ``torch.mm`` a step into one of two output buffers
    in turn, 2·m·k·n FLOPs;
  * int8 matmul: ``torch._int_mm`` (int8 × int8 → int32; CUDA needs
    m > 16 and k, n multiples of 8; B is held column-major), then ``+ i``, ``>> 7`` and the
    wrapping cast to int8 as three passes over the int32 product, which
    XLA fused: credited 2·m·k·n operations, with the three passes timed
    alone in ``detail``;
  * HBM rw: one in-place ``add_`` a step, 2 × nbytes; triad:
    ``ops.stream.triad``, one pass, 4 × nbytes; read:
    ``ops.stream.stream_read``, one pass, 1 × nbytes; copy:
    ``ops.stream.stream_copy``, one pass into one of two outputs in
    turn, 2 × nbytes;
  * flash long context: the flash forward, and dq and dk/dv, kernels
    credited with JAX's FLOPs; the carry's elementwise ops are not.
"""

import dataclasses
import time

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.collectives import cards
from container_engine_accelerators_tpu_torch.models import (
    quantization,
    serving_graphs,
)
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.obs import (
    collective as obs_collective,
)
from container_engine_accelerators_tpu_torch.ops import (
    attention,
    int8_matmul,
    stream,
)


@dataclasses.dataclass
class DeviceBenchResult:
    name: str
    value: float
    unit: str
    peak: float           # nominal hardware ceiling (0 = unknown)
    frac_of_peak: float   # 0 when peak unknown
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # Mirror every qualification number onto the host/slice-tagged
        # fleet gauges — free no-op until obs.collective is configured.
        obs_collective.record_device_bench(
            self.name, self.value, self.unit,
            frac_of_peak=self.frac_of_peak,
        )

    def to_json(self):
        return dataclasses.asdict(self)


def detect_generation(device=None):
    """The card table's entry for ``device`` (default: CUDA device 0 when
    there is one): None on the CPU and on a card the table lacks."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return cards.CARDS.get(torch.cuda.get_device_name(device))


def _device(device):
    """The device a row runs on: ``cuda`` unless the caller asks for the
    CPU (``transformer.resolve_device``: raises without a GPU)."""
    return tf.resolve_device("cuda" if device is None else device)


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _normal(shape, dtype, device, seed, scale=1.0):
    """Standard normal values drawn in f32, scaled, cast to ``dtype``."""
    x = torch.randn(shape, generator=_generator(device, seed), device=device)
    return x.mul_(scale).to(dtype)


def _int8(shape, device, seed):
    return torch.randint(-127, 127, shape, generator=_generator(device, seed),
                         device=device, dtype=torch.int8)


def _median_run(run, iters, repeats):
    """Median seconds per iteration of ``run`` (``iters`` chained steps,
    returning a device scalar whose fetch ends the run)."""
    float(run())  # build + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(run())  # host fetch = hard synchronization
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / iters


def bf16_matmul_chain(a, b, iters, outs=None):
    """``iters`` chained products acc ← acc @ b from acc = a, each into one
    of the two buffers ``outs`` (made when None) in turn → the last."""
    if outs is None:
        outs = (torch.empty_like(a), torch.empty_like(a))
    acc = a
    for i in range(iters):
        acc = torch.mm(acc, b, out=outs[i % 2])
    return acc


def bench_matmul_shape(m, k, n, iters, repeats=3, device=None):
    """One shape: chained bf16 matmul, B scaled 1/sqrt(k) for stability.

    The chain needs n == k (output feeds back as input)."""
    if n != k:
        raise ValueError(f"chained matmul needs n == k, got {k} vs {n}")
    device = _device(device)
    a = _normal((m, k), torch.bfloat16, device, 0, scale=0.1)
    b = _normal((k, n), torch.bfloat16, device, 1, scale=1.0 / np.sqrt(k))
    outs = (torch.empty_like(a), torch.empty_like(a))

    def run():
        return bf16_matmul_chain(a, b, iters, outs)[..., :1].sum()

    sec_per_iter = _median_run(run, iters, repeats)
    return 2.0 * m * k * n / sec_per_iter / 1e12


DEFAULT_MATMUL_SWEEP = (
    # (m, k, n, iters), the JAX package's sweep: highest-intensity shape
    # first (A 1 GiB + B 2 GiB resident, and two 1 GiB output buffers).
    (16384, 32768, 32768, 48),
    (8192, 16384, 16384, 128),
)


def bench_matmul(sweep=DEFAULT_MATMUL_SWEEP, device=None, repeats=3):
    """bf16 tensor-core throughput: best over the shape sweep.

    Per-shape failures (e.g. an out-of-memory error when the lead shape's
    2 GiB operand doesn't fit next to another tenant's buffers) are
    recorded and skipped — one bad shape must not zero the recorded
    metric."""
    device = _device(device)
    per_shape = {}
    for m, k, n, iters in sweep:
        try:
            per_shape[f"{m}x{k}x{n}"] = round(
                bench_matmul_shape(m, k, n, iters, repeats, device=device), 2
            )
        except Exception as e:  # noqa: BLE001 - degrade per shape
            per_shape[f"{m}x{k}x{n}"] = f"error: {str(e)[:120]}"
    values = [v for v in per_shape.values() if isinstance(v, float)]
    if not values:
        raise RuntimeError(f"every matmul shape failed: {per_shape}")
    best = max(values)
    gen = detect_generation(device)
    peak = gen.bf16_tflops if gen else 0.0
    return DeviceBenchResult(
        "matmul_bf16", best, "TFLOP/s", peak,
        best / peak if peak else 0.0, {"per_shape": per_shape},
    )


def int8_chain_step(acc, b, i, out32, out8):
    """One step of the int8 chain, JAX's: the int32 product acc @ b, + i,
    an arithmetic shift right by 7, a wrapping cast to int8 (only
    throughput is measured). ``out32`` holds the product, ``out8``
    receives the step's result (it may be ``acc``)."""
    torch._int_mm(acc, b, out=out32)
    return _int8_epilogue(out32, i, out8)


def _int8_epilogue(out32, i, out8):
    out32.add_(i)
    out32.bitwise_right_shift_(7)
    return out8.copy_(out32)


def bench_matmul_int8(m=16384, k=32768, n=32768, iters=48, repeats=2,
                      device=None):
    """int8 tensor-core throughput (TOPS): chained int8 matmul with int32
    accumulation; the chain feedback shifts the accumulator back to int8.
    ``detail["epilogue_ms"]`` is the time of the ``+ i``, shift and cast
    passes per step, timed alone on the same int32 product (XLA fuses them
    into the matmul's output; here they are three passes over it)."""
    if n != k:
        raise ValueError(f"chained matmul needs n == k, got {k} vs {n}")
    device = _device(device)
    a = _int8((m, k), device, 0)
    # B column-major (a transposed view of an (n, k) buffer): the layout
    # cuBLASLt's int8 tensor-core kernels take (A row-major, B
    # column-major); with a row-major B the chain ran about 6x slower on
    # an H100 (PERF.md).
    b = _int8((n, k), device, 1).t()
    out32 = torch.empty(m, n, dtype=torch.int32, device=device)
    acc = torch.empty_like(a)

    def run():
        src = a
        for i in range(iters):
            src = int8_chain_step(src, b, i, out32, acc)
        return src[:1].to(torch.int32).sum()

    def run_epilogue():
        for i in range(iters):
            _int8_epilogue(out32, i, acc)
        return acc[:1].to(torch.int32).sum()

    sec_per_iter = _median_run(run, iters, repeats)
    epilogue_s = _median_run(run_epilogue, iters, repeats)
    tops = 2.0 * m * k * n / sec_per_iter / 1e12
    gen = detect_generation(device)
    peak = gen.int8_tops if gen else 0.0
    return DeviceBenchResult(
        "matmul_int8", tops, "TOPS", peak,
        tops / peak if peak else 0.0,
        {"shape": f"{m}x{k}x{n}",
         "ms_per_step": round(sec_per_iter * 1e3, 4),
         "epilogue_ms": round(epilogue_s * 1e3, 4),
         "tops_without_epilogue": round(
             2.0 * m * k * n / max(sec_per_iter - epilogue_s, 1e-12) / 1e12,
             2)},
    )


def step_eps(dtype):
    """JAX's ``asarray(1e-9, dtype)``: 1e-9 rounded to ``dtype``."""
    return float(torch.tensor(1e-9, dtype=dtype))


def step_scales(iters, dtype):
    """JAX's per-step scalar i·1e-9 for i < ``iters``, each factor and the
    product rounded to ``dtype`` as JAX's ``i.astype(dtype) *
    asarray(1e-9, dtype)`` is."""
    idx = torch.arange(iters, dtype=torch.float32).to(dtype)
    return (idx * torch.tensor(1e-9, dtype=dtype)).tolist()


def rw_step(v, s):
    """The rw pattern's step, in place: v + s (JAX: v + i·1e-9)."""
    return v.add_(s)


def bench_hbm_bandwidth(nbytes=1 << 30, dtype=torch.bfloat16, iters=2048,
                        device=None, repeats=3):
    """Streaming bandwidth, best of two patterns:

    * rw — each iteration reads and writes the full buffer once, in place
      (v + f(i); the index-dependent addend is JAX's).
    * triad — z' = x + y·s(i) + z·ε (``ops.stream.triad``, one pass): 3
      reads + 1 write per iteration.

    Buffers are random."""
    device = _device(device)
    elems = nbytes // torch.empty((), dtype=dtype).element_size()
    x = _normal((elems,), dtype, device, 0)
    scales = step_scales(iters, dtype)

    def run_rw():
        for i in range(iters):
            rw_step(x, scales[i])
        return x[:1].float().sum()

    sec = _median_run(run_rw, iters, repeats)
    rw_gbps = 2 * nbytes / sec / 1e9

    y = _normal((elems,), dtype, device, 1)
    z = torch.zeros((elems,), dtype=dtype, device=device)
    eps = step_eps(dtype)

    def run_triad():
        for i in range(iters):
            stream.triad(x, y, z, scales[i], eps, out=z)
        return z[:1].float().sum()

    sec = _median_run(run_triad, iters, repeats)
    triad_gbps = 4 * nbytes / sec / 1e9

    best = max(rw_gbps, triad_gbps)
    gen = detect_generation(device)
    peak = gen.hbm_gbps if gen else 0.0
    return DeviceBenchResult(
        "hbm_bandwidth", best, "GB/s", peak,
        best / peak if peak else 0.0,
        {"rw_gbps": round(rw_gbps, 1), "triad_gbps": round(triad_gbps, 1)},
    )


def read_bias(i):
    """The read pattern's addend, JAX's ``i.astype(float32) * 1e-9``."""
    return float(np.float32(i) * np.float32(1e-9))


def int8_index(i):
    """JAX's ``i.astype(int8)``: i wrapped into [-128, 127]."""
    return (i + 128) % 256 - 128


def copy_step(x, src, i, scales, eps, dst):
    """The copy pattern's step into ``dst``, JAX's, in one pass
    (``ops.stream.stream_copy``): x·(1 + i·1e-9) + src[:1]·ε in x's float
    dtype (``scales`` JAX's 1 + i·1e-9 in that dtype, by step, from
    ``copy_scales``); for int8, x + i + src[:1], wrapping."""
    if x.dtype == torch.int8:
        return stream.stream_copy(x, src, dst, k=int8_index(i))
    return stream.stream_copy(x, src, dst, c=float(scales[i]), eps=eps)


def copy_scales(iters, dtype):
    """JAX's per-step copy factor 1 + i·1e-9 in ``dtype`` (each operation
    rounded to it), for i < ``iters``."""
    one = torch.ones((), dtype=dtype)
    idx = torch.arange(iters, dtype=torch.float32).to(dtype)
    return (one + idx * torch.tensor(1e-9, dtype=dtype)).tolist()


# The pattern sweep's buffer sizes: a fixed 256 MiB, and ``nbytes``.
PATTERN_SIZES = (("256M", 1 << 28), ("1G", None))


def bench_hbm_pattern_sweep(nbytes=1 << 30, iters=1024, repeats=3,
                            device=None):
    """HBM ceiling evidence: sweep the two patterns bench_hbm_bandwidth
    does NOT cover — read-only reduce (1 read, no write) and copy (1 read
    + 1 write) — across dtypes (bf16/f32/int8) and buffer sizes (256 MiB
    / 1 GiB). Together with bench_hbm_bandwidth's rw and triad rows this
    completes the pattern evidence.

    Every pattern carries an inter-iteration data dependency: the read
    adds into one f32 carry (``ops.stream.stream_read``: Σ |x + i·1e-9|,
    JAX's step, in one pass); the copy's output feeds one element back
    into the next iteration's value (``ops.stream.stream_copy``, JAX's
    step, in one pass). JAX's ``abs`` and ``i·1e-9`` keep XLA from
    hoisting a loop invariant; eager PyTorch hoists nothing, and the
    kernels keep them at no cost, so nothing of JAX's steps is dropped."""
    device = _device(device)
    sweep = {}
    best = 0.0
    for dtype_name, dtype in (("bf16", torch.bfloat16),
                              ("f32", torch.float32),
                              ("i8", torch.int8)):
        for size_name, size in PATTERN_SIZES:
            size = size or nbytes
            elems = size // torch.empty((), dtype=dtype).element_size()
            if dtype == torch.int8:
                x = _int8((elems,), device, 0)
            else:
                x = _normal((elems,), dtype, device, 0)
            acc = torch.zeros(1, dtype=torch.float32, device=device)
            outs = (torch.empty_like(x), torch.empty_like(x))
            scales = None if dtype == torch.int8 else \
                copy_scales(iters, dtype)
            eps = None if dtype == torch.int8 else step_eps(dtype)

            def run_read(x=x, acc=acc):
                acc.zero_()
                for i in range(iters):
                    stream.stream_read(x, acc, read_bias(i))
                return acc

            def run_copy(x=x, outs=outs, scales=scales, eps=eps):
                src = x
                for i in range(iters):
                    src = copy_step(x, src, i, scales, eps, outs[i % 2])
                return src[:1].float().sum()

            for pat_name, fn, factor in (
                ("read", run_read, 1),
                ("copy", run_copy, 2),
            ):
                try:
                    sec = _median_run(fn, iters, repeats)
                    gbps = factor * size / sec / 1e9
                except Exception:  # noqa: BLE001 - sweep keeps going
                    continue
                sweep[f"{pat_name}_{dtype_name}_{size_name}"] = round(
                    gbps, 1
                )
                best = max(best, gbps)
    gen = detect_generation(device)
    peak = gen.hbm_gbps if gen else 0.0
    return DeviceBenchResult(
        "hbm_pattern_sweep", best, "GB/s", peak,
        best / peak if peak else 0.0, sweep,
    )


def _measure_dispatch_overhead(device, repeats=3):
    """Fixed dispatch+fetch cost of one call, measured with a trivial
    kernel and a fetch of one element — tens of microseconds on a local
    card. Subtracted by the model-level benches whose chains can't fully
    amortize it.

    Measured PER ROUND by those benches: a constant subtracted from
    measurements taken at a different moment biases the result when the
    overhead jitters."""
    x = torch.zeros((8, 8), device=device)
    float((x + 1)[0, 0])
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float((x + 1)[0, 0])
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _bench_cfg(max_seq_len=2048):
    return tf.TransformerConfig(
        vocab_size=32000,
        d_model=2048,
        n_layers=4,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        max_seq_len=max_seq_len,
        dtype="bfloat16",
    )


def _segments(windows):
    """[[steps, window], ...]: runs of equal windows, in order (JAX's
    ``greedy_decode_plan`` form)."""
    out = []
    for w in windows:
        if out and out[-1][1] == w:
            out[-1][0] += 1
        else:
            out.append([1, w])
    return out


def decode_runner(model, prompt, steps, use_window=True):
    """The decode row's device work on ``model`` for ``prompt`` (B, P) on
    its device: a prefill into a ``serving_graphs.DenseDecodeGraphs``
    cache (the prompt right-padded to its length bucket, as
    ``transformer.generate`` does), then ``run()``: ``steps`` greedy
    ``decoder.step`` calls (on CUDA each a replay of the step's graph for
    its (B, window)) → the (B, 1 + steps) tokens, the prefill's first.
    Each step attends the bucket of its position (``use_window``) or the
    whole context. Returns (run, windows, graphs), ``graphs`` the
    decoder's ``GraphSet`` (its ``captures`` and ``replays``). Rerunning
    writes the same K/V at the same positions, so runs need no fresh
    cache."""
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    S = cfg.max_seq_len
    if prompt_len + steps + 1 > S:
        raise ValueError(f"prompt ({prompt_len}) + steps ({steps}) + 1 "
                         f"exceeds max_seq_len ({S})")
    decoder = serving_graphs.DenseDecodeGraphs(model)
    bucket = tf._length_bucket(prompt_len, S)
    padded = torch.nn.functional.pad(prompt, (0, bucket - prompt_len))
    first, _ = tf.prefill(model, padded, true_len=prompt_len,
                          cache=decoder.cache(batch))
    windows = [tf._window_for(prompt_len + s + 1, S) if use_window else S
               for s in range(steps)]

    @torch.inference_mode()
    def run():
        tok, toks = first, [first]
        for s, w in enumerate(windows):
            tok = decoder.step(tok, prompt_len + s, window=w).argmax(dim=-1)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    return run, windows, decoder.graphs


def bench_decode_throughput(batch_size=8, prompt_len=128, steps=512,
                            cfg=None, quantize=False, rounds=3,
                            params=None, use_window=True, device=None):
    """Serving qualification: greedy decode tok/s on the bench model.

    ``decode_runner``'s ``steps`` decode steps, each the replay of a
    captured CUDA graph. The fixed dispatch+fetch cost is re-measured
    EVERY round and subtracted per round; the reported number is the
    median of the corrected rounds, with raw times in the detail.
    ``quantize`` benches weight-only int8 (``quantization.
    quantize_params``: every projection the hand-written ``int8_mm``
    kernel; ``detail["int8_mm_launches"]`` counts its launches, the
    eager prefill's and the 7 × layers each graph replay makes, beside
    the calls the graphs captured and their captures and replays);
    ``use_window`` exercises the bucketed
    attended-window cache read (the serving default — False measures the
    full-context read for comparison)."""
    device = params.device if params is not None else _device(device)
    cfg = cfg or _bench_cfg()
    counts0 = (int8_matmul.int8_mm_launches, int8_matmul.int8_mm_captured)
    if params is None:
        params = tf.init_params(cfg, device=device, seed=0)
        if quantize:
            quantization.quantize_params(params)
    prompt = torch.randint(0, cfg.vocab_size, (batch_size, prompt_len),
                           generator=_generator(device, 1), device=device)
    run, windows, graphs = decode_runner(params, prompt, steps, use_window)
    int(run()[0, -1])  # capture + warm
    corrected, raw, overheads = [], [], []
    for _ in range(rounds):
        overhead = _measure_dispatch_overhead(device, repeats=2)
        t0 = time.perf_counter()
        int(run()[0, -1])
        dt = time.perf_counter() - t0
        raw.append(dt)
        overheads.append(overhead)
        corrected.append(max(dt - overhead, 1e-9))
    sec_per_tok = float(np.median(corrected)) / steps
    detail = {
        "batch": batch_size,
        "ms_per_step": round(sec_per_tok * 1e3, 3),
        "window": windows[-1],
        "segments": _segments(windows),
        "raw_s": [round(t, 4) for t in raw],
        "dispatch_overhead_ms": [round(o * 1e3, 1) for o in overheads],
        "quantize": "int8" if quantize else "none",
    }
    if quantize:
        eager = int8_matmul.int8_mm_launches - counts0[0]
        detail["int8_mm_launches"] = \
            eager + 7 * cfg.n_layers * graphs.replays
        detail["int8_mm_captured"] = int8_matmul.int8_mm_captured - counts0[1]
        detail["graph_captures"] = graphs.captures
        detail["graph_replays"] = graphs.replays
    return DeviceBenchResult(
        "decode_throughput", batch_size / sec_per_tok, "tok/s", 0.0, 0.0,
        detail,
    )


def bench_decode_sweep(batches=(1, 8, 32), prompt_len=128, steps=256,
                       cfg=None, device=None):
    """Decode latency/throughput curve: tok/s + ms/step per batch size,
    so the serving story is a curve, not one point. Shares one params
    instance across batch sizes (each batch captures its own graphs)."""
    device = _device(device)
    cfg = cfg or _bench_cfg()
    params = tf.init_params(cfg, device=device, seed=0)
    out = {}
    for b in batches:
        try:
            r = bench_decode_throughput(
                batch_size=b, prompt_len=prompt_len, steps=steps, cfg=cfg,
                rounds=2, params=params,
            )
            out[f"batch{b}"] = {
                "tok_per_s": round(r.value),
                "ms_per_step": r.detail["ms_per_step"],
            }
        except Exception as e:  # noqa: BLE001 - per-point degradation
            out[f"batch{b}"] = f"error: {str(e)[:120]}"
    return out


def bench_prefill_throughput(batch_size=8, prompt_len=1024, cfg=None,
                             rounds=3, calls_per_round=8, device=None):
    """Prefill tok/s (single-pass batched forward through the flash
    kernel + cache write) — reported separately from decode so the
    latency/throughput split of serving is visible.

    Each round dispatches ``calls_per_round`` prefills back-to-back with
    ONE final sync, so the dispatch overhead is paid once and
    amortized."""
    device = _device(device)
    cfg = cfg or _bench_cfg()
    params = tf.init_params(cfg, device=device, seed=0)
    prompt = torch.randint(0, cfg.vocab_size, (batch_size, prompt_len),
                           generator=_generator(device, 1), device=device)

    def dispatch():
        nxt, _ = tf.prefill(params, prompt, true_len=prompt_len)
        return nxt

    int(dispatch()[0])  # build + warm
    corrected = []
    for _ in range(rounds):
        overhead = _measure_dispatch_overhead(device, repeats=2)
        t0 = time.perf_counter()
        for _ in range(calls_per_round - 1):
            dispatch()
        int(dispatch()[0])  # one sync for the chain
        corrected.append(
            max(time.perf_counter() - t0 - overhead, 1e-9)
            / calls_per_round
        )
    sec = float(np.median(corrected))
    tokens = batch_size * prompt_len
    # Sanity floor from the ACTUAL model size and card: a corrected time
    # implying more than nominal-peak FLOP/s means the overhead
    # subtraction went ill-conditioned — flag it.
    _, n_params = _transformer_flops_per_token(params, cfg)
    gen = detect_generation(device)
    floor = 2.0 * n_params * tokens / (gen.bf16_tflops * 1e12) if gen else 0.0
    return DeviceBenchResult(
        "prefill_throughput", tokens / sec, "tok/s", 0.0, 0.0,
        {"batch": batch_size, "prompt_len": prompt_len,
         "ms": round(sec * 1e3, 1),
         "suspect": bool(floor and sec < floor)},
    )


def _serving_device_numbers(delta, wall, overhead, max_slots):
    """Shared post-processing for the serving benches: one measurement
    protocol for both the mixed open-loop and saturated closed-loop rows.
    Returns (n_calls, device_s, suspect, occupancy): dispatch-corrected
    device seconds with the ill-conditioning guard (when the subtraction
    eats most of the wall the device number is noise), and the
    steps-weighted slot occupancy."""
    n_calls = delta["n_prefills"] + delta["n_chunks"]
    device_s = wall - n_calls * overhead
    suspect = device_s < 0.1 * wall
    occupancy = delta["occupied_steps"] / max(
        delta["steps_done"] * max_slots, 1
    )
    return n_calls, device_s, suspect, occupancy


def _stats_delta(cur, base):
    """The engine's numeric ``stats()`` moved between two reads (the
    per-class queue depths, a dict, are a snapshot, not a counter)."""
    return {k: cur[k] - base[k] for k in base
            if not isinstance(base[k], dict)}


def _concurrent_wall(gen_fn, cases):
    """Fan the case list out on one thread per request through
    ``gen_fn([prompt], n)``; returns wall seconds."""
    import threading

    results = [None] * len(cases)

    def run(i):
        prompt, n = cases[i]
        results[i] = gen_fn([prompt], n)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(cases))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    missing = sum(r is None for r in results)
    if missing:
        raise RuntimeError(f"{missing} of {len(cases)} requests failed")
    return wall


def bench_continuous_serving(n_requests=24, max_slots=8, chunk=64,
                             max_new=256, cfg=None, versus_batcher=False,
                             device=None):
    """Continuous-batching engine under MIXED-length concurrent load.

    ``n_requests`` concurrent requests with varied prompt lengths and
    generation budgets run through serve_cli.ContinuousEngine (dense).
    Two numbers come back:
      * wall tok/s — end-to-end, including the per-call dispatch cost
        (paid once per prefill admission and once per decode chunk);
      * device tok/s — wall minus (n_device_calls × measured dispatch
        overhead): the number comparable to the decode row, which
        subtracts the same overhead. On a local card the two converge.
    ``versus_batcher`` runs the same load through
    ``serve_cli.BatchingModel`` for the head-to-head."""
    from container_engine_accelerators_tpu_torch.models import serve_cli

    device = _device(device)
    cfg = cfg or _bench_cfg()
    model = serve_cli.Model(cfg, device=device)
    eng = serve_cli.ContinuousEngine(model, max_slots=max_slots, chunk=chunk)
    rng = np.random.RandomState(0)
    cases = [
        (
            rng.randint(0, cfg.vocab_size, rng.randint(8, 200)).tolist(),
            int(rng.choice([max_new // 4, max_new // 2, max_new])),
        )
        for _ in range(n_requests)
    ]
    try:
        # Warm the graphs (prefill buckets + chunk/window combos) so the
        # timed section measures serving, not captures.
        for prompt, n in cases[:4]:
            eng.generate([prompt], n)
        tokens = sum(n for _, n in cases)

        def one_repeat():
            """One timed pass over the case list; returns (wall,
            phase-delta dict, dispatch overhead measured around this
            repeat). The stats delta is captured IMMEDIATELY after the
            run so the bracketing overhead measurements' idle time never
            leaks into the phase attribution."""
            pre = _measure_dispatch_overhead(device, repeats=3)
            base = eng.stats()
            wall = _concurrent_wall(eng.generate, cases)
            cur = eng.stats()
            post = _measure_dispatch_overhead(device, repeats=3)
            # The MIN is subtracted (conservative: under-subtracting
            # makes device numbers read LOWER, never inflated by a
            # jitter spike).
            return wall, _stats_delta(cur, base), min(pre, post)

        # One untimed warmup repeat first: the mixed load's full set of
        # chunk/window/bucket graphs is captured here, not inside repeat
        # 1's wall.
        _concurrent_wall(eng.generate, cases)
        # Three timed repeats; the dispatch overhead is re-measured
        # around EVERY repeat, and >20% drift of its minima across the
        # run flags host contention.
        repeats = [one_repeat() for _ in range(3)]
        overheads = [oh for _, _, oh in repeats]
        contention_drift = (max(overheads) - min(overheads)) / max(
            min(overheads), 1e-9
        )
        walls = sorted(w for w, _, _ in repeats)
        wall_med, delta, overhead = sorted(
            repeats, key=lambda r: r[0]
        )[len(repeats) // 2]
        n_calls, device_s, suspect, occupancy = _serving_device_numbers(
            delta, wall_med, overhead, max_slots
        )
        suspect = suspect or contention_drift > 0.2
        # Wall attribution from the engine's per-phase timers: prefill
        # device calls + decode chunk calls + idle + (residual = host
        # loop).
        t_prefill = delta["t_prefill_s"]
        t_chunk = delta["t_chunk_s"]
        t_idle = delta["t_idle_s"]
        t_host = max(wall_med - t_prefill - t_chunk - t_idle, 0.0)
        measured = (t_prefill + t_chunk + t_idle) / wall_med
        # Occupancy-weighted decode rate: occupied_steps over the
        # overhead-corrected decode-call seconds.
        occ_steps = delta["occupied_steps"]
        chunk_device_s = t_chunk - delta["n_chunks"] * overhead
        detail = {
            "requests": n_requests,
            "tokens": tokens,
            "wall_s": round(wall_med, 2),
            "wall_s_min": round(walls[0], 2),
            "wall_s_max": round(walls[-1], 2),
            "wall_spread_pct": round(
                100 * (walls[-1] - walls[0]) / walls[0], 1
            ),
            "device_tok_per_s": (
                round(tokens / device_s) if not suspect else None
            ),
            "suspect": suspect,
            "contention_drift_pct": round(100 * contention_drift, 1),
            "device_calls": n_calls,
            "dispatch_overhead_ms": round(overhead * 1e3, 1),
            "phases": {
                "prefill_s": round(t_prefill, 2),
                "decode_chunks_s": round(t_chunk, 2),
                "idle_s": round(t_idle, 2),
                "host_loop_s": round(t_host, 2),
                "measured_frac": round(measured, 3),
            },
            "occupancy_frac": round(occupancy, 3),
            "occupancy_weighted_decode_tok_per_s": (
                round(occ_steps / chunk_device_s)
                if chunk_device_s > 0.05 * t_chunk and occ_steps else None
            ),
            "max_slots": max_slots,
            "chunk": chunk,
        }
    finally:
        eng.shutdown()
    if versus_batcher:
        # Same load through the identical-shape window coalescer.
        bm = serve_cli.BatchingModel(model, window_ms=5.0)
        try:
            for prompt, n in cases[:4]:
                bm.generate([prompt], n)
            bm_wall = _concurrent_wall(bm.generate, cases)
        finally:
            bm.shutdown()
        detail["window_batcher_tok_per_s"] = round(tokens / bm_wall)
        detail["engine_speedup_vs_batcher"] = round(bm_wall / wall_med, 2)
    return DeviceBenchResult(
        "continuous_serving_mixed", tokens / wall_med, "tok/s", 0.0, 0.0,
        detail,
    )


def bench_continuous_serving_shared_prefix(n_requests=24, max_slots=8,
                                           chunk=64, max_new=128,
                                           prefix_len=192, cfg=None,
                                           versus_dense=True, device=None):
    """Continuous serving under the SHARED-PREFIX workload: every request
    opens with the same system prompt. The paged engine's radix index
    serves those tokens from cache (no re-prefill); the dense engine
    re-prefills them per request. Reports wall tok/s, the hit-token
    counters, and (``versus_dense``) the dense twin's wall for the
    head-to-head. One model's weights serve both engines."""
    from container_engine_accelerators_tpu_torch.models import serve_cli

    device = _device(device)
    cfg = cfg or _bench_cfg()
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, cfg.vocab_size, prefix_len).tolist()
    cases = [
        (
            prefix + rng.randint(
                0, cfg.vocab_size, 1 + rng.randint(1, 24)
            ).tolist(),
            max_new,
        )
        for _ in range(n_requests)
    ]
    tokens = sum(n for _, n in cases)
    model = serve_cli.Model(cfg, device=device)

    def run_engine(kv_cache):
        eng = serve_cli.ContinuousEngine(
            model, max_slots=max_slots, chunk=chunk, kv_cache=kv_cache,
        )
        try:
            # Warm lap: captures + (paged) fills the radix cache, so the
            # timed lap measures steady-state serving.
            for prompt, n in cases[:4]:
                eng.generate([prompt], n)
            return _concurrent_wall(eng.generate, cases), eng.kv_stats()
        finally:
            eng.shutdown()

    wall, kvs = run_engine("paged")
    kvs = kvs or {}
    detail = {
        "requests": n_requests,
        "tokens": tokens,
        "prefix_len": prefix_len,
        "wall_s": round(wall, 2),
        "prefix_hit_tokens": kvs.get("prefix_hit_tokens", 0),
        "prefix_miss_tokens": kvs.get("prefix_miss_tokens", 0),
        "prefix_hit_ratio": kvs.get("prefix_hit_ratio", 0.0),
        "max_slots": max_slots,
        "chunk": chunk,
    }
    if versus_dense:
        dense_wall, _ = run_engine("dense")
        detail["dense_wall_s"] = round(dense_wall, 2)
        detail["paged_speedup_vs_dense"] = round(dense_wall / wall, 2)
    return DeviceBenchResult(
        "continuous_serving_shared_prefix", tokens / wall, "tok/s",
        0.0, 0.0, detail,
    )


def bench_engine_chunk_step(max_slots=8, steps=64, window=256,
                            prompt_len=128, cfg=None, device=None):
    """Per-step device cost of the ENGINE's decode path in isolation: the
    dense engine's own seams, ``_prefill`` (``transformer.
    prefill_into_slot``) into each slot and ``_chunk`` (its
    ``serving_graphs.DenseChunkGraphs``: ``steps`` replays of the
    captured step at ``window``); the engine's loop is not started."""
    from container_engine_accelerators_tpu_torch.models import serve_cli

    device = _device(device)
    cfg = cfg or _bench_cfg()
    model = serve_cli.Model(cfg, device=device)
    eng = serve_cli.ContinuousEngine(model, max_slots=max_slots,
                                     chunk=steps, start_loop=False)
    prompt = torch.randint(0, cfg.vocab_size, (max_slots, prompt_len),
                           generator=_generator(device, 1), device=device)
    for i in range(max_slots):
        eng._prefill(model.model, eng.cache, prompt[i:i + 1], prompt_len, i)
    tok = np.full((max_slots,), 5, np.int64)
    pos = np.full((max_slots,), prompt_len, np.int64)
    act = np.ones((max_slots,), bool)

    def one_call():
        return eng._chunk(tok, pos, act, steps=steps, window=window,
                          mask_writes=False)

    one_call().cpu()  # capture + warm
    # Overhead brackets the timed loop; the MIN is subtracted and the
    # result floored so an overhead spike can only make the row read
    # slower, never negative/inflated.
    pre = _measure_dispatch_overhead(device, repeats=3)
    n = 4
    t0 = time.perf_counter()
    for _ in range(n):
        toks = one_call()
    toks.cpu()
    elapsed = time.perf_counter() - t0
    overhead = min(pre, _measure_dispatch_overhead(device, repeats=3))
    dt = max(elapsed - overhead, 1e-9) / n
    return DeviceBenchResult(
        "engine_chunk_step", max_slots * steps / dt, "tok/s", 0.0, 0.0,
        {
            "ms_per_step": round(dt / steps * 1e3, 3),
            "ms_per_call": round(dt * 1e3, 1),
            "steps": steps,
            "window": window,
            "batch": max_slots,
            "dispatch_overhead_ms": round(overhead * 1e3, 1),
        },
    )


def bench_continuous_serving_saturated(max_slots=8, chunk=64,
                                       rounds_per_worker=4, max_new=192,
                                       cfg=None, model=None, repeats=3,
                                       device=None):
    """Closed-loop saturation: ``max_slots`` workers each fire
    back-to-back requests, so every chunk runs with all slots occupied —
    the engine's ceiling, separating scheduling losses (open-loop
    arrivals, mixed lengths) from decode-path throughput.

    ``repeats`` timed passes publish a cross-run BAND; the median run's
    numbers are the headline and the min/max device rates ride
    alongside."""
    import threading

    from container_engine_accelerators_tpu_torch.models import serve_cli

    cfg = cfg or _bench_cfg()
    model = model or serve_cli.Model(cfg, device=_device(device))
    device = model.device
    eng = serve_cli.ContinuousEngine(model, max_slots=max_slots,
                                     chunk=chunk)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size, 64).tolist()
    tokens = max_slots * rounds_per_worker * max_new
    errors = []

    def worker():
        try:
            for _ in range(rounds_per_worker):
                eng.generate([prompt], max_new)
        except Exception as e:  # noqa: BLE001 - re-raised on the caller
            errors.append(e)

    def one_pass():
        pre = _measure_dispatch_overhead(device, repeats=2)
        base = eng.stats()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker)
                   for _ in range(max_slots)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        overhead = min(pre, _measure_dispatch_overhead(device, repeats=2))
        delta = _stats_delta(eng.stats(), base)
        if errors:
            raise errors[0]
        return wall, overhead, delta

    try:
        eng.generate([prompt], max_new)  # warm the graphs
        passes = [one_pass() for _ in range(repeats)]
    finally:
        eng.shutdown()
    # One derivation per pass; median by wall, explicit key — tuple sort
    # would fall through to comparing the delta dicts on a tie.
    derived = [
        (w, oh, _serving_device_numbers(d, w, oh, max_slots))
        for w, oh, d in passes
    ]
    wall, overhead, (n_calls, device_s, suspect, occupancy) = sorted(
        derived, key=lambda p: p[0]
    )[len(derived) // 2]
    device_rates = [
        tokens / ds
        for _, _, (_, ds, sus, _) in derived
        if not sus
    ]
    walls = sorted(w for w, _, _ in passes)
    return DeviceBenchResult(
        "continuous_serving_saturated", tokens / wall, "tok/s", 0.0, 0.0,
        {
            "tokens": tokens,
            "wall_s": round(wall, 2),
            "wall_s_band": [round(walls[0], 2), round(walls[-1], 2)],
            "device_tok_per_s": (
                round(tokens / device_s) if not suspect else None
            ),
            "device_tok_per_s_band": (
                [round(min(device_rates)), round(max(device_rates))]
                if device_rates else None
            ),
            "repeats": repeats,
            "suspect": suspect,
            "occupancy_frac": round(occupancy, 3),
            "device_calls": n_calls,
            "dispatch_overhead_ms": round(overhead * 1e3, 1),
            "max_slots": max_slots,
            "chunk": chunk,
        },
    )


def bench_flash_long_context(seq=32768, iters=8, device=None):
    """Flash fwd / fwd+bwd at a long sequence: B 1, 4 q heads over 2 kv
    heads, D 128, causal (past the JAX package's STREAM_THRESHOLD of 8192,
    where its three streamed kernels run; here the flash forward, dq and
    dk/dv CUDA kernels, which cover staged and streamed shapes alike).
    Causal FLOPs accounting: qk + pv = 2 matmuls over the S²/2 triangle;
    bwd ≈ 2.5× fwd.

    Protocol: ``iters`` calls chained through a matrix carry, with the
    per-dispatch fixed cost (measured per round) subtracted. fwd+bwd
    takes gradients of q, k and v, all folded into the carry, so no
    kernel's work is dropped. ``detail`` counts the kernels' launches
    across the row."""
    device = _device(device)
    B, Hq, Hkv, D = 1, 4, 2, 128
    q = _normal((B, Hq, seq, D), torch.bfloat16, device, 0)
    k = _normal((B, Hkv, seq, D), torch.bfloat16, device, 1)
    v = _normal((B, Hkv, seq, D), torch.bfloat16, device, 2)
    counts0 = _flash_counts()

    def fwd(c):
        with torch.no_grad():
            for _ in range(iters):
                c = attention.flash_attention(c, k, v, causal=True) * 1e-1
        return c

    def fbw(c):
        for _ in range(iters):
            qq, kk, vv = (t.detach().requires_grad_() for t in (c, k, v))
            out = attention.flash_attention(qq, kk, vv, causal=True)
            dq, dk, dv = torch.autograd.grad(out.float().sum(), (qq, kk, vv))
            c = (c + dq * 1e-6 + (dk.mean() + dv.mean()) * 1e-9).to(
                torch.bfloat16)
        return c

    float(fwd(q)[0, 0, 0, 0])  # build + warm
    float(fbw(q)[0, 0, 0, 0])

    def time_rounds(run, rounds=3):
        """Median of ``rounds`` chained windows. The per-round dispatch
        overhead measurement rides each window. Rounds where the overhead
        probe exceeds half the window are overhead-dominated: the
        subtraction then amplifies probe jitter into the published rate,
        so the count (and the RAW unsubtracted per-iter time) ride the
        artifact to keep inflated TF/s visible."""
        times, raw_times = [], []
        dominated = 0
        for _ in range(rounds):
            overhead = _measure_dispatch_overhead(device, repeats=2)
            t0 = time.perf_counter()
            float(run(q)[0, 0, 0, 0])
            dt = time.perf_counter() - t0
            if overhead > 0.5 * dt:
                dominated += 1
            raw_times.append(dt / iters)
            times.append(max(dt - overhead, dt * 0.1) / iters)
        return (
            float(np.median(times)), float(min(times)),
            float(np.median(raw_times)), dominated,
        )

    dt_f, dt_f_min, dt_f_raw, dom_f = time_rounds(fwd)
    dt_b, dt_b_min, dt_b_raw, dom_b = time_rounds(fbw)
    flops_f = 2 * B * Hq * (seq * seq / 2) * D * 2
    flops_b = flops_f * 2.5
    fwd_l, dq_l, dkv_l = (a - b for a, b in
                          zip(_flash_counts(), counts0))
    return DeviceBenchResult(
        "flash_long_context", flops_f / dt_f / 1e12, "TFLOP/s", 0.0, 0.0,
        {
            "seq": seq,
            "fwd_ms": round(dt_f * 1e3, 1),
            "fwd_ms_min": round(dt_f_min * 1e3, 1),
            "fwd_ms_raw": round(dt_f_raw * 1e3, 1),
            "fwd_tflops": round(flops_f / dt_f / 1e12, 1),
            "fwd_overhead_dominated_rounds": dom_f,
            "fwd_bwd_ms": round(dt_b * 1e3, 1),
            "fwd_bwd_ms_min": round(dt_b_min * 1e3, 1),
            "fwd_bwd_ms_raw": round(dt_b_raw * 1e3, 1),
            "fwd_bwd_tflops": round(
                (flops_f + flops_b) / dt_b / 1e12, 1
            ),
            "fwd_bwd_overhead_dominated_rounds": dom_b,
            "suspect": bool(dom_f or dom_b),
            "streamed": True,
            "flash_fwd_launches": fwd_l,
            "flash_dq_launches": dq_l,
            "flash_dkv_launches": dkv_l,
        },
    )


def _flash_counts():
    return (attention.flash_fwd_launches, attention.flash_dq_launches,
            attention.flash_dkv_launches)


def bench_decode_window_benefit(prompt_len=192, steps=64, batch_size=8,
                                device=None):
    """Length-aware decode: early decode steps of a long-context model
    must not stream the whole max_seq_len cache.

    Measures ms/step at position ~256 on a max_seq_len=8192 model with
    the bucketed window vs the full-cache read, and the same positions
    on a max_seq_len=2048 model (the bar: windowed long-model steps
    within ~15% of the short model)."""
    device = _device(device)
    long_cfg = _bench_cfg(max_seq_len=8192)
    short_cfg = _bench_cfg(max_seq_len=2048)
    rows = {}
    for name, cfg, use_window in (
        ("s8192_windowed", long_cfg, True),
        ("s8192_full", long_cfg, False),
        ("s2048_windowed", short_cfg, True),
    ):
        try:
            r = bench_decode_throughput(
                batch_size=batch_size, prompt_len=prompt_len, steps=steps,
                cfg=cfg, rounds=2, use_window=use_window, device=device,
            )
            rows[name] = {
                "ms_per_step": r.detail["ms_per_step"],
                "window": r.detail["window"],
            }
        except Exception as e:  # noqa: BLE001 - per-point degradation
            rows[name] = f"error: {str(e)[:120]}"
    if all(isinstance(v, dict) for v in rows.values()):
        rows["windowed_vs_short_ratio"] = round(
            rows["s8192_windowed"]["ms_per_step"]
            / rows["s2048_windowed"]["ms_per_step"], 3
        )
        rows["windowed_vs_full_speedup"] = round(
            rows["s8192_full"]["ms_per_step"]
            / rows["s8192_windowed"]["ms_per_step"], 2
        )
    return rows


def _transformer_flops_per_token(params, cfg):
    """6N + 12·L·S·d (PaLM appendix-B accounting: params + attention);
    ``params`` is the model (a ``transformer.Transformer``), N its
    parameter count."""
    n_params = sum(p.numel() for p in params.parameters())
    return (
        6 * n_params
        + 12 * cfg.n_layers * cfg.max_seq_len * cfg.d_model,
        n_params,
    )


def bench_train_step_mfu(batch_size=6, steps=8, device=None, cfg=None,
                         remat=False, rounds=3):
    """Model-level qualification: the bench transformer's train-step MFU
    through ``transformer.make_train_step`` (the flash kernels forward
    and backward, AdamW) rather than a bare matmul.

    Timing: ``steps`` steps back-to-back with ONE host fetch at the end.
    The dispatch overhead is re-measured per round and the median
    corrected round is reported; raw and corrected times ride in the
    detail. ``remat=True`` checkpoints every layer (the forward is
    recomputed, ~2N FLOPs/token the 6N accounting doesn't credit)."""
    device = _device(device)
    cfg = cfg or _bench_cfg()
    init_state, train_step = tf.make_train_step(cfg, remat=remat,
                                                device=device)
    state = init_state(0)
    tokens = torch.randint(0, cfg.vocab_size,
                           (batch_size, cfg.max_seq_len + 1),
                           generator=_generator(device, 1), device=device)

    def sync(state):
        # A host FETCH of a post-update parameter element: the update is
        # not a data dependency of the loss, so fetching the loss could
        # return before the optimizer's kernels ran.
        leaf = next(state[0].parameters())
        float(leaf.detach().view(-1)[0])

    state, loss = train_step(state, {"tokens": tokens})  # build + warm
    sync(state)
    corrected, raw, overheads = [], [], []
    for _ in range(rounds):
        overhead = _measure_dispatch_overhead(device, repeats=2)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = train_step(state, {"tokens": tokens})
        sync(state)
        dt = time.perf_counter() - t0
        raw.append(dt / steps)
        overheads.append(overhead)
        corrected.append(max(dt - overhead, 1e-9) / steps)
    sec = float(np.median(corrected))
    flops_per_token, n_params = _transformer_flops_per_token(
        state[0], cfg
    )
    tokens_per_step = batch_size * cfg.max_seq_len
    tflops = flops_per_token * tokens_per_step / sec / 1e12
    gen = detect_generation(device)
    peak = gen.bf16_tflops if gen else 0.0
    return DeviceBenchResult(
        "train_step_mfu_remat" if remat else "train_step_mfu",
        tflops, "TFLOP/s", peak,
        tflops / peak if peak else 0.0,
        {
            "n_params": n_params,
            "tokens_per_s": round(tokens_per_step / sec),
            "step_s": round(sec, 4),
            "raw_step_s": [round(t, 4) for t in raw],
            "dispatch_overhead_ms": [
                round(o * 1e3, 1) for o in overheads
            ],
            "remat": remat,
            "batch": batch_size,
        },
    )


def bench_train_step_mfu_remat(device=None):
    """MFU under full rematerialization: the number memory-constrained
    production jobs see. The 6N accounting does not credit the ~2N
    recompute FLOPs/token, so the expected ratio vs the remat-free row is
    ≈ 6/8. The comparison pair is (train_step_mfu,
    train_step_mfu_remat)."""
    return bench_train_step_mfu(
        batch_size=6, steps=8, device=device, remat=True, rounds=3,
    )


def bench_train_step_mfu_1b(batch_size=2, steps=6, device=None, rounds=3):
    """Train-step MFU at a ≥1B-parameter config: d_model 4096, 4 layers,
    32 heads/8 kv, d_ff 16384, batch 2 × 2048 tokens, remat (the JAX
    package's wide route to 1B). Parameters, gradients and AdamW's two
    moments in bf16 fit one 80 GB card whole."""
    cfg = tf.TransformerConfig(
        vocab_size=32000,
        d_model=4096,
        n_layers=4,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        max_seq_len=2048,
        dtype="bfloat16",
    )
    r = bench_train_step_mfu(
        batch_size=batch_size, steps=steps, device=device, cfg=cfg,
        remat=True, rounds=rounds,
    )
    return DeviceBenchResult(
        "train_step_mfu_1b", r.value, r.unit, r.peak, r.frac_of_peak,
        dict(r.detail, d_model=cfg.d_model, n_layers=cfg.n_layers),
    )


def bench_train_step_mfu_remat_required(batch_size=7, device=None):
    """MFU at the JAX package's remat-REQUIRED config (batch 7, where its
    no-remat train step did not fit the TPU's HBM). Both sides are
    attempted so the artifact carries the evidence, not just the claim:
    on a card where the no-remat step fits, ``no_remat_unexpectedly_fits``
    records its rate."""
    detail = {"batch": batch_size}
    try:
        no_remat = bench_train_step_mfu(
            batch_size=batch_size, steps=2, device=device, remat=False,
            rounds=1,
        )
        # If this fits, the config is not remat-required here — surface
        # that loudly in the artifact.
        detail["no_remat_unexpectedly_fits"] = round(no_remat.value, 1)
    except torch.cuda.OutOfMemoryError as e:
        detail["no_remat"] = f"does not fit: {str(e)[:120]}"
    r = bench_train_step_mfu(
        batch_size=batch_size, steps=8, device=device, remat=True,
        rounds=3,
    )
    detail.update(r.detail)
    return DeviceBenchResult(
        "train_step_mfu_remat_required", r.value, r.unit, r.peak,
        r.frac_of_peak, detail,
    )
