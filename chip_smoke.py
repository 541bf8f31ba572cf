#!/usr/bin/env python3
# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""On-card smoke test of the PyTorch/H100 port (needs one CUDA GPU).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, serves full-width
Llama-3-8B (16 of its 32 layers, ``SERVE_LAYERS``; random weights from
seed 0) through the
port's HTTP server, one request at a time, through the paged
continuous-batching engine (warmed with ``--warmup=all``: every decode
window's CUDA graph captured before ready), with speculative decoding
(``--speculate ngram|draft``: every batched verify the replay of its
graph, the flash kernel at per-row bases read from device memory),
through the dense continuous-batching engine (the default
``--kv-cache``) and the ``--batch-window-ms`` micro-batcher, under
overload and injected faults (bounded admission with typed 429s,
deadlines, tenant classes, step retries, drains, a client that hangs
up), with every observability flag on (``/metrics`` with the JAX
server's families, the SLO, chip accounting, span traces, the flight
recorder, ``--profile-dir``), hands a cached prompt's KV blocks
from a prefill replica to a decode replica over HTTP (``/kv/export``,
``/kv/install``, the JAX wire), serves it
again with int8 weights (``--quantize int8``: every projection the
hand-written W8A16 kernel, eagerly and inside the captured graphs),
trains it at full width
(depth cut to 8 layers) through ``make_train_step``, trains BERT-large
MLM at full width and depth (every layer's attention the non-causal
flash forward, dq and dk/dv kernels), runs ``train_cli`` for every
``--model`` and its recovery (a preempted supervised run resumed from
its checkpoint, a corrupt checkpoint quarantined), runs every
single-card qualification row of ``collectives/device_bench.py`` (bf16
and int8 matmul, HBM patterns through the Triton triad, read and copy,
decode, prefill, the engines, flash attention at S 32768, train-step MFU
up to 1.1 B parameters) against the card table's peaks, checking that every
prefill, every prefill segment and every training step went through the
kernels, and that every decode chunk replayed its captured graph. Each
phase prints one JSON line; a failed phase raises and the script exits
non-zero before its last line, which is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.

Phases: env, build, kernel (forward, one line per case; the host-bound
shapes also timed as a CUDA graph of 20 launches; then the int8 product's
rows, ``int8_mm_*``, at Llama-3-8B's projections and at the qualification
model's, ``int8_mm_bench_*``), bwd_kernel (backward,
one line per case), small_parity (a tiny f32 model on the card against
the same weights on the CPU), int8_small_parity (a tiny f32 int8 model's
tokens through generate, the dense and the paged engine, with and
without speculation, equal to the CPU's on the same int8 weights),
paged_small_parity (a tiny f32 paged engine
on the card against dense generate), dense_small_parity (the dense engine
on that model against dense generate and the paged engine), serve,
serve_logits (prefill logits
through the kernel vs plain attention), serve_paged (the paged engine
behind the server: shared prefixes and a long prompt prefilled between
decode chunks; ``--health-log`` holds JAX's ready line after warmup and
the event stream one ``warmup_done`` record with JAX's attrs),
spec_small_parity (a tiny f32 engine's tokens with
speculate ngram and draft equal to off), paged_graph_parity (the graphed
decode chunk against the eager one on the full-width model), serve_spec
(speculative decoding, ngram, off and draft, on the full-width paged
engine: every verify a replay, streams held to off's), serve_dense (the
dense engine behind the server on serve_paged's traffic, then the
micro-batcher; streams held to ``Model.generate``'s), serve_robust
(overload, a deadline, armed prefill, chunk and verify faults, drains
of 4 rows, tenant classes and a hang-up on the dense engine and the
paged ``--speculate ngram`` engine: sheds by reason, retries equal to
the faults fired, migrations equal to the occupied slots, every served
token within SERVE_LOGITS_ATOL of its teacher-forced argmax), serve_obs
(the dense engine and the paged ``--speculate ngram`` engine built by
the CLI's code with ``--chip-accounting``, the SLO, ``--trace-out``,
``--flight-recorder`` and ``--metrics-port`` on serve_dense's traffic:
the JAX server's families and counts on ``/metrics`` and the metrics
port, the device-time ledger against its envelopes, the HBM model
against the card's allocations, the flight bundle, each request's spans,
one request under ``--profile-dir``; then the dense engine's tokens/s
and TTFT with every obs flag on against all off), serve_handoff (a
``--role prefill`` and a ``--role decode`` paged replica built by the
CLI's code; a client splits serve_paged's 1024- and 3000-token prompts
as JAX's router does: the prefill leg, ``POST /kv/export``, ``POST
/kv/install``, the request on the decode replica; installed bytes equal
to the exported ones bit for bit, the receiver's tokens equal to the
sender's radix-hit tokens, the sharing prompts hit on the receiver, a
corrupted and a cut stream refused with 409 and nothing changed, the
fallback equal to the cold reference; export and install seconds, HTTP
round trips, wire bytes, TTFT handed off against cold, the split path
against the unified TTFT), serve_int8
(``--quantize int8`` on generate, the dense engine and the speculating
paged engine; every served token held to the int8 reference; then
serve_obs's dense checks on the int8 model, serve_obs_int8), train_grads
(loss and every gradient through the kernels vs plain attention), train
(5 timed steps), train_bert_grads (BERT-large cut to 2 layers, loss and
every gradient through the kernels vs JAX's plain attention), train_bert
(BERT-large, 5 timed steps, 24 launches of each kernel a step),
train_cli, train_cli_models (mnist, resnet, bert and the transformer with
4 experts through ``train_cli.main``: the JAX CLI's result keys),
train_recovery (BERT through ``train_cli``: a preemption at step 3, one
restart from step 2, the end state against an unfaulted run's; then a
corrupted newest checkpoint quarantined with one fallback), ring (ring
attention's kernel half at Llama-3-8B's attention widths, S 32768, sp 2
and sp 4: every rank's forward and backward ring through
``parallel/ring_attention.py``'s own ring loops in this process, an
in-process transport in place of NCCL, sp² launches of each flash kernel,
the assembled out, lse, dq, dk and dv held to the whole-sequence flash
kernels by ``parallel/world_smoke.py``'s checks, every shard call of the held ranks,
a wholly-future shard among them, held to its plain version, each step
timed beside the whole sequence), moe_sp (MoE at Mixtral-8x7B's widths
with the sequence over sp 2 and sp 4 in this process, each sequence
routed whole across the ranks: the layer at S 8192 against the whole
sequence's, then 2 layers' steps on the flash ring against the unsplit
step), tp_whole (4 Qwen2-1.5B layers at tp 4 in this process, the
attention whole on every rank: its 2 KV heads do not divide over 4),
train_dist (``train_cli --distributed``
as a world of one over NCCL through the env contract: the bootstrap
marker, ``n_devices`` 1, every step's loss equal to the same run without
``--distributed``), serve_tp (tensor-parallel serving at Llama-3-8B's
widths, 4 layers, tp 8 with every rank in this process: the dense and
paged engines under ``--warmup=all`` against the unsplit engines on the
same weights, streams parting only below SERVE_LOGITS_ATOL's margin,
final logits, ring against off prefill, int8 under tp against unsplit
int8, layers × tp flash launches a prefill call, every decode step a
replay; last an MoE paged engine at Mixtral-8x7B's widths, 4 layers, tp
8, against the unsplit one), moe_small_parity (a small f32 MoE model
whose groups drop nothing: the paged engine's tokens equal dense
generate's), serve_moe (an MoE model at Mixtral-8x7B's widths, 8 of its
32 layers: generate, the dense engine, the paged engine under
``--warmup=all`` and under ``--speculate ngram``, each against itself on
the plain attention, partings past the margin held by world_smoke's
router rule; int8 attention projections; then all 32 layers over HTTP:
TTFT, ms a token, peak memory), collectives (the collectives CLI's
one-device refusal, every bench over an NCCL world of one with each
op's output held, the env profiles' ConfigMap), compile_cache (two
fresh processes in turn on one
new ``--compile-cache-dir`` directory (``warmstart/cache.py``), each
building the three nvcc libraries and launching each Triton stream
kernel once: the first misses each library and runs nvcc, the second
hits each and runs none, and Triton's specialisations likewise; hits,
misses, seconds and the files of each), train_cli_cache (``train_cli
--compile-cache-dir`` twice in fresh processes on one directory, the
CLI's small transformer, a preemption under ``--max-restarts 1``: the
second run builds nothing, and each restart event carries its attempt's
``cache_hits``/``cache_misses``), hostbench (the port's host-loop bench on
this machine's CPU: host microseconds per token with fake device seams,
paged, dense and paged with ngram; a host measurement, not the card's),
fleet_drills (the port's hermetic fleet tier on this machine's CPU at
each CLI's defaults: the replica-kill chaos drill of ``fleet/sim.py``,
the restart storm of ``faults/storm.py`` and the disaggregation bench of
``fleet/disagg.py``; fails on any ``pass: false``),
device_bench (the single-card qualification rows of
``collectives/device_bench.py`` in the JAX package's bench.py order at
its arguments, plus the int8 decode row and the batcher head-to-head: one
line a row with the card's name and power limit; fails on a reading <= 0
or above 1.05 of its peak, a matmul shape, decode point or HBM pattern
that errs, an S 32768 row that missed the flash kernels or an int8 row
that missed ``int8_mm`` or whose launches are not 7 × layers per
prefill and per graph replay, or a saturated serving row whose
``occupancy_frac`` is under 0.8), device_bench_int8_tokens (that row's
decoded tokens, equal in every run and each within SERVE_LOGITS_ATOL of
the plain int8 model's top logit on its own context), stream_kernels
(the Triton triad, read and copy of ``ops/stream.py`` against their
plain versions at every dtype and size the HBM rows run, at the rows'
constants and at constants that move every term; then timed at 1 GiB
bf16),
kernels (the summary line), then the card's name and power limit, then
the result. The kernel phases include device_bench's long-context shape
(``long_context_s32768``: S 32768, 4/2 heads, D 128) forward and backward.
"""

import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import logging
import math
import os
import re
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

from container_engine_accelerators_tpu_torch.collectives import cards

# The bounds below are against the nominal dense peaks of the card this
# script runs on, its entry in the port's card table (collectives/cards.py:
# NVIDIA's H100 SXM data sheet); main() fails on any other card.
PEAK_CARD = cards.H100_SXM
PEAK_BF16_FLOPS = PEAK_CARD.bf16_tflops * 1e12
PEAK_F32_FLOPS = 67e12   # f32 outside the tensor cores (not in the table)
HBM_BYTES_PER_S = PEAK_CARD.hbm_gbps * 1e9

# Tolerances of the kernel against its plain version on the same inputs.
# bf16: the kernel and the plain version both round p and out to bf16
# (8 significant bits, relative step 2^-8), but round p at different
# running maxima (the kernel's per-tile max, the plain version's row
# max), so an output element may differ by about one bf16 step of its
# magnitude. f32: only the summation order differs.
TOL = {
    "bfloat16": {"out_atol": 1e-2, "out_rtol": 1e-2, "lse_atol": 1e-4},
    # f16 keeps 11 significant bits (a step of 2^-11 relative), 8 times
    # finer than bf16: the same one-step argument.
    "float16": {"out_atol": 2e-3, "out_rtol": 2e-3, "lse_atol": 1e-4},
    "float32": {"out_atol": 2e-5, "out_rtol": 0.0, "lse_atol": 2e-5},
}
# Prefill logits of the 32-layer model through the kernel vs the plain
# attention (both bf16): the per-layer one-step differences above feed
# 32 bf16 residual blocks. Logits here have a spread of about 1.
SERVE_LOGITS_ATOL = 0.25
# Backward kernels against flash_bwd_reference on the same inputs, per
# gradient (see grad_errors): the relative L2 error ||got - ref|| /
# ||ref||, and the worst row (a query's dq, a key's dk or dv) against its
# own norm plus the typical row norm, so a wrong tile of small late rows
# or keys fails even where the first rows' gradients are large. bf16:
# both round p and ds to bf16 at the same values, up to f32
# summation-order noise in s and dp, and each writes one bf16 output (a
# row differs by about 2^-9 of its norm, more where a few ds flip a bf16
# step over 16384 keys); a 30 % wrong row reads 0.15 or more. f32:
# summation order only. Each bwd_kernel line prints both readings.
BWD_TOL = {
    "bfloat16": {"rel_l2": 5e-3, "row": 1e-2},
    "float16": {"rel_l2": 1e-3, "row": 2e-3},  # the same, at f16's step
    "float32": {"rel_l2": 1e-5, "row": 1e-4},
}
# train_grads: the same bf16 model through the kernels and through plain
# attention (mha_reference under autograd). The two round attention at
# other places (normalized vs unnormalized p; autograd rounds dP to bf16
# through the reference's casts), about one bf16 step per element, and
# that passes through two layers' backward. Per parameter: relative L2
# error and largest error over the largest |gradient|.
TRAIN_GRAD_TOL = {"rel_l2": 3e-2, "max_rel": 1e-1, "loss_abs": 1e-2}
# The result keys of the JAX package's train_cli for the transformer
# (container_engine_accelerators_tpu/models/train_cli.py: _train_steps,
# run_transformer and main).
TRAIN_CLI_KEYS = {"loss", "start_step", "steps_run", "units_per_s",
                  "mean_step_s", "est_mfu", "batch_size", "model", "steps",
                  "n_devices", "wall_s"}
# The same CLI's keys for every --model at its single-device flags (mnist,
# resnet, bert, transformer; pp 1), and what a supervised run
# (--max-restarts) and an --event-log add.
TRAIN_CLI_SUPERVISED_KEYS = TRAIN_CLI_KEYS | {"restarts", "goodput"}


# The int8 kernel against int8_mm_reference on the same operands. bf16:
# both sum exact int8 x bf16 products in f32 and round the scaled sum to
# bf16 once, so only the order of the f32 sums differs: an output may sit
# one bf16 step (2^-7 of its magnitude) apart, plus the f32
# summation-order noise (far under 1e-3 at K 14336 for outputs of about
# unit size). f32: summation order only.
INT8_TOL = {"bfloat16": {"rtol": 2.0 ** -7, "atol": 1e-3},
            "float16": {"rtol": 2.0 ** -10, "atol": 1e-3},
            "float32": {"rtol": 1e-5, "atol": 1e-5}}
# The Triton triad and copy against their plain versions (bf16, f32): both
# compute x + y·s + z·ε (x·c + t) in f32 in one order (the kernels without
# fused multiply-adds) and round once to the buffer's dtype, so they may
# differ only where the f32 results differ, by one unit in the last place
# of the dtype at most. The int8 copy is exact.
STREAM_ULPS = 1.0


def ulp_gap(torch, got, want):
    """Largest |got - want| in units of the last place of got's dtype at
    the larger magnitude of the two (0 where they are equal)."""
    bits = {torch.bfloat16: 7, torch.float32: 23}[got.dtype]
    a, b = got.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    _, exp = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 1 - bits)
    return ((a - b).abs() / ulp).max().item()


def read_rtol(torch, n):
    """Relative bound on the Triton read's f32 total against the plain
    version's, for n elements: every term is >= 0, so a chain of c f32
    additions errs by at most c · 2^-24 of the total; the kernel's longest
    chain is a lane's share of its program's tiles plus the programs'
    atomic adds, and the plain version's pairwise sum is shorter."""
    from container_engine_accelerators_tpu_torch.ops import stream

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-n // stream.READ_BLOCK)
    programs = max(1, min(tiles, sms * stream.READ_PROGRAMS_PER_SM))
    chain = -(-tiles // programs) + programs
    return 2 * chain * 2.0 ** -24


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started, so a phase's time is the difference from
    the line before it."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(report):
    """The lines of nvcc's ``-Xptxas -v`` report that say what a kernel
    costs, each after its kernel's name, its 16-bit element type and its
    integer template arguments (``flash_bwd_dq_sm90_kernel<f16,128>``,
    ``int8_mm_sm90_kernel<8,1,8,2>``): registers, spills, and any note
    that ptxas serialised the kernel's wgmma instructions, which costs
    most of their rate."""
    kernel, lines = "?", []
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '.*?((?:flash_(?:fwd|"
                          r"bwd)_(?:dq_|dkv_)?(?:sm90|f32|wide|wide_stream)"
                          r"|int8_mm_(?:sm90|mma|f32)|dkv_reduce)_kernel)"
                          r"(\w*)'", line)
        if found:
            args = [{"13__nv_bfloat16": "bf16", "6__half": "f16"}[e] for e in
                    re.findall(r"13__nv_bfloat16|6__half", found.group(2))]
            args += re.findall(r"L[ib](\d+)E", found.group(2))
            kernel = f"{found.group(1)}<{','.join(args)}>"
        elif any(w in line for w in ("Used", "spill", "wgmma", "serialized")):
            lines.append(f"{kernel}: {line.strip()}")
    return lines


def attended_pairs(seq_q, seq_k, causal, q_base=0, k_base=0, kv_len=None):
    """Visible (query, key) pairs of one (batch, head) under the flash
    masks: keys below kv_len and, when causal, at global positions
    k_base + j <= q_base + i."""
    kv = seq_k if kv_len is None else max(0, min(kv_len, seq_k))
    if not causal:
        return seq_q * kv
    return sum(
        max(0, min(kv, q_base - k_base + i + 1)) for i in range(seq_q)
    )


# Per visible (q, k) pair: FLOPs in units of D, and the tensors moved
# once each, as (q-shaped, k-shaped, f32 rows of Sq) counts; the first two
# k-shaped tensors (k, v) are read over the keys the masks leave, the rest
# (dk, dv) written over all Sk keys. Forward: QK^T
# and PV; reads q, k, v, writes out and lse. dq: s, dp and ds.k; reads q,
# dO, k, v, lse, delta, writes dq. dk/dv: s, dp, p^T.dO and ds^T.q; reads
# q, dO, k, v, lse, delta, writes dk, dv. The whole backward (flash_bwd):
# the five products a backward cannot avoid; reads q, dO, out (for delta),
# k, v, lse, writes dq, dk, dv.
WORK = {
    "fwd": (4, 2, 2, 1),
    "dq": (6, 3, 2, 2),
    "dkv": (8, 2, 4, 2),
    "bwd": (10, 4, 4, 1),
}
# What a batch row must still write when none of its queries sees a key
# (a ring's wholly-future shard): (q-shaped, k-shaped over all Sk, f32
# rows of Sq) outputs; its inputs are not needed, as the kernels skip
# them (out 0, lse -1e30, zero gradients).
WRITES = {"fwd": (1, 0, 1), "dq": (1, 0, 0), "dkv": (0, 2, 0),
          "bwd": (1, 2, 0)}


def flash_bound(batch, num_q_heads, num_kv_heads, seq_q, seq_k, d, dtype,
                causal, q_base=0, k_base=0, kv_len=None, kind="fwd"):
    """(bound_ms, bound_by) of one flash call of ``kind`` (see WORK): the
    larger of FLOPs / peak and bytes / HBM rate. K and V are read only
    below kv_len and, when causal, up to the last query's diagonal.
    ``q_base`` may be a list of one per batch row (the device base): the
    rows' work and bytes are summed. A row whose queries see no key moves
    only its outputs (WRITES)."""
    flops_per_d, q_like, k_like, rows = WORK[kind]
    elt = 4 if dtype == "float32" else 2
    q_bases = q_base if isinstance(q_base, (list, tuple)) else \
        [q_base] * batch
    flops = nbytes = 0
    kv = seq_k if kv_len is None else max(0, min(kv_len, seq_k))
    for qb in q_bases:
        pairs = num_q_heads * attended_pairs(seq_q, seq_k, causal, qb,
                                             k_base, kv_len)
        flops += flops_per_d * d * pairs
        if pairs == 0:
            q_out, k_out, rows_out = WRITES[kind]
            nbytes += elt * d * (q_out * num_q_heads * seq_q
                                 + k_out * num_kv_heads * seq_k)
            nbytes += 4 * rows_out * num_q_heads * seq_q
            continue
        keys_read = max(0, min(kv, qb - k_base + seq_q)) if causal else kv
        nbytes += elt * d * (q_like * num_q_heads * seq_q + num_kv_heads
                             * (2 * keys_read + (k_like - 2) * seq_k))
        nbytes += 4 * rows * num_q_heads * seq_q
    # bf16 and f16 run at one dense tensor-core rate on this card.
    peak = PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def time_ms(fn, torch, min_iters=3, budget_ms=300.0):
    """Mean device time of fn() in ms over a warm loop, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = max(min_iters, min(100, int(budget_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Forward cases whose back-to-back event time reads the wrapper's host
# time (PERF.md): each is also timed as a CUDA graph of GRAPH_LAUNCHES
# launches, which has no host work between the kernels.
GRAPH_MS_CASES = ("causal_512_b2", "q_base_1536", "paged_sq16_qb1040",
                  "paged_sq64_qb2000", "verify_b8_sq16", "tp8_verify_b8_sq16",
                  "draft_d32_sq512",
                  "dense_seg_sq512_qb2560", "bert_large_s512")
# Backward cases timed the same way, each kernel apart (dq_graph_ms,
# dkv_graph_ms): BERT-large's dq and dk/dv read about 50 µs of host time
# back to back.
BWD_GRAPH_MS_CASES = ("bert_large_s512",)
GRAPH_LAUNCHES = 20


def graph_ms(fn, torch, attention, serving_graphs, launches=GRAPH_LAUNCHES):
    """Device time of one fn() in ms: a CUDA graph of ``launches`` calls,
    replayed back to back (time_ms), over ``launches``. The wrapper's
    launch count is left as it was: the capture's calls (and its warm-up
    iterations) record or run the kernel for this timing only, and a
    replay does not pass through the wrapper."""
    graphs = serving_graphs.GraphSet("cuda")

    def calls():
        for _ in range(launches):
            fn()

    counted = attention.flash_fwd_launches
    try:
        graphs.capture("calls", calls)
    finally:
        attention.flash_fwd_launches = counted
    return time_ms(lambda: graphs.replay("calls"), torch) / launches


def host_us(fn, torch, calls=20):
    """Host wall time of fn() in microseconds: ``calls`` calls back to back
    with no synchronize between them, so it reads the wrapper's own work
    (checks, tensor-map encoding, ctypes, the launch) while the device
    runs behind. Where it exceeds the device time, back-to-back device
    timing (time_ms) measures the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


# Ring attention's shard calls at S 32768 beyond the diagonal ones
# (causal_8192 and causal_16384 at bases 0): a whole past shard of sp 4
# and sp 2 (every key visible) and a wholly-future shard (no key visible).
RING_SHARD_CASES = (
    ("ring_past_s8192", 1, 8192, 8192, True, 8192, 0, None, 32, 8, 128,
     "bfloat16"),
    ("ring_past_s16384", 1, 16384, 16384, True, 16384, 0, None, 32, 8, 128,
     "bfloat16"),
    ("ring_future_s8192", 1, 8192, 8192, True, 0, 8192, None, 32, 8, 128,
     "bfloat16"),
)
BERT_LARGE_CASE = ("bert_large_s512", 8, 512, 512, False, 0, 0, None, 16,
                   16, 64, "bfloat16")
# device_bench's bench_flash_long_context: S 32768, B 1, 4 q heads over 2
# kv heads, D 128, causal (the JAX package streams K/V, and Q in dk/dv,
# past 8192).
LONG_CONTEXT_CASE = ("long_context_s32768", 1, 32768, 32768, True, 0, 0,
                     None, 4, 2, 128, "bfloat16")
# The pipeline phase's stage attention: one microbatch of 1 × 4096 at
# Llama-3-8B's heads.
PIPELINE_CASE = ("pipeline_s4096", 1, 4096, 4096, True, 0, 0, None, 32, 8,
                 128, "bfloat16")
# The tensor_parallel phase's rank attention: Llama-3-8B's heads over tp 4
# (8 query heads on 2 kv heads), 1 × 4096.
TP_LOCAL_CASE = ("tp_local_s4096", 1, 4096, 4096, True, 0, 0, None, 8, 2,
                 128, "bfloat16")
# (name, batch, seq_q, seq_k, causal, q_base, k_base, kv_len, hq, hkv, d,
#  dtype). The first four are the Llama-3-8B prefill shapes (Hq 32, Hkv 8,
# D 128): the serve phase's prompts of 300 (batch 2) and 1500 tokens land
# in the 512 and 2048 buckets. "main" marks the shape the kernels line
# reports. A list of q_base (one per batch row) is passed as the device
# ``base`` tensor of [q_base, k_base, kv_len] rows, as the verify does.
# serve_tp's prefill at tp 8 (Llama-3-8B's 32/8 heads over 8 ranks: 4 query
# heads, 1 key/value head a rank): a 512-token segment.
TP_SERVE_CASE = ("tp8_serve_sq512", 1, 512, 512, True, 0, 0, None, 4, 1,
                 128, "bfloat16")
# serve_tp's verify under --speculate at tp 8 (4 query heads, 1 key/value
# head a rank): verify_b8_sq16's batch of 8 rows at their own decode
# positions, read from device memory, over the 2048-token window.
TP_VERIFY_CASE = ("tp8_verify_b8_sq16", 8, 16, 2048, True,
                  [1040 + 137 * i for i in range(8)], 0, None, 4, 1, 128,
                  "bfloat16")
# Head widths between the kernels' instantiations (80 and 96 on the D 128
# kernel, the columns past D read as zeros), D 256 (its own layouts), and
# D 100 (the binding pads it to 104): the public checkpoints' prefill
# shapes at their heads (head_widths' models) and the masks' edges. Past
# 256, the column-chunk kernels: D 288 (Gemma-2-2B's and Gemma-3-1B's
# widths on the repo's block, head_widths' models), D 512 (JAX's CLI at
# --d-model 4096 --n-heads 8), D 300 (padded to 304), f32.
WIDE_CASES = [
    ("gemma2_2b_d288_s4096", 1, 4096, 4096, True, 0, 0, None, 8, 4, 288,
     "bfloat16"),
    ("gemma3_1b_d288_s4096", 1, 4096, 4096, True, 0, 0, None, 4, 1, 288,
     "bfloat16"),
    ("d512_s2048", 1, 2048, 2048, True, 0, 0, None, 8, 8, 512, "bfloat16"),
    ("d300_padded", 1, 1000, 1000, True, 0, 0, None, 8, 2, 300, "bfloat16"),
    ("f32_d520", 1, 100, 300, True, 250, 0, None, 8, 2, 520, "float32"),
]
HEAD_WIDTH_CASES = [
    ("phi3_d96_s4096", 1, 4096, 4096, True, 0, 0, None, 32, 32, 96,
     "bfloat16"),
    ("gemma2b_d256_s8192", 1, 8192, 8192, True, 0, 0, None, 8, 1, 256,
     "bfloat16"),
    ("stablelm3b_d80_s4096", 1, 4096, 4096, True, 0, 0, None, 32, 32, 80,
     "bfloat16"),
    ("d96_noncausal_kv_len", 1, 300, 1000, False, 0, 0, 777, 32, 32, 96,
     "bfloat16"),
    ("d100_padded", 1, 1000, 1000, True, 0, 0, None, 8, 2, 100, "bfloat16"),
    ("f32_d80", 1, 100, 300, True, 250, 0, None, 8, 2, 80, "float32"),
    ("f32_d96", 1, 100, 300, True, 250, 0, None, 8, 2, 96, "float32"),
    ("f32_d100", 2, 77, 300, False, 0, 0, 250, 4, 1, 100, "float32"),
    ("f32_d256", 2, 77, 300, False, 0, 0, 250, 4, 1, 256, "float32"),
    *WIDE_CASES,
]
KERNEL_CASES = [
    ("causal_512_b2", 2, 512, 512, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_2048", 1, 2048, 2048, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    PIPELINE_CASE,
    TP_LOCAL_CASE,
    TP_SERVE_CASE,
    TP_VERIFY_CASE,
    ("causal_8192", 1, 8192, 8192, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    # Past 8192 keys the JAX package switches to its streaming forward.
    ("causal_16384", 1, 16384, 16384, True, 0, 0, None, 32, 8, 128,
     "bfloat16"),
    *RING_SHARD_CASES,
    ("q_base_1536", 1, 512, 2048, True, 1536, 0, None, 32, 8, 128,
     "bfloat16"),
    ("noncausal_kv_len", 1, 300, 1000, False, 0, 0, 777, 32, 8, 128,
     "bfloat16"),
    ("future_keys", 1, 200, 200, True, 0, 150, None, 32, 8, 128, "bfloat16"),
    ("d64_unaligned", 2, 1000, 1000, True, 0, 0, None, 8, 2, 64, "bfloat16"),
    # train_cli's default tiny model: head dim 32.
    ("d32_train_cli", 2, 128, 128, True, 0, 0, None, 8, 4, 32, "bfloat16"),
    # The edges of the kernel's 128-row q and 128-key K/V tiles: one row or
    # key past a tile, the causal diagonal mid-tile, kv_len inside the
    # first key tile, ragged D 64 and D 32, and several waves of blocks.
    ("s129", 1, 129, 129, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("s255", 1, 255, 255, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("diagonal_mid_tile", 1, 300, 700, True, 400, 0, None, 32, 8, 128,
     "bfloat16"),
    ("kv_len_in_first_tile", 1, 200, 300, True, 0, 0, 50, 32, 8, 128,
     "bfloat16"),
    ("d64_ragged", 2, 333, 517, False, 0, 0, 400, 8, 2, 64, "bfloat16"),
    ("d32_ragged", 2, 250, 250, True, 0, 0, None, 8, 4, 32, "bfloat16"),
    ("waves_b4", 4, 1024, 1024, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("f32_q_base", 1, 100, 300, True, 250, 0, None, 8, 2, 128, "float32"),
    ("f32_d64_kv_len", 2, 77, 300, False, 0, 0, 250, 4, 1, 64, "float32"),
    # The paged engine's prefill segments: Sq a segment bucket (often below
    # the 128-row q tile), q_base the radix-reused offset (a multiple of the
    # 16-token block, not of 128), Sk the power-of-two window gathered from
    # the block pool, which reaches past q_base + Sq: the causal bound must
    # stop the K/V walk at the diagonal.
    ("paged_sq16_qb1040", 1, 16, 2048, True, 1040, 0, None, 32, 8, 128,
     "bfloat16"),
    ("paged_sq64_qb2000", 1, 64, 4096, True, 2000, 0, None, 32, 8, 128,
     "bfloat16"),
    ("paged_sq512_qb7680", 1, 512, 8192, True, 7680, 0, None, 32, 8, 128,
     "bfloat16"),
    # Speculation's verify at batch 8: 16 rows a batch row at its own
    # decode position (1040-2000, read from device memory) over the
    # 2048-token window gathered from the pool.
    ("verify_b8_sq16", 8, 16, 2048, True,
     [1040 + 137 * i for i in range(8)], 0, None, 32, 8, 128, "bfloat16"),
    # The draft proposer's prefill segment (Llama-3-8B's heads at the
    # draft's head dim 32, its 512-token segment).
    ("draft_d32_sq512", 1, 512, 512, True, 0, 0, None, 32, 8, 32,
     "bfloat16"),
    # The dense engine's prefill segment as it calls the kernel: the 512
    # rows at q_base 2560 over the slot's whole cache row (Sk 8192, the
    # context), kv_len the segment's window (4096); the causal bound stops
    # the K/V walk at 3072.
    ("dense_seg_sq512_qb2560", 1, 512, 8192, True, 2560, 0, 4096, 32, 8,
     128, "bfloat16"),
    # BERT-large's attention (train_bert): non-causal, 16 q heads on 16
    # kv heads (a GQA group of 1), head dim 64, S 512, B 8.
    BERT_LARGE_CASE,
    LONG_CONTEXT_CASE,
    *HEAD_WIDTH_CASES,
    # B * Hq past grid.y's 65535 (BERT-large's 16 heads reach it at batch
    # 4096): folded over grid.y and grid.z.
    ("bhq_65792", 2056, 128, 128, True, 0, 0, None, 32, 8, 64, "bfloat16"),
]
MAIN_CASE = "causal_2048"


def run_kernel_case(case, torch, attention, gen, serving_graphs):
    (name, batch, seq_q, seq_k, causal, q_base, k_base, kv_len, hq, hkv, d,
     dtype) = case
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = rand(batch, hq, seq_q, d), rand(batch, hkv, seq_k, d), \
        rand(batch, hkv, seq_k, d)
    if isinstance(q_base, list):
        base = torch.tensor(
            [[qb, k_base, seq_k if kv_len is None else kv_len]
             for qb in q_base], dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, sm_scale=d ** -0.5, base=base)
        mask_base = torch.tensor(q_base, device="cuda")
    else:
        kw = dict(causal=causal, sm_scale=d ** -0.5, q_base=q_base,
                  k_base=k_base, kv_len=kv_len)
        mask_base = q_base
    out, lse = attention.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention.flash_fwd_reference(q, k, v, **kw)
    if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
        fail(f"kernel case {name}: non-finite output")
    err_out = (out.float() - ref_out.float()).abs()
    tol = TOL[dtype]
    excess = (err_out - tol["out_atol"]
              - tol["out_rtol"] * ref_out.float().abs()).max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    row = {
        "phase": "kernel", "case": name,
        "shape": {"B": batch, "Hq": hq, "Hkv": hkv, "Sq": seq_q,
                  "Sk": seq_k, "D": d},
        "dtype": dtype, "causal": causal, "q_base": q_base,
        "k_base": k_base, "kv_len": kv_len,
        "max_abs_err_out": err_out.max().item(),
        "max_abs_err_lse": err_lse, "tol": tol,
    }
    if excess > 0 or err_lse > tol["lse_atol"]:
        emit(row)
        fail(f"kernel case {name} disagrees with flash_fwd_reference")
    del ref_out, ref_lse, err_out
    row["ms"] = time_ms(lambda: attention.flash_fwd(q, k, v, **kw), torch)
    row["host_us"] = host_us(lambda: attention.flash_fwd(q, k, v, **kw), torch)
    if name in GRAPH_MS_CASES:
        row["graph_ms"] = graph_ms(lambda: attention.flash_fwd(q, k, v, **kw),
                                   torch, attention, serving_graphs)
    row["plain_ms"] = time_ms(
        lambda: attention.flash_fwd_reference(q, k, v, **kw), torch,
        budget_ms=100.0,
    )
    row["bound_ms"], row["bound_by"] = flash_bound(
        batch, hq, hkv, seq_q, seq_k, d, dtype, causal, q_base, k_base,
        kv_len,
    )
    row["library_ms"], backend = library_ms(
        q, k, v, torch, attention, causal=causal, sm_scale=d ** -0.5,
        q_base=mask_base, k_base=k_base, kv_len=kv_len,
        backend=d > 256 or dtype == "float16")
    if backend:
        row["library_backend"] = backend
    row["ms_over_library"] = (row["ms"] / row["library_ms"]
                              if row["library_ms"] else None)
    emit(row)
    return row


def _sdpa_mask(q, k, attention, causal, q_base, k_base, kv_len):
    """scaled_dot_product_attention's mask arguments for the flash masks,
    or None where some row sees no key: there it computes another
    function (NaN). ``q_base`` may be a (B,) tensor (per-row bases): the
    mask is then (B, 1, Sq, Sk)."""
    seq_q, seq_k = q.shape[2], k.shape[2]
    vis = attention._visible(seq_q, seq_k, causal, q_base, k_base, kv_len,
                             q.device)
    if not vis.any(dim=-1).all():
        return None
    if causal and isinstance(q_base, int) and q_base == k_base and \
            seq_q == seq_k and kv_len is None:
        return {"is_causal": True}
    if not causal and kv_len is None:
        return {}
    return {"attn_mask": vis}


# scaled_dot_product_attention's backends by the names of the ATen ops
# (and CUDA kernels) a call of each runs.
SDPA_BACKENDS = (("flash", ("flash_attention",)),
                 ("efficient", ("efficient_attention", "fmha_cutlass")),
                 ("cudnn", ("cudnn_attention",)),
                 ("math", ("attention_math",)))


def sdpa_backend(fn, torch):
    """Which of scaled_dot_product_attention's backends ``fn`` ran
    (SDPA_BACKENDS), read from the op names a profile of one call shows
    (the host's ops as well as the kernels, so it does not rest on the
    device trace alone), or None where it finds none of them. Its flash
    backend stops at head dim 256."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages()).lower()
    for backend, marks in SDPA_BACKENDS:
        if any(m in names for m in marks):
            return backend
    return None


def library_ms(q, k, v, torch, attention, *, causal, sm_scale, q_base,
               k_base, kv_len, backend=False):
    """(ms, backend) of PyTorch's scaled_dot_product_attention on the same
    inputs and mask, a yardstick only (the port never calls it); the
    backend it took (``sdpa_backend``) where ``backend`` asks, else None.
    (None, None) where the masks leave a row no key."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = _sdpa_mask(q, k, attention, causal, q_base, k_base, kv_len)
    if kw is None:
        return None, None

    def call():
        return sdpa(q, k, v, scale=sm_scale, enable_gqa=True, **kw)

    return time_ms(call, torch), sdpa_backend(call, torch) if backend else None


def library_bwd_ms(q, k, v, g, torch, attention, *, causal, sm_scale,
                   q_base, k_base, kv_len, backend=False):
    """As ``library_ms``, of the backward of scaled_dot_product_attention
    (autograd on the same inputs and mask: dq, dk and dv together); the
    backend is the one its forward took, whose backward autograd runs."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = _sdpa_mask(q, k, attention, causal, q_base, k_base, kv_len)
    if kw is None:
        return None, None
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]

    def forward():
        return sdpa(*qkv, scale=sm_scale, enable_gqa=True, **kw)

    out = forward()

    def call():
        return torch.autograd.grad(out, qkv, g, retain_graph=True)

    return (time_ms(call, torch),
            sdpa_backend(forward, torch) if backend else None)


# Backward cases, the same tuple as KERNEL_CASES. S 16384 takes the JAX
# package's streaming dq and dk/dv branches (and streaming forward);
# "causal_8192" is the train phase's shape, reported on the kernels line.
BWD_CASES = [
    ("causal_2048", 1, 2048, 2048, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    PIPELINE_CASE,
    TP_LOCAL_CASE,
    ("causal_8192", 1, 8192, 8192, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_16384", 1, 16384, 16384, True, 0, 0, None, 32, 8, 128,
     "bfloat16"),
    *RING_SHARD_CASES,
    ("q_base_1536", 1, 512, 2048, True, 1536, 0, None, 32, 8, 128,
     "bfloat16"),
    ("noncausal_kv_len", 1, 300, 1000, False, 0, 0, 777, 32, 8, 128,
     "bfloat16"),
    ("future_keys", 1, 200, 200, True, 0, 150, None, 32, 8, 128, "bfloat16"),
    ("d64_unaligned", 2, 1000, 1000, True, 0, 0, None, 8, 2, 64, "bfloat16"),
    ("d32_train_cli", 2, 128, 128, True, 0, 0, None, 8, 4, 32, "bfloat16"),
    # The forward's tile-edge cases, then the edges of the backward's tiles
    # (dk/dv: 128-key blocks of two 64-key halves, 64-row q tiles; dq:
    # 128-row blocks, 64-key tiles): one row past a 64-row q tile, a ragged
    # key half (keys 128..190 of the second block, none in its second
    # half), and a GQA group of 8 q heads summed into each dk/dv.
    ("s129", 1, 129, 129, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("s255", 1, 255, 255, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("diagonal_mid_tile", 1, 300, 700, True, 400, 0, None, 32, 8, 128,
     "bfloat16"),
    ("kv_len_in_first_tile", 1, 200, 300, True, 0, 0, 50, 32, 8, 128,
     "bfloat16"),
    ("sq65", 1, 65, 65, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("sk191", 1, 256, 191, False, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("gqa8", 1, 1024, 1024, True, 0, 0, None, 32, 4, 128, "bfloat16"),
    ("f32_d128", 1, 512, 512, True, 0, 0, None, 8, 2, 128, "float32"),
    BERT_LARGE_CASE,
    LONG_CONTEXT_CASE,
    # The head widths (dk/dv at D 256: 32-row q tiles and two walks, Gemma-
    # 2B's one KV head split over 8 blocks): the training shapes of
    # head_widths' models, the padded D 100, f32.
    ("phi3_d96_s4096", 1, 4096, 4096, True, 0, 0, None, 32, 32, 96,
     "bfloat16"),
    ("gemma2b_d256_s4096", 1, 4096, 4096, True, 0, 0, None, 8, 1, 256,
     "bfloat16"),
    ("stablelm3b_d80_s4096", 1, 4096, 4096, True, 0, 0, None, 32, 32, 80,
     "bfloat16"),
    ("d100_padded", 1, 1000, 1000, True, 0, 0, None, 8, 2, 100, "bfloat16"),
    ("f32_d80", 1, 256, 256, True, 0, 0, None, 8, 2, 80, "float32"),
    ("f32_d96", 1, 200, 300, False, 0, 0, 250, 8, 2, 96, "float32"),
    ("f32_d100", 1, 256, 256, True, 0, 0, None, 8, 2, 100, "float32"),
    ("f32_d256", 1, 256, 256, True, 0, 0, None, 8, 2, 256, "float32"),
    ("bhq_65792", 2056, 128, 128, True, 0, 0, None, 32, 8, 64, "bfloat16"),
    # Past 256: the column-chunk dq and dk/dv (head_widths trains
    # Gemma-3-1B's D 288 over one KV head: its dk/dv split 2).
    *WIDE_CASES,
]
BWD_MAIN_CASE = "causal_8192"


def _rel_err(got, ref):
    """Largest |got - ref| over the largest |ref| (1 where ref is 0)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def grad_errors(got, ref):
    """(largest |got - ref|, ||got - ref|| / ||ref||, worst row) of one
    gradient: ``parallel/world_smoke.py``'s ``rel_errors``, the measure
    the assembled ring is held by too. Rows lie along the last axis; the
    worst row is the largest ||got_r - ref_r|| / (||ref_r|| + m), m the
    median norm of the nonzero rows of ref: each row is held to its own
    scale, and a row whose gradient cancels to about 0 (a causal first
    query) to the typical one."""
    from container_engine_accelerators_tpu_torch.parallel import world_smoke

    return world_smoke.rel_errors(got, ref)


def run_bwd_case(case, torch, attention, _ext, gen, serving_graphs):
    (name, batch, seq_q, seq_k, causal, q_base, k_base, kv_len, hq, hkv, d,
     dtype) = case
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = rand(batch, hq, seq_q, d), rand(batch, hkv, seq_k, d), \
        rand(batch, hkv, seq_k, d)
    g = rand(batch, hq, seq_q, d)
    kw = dict(causal=causal, sm_scale=d ** -0.5, q_base=q_base,
              k_base=k_base, kv_len=kv_len)
    out, lse = attention.flash_fwd(q, k, v, **kw)
    grads = attention.flash_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    ref = attention.flash_bwd_reference(q, k, v, out, lse, g, **kw)
    row = {
        "phase": "bwd_kernel", "case": name,
        "shape": {"B": batch, "Hq": hq, "Hkv": hkv, "Sq": seq_q,
                  "Sk": seq_k, "D": d},
        "dtype": dtype, "causal": causal, "q_base": q_base,
        "k_base": k_base, "kv_len": kv_len, "tol": BWD_TOL[dtype],
    }
    bad = []
    for grad_name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        err, rel_l2, worst = grad_errors(got, want)
        row[f"max_abs_err_{grad_name}"] = err
        row[f"rel_l2_{grad_name}"] = rel_l2
        row[f"worst_row_{grad_name}"] = worst
        if not torch.isfinite(got.float()).all() or \
                rel_l2 > BWD_TOL[dtype]["rel_l2"] or \
                worst > BWD_TOL[dtype]["row"]:
            bad.append(grad_name)
    kv = seq_k if kv_len is None else kv_len
    if grads[1][:, :, kv:].any() or grads[2][:, :, kv:].any():
        bad.append("dk/dv past kv_len not 0")
    blind = ~attention._visible(seq_q, seq_k, causal, q_base, k_base, kv_len,
                                q.device).expand(seq_q, seq_k).any(dim=1)
    row["rows_without_keys"] = int(blind.sum())
    if grads[0][:, :, blind].any():
        bad.append("dq of rows without keys not 0")
    if bad:
        emit(row)
        fail(f"bwd case {name} disagrees with flash_bwd_reference: {bad}")
    del ref, grads

    delta = (out.float() * g.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ext_kw = dict(kw, kv_len=kv)
    row["dq_ms"] = time_ms(
        lambda: _ext.flash_bwd_dq(q, k, v, g, lse, delta, dq, **ext_kw), torch)
    row["dkv_ms"] = time_ms(
        lambda: _ext.flash_bwd_dkv(q, k, v, g, lse, delta, dk, dv, **ext_kw),
        torch)
    row["bwd_ms"] = time_ms(
        lambda: attention.flash_bwd(q, k, v, out, lse, g, **kw), torch)
    if name in BWD_GRAPH_MS_CASES:
        row["dq_graph_ms"] = graph_ms(
            lambda: _ext.flash_bwd_dq(q, k, v, g, lse, delta, dq, **ext_kw),
            torch, attention, serving_graphs)
        row["dkv_graph_ms"] = graph_ms(
            lambda: _ext.flash_bwd_dkv(q, k, v, g, lse, delta, dk, dv,
                                       **ext_kw),
            torch, attention, serving_graphs)
    row["dq_host_us"] = host_us(
        lambda: _ext.flash_bwd_dq(q, k, v, g, lse, delta, dq, **ext_kw), torch)
    row["dkv_host_us"] = host_us(
        lambda: _ext.flash_bwd_dkv(q, k, v, g, lse, delta, dk, dv, **ext_kw),
        torch)
    # Plain versions: each kernel's own outputs, and the whole backward.
    for kind, only in (("dq", "dq"), ("dkv", "dkv"), ("bwd", None)):
        row[f"{kind}_plain_ms"] = time_ms(
            lambda only=only: attention.flash_bwd_reference(
                q, k, v, out, lse, g, only=only, **kw),
            torch, budget_ms=100.0,
        )
    for kind in ("dq", "dkv", "bwd"):
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = flash_bound(
            batch, hq, hkv, seq_q, seq_k, d, dtype, causal, q_base, k_base,
            kv_len, kind=kind,
        )
    row["library_ms"], backend = library_bwd_ms(
        q, k, v, g, torch, attention,
        backend=d > 256 or dtype == "float16", **kw)
    if backend:
        row["library_backend"] = backend
    emit(row)
    return row


# (name, M, K, N): Llama-3-8B's layer matrices (wq/wo (4096, 4096), wk/wv
# (4096, 1024), w1/w3 (4096, 14336), w2 (14336, 4096)) at generate's one
# decode row, the engines' 8, the 16 of the D16 tile, the B 8 verify's
# 128 (8 rows × 16) and prefill buckets of 512 and 2048 rows. "main" of
# the kernels line: the engines' decode's largest product.
INT8_CASES = [
    ("m1_w1", 1, 4096, 14336),
    ("m8_wq", 8, 4096, 4096), ("m8_wk", 8, 4096, 1024),
    ("m8_w1", 8, 4096, 14336), ("m8_w2", 8, 14336, 4096),
    ("m16_w1", 16, 4096, 14336),
    ("m128_w1", 128, 4096, 14336), ("m128_w2", 128, 14336, 4096),
    ("m512_w1", 512, 4096, 14336), ("m512_w2", 512, 14336, 4096),
    ("m2048_w1", 2048, 4096, 14336), ("m2048_w2", 2048, 14336, 4096),
    # device_bench's model (_bench_cfg: wq/wo (2048, 2048), wk/wv (2048,
    # 1024), w1/w3 (2048, 8192), w2 (8192, 2048)) at the int8 decode row's
    # batch of 8 and its prefill of 8 × 128 rows.
    ("bench_m8_wq", 8, 2048, 2048), ("bench_m8_wk", 8, 2048, 1024),
    ("bench_m8_w1", 8, 2048, 8192), ("bench_m8_w2", 8, 8192, 2048),
    ("bench_m1024_wq", 1024, 2048, 2048),
    ("bench_m1024_wk", 1024, 2048, 1024),
    ("bench_m1024_w1", 1024, 2048, 8192),
    ("bench_m1024_w2", 1024, 8192, 2048),
]
# serve_tp's shard shapes at tp 8: the column shards (wq 4096 × 512, w1
# 4096 × 1792) in bf16 and the row shards (wo 512 × 4096, w2 1792 × 4096)
# with the f32 epilogue of their partial sums, at the engines' decode
# batch and a 512-token prefill.
TP_INT8_CASES = [
    ("tp8_m8_wq", 8, 4096, 512), ("tp8_m8_w1", 8, 4096, 1792),
    ("tp8_m512_w1", 512, 4096, 1792),
    ("tp8_m8_wo_f32", 8, 512, 4096, "float32"),
    ("tp8_m8_w2_f32", 8, 1792, 4096, "float32"),
    ("tp8_m512_w2_f32", 512, 1792, 4096, "float32"),
]
INT8_CASES += TP_INT8_CASES
INT8_MAIN_CASE = "m8_w1"
# Rows whose back-to-back time may read the wrapper's host time: also
# timed as a CUDA graph of GRAPH_LAUNCHES launches, and held bit-equal to
# the eager launch when replayed.
INT8_GRAPH_CASES = ("m1_w1", "m8_wq", "m8_wk", "m8_w1", "m8_w2",
                    "m16_w1", "m128_w1", "m128_w2", "bench_m8_wq",
                    "bench_m8_wk", "bench_m8_w1", "bench_m8_w2",
                    "fp16_m8_w1", "fp16_m8_wq", "fp16_m8_wk")
# Weight bytes one timed pass cycles through, so that a launch finds its
# weight in HBM (the 50 MB L2 cannot hold them), as the decode does: it
# streams 218 MB of layer matrices a layer.
COLD_BYTES = 120e6


def int8_bound(m, k, n, y_bytes=2):
    """(bound_ms, bound_by) of one W8A16 product: the larger of 2MKN over
    the bf16 peak and K·N (int8) + 4N (scale) + 2MK (x) + ``y_bytes``·MN
    (y: bf16, or 4 for an f32 output) bytes over the HBM rate."""
    t_ops = 2.0 * m * k * n / PEAK_BF16_FLOPS
    t_bytes = (k * n + 4 * n + 2 * m * k + y_bytes * m * n) / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def _cycling(fn, count):
    """A no-argument call of fn(i) for i = 0, 1, ..., count - 1, 0, ..."""
    state = {"i": -1}

    def call():
        state["i"] = (state["i"] + 1) % count
        return fn(state["i"])

    return call


def run_int8_case(case, torch, int8_matmul, q8, gen, serving_graphs,
                  attention, act="bfloat16"):
    """One int8_mm row: the kernel against the plain version (activations
    in ``act``, bf16 or f16, within INT8_TOL), then its time on weights
    cycled through more than the L2 holds, beside the plain version, the
    unfused PyTorch composition (``library_ms``), cuBLAS on a weight of the
    activations' dtype and the same shape (``bf16_ms``, or ``f16_ms``) and
    ``torch._weight_int8pack_mm`` where this torch runs it on CUDA. A
    fifth field "float32" asks for the f32 epilogue (a row shard's partial
    sums), held to the plain version's f32 output."""
    name, m, k, n, *out_dtype = case
    out_dt = getattr(torch, out_dtype[0]) if out_dtype else None
    dt = getattr(torch, act)
    dense = "bf16" if act == "bfloat16" else "f16"
    x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    copies = max(1, min(GRAPH_LAUNCHES, math.ceil(COLD_BYTES / (k * n))))
    qts, scales = [], []
    for _ in range(copies):
        qw = q8.quantize_weight(
            torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5)
        qts.append(qw["q"].T.contiguous())
        scales.append(qw["scale"])
        del qw
    got = int8_matmul.int8_mm(x, qts[0], scales[0], out_dtype=out_dt)
    torch.cuda.synchronize()
    ref = int8_matmul.int8_mm_reference(x, qts[0], scales[0],
                                        out_dtype=out_dt)
    tol = INT8_TOL[act]
    err = (got.float() - ref.float()).abs()
    excess = (err - tol["atol"] - tol["rtol"] * ref.float().abs()).max()
    row = {"phase": "kernel", "case": f"int8_mm_{name}", "kernel": "int8_mm",
           "shape": {"M": m, "K": k, "N": n}, "dtype": act,
           "out_dtype": "float32" if out_dt is not None else act,
           "weight_copies": copies, "max_abs_err": err.max().item(),
           "tol": tol}
    if not torch.isfinite(got.float()).all() or excess.item() > 0:
        emit(row)
        fail(f"int8 case {name} disagrees with int8_mm_reference")
    kernel = _cycling(lambda i: int8_matmul.int8_mm(x, qts[i], scales[i],
                                                    out_dtype=out_dt), copies)
    row["ms"] = time_ms(kernel, torch)
    row["host_us"] = host_us(kernel, torch)
    if name in INT8_GRAPH_CASES:
        graphs, out = serving_graphs.GraphSet("cuda"), {}
        graphs.capture("one", lambda: out.update(
            y=int8_matmul.int8_mm(x, qts[0], scales[0])))
        out["y"].zero_()
        graphs.replay("one")
        torch.cuda.synchronize()
        row["replay_bit_equal"] = bool(torch.equal(out["y"], got))
        if not row["replay_bit_equal"]:
            emit(row)
            fail(f"int8 case {name}: a graph replay differs from the eager "
                 f"launch")
        row["graph_ms"] = graph_ms(kernel, torch, attention, serving_graphs)
    row["plain_ms"] = time_ms(
        lambda: int8_matmul.int8_mm_reference(x, qts[0], scales[0],
                                              out_dtype=out_dt), torch,
        budget_ms=100.0)
    row["bound_ms"], row["bound_by"] = int8_bound(
        m, k, n, y_bytes=2 if out_dt is None else 4)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["library_ms"] = time_ms(_cycling(
        lambda i: ((x @ qts[i].to(dt).T) * scales[i]).to(out_dt or dt),
        copies), torch)
    try:
        scales_bf16 = [sc.reshape(-1).to(dt) for sc in scales]
        row["int8pack_ms"] = time_ms(_cycling(
            lambda i: torch._weight_int8pack_mm(x, qts[i], scales_bf16[i]),
            copies), torch)
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        row["int8pack_ms"] = None
        row["int8pack_note"] = f"not run on CUDA here: {e}"[:200]
    del qts, scales
    bf16_copies = max(1, min(GRAPH_LAUNCHES,
                             math.ceil(COLD_BYTES / (2 * k * n))))
    ws = [(torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5)
          .to(dt) for _ in range(bf16_copies)]
    row[f"{dense}_ms"] = time_ms(_cycling(lambda i: x @ ws[i], bf16_copies),
                                 torch)
    row[f"ms_over_{dense}"] = row["ms"] / row[f"{dense}_ms"]
    del ws
    emit(row)
    return row


def small_int8_cpu_twin(torch, tf, serve_cli, q8, model):
    """``model`` (a serve_cli.Model quantized on the card) as a Model on
    the CPU with the same int8 weights."""
    cpu = q8.quantize_params(tf.Transformer(model.cfg, "cpu"))
    cpu.load_state_dict({k: t.cpu()
                         for k, t in model.model.state_dict().items()})
    return serve_cli.Model(model.cfg, weights=cpu)


def weight_bytes(model):
    """Bytes of a model's weights on the card: parameters and buffers."""
    return sum(t.nbytes for t in (*model.parameters(), *model.buffers()))


def _int8_counts(int8_matmul):
    return int8_matmul.int8_mm_launches, int8_matmul.int8_mm_captured


def int8_small_parity(torch, np, tf, serve_cli, int8_matmul, q8):
    """A small f32 int8 model (every projection through the kernel's f32
    path) on the card against the same int8 weights on the CPU: greedy
    tokens identical through ``Model.generate``, the dense engine and the
    paged engine; ``--speculate ngram`` on the paged engine equal to off.
    On each path the kernel launches 7 × layers times per eager forward
    call, and every captured step records 7 × layers products."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    per = 7 * cfg.n_layers
    model = serve_cli.Model(cfg, seed=1, device="cuda", quantize="int8")
    cpu = small_int8_cpu_twin(torch, tf, serve_cli, q8, model)
    rng = np.random.default_rng(6)
    cases = [(rng.integers(0, cfg.vocab_size, 70).tolist(), 10)]
    cases += [(rng.integers(0, cfg.vocab_size, 3 + 9 * i).tolist(), 8 + i)
              for i in range(3)]
    cases.append((rng.integers(0, cfg.vocab_size, 5).tolist(), 1))
    want = [cpu.generate([p], n)[0] for p, n in cases]
    row = {"phase": "int8_small_parity", "requests": len(cases)}
    bad = []

    graphs = model.decode_graphs.graphs
    (l0, c0), g0 = _int8_counts(int8_matmul), graphs.captures
    outs = [model.generate([p], n)[0] for p, n in cases]
    launches, captured = (a - b for a, b in
                          zip(_int8_counts(int8_matmul), (l0, c0)))
    row["generate"] = {"tokens_equal_cpu": outs == want,
                       "int8_mm_launches": launches,
                       "int8_mm_captured": captured,
                       "graph_captures": graphs.captures - g0}
    if outs != want or launches != per * len(cases) or \
            captured != per * (graphs.captures - g0):
        bad.append("generate")
    for kv_cache, mode in (("dense", "off"), ("paged", "off"),
                           ("paged", "ngram")):
        engine = serve_cli.ContinuousEngine(
            model, max_slots=2, chunk=4, prefill_chunk=32, kv_block_size=16,
            kv_cache=kv_cache, speculate=mode)
        l0, c0 = _int8_counts(int8_matmul)
        try:
            with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
                futures = [pool.submit(engine.generate, [p], n)
                           for p, n in cases]
                outs = [f.result(timeout=300)[0] for f in futures]
        finally:
            engine.shutdown()
        launches, captured = (a - b for a, b in
                              zip(_int8_counts(int8_matmul), (l0, c0)))
        stats, gs = engine.stats(), engine.graph_stats()
        captures = gs["graph_captures"] + gs.get("verify_graph_captures", 0)
        key = f"{kv_cache}_{mode}"
        row[key] = {"tokens_equal_cpu": outs == want,
                    "n_prefills": stats["n_prefills"],
                    "int8_mm_launches": launches,
                    "int8_mm_captured": captured, "graph_captures": captures,
                    "eager_chunks_on_cuda": gs["eager_chunks_on_cuda"],
                    "verifies": stats.get("spec_verifies")}
        if outs != want or launches != per * stats["n_prefills"] or \
                captured != per * captures or gs["eager_chunks_on_cuda"]:
            bad.append(key)
    emit(row)
    if bad:
        fail(f"int8_small_parity: {bad} disagree with the CPU on the same "
             f"int8 weights, or a projection went around the kernel")


def small_parity(torch, tf, serving_graphs, attention):
    """A tiny f32 model (head dim 128, so the f32 kernel runs) on the
    card against the same weights on the CPU (plain attention)."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    gpu = tf.init_params(cfg, device="cuda", seed=1)
    cpu = tf.Transformer(cfg, "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    prompt = torch.arange(3, 40)[None, :] % cfg.vocab_size
    before = attention.flash_fwd_launches
    with torch.inference_mode():
        lg = tf.forward(gpu, prompt.cuda()).cpu()
        lc = tf.forward(cpu, prompt)
    tg = tf.generate(gpu, prompt.cuda(), max_new_tokens=8,
                     decoder=serving_graphs.DenseDecodeGraphs(gpu)).cpu()
    tc = tf.generate(cpu, prompt, max_new_tokens=8,
                     decoder=serving_graphs.DenseDecodeGraphs(cpu))
    err = (lg - lc).abs().max().item()
    row = {"phase": "small_parity", "max_abs_err_logits": err,
           "tol": 1e-3, "tokens_equal": bool(torch.equal(tg, tc)),
           "kernel_launches": attention.flash_fwd_launches - before}
    emit(row)
    if err > 1e-3 or not row["tokens_equal"] or not row["kernel_launches"]:
        fail("small f32 model on the card disagrees with the CPU")


# The depth of the Llama-3-8B model the serving phases share (serve,
# serve_paged, serve_spec, serve_dense, serve_robust, serve_obs,
# serve_handoff) and of serve_int8's: 16 of its 32 layers, cut from all 32
# to keep the script inside its time limit once serve_moe came.
SERVE_LAYERS = 16


def serve(torch, np, tf, serve_cli, attention, card):
    """Full-width Llama-3-8B (SERVE_LAYERS of its layers) behind the
    port's HTTP server. ``card``: the GPU's name and power limit, printed
    beside the times."""
    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=SERVE_LAYERS)
    _free(torch)
    t0 = time.perf_counter()
    alloc0 = torch.cuda.memory_allocated()
    model = serve_cli.Model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    load_bytes = torch.cuda.memory_allocated() - alloc0
    rng = np.random.default_rng(0)

    def prompt(n, rows=1):
        return rng.integers(0, cfg.vocab_size, (rows, n)).tolist()

    p17, p300, p1500 = prompt(17), prompt(300, rows=2), prompt(1500)
    # p1500 captures the decode graph of its window (batch 1, 2048);
    # p1500_again replays it: its decode time is the served one.
    requests = [("p17", p17, 32), ("p300_b2", p300, 32),
                ("p1500", p1500, 32), ("p1500_ttft", p1500, 1),
                ("p1500_again", p1500, 32), ("p17_again", p17, 32)]

    # The main path: counts at zero, then server start (its warmup
    # decode) and the requests, through the entry points a user calls.
    attention.flash_fwd_launches = 0
    server, state = serve_cli.start_server(model, port=0, host="127.0.0.1")
    try:
        serve_cli.wait_ready(state, timeout=600)
        port = server.server_address[1]
        seen = attention.flash_fwd_launches
        if seen != cfg.n_layers:
            fail(f"warmup prefill launched the kernel {seen} times, "
                 f"want {cfg.n_layers}")
        results = {}
        for name, toks, max_new in requests:
            before = attention.flash_fwd_launches
            resp = serve_cli.post_generate(port, toks, max_new)
            delta = attention.flash_fwd_launches - before
            if delta != cfg.n_layers:
                fail(f"{name}: {delta} kernel launches, want one per layer "
                     f"({cfg.n_layers}) for its one prefill")
            out = np.asarray(resp["tokens"])
            want = (len(toks), len(toks[0]) + max_new)
            if out.shape != want or (out[:, :want[1] - max_new]
                                     != np.asarray(toks)).any():
                fail(f"{name}: response shape {out.shape}, want {want} "
                     f"with the prompt as prefix")
            if out.min() < 0 or out.max() >= cfg.vocab_size:
                fail(f"{name}: token ids outside the vocabulary")
            results[name] = resp
    finally:
        server.shutdown()
    launches = attention.flash_fwd_launches
    for name in ("p17", "p1500"):
        if results[name]["tokens"] != results[f"{name}_again"]["tokens"]:
            fail(f"the same greedy request ({name}) gave different tokens")
    ttft = results["p1500_ttft"]["latency_s"]
    decode_ms = (results["p1500_again"]["latency_s"] - ttft) / 31 * 1e3
    # Every decode step replays the graph of its (batch, window), captured
    # at the first step that needs it; step s of a request decodes at
    # position prompt + s - 1 (the warmup request: 4 new tokens after 4).
    graphs = model.decode_graphs.graphs
    shapes = [(1, 4, 4)] + [(len(t), len(t[0]), n) for _, t, n in requests]
    windows = {(b, tf._window_for(p + s, cfg.max_seq_len))
               for b, p, n in shapes for s in range(1, n)}
    steps = sum(n - 1 for _, _, n in shapes)
    if (graphs.captures, graphs.replays) != (len(windows), steps):
        fail(f"dense decode: {graphs.captures} graph captures and "
             f"{graphs.replays} replays, want {len(windows)} (one per "
             f"batch and window) and {steps} (every decode step)")
    emit({
        "phase": "serve", **card, "model": "llama3-8b",
        "n_layers": cfg.n_layers,
        "init_s": init_s, "requests": len(requests),
        "flash_fwd_launches": launches,
        "launches_per_prefill": cfg.n_layers,
        "latency_s": {n: r["latency_s"] for n, r in results.items()},
        "ttft_s_p1500": ttft, "decode_ms_per_token_p1500": decode_ms,
        "decode_ms_per_token_p1500_with_capture":
            (results["p1500"]["latency_s"] - ttft) / 31 * 1e3,
        "graph_captures": graphs.captures, "graph_replays": graphs.replays,
        "graph_capture_s": graphs.capture_s,
        "graph_pool_gb": graphs.pool_bytes() / 1e9,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    })

    toks = torch.as_tensor(p1500, device="cuda")
    with torch.inference_mode():
        flash = tf.forward(model.model, toks, logits_at="last")
        plain = tf.forward(model.model, toks, logits_at="last",
                           attn_impl="plain")
    err = (flash - plain).abs().max().item()
    emit({
        "phase": "serve_logits", "prompt_len": 1500,
        "max_abs_err": err, "tol": SERVE_LOGITS_ATOL,
        "logit_std": plain.std().item(),
        "argmax_equal": bool(torch.equal(flash.argmax(-1),
                                         plain.argmax(-1))),
    })
    if not torch.isfinite(flash).all() or err > SERVE_LOGITS_ATOL:
        fail("prefill logits through the kernel disagree with plain "
             "attention")
    bf16 = {"ttft_s_p1500": ttft, "decode_ms_per_token_p1500": decode_ms,
            "p1500_tokens": results["p1500_again"]["tokens"][0],
            "load_allocated_bytes": load_bytes}
    return launches, model, bf16


def _check_response(name, resp, prompt, max_new, vocab_size):
    out = resp["tokens"]
    if len(out) != 1 or len(out[0]) != len(prompt) + max_new or \
            out[0][:len(prompt)] != prompt:
        fail(f"{name}: response of {len(out[0])} tokens, want the "
             f"{len(prompt)}-token prompt as prefix of {len(prompt) + max_new}")
    if min(out[0]) < 0 or max(out[0]) >= vocab_size:
        fail(f"{name}: token ids outside the vocabulary")


def serve_paged(torch, np, tf, serve_cli, attention, card, model):
    """The paged continuous-batching engine (max_slots 8, decode chunk 32,
    prefill chunk 512, block 16, the default pool) on the serve phase's
    full-width model, behind the HTTP server started with
    ``--warmup=all``: every paged prefill shape runs and every decode
    window's graph is captured before ready, so the traffic only replays
    (no capture, no chunk run eagerly). Traffic: a request with a
    1024-token prompt runs to completion (its retire puts the prefix into
    the radix index); then 6 concurrent requests share that prefix, each
    with its own 64-token suffix; while they decode, a 3000-token prompt
    arrives and prefills in 512-token segments between their decode
    chunks. Every prefill segment runs the flash kernel once per layer.
    Each final segment's logits are kept (on the card) and held, after the
    traffic, against the dense ``tf.forward`` on the same context. The
    server runs with ``--health-log``: once warmup succeeds the file holds
    JAX's ready line and nothing before, and the engine's event stream one
    ``warmup_done`` record with JAX's attrs equal to the warmup summary.
    Returns the kernel's launches."""
    import tempfile

    from container_engine_accelerators_tpu_torch.obs import events as obs_events

    cfg = model.cfg
    vocab = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    engine = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512, kv_block_size=16,
        kv_cache="paged", events=obs_events.EventStream("serve"),
    )
    health_dir = tempfile.TemporaryDirectory(prefix="serve_paged-")
    health_log = os.path.join(health_dir.name, "health.log")
    # Each prefill call: (offset, segment length, true_pos, chunks
    # dispatched before it); each final segment's (tokens, logits).
    segments, finals = [], []
    paged_prefill = engine._paged_prefill

    def prefill_keeping_logits(*args, want_logits=False, **kw):
        seg, off, true_pos = args[2], args[3], args[6]
        segments.append((off, seg.shape[1], true_pos,
                         engine.stats()["n_chunks"]))
        if not want_logits:
            return paged_prefill(*args, want_logits=False, **kw)
        tok, logits = paged_prefill(*args, want_logits=True,
                                    return_logits=True, **kw)
        finals.append((seg, off, true_pos, logits))
        return tok

    engine._paged_prefill = prefill_keeping_logits
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, 1024).tolist()
    prompts = {"prefix_1024": prefix}
    for i in range(6):
        prompts[f"shared_{i}"] = prefix + rng.integers(0, vocab, 64).tolist()
    prompts["long_3000"] = rng.integers(0, vocab, 3000).tolist()
    max_new = {name: 32 for name in prompts}
    max_new["prefix_1024"] = 8
    results, latency = {}, {}

    # The main path: counts at zero, then server start (the warm grid and
    # the warmup request run through the engine) and the traffic.
    attention.flash_fwd_launches = 0
    attention.flash_dq_launches = attention.flash_dkv_launches = 0
    t0 = time.perf_counter()
    server, state = serve_cli.start_server(engine, port=0, host="127.0.0.1",
                                           warmup_mode="all",
                                           health_log=health_log)
    try:
        serve_cli.wait_ready(state, timeout=600)
        ready_s = time.perf_counter() - t0
        port = server.server_address[1]
        warm = state["warmup"]
        health = _held_health(health_log, engine, warm, "serve_paged")
        at_ready = {"launches": attention.flash_fwd_launches,
                    "n_prefills": engine.stats()["n_prefills"],
                    "steps_done": engine.stats()["steps_done"],
                    **engine.graph_stats()}

        def post(name):
            t0 = time.perf_counter()
            results[name] = serve_cli.post_generate(
                port, [prompts[name]], max_new[name])
            latency[name] = time.perf_counter() - t0

        post("prefix_1024")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(7) as pool:
            futures = [pool.submit(post, f"shared_{i}") for i in range(6)]
            # The long prompt arrives once the shared requests decode.
            chunks = engine.stats()["n_chunks"]
            deadline = time.monotonic() + 600
            while engine.stats()["n_chunks"] == chunks:
                if time.monotonic() > deadline:
                    fail("serve_paged: no decode chunk after the shared "
                         "requests were posted")
                time.sleep(0.002)
            futures.append(pool.submit(post, "long_3000"))
            for f in futures:
                f.result(timeout=600)
        burst_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        health_dir.cleanup()
    launches = attention.flash_fwd_launches
    other = attention.flash_dq_launches + attention.flash_dkv_launches
    stats, kvs = engine.stats(), engine.kv_stats()
    graph_stats = engine.graph_stats()
    engine.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name, prompt in prompts.items():
        _check_response(name, results[name], prompt, max_new[name], vocab)
    n_windows = len(tf.serving_shape_buckets(cfg, engine.prefill_chunk,
                                             engine.chunk)["windows"])
    warm_segments = warm["tasks"] - n_windows
    if at_ready["graph_captures"] != n_windows:
        fail(f"serve_paged: the warmup captured {at_ready['graph_captures']} "
             f"decode graphs, want one per window ({n_windows})")
    if at_ready["launches"] != cfg.n_layers * (warm_segments
                                               + at_ready["n_prefills"]):
        fail(f"serve_paged: {at_ready['launches']} flash launches before "
             f"ready for {warm_segments} warm segments and "
             f"{at_ready['n_prefills']} of the warmup request")
    served = stats["n_prefills"] - at_ready["n_prefills"]
    if launches - at_ready["launches"] != cfg.n_layers * served or other:
        fail(f"serve_paged: {launches - at_ready['launches']} flash launches "
             f"after ready for {served} prefill segments (want "
             f"{cfg.n_layers} each), {other} backward launches")
    if graph_stats["eager_chunks_on_cuda"] or \
            graph_stats["graph_captures"] != at_ready["graph_captures"] or \
            graph_stats["graph_replays"] - at_ready["graph_replays"] != \
            stats["steps_done"] - at_ready["steps_done"]:
        fail(f"serve_paged: decode graphs {graph_stats} after the traffic, "
             f"{at_ready} at ready: a chunk ran eagerly, a window was "
             f"captured during the traffic, or a step was not a replay")
    if kvs["prefix_hit_tokens"] <= 0:
        fail("serve_paged: no prefix hit on the radix cache")
    long_segs = [s for s in segments if s[2] == len(prompts["long_3000"]) - 1]
    chunks_during_long = long_segs[-1][3] - long_segs[0][3]
    if len(long_segs) != 6 or chunks_during_long <= 0:
        fail(f"serve_paged: the long prompt took {len(long_segs)} segments "
             f"with {chunks_during_long} decode chunks between them, want 6 "
             f"segments interleaved with decode")

    logit_rows = _hold_final_logits(torch, tf, model, "serve_paged",
                                    prompts, results, finals)
    witness = segment_witness(torch, tf, attention, model, engine,
                              prompts["shared_0"], len(prefix),
                              _final_logits(finals, prompts["shared_0"]))
    n_chunks = max(stats["n_chunks"], 1)
    ttft = [{"prompt_len": n, "ttft_s": t} for n, t in engine.ttft_s]
    emit({
        "phase": "serve_paged", **card, "model": "llama3-8b",
        "n_layers": cfg.n_layers, "max_slots": engine.max_slots,
        "decode_chunk": engine.chunk, "prefill_chunk": engine.prefill_chunk,
        "kv_block_size": engine.kv.block_size,
        "kv_blocks": engine.kv.num_blocks,
        "requests": len(prompts) + 1, "burst_s": burst_s,
        "latency_s": latency, "ttft": ttft,
        "flash_fwd_launches": launches, "n_prefills": stats["n_prefills"],
        "n_chunks": stats["n_chunks"], "steps_done": stats["steps_done"],
        "occupied_steps": stats["occupied_steps"],
        "decode_tokens_per_s": stats["occupied_steps"]
        / max(stats["t_chunk_s"], 1e-9),
        "t_chunk_s": stats["t_chunk_s"], "t_prefill_s": stats["t_prefill_s"],
        "chunk_host_dispatch_ms": engine.t_chunk_dispatch_s / n_chunks * 1e3,
        "chunk_sync_wait_ms": engine.t_chunk_wait_s / n_chunks * 1e3,
        "chunk_device_ms": engine.t_chunk_device_s / n_chunks * 1e3,
        "prefill_host_dispatch_ms":
            engine.t_prefill_dispatch_s / stats["n_prefills"] * 1e3,
        "prefill_sync_wait_ms":
            engine.t_prefill_wait_s / stats["n_prefills"] * 1e3,
        "long_prompt_segments": len(long_segs),
        "chunks_during_long_prefill": chunks_during_long,
        "kv": kvs, "logits": logit_rows, "tol": SERVE_LOGITS_ATOL,
        "segment_witness": witness,
        "ready_s": ready_s, "warmup": warm, "warm_segments": warm_segments,
        "health_log": health,
        "graph_captures": graph_stats["graph_captures"],
        "graph_replays": graph_stats["graph_replays"],
        "graph_capture_s": graph_stats["graph_capture_s"],
        "graph_pool_gb": graph_stats["graph_pool_bytes"] / 1e9,
        "eager_chunks_on_cuda": graph_stats["eager_chunks_on_cuda"],
        "max_memory_allocated_gb": peak_gb,
    })
    return launches


# -- serve_tp: tensor-parallel serving, every rank in one process -------

# Llama-3-8B's widths at the demo manifest's --tp=8 (4 query and 1 key/value
# heads, d_ff 1792 a rank), SERVE_TP_LAYERS of its 32 layers, every rank
# held in this process (tensor_parallel.Axes.in_process): the shards'
# arithmetic and kernels at their shapes on one card. The NCCL transport
# is parallel/world_smoke.py's serve_tp, across cards.
SERVE_TP = 8
# 4 of the 32 layers, cut from 8 to keep the script inside its time limit
# once serve_moe came.
SERVE_TP_LAYERS = 4


def _serve_tp_traffic(np, vocab):
    """serve_paged's prompts (same seed): a 1024-token prefix, six prompts
    sharing it, a 3000-token prompt."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, 1024).tolist()
    prompts = {"prefix_1024": prefix}
    for i in range(6):
        prompts[f"shared_{i}"] = prefix + rng.integers(0, vocab, 64).tolist()
    prompts["long_3000"] = rng.integers(0, vocab, 3000).tolist()
    max_new = {name: 32 for name in prompts}
    max_new["prefix_1024"] = 8
    return prompts, max_new


def _serve_tp_engine(torch, serve_cli, attention, model, kv_cache, prompts,
                     max_new, warmup_mode, keep_logits=False,
                     speculate="off"):
    """``kv_cache``'s engine (serve_paged's settings, ``speculate``) on
    ``model`` behind the HTTP server under ``warmup_mode``, serve_paged's
    traffic order; prompts beyond serve_paged's are posted last, at once.
    Returns (streams, the engine's readings, the kept final-segment
    logits)."""
    kw = dict(kv_block_size=16) if kv_cache == "paged" else {}
    engine = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512, kv_cache=kv_cache,
        speculate=speculate, **kw)
    finals = []
    if keep_logits and kv_cache == "paged":
        paged_prefill = engine._paged_prefill

        def prefill_keeping_logits(*args, want_logits=False, **kwargs):
            if not want_logits:
                return paged_prefill(*args, want_logits=False, **kwargs)
            tok, logits = paged_prefill(*args, want_logits=True,
                                        return_logits=True, **kwargs)
            finals.append((args[2], args[3], args[6], logits))
            return tok

        engine._paged_prefill = prefill_keeping_logits
    results = {}
    server, state = serve_cli.start_server(engine, port=0, host="127.0.0.1",
                                           warmup_mode=warmup_mode)
    try:
        t0 = time.perf_counter()
        serve_cli.wait_ready(state, timeout=600)
        ready_s = time.perf_counter() - t0
        at_ready = {"launches": attention.flash_fwd_launches,
                    "n_prefills": engine.stats()["n_prefills"],
                    "steps_done": engine.stats()["steps_done"],
                    **engine.graph_stats()}
        port = server.server_address[1]

        def post(name):
            results[name] = serve_cli.post_generate(
                port, [prompts[name]], max_new[name])["tokens"][0]

        post("prefix_1024")
        with concurrent.futures.ThreadPoolExecutor(7) as pool:
            futures = [pool.submit(post, f"shared_{i}") for i in range(6)]
            chunks = engine.stats()["n_chunks"]
            deadline = time.monotonic() + 600
            while engine.stats()["n_chunks"] == chunks and \
                    time.monotonic() < deadline:
                time.sleep(0.002)
            futures.append(pool.submit(post, "long_3000"))
            for f in futures:
                f.result(timeout=600)
        rest = [n for n in prompts if n not in results]
        if rest:
            with concurrent.futures.ThreadPoolExecutor(len(rest)) as pool:
                for f in [pool.submit(post, n) for n in rest]:
                    f.result(timeout=600)
    finally:
        server.shutdown()
        server.server_close()
    stats = engine.stats()
    readings = {
        "ready_s": ready_s, "at_ready": at_ready,
        "launches": attention.flash_fwd_launches,
        "n_prefills": stats["n_prefills"], "n_chunks": stats["n_chunks"],
        "steps_done": stats["steps_done"],
        "ttft_s": [{"prompt_len": n, "ttft_s": t} for n, t in engine.ttft_s],
        "chunk_device_ms_per_step": engine.t_chunk_device_s
        / max(stats["steps_done"], 1) * 1e3,
        "decode_tokens_per_s": stats["occupied_steps"]
        / max(stats["t_chunk_s"], 1e-9),
        **engine.graph_stats(),
    }
    if speculate != "off":
        readings.update({k: stats[k] for k in (
            "spec_verifies", "spec_proposed", "spec_accepted")})
        readings["verify_device_ms"] = engine.t_verify_device_s / max(
            stats["spec_verifies"], 1) * 1e3
    engine.shutdown()
    return results, readings, finals


def _margin_partings(torch, tf, ref, prompts, got, want, phase,
                     routes=None):
    """Where ``got``'s streams part from the reference's, each held to
    serve_spec's rule: only where the reference's top-2 margin is under
    SERVE_LOGITS_ATOL. An MoE model's parting past it is held by
    world_smoke's router rule instead: ``routes(context)`` gives (the
    got path's, the reference's) routing of the shared context
    (``world_smoke.routing``), which may differ only at router ties
    (``world_smoke.router_ties``). Returns the partings."""
    from container_engine_accelerators_tpu_torch.parallel import world_smoke

    names = list(prompts)
    rows = _divergences(torch, tf, ref, [prompts[n] for n in names],
                        [got[n] for n in names], [want[n] for n in names])
    for r in rows:
        r["request"] = names[r["request"]]
        if routes is not None and r["want_margin"] >= SERVE_LOGITS_ATOL:
            context = want[r["request"]][:len(prompts[r["request"]])
                                         + r["generated_index"]]
            r["router"] = world_smoke.router_ties(*routes(context))
    bad = [r for r in rows if r["want_margin"] >= SERVE_LOGITS_ATOL
           and not r.get("router", {}).get("router_tie")]
    if bad:
        emit({"phase": f"{phase}_partings", "partings": rows})
        fail(f"{phase}: a stream parts from the unsplit engine's where its "
             f"top-2 margin is {SERVE_LOGITS_ATOL} or more: {bad}")
    return rows


def _prefill_logits(torch, tf, model, prompt, overlap=None):
    with torch.inference_mode():
        logits, _ = tf.prefill(model.model, torch.as_tensor(
            [prompt], device=model.device), return_logits=True,
            overlap=overlap)
    return logits[0].float()


def _logit_row(torch, got, want):
    """(max |got - want|, want's top-2 margin, the argmaxes agree)."""
    top2 = want.topk(2).values
    return {"max_abs_err": (got - want).abs().max().item(),
            "want_margin": (top2[0] - top2[1]).item(),
            "argmax_equal": int(got.argmax()) == int(want.argmax())}


def _hold_logit_row(row, phase, what):
    if row["max_abs_err"] > SERVE_LOGITS_ATOL or (
            not row["argmax_equal"]
            and row["want_margin"] >= SERVE_LOGITS_ATOL):
        emit({"phase": phase, what: row})
        fail(f"{phase}: {what} logits outside SERVE_LOGITS_ATOL "
             f"{SERVE_LOGITS_ATOL} or a decided argmax differs")


def _serve_tp_spec_traffic(np, vocab, prompts, max_new):
    """serve_paged's traffic and two of serve_spec's requests (a 32-token
    pattern of its own repeated to 512 tokens, SPEC_NEW new tokens), so
    the ngram proposer has something to propose whatever the random
    weights generate."""
    rng = np.random.default_rng(7)
    prompts, max_new = dict(prompts), dict(max_new)
    for i in range(2):
        pattern = rng.integers(0, vocab, SPEC_PATTERN)
        prompts[f"pattern_{i}"] = np.tile(
            pattern, SPEC_PROMPT // SPEC_PATTERN).tolist()
        max_new[f"pattern_{i}"] = SPEC_NEW
    return prompts, max_new


def _tp_handoff(torch, tf, serve_cli, model, ref, prompts, new):
    """A KV handoff round trip between the tp engine and the unsplit one
    (paged, serve_paged's settings): each donor serves its prompt, exports
    it on JAX's wire, the other installs it and serves the same prompt
    from the installed blocks; every continuation is held to its donor's
    stream by the margin rule. Returns the readings."""
    def engine(m):
        return serve_cli.ContinuousEngine(
            m, max_slots=8, chunk=32, prefill_chunk=512, kv_cache="paged",
            kv_block_size=16)

    tp_eng, un_eng = engine(model), engine(ref)
    out = {}
    try:
        for name, donor, taker in (("tp_to_unsplit", tp_eng, un_eng),
                                   ("unsplit_to_tp", un_eng, tp_eng)):
            prompt = prompts[name]
            want = donor.generate([prompt], new)[0]
            t0 = time.perf_counter()
            frames = donor.kv_export(prompt, timeout_s=120)
            export_s = time.perf_counter() - t0
            hit0 = taker.kv_stats()["prefix_hit_tokens"]
            t0 = time.perf_counter()
            installed = taker.kv_install(frames, timeout_s=120)
            install_s = time.perf_counter() - t0
            got = taker.generate([prompt], new)[0]
            hit = taker.kv_stats()["prefix_hit_tokens"] - hit0
            blocks = installed["installed_blocks"]
            out[name] = {"prompt_len": len(prompt), "blocks": blocks,
                         "nbytes": installed["nbytes"], "export_s": export_s,
                         "install_s": install_s, "prefix_hit_tokens": hit,
                         "partings": _margin_partings(
                             torch, tf, ref, {name: prompt}, {name: got},
                             {name: want}, f"serve_tp_handoff_{name}")}
            # An admission reuses at most len - 1 tokens, in whole blocks.
            if blocks != len(prompt) // 16 or \
                    hit < 16 * ((len(prompt) - 1) // 16):
                fail(f"serve_tp handoff {name}: {blocks} blocks installed, "
                     f"{hit} prefix tokens reused, for a "
                     f"{len(prompt)}-token prompt")
    finally:
        tp_eng.shutdown()
        un_eng.shutdown()
    return out


SERVE_TP_MOE_LAYERS = 4


def _serve_tp_moe(torch, np, tf, serve_cli, attention):
    """The MoE engine under tp: Mixtral-8x7B's widths (``mixtral_config``)
    at 4 of its 32 layers, tp 8 in this process (each rank 4/1 heads and
    1792 of every expert's 14336 columns, the router whole): the paged
    engine under ``--warmup=all`` on serve_paged's traffic against the
    unsplit paged engine on the same weights by the margin rule, every
    decode step a replay; a parting past the margin held by the router
    rule. Returns (flash launches, its row)."""
    from container_engine_accelerators_tpu_torch.parallel import world_smoke

    cfg = mixtral_config(tf, SERVE_TP_MOE_LAYERS)
    whole = tf.init_params(cfg, device="cuda", seed=0)
    ref = serve_cli.Model(cfg, weights=whole)
    model = serve_cli.Model(cfg, weights=whole, tp=SERVE_TP)
    ffn = model.model.shards[0].layers[0].ffn
    shapes = {k: tuple(getattr(ffn, k).shape) for k in ("router", "w1", "w2")}
    prompts, max_new = _serve_tp_traffic(np, cfg.vocab_size)
    before = attention.flash_fwd_launches
    got, r, _ = _serve_tp_engine(torch, serve_cli, attention, model, "paged",
                                 prompts, max_new, "all")
    launches = attention.flash_fwd_launches - before
    per_call = cfg.n_layers * SERVE_TP
    served = r["n_prefills"] - r["at_ready"]["n_prefills"]
    if r["launches"] - r["at_ready"]["launches"] != per_call * served:
        fail(f"serve_tp moe: {r['launches'] - r['at_ready']['launches']} "
             f"flash launches for {served} prefill calls, want {per_call} "
             f"(layers × tp) each")
    replays = _held_replays("serve_tp moe", r)
    del model
    _free(torch)
    want, _, _ = _serve_tp_engine(torch, serve_cli, attention, ref, "paged",
                                  prompts, max_new, "lazy")
    model = serve_cli.Model(cfg, weights=whole, tp=SERVE_TP)

    def routes(context):
        return (world_smoke.routing(torch, tf, model, context),
                world_smoke.routing(torch, tf, ref, context))

    partings = _margin_partings(torch, tf, ref, prompts, got, want,
                                "serve_tp_moe", routes)
    del model
    del ref, whole
    _free(torch)
    return launches, {
        "n_layers": cfg.n_layers, "tp": SERVE_TP, "shard_shapes": shapes,
        "ready_s": r["ready_s"], "ttft_s": r["ttft_s"],
        "chunk_device_ms_per_step": r["chunk_device_ms_per_step"],
        "replays_during_traffic": replays, "partings": partings,
        "flash_fwd_launches": launches}


def serve_tp_phase(torch, np, tf, serve_cli, attention, int8_matmul, card):
    """Tensor-parallel serving at Llama-3-8B's full width, tp 8 (the demo
    manifest's ``--tp=8``: 4 query and 1 key/value heads, d_ff 1792 a
    rank), 4 of its 32 layers in bf16, every rank's shard in this process
    (``serve_cli.Model(tp=8)`` over ``tensor_parallel.Axes.in_process``):
    the dense and the paged engine under ``--warmup=all`` with
    serve_paged's traffic, against the unsplit engines on the same
    weights and depth. Holds: greedy streams equal wherever the unsplit
    top-2 margin is SERVE_LOGITS_ATOL or more (every parting printed),
    the paged engine's final-segment logits within SERVE_LOGITS_ATOL of
    the unsplit forward, the ring prefill against the off prefill (a
    2048-token prompt, divisible by 8) and both against the unsplit
    prefill, int8 under tp against unsplit int8 (``Model.generate``), the
    flash kernel launched layers × tp times a prefill call, and every
    decode step a replay (one graph holds the 8 ranks' steps). The paged
    tp engine under ``--speculate ngram`` (serve_paged's traffic and two
    of serve_spec's pattern requests) is held to the unsplit
    non-speculating engine by the same margin rule, its verify rounds
    replays of captured graphs (the flash kernel at 4 query and 1
    key/value heads a rank, per-row bases in device memory); a KV handoff
    round trip (tp to unsplit and back, JAX's wire) serves each prompt
    from the installed blocks to its donor's stream. Last, an MoE engine
    at tp 8 against the unsplit one (``_serve_tp_moe``). TTFT and ms a decode
    step are in-process figures (8 ranks' kernels on one card), no
    cross-card number. Returns (flash launches, int8 launches) of the tp
    paths."""
    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=SERVE_TP_LAYERS)
    per_call = cfg.n_layers * SERVE_TP
    whole = tf.init_params(cfg, device="cuda", seed=0)
    ref = serve_cli.Model(cfg, weights=whole)
    model = serve_cli.Model(cfg, weights=whole, tp=SERVE_TP)
    shard = model.model.shards[0].layers[0]
    shapes = {"wq": tuple(shard.attn.wq.shape),
              "wk": tuple(shard.attn.wk.shape),
              "w1": tuple(shard.ffn.w1.shape),
              "w2": tuple(shard.ffn.w2.shape),
              "kv_heads_per_rank": cfg.n_kv_heads // SERVE_TP}
    prompts, max_new = _serve_tp_traffic(np, cfg.vocab_size)

    # The main path: counts at zero, the tp engines' warm grids and
    # traffic, counts read.
    attention.flash_fwd_launches = 0
    attention.flash_dq_launches = attention.flash_dkv_launches = 0
    runs, finals = {}, None
    for kv in ("dense", "paged"):
        got, readings, kept = _serve_tp_engine(
            torch, serve_cli, attention, model, kv, prompts, max_new, "all",
            keep_logits=True)
        runs[kv] = (got, readings)
        if kv == "paged":
            finals = kept
        _free(torch)
    spec_prompts, spec_new = _serve_tp_spec_traffic(np, cfg.vocab_size,
                                                    prompts, max_new)
    got, readings, _ = _serve_tp_engine(
        torch, serve_cli, attention, model, "paged", spec_prompts, spec_new,
        "all", speculate="ngram")
    runs["paged_spec"] = (got, readings)
    _free(torch)
    # Verify launches run inside the verify graphs' replays: layers × tp
    # flash launches each, counted at capture, not at replay.
    verify_replays = readings["verify_graph_replays"] - \
        readings["at_ready"]["verify_graph_replays"]
    verify_launches = per_call * verify_replays
    flash_launches = attention.flash_fwd_launches + verify_launches
    if attention.flash_dq_launches or attention.flash_dkv_launches:
        fail("serve_tp: a backward kernel launched while serving")
    if not readings["spec_verifies"] or \
            verify_replays != readings["spec_verifies"]:
        fail(f"serve_tp paged_spec: {readings['spec_verifies']} verifies, "
             f"{verify_replays} verify replays")
    for kv, (got, r) in runs.items():
        traffic = spec_prompts if kv == "paged_spec" else prompts
        for name, prompt in traffic.items():
            _check_response(f"serve_tp {kv} {name}", {"tokens": [got[name]]},
                            prompt, spec_new[name], cfg.vocab_size)
        served = r["n_prefills"] - r["at_ready"]["n_prefills"]
        if r["launches"] - r["at_ready"]["launches"] != per_call * served:
            fail(f"serve_tp {kv}: {r['launches'] - r['at_ready']['launches']}"
                 f" flash launches outside graphs for {served} prefill "
                 f"calls, want {per_call} (layers × tp) each")
        replays = r["graph_replays"] + r.get("verify_graph_replays", 0) - \
            r["at_ready"]["graph_replays"] - \
            r["at_ready"].get("verify_graph_replays", 0)
        if r["eager_chunks_on_cuda"] or r.get("eager_verifies_on_cuda") or \
                r["graph_captures"] != r["at_ready"]["graph_captures"] or \
                r.get("verify_graph_captures") != \
                r["at_ready"].get("verify_graph_captures") or \
                replays != r["steps_done"] - r["at_ready"]["steps_done"]:
            fail(f"serve_tp {kv}: a decode step or a verify ran eagerly or "
                 f"a graph was captured during the traffic: {r}")

    # The reference: the unsplit engines on the same weights and depth.
    partings = {}
    for kv in ("dense", "paged"):
        want, _, _ = _serve_tp_engine(torch, serve_cli, attention, ref, kv,
                                      prompts, max_new, "lazy")
        partings[kv] = _margin_partings(torch, tf, ref, prompts,
                                        runs[kv][0], want, f"serve_tp_{kv}")
        _free(torch)
    # The speculating engine against the unsplit paged engine's streams
    # (the same requests, in the same batches) and, for the pattern
    # requests posted after them, the unsplit Model.generate's.
    want.update({n: ref.generate([spec_prompts[n]], spec_new[n])[0]
                 for n in spec_prompts if n not in prompts})
    partings["paged_spec"] = _margin_partings(
        torch, tf, ref, spec_prompts, runs["paged_spec"][0], want,
        "serve_tp_paged_spec")
    _free(torch)
    handoff = _tp_handoff(
        torch, tf, serve_cli, model, ref,
        {"tp_to_unsplit": spec_prompts["shared_0"][:512],
         "unsplit_to_tp": spec_prompts["long_3000"][:512]}, 32)
    _free(torch)
    logit_rows = _hold_final_logits(torch, tf, ref, "serve_tp", prompts,
                                    {n: {"tokens": [s]} for n, s in
                                     runs["paged"][0].items()}, finals)

    # The ring prefill against the off one and both against the unsplit.
    rng = np.random.default_rng(11)
    p2048 = rng.integers(0, cfg.vocab_size, 2048).tolist()
    unsplit = _prefill_logits(torch, tf, ref, p2048)
    ring = _prefill_logits(torch, tf, model, p2048, overlap="ring")
    off = _prefill_logits(torch, tf, model, p2048, overlap="off")
    prefill_rows = {"ring_vs_off": _logit_row(torch, ring, off),
                    "ring_vs_unsplit": _logit_row(torch, ring, unsplit),
                    "off_vs_unsplit": _logit_row(torch, off, unsplit)}
    for what, row in prefill_rows.items():
        _hold_logit_row(row, "serve_tp_prefill", what)
    del model, ref
    _free(torch)

    # int8 under tp against unsplit int8 on the same weights (the tp
    # shards quantize first: the unsplit quantization is in place).
    int8_matmul.int8_mm_launches = int8_matmul.int8_mm_captured = 0
    tp8 = serve_cli.Model(cfg, weights=whole, tp=SERVE_TP, quantize="int8")
    int8_prompts = {"p512": p2048[:512], "p1500": p2048[:1500]}
    int8_got = {n: tp8.generate([p], 16)[0] for n, p in int8_prompts.items()}
    graphs = tp8.decode_graphs.graphs
    per_step = 7 * cfg.n_layers * SERVE_TP
    int8_launches = int8_matmul.int8_mm_launches + per_step * graphs.replays
    if int8_matmul.int8_mm_captured != per_step * graphs.captures or \
            not int8_matmul.int8_mm_launches:
        fail(f"serve_tp int8: {int8_matmul.int8_mm_captured} products "
             f"captured in {graphs.captures} graphs (want {per_step} each), "
             f"{int8_matmul.int8_mm_launches} eager")
    int8_tp_logits = _prefill_logits(torch, tf, tp8, int8_prompts["p512"])
    ref8 = serve_cli.Model(cfg, weights=whole, quantize="int8")
    int8_want = {n: ref8.generate([p], 16)[0]
                 for n, p in int8_prompts.items()}
    int8_partings = _margin_partings(torch, tf, ref8, int8_prompts,
                                     int8_got, int8_want, "serve_tp_int8")
    int8_row = _logit_row(torch, int8_tp_logits, _prefill_logits(
        torch, tf, ref8, int8_prompts["p512"]))
    _hold_logit_row(int8_row, "serve_tp_int8", "prefill")
    del tp8, ref8, whole
    _free(torch)
    moe_launches, moe_row = _serve_tp_moe(torch, np, tf, serve_cli,
                                          attention)
    flash_launches += moe_launches

    def figures(r):
        return {k: r[k] for k in (
            "ready_s", "n_prefills", "n_chunks", "steps_done", "ttft_s",
            "chunk_device_ms_per_step", "decode_tokens_per_s",
            "graph_captures", "graph_replays", "graph_pool_bytes")}

    emit({"phase": "serve_tp", **card, "model": "llama3-8b",
          "n_layers": cfg.n_layers, "tp": SERVE_TP, "shard_shapes": shapes,
          "in_process": True,
          "note": "every rank in one process on one card: TTFT and decode "
                  "ms are in-process figures, not cross-card ones; one "
                  "graph holds all 8 ranks' steps",
          "dense": figures(runs["dense"][1]),
          "paged": figures(runs["paged"][1]),
          "paged_spec": {**figures(runs["paged_spec"][1]), **{
              k: runs["paged_spec"][1][k] for k in (
                  "spec_verifies", "spec_proposed", "spec_accepted",
                  "verify_device_ms", "verify_graph_replays")}},
          "verify_flash_launches": verify_launches, "handoff": handoff,
          "partings": partings, "final_logits": logit_rows,
          "prefill_logits": prefill_rows, "int8_partings": int8_partings,
          "int8_prefill_logits": int8_row, "tol": SERVE_LOGITS_ATOL,
          "moe": moe_row, "flash_fwd_launches": flash_launches,
          "int8_mm_launches": int8_launches})
    return flash_launches, int8_launches


SERVE_MOE_LAYERS = 8
SERVE_MOE_FULL_LAYERS = 32
SERVE_MOE_NEW = 32


@contextlib.contextmanager
def plain_attention(tf, attention):
    """Inside the block the serving programs' flash calls (prefill,
    segments, verify; ``transformer.flash_attention`` and
    ``transformer.flash_fwd``) run the plain version on the card
    (``flash_fwd_reference``): the reference the MoE streams are held to,
    the same programs on the same routing groups. The port itself never
    does this."""
    fwd, attn = tf.flash_fwd, tf.flash_attention

    def plain(q, k, v, causal=True, sm_scale=None):
        return attention.flash_fwd_reference(
            q, k, v, causal=causal,
            sm_scale=sm_scale or q.shape[-1] ** -0.5)[0]

    tf.flash_fwd, tf.flash_attention = attention.flash_fwd_reference, plain
    try:
        yield
    finally:
        tf.flash_fwd, tf.flash_attention = fwd, attn


def _moe_latency(model, prompt):
    """``Model.generate``'s TTFT (a one-token request) and ms a token
    (32 new tokens, the second run: its decode steps replay the graph
    the first captured) for ``prompt``."""
    walls = {}
    for name, n in (("ttft", 1), ("first", SERVE_MOE_NEW),
                    ("again", SERVE_MOE_NEW)):
        t0 = time.perf_counter()
        model.generate([prompt], n)
        walls[name] = time.perf_counter() - t0
    return {"prompt_len": len(prompt), "ttft_s": walls["ttft"],
            "decode_ms_per_token": (walls["again"] - walls["ttft"])
            / (SERVE_MOE_NEW - 1) * 1e3}


def _moe_generate(model, prompts, max_new):
    """``Model.generate`` of each prompt in turn → ({name: stream},
    {name: seconds})."""
    streams, wall = {}, {}
    for name, prompt in prompts.items():
        t0 = time.perf_counter()
        streams[name] = model.generate([prompt], max_new[name])[0]
        wall[name] = time.perf_counter() - t0
    return streams, wall


def _held_replays(phase, r):
    """Every decode step (and verify) of an engine run after its warm grid
    a replay of a graph captured before the traffic; none eager."""
    replays = r["graph_replays"] + r.get("verify_graph_replays", 0) - \
        r["at_ready"]["graph_replays"] - \
        r["at_ready"].get("verify_graph_replays", 0)
    if r["eager_chunks_on_cuda"] or r.get("eager_verifies_on_cuda") or \
            replays != r["steps_done"] - r["at_ready"]["steps_done"]:
        fail(f"{phase}: a decode step or a verify ran eagerly: {r}")
    return replays


def moe_small_parity(torch, np, tf, serve_cli, attention):
    """A small f32 MoE model (head dim 128, the f32 kernel) on the card,
    its capacity factor E / k so that no group drops a token and every
    token routes as it would alone: the paged engine's greedy tokens
    equal the dense ``Model.generate``'s exactly, for shared prefixes, a
    prompt prefilled in three segments and a one-token request."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=256,
                               max_seq_len=128, dtype="float32",
                               n_experts=4, expert_top_k=2,
                               capacity_factor=2.0)
    model = serve_cli.Model(cfg, seed=1, device="cuda")
    engine = serve_cli.ContinuousEngine(model, max_slots=2, chunk=4,
                                        prefill_chunk=32, kv_block_size=16,
                                        kv_cache="paged")
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 40).tolist()
    cases = [(prefix + rng.integers(0, cfg.vocab_size, 3 + i).tolist(), 8)
             for i in range(3)]
    cases += [(rng.integers(0, cfg.vocab_size, 70).tolist(), 10),
              (prefix[:5], 1)]
    before = attention.flash_fwd_launches
    try:
        outs = [engine.generate([p], n)[0] for p, n in cases]
    finally:
        engine.shutdown()
    launches = attention.flash_fwd_launches - before
    equal = [got == model.generate([p], n)[0]
             for (p, n), got in zip(cases, outs)]
    kvs = engine.kv_stats()
    row = {"phase": "moe_small_parity", "requests": len(cases),
           "tokens_equal": equal, "kernel_launches": launches,
           "n_prefills": engine.stats()["n_prefills"],
           "prefix_hit_tokens": kvs["prefix_hit_tokens"]}
    emit(row)
    if not all(equal) or launches != cfg.n_layers * row["n_prefills"] or \
            kvs["prefix_hit_tokens"] <= 0:
        fail("moe_small_parity: the f32 MoE paged engine on the card "
             "disagrees with dense generate, or skipped the kernel or the "
             "radix cache")


def _moe_full_depth(torch, np, tf, serve_cli, attention, card):
    """Mixtral-8x7B at its full 32 layers (about 63 GB of bf16 weights)
    behind the HTTP server: one 1500-token prompt, its TTFT (a one-token
    request), then 32 new tokens twice (the second replays the captured
    decode graph: its time is the served one), ms a token, the peak of
    allocated memory. Returns the flash launches."""
    cfg = mixtral_config(tf, SERVE_MOE_FULL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve_cli.Model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = weight_bytes(model.model) / 1e9
    prompt = np.random.default_rng(13).integers(
        0, cfg.vocab_size, 1500).tolist()
    before = attention.flash_fwd_launches
    server, state = serve_cli.start_server(model, port=0, host="127.0.0.1")
    try:
        serve_cli.wait_ready(state, timeout=600)
        port = server.server_address[1]
        out = {name: serve_cli.post_generate(port, [prompt], n)
               for name, n in (("ttft", 1), ("first", SERVE_MOE_NEW),
                               ("again", SERVE_MOE_NEW))}
    finally:
        server.shutdown()
        server.server_close()
    launches = attention.flash_fwd_launches - before
    for name, n in (("ttft", 1), ("again", SERVE_MOE_NEW)):
        _check_response(f"serve_moe full {name}", out[name], prompt, n,
                        cfg.vocab_size)
    if out["first"]["tokens"] != out["again"]["tokens"]:
        fail("serve_moe full: the same greedy request gave other tokens")
    # The warmup prefill and three requests: one prefill each.
    if launches != 4 * cfg.n_layers:
        fail(f"serve_moe full: {launches} flash launches, want "
             f"{4 * cfg.n_layers} (one a layer for 4 prefills)")
    ttft = out["ttft"]["latency_s"]
    graphs = model.decode_graphs.graphs
    row = {"n_layers": cfg.n_layers, "init_s": init_s,
           "weights_gb": weights_gb, "prompt_len": len(prompt),
           "ttft_s": ttft,
           "decode_ms_per_token": (out["again"]["latency_s"] - ttft)
           / (SERVE_MOE_NEW - 1) * 1e3,
           "decode_ms_per_token_with_capture":
               (out["first"]["latency_s"] - ttft) / (SERVE_MOE_NEW - 1)
               * 1e3,
           "bound_ms_per_token": weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 1e9,
           "graph_captures": graphs.captures,
           "graph_replays": graphs.replays,
           "flash_fwd_launches": launches}
    del model, server, state
    _free(torch)
    return row


def serve_moe_phase(torch, np, tf, serve_cli, attention, int8_matmul, card):
    """A mixture-of-experts model served at Mixtral-8x7B's widths
    (``mixtral_config``: d 4096, 32/8 heads, d_ff 14336, 8 experts, top-2,
    vocab 32000, the JAX package's GELU experts; bf16, random weights
    from seed 0), reached as in JAX through ``Model(cfg)``. At 8 of its
    32 layers (about 15.9 GB): serve_paged's traffic through
    ``Model.generate``, the dense engine, the paged engine under
    ``--warmup=all`` and the paged engine under ``--speculate ngram``
    (two pattern requests more), each held to the same path on the plain
    attention (the same model, programs and routing groups:
    ``plain_attention``) by the margin rule (a parting past the margin
    by world_smoke's router rule: the two attentions may route the
    shared context apart only at router ties), every decode step and
    verify a replay; then ``--quantize int8`` (the attention projections the
    ``int8_mm`` kernel, the experts bf16) held to the plain int8 model on
    the plain attention. Then at the full 32 layers
    (``_moe_full_depth``). First ``moe_small_parity``. Returns (flash
    launches, int8 launches) of the main path."""
    from container_engine_accelerators_tpu_torch.parallel import world_smoke

    moe_small_parity(torch, np, tf, serve_cli, attention)
    cfg = mixtral_config(tf, SERVE_MOE_LAYERS)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve_cli.Model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = weight_bytes(model.model) / 1e9
    prompts, max_new = _serve_tp_traffic(np, cfg.vocab_size)
    spec_prompts, spec_new = _serve_tp_spec_traffic(np, cfg.vocab_size,
                                                    prompts, max_new)

    # The main path: counts at zero, the four bf16 paths, counts read.
    attention.flash_fwd_launches = 0
    attention.flash_dq_launches = attention.flash_dkv_launches = 0
    graphs = model.decode_graphs.graphs
    replays0 = graphs.replays
    got, readings = {}, {}
    got["generate"], walls = _moe_generate(model, prompts, max_new)
    generate_launches = attention.flash_fwd_launches
    generate_replays = graphs.replays - replays0
    if generate_launches != cfg.n_layers * len(prompts) or \
            generate_replays != sum(n - 1 for n in max_new.values()):
        fail(f"serve_moe generate: {generate_launches} flash launches for "
             f"{len(prompts)} prefills of {cfg.n_layers} layers, "
             f"{generate_replays} decode replays")
    for kv, traffic, new, spec in (("dense", prompts, max_new, "off"),
                                   ("paged", prompts, max_new, "off"),
                                   ("paged_spec", spec_prompts, spec_new,
                                    "ngram")):
        got[kv], readings[kv], _ = _serve_tp_engine(
            torch, serve_cli, attention, model, kv.split("_")[0], traffic,
            new, "all", speculate=spec)
        _free(torch)
    spec = readings["paged_spec"]
    verify_replays = spec["verify_graph_replays"] - \
        spec["at_ready"]["verify_graph_replays"]
    flash_launches = attention.flash_fwd_launches + \
        cfg.n_layers * verify_replays
    if attention.flash_dq_launches or attention.flash_dkv_launches:
        fail("serve_moe: a backward kernel launched while serving")
    if not spec["spec_verifies"] or verify_replays != spec["spec_verifies"]:
        fail(f"serve_moe paged_spec: {spec['spec_verifies']} verifies, "
             f"{verify_replays} verify replays")
    for kv, r in readings.items():
        traffic, new = (spec_prompts, spec_new) if kv == "paged_spec" \
            else (prompts, max_new)
        for name, prompt in traffic.items():
            _check_response(f"serve_moe {kv} {name}",
                            {"tokens": [got[kv][name]]}, prompt, new[name],
                            cfg.vocab_size)
        served = r["n_prefills"] - r["at_ready"]["n_prefills"]
        if r["launches"] - r["at_ready"]["launches"] != \
                cfg.n_layers * served:
            fail(f"serve_moe {kv}: {r['launches'] - r['at_ready']['launches']}"
                 f" flash launches outside graphs for {served} prefill "
                 f"calls, want {cfg.n_layers} each")
        r["replays_during_traffic"] = _held_replays(f"serve_moe {kv}", r)

    # The reference: each path again on the plain attention.
    want, partings = {}, {}
    with plain_attention(tf, attention):
        want["generate"], _ = _moe_generate(model, prompts, max_new)
        for kv, traffic, new, spec_mode in (
                ("dense", prompts, max_new, "off"),
                ("paged", prompts, max_new, "off"),
                ("paged_spec", spec_prompts, spec_new, "ngram")):
            want[kv], _, _ = _serve_tp_engine(
                torch, serve_cli, attention, model, kv.split("_")[0],
                traffic, new, "lazy", speculate=spec_mode)
            _free(torch)
    def routes(context):
        return (world_smoke.routing(torch, tf, model, context),
                world_smoke.routing(torch, tf, model, context,
                                    plain_attention(tf, attention)))

    for path in want:
        traffic = spec_prompts if path == "paged_spec" else prompts
        partings[path] = _margin_partings(torch, tf, model, traffic,
                                          got[path], want[path],
                                          f"serve_moe_{path}", routes)
    _free(torch)
    latency = _moe_latency(model, prompts["long_3000"][:1500])
    latency["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9

    # int8: the attention projections quantized in place (the experts
    # stay bf16), generate held to the plain int8 model on the plain
    # attention.
    int8_matmul.int8_mm_launches = int8_matmul.int8_mm_captured = 0
    q8model = serve_cli.Model(cfg, weights=model.model, quantize="int8")
    del model
    _free(torch)
    int8_prompts = {"prefix_1024": prompts["prefix_1024"],
                    "p1500": prompts["long_3000"][:1500]}
    int8_new = {n: SERVE_MOE_NEW for n in int8_prompts}
    int8_got, int8_walls = _moe_generate(q8model, int8_prompts,
                                         int8_new)
    graphs = q8model.decode_graphs.graphs
    per_step = 4 * cfg.n_layers
    int8_launches = int8_matmul.int8_mm_launches + per_step * graphs.replays
    if int8_matmul.int8_mm_captured != per_step * graphs.captures or \
            int8_matmul.int8_mm_launches != per_step * len(int8_prompts):
        fail(f"serve_moe int8: {int8_matmul.int8_mm_launches} eager "
             f"products for {len(int8_prompts)} prefills and "
             f"{int8_matmul.int8_mm_captured} captured in {graphs.captures} "
             f"graphs, want {per_step} (wq/wk/wv/wo a layer) each")
    # A Model of its own on the same int8 weights: its decode graphs are
    # captured with the plain product, where q8model's hold the kernel.
    ref8 = serve_cli.Model(cfg, weights=q8model.model)
    with plain_attention(tf, attention), plain_int8(int8_matmul):
        int8_want, _ = _moe_generate(ref8, int8_prompts, int8_new)
    def int8_routes(context):
        with plain_int8(int8_matmul):
            want = world_smoke.routing(torch, tf, ref8, context,
                                       plain_attention(tf, attention))
        return world_smoke.routing(torch, tf, q8model, context), want

    partings["int8"] = _margin_partings(torch, tf, q8model, int8_prompts,
                                        int8_got, int8_want, "serve_moe_int8",
                                        int8_routes)
    experts_dtype = str(q8model.model.layers[0].ffn.w1.dtype)
    del q8model, ref8
    _free(torch)

    full = _moe_full_depth(torch, np, tf, serve_cli, attention, card)

    def figures(r):
        return {k: r[k] for k in (
            "ready_s", "n_prefills", "n_chunks", "steps_done", "ttft_s",
            "chunk_device_ms_per_step", "decode_tokens_per_s",
            "graph_captures", "graph_replays", "replays_during_traffic",
            "eager_chunks_on_cuda")}

    emit({"phase": "serve_moe", **card, "model": "mixtral-8x7b widths",
          "n_layers": cfg.n_layers, "init_s": init_s,
          "weights_gb": weights_gb,
          "bound_ms_per_step": weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
          "latency": latency,
          "generate": {"wall_s": walls, "decode_replays": generate_replays},
          "dense": figures(readings["dense"]),
          "paged": figures(readings["paged"]),
          "paged_spec": {**figures(spec), **{k: spec[k] for k in (
              "spec_verifies", "spec_proposed", "spec_accepted",
              "verify_device_ms", "verify_graph_replays")}},
          "int8": {"wall_s": int8_walls, "experts_dtype": experts_dtype,
                   "int8_mm_launches": int8_launches},
          "partings": partings, "tol": SERVE_LOGITS_ATOL,
          "full_depth": full,
          "flash_fwd_launches": flash_launches + full["flash_fwd_launches"],
          "int8_mm_launches": int8_launches})
    return flash_launches + full["flash_fwd_launches"], int8_launches


# The attrs of JAX's warmup_done record (warmstart/warmup.py emit_done).
WARMUP_DONE_ATTRS = ("tasks", "compiled", "skipped", "dropped", "dur_s",
                     "cache_hits", "cache_misses")


def _held_health(path, engine, summary, phase):
    """The ready line in ``path`` (the server's ``--health-log``, read
    once ``/healthz`` is ready: the line is written just after) and the
    engine's one ``warmup_done`` record, whose attrs must equal the
    warmup summary's. Returns both."""
    deadline = time.monotonic() + 10
    while not (os.path.exists(path) and open(path).read()):
        if time.monotonic() > deadline:
            fail(f"{phase}: no ready line in --health-log after ready")
        time.sleep(0.01)
    text = open(path).read()
    if not re.fullmatch(r"tpu-serving ready warmup_s=\d+\.\d\n", text):
        fail(f"{phase}: --health-log holds {text!r}, want one JAX ready "
             f"line")
    done = engine.events.events("warmup_done")
    if len(done) != 1 or any(done[0].get(k) != summary[k]
                             for k in WARMUP_DONE_ATTRS):
        fail(f"{phase}: warmup_done records {done}, want one with the "
             f"summary's {WARMUP_DONE_ATTRS}: {summary}")
    return {"line": text.strip(),
            "warmup_done": {k: done[0][k] for k in WARMUP_DONE_ATTRS}}


def segment_witness(torch, tf, attention, model, engine, prompt, offset,
                    paged):
    """Where the logits of a segment at a reused offset part from the
    dense forward's on the same context (``paged``: the segment's kept
    logits). Reads, after the traffic:

      * the pool's pages of ``prompt`` (the radix index's blocks) against
        the dense forward's rope'd K/V: over the reused prefix [0,
        offset) in every layer, and over the segment's own rows in layer
        0, where only the norm and the projections at the segment's row
        count stand between the two;
      * a dense replay of the segment: the same rows through every layer
        at the segment's row count, ``flash_fwd`` at q_base ``offset``
        over the dense forward's prefix K/V, no pool involved; held
        against the paged logits and the dense ones.

    Equal pages and a replay equal to the paged logits put the gap in
    computing the segment's rows apart, not in the reused pages."""
    m, cfg = model.model, model.cfg
    ctx = torch.as_tensor([prompt], device="cuda")
    ids = engine.kv.radix.match(prompt)
    cached = len(ids) * engine.kv.block_size
    if cached < offset:
        fail(f"segment witness: {cached} tokens of the {offset}-token "
             f"reused prefix left in the radix index")
    with torch.inference_mode():
        dense, (ks, vs) = tf.forward(m, ctx, logits_at="last",
                                     return_kv=True)
        dense = dense[0, 0]
        ids = torch.as_tensor(ids, device="cuda")
        prefix_err, seg_err = 0.0, None
        for i in range(cfg.n_layers):
            for pool, ref in ((engine.cache["k"][i], ks[i]),
                              (engine.cache["v"][i], vs[i])):
                win = pool[ids].transpose(0, 1).reshape(
                    1, cfg.n_kv_heads, cached, cfg.head_dim)
                diff = (win.float() - ref[:, :, :cached].float()).abs()
                prefix_err = max(prefix_err,
                                 diff[:, :, :offset].max().item())
                if i == 0 and cached > offset:
                    seg_err = max(seg_err or 0.0,
                                  diff[:, :, offset:].max().item())
        positions = torch.arange(offset, len(prompt), device="cuda")[None]
        x = m.embed[ctx[:, offset:]]
        for i, layer in enumerate(m.layers):
            def attend(q, k, v, i=i):
                out, _ = attention.flash_fwd(
                    q, torch.cat([ks[i][:, :, :offset], k], dim=2),
                    torch.cat([vs[i][:, :, :offset], v], dim=2),
                    causal=True, sm_scale=1.0 / (cfg.head_dim ** 0.5),
                    q_base=offset, k_base=0,
                )
                return out
            x = layer(x, positions, attend)[0]
        replay = tf.lm_head(x[:, -1:], m.ln_f.weight, m.embed)[0, 0]
    return {
        "prompt_len": len(prompt), "offset": offset,
        "segment_rows": len(prompt) - offset, "cached_tokens": cached,
        "prefix_pages_vs_dense_max_abs": prefix_err,
        "segment_layer0_kv_vs_dense_max_abs": seg_err,
        "replay_vs_paged_max_abs": (replay - paged).abs().max().item(),
        "replay_vs_dense_max_abs": (replay - dense).abs().max().item(),
        "paged_vs_dense_max_abs": (paged - dense).abs().max().item(),
    }


def _hold_final_logits(torch, tf, model, phase, prompts, results, finals):
    """Each request's first token and kept final-segment logits vs the
    dense forward (the kernel at q_base 0 over the whole context) on the
    same context, within SERVE_LOGITS_ATOL: bf16, and the two place their
    q and K/V tiles differently (a segment's rows are computed apart from
    the rows before them). Returns the readings by request."""
    logit_rows = {}
    for name, prompt in prompts.items():
        kept = _final_logits(finals, prompt)
        with torch.inference_mode():
            dense = tf.forward(model.model,
                               torch.as_tensor([prompt], device="cuda"),
                               logits_at="last")[0, 0]
        first = results[name]["tokens"][0][len(prompt)]
        err = (kept - dense).abs().max().item()
        gap = (dense.max() - dense[first]).item()
        logit_rows[name] = {"max_abs_err": err, "dense_gap_of_first": gap,
                            "first_is_kept_argmax":
                                first == int(kept.argmax())}
        if not torch.isfinite(kept).all() or err > SERVE_LOGITS_ATOL or \
                gap > SERVE_LOGITS_ATOL or \
                not logit_rows[name]["first_is_kept_argmax"]:
            emit({"phase": f"{phase}_logits", name: logit_rows[name]})
            fail(f"{phase}: {name}'s final prefill-segment logits or first "
                 f"token disagree with the dense forward")
    return logit_rows


def _final_logits(finals, prompt):
    """The kept logits of the final prefill segment of ``prompt``."""
    for seg, off, true_pos, logits in finals:
        if true_pos + 1 == len(prompt) and \
                seg[0, :true_pos + 1 - off].tolist() == prompt[off:]:
            return logits
    fail(f"no final prefill segment kept for a {len(prompt)}-token prompt")


def paged_small_parity(torch, np, tf, serve_cli, attention):
    """A small f32 model (head dim 128, so the f32 kernel runs) on the
    card: the paged engine's greedy tokens equal the dense
    ``tf.generate``'s exactly, for shared prefixes, a prompt prefilled in
    three segments and a one-token request, submitted concurrently."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    model = serve_cli.Model(cfg, seed=1, device="cuda")
    engine = serve_cli.ContinuousEngine(model, max_slots=2, chunk=4,
                                        prefill_chunk=32, kv_block_size=16,
                                        kv_cache="paged")
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 40).tolist()
    cases = [(prefix + rng.integers(0, cfg.vocab_size, 3 + i).tolist(), 8)
             for i in range(3)]
    cases += [(rng.integers(0, cfg.vocab_size, 70).tolist(), 10),
              (prefix[:5], 1)]
    before = attention.flash_fwd_launches
    try:
        (first,) = engine.generate([cases[0][0]], cases[0][1])
        with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
            futures = [pool.submit(engine.generate, [p], n)
                       for p, n in cases[1:]]
            outs = [first] + [f.result(timeout=300)[0] for f in futures]
    finally:
        engine.shutdown()
    kvs = engine.kv_stats()
    launches = attention.flash_fwd_launches - before
    equal = []
    for (prompt, max_new), got in zip(cases, outs):
        want = tf.generate(model.model,
                           torch.as_tensor([prompt], device="cuda"),
                           max_new_tokens=max_new,
                           decoder=model.decode_graphs)[0].tolist()
        equal.append(got == want)
    row = {"phase": "paged_small_parity", "requests": len(cases),
           "tokens_equal": equal, "kernel_launches": launches,
           "n_prefills": engine.stats()["n_prefills"],
           "prefix_hit_tokens": kvs["prefix_hit_tokens"]}
    emit(row)
    if not all(equal) or launches != cfg.n_layers * row["n_prefills"] or \
            kvs["prefix_hit_tokens"] <= 0:
        fail("the f32 paged engine on the card disagrees with dense "
             "generate, or skipped the kernel or the radix cache")


def dense_small_parity(torch, np, tf, serve_cli, attention):
    """The small f32 model of ``paged_small_parity`` on the card: the
    dense engine (the default ``kv_cache``) returns exactly dense
    ``tf.generate``'s greedy tokens and the paged engine's, for requests
    submitted concurrently, more of them than slots: a prompt prefilled
    in three segments (its chunks under masked writes), shorter ones in
    one call, and a one-token request. Every prefill runs the kernel once
    per layer; every chunk replays its graph."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    model = serve_cli.Model(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(4)
    cases = [(rng.integers(0, cfg.vocab_size, 70).tolist(), 10)]
    cases += [(rng.integers(0, cfg.vocab_size, 3 + 9 * i).tolist(), 8 + i)
              for i in range(3)]
    cases.append((rng.integers(0, cfg.vocab_size, 5).tolist(), 1))
    outs, row = {}, {"phase": "dense_small_parity", "requests": len(cases)}
    for kv_cache in ("dense", "paged"):
        engine = serve_cli.ContinuousEngine(
            model, max_slots=2, chunk=4, prefill_chunk=32, kv_block_size=16,
            kv_cache=kv_cache)
        before = attention.flash_fwd_launches
        try:
            with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
                futures = [pool.submit(engine.generate, [p], n)
                           for p, n in cases]
                outs[kv_cache] = [f.result(timeout=300)[0] for f in futures]
        finally:
            engine.shutdown()
        stats, graphs = engine.stats(), engine.graph_stats()
        row[kv_cache] = {
            "kernel_launches": attention.flash_fwd_launches - before,
            "n_prefills": stats["n_prefills"], "n_chunks": stats["n_chunks"],
            "steps_done": stats["steps_done"],
            "graph_captures": graphs["graph_captures"],
            "graph_replays": graphs["graph_replays"],
            "eager_chunks_on_cuda": graphs["eager_chunks_on_cuda"],
        }
    want = [tf.generate(model.model, torch.as_tensor([p], device="cuda"),
                        max_new_tokens=n,
                        decoder=model.decode_graphs)[0].tolist()
            for p, n in cases]
    row["tokens_equal_generate"] = [a == b for a, b in
                                    zip(outs["dense"], want)]
    row["tokens_equal_paged"] = outs["dense"] == outs["paged"]
    emit(row)
    dense = row["dense"]
    if not all(row["tokens_equal_generate"]) or \
            not row["tokens_equal_paged"]:
        fail("dense_small_parity: the dense engine's tokens differ from "
             "dense generate's or the paged engine's")
    if dense["kernel_launches"] != cfg.n_layers * dense["n_prefills"] or \
            dense["eager_chunks_on_cuda"] or \
            dense["graph_replays"] != dense["steps_done"]:
        fail("dense_small_parity: a prefill skipped the kernel or a chunk "
             "did not replay its graph")


def paged_graph_parity(torch, np, tf, serving_graphs, model, card):
    """The graphed paged decode chunk against the eager
    ``tf.paged_decode_chunk`` on the serve phase's full-width model: 8
    rows (one inactive, one clamping at the window's end) over pools of
    random K/V, windows 2048 and 4096, 16 steps from one pool state. The
    tokens must be equal. Reports the largest logit gap of one step (a
    graph of ``tf.paged_decode_step`` against the eager call; expect 0),
    whether the pools came out equal but for the null block, and the wall
    time of a 16-step chunk replayed and run eagerly (each ending in a
    synchronize)."""
    cfg, m = model.cfg, model.model
    slots, steps, bs = 8, 16, 16
    for window in (2048, 4096):
        per_row = window // bs
        shape = (cfg.n_layers, 1 + slots * per_row, cfg.n_kv_heads, bs,
                 cfg.head_dim)
        gen = torch.Generator(device="cuda").manual_seed(window)
        pools = {n: torch.randn(shape, generator=gen, device="cuda",
                                dtype=cfg.torch_dtype) for n in ("k", "v")}
        eager_pools = {n: p.clone() for n, p in pools.items()}
        rng = np.random.default_rng(window)
        tables = 1 + np.arange(slots * per_row).reshape(slots, per_row)
        positions = rng.integers(window // 2, window - steps, slots)
        positions[0] = window - 3
        active = np.ones(slots, bool)
        active[5] = False
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, slots),
                                 device="cuda")
        t_tables, t_pos, t_act = (torch.as_tensor(a, device="cuda")
                                  for a in (tables, positions, active))
        with torch.inference_mode():
            one = serving_graphs.GraphSet("cuda")
            logits = {}

            def step():
                logits["graph"] = tf.paged_decode_step(
                    m, pools, t_tables, tokens, t_pos, t_act, window, bs)[0]

            one.capture("step", step)
            one.replay("step")
            eager_logits = tf.paged_decode_step(
                m, eager_pools, t_tables, tokens, t_pos, t_act, window, bs)[0]
            gap = (logits["graph"] - eager_logits).abs().max().item()
            del one, logits, eager_logits
            last_dev = tokens.clone()
            runner = serving_graphs.PagedDecodeGraphs(
                m, pools, last_dev, tables.shape, steps, bs)
            got = runner(tables, positions, active, steps, window).clone()
            want, want_last, _ = tf.paged_decode_chunk(
                m, eager_pools, t_tables, tokens.clone(), t_pos, t_act,
                steps=steps, window=window, block_size=bs)
            torch.cuda.synchronize()
            equal = bool(torch.equal(got, want)
                         and torch.equal(last_dev, want_last))
            # Block 0 holds garbage by definition (inactive rows write
            # there, and so do the capture's warm-up iterations).
            pools_equal = all(torch.equal(pools[n][:, 1:],
                                          eager_pools[n][:, 1:])
                              for n in pools)

            def wall_ms(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            graph_chunk_ms = wall_ms(lambda: runner(
                tables, positions, active, steps, window))
            eager_chunk_ms = wall_ms(lambda: tf.paged_decode_chunk(
                m, eager_pools, t_tables, tokens.clone(), t_pos, t_act,
                steps=steps, window=window, block_size=bs))
        row = {"phase": "paged_graph_parity", **card, "model": "llama3-8b",
               "window": window, "rows": slots,
               "active_rows": int(active.sum()), "steps": steps,
               "tokens_equal": equal, "pools_equal": pools_equal,
               "step_logits_max_abs_gap": gap,
               "graph_capture_s": runner.graphs.capture_s,
               "graph_chunk_ms": graph_chunk_ms,
               "eager_chunk_ms": eager_chunk_ms}
        emit(row)
        del pools, eager_pools, runner
        _free(torch)
        if not equal:
            fail(f"paged_graph_parity: the graphed chunk's tokens differ "
                 f"from the eager chunk's at window {window}")


def spec_small_parity(torch, np, tf, serve_cli, attention):
    """A small f32 model (head dim 128, so the f32 kernel runs; its draft
    has head dim 32) on the card: the paged engine with ``speculate``
    ngram and draft returns exactly the tokens of ``speculate="off"``, for
    repetitive, shared-prefix and structureless prompts, more of them
    than slots; every verify replays its graph."""
    cfg = tf.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=1, d_ff=768,
                               max_seq_len=128, dtype="float32")
    model = serve_cli.Model(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(3)
    pattern = rng.integers(0, cfg.vocab_size, 8).tolist()
    prefix = rng.integers(0, cfg.vocab_size, 20).tolist()
    cases = [(pattern * 5, 60), (pattern * 3 + pattern[:3], 48),
             (prefix + pattern * 2, 40), (prefix + [7, 7], 24),
             (rng.integers(0, cfg.vocab_size, 30).tolist(), 40)]
    outs, row = {}, {"phase": "spec_small_parity", "requests": len(cases)}
    for mode in ("off", "ngram", "draft"):
        engine = serve_cli.ContinuousEngine(
            model, max_slots=2, chunk=4, prefill_chunk=32, kv_block_size=16,
            kv_cache="paged", speculate=mode)
        try:
            with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
                futures = [pool.submit(engine.generate, [p], n)
                           for p, n in cases]
                outs[mode] = [f.result(timeout=300)[0] for f in futures]
        finally:
            engine.shutdown()
        if mode != "off":
            stats, graphs = engine.stats(), engine.graph_stats()
            row[mode] = {
                "tokens_equal_off": outs[mode] == outs["off"],
                "verifies": stats["spec_verifies"],
                "proposed": stats["spec_proposed"],
                "accepted": stats["spec_accepted"],
                "verify_graph_replays": graphs["verify_graph_replays"],
                "eager_verifies_on_cuda": graphs["eager_verifies_on_cuda"],
            }
    emit(row)
    for mode in ("ngram", "draft"):
        got = row[mode]
        if not got["tokens_equal_off"] or got["eager_verifies_on_cuda"] or \
                got["verify_graph_replays"] != got["verifies"]:
            fail(f"spec_small_parity: speculate={mode} disagrees with off, "
                 f"or ran a verify eagerly")
    # A draft always proposes; the n-gram proposer only where the stream
    # repeats itself.
    if not row["draft"]["verifies"]:
        fail("spec_small_parity: the draft engine ran no verify")


# serve_spec traffic: 4 requests, each prompt a 32-token pattern of its own
# repeated to 512 tokens, 64 new tokens each (the draft mode: the first 2).
SPEC_PATTERN, SPEC_PROMPT, SPEC_NEW = 32, 512, 64


def _graph_captures(graph_stats):
    return sum(v for k, v in graph_stats.items()
               if k.endswith("graph_captures"))


def _verify_replay_ms(torch, runner):
    """Device ms of one replay of ``runner``'s verify graph at batch 1
    and 8 (window 2048), rows at decode positions 1040-2000 that write
    and read only the null block: the engine's own graphs, after its
    traffic."""
    out = {}
    with torch.inference_mode():
        for rows in (1, 8):
            runner._neutral(rows)
            runner.buffers(rows)["poss"].copy_(torch.as_tensor(
                [1040 + 137 * i for i in range(rows)]))
            out[f"b{rows}_w2048"] = time_ms(
                lambda rows=rows: runner.graphs.replay((rows, 2048)), torch)
    return out


def _serve_spec_mode(torch, np, serve_cli, attention, model, mode, prompts,
                     card, int8_matmul, phase="serve_spec"):
    """One engine (the serve_paged configuration, ``speculate=mode``)
    behind the server with ``--warmup=all``, the requests posted at once.
    An int8 model's products are counted too: 7 × layers per eager
    forward (prefill segment) after ready, and per captured graph.
    Returns (row, outputs, flash launches of the mode's run); the row
    carries the int8 product's launches (eager ones counted, graph ones
    7 × layers a replay)."""
    cfg = model.cfg
    engine = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512, kv_block_size=16,
        kv_cache="paged", speculate=mode)
    results, latency = {}, {}
    attention.flash_fwd_launches = 0
    int8_matmul.int8_mm_launches = int8_matmul.int8_mm_captured = 0
    t0 = time.perf_counter()
    server, state = serve_cli.start_server(engine, port=0, host="127.0.0.1",
                                           warmup_mode="all")
    try:
        serve_cli.wait_ready(state, timeout=900)
        ready_s = time.perf_counter() - t0
        port = server.server_address[1]
        at_ready = {"launches": attention.flash_fwd_launches,
                    "int8_launches": int8_matmul.int8_mm_launches,
                    **engine.stats(), **engine.graph_stats()}
        ttft_before = len(engine.ttft_s)

        def post(i):
            t1 = time.perf_counter()
            results[i] = serve_cli.post_generate(port, [prompts[i]],
                                                 SPEC_NEW)
            latency[i] = time.perf_counter() - t1

        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            for f in [pool.submit(post, i) for i in range(len(prompts))]:
                f.result(timeout=900)
        burst_s = time.perf_counter() - t1
        stats, graphs = engine.stats(), engine.graph_stats()
        launches = attention.flash_fwd_launches
        int8_counted = int8_matmul.int8_mm_launches
        verify_ms = (_verify_replay_ms(torch, engine.verify_graphs)
                     if engine.verify_graphs is not None else {})
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    for i, prompt in enumerate(prompts):
        _check_response(f"serve_spec {mode} {i}", results[i], prompt,
                        SPEC_NEW, cfg.vocab_size)
    served = {k: stats[k] - at_ready[k]
              for k in ("steps_done", "n_prefills", "n_chunks",
                        "occupied_steps")}
    decode_tokens = len(prompts) * (SPEC_NEW - 1)
    device_s = engine.t_chunk_device_s + engine.t_verify_device_s
    n_layers = cfg.n_layers
    verify_replays = graphs.get("verify_graph_replays", 0)
    draft_launches = 0
    if mode == "draft":
        drafter = engine.spec_proposer
        draft_launches = drafter._ingest.graphs.replays * \
            drafter.cfg.n_layers
    total_launches = launches + n_layers * verify_replays + draft_launches
    row = {
        "phase": phase, **card, "model": "llama3-8b",
        "speculate": mode, "requests": len(prompts),
        "prompt_len": SPEC_PROMPT, "pattern": SPEC_PATTERN,
        "max_new": SPEC_NEW, "ready_s": ready_s, "burst_s": burst_s,
        "warmup": state["warmup"], "latency_s": latency,
        "ttft_s": [t for _, t in list(engine.ttft_s)[ttft_before:]],
        **served,
        "device_steps_per_token": served["steps_done"] / decode_tokens,
        "decode_tokens_per_s_on_card": stats["occupied_steps"]
        / max(device_s, 1e-9),
        "chunk_device_s": engine.t_chunk_device_s,
        "verify_device_s": engine.t_verify_device_s,
        "flash_launches_counted": launches,
        "flash_launches": total_launches,
        "captures_after_ready":
            _graph_captures(graphs) - _graph_captures(at_ready),
        **{k: v for k, v in graphs.items() if "pool_bytes" not in k},
        "graph_pool_gb": sum(v for k, v in graphs.items()
                             if k.endswith("pool_bytes")) / 1e9,
        "verify_replay_ms": verify_ms,
        "distinct_generated": [
            len(set(results[i]["tokens"][0][len(p):]))
            for i, p in enumerate(prompts)],
    }
    if mode != "off":
        verifies = max(stats["spec_verifies"], 1)
        row.update({
            "verifies": stats["spec_verifies"],
            "proposed": stats["spec_proposed"],
            "accepted": stats["spec_accepted"],
            "acceptance": stats["spec_acceptance"],
            "accepted_by_row": list(engine.retired_spec_accepted),
            "verify_dispatch_ms": engine.t_verify_dispatch_s / verifies * 1e3,
            "verify_sync_wait_ms": engine.t_verify_wait_s / verifies * 1e3,
            "verify_device_ms": engine.t_verify_device_s / verifies * 1e3,
        })
    chunks = max(served["n_chunks"], 1)
    row["chunk_dispatch_ms"] = engine.t_chunk_dispatch_s / chunks * 1e3
    row["chunk_sync_wait_ms"] = engine.t_chunk_wait_s / chunks * 1e3
    quantized = int8_matmul.int8_mm_captured > 0
    if quantized:
        per = 7 * n_layers
        replays = graphs["graph_replays"] + verify_replays
        row.update({
            "int8_mm_launches_counted": int8_counted,
            "int8_mm_launches": int8_counted + per * replays,
            "int8_mm_captured": int8_matmul.int8_mm_captured,
            "int8_mm_launches_after_ready":
                int8_counted - at_ready["int8_launches"],
        })
    emit(row)
    outs = [results[i]["tokens"][0] for i in range(len(prompts))]
    if row["captures_after_ready"] or graphs["eager_chunks_on_cuda"] or \
            graphs.get("eager_verifies_on_cuda", 0):
        fail(f"serve_spec {mode}: a graph was captured after ready, or a "
             f"chunk or a verify ran eagerly on the card")
    if mode != "off" and verify_replays != row["verifies"]:
        fail(f"serve_spec {mode}: {row['verifies']} verifies, "
             f"{verify_replays} verify replays")
    if mode != "draft" and launches - at_ready["launches"] != \
            n_layers * served["n_prefills"]:
        fail(f"serve_spec {mode}: {launches - at_ready['launches']} flash "
             f"launches outside graphs after ready for "
             f"{served['n_prefills']} prefill segments")
    if quantized and (
            row["int8_mm_launches_after_ready"] != per * served["n_prefills"]
            or row["int8_mm_captured"] != per * _graph_captures(graphs)):
        fail(f"{phase} {mode}: int8 products {row} do not match 7 × "
             f"{n_layers} per eager forward and per captured graph")
    return row, outs, total_launches


def _divergences(torch, tf, model, prompts, got, want):
    """Where each stream of ``got`` first parts from ``want`` (the
    reference streams: ``--speculate off``'s, or ``Model.generate``'s):
    the generated index and the top-2 logit margin there under the
    reference, read from the dense forward over its context."""
    rows = []
    for i, (prompt, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        pos = next(j for j in range(len(b)) if a[j] != b[j])
        with torch.inference_mode():
            logits = tf.forward(model.model,
                                torch.as_tensor([b[:pos]], device="cuda"),
                                logits_at="last")[0, 0]
        top2 = logits.topk(2).values
        rows.append({"request": i, "generated_index": pos - len(prompt),
                     "want_token": b[pos], "got_token": a[pos],
                     "want_margin": (top2[0] - top2[1]).item()})
    return rows


def _served_gaps(torch, tf, transformer, prompts, got):
    """Every served token of the streams ``got`` (prompt + generated)
    against the dense forward over that stream's own context (teacher
    forced, so a stream is read past where it parts from the
    reference's): ``gap`` is the reference's top logit less its logit of
    the token served there, 0 where the engine chose the reference's
    argmax; ``margin`` the reference's top-2 margin there, how close the
    choice was. Returns their summary: the count of gaps of
    SERVE_LOGITS_ATOL or more, the largest gap, and the margins'
    quantiles, so the limit can be judged against them."""
    gaps, margins = [], []
    for prompt, stream in zip(prompts, got):
        with torch.inference_mode():
            logits = tf.forward(transformer,
                                torch.as_tensor([stream[:-1]], device="cuda"))
        logits = logits[0, len(prompt) - 1:]
        served = torch.as_tensor(stream[len(prompt):], device="cuda")
        top2 = logits.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - logits.gather(1, served[:, None])[:, 0])
        margins.append(top2[:, 0] - top2[:, 1])
        del logits
    gaps, margins = torch.cat(gaps).float(), torch.cat(margins).float()
    q = torch.quantile(margins, torch.tensor([0.1, 0.5, 0.9],
                                             device=margins.device))
    return {"tokens": gaps.numel(), "max_gap": gaps.max().item(),
            "gaps_over_tol": int((gaps >= SERVE_LOGITS_ATOL).sum()),
            "argmax_tokens": int((gaps == 0).sum()),
            "margin_min": margins.min().item(),
            "margin_p10_p50_p90": q.tolist(),
            "margins_below_tol": int((margins < SERVE_LOGITS_ATOL).sum())}


def serve_spec(torch, np, tf, serve_cli, attention, card, model,
               int8_matmul):
    """Speculation on the full-width model, the serve_paged configuration
    (8 slots, chunk 32, prefill chunk 512, block 16, ``--warmup=all``):
    ``--speculate ngram`` on 4 concurrent requests, each a 32-token
    pattern of its own repeated to 512 tokens, 64 new tokens; the same
    requests with ``--speculate off``; the first 2 with ``--speculate
    draft``. In bf16 at full width a 16-row verify and a one-row decode
    step may round differently, so a stream may part from off's only at
    a position whose top-2 margin under off is below SERVE_LOGITS_ATOL;
    every divergence is printed with its margin. Returns the flash
    kernel's launches (the verify replays × 32 and the draft's included).
    """
    rng = np.random.default_rng(7)
    prompts = []
    for _ in range(4):
        pattern = rng.integers(0, model.cfg.vocab_size, SPEC_PATTERN)
        prompts.append(np.tile(pattern, SPEC_PROMPT // SPEC_PATTERN).tolist())
    launches, outs, rows = 0, {}, {}
    for mode, reqs in (("ngram", prompts), ("off", prompts),
                       ("draft", prompts[:2])):
        rows[mode], outs[mode], n = _serve_spec_mode(
            torch, np, serve_cli, attention, model, mode, reqs, card,
            int8_matmul)
        launches += n
        _free(torch)  # the mode's engine: its pools and graphs
    if not rows["ngram"]["verifies"] or not rows["draft"]["verifies"]:
        fail("serve_spec: a speculating engine ran no verify")
    bad = []
    for mode, reqs in (("ngram", prompts), ("draft", prompts[:2])):
        div = _divergences(torch, tf, model, reqs, outs[mode],
                           outs["off"][:len(reqs)])
        emit({"phase": "serve_spec_divergences", "speculate": mode,
              "streams": len(reqs), "equal": len(reqs) - len(div),
              "divergences": div, "tol": SERVE_LOGITS_ATOL})
        bad += [d for d in div if d["want_margin"] >= SERVE_LOGITS_ATOL]
    if bad:
        fail(f"serve_spec: streams part from off at margins >= "
             f"{SERVE_LOGITS_ATOL}: {bad}")
    return launches


# serve_dense's micro-batcher traffic: requests of one shape posted at once
# through ``--batch-window-ms``.
BATCH_REQUESTS, BATCH_PROMPT, BATCH_NEW, BATCH_WINDOW_MS = 4, 256, 32, 50.0


def serve_dense(torch, np, tf, serve_cli, attention, card, model):
    """The dense continuous-batching engine (the default ``kv_cache``) on
    the serve phase's full-width model, with the JAX server's defaults (8
    slots, chunk 32, prefill chunk 512), behind the HTTP server started
    with ``--warmup=all``: every prefill shape runs and every (window,
    mask_writes) decode graph is captured before ready. serve_paged's
    traffic, the same prompts: a 1024-token prompt, then 6 concurrent
    requests sharing it (64-token suffixes, 32 new) and, once they decode,
    a 3000-token prompt, which prefills in 6 segments of 512 between
    decode chunks run under masked writes. Then the micro-batcher
    (``--batch-window-ms``) in front of the same model: BATCH_REQUESTS
    equal-shape greedy requests posted at once must coalesce into fewer
    calls. Each request's final prefill segment keeps its logits (on the
    card), held after the traffic against the dense ``tf.forward`` on the
    same context, as serve_paged's are. Every stream is held to
    ``Model.generate``'s, but where it parts at a top-2 margin under
    SERVE_LOGITS_ATOL (the engine's 8-row chunk and the batcher's 4-row
    decode against one-row steps, in bf16); each divergence is printed,
    and every served token is held, on its stream's own context, to
    within SERVE_LOGITS_ATOL of the dense forward's top logit. Returns the
    kernel's launches (the engine's run and the batcher's)."""
    cfg = model.cfg
    vocab = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    engine = serve_cli.ContinuousEngine(model, max_slots=8, chunk=32,
                                        prefill_chunk=512)
    # Each segment call: (offset, true_pos, chunks run before it); each
    # final segment's (tokens, offset, true_pos, logits); each chunk:
    # (steps, window, mask_writes).
    segments, finals, chunks = [], [], []
    prefill_seg, run_chunk = engine._prefill_seg, engine._chunk

    def seg_recording(m, cache, seg, offset, slot, true_pos,
                      want_logits=False, **kw):
        segments.append((offset, true_pos, len(chunks)))
        if not want_logits:
            return prefill_seg(m, cache, seg, offset, slot, true_pos, **kw)
        tok, logits = prefill_seg(m, cache, seg, offset, slot, true_pos,
                                  want_logits=True, return_logits=True, **kw)
        finals.append((seg, offset, true_pos, logits))
        return tok

    def chunk_recording(*args, **kw):
        chunks.append((kw["steps"], kw["window"], kw["mask_writes"]))
        return run_chunk(*args, **kw)

    engine._prefill_seg, engine._chunk = seg_recording, chunk_recording
    prompts, max_new = _shared_prefix_prompts(np, vocab)

    def snapshot():
        return {"launches": attention.flash_fwd_launches,
                "t_chunk_device_s": engine.t_chunk_device_s,
                "t_chunk_dispatch_s": engine.t_chunk_dispatch_s,
                "t_chunk_wait_s": engine.t_chunk_wait_s,
                "t_prefill_dispatch_s": engine.t_prefill_dispatch_s,
                "t_prefill_wait_s": engine.t_prefill_wait_s,
                "ttft": len(engine.ttft_s),
                **engine.stats(), **engine.graph_stats()}

    # The main path: counts at zero, then server start (the warm grid and
    # the warmup request run through the engine) and the traffic.
    attention.flash_fwd_launches = 0
    attention.flash_dq_launches = attention.flash_dkv_launches = 0
    t0 = time.perf_counter()
    server, state = serve_cli.start_server(engine, port=0, host="127.0.0.1",
                                           warmup_mode="all")
    try:
        serve_cli.wait_ready(state, timeout=900)
        ready_s = time.perf_counter() - t0
        port = server.server_address[1]
        warm = state["warmup"]
        at_ready = snapshot()
        results, latency, burst_s = _post_shared_prefix(
            engine, port, prompts, max_new, "serve_dense")
        done = snapshot()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    launches = attention.flash_fwd_launches
    other = attention.flash_dq_launches + attention.flash_dkv_launches
    cache_gb = sum(c.nbytes for c in engine.cache.values()) / 1e9
    served = {k: done[k] - at_ready[k] for k in (
        "launches", "steps_done", "n_prefills", "n_chunks", "occupied_steps",
        "t_chunk_device_s", "t_chunk_dispatch_s", "t_chunk_wait_s",
        "t_prefill_dispatch_s", "t_prefill_wait_s", "graph_captures",
        "graph_replays", "eager_chunks_on_cuda")}
    ttft = [{"prompt_len": n, "ttft_s": t}
            for n, t in list(engine.ttft_s)[at_ready["ttft"]:]]
    del engine
    _free(torch)

    for name, prompt in prompts.items():
        _check_response(f"serve_dense {name}", results[name], prompt,
                        max_new[name], vocab)
    n_graphs = 2 * len(tf.serving_shape_buckets(cfg, 512, 32)["windows"])
    warm_prefills = warm["tasks"] - n_graphs
    long_segs = [s for s in segments
                 if s[1] == len(prompts["long_3000"]) - 1]
    masked = [c[2] for c in chunks[long_segs[0][2]:long_segs[-1][2]]] \
        if long_segs else []
    chunks_n = max(served["n_chunks"], 1)
    row = {
        "phase": "serve_dense", **card, "model": "llama3-8b",
        "n_layers": cfg.n_layers, "max_slots": 8, "decode_chunk": 32,
        "prefill_chunk": 512, "cache_gb": cache_gb,
        "requests": len(prompts) + 1, "burst_s": burst_s,
        "latency_s": latency, "ttft": ttft,
        "flash_fwd_launches": launches, **{f"served_{k}": v
                                           for k, v in served.items()},
        "decode_tokens_per_s_on_card": served["occupied_steps"]
        / max(served["t_chunk_device_s"], 1e-9),
        "decode_tokens_per_s_host": served["occupied_steps"]
        / max(served["t_chunk_dispatch_s"] + served["t_chunk_wait_s"], 1e-9),
        "chunk_step_device_ms": served["t_chunk_device_s"]
        / max(served["steps_done"], 1) * 1e3,
        "chunk_host_dispatch_ms": served["t_chunk_dispatch_s"] / chunks_n
        * 1e3,
        "chunk_sync_wait_ms": served["t_chunk_wait_s"] / chunks_n * 1e3,
        "chunk_device_ms": served["t_chunk_device_s"] / chunks_n * 1e3,
        "prefill_host_dispatch_ms": served["t_prefill_dispatch_s"]
        / max(served["n_prefills"], 1) * 1e3,
        "prefill_sync_wait_ms": served["t_prefill_wait_s"]
        / max(served["n_prefills"], 1) * 1e3,
        "long_prompt_segments": len(long_segs),
        "chunks_during_long_prefill": len(masked),
        "masked_chunks_during_long_prefill": sum(masked),
        "ready_s": ready_s, "warmup": warm, "warm_prefill_tasks":
            warm_prefills,
        "graph_captures": done["graph_captures"],
        "captures_after_ready": served["graph_captures"],
        "graph_replays": done["graph_replays"],
        "graph_capture_s": done["graph_capture_s"],
        "graph_pool_gb": done["graph_pool_bytes"] / 1e9,
        "eager_chunks_on_cuda": done["eager_chunks_on_cuda"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(row)
    if at_ready["graph_captures"] != n_graphs:
        fail(f"serve_dense: the warmup captured {at_ready['graph_captures']} "
             f"decode graphs, want one per (window, mask) ({n_graphs})")
    if at_ready["launches"] != cfg.n_layers * (warm_prefills
                                               + at_ready["n_prefills"]):
        fail(f"serve_dense: {at_ready['launches']} flash launches before "
             f"ready for {warm_prefills} warm prefills and "
             f"{at_ready['n_prefills']} of the warmup request")
    if served["launches"] != cfg.n_layers * served["n_prefills"] or other:
        fail(f"serve_dense: {served['launches']} flash launches after "
             f"ready for {served['n_prefills']} prefills (want "
             f"{cfg.n_layers} each), {other} backward launches")
    if done["eager_chunks_on_cuda"] or served["graph_captures"] or \
            served["graph_replays"] != served["steps_done"]:
        fail("serve_dense: a chunk ran eagerly, a graph was captured after "
             "ready, or a step was not a replay")
    if len(long_segs) != 6 or not masked or not all(masked):
        fail(f"serve_dense: the long prompt took {len(long_segs)} segments "
             f"with {len(masked)} chunks between them ({sum(masked)} "
             f"masked), want 6 segments interleaved with masked chunks")

    # Every prompt here is longer than the prefill chunk, so each one's
    # first token comes from a final segment at its offset over the
    # slot's whole cache row (kv_len = window), written between masked
    # chunks for the long prompt.
    logit_rows = _hold_final_logits(torch, tf, model, "serve_dense",
                                    prompts, results, finals)
    emit({"phase": "serve_dense_logits", "logits": logit_rows,
          "tol": SERVE_LOGITS_ATOL})
    b_launches, b_row = _serve_batcher(torch, np, serve_cli, attention,
                                       model, card)
    names = list(prompts)
    want = [model.generate([prompts[n]], max_new[n])[0] for n in names]
    got = [results[n]["tokens"][0] for n in names]
    div = _divergences(torch, tf, model, [prompts[n] for n in names], got,
                       want)
    div_b = _divergences(torch, tf, model, b_row["prompts"], b_row["outs"],
                         b_row.pop("want"))
    held = _served_gaps(torch, tf, model.model,
                        [prompts[n] for n in names] + b_row.pop("prompts"),
                        got + b_row.pop("outs"))
    emit({"phase": "serve_dense_divergences",
          "engine": {"streams": len(names), "equal": len(names) - len(div),
                     "divergences": div},
          "batcher": {"streams": BATCH_REQUESTS,
                      "equal": BATCH_REQUESTS - len(div_b),
                      "divergences": div_b},
          "served_tokens": held, "tol": SERVE_LOGITS_ATOL})
    bad = [d for d in div + div_b if d["want_margin"] >= SERVE_LOGITS_ATOL]
    if bad:
        fail(f"serve_dense: streams part from Model.generate's at margins "
             f">= {SERVE_LOGITS_ATOL}: {bad}")
    if held["gaps_over_tol"]:
        fail(f"serve_dense: {held['gaps_over_tol']} served tokens lie "
             f"{SERVE_LOGITS_ATOL} or more below the dense forward's top "
             f"logit on their own context: {held}")
    bf16 = {k: row[k] for k in (
        "decode_tokens_per_s_on_card", "chunk_step_device_ms", "ready_s",
        "max_memory_allocated_gb")}
    bf16["streams"] = got
    return launches + b_launches, bf16


def _serve_batcher(torch, np, serve_cli, attention, model, card):
    """``--batch-window-ms`` in front of ``model``, behind the server:
    BATCH_REQUESTS greedy requests of one shape posted at once must
    coalesce into fewer calls than requests, each call one prefill (the
    kernel once per layer). Returns (launches, row); the row keeps the
    prompts, outputs and ``Model.generate``'s solo streams for the
    caller's divergence check."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, model.cfg.vocab_size, BATCH_PROMPT).tolist()
               for _ in range(BATCH_REQUESTS)]
    batcher = serve_cli.BatchingModel(model, window_ms=BATCH_WINDOW_MS)
    results = {}
    attention.flash_fwd_launches = 0
    server, state = serve_cli.start_server(batcher, port=0, host="127.0.0.1")
    try:
        serve_cli.wait_ready(state, timeout=600)
        port = server.server_address[1]
        at_ready = (attention.flash_fwd_launches, batcher.n_batches,
                    batcher._m_queue_wait.count, batcher._m_queue_wait.sum)
        t0 = time.perf_counter()

        def post(i):
            results[i] = serve_cli.post_generate(port, [prompts[i]],
                                                 BATCH_NEW)

        with concurrent.futures.ThreadPoolExecutor(BATCH_REQUESTS) as pool:
            for f in [pool.submit(post, i) for i in range(BATCH_REQUESTS)]:
                f.result(timeout=600)
        burst_s = time.perf_counter() - t0
        launches = attention.flash_fwd_launches
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()
    calls = batcher.n_batches - at_ready[1]
    outs = [results[i]["tokens"][0] for i in range(BATCH_REQUESTS)]
    for i, prompt in enumerate(prompts):
        _check_response(f"serve_dense batcher {i}", results[i], prompt,
                        BATCH_NEW, model.cfg.vocab_size)
    emit({"phase": "serve_dense_batcher", **card, "model": "llama3-8b",
          "window_ms": BATCH_WINDOW_MS, "requests": BATCH_REQUESTS,
          "prompt_len": BATCH_PROMPT, "max_new": BATCH_NEW,
          "coalesced_calls": calls,
          "last_batch_rows": batcher._m_batch_rows.value,
          "queue_wait_mean_s": (batcher._m_queue_wait.sum - at_ready[3])
          / max(batcher._m_queue_wait.count - at_ready[2], 1),
          "burst_s": burst_s, "flash_fwd_launches": launches,
          "launches_after_ready": launches - at_ready[0]})
    if calls >= BATCH_REQUESTS or \
            launches - at_ready[0] != model.cfg.n_layers * calls:
        fail(f"serve_dense: the batcher made {calls} calls for "
             f"{BATCH_REQUESTS} requests with {launches - at_ready[0]} "
             f"kernel launches (want fewer calls, one prefill each)")
    want = [model.generate([p], BATCH_NEW)[0] for p in prompts]
    return launches, {"prompts": prompts, "outs": outs, "want": want}


# serve_robust: the overload burst (distinct 512-token prompts from seed 0,
# 32 new each, against max_queue 4), and the tenant classes' burst.
ROBUST_REQUESTS, ROBUST_PROMPT, ROBUST_NEW, ROBUST_QUEUE = 12, 512, 32, 4
ROBUST_TENANTS = {"a": {"priority": 0, "queue_share": 0.75},
                  "b": {"priority": 1, "queue_share": 0.25}}


def _post_status(port, body, headers=None, timeout=600, path="/generate"):
    """POST ``path`` (/generate unless said): (HTTP status, decoded body),
    a 429 or 500 included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_all(port, bodies, headers=None):
    """Every body of ``bodies`` posted at once (a thread each, released
    together); their (status, body) in order."""
    start = threading.Barrier(len(bodies))

    def post(i):
        start.wait()
        return _post_status(port, bodies[i],
                            headers=headers[i] if headers else None)

    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
        futures = [pool.submit(post, i) for i in range(len(bodies))]
        return [f.result(timeout=900) for f in futures]


@contextlib.contextmanager
def _robust_server(serve_cli, engine, warmup_mode="lazy"):
    """``engine`` behind the HTTP server, ready; shut down after."""
    server, state = serve_cli.start_server(engine, port=0, host="127.0.0.1",
                                           warmup_mode=warmup_mode)
    try:
        serve_cli.wait_ready(state, timeout=900)
        yield server.server_address[1], state
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


@contextlib.contextmanager
def _held_loop(engine):
    """The engine loop held by a control call (which no admission bound
    counts) until the block ends."""
    release, running = threading.Event(), threading.Event()

    def hold():
        running.set()
        release.wait(600)

    holder = threading.Thread(target=lambda: engine.run_on_loop(hold),
                              daemon=True)
    holder.start()
    running.wait(600)
    try:
        yield
    finally:
        release.set()
        holder.join(600)


def _drain_when_full(engine, rows, seams, out):
    """Wrap ``engine``'s device ``seams``: at their first call (on the
    loop thread) with ``rows`` rows decoding after a chunk or verify has
    run since the wrap, ``engine.drain()``; the targeted count lands in
    ``out``."""
    def decoding():
        return sum(r is not None and r.get("remaining") is not None
                   for r in engine.occupied)

    def device_calls():
        stats = engine.stats()
        return stats["n_chunks"] + stats.get("spec_verifies", 0)

    ran = device_calls()
    for seam in seams:
        real = getattr(engine, seam)

        def wrapped(*args, _real=real, **kwargs):
            if "targeted" not in out and device_calls() > ran and \
                    decoding() == rows:
                out["targeted"] = engine.drain(reason="serve_robust")
            return _real(*args, **kwargs)

        setattr(engine, seam, wrapped)


def _robust_gaps(torch, tf, model, case, prompts, streams, refs):
    """Every served token of ``streams`` within SERVE_LOGITS_ATOL of the
    dense forward's top logit on its own context (``_served_gaps``), and
    the count of streams equal to their reference."""
    held = _served_gaps(torch, tf, model.model, prompts, streams)
    equal = sum(a == b for a, b in zip(streams, refs))
    if held["gaps_over_tol"]:
        fail(f"serve_robust {case}: {held['gaps_over_tol']} served tokens "
             f"lie {SERVE_LOGITS_ATOL} or more below the dense forward's "
             f"top logit: {held}")
    return {"served_tokens": held, "equal_streams": equal,
            "streams": len(streams), "tol": SERVE_LOGITS_ATOL}


def _shed_counts(engine):
    return {r: int(engine._m_shed.labels(r).value)
            for r in ("class_share", "queue_full", "quota", "deadline")}


def _burst_outcome(future):
    """What a finished ``_post_all`` future left: its statuses, or the
    error a client raised; "running" while it runs."""
    if not future.done():
        return "running"
    if future.exception() is not None:
        return repr(future.exception())
    return [code for code, _ in future.result()]


def _quantiles(values):
    if not values:
        return None
    v = sorted(values)
    return {"p50": v[(len(v) - 1) // 2],
            "p99": v[min(len(v) - 1, math.ceil(0.99 * len(v)) - 1)],
            "n": len(v)}


def serve_robust(torch, np, tf, serve_cli, attention, card, model):
    """Overload and failure handling on the full-width model, through
    the HTTP server. The dense engine (8 slots, chunk 32, prefill chunk
    512, ``max_queue`` 4, ``step_retries`` 1, ``--warmup=all``):
    ROBUST_REQUESTS distinct 512-token prompts served one by one (their
    TTFT), then posted at once (429s with ``queue_full``, the served
    rows' TTFT); a 1 ms deadline posted while a 3000-token prompt
    prefills in segments (429 ``deadline``); armed prefill and chunk
    faults on 4 requests (each retried once); a drain with 4 rows
    decoding; a client that hangs up. Then tenant classes on a second
    dense engine, and on the paged engine with ``--speculate ngram`` on
    serve_spec's traffic an armed verify fault and a drain. Every served
    token is held to the dense forward's top logit within
    SERVE_LOGITS_ATOL on its own context, and the equal streams are
    counted against ``Model.generate``'s. Returns the flash kernel's
    launches."""
    from container_engine_accelerators_tpu_torch import faults
    from container_engine_accelerators_tpu_torch.fleet import tenants
    from container_engine_accelerators_tpu_torch.obs import events

    def lost_s(stream):
        """Drain to re-prefill first token, per migrated row."""
        return [e["lost_s"] for e in stream.events("migration_replayed")]

    cfg = model.cfg
    vocab, n_layers = cfg.vocab_size, cfg.n_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, ROBUST_PROMPT).tolist()
               for _ in range(ROBUST_REQUESTS)]
    long_prompt = rng.integers(0, vocab, 3000).tolist()
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    capture = Capture(level=logging.INFO)
    serve_log = logging.getLogger("serve_cli")
    serve_log.addHandler(capture)
    saved_level = serve_log.level
    serve_log.setLevel(logging.INFO)
    rows, streams = {}, {}
    launches = {}

    def counted(name, engine):
        """Flash launches outside graphs since ready must be one per
        layer a prefill call (re-prefills and segments included)."""
        snap = engine.stats()["n_prefills"]
        before = attention.flash_fwd_launches
        return lambda: launches.__setitem__(name, (
            attention.flash_fwd_launches - before,
            n_layers * (engine.stats()["n_prefills"] - snap)))

    # The main path: counts at zero, then the three engines' traffic.
    attention.flash_fwd_launches = 0
    dense_events = events.EventStream("serve")
    dense = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512,
        max_queue=ROBUST_QUEUE, step_retries=1, events=dense_events)
    try:
        with _robust_server(serve_cli, dense, "all") as (port, _):
            done = counted("dense", dense)
            # Overload: one by one, then at once.
            t0 = len(dense.ttft_s)
            for p in prompts:
                code, body = _post_status(port, {
                    "tokens": [p], "max_new_tokens": 1})
                if code != 200:
                    fail(f"serve_robust overload: solo request got {code}")
            solo = {i: t for i, (_, t) in
                    enumerate(list(dense.ttft_s)[t0:])}
            t0 = len(dense.ttft_s)
            t1 = time.perf_counter()
            results = _post_all(port, [
                {"tokens": [p], "max_new_tokens": ROBUST_NEW}
                for p in prompts])
            burst_s = time.perf_counter() - t1
            burst_ttft = [t for _, t in list(dense.ttft_s)[t0:]]
            served = [i for i, (c, _) in enumerate(results) if c == 200]
            shed = [b.get("shed") for c, b in results if c == 429]
            for i in served:
                _check_response(f"serve_robust overload {i}",
                                results[i][1], prompts[i], ROBUST_NEW, vocab)
            rows["overload"] = {
                "max_queue": ROBUST_QUEUE, "requests": ROBUST_REQUESTS,
                "served": len(served), "shed_queue_full":
                    shed.count("queue_full"),
                "other": [c for c, _ in results if c not in (200, 429)],
                "burst_s": burst_s,
                "ttft_s": _quantiles(burst_ttft),
                "solo_ttft_s": _quantiles([solo[i] for i in served]),
            }
            if not shed or set(shed) != {"queue_full"} or \
                    len(served) + len(shed) != ROBUST_REQUESTS:
                fail(f"serve_robust overload: {rows['overload']}")
            streams["overload"] = ([prompts[i] for i in served],
                                   [results[i][1]["tokens"][0]
                                    for i in served])

            # A 1 ms deadline while a long prompt prefills in segments.
            segs = []
            segmenting = threading.Event()
            prefill_seg = dense._prefill_seg

            def seg_watch(*args, **kwargs):
                # At the second segment the deadline request is posted,
                # and this segment starts once it is queued: it waits at
                # least the segment's time, far more than 1 ms.
                segs.append(1)
                if len(segs) == 2:
                    segmenting.set()
                    deadline = time.monotonic() + 600
                    while dense._q.qsize() < 1 and \
                            time.monotonic() < deadline:
                        time.sleep(0.001)
                return prefill_seg(*args, **kwargs)

            dense._prefill_seg = seg_watch
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                long_req = pool.submit(_post_status, port, {
                    "tokens": [long_prompt], "max_new_tokens": 8})
                if not segmenting.wait(600):
                    fail("serve_robust deadline: the long prompt did not "
                         "prefill in segments")
                code, body = _post_status(port, {
                    "tokens": [prompts[0]], "max_new_tokens": 4,
                    "deadline_s": 0.001})
                long_code, long_body = long_req.result(600)
            dense._prefill_seg = prefill_seg
            rows["deadline"] = {"status": code, "shed": body.get("shed"),
                                "long_prompt_segments": len(segs),
                                "long_status": long_code}
            if (code, body.get("shed"), long_code) != (429, "deadline", 200):
                fail(f"serve_robust deadline: {rows['deadline']} {body}")
            _check_response("serve_robust long", long_body, long_prompt, 8,
                            vocab)

            # Armed faults: the second prefill and the fourth chunk.
            plan = faults.arm(faults.FaultPlan([
                {"kind": "collective_timeout", "site": "serving.prefill",
                 "at": 1, "count": 1},
                {"kind": "collective_timeout", "site": "serving.chunk",
                 "at": 3, "count": 1},
            ]))
            r0 = int(dense._m_retries.value)
            try:
                results = _post_all(port, [
                    {"tokens": [p], "max_new_tokens": ROBUST_NEW}
                    for p in prompts[:4]])
            finally:
                faults.disarm()
            fired = len(plan.events.events("fault_injected"))
            retries = int(dense._m_retries.value) - r0
            rows["faults_dense"] = {
                "statuses": [c for c, _ in results], "faults_fired": fired,
                "step_retries": retries}
            if any(c != 200 for c, _ in results) or fired != 2 or \
                    retries != fired:
                fail(f"serve_robust faults dense: {rows['faults_dense']}")
            for p, (_, b) in zip(prompts[:4], results):
                _check_response("serve_robust faults", b, p, ROBUST_NEW,
                                vocab)
            streams["faults_dense"] = (prompts[:4], [b["tokens"][0]
                                                     for _, b in results])

            # Drain with 4 rows decoding.
            drained = {}
            _drain_when_full(dense, 4, ["_chunk"], drained)
            m0 = int(dense._m_migrated.value)
            results = _post_all(port, [
                {"tokens": [p], "max_new_tokens": ROBUST_NEW}
                for p in prompts[4:8]])
            migrated = int(dense._m_migrated.value) - m0
            rows["drain_dense"] = {
                "statuses": [c for c, _ in results],
                "targeted": drained.get("targeted"), "migrated": migrated,
                "lost_s": lost_s(dense_events)}
            if any(c != 200 for c, _ in results) or \
                    drained.get("targeted") != 4 or migrated != 4:
                fail(f"serve_robust drain dense: {rows['drain_dense']}")
            for p, (_, b) in zip(prompts[4:8], results):
                _check_response("serve_robust drain", b, p, ROBUST_NEW,
                                vocab)
            streams["drain_dense"] = (prompts[4:8], [b["tokens"][0]
                                                     for _, b in results])

            # A client that hangs up before its response.
            body = json.dumps({"tokens": [prompts[8]],
                               "max_new_tokens": 8}).encode()
            with _held_loop(dense):
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=600)
                sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Type: application/json\r\n"
                             b"Content-Length: "
                             + str(len(body)).encode() + b"\r\n\r\n" + body)
                deadline = time.monotonic() + 600
                while dense._q.qsize() < 1:
                    if time.monotonic() > deadline:
                        fail("serve_robust hang-up: request not queued")
                    time.sleep(0.002)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
                sock.close()
            deadline = time.monotonic() + 600
            while not any("client disconnected" in r for r in records):
                if time.monotonic() > deadline:
                    fail("serve_robust hang-up: no disconnect logged")
                time.sleep(0.01)
            code, body = _post_status(port, {
                "tokens": [prompts[9]], "max_new_tokens": 8})
            rows["hang_up"] = {
                "next_status": code,
                "failures_logged": sum("generate failed" in r
                                       for r in records)}
            if code != 200 or rows["hang_up"]["failures_logged"]:
                fail(f"serve_robust hang-up: {rows['hang_up']}")
            done()
            graphs = dense.graph_stats()
        rows["dense_graphs"] = {k: graphs[k] for k in (
            "graph_captures", "graph_replays", "eager_chunks_on_cuda")}
        del dense
        _free(torch)

        # Tenant classes: class b's burst sheds its own share.
        dense = serve_cli.ContinuousEngine(
            model, max_slots=8, chunk=32, prefill_chunk=512, max_queue=8,
            step_retries=1,
            tenants=tenants.TenantClasses.from_dict(ROBUST_TENANTS))
        with _robust_server(serve_cli, dense) as (port, _):
            done = counted("tenants", dense)
            bodies = [{"tokens": [p], "max_new_tokens": 8}
                      for p in prompts[:12]]
            heads = [{"X-Tenant-Class": "a"}] * 4 + \
                [{"X-Tenant-Class": "b"}] * 8
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                with _held_loop(dense):
                    burst = pool.submit(_post_all, port, bodies,
                                        heads)
                    # Held until every request queued or was shed (for
                    # any reason: a queue_full shed fails the check
                    # below, not this wait).
                    deadline = time.monotonic() + 600

                    def landed():
                        return dense._q.qsize() + sum(
                            int(dense._m_shed.labels(r).value)
                            for r in ("class_share", "queue_full"))

                    while landed() < 12:
                        # A burst that ended (a client's error) or ran
                        # out of time fails with what it left.
                        if burst.done() or time.monotonic() > deadline:
                            fail(f"serve_robust tenants: the burst did "
                                 f"not land: {landed()} of 12 queued or "
                                 f"shed, queues {dense._q.depths()}, "
                                 f"sheds {_shed_counts(dense)}, burst "
                                 f"{_burst_outcome(burst)}")
                        time.sleep(0.002)
                    depths = dense.stats()["tenant_queues"]
                results = burst.result(600)
            done()
        a = [c for c, _ in results[:4]]
        b_shed = [body for c, body in results[4:] if c == 429]
        rows["tenants"] = {
            "max_queue": 8, "classes": ROBUST_TENANTS,
            "queued_while_held": depths, "a_statuses": a,
            "b_served": sum(c == 200 for c, _ in results[4:]),
            "b_shed": [(x.get("shed"), x.get("tenant")) for x in b_shed]}
        if a != [200] * 4 or not b_shed or any(
                (x.get("shed"), x.get("tenant")) != ("class_share", "b")
                for x in b_shed):
            fail(f"serve_robust tenants: {rows['tenants']}")
        del dense
        _free(torch)

        # The paged engine with --speculate ngram: a verify fault, a drain.
        srng = np.random.default_rng(7)  # serve_spec's prompts
        spec_prompts = []
        for _ in range(4):
            pattern = srng.integers(0, vocab, SPEC_PATTERN)
            spec_prompts.append(
                np.tile(pattern, SPEC_PROMPT // SPEC_PATTERN).tolist())
        paged = serve_cli.ContinuousEngine(
            model, max_slots=8, chunk=32, prefill_chunk=512,
            kv_block_size=16, kv_cache="paged", speculate="ngram",
            max_queue=ROBUST_QUEUE, step_retries=1,
            events=events.EventStream("serve"))
        # Warmed before ready: a verify graph's capture runs the flash
        # kernel eagerly, outside the counted prefills.
        with _robust_server(serve_cli, paged, "all") as (port, _):
            done = counted("paged", paged)
            spec_bodies = [{"tokens": [p], "max_new_tokens": SPEC_NEW}
                           for p in spec_prompts]
            plan = faults.arm(faults.FaultPlan([
                {"kind": "collective_timeout", "site": "serving.verify",
                 "at": 1, "count": 1}]))
            r0 = int(paged._m_retries.value)
            try:
                results = _post_all(port, spec_bodies)
            finally:
                faults.disarm()
            fired = len(plan.events.events("fault_injected"))
            retries = int(paged._m_retries.value) - r0
            rows["faults_paged_ngram"] = {
                "statuses": [c for c, _ in results], "faults_fired": fired,
                "step_retries": retries,
                "verifies": paged.stats()["spec_verifies"]}
            if any(c != 200 for c, _ in results) or fired != 1 or \
                    retries != fired:
                fail(f"serve_robust faults paged: "
                     f"{rows['faults_paged_ngram']}")
            for p, (_, b) in zip(spec_prompts, results):
                _check_response("serve_robust faults paged", b, p, SPEC_NEW,
                                vocab)
            streams["faults_paged_ngram"] = (
                spec_prompts, [b["tokens"][0] for _, b in results])
            drained = {}
            _drain_when_full(paged, 4, ["_paged_chunk", "_paged_verify"],
                             drained)
            m0 = int(paged._m_migrated.value)
            results = _post_all(port, spec_bodies)
            migrated = int(paged._m_migrated.value) - m0
            rows["drain_paged_ngram"] = {
                "statuses": [c for c, _ in results],
                "targeted": drained.get("targeted"), "migrated": migrated,
                "lost_s": lost_s(paged.events)}
            if any(c != 200 for c, _ in results) or \
                    drained.get("targeted") != 4 or migrated != 4:
                fail(f"serve_robust drain paged: "
                     f"{rows['drain_paged_ngram']}")
            for p, (_, b) in zip(spec_prompts, results):
                _check_response("serve_robust drain paged", b, p, SPEC_NEW,
                                vocab)
            streams["drain_paged_ngram"] = (
                spec_prompts, [b["tokens"][0] for _, b in results])
            done()
            graphs = paged.graph_stats()
        rows["paged_graphs"] = {k: graphs[k] for k in (
            "graph_captures", "graph_replays", "eager_chunks_on_cuda",
            "verify_graph_replays", "eager_verifies_on_cuda")}
        del paged
        _free(torch)
    finally:
        serve_log.removeHandler(capture)
        serve_log.setLevel(saved_level)
    total = attention.flash_fwd_launches
    rows["flash_launches"] = {"total": total, "by_engine": launches}
    if any(got != want for got, want in launches.values()) or \
            rows["dense_graphs"]["eager_chunks_on_cuda"] or \
            rows["paged_graphs"]["eager_chunks_on_cuda"] or \
            rows["paged_graphs"]["eager_verifies_on_cuda"]:
        fail(f"serve_robust: a prefill missed the kernel or a chunk or "
             f"verify ran eagerly on the card: {rows}")

    # The streams, held after the traffic (these forwards run the kernel
    # too, outside the counted path).
    refs = {}
    for ps, outs in streams.values():
        for p, out in zip(ps, outs):
            if tuple(p) not in refs:
                refs[tuple(p)] = model.generate([p], len(out) - len(p))[0]
    for case, (ps, outs) in streams.items():
        rows[case]["held"] = _robust_gaps(
            torch, tf, model, case, ps, outs, [refs[tuple(p)] for p in ps])
    for name, row in rows.items():
        emit({"phase": "serve_robust", "case": name, **card, **(
            row if isinstance(row, dict) else {"value": row})})
    return total


# -- serve_obs: the observability surfaces on the full-width engines ----------

# serve_dense's engine (the JAX server's defaults, --warmup=all), and the
# two engine modes serve_obs arms the obs flags on.
OBS_ENGINE_FLAGS = ["--continuous-batching", "--max-slots", "8",
                    "--decode-chunk", "32", "--prefill-chunk", "512",
                    "--warmup", "all"]
OBS_MODES = {"dense": [],
             "paged_ngram": ["--kv-cache", "paged", "--speculate", "ngram"]}
# Repeats of the traffic with every obs flag on and with all off, in
# turns, for the overhead finding (no threshold).
OBS_REPEATS = 3
# The HBM model's weights figure against the allocation loading the bf16
# model caused (the caching allocator rounds each tensor up to 512 B).
HBM_WEIGHTS_RTOL = 0.01
# The ledger's device seconds over every label against the sum of the
# envelopes it booked (the phase counters' seconds): float sums only.
LEDGER_ATOL_S = 1e-9


def obs_flags(workdir, tag, metrics_port):
    """Every obs flag on (``--chip-accounting``, the SLO, ``--trace-out``,
    ``--flight-recorder``, ``--metrics-port``, ``--event-log``), its files
    in ``workdir``."""
    def path(name):
        return os.path.join(workdir, f"{tag}.{name}")

    return ["--chip-accounting", "--slo-ttft-ms", "200", "--slo-tpot-ms",
            "50", "--trace-out", path("trace.json"), "--flight-recorder",
            "--flight-dir", path("flight"), "--flight-window-s", "120",
            "--metrics-port", str(metrics_port), "--event-log",
            path("events.jsonl")]


def serving_families():
    """The tpu_serving_* families the JAX server renders per engine mode
    (``SERVING_FAMILIES`` of tests/test_torch_obs_serving.py, which pins
    them to the JAX server). Read from that file's literal lists: the test
    imports JAX, this script imports nothing of it."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_obs_serving.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    lists = {node.targets[0].id: ast.literal_eval(node.value)
             for node in tree.body if isinstance(node, ast.Assign)
             and len(node.targets) == 1
             and getattr(node.targets[0], "id", None)
             in ("_COMMON", "_PAGED", "_SPEC")}
    common, paged, spec = lists["_COMMON"], lists["_PAGED"], lists["_SPEC"]
    return {"dense": sorted(common), "paged": sorted(common + paged),
            "paged_ngram": sorted(common + paged + spec)}


def exposition(text):
    """{family: {series: value}} of a Prometheus text exposition (an
    exemplar after a sample left out)."""
    kinds = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    out = {name: {} for name in kinds}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.split(" # ", 1)[0].rsplit(" ", 1)
        name = series.split("{", 1)[0]
        if name not in kinds:
            name = re.sub(r"_(bucket|sum|count)$", "", name)
        out.setdefault(name, {})[series] = float(value)
    return out


def _get_text(port, path="/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=600) as resp:
        return resp.read().decode()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shared_prefix_prompts(np, vocab):
    """serve_paged's traffic: a 1024-token prompt (8 new), then 6
    requests sharing it with 64-token suffixes and a 3000-token prompt
    (32 new each)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, 1024).tolist()
    prompts = {"prefix_1024": prefix}
    for i in range(6):
        prompts[f"shared_{i}"] = prefix + rng.integers(0, vocab, 64).tolist()
    prompts["long_3000"] = rng.integers(0, vocab, 3000).tolist()
    max_new = {name: 32 for name in prompts}
    max_new["prefix_1024"] = 8
    return prompts, max_new


def _post_shared_prefix(engine, port, prompts, max_new, phase,
                        headers=None):
    """The first prompt alone, then the 6 sharing it at once and, once
    they decode, the long one. Returns (responses, latency by name, the
    burst's seconds)."""
    results, latency = {}, {}

    def post(name):
        t1 = time.perf_counter()
        status, body = _post_status(
            port, {"tokens": [prompts[name]],
                   "max_new_tokens": max_new[name]},
            headers=None if headers is None else headers[name])
        if status != 200:
            fail(f"{phase} {name}: HTTP {status}: {body}")
        results[name] = body
        latency[name] = time.perf_counter() - t1

    post("prefix_1024")
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(7) as pool:
        futures = [pool.submit(post, f"shared_{i}") for i in range(6)]
        n = engine.stats()["n_chunks"]
        deadline = time.monotonic() + 600
        while engine.stats()["n_chunks"] == n:
            if time.monotonic() > deadline:
                fail(f"{phase}: no decode chunk after the shared requests "
                     f"were posted")
            time.sleep(0.002)
        futures.append(pool.submit(post, "long_3000"))
        for f in futures:
            f.result(timeout=600)
    return results, latency, time.perf_counter() - t1


@contextlib.contextmanager
def _obs_server(torch, serve_cli, model, argv):
    """What ``serve_cli`` builds for ``argv`` over ``model``
    (``build_parser``, ``build_serving``: the engine, its obs surfaces,
    the request metrics, the flight recorder) behind its HTTP server
    (``start_server``, ready) and, under ``--metrics-port``, the metrics
    listener, as ``serve_cli.main`` wires them. Yields (args, engine,
    metrics, port, flight, the bytes building the engine allocated)."""
    from container_engine_accelerators_tpu_torch.obs import (
        flight as obs_flight,
    )
    from container_engine_accelerators_tpu_torch.obs import (
        metrics as obs_metrics,
    )

    import signal

    args = serve_cli.build_parser().parse_args(argv)
    # The flight recorder's crash hooks hold it, and through its state
    # providers the engine: restored after, so the engine is freed.
    hooks = sys.excepthook, signal.getsignal(signal.SIGUSR2)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    engine, metrics, _, flight = serve_cli.build_serving(args, model)
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - alloc0
    server, state = serve_cli.start_server(
        engine, port=0, host="127.0.0.1", warmup_mode=args.warmup,
        metrics=metrics, replica_id=args.replica_id, role=args.role)
    own = None
    try:
        if args.metrics_port:
            own = obs_metrics.serve(args.metrics_port, registry=metrics,
                                    host="127.0.0.1")
        serve_cli.wait_ready(state, timeout=900)
        yield args, engine, metrics, server.server_address[1], flight, built
    finally:
        server.shutdown()
        server.server_close()
        if own is not None:
            own.close()
        if flight is not None:
            flight.close()
            obs_flight.deactivate()
            # The thread serving the recorder's health port kept the
            # excepthook of its creation (threading does, for the thread's
            # end), and with it the recorder: drop its hold on the engine.
            flight._providers.clear()
            flight._streams.clear()
            flight._registries.clear()
        sys.excepthook = hooks[0]
        signal.signal(signal.SIGUSR2, hooks[1])
        engine.shutdown()


def _traffic_run(torch, engine, port, prompts, max_new, phase,
                 headers=None):
    """serve_dense's traffic through ``port`` and what it cost: decode
    tokens/s over the chunks' span on the card and over their host
    wall, the TTFT quantiles, the generated tokens."""
    def snap():
        return {"t_chunk_device_s": engine.t_chunk_device_s,
                "t_chunk_host_s": engine.t_chunk_dispatch_s
                + engine.t_chunk_wait_s,
                "ttft": len(engine.ttft_s), **engine.stats()}

    before = snap()
    results, latency, burst_s = _post_shared_prefix(
        engine, port, prompts, max_new, phase, headers)
    torch.cuda.synchronize()
    after = snap()
    d = {k: after[k] - before[k] for k in (
        "t_chunk_device_s", "t_chunk_host_s", "occupied_steps",
        "steps_done")}
    ttft = [t for _, t in list(engine.ttft_s)[before["ttft"]:]]
    return results, {
        "burst_s": burst_s, "latency_s": latency,
        "decode_tokens_per_s_on_card": d["occupied_steps"]
        / max(d["t_chunk_device_s"], 1e-9),
        "decode_tokens_per_s_host": d["occupied_steps"]
        / max(d["t_chunk_host_s"], 1e-9),
        "ttft": _quantiles(ttft),
        "chunk_device_s": d["t_chunk_device_s"],
        "steps": d["steps_done"],
    }


def _held_obs(phase, mode, families, text, own_text, results, prompts,
              before, after):
    """The /metrics checks: both listeners serve the same families, every
    family the JAX server renders for ``mode`` is there, and the request,
    token, TTFT and TPOT counts match what was served (``before`` and
    ``after``: the expositions around the traffic). Returns the row."""
    got, own = exposition(text), exposition(own_text)
    missing = [f for f in families[mode] if f not in got]
    if sorted(got) != sorted(own) or missing:
        fail(f"{phase}: /metrics and --metrics-port differ, or JAX's "
             f"families are missing: {missing}")

    def delta(family, series):
        return after[family].get(series, 0.0) - \
            before[family].get(series, 0.0)

    served = {name: len(r["tokens"][0]) - len(prompts[name])
              for name, r in results.items()}
    counts = {
        "requests_ok": delta("tpu_serving_requests_total",
                             'tpu_serving_requests_total{outcome="ok"}'),
        "generated_tokens": delta("tpu_serving_generated_tokens_total",
                                  "tpu_serving_generated_tokens_total"),
        "ttft_count": delta("tpu_serving_ttft_seconds",
                            "tpu_serving_ttft_seconds_count"),
        "tpot_count": delta("tpu_serving_tpot_seconds",
                            "tpu_serving_tpot_seconds_count"),
    }
    # The JAX rule: TPOT for a row with more than one token.
    want = {"requests_ok": len(results),
            "generated_tokens": sum(served.values()),
            "ttft_count": len(results),
            "tpot_count": sum(n > 1 for n in served.values())}
    if counts != want:
        fail(f"{phase}: /metrics counts {counts}, served {want}")
    return {"families": len(got), "jax_families": len(families[mode]),
            **counts}


def _held_ledger(phase, engine, at_ready):
    """The chip-accounting invariant and what sits beside it: the ledger's
    device seconds over every label against the envelopes it booked (the
    phase counters' seconds), to LEDGER_ATOL_S; during the traffic, its
    decode and verify seconds beside the CUDA-event span of the same
    chunks and verifies, and the bubbles."""
    led = engine.devicetime
    series = engine.registry.get("tpu_serving_device_seconds_total")
    device_s = sum(c.value for _, c in series._series())
    envelopes = engine._m_t_prefill.value + engine._m_t_chunk.value
    if engine.spec_proposer is not None:
        envelopes += engine._m_t_verify.value
    snap = led.snapshot()
    chunk_phases = ("decode", "verify")
    row = {
        "ledger_device_s": device_s, "envelopes_s": envelopes,
        "ledger_minus_envelopes_s": device_s - envelopes,
        "by_phase_class": snap["per_phase_class"],
        "traffic_ledger_decode_verify_s": sum(
            led.per_phase[p] - at_ready["per_phase"].get(p, 0.0)
            for p in chunk_phases),
        "traffic_cuda_event_span_s":
            engine.t_chunk_device_s + engine.t_verify_device_s
            - at_ready["device_span_s"],
        "traffic_bubble_s": led.total_bubble_s - at_ready["bubble_s"],
        "bubble_ratio": led.bubble_ratio(),
    }
    if abs(device_s - envelopes) > LEDGER_ATOL_S:
        fail(f"{phase}: the ledger holds {device_s!r} s, its envelopes "
             f"{envelopes!r} s")
    for key in ("traffic_ledger_decode_verify_s",
                "traffic_cuda_event_span_s", "traffic_bubble_s",
                "bubble_ratio"):
        if not (math.isfinite(row[key]) and row[key] > 0):
            fail(f"{phase}: {key} = {row[key]!r}, want finite and > 0")
    return row


def _held_hbm(phase, torch, engine, text, load_bytes, built_bytes):
    """The HBM model against the card: ``weights`` within
    HBM_WEIGHTS_RTOL of the allocation loading the model caused (None: a
    quantized model, printed only), ``kv_pool`` the cache tensors' bytes
    exactly; ``total`` beside the peak allocation and the graph pools
    the model does not count."""
    gauges = exposition(text)["tpu_hbm_bytes"]

    def gauge(component):
        return gauges[f'tpu_hbm_bytes{{component="{component}"}}']

    cache_bytes = sum(t.nbytes for t in engine.cache.values())
    graphs = engine.graph_stats()
    row = {
        "weights_model_bytes": gauge("weights"),
        "weights_loaded_bytes": load_bytes,
        "weights_model_over_loaded": gauge("weights") / load_bytes,
        "kv_pool_model_bytes": gauge("kv_pool"),
        "cache_tensor_bytes": cache_bytes,
        "engine_built_bytes": built_bytes,
        "scratch_model_bytes": gauge("scratch"),
        "total_model_bytes": gauge("total"),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "graph_pool_bytes": sum(v for k, v in graphs.items()
                                if k.endswith("graph_pool_bytes")),
        "kv_used_bytes": gauge("kv_used"),
        "kv_watermark_bytes": gauge("kv_watermark"),
    }
    if gauge("kv_pool") != cache_bytes:
        fail(f"{phase}: kv_pool {gauge('kv_pool')} B, the cache tensors "
             f"{cache_bytes} B")
    if phase.endswith("int8"):
        return row
    if abs(gauge("weights") - load_bytes) > HBM_WEIGHTS_RTOL * load_bytes:
        fail(f"{phase}: the HBM model's weights {gauge('weights')} B, "
             f"loading the model allocated {load_bytes} B")
    return row


def _held_flight(phase, port):
    """POST /debug/flight: a bundle holding both registries' deltas, the
    event tail and the recent spans."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/debug/flight",
                                 data=b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        path = json.loads(resp.read())["bundle"]
    with open(path) as f:
        records = [json.loads(line) for line in f]
    snaps = [r for r in records if r["record"] == "snapshot"]
    counters = {k.split("{", 1)[0] for s in snaps for k in s["counters"]}
    kinds = {e["kind"] for s in snaps for e in s.get("events", ())}
    spans = {sp["name"] for s in snaps for sp in s.get("spans", ())}
    row = {"registries": records[0]["registries"],
           "snapshots": len(snaps), "event_kinds": sorted(kinds),
           "span_names": sorted(spans),
           "serving_counters": "tpu_serving_requests_total" in counters,
           "engine_counters": "tpu_serving_engine_steps_total" in counters}
    if row["registries"] != ["serving", "engine"] or not (
            row["serving_counters"] and row["engine_counters"]) or \
            "request_retired" not in kinds or "request" not in spans:
        fail(f"{phase}: the flight bundle lacks a registry, the event "
             f"tail or the spans: {row}")
    return row


def _held_spans(phase, trace_path, trace_ids):
    """The --trace-out Chrome trace: each request's ``request`` span,
    under its traceparent's trace id, nests ``queue``, ``admit``,
    ``prefill`` and ``decode`` on its track."""
    with open(trace_path) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    per_request = {}
    for name, tid in trace_ids.items():
        mine = [e for e in spans if e["args"].get("trace_id") == tid]
        req = [e for e in mine if e["name"] == "request"]
        if len(req) != 1:
            fail(f"{phase} {name}: {len(req)} request spans under its "
                 f"trace id")
        req = req[0]
        nested = {e["name"] for e in mine if e["tid"] == req["tid"]
                  and req["ts"] - 1 <= e["ts"]
                  and e["ts"] + e["dur"] <= req["ts"] + req["dur"] + 1}
        if not {"queue", "admit", "prefill", "decode"} <= nested:
            fail(f"{phase} {name}: the request span nests {nested}")
        per_request[name] = sum(e["name"] == "prefill" for e in mine)
    return {"requests": len(per_request),
            "prefill_spans_by_request": per_request}


def _profiled_request(phase, serve_cli, attention, int8_matmul, port,
                      prompt, max_new, prof_dir, graphs_hold_flash):
    """One request under ``--profile-dir``'s bracket
    (``utils.profiling.trace_or_null``): the trace's kernel events by
    hand-written kernel, against the launches counted meanwhile (which
    leave out the replays of captured graphs: a verify graph holds the
    flash kernel, ``graphs_hold_flash``, and a decode graph the int8
    one)."""
    from container_engine_accelerators_tpu_torch.utils import profiling

    before = (attention.flash_fwd_launches,
              None if int8_matmul is None else int8_matmul.int8_mm_launches)
    with profiling.trace_or_null(prof_dir):
        serve_cli.post_generate(port, [prompt], max_new)
    (name,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, name)) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    row = {"flash_fwd_launches": attention.flash_fwd_launches - before[0],
           "flash_fwd_sm90_kernel_events":
               sum("flash_fwd_sm90_kernel" in k for k in kernels),
           "kernel_events": len(kernels)}
    events, launched = row["flash_fwd_sm90_kernel_events"], \
        row["flash_fwd_launches"]
    if launched <= 0 or events < launched or (
            events != launched and not graphs_hold_flash):
        fail(f"{phase}: the profiler trace holds "
             f"{row['flash_fwd_sm90_kernel_events']} flash_fwd_sm90_kernel "
             f"events for {row['flash_fwd_launches']} launches")
    if int8_matmul is not None:
        row["int8_mm_launches_eager"] = \
            int8_matmul.int8_mm_launches - before[1]
        row["int8_mm_sm90_kernel_events"] = sum(
            "int8_mm_sm90_kernel" in k for k in kernels)
        if row["int8_mm_sm90_kernel_events"] < \
                row["int8_mm_launches_eager"] or \
                not row["int8_mm_sm90_kernel_events"]:
            fail(f"{phase}: the profiler trace holds "
                 f"{row['int8_mm_sm90_kernel_events']} int8_mm_sm90_kernel "
                 f"events for {row['int8_mm_launches_eager']} eager launches")
    return row


def _serve_obs_mode(torch, np, serve_cli, attention, model, mode, workdir,
                    card, load_bytes, int8_matmul=None, overhead=False):
    """One engine mode with every obs flag on, behind the server, on
    serve_dense's traffic (each request under a traceparent of its own):
    the /metrics, ledger, HBM, flight and span checks, one profiled
    request and, with ``overhead``, OBS_REPEATS runs each with the flags
    on and all off (a second engine), in turns. Returns (row, flash
    launches, int8 launches)."""
    from container_engine_accelerators_tpu_torch.obs import (
        flight as obs_flight,
    )
    from container_engine_accelerators_tpu_torch.obs import trace as obs_trace

    phase = "serve_obs_int8" if int8_matmul is not None else \
        f"serve_obs_{mode}"
    families = serving_families()
    prompts, max_new = _shared_prefix_prompts(np, model.cfg.vocab_size)
    trace_ids = {name: obs_trace.new_trace_id() for name in prompts}
    headers = {name: {"traceparent": obs_trace.format_traceparent(
        tid, obs_trace.new_span_id())} for name, tid in trace_ids.items()}
    argv = OBS_ENGINE_FLAGS + OBS_MODES[mode] + obs_flags(
        workdir, phase, _free_port())
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    tracer = obs_trace.configure()
    row = {"phase": phase, **card, "model": "llama3-8b", "mode": mode,
           "argv": argv[len(OBS_ENGINE_FLAGS):]}
    # The main path: counts at zero, then the engine built by the CLI's
    # code, its warm grid, the traffic and the profiled request.
    attention.flash_fwd_launches = 0
    if int8_matmul is not None:
        int8_matmul.int8_mm_launches = int8_matmul.int8_mm_captured = 0
    try:
        with _obs_server(torch, serve_cli, model, argv) as (
                args, engine, metrics, port, flight, built):
            led = engine.devicetime
            at_ready = {"per_phase": dict(led.per_phase),
                        "bubble_s": led.total_bubble_s,
                        "device_span_s": engine.t_chunk_device_s
                        + engine.t_verify_device_s}
            before = exposition(_get_text(port))
            results, run = _traffic_run(torch, engine, port, prompts,
                                        max_new, phase, headers)
            text = _get_text(port)
            row["metrics"] = _held_obs(
                phase, mode, families, text, _get_text(args.metrics_port),
                results, prompts, before, exposition(text))
            row["traffic"] = run
            row["ledger"] = _held_ledger(phase, engine, at_ready)
            row["hbm"] = _held_hbm(phase, torch, engine, text, load_bytes,
                                   built)
            row["flight"] = _held_flight(phase, port)
            tracer.write_chrome(args.trace_out)
            row["spans"] = _held_spans(phase, args.trace_out, trace_ids)
            for name, prompt in prompts.items():
                _check_response(f"{phase} {name}", results[name], prompt,
                                max_new[name], model.cfg.vocab_size)
            row["profile"] = _profiled_request(
                phase, serve_cli, attention, int8_matmul, port,
                prompts["prefix_1024"], max_new["prefix_1024"],
                os.path.join(workdir, f"{phase}.profile"),
                graphs_hold_flash=engine.spec_proposer is not None)
            row["graph_stats"] = engine.graph_stats()
            if engine.graph_stats()["eager_chunks_on_cuda"] or \
                    engine.graph_stats().get("eager_verifies_on_cuda"):
                fail(f"{phase}: a chunk or verify ran eagerly on the card")
            if overhead:
                row["overhead"] = _obs_overhead(
                    torch, serve_cli, model, engine, port, flight, prompts,
                    max_new, phase)
    finally:
        obs_trace.configure(False)
        obs_flight.deactivate()
    launches = attention.flash_fwd_launches
    int8 = None
    if int8_matmul is not None:
        int8 = int8_matmul.int8_mm_launches + 7 * model.cfg.n_layers * \
            row["graph_stats"]["graph_replays"]
    emit(row)
    return row, launches, int8


def _obs_overhead(torch, serve_cli, model, engine, port, flight, prompts,
                  max_new, phase):
    """The traffic OBS_REPEATS times on ``engine`` (every obs flag on:
    the tracer, the flight recorder's snapshots, the ledger, the SLO,
    the event log) and on a second engine with all of them off, in
    turns: decode tokens/s and TTFT p50 of each run, and their spread."""
    from container_engine_accelerators_tpu_torch.obs import (
        flight as obs_flight,
    )
    from container_engine_accelerators_tpu_torch.obs import trace as obs_trace

    runs = {"on": [], "off": []}
    with _obs_server(torch, serve_cli, model, OBS_ENGINE_FLAGS) as (
            _, off_engine, _, off_port, _, _):
        for rep in range(OBS_REPEATS):
            for which in (("on", "off") if rep % 2 == 0 else ("off", "on")):
                if which == "on":
                    obs_trace.configure()
                    obs_flight.install(flight)
                    flight.start()
                    _, run = _traffic_run(torch, engine, port, prompts,
                                          max_new, phase)
                else:
                    obs_trace.configure(False)
                    flight.close()
                    obs_flight.deactivate()
                    _, run = _traffic_run(torch, off_engine, off_port,
                                          prompts, max_new, phase)
                runs[which].append(run)
    out = {}
    for which, rs in runs.items():
        tps = [r["decode_tokens_per_s_on_card"] for r in rs]
        host = [r["decode_tokens_per_s_host"] for r in rs]
        ttft = [r["ttft"]["p50"] for r in rs]
        out[which] = {"decode_tokens_per_s_on_card": tps,
                      "decode_tokens_per_s_host": host,
                      "ttft_p50_s": ttft, "burst_s": [r["burst_s"]
                                                      for r in rs]}
        for key, vals in (("tokens_per_s", tps), ("host_tokens_per_s", host),
                          ("ttft_p50_s", ttft)):
            out[which][f"{key}_mean"] = sum(vals) / len(vals)
            out[which][f"{key}_spread"] = max(vals) - min(vals)
    out["on_over_off_tokens_per_s"] = \
        out["on"]["tokens_per_s_mean"] / out["off"]["tokens_per_s_mean"]
    out["on_over_off_ttft_p50"] = \
        out["on"]["ttft_p50_s_mean"] / out["off"]["ttft_p50_s_mean"]
    return out


def serve_obs(torch, np, serve_cli, attention, card, model, bf16):
    """The serving observability surfaces on full-width Llama-3-8B (the
    serve phases' bf16 model from seed 0): the dense engine and the paged
    engine with ``--speculate ngram``, each built by the CLI's own code
    with ``--chip-accounting --slo-ttft-ms 200 --slo-tpot-ms 50
    --trace-out --flight-recorder --metrics-port`` (and ``--event-log``)
    behind the HTTP server, on serve_dense's traffic. Checks: ``/metrics``
    and the ``--metrics-port`` listener serve the same families, every
    tpu_serving_* family the JAX server renders for the mode among them,
    and their request, token, TTFT and TPOT counts are what was served;
    the device-time ledger sums to the envelopes it booked, beside the
    chunks' CUDA-event span and the bubbles; the HBM model's weights
    within HBM_WEIGHTS_RTOL of the allocation loading the model caused,
    its ``kv_pool`` the cache tensors' bytes; ``POST /debug/flight``'s
    bundle; each request's spans under its traceparent; one request under
    ``--profile-dir`` naming ``flash_fwd_sm90_kernel`` once per launch.
    On the dense engine, the overhead: the traffic OBS_REPEATS times with
    every flag on and all off. Returns the flash kernel's launches."""
    import tempfile

    launches = 0
    with tempfile.TemporaryDirectory(prefix="serve_obs-") as workdir:
        for mode in OBS_MODES:
            _, n, _ = _serve_obs_mode(
                torch, np, serve_cli, attention, model, mode, workdir, card,
                bf16["load_allocated_bytes"], overhead=mode == "dense")
            launches += n
    return launches


# serve_handoff: two paged engines at the JAX server's engine defaults,
# each built by the CLI's code with its --role and --replica-id.
HANDOFF_ENGINE_FLAGS = ["--continuous-batching", "--kv-cache", "paged",
                        "--max-slots", "8", "--decode-chunk", "32",
                        "--prefill-chunk", "512", "--kv-block-size", "16",
                        "--warmup", "all"]
HANDOFF_NEW = 32


def _timed_loop_calls(engine):
    """Wrap ``engine.run_on_loop`` so that each call's seconds on the loop
    thread land in the returned list: the engine side of a handoff
    operation, apart from its wait to be taken up."""
    seconds, real = [], engine.run_on_loop

    def run_on_loop(fn, timeout_s=None):
        def timed():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                seconds.append(time.perf_counter() - t0)

        return real(timed, timeout_s=timeout_s)

    engine.run_on_loop = run_on_loop
    return seconds


def _timed_post(port, path, body):
    """(status, decoded body, seconds): the round trip of a POST, the
    request's JSON encoding and the response's decoding included."""
    t0 = time.perf_counter()
    status, out = _post_status(port, body, timeout=900, path=path)
    return status, out, time.perf_counter() - t0


def _flush_prefixes(engine):
    """Evict every cached prefix of an idle paged engine (the radix
    index's LRU eviction, on the loop): the next admissions prefill
    cold."""
    engine.run_on_loop(lambda: engine.kv.radix.evict(
        engine.kv.pool, len(engine.kv.radix)))
    if engine.kv_stats()["cached_blocks"]:
        fail(f"serve_handoff: {engine.kv_stats()['cached_blocks']} blocks "
             f"still cached after the flush")


def serve_handoff(torch, np, tf, serve_cli, attention, card, model):
    """Cross-replica KV handoff on full-width Llama-3-8B (the serve
    phases' bf16 model from seed 0): a prefill replica p0 and a decode
    replica d0, paged engines at the JAX server's engine defaults built
    by the CLI's code (``--role prefill --replica-id p0``, ``--role decode
    --replica-id d0``), behind the HTTP server. A client does what JAX's
    router does for a split request, one request at a time: the prompt
    with ``max_new_tokens`` 1 on p0 (the prefill leg), ``POST
    /kv/export`` on p0, ``POST /kv/install`` on d0, the request on d0.
    Traffic: serve_paged's 1024- and 3000-token prompts (32 new each),
    then the 6 prompts sharing the 1024-token prefix at once; then d0's
    prefixes flushed, both prompts cold on d0 (the unified reference);
    flushed again, a ``corrupt_payload`` and a ``drop`` fault on the
    ``serving.handoff`` site through the port's ``perturb_frames``.
    Checks: installed blocks = exported (64, 187); d0's pools hold p0's
    bytes at the installed ids, bit for bit, and keep their addresses;
    d0's prefix hits grow by at least 1008 and 2992; d0's tokens equal
    p0's second serving (the same radix hit over the same bytes) bit for
    bit; the sharing prompts hit on d0; every served token within
    SERVE_LOGITS_ATOL of its teacher-forced top logit; each fault
    answers 409 and leaves d0's free and cached blocks and radix size as
    they were, and the fallback's tokens equal the cold reference;
    ``eager_chunks_on_cuda`` 0 on both; flash launches = 32 per prefill
    segment. Prints each transfer's engine seconds, HTTP round trips,
    wire bytes and MB/s, d0's TTFT handed off and cold, the split path
    against the unified TTFT. Returns the flash kernel's launches."""
    from container_engine_accelerators_tpu_torch import faults
    from container_engine_accelerators_tpu_torch.kvcache import handoff

    cfg = model.cfg
    prompts, _ = _shared_prefix_prompts(np, cfg.vocab_size)
    big = ("prefix_1024", "long_3000")
    shared = [n for n in prompts if n.startswith("shared_")]
    row = {"phase": "serve_handoff", **card, "model": "llama3-8b",
           "n_layers": cfg.n_layers, "argv": HANDOFF_ENGINE_FLAGS}
    _free(torch)
    torch.cuda.reset_peak_memory_stats()

    def served(port, name, max_new, what):
        status, out, secs = _timed_post(
            port, "/generate", {"tokens": [prompts[name]],
                                "max_new_tokens": max_new})
        if status != 200:
            fail(f"serve_handoff {name} ({what}): HTTP {status}: {out}")
        _check_response(f"serve_handoff {name} ({what})", out,
                        prompts[name], max_new, cfg.vocab_size)
        return out["tokens"][0], secs

    # The main path: counts at zero, then both replicas built (their warm
    # grids), the traffic, the flushes and the faults.
    attention.flash_fwd_launches = 0
    with contextlib.ExitStack() as stack:
        ports, engines = {}, {}
        for rid, role in (("p0", "prefill"), ("d0", "decode")):
            _, engines[rid], _, ports[rid], _, _ = stack.enter_context(
                _obs_server(torch, serve_cli, model, HANDOFF_ENGINE_FLAGS
                            + ["--role", role, "--replica-id", rid]))
            health = json.loads(_get_text(ports[rid], "/healthz"))
            if (health.get("role"), health.get("replica")) != (role, rid):
                fail(f"serve_handoff: {rid}'s /healthz is {health}")
        p0, d0 = engines["p0"], engines["d0"]
        bs = d0.kv.block_size
        at_ready = {"launches": attention.flash_fwd_launches,
                    "n_prefills": p0.stats()["n_prefills"]
                    + d0.stats()["n_prefills"]}
        ptrs = [t.data_ptr() for t in d0.cache.values()]
        loop_s = {"p0": _timed_loop_calls(p0), "d0": _timed_loop_calls(d0)}
        frames, streams, legs = {}, {}, {}
        for name in big:
            prompt = prompts[name]
            n_blocks = len(prompt) // bs
            _, prefill_leg_s = served(ports["p0"], name, 1, "prefill leg")
            status, out, export_http_s = _timed_post(
                ports["p0"], "/kv/export",
                {"tokens": prompt, "traceparent": "00-" + "1" * 32 + "-"
                 + "2" * 16 + "-01"})
            frames[name] = out.get("frames") or []
            if status != 200 or len(frames[name]) != n_blocks + 2:
                fail(f"serve_handoff {name}: export answered {status} with "
                     f"{len(frames[name])} frames, want {n_blocks + 2}")
            export_s = loop_s["p0"][-1]
            hit0 = d0.kv_stats()["prefix_hit_tokens"]
            status, summary, install_http_s = _timed_post(
                ports["d0"], "/kv/install", {"frames": frames[name]})
            if status != 200 or summary["installed_blocks"] != n_blocks:
                fail(f"serve_handoff {name}: install answered {status}: "
                     f"{summary}, want {n_blocks} installed blocks")
            install_s = loop_s["d0"][-1]
            # The installed bytes are the exported ones, bit for bit.
            ids = torch.tensor(d0.run_on_loop(
                lambda: d0.kv.radix.match(prompt)), device="cuda")
            sent = torch.tensor([f["payload"]["block"]
                                 for f in frames[name][1:-1]],
                                device="cuda")
            if len(ids) != n_blocks or not all(
                    torch.equal(d0.cache[k][:, ids].view(torch.int16),
                                p0.cache[k][:, sent].view(torch.int16))
                    for k in ("k", "v")):
                fail(f"serve_handoff {name}: d0's pools do not hold the "
                     f"exported bytes at the {len(ids)} installed ids")
            got, _ = served(ports["d0"], name, HANDOFF_NEW, "handed off")
            receiver_ttft_s = d0.ttft_s[-1][1]
            hit = d0.kv_stats()["prefix_hit_tokens"] - hit0
            if hit < (len(prompt) - 1) // bs * bs:
                fail(f"serve_handoff {name}: d0 reused {hit} tokens of the "
                     f"handed-off prefix")
            want, _ = served(ports["p0"], name, HANDOFF_NEW,
                             "the sender's second serving")
            if got != want:
                fail(f"serve_handoff {name}: d0's tokens part from p0's "
                     f"radix-hit tokens at {_equal_prefix(got, want, 0)}")
            streams[f"{name}_handed_off"] = (prompt, got)
            nbytes = handoff.frames_nbytes(frames[name])
            legs[name] = {
                "blocks": n_blocks, "frames": len(frames[name]),
                "wire_bytes": nbytes, "export_s": export_s,
                "install_s": install_s, "export_http_s": export_http_s,
                "install_http_s": install_http_s,
                "export_http_mb_per_s": nbytes / export_http_s / 1e6,
                "install_http_mb_per_s": nbytes / install_http_s / 1e6,
                "prefill_leg_s": prefill_leg_s,
                "receiver_ttft_s": receiver_ttft_s,
                "split_path_s": prefill_leg_s + export_http_s
                + install_http_s + receiver_ttft_s,
                "prefix_hit_tokens": hit, "installed": summary,
            }
        hit0 = d0.kv_stats()["prefix_hit_tokens"]
        results = _post_all(ports["d0"], [
            {"tokens": [prompts[n]], "max_new_tokens": HANDOFF_NEW}
            for n in shared])
        for n, (status, out) in zip(shared, results):
            if status != 200:
                fail(f"serve_handoff {n}: HTTP {status}: {out}")
            _check_response(f"serve_handoff {n}", out, prompts[n],
                            HANDOFF_NEW, cfg.vocab_size)
            streams[n] = (prompts[n], out["tokens"][0])
        row["shared_prefix_hit_tokens"] = \
            d0.kv_stats()["prefix_hit_tokens"] - hit0
        if row["shared_prefix_hit_tokens"] < len(shared) * 1024:
            fail(f"serve_handoff: the sharing prompts reused "
                 f"{row['shared_prefix_hit_tokens']} tokens on d0, want "
                 f"{len(shared)} x 1024")
        # The unified reference: each prompt cold on the same receiver.
        _flush_prefixes(d0)
        cold = {}
        for name in big:
            cold[name], _ = served(ports["d0"], name, HANDOFF_NEW, "cold")
            legs[name]["cold_ttft_s"] = d0.ttft_s[-1][1]
            legs[name]["split_over_unified"] = \
                legs[name]["split_path_s"] / legs[name]["cold_ttft_s"]
            streams[f"{name}_cold"] = (prompts[name], cold[name])
        # Faults: a stream corrupted or cut in flight is refused with 409
        # and changes nothing; the request then prefills on d0.
        _flush_prefixes(d0)
        row["faults"] = {}
        for kind, name in (("corrupt_payload", "prefix_1024"),
                           ("drop", "long_3000")):
            faults.arm(faults.FaultPlan([{
                "kind": kind, "site": handoff.HANDOFF_FAULT_SITE, "at": 0,
                "count": 1}]))
            try:
                bad = handoff.perturb_frames(frames[name])
            finally:
                faults.disarm()
            before = (d0.kv_stats(), len(d0.kv.radix))
            status, out, _ = _timed_post(ports["d0"], "/kv/install",
                                         {"frames": bad})
            after = (d0.kv_stats(), len(d0.kv.radix))
            if status != 409 or after != before:
                fail(f"serve_handoff {kind}: install answered {status} "
                     f"({out}); d0 before {before}, after {after}")
            hit0 = d0.kv_stats()["prefix_hit_tokens"]
            got, _ = served(ports["d0"], name, HANDOFF_NEW, "fallback")
            if got != cold[name] or \
                    d0.kv_stats()["prefix_hit_tokens"] != hit0:
                fail(f"serve_handoff {kind}: the fallback's tokens part "
                     f"from the cold reference or reused a prefix")
            row["faults"][kind] = {"prompt": name, "status": status,
                                   "error": out.get("error", "")[:120]}
        graphs = {rid: e.graph_stats() for rid, e in engines.items()}
        stats = {rid: e.stats() for rid, e in engines.items()}
        kvs = {rid: e.kv_stats() for rid, e in engines.items()}
        if [t.data_ptr() for t in d0.cache.values()] != ptrs:
            fail("serve_handoff: d0's pools moved")
    launches = attention.flash_fwd_launches
    served_segments = sum(s["n_prefills"] for s in stats.values()) - \
        at_ready["n_prefills"]
    if launches - at_ready["launches"] != cfg.n_layers * served_segments:
        fail(f"serve_handoff: {launches - at_ready['launches']} flash "
             f"launches after ready for {served_segments} prefill segments")
    if any(g["eager_chunks_on_cuda"] for g in graphs.values()):
        fail(f"serve_handoff: a chunk ran eagerly on the card: {graphs}")
    names = list(streams)
    held = _served_gaps(torch, tf, model.model,
                        [streams[n][0] for n in names],
                        [streams[n][1] for n in names])
    if held["gaps_over_tol"]:
        fail(f"serve_handoff: {held['gaps_over_tol']} served tokens lie "
             f"{SERVE_LOGITS_ATOL} or more below the dense forward's top "
             f"logit: {held}")
    row.update(transfers=legs, served_tokens=held, tol=SERVE_LOGITS_ATOL,
               flash_fwd_launches=launches,
               flash_fwd_launches_at_ready=at_ready["launches"],
               served_segments=served_segments, kv=kvs,
               graph_stats=graphs,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9)
    emit(row)
    return launches


def hostbench_phase():
    """The port's host-loop microbench (``kvcache/hostbench.py``) on this
    machine's CPU: a port engine on the CPU with fake device seams, so
    the time per token is the host loop's. A host measurement, not a
    card one."""
    from container_engine_accelerators_tpu_torch.kvcache import hostbench

    row = {"phase": "hostbench",
           "measures": "the host loop on the CPU (the engine on the CPU, "
                       "fake device seams), not the card"}
    for mode, kw in (("paged", {}), ("dense", {"kv_cache": "dense"}),
                     ("paged_ngram", {"requests": 24,
                                      "speculate": "ngram"})):
        result = hostbench.run_hostbench(**{"requests": 32, "max_new": 32,
                                            **kw})
        row[mode] = {k: result.get(k) for k in (
            "host_us_per_token", "prefix_hit_ratio",
            "device_steps_per_token", "tokens", "wall_s")}
    emit(row)


# compile_cache: one fresh process arms the cache in a directory, builds
# the nvcc libraries and launches each Triton stream kernel once at a
# small size, then prints its counts; the phase runs it twice on one
# directory.
COMPILE_CACHE_CHILD = r"""
import json, os, sys, time
import torch
from container_engine_accelerators_tpu_torch.ops import _ext, stream
from container_engine_accelerators_tpu_torch.warmstart import cache as ws
cache = ws.configure(sys.argv[1], key="chip_smoke")
t0 = time.perf_counter()
_ext.build()
build_s = time.perf_counter() - t0
nvcc = sorted(n for n, i in _ext.build_info.items() if i["seconds"] > 0)
after_nvcc = cache.snapshot()
x, y, z = (torch.ones(1 << 16, device="cuda", dtype=torch.bfloat16)
           for _ in range(3))
acc = torch.zeros(1, device="cuda")
t0 = time.perf_counter()
triton = {"error": None}
try:
    stream.triad(x, y, z, 2.0, 1e-3, z)
    stream.stream_read(x, acc, 1e-9)
    stream.stream_copy(x, y, z, c=0.5, eps=1e-3)
    torch.cuda.synchronize()
except RuntimeError as e:
    if "compiled specialisations" not in str(e):
        raise
    triton["error"] = str(e)
triton_s = time.perf_counter() - t0
end = cache.snapshot()
files = sorted(os.path.relpath(os.path.join(r, f), cache.dir)
               for r, _, fs in os.walk(cache.dir) for f in fs)
print(json.dumps({
    "nvcc": {"hits": after_nvcc["hits"], "misses": after_nvcc["misses"],
             "ran": nvcc, "seconds": build_s},
    "triton": {"hits": end["hits"] - after_nvcc["hits"],
               "misses": end["misses"] - after_nvcc["misses"],
               "seconds": triton_s, "error": triton["error"]},
    "files": files}))
"""


def compile_cache_phase(card):
    """The persistent compile cache (``warmstart/cache.py``) on the card:
    two fresh processes in turn on one new directory, each arming the
    cache there, building the nvcc libraries and launching each Triton
    stream kernel once. The first must miss each of the three libraries
    (and run nvcc for each), the second hit each and run no nvcc; the
    same for Triton's specialisations, unless this Triton's count cannot
    be read (the line then says why)."""
    import tempfile

    from container_engine_accelerators_tpu_torch.ops import _ext

    work = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", COMPILE_CACHE_CHILD, work],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            fail(f"compile_cache: a child exited {proc.returncode}:\n"
                 f"{proc.stderr[-4000:]}")
        runs.append({**json.loads(proc.stdout.strip().splitlines()[-1]),
                     "process_s": time.perf_counter() - t0})
    cold, warm = runs
    row = {"phase": "compile_cache", **card, "dir": work,
           "cold": cold, "warm": warm}
    emit(row)
    n = len(_ext.SOURCES)
    if cold["nvcc"]["misses"] != n or len(cold["nvcc"]["ran"]) != n:
        fail(f"compile_cache: the first process missed "
             f"{cold['nvcc']['misses']} and ran nvcc for "
             f"{cold['nvcc']['ran']}, want each of the {n} libraries")
    if warm["nvcc"] != {**warm["nvcc"], "hits": n, "misses": 0, "ran": []}:
        fail(f"compile_cache: the second process counted "
             f"{warm['nvcc']}, want {n} hits, no miss and no nvcc")
    if warm["files"] != cold["files"] and any(
            f.startswith("torch_ext/") for f in
            set(warm["files"]) - set(cold["files"])):
        fail("compile_cache: the second process added libraries")
    if cold["triton"]["error"] is None:
        if cold["triton"]["misses"] < len(STREAM_KERNELS) or \
                warm["triton"]["misses"] or \
                warm["triton"]["hits"] != cold["triton"]["misses"]:
            fail(f"compile_cache: Triton counted {cold['triton']} cold "
                 f"and {warm['triton']} warm; want a miss for each "
                 f"stream kernel, then as many hits and no miss")
    return row


def train_cli_cache_phase(card):
    """``train_cli --compile-cache-dir`` twice in fresh processes on one
    directory, at the CLI's small transformer default with an event log
    and a preemption at step 2 under ``--max-restarts 1``: the first
    run's builds miss (nvcc runs for the flash libraries), the second's
    only hit, and each run's supervisor restart event carries its
    attempt's ``cache_hits``/``cache_misses``."""
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_cache_")
    cache_dir = os.path.join(work, "cache")
    plan = os.path.join(work, "plan.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"kind": "preemption", "site": "train.step",
                               "at": 2}]}, f)
    runs = []
    for i in range(2):
        events = os.path.join(work, f"events{i}.jsonl")
        argv = [sys.executable, "-m",
                "container_engine_accelerators_tpu_torch.models.train_cli",
                "--model", "transformer", "--steps", "4",
                "--compile-cache-dir", cache_dir, "--event-log", events,
                "--fault-plan", plan, "--max-restarts", "1",
                "--restart-backoff-s", "0.01", "--checkpoint-every", "1",
                "--checkpoint-dir", os.path.join(work, f"ckpt{i}")]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            fail(f"train_cli_cache: run {i} exited {proc.returncode}:\n"
                 f"{proc.stderr[-4000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(events) as f:
            records = [json.loads(line) for line in f if line.strip()]
        kinds = {}
        for r in records:
            kinds.setdefault(r.get("kind") or r.get("event"), []).append(r)
        restarts = [{k: r.get(k) for k in ("cache_hits", "cache_misses",
                                           "attempt", "action")}
                    for r in kinds.get("train_recovery", [])]
        (configured,) = kinds.get("compile_cache_configured", [None])
        runs.append({"process_s": time.perf_counter() - t0,
                     "restarts": result.get("restarts"),
                     "loss": result.get("loss"),
                     "recovery_events": restarts,
                     "configured": configured and {
                         k: configured[k] for k in ("key", "runtime_cache")},
                     "libraries": sorted(os.listdir(os.path.join(
                         configured["dir"], "torch_ext")))
                     if configured else None})
    cold, warm = runs
    emit({"phase": "train_cli_cache", **card, "cold": cold, "warm": warm})
    for name, run in (("cold", cold), ("warm", warm)):
        if run["configured"] is None or run["restarts"] != 1 or \
                len(run["recovery_events"]) != 1 or \
                not math.isfinite(run["loss"]):
            fail(f"train_cli_cache: the {name} run: {run}")
        if run["recovery_events"][0]["cache_hits"] is None:
            fail(f"train_cli_cache: the {name} run's restart event "
                 f"carries no cache deltas: {run['recovery_events']}")
    if cold["configured"]["key"] != warm["configured"]["key"]:
        fail("train_cli_cache: the two runs keyed their caches apart")
    first, second = (r["recovery_events"][0] for r in runs)
    if first["cache_misses"] < 1 or second["cache_misses"] or \
            second["cache_hits"] < 1 or \
            warm["libraries"] != cold["libraries"]:
        fail(f"train_cli_cache: cold attempt {first}, warm attempt "
             f"{second}, libraries {cold['libraries']} then "
             f"{warm['libraries']}: want misses, then only hits and no "
             f"new library")


# The reduced tenant day of fleet_drills (JAX's CLI default is 150000,
# its tier-1 twin's 20000).
DAY_REQUESTS = 8000


def fleet_drills_phase():
    """The port's hermetic fleet tier on this machine's CPU (fake device
    seams, no card), at each CLI's defaults: the replica-kill chaos drill
    (``fleet/sim.py``), the restart storm (``faults/storm.py``), the
    disaggregation bench (``fleet/disagg.py``, its strict timing gates
    on), the request-journey drill (``fleet/journeydrill.py``, its
    stage-sum gate on), the flight drill (``fleet/flightdrill.py``: a
    wedged link, one bundle, the wedge attributed first) and a reduced
    tenant day (``fleet/daysim.py`` at DAY_REQUESTS). Fails on any
    ``pass: false``."""
    import tempfile

    from container_engine_accelerators_tpu_torch.faults import storm
    from container_engine_accelerators_tpu_torch.fleet import daysim
    from container_engine_accelerators_tpu_torch.fleet import disagg
    from container_engine_accelerators_tpu_torch.fleet import flightdrill
    from container_engine_accelerators_tpu_torch.fleet import journeydrill
    from container_engine_accelerators_tpu_torch.fleet import sim

    row = {"phase": "fleet_drills",
           "measures": "the fleet tier's host loop on the CPU (fake device "
                       "seams), not the card"}
    drills = {
        "chaos": lambda: sim.run_drill(),
        "storm": lambda: storm.run_drill(
            work_dir=tempfile.mkdtemp(prefix="chip_smoke_storm_")),
        "disagg": lambda: disagg.run_bench(),
        "journey": lambda: journeydrill.run_drill()[0],
        "flight": lambda: flightdrill.run_flight_drill(
            tempfile.mkdtemp(prefix="chip_smoke_flight_")),
        "day": lambda: daysim.run_day(requests=DAY_REQUESTS),
    }
    keep = {
        "chaos": ("requests", "served", "retired", "reissued", "ejections",
                  "readmissions", "scale_outs", "scale_ins",
                  "replicas_final"),
        "storm": ("restarts", "attempts", "checkpoint_fallbacks",
                  "serve_timing", "compile_cache", "train_compile_s"),
        "disagg": ("baseline", "unified", "split", "storm", "fault",
                   "tpot_inflation_unified", "tpot_inflation_split"),
        "journey": ("measured", "stitched", "stitch_ratio", "journeys",
                    "hedged_with_leg", "handoff_journeys", "exemplar",
                    "sum_mismatches", "stage_percentiles"),
        "flight": ("trigger", "snapshots", "first_anomaly",
                   "first_anomaly_rel_s", "correlated_kinds"),
        "day": ("requests_total", "served", "retired", "premium_goodput",
                "expected_quota_sheds", "phase_shed", "hedged",
                "scale_outs", "scale_ins", "reconcile", "replicas_final",
                "fairness_audit"),
    }
    failed = []
    for name, run in drills.items():
        t0 = time.perf_counter()
        verdict = run()
        row[name] = {"pass": verdict["pass"],
                     "seconds": time.perf_counter() - t0,
                     "failures": verdict["failures"],
                     **{k: verdict.get(k) for k in keep[name]}}
        if not verdict["pass"]:
            failed.append(name)
    emit(row)
    if failed:
        fail(f"fleet_drills: {failed} failed: "
             f"{[row[n]['failures'] for n in failed]}")


def serve_obs_int8(torch, np, serve_cli, attention, int8_matmul, card,
                   model, load_bytes):
    """serve_obs's dense checks on the int8 model (``--quantize int8``):
    every obs flag on, the same traffic, one profiled request naming
    ``int8_mm_sm90_kernel`` beside the flash kernel, and the HBM model's
    weights figure (JAX's: every matrix at bf16) printed beside the
    allocation loading the int8 model caused. Returns (flash launches,
    int8_mm launches)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="serve_obs_int8-") as workdir:
        _, flash, int8 = _serve_obs_mode(
            torch, np, serve_cli, attention, model, "dense", workdir, card,
            load_bytes, int8_matmul=int8_matmul)
    return flash, int8


@contextlib.contextmanager
def plain_int8(int8_matmul):
    """Inside the block, every int8 projection of the model (which
    ``transformer._mm`` sends to ``int8_matmul.int8_mm``) runs the plain
    version on the card: the reference the served int8 streams are held
    to. The port itself never does this."""
    kernel = int8_matmul.int8_mm
    int8_matmul.int8_mm = int8_matmul.int8_mm_reference
    try:
        yield
    finally:
        int8_matmul.int8_mm = kernel


def _equal_prefix(a, b, start):
    """How many tokens from ``start`` on the streams a and b share."""
    n = 0
    for x, y in zip(a[start:], b[start:]):
        if x != y:
            break
        n += 1
    return n


def _serve_int8_generate(torch, np, serve_cli, attention, int8_matmul,
                         model, bf16):
    """``Model.generate`` on the int8 model behind the HTTP server, the
    serve phase's p1500 requests (its prompt, from the same seed): TTFT
    and decode ms/token beside serve's bf16 figures of this run. Every
    request's prefill launches the kernel 7 × layers times, every decode
    step replays a graph that records as many."""
    cfg = model.cfg
    per = 7 * cfg.n_layers
    rng = np.random.default_rng(0)  # serve's prompts, in serve's order
    rng.integers(0, cfg.vocab_size, (1, 17))
    rng.integers(0, cfg.vocab_size, (2, 300))
    p1500 = rng.integers(0, cfg.vocab_size, (1, 1500)).tolist()
    requests = [("p1500", 32), ("p1500_ttft", 1), ("p1500_again", 32)]
    graphs = model.decode_graphs.graphs
    attention.flash_fwd_launches = 0
    int8_matmul.int8_mm_launches = int8_matmul.int8_mm_captured = 0
    server, state = serve_cli.start_server(model, port=0, host="127.0.0.1")
    results, bad = {}, []
    try:
        serve_cli.wait_ready(state, timeout=600)
        port = server.server_address[1]
        if int8_matmul.int8_mm_launches != per:
            bad.append(f"warmup prefill: {int8_matmul.int8_mm_launches}")
        for name, max_new in requests:
            before = int8_matmul.int8_mm_launches
            results[name] = serve_cli.post_generate(port, p1500, max_new)
            if int8_matmul.int8_mm_launches - before != per:
                bad.append(f"{name}: {int8_matmul.int8_mm_launches - before}")
            _check_response(f"serve_int8 {name}", results[name], p1500[0],
                            max_new, cfg.vocab_size)
    finally:
        server.shutdown()
        server.server_close()
    counted = int8_matmul.int8_mm_launches
    if int8_matmul.int8_mm_captured != per * graphs.captures:
        bad.append(f"captured {int8_matmul.int8_mm_captured} in "
                   f"{graphs.captures} graphs")
    if bad:
        fail(f"serve_int8 generate: int8 products not 7 × {cfg.n_layers} "
             f"per prefill or per captured step: {bad}")
    if results["p1500"]["tokens"] != results["p1500_again"]["tokens"]:
        fail("serve_int8: the same greedy request gave different tokens")
    ttft = results["p1500_ttft"]["latency_s"]
    stream = results["p1500_again"]["tokens"][0]
    row = {
        "ttft_s_p1500": ttft,
        "decode_ms_per_token_p1500":
            (results["p1500_again"]["latency_s"] - ttft) / 31 * 1e3,
        "bf16_ttft_s_p1500": bf16["ttft_s_p1500"],
        "bf16_decode_ms_per_token_p1500": bf16["decode_ms_per_token_p1500"],
        "greedy_equal_to_bf16": _equal_prefix(stream, bf16["p1500_tokens"],
                                              1500),
        "graph_captures": graphs.captures, "graph_replays": graphs.replays,
        "int8_mm_launches_counted": counted,
        "int8_mm_launches": counted + per * graphs.replays,
        "flash_fwd_launches": attention.flash_fwd_launches,
    }
    return row, p1500[0], stream


def _serve_int8_dense(torch, np, tf, serve_cli, attention, int8_matmul,
                      model, card):
    """The dense engine (8 slots, chunk 32, prefill chunk 512) on the
    int8 model behind the server with ``--warmup=all``, on serve_dense's
    traffic: a 1024-token prompt, then 6 requests sharing it and, once
    they decode, a 3000-token prompt. Checks: every (window, mask) graph
    captured before ready and none after, no eager chunk, every step a
    replay, the kernel 7 × layers per eager forward (warm prefills, the
    warmup request, the served prefills and segments) and per captured
    step. Returns (row, prompts, streams)."""
    cfg = model.cfg
    per = 7 * cfg.n_layers
    vocab = cfg.vocab_size
    engine = serve_cli.ContinuousEngine(model, max_slots=8, chunk=32,
                                        prefill_chunk=512)
    prompts, max_new = _shared_prefix_prompts(np, vocab)

    def snapshot():
        return {"launches": attention.flash_fwd_launches,
                "int8": int8_matmul.int8_mm_launches,
                "t_chunk_device_s": engine.t_chunk_device_s,
                "ttft": len(engine.ttft_s),
                **engine.stats(), **engine.graph_stats()}

    attention.flash_fwd_launches = 0
    int8_matmul.int8_mm_launches = int8_matmul.int8_mm_captured = 0
    t0 = time.perf_counter()
    server, state = serve_cli.start_server(engine, port=0, host="127.0.0.1",
                                           warmup_mode="all")
    try:
        serve_cli.wait_ready(state, timeout=900)
        ready_s = time.perf_counter() - t0
        port = server.server_address[1]
        warm = state["warmup"]
        at_ready = snapshot()
        results, _, burst_s = _post_shared_prefix(
            engine, port, prompts, max_new, "serve_int8")
        done = snapshot()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    served = {k: done[k] - at_ready[k] for k in (
        "launches", "int8", "steps_done", "n_prefills", "occupied_steps",
        "t_chunk_device_s", "graph_captures", "graph_replays")}
    ttft = [{"prompt_len": n, "ttft_s": t}
            for n, t in list(engine.ttft_s)[at_ready["ttft"]:]]
    n_graphs = 2 * len(tf.serving_shape_buckets(cfg, 512, 32)["windows"])
    warm_prefills = warm["tasks"] - n_graphs
    replays = done["graph_replays"]
    row = {
        "ready_s": ready_s, "warmup": warm, "burst_s": burst_s,
        "ttft": ttft, **{f"served_{k}": v for k, v in served.items()},
        "decode_tokens_per_s_on_card": served["occupied_steps"]
        / max(served["t_chunk_device_s"], 1e-9),
        "chunk_step_device_ms": served["t_chunk_device_s"]
        / max(served["steps_done"], 1) * 1e3,
        "graph_captures": done["graph_captures"],
        "captures_after_ready": served["graph_captures"],
        "graph_replays": replays,
        "graph_pool_gb": done["graph_pool_bytes"] / 1e9,
        "eager_chunks_on_cuda": done["eager_chunks_on_cuda"],
        "cache_gb": sum(c.nbytes for c in engine.cache.values()) / 1e9,
        "int8_mm_launches_counted": done["int8"],
        "int8_mm_launches": done["int8"] + per * replays,
        "int8_mm_captured": int8_matmul.int8_mm_captured,
        "flash_fwd_launches": done["launches"],
    }
    del engine
    for name, prompt in prompts.items():
        _check_response(f"serve_int8 dense {name}", results[name], prompt,
                        max_new[name], vocab)
    if at_ready["graph_captures"] != n_graphs or served["graph_captures"] \
            or done["eager_chunks_on_cuda"] or \
            served["graph_replays"] != served["steps_done"]:
        emit({"phase": "serve_int8_dense", **card, **row})
        fail("serve_int8: the dense engine captured a graph after ready, "
             "ran a chunk eagerly, or a step was not a replay")
    if at_ready["int8"] != per * (warm_prefills + at_ready["n_prefills"]) \
            or served["int8"] != per * served["n_prefills"] or \
            row["int8_mm_captured"] != per * done["graph_captures"] or \
            served["launches"] != cfg.n_layers * served["n_prefills"]:
        emit({"phase": "serve_int8_dense", **card, **row})
        fail("serve_int8: the dense engine's int8 products or flash "
             "launches do not match 7 × (or 1 ×) layers per eager forward "
             "and per captured step")
    names = list(prompts)
    return row, [prompts[n] for n in names], \
        [results[n]["tokens"][0] for n in names]


def serve_int8(torch, np, tf, serve_cli, attention, int8_matmul, q8, card,
               bf16):
    """``--quantize int8`` on full-width Llama-3-8B from seed 0, quantized
    on the card (``serve_cli.Model(quantize="int8")``, the bf16 source
    the serve phases ran): ``Model.generate`` behind the server, the
    dense engine on serve_dense's traffic with ``--warmup=all``, and the
    paged engine with ``--speculate ngram`` on serve_spec's requests,
    every verify a replay. Every served stream is held, teacher-forced on
    its own context, to the same int8 weights through
    ``int8_mm_reference`` on the card: each served token within
    SERVE_LOGITS_ATOL of the reference's top logit. The greedy agreement
    with the bf16 model is printed, not held (random weights have
    near-ties). ``bf16``: the serve phases' figures of this run. Returns
    the kernel's launches by path."""
    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=SERVE_LAYERS)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    alloc0 = torch.cuda.memory_allocated()
    model = serve_cli.Model(cfg, seed=0, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    load_bytes = torch.cuda.memory_allocated() - alloc0
    row = {"phase": "serve_int8", **card, "model": "llama3-8b",
           "n_layers": cfg.n_layers, "init_and_quantize_s":
               time.perf_counter() - t0,
           "weight_gb": weight_bytes(model.model) / 1e9,
           "bf16_weight_gb": bf16["weight_bytes"] / 1e9,
           "quantize_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not q8.model_is_quantized(model.model):
        fail("serve_int8: Model(quantize='int8') left the model dense")
    gen_row, p1500, gen_stream = _serve_int8_generate(
        torch, np, serve_cli, attention, int8_matmul, model, bf16)
    row["generate"] = gen_row
    torch.cuda.reset_peak_memory_stats()
    dense_row, dense_prompts, dense_streams = _serve_int8_dense(
        torch, np, tf, serve_cli, attention, int8_matmul, model, card)
    dense_row["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    for key in ("decode_tokens_per_s_on_card", "chunk_step_device_ms",
                "ready_s", "max_memory_allocated_gb"):
        dense_row[f"bf16_{key}"] = bf16["dense"][key]
    dense_row["greedy_equal_to_bf16"] = [
        _equal_prefix(a, b, len(p)) for p, a, b in
        zip(dense_prompts, dense_streams, bf16["dense"]["streams"])]
    row["dense"] = dense_row
    _free(torch)
    rng = np.random.default_rng(7)  # serve_spec's requests
    spec_prompts = []
    for _ in range(4):
        pattern = rng.integers(0, cfg.vocab_size, SPEC_PATTERN)
        spec_prompts.append(
            np.tile(pattern, SPEC_PROMPT // SPEC_PATTERN).tolist())
    spec_row, spec_streams, _ = _serve_spec_mode(
        torch, np, serve_cli, attention, model, "ngram", spec_prompts, card,
        int8_matmul, phase="serve_int8_spec")
    if not spec_row["verifies"]:
        fail("serve_int8: the speculating engine ran no verify")
    obs_flash, obs_int8 = serve_obs_int8(
        torch, np, serve_cli, attention, int8_matmul, card, model,
        load_bytes)
    _free(torch)
    with plain_int8(int8_matmul):
        held = _served_gaps(
            torch, tf, model.model, [p1500] + dense_prompts + spec_prompts,
            [gen_stream] + dense_streams + spec_streams)
    row["served_tokens_vs_int8_reference"] = held
    row["tol"] = SERVE_LOGITS_ATOL
    emit(row)
    if held["gaps_over_tol"]:
        fail(f"serve_int8: {held['gaps_over_tol']} served tokens lie "
             f"{SERVE_LOGITS_ATOL} or more below the int8 reference's top "
             f"logit on their own context: {held}")
    return {"serve_int8_generate": gen_row["int8_mm_launches"],
            "serve_int8_dense": dense_row["int8_mm_launches"],
            "serve_int8_spec": spec_row["int8_mm_launches"],
            "serve_obs_int8": obs_int8}, obs_flash


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def _grad_errors(torch, got, ref):
    """``got``'s gradients against ``ref``'s by name, in f32: the names
    outside ``TRAIN_GRAD_TOL`` (relative L2 error, largest error over the
    largest |gradient|) or not finite, and the worst readings."""
    bad, worst_l2, worst_max, worst_name = [], 0.0, 0.0, None
    for name, r in ref.items():
        g, r = got[name].float(), r.float()
        rel_l2 = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
        _, max_rel = _rel_err(g, r)
        if not torch.isfinite(g).all() or \
                rel_l2 > TRAIN_GRAD_TOL["rel_l2"] or \
                max_rel > TRAIN_GRAD_TOL["max_rel"]:
            bad.append(name)
        if rel_l2 > worst_l2:
            worst_l2, worst_name = rel_l2, name
        worst_max = max(worst_max, max_rel)
    return bad, {"n_params_compared": len(ref), "worst_rel_l2": worst_l2,
                 "worst_rel_l2_param": worst_name, "worst_max_rel": worst_max}


def train_grads(torch, np, tf, attention):
    """Loss and every parameter's gradient of full-width Llama-3-8B (2
    layers, bf16, B 1, S 2048) through the kernels vs the same model with
    plain attention (mha_reference under autograd)."""
    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(), n_layers=2)
    model = tf.init_params(cfg, device="cuda", seed=0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 2049))
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}

    def loss_and_grads(attn_impl):
        model.zero_grad(set_to_none=True)
        loss = tf.loss_fn(model, batch, attn_impl=attn_impl)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    before = [attention.flash_fwd_launches, attention.flash_dq_launches,
              attention.flash_dkv_launches]
    loss_k, grads_k = loss_and_grads("flash")
    launches = [attention.flash_fwd_launches - before[0],
                attention.flash_dq_launches - before[1],
                attention.flash_dkv_launches - before[2]]
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    loss_r, grads_r = loss_and_grads("reference")
    bad, errs = _grad_errors(torch, grads_k, grads_r)
    row = {
        "phase": "train_grads", "model": "llama3-8b", "n_layers": 2,
        "batch": 1, "seq_len": 2048, "dtype": "bfloat16",
        "loss_kernels": loss_k, "loss_plain": loss_r, **errs,
        "tol": TRAIN_GRAD_TOL, "launches_fwd_dq_dkv": launches,
    }
    emit(row)
    if bad or abs(loss_k - loss_r) > TRAIN_GRAD_TOL["loss_abs"] or \
            not math.isfinite(loss_k):
        fail(f"gradients through the kernels disagree with plain attention "
             f"for {bad or 'the loss'}")
    if launches != [cfg.n_layers] * 3:
        fail(f"train_grads launched fwd/dq/dkv {launches} times, want "
             f"{cfg.n_layers} each")


def train(torch, np, tf, attention, card, n_layers=8, steps=5):
    """The training slice's main path: full-width Llama-3-8B cut to
    ``n_layers``, bf16, B 1 at the model's full context (8192), through
    make_train_step (AdamW, per-layer remat). One warm-up step, then
    ``steps`` timed steps with the kernel counts at zero before them.
    Returns the counts (fwd, dq, dkv)."""
    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=n_layers)
    seq = cfg.max_seq_len
    init_state, train_step = tf.make_train_step(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = init_state(seed=0)
    n_params = sum(p.numel() for p in state[0].parameters())

    def batch(step):
        rng = np.random.default_rng(1 + step)
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, seq + 1)), device="cuda")}

    t0 = time.perf_counter()
    state, loss = train_step(state, batch(0))
    warm = [loss.item()]
    warm_s = time.perf_counter() - t0
    # Random tied weights: the logits are about N(0, d_model * 0.02^2)
    # (unit-RMS normed states against N(0, 0.02^2) embeddings), so the
    # first loss is about ln(V) + d_model * 0.02^2 / 2.
    expected = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2

    attention.flash_fwd_launches = 0
    attention.flash_dq_launches = 0
    attention.flash_dkv_launches = 0
    losses, step_s = [], []
    for step in range(1, steps + 1):
        b = batch(step)
        t0 = time.perf_counter()
        state, loss = train_step(state, b)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    launches = (attention.flash_fwd_launches, attention.flash_dq_launches,
                attention.flash_dkv_launches)
    mean_s = sum(step_s) / len(step_s)
    row = {
        "phase": "train", **card, "model": "llama3-8b",
        "n_layers": n_layers, "n_layers_full": 32,
        "depth_cut": f"{n_layers} of 32 layers: bf16 params, grads and two "
                     f"AdamW moments of all 32 would need ~64 GB before "
                     f"activations",
        "batch": 1, "seq_len": seq, "dtype": "bfloat16", "remat": True,
        "n_params": n_params, "warmup_loss": warm[0],
        "warmup_s": warm_s, "expected_first_loss": expected,
        "ln_vocab": math.log(cfg.vocab_size),
        "losses": losses, "step_ms": [t * 1e3 for t in step_s],
        "mean_step_ms": mean_s * 1e3, "tokens_per_s": seq / mean_s,
        "est_mfu": 6.0 * n_params * seq / mean_s / PEAK_BF16_FLOPS,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             launches)),
        "launches_per_step_want": [2 * n_layers, n_layers, n_layers],
    }
    emit(row)
    if not all(math.isfinite(x) for x in warm + losses):
        fail("non-finite training loss")
    if abs(warm[0] - expected) > 0.5:
        fail(f"first loss {warm[0]} is not within 0.5 of {expected}")
    want = (2 * n_layers * steps, n_layers * steps, n_layers * steps)
    if launches != want:
        fail(f"{steps} steps launched fwd/dq/dkv {launches} times, want "
             f"{want} (remat: the forward twice per layer and step)")
    return launches


def train_cli_phase(train_cli):
    """The port's train_cli at its default tiny flags on the card."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["--model", "transformer", "--steps", "3"])
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    emit({"phase": "train_cli", "rc": rc, "result": result})
    if rc != 0 or set(result) != TRAIN_CLI_KEYS:
        fail(f"train_cli: rc {rc}, keys {sorted(result)}, want "
             f"{sorted(TRAIN_CLI_KEYS)}")
    if not math.isfinite(result["loss"]) or result["steps_run"] != 3:
        fail("train_cli: no finite loss after 3 steps")


def _flash_counts(attention):
    return (attention.flash_fwd_launches, attention.flash_dq_launches,
            attention.flash_dkv_launches)


def _zero_flash_counts(attention):
    attention.flash_fwd_launches = 0
    attention.flash_dq_launches = 0
    attention.flash_dkv_launches = 0


def train_bert_grads(torch, np, bert, attention):
    """BERT-large cut to 2 layers (bf16, B 8, S 512): the loss and every
    parameter's gradient through the flash kernels vs the same model with
    JAX's plain f32 attention (``attn_impl="reference"``), held to
    TRAIN_GRAD_TOL as train_grads holds the decoder: the kernels round p
    to bf16 before P·V, the plain path keeps it f32, about one bf16 step
    per element through two layers' backward."""
    cfg = dataclasses.replace(bert.BertConfig.bert_large(), n_layers=2)
    model = bert.init_params(cfg, device="cuda", seed=0)
    batch = bert.synthetic_mlm_batch(np.random.default_rng(1), 8, cfg,
                                     device="cuda")

    def loss_and_grads(attn_impl):
        model.zero_grad(set_to_none=True)
        loss = bert.loss_fn(model, batch, attn_impl=attn_impl)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    before = _flash_counts(attention)
    loss_k, grads_k = loss_and_grads("flash")
    launches = [a - b for a, b in zip(_flash_counts(attention), before)]
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    loss_r, grads_r = loss_and_grads("reference")
    bad, errs = _grad_errors(torch, grads_k, grads_r)
    emit({
        "phase": "train_bert_grads", "model": "bert-large", "n_layers": 2,
        "batch": 8, "seq_len": cfg.max_seq_len, "dtype": "bfloat16",
        "loss_kernels": loss_k, "loss_plain": loss_r, **errs,
        "tol": TRAIN_GRAD_TOL, "launches_fwd_dq_dkv": launches,
    })
    if bad or abs(loss_k - loss_r) > TRAIN_GRAD_TOL["loss_abs"] or \
            not math.isfinite(loss_k):
        fail(f"BERT gradients through the kernels disagree with plain "
             f"attention for {bad or 'the loss'}")
    if launches != [cfg.n_layers] * 3:
        fail(f"train_bert_grads launched fwd/dq/dkv {launches} times, "
             f"want {cfg.n_layers} each")


def train_bert(torch, np, attention, card, steps=5):
    """BERT-large MLM at full width and depth (vocab 30522, d 1024, 24
    layers, 16 heads, d_ff 4096, S 512, B 8, bf16) through
    ``bert.make_train_step`` (AdamW, no remat): one warm-up step, then
    ``steps`` timed ones with the kernel counts at zero before them; every
    layer's unmasked attention is the non-causal flash forward, dq and
    dk/dv. Returns the counts (fwd, dq, dkv)."""
    from container_engine_accelerators_tpu_torch.models import bert

    train_bert_grads(torch, np, bert, attention)
    _free(torch)
    cfg = bert.BertConfig.bert_large()
    batch_size = 8
    init_state, train_step = bert.make_train_step(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = init_state(seed=0)
    n_params = sum(p.numel() for p in state[0].parameters())

    def batch(step):
        return bert.synthetic_mlm_batch(np.random.default_rng(1 + step),
                                        batch_size, cfg, device="cuda")

    t0 = time.perf_counter()
    state, loss = train_step(state, batch(0))
    warm = loss.item()
    warm_s = time.perf_counter() - t0
    # Random weights: the MLM head's LayerNorm leaves unit-variance
    # states, the tied embedding is N(0, 0.02^2), so the logits are about
    # N(0, d_model * 0.02^2) and the first loss about ln(V) + d_model *
    # 0.02^2 / 2.
    expected = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2

    _zero_flash_counts(attention)
    losses, step_s = [], []
    for step in range(1, steps + 1):
        b = batch(step)
        t0 = time.perf_counter()
        state, loss = train_step(state, b)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    launches = _flash_counts(attention)
    mean_s = sum(step_s) / len(step_s)
    tokens = batch_size * cfg.max_seq_len
    flops = 6.0 * n_params * tokens
    row = {
        "phase": "train_bert", **card, "model": "bert-large",
        "vocab": cfg.vocab_size, "d_model": cfg.d_model,
        "n_layers": cfg.n_layers, "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
        "batch": batch_size, "seq_len": cfg.max_seq_len, "dtype": cfg.dtype,
        "remat": False, "n_params": n_params, "warmup_loss": warm,
        "warmup_s": warm_s, "expected_first_loss": expected,
        "losses": losses, "step_ms": [t * 1e3 for t in step_s],
        "mean_step_ms": mean_s * 1e3, "tokens_per_s": tokens / mean_s,
        "flops_per_step": flops,
        "step_ms_at_peak": flops / PEAK_BF16_FLOPS * 1e3,
        "est_mfu": flops / mean_s / PEAK_BF16_FLOPS,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             launches)),
        "launches_per_step_want": [cfg.n_layers] * 3,
    }
    emit(row)
    if not all(math.isfinite(x) for x in [warm] + losses):
        fail("non-finite BERT training loss")
    if abs(warm - expected) > 0.5:
        fail(f"first BERT loss {warm} is not within 0.5 of {expected}")
    want = (cfg.n_layers * steps,) * 3
    if launches != want:
        fail(f"{steps} BERT steps launched fwd/dq/dkv {launches} times, "
             f"want {want} (no remat: each kernel once per layer and step)")
    return launches


def _cli_run(train_cli, argv):
    """train_cli.main(argv) in this process → (rc, its result JSON)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


# train_cli_models: each --model at the CLI's defaults for 3 steps, and
# the flash launches each must make (fwd, dq, dkv): 2 layers × 3 steps;
# the transformer's per-layer remat runs the forward twice.
CLI_MODELS = {
    "mnist": ([], (0, 0, 0)),
    "resnet": ([], (0, 0, 0)),
    "bert": ([], (6, 6, 6)),
    "transformer": (["--n-experts", "4"], (12, 6, 6)),
}


def train_cli_models(train_cli, attention):
    """``train_cli.main`` for every --model at its defaults on the card
    (the default --model mnist, resnet18_ish at 64, bert, the transformer
    with 4 experts): rc 0, finite losses, the JAX CLI's result keys and
    the flash launches each model's path makes. Returns the launches."""
    total = [0, 0, 0]
    for model, (extra, want) in CLI_MODELS.items():
        argv = ["--steps", "3", *extra]
        if model != "mnist":  # mnist is the default --model
            argv = ["--model", model, *argv]
        before = _flash_counts(attention)
        rc, result = _cli_run(train_cli, argv)
        launches = tuple(a - b for a, b in
                         zip(_flash_counts(attention), before))
        total = [t + n for t, n in zip(total, launches)]
        emit({"phase": "train_cli_models", "argv": argv, "rc": rc,
              "result": result, "launches_fwd_dq_dkv": launches})
        if rc != 0 or set(result) != TRAIN_CLI_KEYS:
            fail(f"train_cli {argv}: rc {rc}, keys {sorted(result)}, want "
                 f"{sorted(TRAIN_CLI_KEYS)}")
        if result["model"] != model or result["steps_run"] != 3 or \
                not math.isfinite(result["loss"]):
            fail(f"train_cli {argv}: no finite loss after 3 steps")
        if launches != want:
            fail(f"train_cli {argv} launched fwd/dq/dkv {launches}, want "
                 f"{want}")
    return tuple(total)


# train_recovery: BERT at the CLI's defaults (bf16), 6 steps, checkpoints
# every 2, a preemption at train.step hit 3. Where the card's run is not
# bit-reproducible (the index and gather backwards accumulate with
# atomics), the faulted run is held to the straight one within: the loss
# to 2e-2 (about 7 in bf16 MLM), every parameter to 2 · lr for each of the
# 4 steps after the restart plus one bf16 step (2^-8) of its magnitude.
RECOVERY_STEPS = 6
RECOVERY_TOL = {"loss_abs": 2e-2, "param_abs": 2 * 1e-4 * 4,
                "param_rel": 2.0 ** -8}


def _state_diff(torch, a, b, path=""):
    """(largest |a - b| over the tensors, over the limit set by
    RECOVERY_TOL, whether every tensor and value is equal) of two
    checkpoint states."""
    if isinstance(a, dict):
        out = [_state_diff(torch, a[k], b[k], f"{path}.{k}") for k in a]
    elif isinstance(a, (list, tuple)):
        out = [_state_diff(torch, x, y, path) for x, y in zip(a, b)]
    elif torch.is_tensor(a):
        if not a.is_floating_point():
            return 0.0, 0.0, bool(torch.equal(a, b))
        diff = (a.float() - b.float()).abs()
        limit = RECOVERY_TOL["param_abs"] + \
            RECOVERY_TOL["param_rel"] * b.float().abs()
        return (diff.max().item() if diff.numel() else 0.0,
                (diff / limit).max().item() if diff.numel() else 0.0,
                bool(torch.equal(a, b)))
    else:
        return 0.0, 0.0, a == b
    out = out or [(0.0, 0.0, True)]
    return (max(o[0] for o in out), max(o[1] for o in out),
            all(o[2] for o in out))


def train_recovery(torch, train_cli, attention):
    """The training loop's recovery on the card through ``train_cli``:
    a supervised BERT run preempted at step 3 restarts once from the
    step-2 checkpoint and ends where an unfaulted run ends; then its
    newest checkpoint is corrupted and the next run quarantines it,
    emits ``checkpoint_fallback`` and resumes one checkpoint earlier.
    Returns the flash launches (fwd, dq, dkv) of its runs."""
    import shutil
    import tempfile

    from container_engine_accelerators_tpu_torch.utils import checkpointing

    work = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    before = _flash_counts(attention)
    try:
        plan = os.path.join(work, "plan.json")
        with open(plan, "w") as f:
            json.dump({"faults": [{"kind": "preemption",
                                   "site": "train.step", "at": 3}]}, f)
        base = ["--model", "bert", "--steps", str(RECOVERY_STEPS),
                "--checkpoint-every", "2"]
        dirs = {n: os.path.join(work, n) for n in ("a", "a2", "b")}
        results = {}
        for name in ("a", "a2"):
            rc, results[name] = _cli_run(
                train_cli, base + ["--checkpoint-dir", dirs[name]])
            if rc != 0:
                fail(f"train_recovery straight run {name}: rc {rc}")
        ev = os.path.join(work, "ev.jsonl")
        rc, faulted = _cli_run(train_cli, base + [
            "--checkpoint-dir", dirs["b"], "--max-restarts", "1",
            "--restart-backoff-s", "0.01", "--event-log", ev,
            "--fault-plan", plan])
        if rc != 0 or set(faulted) != TRAIN_CLI_SUPERVISED_KEYS:
            fail(f"train_recovery faulted run: rc {rc}, keys "
                 f"{sorted(faulted)}")

        def final(name):
            return torch.load(os.path.join(
                dirs[name], f"step_{RECOVERY_STEPS}",
                checkpointing.STATE_FILE), weights_only=True)

        straight = final("a")
        _, _, reproducible = _state_diff(torch, final("a2"), straight)
        max_abs, over, exact = _state_diff(torch, final("b"), straight)
        loss_gap = abs(faulted["loss"] - results["a"]["loss"])
        row = {
            "phase": "train_recovery", "model": "bert",
            "steps": RECOVERY_STEPS, "restarts": faulted["restarts"],
            "start_step": faulted["start_step"],
            "loss_straight": results["a"]["loss"],
            "loss_straight_again": results["a2"]["loss"],
            "loss_faulted": faulted["loss"],
            "bit_exact": exact and loss_gap == 0.0,
            "straight_runs_bit_equal": reproducible,
            "max_abs_state_diff": max_abs, "over_tol": over,
            "tol": RECOVERY_TOL, "goodput": faulted["goodput"],
        }
        if not row["bit_exact"]:
            row["reason"] = (
                "not bit for bit: two unfaulted runs on the card "
                + ("differ too (atomic accumulation in the embedding "
                   "index and the label gather backwards)"
                   if not reproducible else "are bit-equal"))
        if faulted["restarts"] != 1 or faulted["start_step"] != 2:
            emit(row)
            fail("train_recovery: want 1 restart from step 2")
        if not row["bit_exact"] and (
                reproducible or over > 1.0
                or loss_gap > RECOVERY_TOL["loss_abs"]):
            emit(row)
            fail("train_recovery: the resumed run left the unfaulted one")

        # The newest checkpoint corrupted: quarantined, one step back.
        newest = os.path.join(dirs["b"], f"step_{RECOVERY_STEPS}")
        for root, _, files in os.walk(newest):
            for fn in files:
                with open(os.path.join(root, fn), "wb") as f:
                    f.write(b"garbage")
        rc, resumed = _cli_run(train_cli, base[:2] + [
            "--steps", str(RECOVERY_STEPS + 2), "--checkpoint-every", "2",
            "--checkpoint-dir", dirs["b"], "--event-log", ev])
        with open(ev) as f:
            fallbacks = [r for r in map(json.loads, f)
                         if r.get("kind") == "checkpoint_fallback"]
        row.update(
            resumed_start_step=resumed.get("start_step"),
            fallback_events=len(fallbacks),
            quarantined=os.path.isdir(newest + ".corrupt"),
            resumed_goodput=resumed.get("goodput"),
        )
        emit(row)
        if rc != 0 or resumed["start_step"] != RECOVERY_STEPS - 2 or \
                len(fallbacks) != 1 or not row["quarantined"] or \
                "goodput" not in resumed:
            fail("train_recovery: a corrupt newest checkpoint was not "
                 "quarantined with one fallback to the prior step")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return tuple(a - b for a, b in zip(_flash_counts(attention), before))


# -- ring attention's kernel half and the distributed CLI ---------------------

# The ring phase: Llama-3-8B's attention widths at S 32768, bf16, causal,
# every rank's steps of a ring of RING_SPS ranks run in this process
# through parallel/ring_attention.py's own step functions.
RING_SEQ = 32768
RING_SPS = (2, 4)
RING_HEADS = (32, 8)
RING_D = 128
# The assembled ring is held to the whole-sequence flash kernels by
# parallel/world_smoke.py's ring_errors under its RING_TOL, the limits
# the four-card ring is held to.
# The ranks of each ring whose every shard call is held to its plain
# version: at sp 2 both (a diagonal, a past and a wholly-future shard), at
# sp 4 rank 1 (diagonal, past, two wholly-future shards).
RING_HELD_RANKS = {2: (0, 1), 4: (1,)}


def _held_shard_call(torch, attention, q, k, v, out, lse, g, delta, q_base,
                     k_base, sm_scale):
    """One rank's shard call, kernel against plain version at the shard's
    bases (forward, then the backward at the ring's global lse and δ):
    the errors, and the wholly-future shard's exact zeros."""
    kw = dict(causal=True, sm_scale=sm_scale, q_base=q_base, k_base=k_base)
    o_k, lse_k = attention.flash_fwd(q, k, v, **kw)
    o_p, lse_p = attention.flash_fwd_reference(q, k, v, **kw)
    tol = TOL["bfloat16"]
    diff = (o_k.float() - o_p.float()).abs()
    fwd_err = diff.max().item()
    lse_err = (lse_k - lse_p).abs().max().item()
    ok = bool((diff <= tol["out_atol"] + tol["out_rtol"]
               * o_p.float().abs()).all()) and lse_err <= tol["lse_atol"]
    got = attention.flash_bwd(q, k, v, out, lse, g, delta=delta, **kw)
    ref = attention.flash_bwd_reference(q, k, v, out, lse, g, delta=delta,
                                        **kw)
    errs = {name: grad_errors(a, b) for name, a, b in zip(
        ("dq", "dk", "dv"), got, ref)}
    btol = BWD_TOL["bfloat16"]
    for name, (_, rel_l2, row) in errs.items():
        if ref[("dq", "dk", "dv").index(name)].abs().max() == 0:
            continue  # the wholly-future shard: held exactly below
        ok = ok and rel_l2 <= btol["rel_l2"] and row <= btol["row"]
    future = k_base >= q_base + q.shape[2]
    if future:
        ok = ok and not o_k.any() and bool((lse_k == -1e30).all()) and \
            not any(t.any() for t in got)
    return ok, {"future": future, "max_abs_err_out": fwd_err,
                "max_abs_err_lse": lse_err,
                **{f"{n}_max_abs_err": e[0] for n, e in errs.items()},
                **{f"{n}_rel_l2": e[1] for n, e in errs.items()},
                **{f"{n}_worst_row": e[2] for n, e in errs.items()}}


def ring_phase(torch, attention, ra, ws, card, device="cuda"):
    """The ring's kernel half at full width: for each ring size, every
    rank's forward and backward ring through the module's own loops
    (``ring_flash_forward``/``ring_flash_backward`` over an
    ``InProcess`` transport: the same steps, combine, dk/dv travel and
    casts as between processes; the counts zeroed before and read after:
    sp² launches of each kernel), the assembled out, lse, dq, dk and dv
    held to the whole-sequence flash forward and backward by
    ``world_smoke.ring_errors``, the held ranks' shard
    calls held to their plain versions, and each step timed (its kernel
    and the f32 combine or accumulate) beside the whole-sequence
    kernels. Returns the launches (fwd, dq, dk/dv) and the per-ring
    rows."""
    hq, hkv = RING_HEADS
    gen = torch.Generator(device=device).manual_seed(16)

    def rand(h):
        return torch.randn(1, h, RING_SEQ, RING_D, generator=gen,
                           device=device).to(torch.bfloat16)

    q, k, v, g = rand(hq), rand(hkv), rand(hkv), rand(hq)
    sm_scale = RING_D ** -0.5
    whole_kw = dict(causal=True, sm_scale=sm_scale)
    out_w, lse_w = attention.flash_fwd(q, k, v, **whole_kw)
    grads_w = attention.flash_bwd(q, k, v, out_w, lse_w, g, **whole_kw)
    whole_ms = {
        "fwd": time_ms(lambda: attention.flash_fwd(q, k, v, **whole_kw),
                       torch, budget_ms=100),
        "bwd": time_ms(lambda: attention.flash_bwd(
            q, k, v, out_w, lse_w, g, **whole_kw), torch, budget_ms=100),
    }
    whole_bound = {kind: flash_bound(1, hq, hkv, RING_SEQ, RING_SEQ, RING_D,
                                     "bfloat16", True, kind=kind)[0]
                   for kind in ("fwd", "bwd")}
    launches = [0, 0, 0]
    rows = {}
    for sp in RING_SPS:
        sl = RING_SEQ // sp
        qs, ks, vs, gs = ([t.contiguous() for t in x.split(sl, dim=2)]
                          for x in (q, k, v, g))
        transport = ra.InProcess(sp)
        _zero_flash_counts(attention)
        outs, lses = ra.ring_flash_forward(qs, ks, vs, transport, True,
                                           sm_scale)
        dqs, dks, dvs = ra.ring_flash_backward(qs, ks, vs, outs, lses, gs,
                                               transport, True, sm_scale)
        torch.cuda.synchronize()
        counts = _flash_counts(attention)
        if counts != (sp * sp,) * 3:
            fail(f"ring sp {sp}: launches {counts}, want {sp * sp} of each "
                 f"kernel (every rank, every step)")
        launches = [a + b for a, b in zip(launches, counts)]
        got = {"out": torch.cat(outs, 2), "lse": torch.cat(lses, 2),
               "dq": torch.cat(dqs, 2), "dk": torch.cat(dks, 2),
               "dv": torch.cat(dvs, 2)}
        want = {"out": out_w, "lse": lse_w, **dict(zip(("dq", "dk", "dv"),
                                                       grads_w))}
        errs, ok = ws.ring_errors(got, want)
        del got
        deltas = [ra.delta_of(o, g) for o, g in zip(outs, gs)]
        held = {}
        for r in RING_HELD_RANKS[sp]:
            for t in range(sp):
                src = (r - t) % sp
                good, held[f"r{r}_t{t}_src{src}"] = _held_shard_call(
                    torch, attention, qs[r], ks[src], vs[src], outs[r],
                    lses[r], gs[r], deltas[r], r * sl, src * sl, sm_scale)
                if not good:
                    fail(f"ring sp {sp}: rank {r} step {t} (shard {src}) "
                         f"disagrees with its plain version: "
                         f"{held[f'r{r}_t{t}_src{src}']}")
                _free(torch)
        steps = []
        for r in range(sp):
            for t in range(sp):
                src = (r - t) % sp
                kw = dict(causal=True, sm_scale=sm_scale, q_base=r * sl,
                          k_base=src * sl)
                acc = [torch.zeros(x.shape, dtype=torch.float32,
                                   device=device)
                       for x in (qs[r], ks[src], vs[src])]
                out_f = outs[r].float()
                steps.append({
                    "rank": r, "step": t, "shard": src,
                    "fwd_ms": time_ms(lambda: ra.fwd_step(
                        qs[r], ks[src], vs[src], out_f, lses[r], **kw),
                        torch, budget_ms=100),
                    "bwd_ms": time_ms(lambda: ra.bwd_step(
                        qs[r], ks[src], vs[src], outs[r], lses[r], gs[r],
                        deltas[r], *acc, **kw), torch, budget_ms=100),
                    "fwd_bound_ms": flash_bound(
                        1, hq, hkv, sl, sl, RING_D, "bfloat16", True,
                        r * sl, src * sl, kind="fwd")[0],
                    "bwd_bound_ms": flash_bound(
                        1, hq, hkv, sl, sl, RING_D, "bfloat16", True,
                        r * sl, src * sl, kind="bwd")[0],
                })
        per_rank = {
            kind: [sum(s[f"{kind}_ms"] for s in steps if s["rank"] == r)
                   for r in range(sp)] for kind in ("fwd", "bwd")}
        rows[f"sp{sp}"] = {
            "shard": sl, "launches": counts, "errors": errs,
            "tol": ws.RING_TOL, "held": held, "steps": steps,
            "rank_ms": per_rank,
            "ring_ms": {kind: max(v) for kind, v in per_rank.items()},
        }
        emit({"phase": "ring", **card, "sp": sp, "seq": RING_SEQ,
              "heads": RING_HEADS, "d": RING_D, "dtype": "bfloat16",
              "whole_ms": whole_ms, "whole_bound_ms": whole_bound,
              **rows[f"sp{sp}"]})
        if not ok:
            fail(f"ring sp {sp}: the assembled ring disagrees with the "
                 f"whole-sequence flash: {errs}")
        del outs, lses, dqs, dks, dvs, deltas, qs, ks, vs, gs
        _free(torch)
    return tuple(launches), rows


# pipeline: Llama-3-8B's widths, 8 of its 32 layers as 4 stages of 2,
# M 8 microbatches of 1 × S 4096, every stage in this process
# (parallel/ring_attention.InProcess), 3 steps of models/pipeline_lm.py.
PP_STAGES = 4
PP_LAYERS = 8
PP_MICRO = 8
PP_SEQ = 4096
PP_STEPS = 3


def _pp_launches_per_step(stages, layers, micro):
    """Flash launches of one 1F1B step with recompute: every stage but
    the last runs its layers' forward under no_grad at its forward tick,
    and every stage runs it again under autograd at its backward tick
    (the last stage's two ticks coincide, so it runs it once), then one
    dq and one dk/dv launch a layer and microbatch."""
    per = layers // stages
    return ((2 * stages - 1) * per * micro, layers * micro, layers * micro)


def _unsplit_step(torch, tf, cfg, flat, steps=2):
    """The unsplit model's AdamW step (``make_train_step``'s model,
    optimizer and per-layer remat) on the flattened batch, its gradient
    accumulated over the rows in f32: one ``loss_fn`` call over all 8 ×
    4096 tokens needs more than the card's 80 GB (its f32 logits are
    16.8 GB, and their backward holds several such), so each row's mean
    loss over M is backpropagated in turn. ``steps`` steps on the batch.
    Returns (the first step's loss, its bf16 gradients at the initial
    weights by name, each step's wall ms, peak GB)."""
    init1, _ = tf.make_train_step(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    model, opt = init1(seed=0)
    rows = flat["tokens"].shape[0]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device="cuda")
           for p in model.parameters()]
    first, step_ms = None, []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = torch.zeros((), dtype=torch.float32, device="cuda")
        for a in acc:
            a.zero_()
        for r in range(rows):
            model.zero_grad(set_to_none=True)
            part = tf.loss_fn(model, {"tokens": flat["tokens"][r:r + 1]},
                              remat=True) / rows
            part.backward()
            loss += part.detach().float()
            for a, p in zip(acc, model.parameters()):
                a += p.grad.float()
        for a, p in zip(acc, model.parameters()):
            # A copy even for an f32 parameter (an MoE router): the next
            # step zeroes and refills ``acc``.
            p.grad = a.to(p.dtype, copy=True)
        opt.step()
        loss = loss.item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = (loss, {n: p.grad for n, p in model.named_parameters()})
    return (*first, step_ms, torch.cuda.max_memory_allocated() / 1e9)


def pipeline_phase(torch, np, tf, attention, ra, card):
    """The pipeline-parallel training path at full width: 8 layers of
    Llama-3-8B as 4 stages × 2 (bf16), 8 microbatches of 1 × 4096,
    through ``pipeline_lm.make_pp_train_step`` over the ``InProcess``
    transport (every stage's ticks in this process, serially), 3 steps.
    The first step's loss and gradients are held to the unsplit step's
    (``_unsplit_step``: the whole model, the flattened batch of 8 × 4096
    tokens, the gradient accumulated row by row) on the same initial
    weights within ``TRAIN_GRAD_TOL``; flash
    launches per step to the schedule's count; the stage's attention
    calls (kernels 1, 3, 4 at 1 × 32/8 × 4096 × 128) to their plain
    versions. Prints the step ms beside the unsplit step's, the
    schedule's bubble and the peak memory. Returns the launches of the
    3 steps (fwd, dq, dkv)."""
    from container_engine_accelerators_tpu_torch.models import pipeline_lm

    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=PP_LAYERS)
    rng = np.random.default_rng(18)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (PP_MICRO, 1, PP_SEQ + 1)), device="cuda")}
        for _ in range(PP_STEPS)]
    flat = {"tokens": batches[0]["tokens"].reshape(PP_MICRO, PP_SEQ + 1)}

    # The unsplit step on the initial weights: its loss, its gradients
    # (kept, bf16) and its wall time.
    loss1, ref, unsplit_ms, unsplit_peak_gb = _unsplit_step(
        torch, tf, cfg, flat)
    _free(torch)

    # The same weights split over the stages.
    init, step = pipeline_lm.make_pp_train_step(cfg, ra.InProcess(PP_STAGES),
                                                device="cuda")
    model = tf.init_params(cfg, device="cuda", seed=0)
    state = init(model=model)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts(attention)
    losses, step_ms, per_step = [], [], []
    for k, batch in enumerate(batches):
        before = _flash_counts(attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(
            _flash_counts(attention), before)))
        if k == 0:
            bad, errs = _grad_errors(torch, {
                n: p.grad for n, p in model.named_parameters()}, ref)
            del ref
    launches = _flash_counts(attention)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _pp_launches_per_step(PP_STAGES, PP_LAYERS, PP_MICRO)
    del state, model
    _free(torch)

    # Kernels 1, 3 and 4 at the stage's shapes against their plain
    # versions (_held_shard_call at bases 0: the forward and both
    # backward kernels).
    gen = torch.Generator(device="cuda").manual_seed(18)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rand(h):
        return torch.randn(1, h, PP_SEQ, d, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, g = rand(hq), rand(hkv), rand(hkv), rand(hq)
    sm_scale = d ** -0.5
    out, lse = attention.flash_fwd(q, k, v, causal=True, sm_scale=sm_scale)
    held_ok, held = _held_shard_call(torch, attention, q, k, v, out, lse, g,
                                     ra.delta_of(out, g), 0, 0, sm_scale)
    del q, k, v, g, out, lse
    _free(torch)

    tokens = PP_MICRO * PP_SEQ
    steady = step_ms[1:]
    bubble = (2 * PP_STAGES - 2) / (PP_MICRO + 2 * PP_STAGES - 2)
    expected = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    row = {
        "phase": "pipeline", **card, "model": "llama3-8b",
        "n_layers": PP_LAYERS, "n_layers_full": 32, "stages": PP_STAGES,
        "layers_per_stage": PP_LAYERS // PP_STAGES,
        "microbatches": PP_MICRO, "microbatch": [1, PP_SEQ],
        "dtype": "bfloat16", "transport": "InProcess", "n_params": n_params,
        "losses": losses, "unsplit_loss": loss1,
        "loss_abs_err": abs(losses[0] - loss1),
        "expected_first_loss": expected, **errs, "tol": TRAIN_GRAD_TOL,
        "launches_per_step": per_step, "launches_per_step_want": want,
        "step_ms": step_ms, "mean_steady_step_ms": sum(steady) / len(steady),
        "unsplit_step_ms": unsplit_ms,
        "unsplit_timing": "two unsplit steps, each's gradient "
                          "accumulated over the 8 rows (AdamW's moments "
                          "allocated in the first); the second and pp "
                          "steps 2-3 are steady",
        "tokens_per_step": tokens,
        "tokens_per_s": tokens / (sum(steady) / len(steady) / 1e3),
        "est_mfu": 6.0 * n_params * tokens
        / (sum(steady) / len(steady) / 1e3) / PEAK_BF16_FLOPS,
        "bubble_per_stage": bubble,
        "bubble_note": f"({2 * PP_STAGES - 2})/({PP_MICRO} + "
                       f"{2 * PP_STAGES - 2}) of each stage's ticks idle "
                       f"across processes; here every stage runs in one "
                       f"process, serially, so no tick is idle and the "
                       f"step is the sum of every stage's work",
        "max_memory_allocated_gb": peak_gb,
        "unsplit_max_memory_allocated_gb": unsplit_peak_gb,
        "held_stage_calls": held,
    }
    emit(row)
    if bad or abs(losses[0] - loss1) > TRAIN_GRAD_TOL["loss_abs"]:
        fail(f"pipeline: the pp step disagrees with the unsplit step for "
             f"{bad or 'the loss'}")
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - expected) > 0.5:
        fail(f"pipeline: losses {losses}, the first not within 0.5 of "
             f"{expected}")
    if any(c != want for c in per_step):
        fail(f"pipeline: launches per step {per_step}, want {want}")
    if not held_ok:
        fail(f"pipeline: the stage's kernel calls disagree with their "
             f"plain versions: {held}")
    return launches


# tensor_parallel: Llama-3-8B's widths, 4 of its 32 layers, tp 4 (every
# rank in this process, parallel/tensor_parallel.Axes.in_process), B 1 ×
# S 4096, bf16, 3 steps of models/tp_lm.py on each of its paths.
TP_SIZE = 4
TP_LAYERS = 4
TP_SEQ = 4096
TP_STEPS = 3
# expert_parallel: Mixtral-8x7B's widths (d 4096, 32/8 heads, d_ff 14336,
# 8 experts, top-2, the JAX package's GELU experts, vocab 32000, rope
# theta 1e6), 2 layers, ep 4, the same batch shape.
EP_SIZE = 4
EP_LAYERS = 2


def _sharded_launches_per_step(ranks, layers):
    """Flash launches of one sharded step with per-layer remat: each of
    ``ranks`` attention calls a layer (a rank's own, or one rank's step
    of an sp ring held in this process) runs its forward twice (the
    forward and the backward's recompute), then one dq and one dk/dv
    launch."""
    return (2 * ranks * layers, ranks * layers, ranks * layers)


def _ring_calls(axes):
    """Attention kernel calls a layer of one step makes over ``axes``:
    every rank held, each an sp ring's sp steps."""
    return axes.held * axes.sp.size


def _sharded_steps(torch, tf, tp_lm, attention, cfg, axes, overlap,
                   batches, seq, routes=False):
    """``TP_STEPS`` steps of ``tp_lm`` over ``axes`` from seed 0's
    weights: (losses, step ms, flash launches per step, the first step's
    gradients merged by name, peak GB, the path, the first step's
    routing when ``routes``)."""
    from container_engine_accelerators_tpu_torch.parallel import world_smoke

    init, step = tp_lm.make_train_step(cfg, axes, device="cuda",
                                       overlap=overlap)
    model = tf.init_params(cfg, device="cuda", seed=0)
    state = init(model=model)
    del model
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step, grads, seen = [], [], [], None, []
    for k, batch in enumerate(batches):
        before = _flash_counts(attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with world_smoke.recorded_routes(torch, routes and k == 0) as got:
            state, loss = step(state, batch)
            losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(
            _flash_counts(attention), before)))
        if k == 0:
            grads = tp_lm.merged(list(state[0]), axes, "grads")
            seen = got
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = tp_lm.resolve(cfg, axes, None, 1, seq, overlap)
    del state
    _free(torch)
    return losses, step_ms, per_step, grads, peak_gb, path, seen


def _layer_routes(torch, seen, n_layers, ranks):
    """The first forward's routing per layer from ``recorded_routes``,
    as ``router_ties`` reads it: each layer's ``ranks`` calls'
    probabilities of batch row 0 joined along the sequence, and k."""
    return [(torch.cat([p[0] for p, _ in seen[i * ranks:(i + 1) * ranks]]),
             seen[i * ranks][1]) for i in range(n_layers)]


def _sharded_phase(torch, np, tf, attention, card, phase, cfg, variants,
                   seed, kernel_case, seq=TP_SEQ):
    """Sharded training paths held to the unsplit step by
    ``world_smoke.wide_verdict`` (their gradients merged from the ranks'
    shards: in f32 within ``SHARDED_GRAD_RTOL`` of the unsplit f32 step;
    in bf16 as close to those as the unsplit bf16 step; a dense model's
    also within ``TRAIN_GRAD_TOL`` of the unsplit bf16 step, and the
    loss; an MoE model under sp also its routing against the unsplit
    step's by ``world_smoke.router_ties``), their flash launches to the
    schedule's count and a rank's attention calls (``kernel_case``'s
    shape) to their plain versions. ``variants``: (overlap, axes) pairs,
    each run ``TP_STEPS`` steps on B 1 × S ``seq``. Returns the launches
    of all their steps (fwd, dq, dkv)."""
    from container_engine_accelerators_tpu_torch.models import tp_lm
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention as ra,
        world_smoke,
    )

    rng = np.random.default_rng(seed)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, seq + 1)), device="cuda")}
        for _ in range(TP_STEPS)]
    routes = bool(cfg.n_experts) and any(a.sp.size > 1 for _, a in variants)
    with world_smoke.recorded_routes(torch, routes) as seen_ref:
        loss1, ref, unsplit_ms, unsplit_peak_gb = _unsplit_step(
            torch, tf, cfg, batches[0])
    ref_routes = _layer_routes(torch, seen_ref, cfg.n_layers, 1) \
        if routes else None
    _free(torch)
    ref32 = world_smoke.unsplit_f32_grads(
        torch, tf, tf.init_params(cfg, device="cuda", seed=0), batches[0])
    _free(torch)
    n_params = tp_lm.n_params(cfg)
    expected = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    _zero_flash_counts(attention)
    problems, launches = [], (0, 0, 0)
    for overlap, axes in variants:
        ranks = _ring_calls(axes)
        want = _sharded_launches_per_step(ranks, cfg.n_layers)
        sp_routes = routes and axes.sp.size > 1
        losses, step_ms, per_step, grads, peak_gb, path, seen = \
            _sharded_steps(torch, tf, tp_lm, attention, cfg, axes, overlap,
                           batches, seq, routes=sp_routes)
        # The steps' launches; the f32 hold's below are a comparison's.
        for counts in per_step:
            launches = tuple(a + b for a, b in zip(launches, counts))
        got32 = world_smoke.sharded_f32_grads(
            torch, tf, tp_lm, tf.init_params(cfg, device="cuda", seed=0),
            axes, batches[0], overlap=overlap)
        readings, held = world_smoke.wide_verdict(
            torch, bool(cfg.n_experts), abs(losses[0] - loss1), grads, ref,
            got32, ref32)
        if sp_routes:
            ties = world_smoke.router_ties(
                _layer_routes(torch, seen, cfg.n_layers, axes.held),
                ref_routes)
            readings["router"] = ties
            held = held and (ties["first_layer"] is None
                             or ties["router_tie"])
        del grads, got32
        _free(torch)
        steady = step_ms[1:]
        emit({"phase": phase, **card, "path": path, "tp": axes.tp.size,
              "ep": axes.ep.size, "sp": axes.sp.size,
              "whole_parts": sorted(tp_lm.whole_parts(cfg, axes.tp.size)),
              "n_layers": cfg.n_layers, "n_experts": cfg.n_experts,
              "batch": [1, seq], "dtype": cfg.dtype, "transport": "InProcess",
              "n_params": n_params, "losses": losses, "unsplit_loss": loss1,
              "loss_abs_err": abs(losses[0] - loss1),
              "expected_first_loss": expected, **readings,
              "tol": {**world_smoke.WIDE_GRAD_TOL,
                      "f32_grad_rel": world_smoke.SHARDED_GRAD_RTOL,
                      "f32_anchor": world_smoke.F32_ANCHOR,
                      "router_atol": world_smoke.ROUTER_ATOL,
                      "bf16_vs_unsplit_held": not cfg.n_experts},
              "launches_per_step": per_step, "launches_per_step_want": want,
              "step_ms": step_ms,
              "mean_steady_step_ms": sum(steady) / len(steady),
              "unsplit_step_ms": unsplit_ms,
              "step_note": f"every rank's step in this process, serially: "
                           f"the sum of the {axes.held} ranks' work and "
                           f"their in-process transfers (a list rotation)",
              "tokens_per_s": seq / (sum(steady) / len(steady) / 1e3),
              "max_memory_allocated_gb": peak_gb,
              "unsplit_max_memory_allocated_gb": unsplit_peak_gb})
        if not held:
            problems.append(f"{path} over {axes.held} ranks: disagrees with "
                            f"the unsplit step: {readings}")
        if not all(math.isfinite(x) for x in losses) or \
                abs(losses[0] - expected) > 0.5:
            problems.append(f"{path}: losses {losses}, the first not within "
                            f"0.5 of {expected}")
        if any(c != want for c in per_step):
            problems.append(f"{path}: launches per step {per_step}, want "
                            f"{want}")
    del ref, ref32
    _free(torch)

    # Kernels 1, 3 and 4 at a rank's attention shape against their plain
    # versions: bases 0 and, for an sp ring, its last rank's past shard.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_len, hq, hkv, d = kernel_case[2], kernel_case[8], kernel_case[9], \
        kernel_case[10]

    def rand(h):
        return torch.randn(1, h, q_len, d, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, g = rand(hq), rand(hkv), rand(hkv), rand(hq)
    sm_scale = d ** -0.5
    for q_base in sorted({0, kernel_case[5]}):
        out, lse = attention.flash_fwd(q, k, v, causal=True,
                                       sm_scale=sm_scale, q_base=q_base)
        held_ok, held = _held_shard_call(torch, attention, q, k, v, out, lse,
                                         g, ra.delta_of(out, g), q_base, 0,
                                         sm_scale)
        emit({"phase": f"{phase}_kernels", **card, "case": kernel_case[0],
              "q_base": q_base, "ok": held_ok, **held})
        if not held_ok:
            problems.append(f"the rank's kernel calls at q_base {q_base} "
                            f"disagree with their plain versions: {held}")
    del q, k, v, g, out, lse
    _free(torch)
    if problems:
        fail(f"{phase}: " + "; ".join(problems))
    return launches


def tensor_parallel_phase(torch, np, tf, attention, card):
    """Tensor-parallel training at Llama-3-8B's widths (``TP_LAYERS``
    layers, tp ``TP_SIZE``, every rank in this process): the ring path and
    the off path, ``TP_STEPS`` steps each, against the unsplit step.
    Returns the launches of all its steps (fwd, dq, dkv)."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    cfg = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                              n_layers=TP_LAYERS)
    axes = tpar.Axes.in_process(tp=TP_SIZE)
    return _sharded_phase(torch, np, tf, attention, card, "tensor_parallel",
                          cfg, [("ring", axes), ("off", axes)], 19,
                          TP_LOCAL_CASE)


def mixtral_config(tf, n_layers=EP_LAYERS):
    """Mixtral-8x7B's published widths on the port's MoE FFN (the JAX
    package's GELU experts)."""
    return tf.TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=TP_SEQ, rope_theta=1e6,
        n_experts=8, expert_top_k=2)


def expert_parallel_phase(torch, np, tf, attention, card):
    """Expert-parallel MoE training at Mixtral-8x7B's widths
    (``EP_LAYERS`` layers, ep ``EP_SIZE``, every rank in this process)
    against the unsplit MoE step. Returns the launches of its steps."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    return _sharded_phase(torch, np, tf, attention, card, "expert_parallel",
                          mixtral_config(tf),
                          [(None, tpar.Axes.in_process(ep=EP_SIZE))], 20,
                          PIPELINE_CASE)


# moe_sp: Mixtral-8x7B's widths (mixtral_config), MOE_SP_LAYERS layers,
# B 1 × S MOE_SP_SEQ, its sequence over sp 2 and sp 4 with every sp rank
# in this process (Axes.in_process(sp=...)): each sequence routed whole
# across the ranks (parallel/moe.py), attention the flash ring
# (ring_attention.RingFlash over InProcess).
MOE_SP_SEQ = 8192
MOE_SP_SIZES = (2, 4)
MOE_SP_LAYERS = 2
# The MoE layer through the sharded routing against moe_ffn on the whole
# sequence in f32: the slot masks equal, y's largest error within this
# share of its largest |y| (the expert products run on other buffers, so
# only the order of f32 sums differs), the gradients by wide_verdict's f32
# rule (SHARDED_GRAD_RTOL).
MOE_SP_Y_RTOL = 1e-4
# A rank's shard attention there: Mixtral's 32/8 heads, a 4096-token
# shard (sp 2), at base 0 and at the last rank's base against the first
# shard.
MOE_SP_CASE = ("moe_sp_shard_s4096", 1, 4096, 4096, True, 4096, 0, None, 32,
               8, 128, "bfloat16")
# tp_whole: Qwen2-1.5B's widths (world_smoke.qwen2_config), TP_LAYERS
# layers, tp 4 in this process: tp does not divide its 2 KV heads, so the
# attention is whole on every rank (12/2 heads), the FFN and vocabulary
# split.
TP_WHOLE_CASE = ("tp_whole_s4096", 1, 4096, 4096, True, 0, 0, None, 12, 2,
                 128, "bfloat16")


def _moe_layer(torch, moe, tpar, cfg, params, x, sp):
    """One MoE layer's loss, ``(y.float() ** 2).mean() + 0.01 · aux``,
    and its backward: whole (sp 1, ``moe.moe_ffn``) or every rank of an
    sp axis in this process (``moe.moe_ffn_parallel``, each rank's share
    of the loss, the ranks' weights one tensor). Returns (y, the loss,
    gradients by name: router, w1, w2 and x)."""
    leaves = {n: t.detach().clone().requires_grad_()
              for n, t in params.items()}
    kw = dict(top_k=cfg.expert_top_k, capacity_factor=cfg.capacity_factor)
    xs = [t.contiguous().requires_grad_()
          for t in x.detach().split(x.shape[1] // sp, dim=1)]
    if sp == 1:
        y, aux = moe.moe_ffn(xs[0], leaves, **kw)
        ys, loss = [y], (y.float() ** 2).mean() + 0.01 * aux
    else:
        ys, auxes = moe.moe_ffn_parallel(
            xs, [leaves] * sp, tpar.Axes.in_process(sp=sp), **kw)
        loss = sum((y.float() ** 2).sum() / x.numel() + 0.01 * a / sp
                   for y, a in zip(ys, auxes))
    loss.backward()
    grads = {n: t.grad for n, t in leaves.items()}
    grads["x"] = torch.cat([t.grad for t in xs], dim=1)
    return torch.cat([y.detach() for y in ys], dim=1), loss.item(), grads


def moe_sp_layer(torch, tf, card):
    """The MoE layer at Mixtral-8x7B's widths and S ``MOE_SP_SEQ``
    through the sharded routing at each sp of ``MOE_SP_SIZES`` against
    ``moe_ffn`` on the whole sequence, on the same bf16 weights: in f32
    (the weights widened) the slot masks equal and y and every gradient
    within ``MOE_SP_Y_RTOL`` / ``SHARDED_GRAD_RTOL``; in bf16 by
    ``wide_verdict``'s MoE rule, the routing by ``router_ties``."""
    from container_engine_accelerators_tpu_torch.parallel import moe
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
        world_smoke,
    )

    cfg = mixtral_config(tf, MOE_SP_LAYERS)
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.expert_top_k
    gen = torch.Generator(device="cuda").manual_seed(23)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    bf16 = {"router": randn(d, e, scale=d ** -0.5),
            "w1": randn(e, d, f, scale=d ** -0.5).to(torch.bfloat16),
            "w2": randn(e, f, d, scale=f ** -0.5).to(torch.bfloat16)}
    wide = {n: t.float() for n, t in bf16.items()}
    x = randn(1, MOE_SP_SEQ, d).to(torch.bfloat16)
    with world_smoke.recorded_routes(torch) as seen:
        _, loss_ref, ref = _moe_layer(torch, moe, tpar, cfg, bf16, x, 1)
    y32_ref, _, ref32 = _moe_layer(torch, moe, tpar, cfg, wide, x.float(), 1)
    with torch.no_grad():
        _, want_masks, _ = moe._route(x.float(), wide["router"], k,
                                      cfg.capacity_factor)
    problems = []
    for sp in MOE_SP_SIZES:
        t0 = time.perf_counter()
        with torch.no_grad():
            routes, _, c = moe._route_sharded(
                list(x.float().split(MOE_SP_SEQ // sp, dim=1)),
                [wide["router"]] * sp, k, cfg.capacity_factor,
                tpar.Axes.in_process(sp=sp))
            masks_equal = all(torch.equal(torch.cat(
                [moe.slot_masks(r, e, c)[j] for r in routes], dim=1),
                want_masks[j]) for j in range(k))
            drops = int(sum((~r[3]).sum() for r in routes))
            del routes
        with world_smoke.recorded_routes(torch) as seen_sp:
            _, loss_sp, got = _moe_layer(torch, moe, tpar, cfg, bf16, x, sp)
        y32, _, got32 = _moe_layer(torch, moe, tpar, cfg, wide, x.float(),
                                   sp)
        y_err = ((y32 - y32_ref).abs().max()
                 / y32_ref.abs().max()).item()
        readings, held = world_smoke.wide_verdict(
            torch, True, abs(loss_sp - loss_ref), got, ref, got32, ref32)
        ties = world_smoke.router_ties(
            _layer_routes(torch, seen_sp, 1, sp),
            _layer_routes(torch, seen, 1, 1))
        ok = held and masks_equal and y_err <= MOE_SP_Y_RTOL and (
            ties["first_layer"] is None or ties["router_tie"])
        emit({"phase": "moe_sp_layer", **card, "sp": sp, "seq": MOE_SP_SEQ,
              "d_model": d, "d_ff": f, "n_experts": e, "top_k": k,
              "capacity": c, "drops": drops, "masks_equal": masks_equal,
              "f32_y_rel_err": y_err, **readings, "router": ties,
              "tol": {"f32_y_rel": MOE_SP_Y_RTOL,
                      "f32_grad_rel": world_smoke.SHARDED_GRAD_RTOL,
                      "f32_anchor": world_smoke.F32_ANCHOR,
                      "loss_abs": world_smoke.WIDE_GRAD_TOL["loss_abs"],
                      "router_atol": world_smoke.ROUTER_ATOL},
              "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            problems.append(f"sp {sp}: masks equal {masks_equal}, f32 y "
                            f"{y_err}, {readings}, router {ties}")
        del got, got32, y32
        _free(torch)
    del bf16, wide, x, ref, ref32, want_masks
    _free(torch)
    if problems:
        fail("moe_sp layer: " + "; ".join(problems))


def moe_sp_phase(torch, np, tf, attention, card):
    """MoE training with its sequence over sp at Mixtral-8x7B's widths:
    the layer through the sharded routing (``moe_sp_layer``), then
    ``TP_STEPS`` steps of ``tp_lm`` over an in-process sp axis of each
    size of ``MOE_SP_SIZES`` on the flash ring against the unsplit step
    (``_sharded_phase``). Returns the launches of its steps."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    moe_sp_layer(torch, tf, card)
    cfg = dataclasses.replace(mixtral_config(tf, MOE_SP_LAYERS),
                              max_seq_len=MOE_SP_SEQ)
    return _sharded_phase(
        torch, np, tf, attention, card, "moe_sp", cfg,
        [(None, tpar.Axes.in_process(sp=sp)) for sp in MOE_SP_SIZES], 21,
        MOE_SP_CASE, seq=MOE_SP_SEQ)


def tp_whole_phase(torch, np, tf, attention, card):
    """Tensor-parallel training over dims tp does not divide: Qwen2-1.5B's
    widths (``TP_LAYERS`` layers, tp ``TP_SIZE`` in this process; its 2
    KV heads whole on every rank), ``TP_STEPS`` steps against the unsplit
    step. Returns the launches of its steps."""
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
        world_smoke,
    )

    cfg = world_smoke.qwen2_config(n_layers=TP_LAYERS, seq=TP_SEQ)
    return _sharded_phase(
        torch, np, tf, attention, card, "tp_whole", cfg,
        [(None, tpar.Axes.in_process(tp=TP_SIZE))], 22, TP_WHOLE_CASE)


# The int8 ring products at a tp-4 shard of Llama-3-8B's FFN: w1's column
# shard (K 4096 × N 3584) behind the gathering ring of M 4096 rows, and
# w2's row shard (K 3584 × N 4096) behind the scattering ring, whose f32
# partials are the tensor-core kernel's f32 epilogue (bf16 x, f32 y).
INT8_RING_M = 4096


def int8_ring_phase(torch, int8_matmul, q8, card):
    """Both int8 rings over ``InProcess(4)`` against ``int8_mm_reference``
    on each rank's whole product, within ``INT8_TOL``; the ring ms beside
    the monolithic kernel's on the gathered rows; one f32-output product
    (the scattering ring's partial at its shard) against the plain version
    with an f32 output (``INT8_TOL["float32"]``), its ms beside the
    bf16-output launch's, the plain version's and its bound. Returns the
    kernel's launches in the two rings' timed-free runs."""
    from container_engine_accelerators_tpu_torch.parallel import overlap
    from container_engine_accelerators_tpu_torch.parallel.ring_attention \
        import InProcess

    n = TP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(1, INT8_RING_M, 4096, generator=gen,
                    device="cuda").to(torch.bfloat16)
    h = torch.randn(1, INT8_RING_M, 14336, generator=gen,
                    device="cuda").to(torch.bfloat16)

    def int8_weight(k, nn):
        w = (torch.randn(k, nn, generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        return q8.Int8Weight.from_jax_layout(**q8.quantize_weight(w))

    w1, w2 = int8_weight(4096, 14336), int8_weight(14336, 4096)
    cols, rows = overlap._split_cols(w1, n), overlap._split_rows(w2, n)
    xs = [c.contiguous() for c in x.chunk(n, dim=-2)]
    hs = [c.contiguous() for c in h.chunk(n, dim=-1)]
    ring = InProcess(n)
    tol = INT8_TOL["bfloat16"]
    before = int8_matmul.int8_mm_launches
    ag = overlap.allgather_matmul(xs, cols, ring)
    rs = overlap.matmul_reducescatter(hs, rows, ring)
    torch.cuda.synchronize()
    launches = int8_matmul.int8_mm_launches - before
    errs, ok = {}, True
    for r in range(n):
        want = int8_matmul.int8_mm_reference(x, cols[r].q, cols[r].scale)
        diff = (ag[r].float() - want.float()).abs()
        ok = ok and bool((diff <= tol["atol"] + tol["rtol"]
                          * want.float().abs()).all())
        errs[f"ag_rank{r}"] = diff.max().item()
    want = int8_matmul.int8_mm_reference(h, w2.q, w2.scale)
    got = torch.cat(rs, dim=-2)
    diff = (got.float() - want.float()).abs()
    ok = ok and bool((diff <= tol["atol"] + tol["rtol"]
                      * want.float().abs()).all())
    errs["rs"] = diff.max().item()
    # The f32 epilogue alone: rank 0's partial over its K shard.
    w0 = rows[0]
    part = int8_matmul.int8_mm(hs[0], w0.q, w0.scale, out_dtype=torch.float32)
    want32 = int8_matmul.int8_mm_reference(hs[0], w0.q, w0.scale,
                                           out_dtype=torch.float32)
    tol32 = INT8_TOL["float32"]
    diff = (part - want32).abs()
    f32_ok = part.dtype == torch.float32 and bool(
        (diff <= tol32["atol"] + tol32["rtol"] * want32.abs()).all())
    errs["f32_out"] = diff.max().item()
    f32_bound, f32_bound_by = int8_bound(INT8_RING_M, w0.q.shape[1],
                                         w0.q.shape[0], y_bytes=4)
    f32_out = {
        "shape": [INT8_RING_M, w0.q.shape[1], w0.q.shape[0]],
        "max_abs_err": errs["f32_out"], "tol": tol32, "ok": f32_ok,
        "ms": time_ms(lambda: int8_matmul.int8_mm(
            hs[0], w0.q, w0.scale, out_dtype=torch.float32), torch),
        "bf16_out_ms": time_ms(lambda: int8_matmul.int8_mm(
            hs[0], w0.q, w0.scale), torch),
        "plain_ms": time_ms(lambda: int8_matmul.int8_mm_reference(
            hs[0], w0.q, w0.scale, out_dtype=torch.float32), torch),
        "bound_ms": f32_bound, "bound_by": f32_bound_by}
    # The library column, as run_int8_case times it: the unfused PyTorch
    # composition (bf16 product of the widened weight, the f32 scale)
    # with an f32 output, and torch._weight_int8pack_mm (bf16 output).
    h0 = hs[0].reshape(-1, hs[0].shape[-1])
    f32_out["library_ms"] = time_ms(
        lambda: ((h0 @ w0.q.to(torch.bfloat16).T) * w0.scale).float(),
        torch)
    try:
        scale_bf16 = w0.scale.reshape(-1).to(torch.bfloat16)
        f32_out["int8pack_ms"] = time_ms(
            lambda: torch._weight_int8pack_mm(h0, w0.q, scale_bf16), torch)
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        f32_out["int8pack_ms"] = None
        f32_out["int8pack_note"] = f"not run on CUDA here: {e}"[:200]
    del part, want32, diff
    ok = ok and f32_ok
    row = {"phase": "int8_ring", **card, "tp": n, "m": INT8_RING_M,
           "ag_shard": [4096, 3584], "rs_shard": [3584, 4096],
           "launches": launches, "max_abs_err": errs, "tol": tol,
           "ag_ring_ms": time_ms(lambda: overlap.allgather_matmul(
               xs, cols, ring), torch),
           "ag_monolithic_ms": time_ms(lambda: [
               int8_matmul.int8_mm(x, c.q, c.scale) for c in cols], torch),
           "rs_ring_ms": time_ms(lambda: overlap.matmul_reducescatter(
               hs, rows, ring), torch),
           "rs_monolithic_bf16_ms": time_ms(lambda: int8_matmul.int8_mm(
               h, w2.q, w2.scale), torch),
           "f32_out": f32_out,
           "timing": "every rank in this process, serially (the transfer "
                     "is a list rotation); the scattering ring's f32 "
                     "partials are the tensor-core kernel's f32 epilogue, "
                     "the monolithic row its bf16 one", "ok": ok}
    emit(row)
    del x, h, w1, w2, w0, cols, rows, xs, hs, ag, rs, got, want
    _free(torch)
    if not ok:
        fail(f"int8_ring: the ring products disagree with int8_mm_reference "
             f"beyond {tol}: {errs}")
    if launches != 4 * n * n:
        # Bidirectional at a ring of 4: two half-row chunks a step, n
        # steps, n ranks, two rings.
        fail(f"int8_ring: {launches} int8_mm launches, want {4 * n * n}")
    return launches


# train_dist: a world of one over NCCL through the env contract, against
# the same run without --distributed. Two layers at d_model 4096 (32
# heads, train_cli's 16 kv heads), S 4096.
TRAIN_DIST_ARGV = ["--model", "transformer", "--d-model", "4096",
                   "--n-heads", "32", "--n-layers", "2", "--seq-len", "4096",
                   "--vocab-size", "32000", "--steps", "3"]
# Runs train_cli.main in a process of its own and prints its kernel
# launches after the CLI's result line.
_TRAIN_DIST_SNIPPET = (
    "import json, sys\n"
    "from container_engine_accelerators_tpu_torch.models import train_cli\n"
    "from container_engine_accelerators_tpu_torch.ops import attention\n"
    "rc = train_cli.main(sys.argv[1:])\n"
    "print(json.dumps({'launches': [attention.flash_fwd_launches, "
    "attention.flash_dq_launches, attention.flash_dkv_launches]}))\n"
    "sys.exit(rc)\n")


def _train_cli_process(argv, env, timeout=600):
    """(rc, result, launches, stderr) of train_cli in a subprocess."""
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_DIST_SNIPPET, *argv], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2:
        fail(f"train_dist: train_cli {' '.join(argv)} exited "
             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return (json.loads(lines[-2]), tuple(json.loads(lines[-1])["launches"]),
            proc.stderr)


def train_dist_phase(card):
    """``train_cli --distributed`` as a world of one on NCCL, from the
    env contract (TPU_WORKER_ID 0, TPU_WORKER_HOSTNAMES localhost, a free
    TPU_COORDINATOR_PORT, TPU_HEALTH_CHECK_LOG_FILE): the marker, n_devices
    1, and every step's loss equal to the same run without
    --distributed. Returns the distributed run's launches."""
    import tempfile

    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    with tempfile.TemporaryDirectory(prefix="train_dist-") as work:
        marker = os.path.join(work, "health.log")
        runs = {}
        for name, extra in (("plain", {}), ("distributed", {
                "TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "localhost",
                "TPU_COORDINATOR_PORT": str(_free_port()),
                "TPU_HEALTH_CHECK_LOG_FILE": marker})):
            events = os.path.join(work, f"{name}.jsonl")
            flags = ["--distributed"] if extra else []
            t0 = time.perf_counter()
            result, launches, _ = _train_cli_process(
                [*TRAIN_DIST_ARGV, *flags, "--event-log", events],
                {**base, **extra})
            with open(events) as f:
                losses = [r["loss"] for r in map(json.loads, f)
                          if r.get("kind") == "train_step"]
            runs[name] = {"result": result, "launches": launches,
                          "losses": losses,
                          "process_s": time.perf_counter() - t0}
        text = open(marker).read() if os.path.exists(marker) else ""
    dist, plain = runs["distributed"], runs["plain"]
    layers, steps = 2, 3
    want = (2 * layers * steps, layers * steps, layers * steps)
    emit({"phase": "train_dist", **card, "marker": text.strip(),
          "argv": TRAIN_DIST_ARGV, "want_launches": want, **runs})
    if text != "TPU_BOOTSTRAP_OK rank=0 world=1\n":
        fail(f"train_dist: the marker file holds {text!r}")
    if dist["result"]["n_devices"] != 1 or len(dist["losses"]) != steps:
        fail(f"train_dist: n_devices {dist['result']['n_devices']}, "
             f"{len(dist['losses'])} step losses")
    if dist["losses"] != plain["losses"]:
        fail(f"train_dist: losses {dist['losses']} with --distributed, "
             f"{plain['losses']} without")
    if dist["launches"] != want or plain["launches"] != want:
        fail(f"train_dist: launches {dist['launches']} / "
             f"{plain['launches']}, want {want}")
    return dist["launches"]


class _HeldRankMesh:
    """The mesh view ``parallel/data_parallel`` reads (axis names, sizes,
    this rank's coordinates) of one rank of a {"dp": 1, "sp": sp} mesh,
    held in this process: a model whose sp ranks are replicas reduces over
    dp alone, a group of one, so no process group is needed to run each
    rank's step here."""

    def __init__(self, sizes, coords):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._coords = coords

    def get_local_rank(self, name):
        return self._coords[name]

    def get_group(self, name):
        raise RuntimeError(f"the {name} group of a rank held in process")


# collectives: the sweep on one card. The CLI refuses a world of one, as
# JAX refuses one device; the benches run over an NCCL world of one
# joined through the env contract, in a process of their own, each op's
# output held to its plain expectation there (every collective over a
# group of one is its identity; the ring matmul the plain product).
COLLECTIVES_CHILD = r"""
import json
import torch
from container_engine_accelerators_tpu_torch.collectives import bench as cb
from container_engine_accelerators_tpu_torch.parallel import bootstrap
opts = bootstrap.initialize_from_env(device="cuda")
mesh = cb._mesh_1d()
bf16, elems = torch.bfloat16, 1 << 19
x = cb._sharded_input(mesh, elems, bf16)
want = torch.arange(elems, dtype=torch.float32, device=x.device).to(bf16)
full = cb.reduce_scatter_input(mesh, "x", elems, bf16)
m, xm, wm = cb.collective_matmul_inputs(mesh, "x", 1 << 20, bf16)
checks = {
    "psum": torch.equal(cb.psum_op(mesh, "x")(x.clone()), want),
    "all_gather": torch.equal(
        cb.all_gather_op(mesh, "x")(x, torch.empty_like(x)), want),
    "reduce_scatter": torch.equal(
        cb.reduce_scatter_op(mesh, "x")(full, torch.empty_like(x)), want),
    "ppermute": torch.equal(
        cb.ppermute_op(mesh, "x")(x, torch.empty_like(x)), want),
    "collective_matmul": torch.equal(
        cb.collective_matmul_op(mesh, "x")(xm, wm), torch.matmul(xm, wm)),
}
results = {name: [r.to_json() for r in cb.sweep(
    name, 1 << 20, 1 << 28, 4, mesh=mesh, iters=10)]
    for name in sorted(cb.BENCHES)}
torch.distributed.destroy_process_group()
print(json.dumps({"world": opts["world_size"], "backend": opts["backend"],
                  "checks": checks, "results": results}))
"""


def collectives_phase(card):
    """The collective sweep (``collectives/bench.py``, its CLI and the
    NCCL environment profiles) on one card: the CLI refuses the world of
    one with JAX's JSON and exit code 1; every ``BENCHES`` entry runs
    over an NCCL world of one (``COLLECTIVES_CHILD``), 1M to 256M bytes
    by factor 4, with JAX's byte accounting and one device, the
    collective matmul's transfer 0; each op's output is its plain
    expectation; the profiles render as a ConfigMap holding every
    key."""
    from container_engine_accelerators_tpu_torch.collectives import (
        env_profiles,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.collectives", "--json"],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    refusal = json.loads(lines[-1]) if lines else None
    if proc.returncode != 1 or refusal != {
            "error": "need >= 2 devices for collectives", "n_devices": 1}:
        fail(f"collectives: the CLI on one card exited {proc.returncode} "
             f"with {refusal}, want JAX's one-device refusal:\n"
             f"{proc.stderr[-2000:]}")
    env.update(TPU_WORKER_ID="0", TPU_WORKER_HOSTNAMES="localhost",
               TPU_COORDINATOR_PORT=str(_free_port()), LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", COLLECTIVES_CHILD],
                          env=env, cwd=root, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        fail(f"collectives: the NCCL world of one exited {proc.returncode}:"
             f"\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    sizes = [1 << s for s in range(20, 29, 2)]
    bad = [name for name, ok in out["checks"].items() if not ok]
    for name, rows in out["results"].items():
        per = [r["msg_bytes"] for r in rows]
        if per != sizes or any(r["n_devices"] != 1 or r["mean_s"] <= 0
                               for r in rows):
            bad.append(f"{name} results {per}")
        if name == "collective_matmul" and any(
                r["detail"]["collective_s"] != 0.0 for r in rows):
            bad.append("collective_matmul moved bytes on one card")
    text = env_profiles.render_configmap()
    missing = [f"{p}:{k}" for p, env_ in env_profiles.PROFILES.items()
               for k, v in env_.items() if f"    {k}={v}" not in text]
    emit({"phase": "collectives", **card, "refusal": refusal,
          "world": out["world"], "backend": out["backend"],
          "checks": out["checks"], "seconds": time.perf_counter() - t0,
          "results": {name: [[r["msg_bytes"], r["mean_s"], r["busbw_gbps"]]
                             for r in rows]
                      for name, rows in out["results"].items()},
          "profiles": sorted(env_profiles.PROFILES),
          "profile_keys_missing": missing})
    if bad or missing:
        fail(f"collectives: {bad} {missing}")


BERT_SP = 2


def train_bert_sp(torch, np, attention, card):
    """``train_cli --sp 2 --model bert``'s step, every rank in this
    process: BERT-large cut to 2 layers (bf16, B 8, S 512), each sp rank's
    ``bert.make_train_step`` on its mesh coordinates (the whole batch, the
    gradients summed over dp alone) against the unsplit step from the
    same weights, loss and every gradient held to TRAIN_GRAD_TOL; each
    rank's step runs the non-causal flash forward, dq and dk/dv once a
    layer. Returns the ranks' launches (fwd, dq, dkv)."""
    from container_engine_accelerators_tpu_torch.models import bert

    cfg = dataclasses.replace(bert.BertConfig.bert_large(), n_layers=2)
    batch = bert.synthetic_mlm_batch(np.random.default_rng(1), 8, cfg,
                                     device="cuda")

    def step(mesh):
        init_state, train_step = bert.make_train_step(cfg, device="cuda",
                                                      mesh=mesh)
        state = init_state(seed=0)
        state, loss = train_step(state, batch)
        return loss.item(), {
            n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in state[0].named_parameters()}

    want_loss, want = step(None)
    _zero_flash_counts(attention)
    ranks = []
    for r in range(BERT_SP):
        loss, grads = step(_HeldRankMesh({"dp": 1, "sp": BERT_SP, "tp": 1},
                                         {"dp": 0, "sp": r, "tp": 0}))
        bad, errs = _grad_errors(torch, grads, want)
        ranks.append({"rank": r, "loss": loss, "bad": bad, **errs})
        del grads
    launches = _flash_counts(attention)
    emit({"phase": "train_bert_sp", **card, "model": "bert-large",
          "n_layers": cfg.n_layers, "sp": BERT_SP, "batch": 8,
          "seq_len": cfg.max_seq_len, "dtype": "bfloat16",
          "unsplit_loss": want_loss, "ranks": ranks, "tol": TRAIN_GRAD_TOL,
          "launches_fwd_dq_dkv": launches})
    for row in ranks:
        if row["bad"] or not math.isfinite(row["loss"]) or \
                abs(row["loss"] - want_loss) > TRAIN_GRAD_TOL["loss_abs"]:
            fail(f"train_bert_sp: rank {row['rank']}'s loss or gradients "
                 f"{row['bad']} disagree with the unsplit step")
    if launches != (cfg.n_layers * BERT_SP,) * 3:
        fail(f"train_bert_sp: fwd/dq/dkv launched {launches} times, want "
             f"{cfg.n_layers} a rank each")
    return launches


# The single-card qualification rows (collectives/device_bench.py) in the
# order the JAX package's bench.py runs them on one chip, with its
# arguments, plus what it leaves out: the int8 decode row and the
# engine-against-batcher head-to-head. (label, function, arguments)
DEVICE_BENCH_ROWS = (
    ("matmul_bf16", "bench_matmul", {}),
    ("hbm_bandwidth", "bench_hbm_bandwidth", {"repeats": 2}),
    ("hbm_pattern_sweep", "bench_hbm_pattern_sweep", {"repeats": 2}),
    ("matmul_int8", "bench_matmul_int8", {}),
    ("train_step_mfu", "bench_train_step_mfu", {}),
    ("decode_throughput", "bench_decode_throughput", {}),
    ("decode_throughput_int8", "bench_decode_throughput",
     {"quantize": True}),
    ("train_step_mfu_remat", "bench_train_step_mfu_remat", {}),
    ("train_step_mfu_remat_required", "bench_train_step_mfu_remat_required",
     {}),
    ("train_step_mfu_1b", "bench_train_step_mfu_1b", {}),
    ("decode_sweep", "bench_decode_sweep", {"batches": (1, 32)}),
    ("prefill_throughput", "bench_prefill_throughput", {}),
    ("decode_window_benefit", "bench_decode_window_benefit", {}),
    ("flash_long_context", "bench_flash_long_context", {}),
    ("continuous_serving", "bench_continuous_serving",
     {"versus_batcher": True}),
    ("continuous_serving_shared_prefix",
     "bench_continuous_serving_shared_prefix", {}),
    ("engine_chunk_step", "bench_engine_chunk_step", {}),
    ("continuous_serving_saturated", "bench_continuous_serving_saturated",
     {}),
)
# A reading above the nominal peak by more than this means a wrong count.
MAX_FRAC_OF_PEAK = 1.05
# bench_hbm_pattern_sweep's rows: every one must run on an 80 GB card.
PATTERN_KEYS = {f"{p}_{d}_{s}" for p in ("read", "copy")
                for d in ("bf16", "f32", "i8") for s in ("256M", "1G")}


def _numbers(obj):
    """Every int or float inside a JSON-like object (bools aside)."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _numbers(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _numbers(v)]
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return [obj]
    return []


def _errors(obj):
    """Every "error: ..." string inside a JSON-like object."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _errors(v)]
    if isinstance(obj, str) and obj.startswith("error"):
        return [obj]
    return []


def _device_bench_problems(label, out, cfg_layers):
    """What is wrong with one row's result (an empty list when nothing)."""
    if isinstance(out, dict):  # decode_sweep, decode_window_benefit
        bad = [f"error: {e}" for e in _errors(out)]
        bad += [f"{label}: a reading <= 0"
                for x in _numbers(out) if not x > 0][:1]
        return bad
    bad = []
    if not (math.isfinite(out.value) and out.value > 0):
        bad.append(f"value {out.value}")
    if out.frac_of_peak > MAX_FRAC_OF_PEAK:
        bad.append(f"frac_of_peak {out.frac_of_peak} > {MAX_FRAC_OF_PEAK}")
    d = out.detail
    if label == "matmul_bf16":
        bad += [f"{shape}: {v}" for shape, v in d["per_shape"].items()
                if not isinstance(v, float)]
    elif label == "hbm_pattern_sweep" and set(d) != PATTERN_KEYS:
        bad.append(f"patterns missing: {sorted(PATTERN_KEYS - set(d))}")
    elif label == "flash_long_context":
        # A warm and 3 timed rounds of 8 forwards, then of 8 fwd+bwd.
        got = (d["flash_fwd_launches"], d["flash_dq_launches"],
               d["flash_dkv_launches"])
        if got != (64, 32, 32):
            bad.append(f"flash launches {got}, want (64, 32, 32)")
    elif label == "continuous_serving_saturated":
        # Closed-loop clients keep every slot busy: the steps-weighted
        # slot occupancy read 1.0 on the card.
        if not d["occupancy_frac"] >= MIN_SATURATED_OCCUPANCY:
            bad.append(f"occupancy_frac {d['occupancy_frac']} < "
                       f"{MIN_SATURATED_OCCUPANCY}")
    elif label == "decode_throughput_int8":
        # One eager prefill through every projection, then every decode
        # step a replay of a captured graph that launches each of them.
        per = 7 * cfg_layers
        if not d["graph_replays"] or \
                d["int8_mm_launches"] != per * (1 + d["graph_replays"]) or \
                d["int8_mm_captured"] != per * d["graph_captures"]:
            bad.append(f"int8_mm launches {d['int8_mm_launches']}, "
                       f"captured {d['int8_mm_captured']}, graphs "
                       f"{d['graph_captures']} captured, "
                       f"{d['graph_replays']} replayed; want {per} a "
                       f"prefill, a replay and a capture")
    return bad


STREAM_KERNELS = ("stream_triad", "stream_read", "stream_copy")
# The saturated serving row's slot occupancy must stay at least this.
MIN_SATURATED_OCCUPANCY = 0.8


@contextlib.contextmanager
def recorded_decodes(db, seen):
    """Inside the block, every run of a ``db.decode_runner`` runner
    appends (model, prompt, tokens) to ``seen``: the tokens a decode row
    decodes, for holding them afterwards."""
    runner = db.decode_runner

    def recording(model, prompt, steps, use_window=True):
        run, windows, graphs = runner(model, prompt, steps, use_window)

        def recorded():
            out = run()
            seen.append((model, prompt, out))
            return out

        return recorded, windows, graphs

    db.decode_runner = recording
    try:
        yield
    finally:
        db.decode_runner = runner


def device_bench_phase(torch, db, attention, int8_matmul, stream, card):
    """Every qualification row on the card (DEVICE_BENCH_ROWS), one JSON
    line each with the card's name and power limit: the result's
    ``to_json()`` and the row's seconds. Fails when a reading is <= 0 or
    above MAX_FRAC_OF_PEAK of its peak, a default matmul shape, a decode
    point or an HBM pattern errs, the S 32768 row did not launch the
    flash kernels, or the int8 decode row went around ``int8_mm``.
    Returns the kernel launches the rows made (the counts are zeroed
    first)."""
    _zero_flash_counts(attention)
    int8_matmul.int8_mm_launches = 0
    for name in STREAM_KERNELS:
        setattr(stream, f"{name}_launches", 0)
    bad, int8_decodes = [], []
    t_phase = time.perf_counter()
    layers = db._bench_cfg().n_layers
    for label, fn, kwargs in DEVICE_BENCH_ROWS:
        t0 = time.perf_counter()
        with (recorded_decodes(db, int8_decodes)
              if label == "decode_throughput_int8"
              else contextlib.nullcontext()):
            out = getattr(db, fn)(**kwargs)
        row = {"phase": "device_bench", "row": label, **card,
               "seconds": time.perf_counter() - t0}
        row.update(out.to_json() if isinstance(out, db.DeviceBenchResult)
                   else {"detail": out})
        if label == "continuous_serving_saturated":
            row["occupancy_frac"] = out.detail["occupancy_frac"]
            row["min_occupancy_frac"] = MIN_SATURATED_OCCUPANCY
        emit(row)
        bad += [f"{label}: {p}" for p in
                _device_bench_problems(label, out, layers)]
        _free(torch)
        if label == "decode_throughput_int8":
            int8_replays = out.detail["graph_replays"]
    fwd, dq, dkv = _flash_counts(attention)
    # int8_mm: the calls that launched it eagerly, and the 7 × layers
    # launches of each of the int8 decode row's graph replays, which the
    # counter does not see.
    launches = {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv,
                "int8_mm": int8_matmul.int8_mm_launches
                + 7 * layers * int8_replays,
                **{name: getattr(stream, f"{name}_launches")
                   for name in STREAM_KERNELS}}
    emit({"phase": "device_bench", "seconds": time.perf_counter() - t_phase,
          "launches": launches, **card})
    if bad:
        fail(f"device_bench: {bad}")
    return launches, int8_decodes


def hold_int8_decodes(torch, tf, int8_matmul, card, decodes):
    """The int8 decode row's tokens (every run's, ``recorded_decodes``):
    every run decodes the same tokens, and each of the last run's lies
    within SERVE_LOGITS_ATOL of the top logit of the same int8 model
    through the plain version of ``int8_mm`` on its own context (teacher
    forced, ``_served_gaps``)."""
    model, prompt, _ = decodes[0]
    runs = [tokens for _, _, tokens in decodes]
    prompts = prompt.tolist()
    streams = [p + t for p, t in zip(prompts, runs[-1].tolist())]
    with plain_int8(int8_matmul):
        held = _served_gaps(torch, tf, model, prompts, streams)
    row = {"phase": "device_bench_int8_tokens", **card, "runs": len(runs),
           "runs_equal": all(torch.equal(runs[0], t) for t in runs[1:]),
           "tokens_vs_int8_reference": held, "tol": SERVE_LOGITS_ATOL}
    emit(row)
    if not row["runs_equal"]:
        fail("device_bench: the int8 decode row's runs decoded different "
             "tokens")
    if held["gaps_over_tol"]:
        fail(f"device_bench: {held['gaps_over_tol']} tokens of the int8 "
             f"decode row lie {SERVE_LOGITS_ATOL} or more below the int8 "
             f"reference's top logit on their own context: {held}")


# bench_hbm_pattern_sweep's buffers (bench_hbm_bandwidth's is the 1 GiB).
STREAM_SIZES = (1 << 28, 1 << 30)


def _stream_buffer(torch, gen, n, dtype):
    if dtype == torch.int8:
        return torch.randint(-127, 127, (n,), generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn(n, generator=gen, device="cuda").to(dtype)


def _stream_checks(torch, db, stream, gen):
    """Each Triton kernel against its plain version at every dtype and
    size its row runs it at: the read and the copy at bf16, f32 and int8
    over 256 MiB and 1 GiB, the triad in place over bench_hbm_bandwidth's
    1 GiB bf16 buffers. Each at its row's constants of the last step and
    at constants that move every term (the rows' 1e-9 terms fall below a
    bf16 step, where a kernel that dropped one would still agree). Returns
    (checks, the 1 GiB bf16 buffers (x, y, z, src) for the timing)."""
    checks = []

    def check(kernel, x, consts, err, tol, abs_err):
        checks.append({"kernel": kernel, "dtype": str(x.dtype)[6:],
                       "bytes": x.nbytes, "constants": consts, "err": err,
                       "tol": tol, "max_abs_err": abs_err,
                       "ok": bool(err <= tol)})

    timed = None
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        size = torch.empty((), dtype=dtype).element_size()
        for nbytes in STREAM_SIZES:
            n = nbytes // size
            x, src = (_stream_buffer(torch, gen, n, dtype) for _ in range(2))
            for bias in (db.read_bias(1023), 0.125):
                want = stream.stream_read_reference(x, bias).item()
                got = stream.stream_read(
                    x, torch.zeros(1, device="cuda"), bias).item()
                check("stream_read", x, {"bias": bias},
                      abs(got - want) / want, read_rtol(torch, n),
                      abs(got - want))
            if dtype == torch.int8:
                consts = ({"k": db.int8_index(1023)}, {"k": -77})
            else:
                consts = ({"c": db.copy_scales(1024, dtype)[1023],
                           "eps": db.step_eps(dtype)},
                          {"c": 0.375, "eps": -0.25})
            out = torch.empty_like(x)
            for kw in consts:
                want = stream.stream_copy_reference(x, src, **kw)
                got = stream.stream_copy(x, src, out, **kw)
                abs_err = (got.float() - want.float()).abs().max().item()
                if dtype == torch.int8:
                    check("stream_copy", x, kw, abs_err, 0.0, abs_err)
                else:
                    check("stream_copy", x, kw, ulp_gap(torch, got, want),
                          STREAM_ULPS, abs_err)
                del want
            del out
            if (dtype, nbytes) != (torch.bfloat16, 1 << 30):
                del x, src
                continue
            y, z = (_stream_buffer(torch, gen, n, dtype) for _ in range(2))
            for sc, eps in ((db.step_scales(2048, dtype)[2047],
                             db.step_eps(dtype)), (0.375, -0.25)):
                want = stream.triad_reference(x, y, z, sc, eps)
                got = stream.triad(x, y, z, sc, eps, out=z)
                check("stream_triad", x, {"s": sc, "eps": eps},
                      ulp_gap(torch, got, want), STREAM_ULPS,
                      (got.float() - want.float()).abs().max().item())
                del want
            timed = (x, y, z, src)
    return checks, timed


def stream_kernel_rows(torch, db, stream, gen):
    """The Triton kernels held to their plain versions (``_stream_checks``),
    then timed at the HBM rows' 1 GiB bf16 buffers: the kernel, the plain
    version, the bound (the bytes each moves once over the HBM rate, or
    its f32 operations over the f32 peak, the larger) and beside them the
    PyTorch calls nearest to each, which compute less or take two calls
    (so no library_ms): ``torch.sum``'s one-pass read without |x + b|,
    and the copy through ``addcmul`` and a one-element product."""
    checks, (x, y, z, src) = _stream_checks(torch, db, stream, gen)
    row = {"phase": "stream_kernels", "buffer_bytes": x.nbytes,
           "dtype": "bfloat16", "checks": checks}
    n = x.numel()

    def first(kernel):
        return next(c for c in checks
                    if c["kernel"] == kernel and c["bytes"] == x.nbytes
                    and c["dtype"] == "bfloat16")

    sc, eps = db.step_scales(2048, torch.bfloat16)[2047], \
        db.step_eps(torch.bfloat16)
    triad = {"max_abs_err": first("stream_triad")["max_abs_err"]}
    triad["ms"] = time_ms(lambda: stream.triad(x, y, z, sc, eps, out=z),
                          torch)
    triad["plain_ms"] = time_ms(
        lambda: stream.triad_reference(x, y, z, sc, eps), torch,
        budget_ms=100.0)
    triad["bound_ms"], triad["bound_by"] = _stream_bound(4 * x.nbytes, 4 * n)
    acc = torch.zeros(1, device="cuda")
    bias = db.read_bias(1023)
    read = {"max_abs_err": first("stream_read")["max_abs_err"]}
    read["ms"] = time_ms(lambda: stream.stream_read(x, acc, bias), torch)
    read["plain_ms"] = time_ms(
        lambda: stream.stream_read_reference(x, bias), torch,
        budget_ms=100.0)
    read["bound_ms"], read["bound_by"] = _stream_bound(x.nbytes, 3 * n)
    read["torch_sum_ms"] = time_ms(
        lambda: torch.sum(x, dtype=torch.float32), torch)
    out = torch.empty_like(x)
    c = db.copy_scales(1024, torch.bfloat16)[1023]
    scale = torch.full((1,), c, dtype=torch.bfloat16, device="cuda")
    copy = {"max_abs_err": first("stream_copy")["max_abs_err"]}
    copy["ms"] = time_ms(
        lambda: stream.stream_copy(x, src, out, c=c, eps=eps), torch)
    copy["plain_ms"] = time_ms(
        lambda: stream.stream_copy_reference(x, src, c=c, eps=eps), torch,
        budget_ms=100.0)
    copy["bound_ms"], copy["bound_by"] = _stream_bound(2 * x.nbytes, 2 * n)
    copy["addcmul_ms"] = time_ms(
        lambda: torch.addcmul(src[:1] * eps, x, scale, out=out), torch)
    row.update(stream_triad=triad, stream_read=read, stream_copy=copy)
    emit(row)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"stream kernels disagree with their plain versions: {bad}")
    return row


def _stream_bound(nbytes, f32_ops):
    """(bound_ms, bound_by) of a streaming pass: bytes over the HBM rate
    or its f32 operations over the f32 peak, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, f32_ops / PEAK_F32_FLOPS
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# Public checkpoints whose head widths only this block's padded and D 256
# kernels take, at their published widths on the repo's Llama-style block
# (``Model(cfg)``; random weights from a seed, no checkpoint):
# Phi-3-mini (config.json of microsoft/Phi-3-mini-4k-instruct: D 3072 / 32
# = 96), Gemma-2B (google/gemma-2b: 8 heads of 256 over one KV head) and
# StableLM-3B-4E1T (stabilityai/stablelm-3b-4e1t: 2560 / 32 = 80). The
# block keeps its own MLP, norms and full rotary: the widths, not the
# models, are what the kernels see.
HEAD_WIDTH_MODELS = {
    "phi3_mini": dict(vocab_size=32064, d_model=3072, n_layers=32,
                      n_heads=32, n_kv_heads=32, d_ff=8192,
                      max_seq_len=4096, rope_theta=10000.0),
    # Gemma-2-2B (config.json of google/gemma-2-2b: d 2304, 8 heads over 4
    # KV heads, d_ff 9216, vocab 256000, 26 layers) and Gemma-3-1B
    # (google/gemma-3-1b-pt: d 1152, 4 heads over 1, d_ff 6912, vocab
    # 262144, 26 layers, rope θ 1e6): their checkpoints' heads are 256
    # wide, the repo's block's d_model / n_heads = 288, past 256.
    "gemma2_2b": dict(vocab_size=256000, d_model=2304, n_layers=26,
                      n_heads=8, n_kv_heads=4, d_ff=9216, max_seq_len=8192,
                      rope_theta=10000.0),
    "gemma3_1b": dict(vocab_size=262144, d_model=1152, n_layers=26,
                      n_heads=4, n_kv_heads=1, d_ff=6912,
                      max_seq_len=32768, rope_theta=1000000.0),
    "gemma_2b": dict(vocab_size=256000, d_model=2048, n_layers=18,
                     n_heads=8, n_kv_heads=1, d_ff=16384, max_seq_len=8192,
                     rope_theta=10000.0),
    "stablelm_3b": dict(vocab_size=50304, d_model=2560, n_layers=32,
                        n_heads=32, n_kv_heads=32, d_ff=6912,
                        max_seq_len=4096, rope_theta=10000.0),
}
# Served depth: Phi-3-mini cut to SERVE_LAYERS of its 32 as the Llama
# phases are; Gemma-2B whole (18 layers, about 6 GB of bf16 weights) and
# Gemma-2-2B's widths whole (26 layers).
HEAD_WIDTH_SERVE_LAYERS = {"phi3_mini": SERVE_LAYERS, "gemma_2b": 18,
                           "gemma2_2b": 26}
# make_train_step steps after the gradients are held.
HEAD_WIDTH_TRAIN = {"gemma_2b": 3, "stablelm_3b": 0, "gemma3_1b": 3}
HEAD_WIDTH_TRAIN_LAYERS = 2
HEAD_WIDTH_TRAIN_SEQ = 4096
HEAD_WIDTH_NEW = 16


def _width_traffic(np, vocab):
    """Greedy requests of 300, 800 and 1500 random tokens, and a 32-token
    pattern repeated to 512 (SPEC_NEW new tokens) for the ngram proposer
    to find, so that the run verifies."""
    rng = np.random.default_rng(11)
    prompts = {f"p{n}": rng.integers(0, vocab, n).tolist()
               for n in (300, 800, 1500)}
    max_new = {name: HEAD_WIDTH_NEW for name in prompts}
    prompts["pattern"] = np.tile(rng.integers(0, vocab, SPEC_PATTERN),
                                 SPEC_PROMPT // SPEC_PATTERN).tolist()
    max_new["pattern"] = SPEC_NEW
    return prompts, max_new


def _width_engine(torch, serve_cli, attention, model, prompts, max_new,
                  solo=()):
    """The paged engine under ``--speculate ngram`` (serve_paged's slots,
    chunks and blocks) on ``model`` behind the HTTP server: each of
    ``solo`` ((name, prompt, max_new)) posted alone, its wall time read as
    ``solo_latency_s``, then every prompt posted at once → (streams,
    readings)."""
    engine = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512, kv_cache="paged",
        kv_block_size=16, speculate="ngram")
    server, state = serve_cli.start_server(engine, port=0, host="127.0.0.1")
    try:
        t0 = time.perf_counter()
        serve_cli.wait_ready(state, timeout=600)
        ready_s = time.perf_counter() - t0
        port = server.server_address[1]
        solo_s = {}
        for name, prompt, new in solo:
            resp = serve_cli.post_generate(port, [prompt], new)
            _check_response(name, resp, prompt, new, model.cfg.vocab_size)
            solo_s[name] = resp["latency_s"]
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            futures = {name: pool.submit(serve_cli.post_generate, port,
                                         [prompt], max_new[name])
                       for name, prompt in prompts.items()}
            streams = {name: f.result(timeout=600)["tokens"][0]
                       for name, f in futures.items()}
    finally:
        server.shutdown()
        server.server_close()
    stats = engine.stats()
    readings = {"ready_s": ready_s, "solo_latency_s": solo_s,
                "n_prefills": stats["n_prefills"],
                "steps_done": stats["steps_done"],
                "ttft_s": [{"prompt_len": n, "ttft_s": t}
                           for n, t in engine.ttft_s],
                "decode_tokens_per_s": stats["occupied_steps"]
                / max(stats["t_chunk_s"], 1e-9),
                **{k: stats[k] for k in ("spec_verifies", "spec_proposed",
                                         "spec_accepted")},
                **engine.graph_stats()}
    engine.shutdown()
    return streams, readings


def _width_serve(torch, np, tf, serve_cli, attention, _ext, name):
    """One HEAD_WIDTH_MODELS model at HEAD_WIDTH_SERVE_LAYERS: the paged
    engine's streams (``_width_engine``) held to the same engine on the
    plain attention by the margin rule, and a 1500-token prefill's logits
    to the plain attention's. Returns (the phase row, flash launches:
    the eager calls and n_layers a verify replay)."""
    cfg = tf.TransformerConfig(**dict(
        HEAD_WIDTH_MODELS[name], n_layers=HEAD_WIDTH_SERVE_LAYERS[name]))
    model = serve_cli.Model(cfg, seed=0, device="cuda")
    prompts, max_new = _width_traffic(np, cfg.vocab_size)
    before = attention.flash_fwd_launches
    got, r = _width_engine(torch, serve_cli, attention, model, prompts,
                           max_new)
    logits = _prefill_logits(torch, tf, model, prompts["p1500"])
    launches = attention.flash_fwd_launches - before + \
        cfg.n_layers * r["verify_graph_replays"]
    before = attention.flash_fwd_launches
    with plain_attention(tf, attention):
        want, _ = _width_engine(torch, serve_cli, attention, model, prompts,
                                max_new)
        row = _logit_row(torch, logits, _prefill_logits(
            torch, tf, model, prompts["p1500"]))
    if attention.flash_fwd_launches != before:
        fail(f"head_widths {name}: the plain-attention reference launched "
             f"the kernel")
    for req, prompt in prompts.items():
        _check_response(f"head_widths {name} {req}",
                        {"tokens": [got[req]]}, prompt, max_new[req],
                        cfg.vocab_size)
    if not r["spec_verifies"] or \
            r["verify_graph_replays"] != r["spec_verifies"] or \
            r["eager_chunks_on_cuda"] or r["eager_verifies_on_cuda"]:
        fail(f"head_widths {name}: {r['spec_verifies']} verifies, "
             f"{r['verify_graph_replays']} verify replays, "
             f"{r['eager_chunks_on_cuda']} eager chunks")
    _hold_logit_row(row, f"head_widths {name}", "prefill_p1500")
    partings = _margin_partings(torch, tf, model, prompts, got, want,
                                f"head_widths_{name}")
    out = {"n_layers": cfg.n_layers, "n_layers_full": HEAD_WIDTH_MODELS[
        name]["n_layers"], "head_dim": cfg.head_dim,
        "kernel_head_dim": _ext.kernel_head_dim(cfg.head_dim),
        "weights_gb": weight_bytes(model.model) / 1e9,
        "prefill_p1500": row, "partings": partings,
        "flash_fwd_launches": launches,
        **{k: r[k] for k in ("ready_s", "n_prefills", "steps_done", "ttft_s",
                             "decode_tokens_per_s", "spec_verifies",
                             "spec_proposed", "spec_accepted",
                             "graph_captures", "graph_replays",
                             "verify_graph_replays")}}
    del model
    _free(torch)
    return out, launches


def _width_train(torch, np, tf, serve_cli, attention, _ext, name, steps):
    """One HEAD_WIDTH_MODELS model at HEAD_WIDTH_TRAIN_LAYERS layers, B 1 ×
    HEAD_WIDTH_TRAIN_SEQ: the loss and every gradient through the kernels
    (``FlashAttention.backward``) held to plain attention by
    TRAIN_GRAD_TOL, then ``steps`` make_train_step steps (AdamW, remat; the
    train_cli path). Returns (the phase row, launches (fwd, dq, dkv))."""
    cfg = tf.TransformerConfig(**dict(HEAD_WIDTH_MODELS[name],
                                      n_layers=HEAD_WIDTH_TRAIN_LAYERS))
    model = tf.init_params(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(3)

    def batch():
        return {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (1, HEAD_WIDTH_TRAIN_SEQ + 1)),
            device="cuda")}

    tokens = batch()

    def loss_and_grads(attn_impl):
        model.zero_grad(set_to_none=True)
        loss = tf.loss_fn(model, tokens, attn_impl=attn_impl)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    counts = _flash_counts(attention)
    loss_k, grads_k = loss_and_grads("flash")
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    launches = [a - b for a, b in zip(_flash_counts(attention), counts)]
    loss_r, grads_r = loss_and_grads("reference")
    bad, errs = _grad_errors(torch, grads_k, grads_r)
    del grads_k, grads_r
    model.zero_grad(set_to_none=True)
    row = {"n_layers": cfg.n_layers, "seq_len": HEAD_WIDTH_TRAIN_SEQ,
           "batch": 1, "head_dim": cfg.head_dim,
           "kernel_head_dim": _ext.kernel_head_dim(cfg.head_dim),
           "loss_kernels": loss_k,
           "loss_plain": loss_r, **errs}
    if bad or abs(loss_k - loss_r) > TRAIN_GRAD_TOL["loss_abs"] or \
            not math.isfinite(loss_k):
        emit({"phase": "head_widths_train", "model": name, **row})
        fail(f"head_widths {name}: gradients through the kernels disagree "
             f"with plain attention for {bad or 'the loss'}")
    if launches != [cfg.n_layers] * 3:
        fail(f"head_widths {name}: the step launched fwd/dq/dkv {launches} "
             f"times, want {cfg.n_layers} each")
    row["attention_bwd_ms"] = _layer_bwd_ms(torch, attention, cfg)
    if steps:
        init_state, train_step = tf.make_train_step(cfg, device="cuda")
        state = init_state(model=model)
        torch.cuda.reset_peak_memory_stats()
        counts = _flash_counts(attention)
        losses, step_s = [], []
        for _ in range(steps):
            b = batch()
            t0 = time.perf_counter()
            state, loss = train_step(state, b)
            losses.append(loss.item())
            step_s.append(time.perf_counter() - t0)
        step_launches = [a - b for a, b in zip(_flash_counts(attention),
                                               counts)]
        want = [2 * cfg.n_layers * steps] + [cfg.n_layers * steps] * 2
        if step_launches != want or not all(map(math.isfinite, losses)):
            fail(f"head_widths {name}: {steps} steps launched fwd/dq/dkv "
                 f"{step_launches} times (want {want}), losses {losses}")
        launches = [a + b for a, b in zip(launches, step_launches)]
        row.update(losses=losses, step_ms=[t * 1e3 for t in step_s],
                   tokens_per_s=HEAD_WIDTH_TRAIN_SEQ * steps / sum(step_s),
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9)
        del state
    if name == "stablelm_3b":
        # One prefill through the serving entry point's program, held to
        # the plain attention's logits.
        served = serve_cli.Model(cfg, weights=model)
        prompt = rng.integers(0, cfg.vocab_size, 1500).tolist()
        before = attention.flash_fwd_launches
        got = _prefill_logits(torch, tf, served, prompt)
        launches[0] += attention.flash_fwd_launches - before
        with plain_attention(tf, attention):
            row["prefill_p1500"] = _logit_row(
                torch, got, _prefill_logits(torch, tf, served, prompt))
        _hold_logit_row(row["prefill_p1500"], f"head_widths {name}",
                        "prefill_p1500")
    row["launches_fwd_dq_dkv"] = launches
    del model
    _free(torch)
    return row, launches


def _layer_bwd_ms(torch, attention, cfg):
    """Device ms of one layer's attention backward (``flash_bwd``: dq,
    dk/dv and delta) at the training shape, B 1 × HEAD_WIDTH_TRAIN_SEQ,
    bf16, causal. The launch counters are left as they were."""
    counts = _flash_counts(attention)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, g = (torch.randn(1, cfg.n_heads, HEAD_WIDTH_TRAIN_SEQ, cfg.head_dim,
                        generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    k, v = (torch.randn(1, cfg.n_kv_heads, HEAD_WIDTH_TRAIN_SEQ,
                        cfg.head_dim, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    kw = dict(causal=True, sm_scale=cfg.head_dim ** -0.5)
    out, lse = attention.flash_fwd(q, k, v, **kw)
    ms = time_ms(lambda: attention.flash_bwd(q, k, v, out, lse, g, **kw),
                 torch)
    (attention.flash_fwd_launches, attention.flash_dq_launches,
     attention.flash_dkv_launches) = counts
    return ms


def head_widths_phase(torch, np, tf, serve_cli, attention, _ext, card):
    """The head widths only the padded kernels (D 80 and 96 on the D 128
    instantiation), the D 256 ones and the column-chunk ones (D 288) take,
    through the entry points a user calls at public checkpoints' widths
    (HEAD_WIDTH_MODELS): Phi-3-mini, Gemma-2B and Gemma-2-2B's widths
    served on the paged engine under ``--speculate ngram``
    (``_width_serve``), Gemma-2B, StableLM-3B and Gemma-3-1B's widths
    trained at 2 layers, B 1 × 4096 (``_width_train``; Gemma-2B and
    Gemma-3-1B three make_train_step steps more), StableLM-3B's prefill;
    each held to the same path on the plain attention. Counts at zero
    before, read after; returns the launches (fwd, dq, dkv), each above 0,
    and fails unless D 288 launched the forward serving and all three
    kernels training."""
    _zero_flash_counts(attention)
    t0 = time.perf_counter()
    serving, training = {}, {}
    launches = [0, 0, 0]
    for name in HEAD_WIDTH_SERVE_LAYERS:
        serving[name], fwd = _width_serve(torch, np, tf, serve_cli,
                                          attention, _ext, name)
        launches[0] += fwd
    for name, steps in HEAD_WIDTH_TRAIN.items():
        training[name], counts = _width_train(torch, np, tf, serve_cli,
                                              attention, _ext, name, steps)
        launches = [a + b for a, b in zip(launches, counts)]
    if list(_flash_counts(attention)[1:]) != launches[1:] or \
            min(launches) <= 0:
        fail(f"head_widths: launches {launches} against the counters "
             f"{_flash_counts(attention)}")
    if serving["gemma2_2b"]["flash_fwd_launches"] <= 0 or \
            min(training["gemma3_1b"]["launches_fwd_dq_dkv"]) <= 0:
        fail("head_widths: D 288 did not launch the kernels on every path")
    emit({"phase": "head_widths", **card,
          "models": {n: {k: v for k, v in HEAD_WIDTH_MODELS[n].items()
                         if k != "n_layers"} for n in HEAD_WIDTH_MODELS},
          "serve": serving, "train": training, "tol": {
              "serve_logits_atol": SERVE_LOGITS_ATOL,
              "train": TRAIN_GRAD_TOL},
          "seconds": time.perf_counter() - t0,
          "launches_fwd_dq_dkv": launches})
    return tuple(launches)


# float16: the dtype JAX takes beside bf16 and f32. The f16
# kernels' rows: the forward at D 64, 128, 256 and 288, causal and not,
# with GQA groups of 8 and Llama-2-7B's heads (32 over 32, D 128), a
# device-base verify; the wide forward at D 288 (both Gemma widths), 512
# and 1024; dq and dk/dv at D 64-288; int8_mm with f16 activations.
FP16_CASES = [
    ("fp16_d64_gqa8_s4096", 1, 4096, 4096, True, 0, 0, None, 32, 4, 64,
     "float16"),
    ("fp16_d64_noncausal_kv_len", 2, 300, 1000, False, 0, 0, 777, 16, 2, 64,
     "float16"),
    ("fp16_llama2_7b_s2048", 1, 2048, 2048, True, 0, 0, None, 32, 32, 128,
     "float16"),
    ("fp16_d128_noncausal_kv_len", 1, 300, 1000, False, 0, 0, 777, 32, 8,
     128, "float16"),
    ("fp16_llama2_7b_verify_b8_sq16", 8, 16, 2048, True,
     [1040 + 137 * i for i in range(8)], 0, None, 32, 32, 128, "float16"),
    ("fp16_d256_gqa8_s4096", 1, 4096, 4096, True, 0, 0, None, 8, 1, 256,
     "float16"),
    ("fp16_d256_noncausal_kv_len", 1, 300, 1000, False, 0, 0, 777, 8, 1,
     256, "float16"),
    ("fp16_gemma2_2b_d288_s4096", 1, 4096, 4096, True, 0, 0, None, 8, 4, 288,
     "float16"),
    ("fp16_gemma3_1b_d288_s4096", 1, 4096, 4096, True, 0, 0, None, 4, 1, 288,
     "float16"),
    ("fp16_d288_noncausal_gqa8", 1, 300, 1000, False, 0, 0, 777, 8, 1, 288,
     "float16"),
]
# The wide forward's widths in both 16-bit dtypes (forward rows only; the
# bf16 D 288 and 512 rows are WIDE_CASES'): D 288 at both Gemma widths, D
# 512 (two chunks, Q resident), D 1024 (the streaming kernel).
WIDE_FWD_CASES = [
    ("d1024_s2048", 1, 2048, 2048, True, 0, 0, None, 4, 4, 1024, "bfloat16"),
    ("fp16_d512_s2048", 1, 2048, 2048, True, 0, 0, None, 8, 8, 512,
     "float16"),
    ("fp16_d1024_s2048", 1, 2048, 2048, True, 0, 0, None, 4, 4, 1024,
     "float16"),
]
FP16_BWD_CASES = [c for c in FP16_CASES if not isinstance(c[5], list)]
# int8_mm with f16 activations: Llama-3-8B's w1, wq and wk at the engines'
# decode batch of 8, and w1 at a 512-token prefill.
FP16_INT8_CASES = [("fp16_m8_w1", 8, 4096, 14336), ("fp16_m8_wq", 8, 4096,
                                                     4096),
                   ("fp16_m8_wk", 8, 4096, 1024),
                   ("fp16_m512_w1", 512, 4096, 14336)]


def fp16_kernels_phase(torch, attention, _ext, int8_matmul, q8, gen,
                       serving_graphs, card):
    """Every f16 kernel against its plain version (FP16_CASES,
    WIDE_FWD_CASES, FP16_BWD_CASES, FP16_INT8_CASES): each row its device
    ms, bound, host µs and, for the flash rows, SDPA's f16 time and
    backend. Returns the rows (fwd, bwd, int8) by case."""
    t0 = time.perf_counter()
    fwd = {c[0]: run_kernel_case(c, torch, attention, gen, serving_graphs)
           for c in FP16_CASES + WIDE_FWD_CASES}
    _free(torch)
    bwd = {c[0]: run_bwd_case(c, torch, attention, _ext, gen, serving_graphs)
           for c in FP16_BWD_CASES}
    _free(torch)
    int8 = {c[0]: run_int8_case(c, torch, int8_matmul, q8, gen,
                                serving_graphs, attention, act="float16")
            for c in FP16_INT8_CASES}
    _free(torch)

    def brief(row, pre=""):
        return {k: row.get(f"{pre}{k}") for k in (
            "ms", "bound_ms", "bound_by", "plain_ms", "host_us")}
    emit({"phase": "fp16_kernels", **card,
          "seconds": time.perf_counter() - t0,
          "fwd": {n: {**brief(r), "dtype": r["dtype"],
                      "library_ms": r["library_ms"],
                      "library_backend": r.get("library_backend"),
                      "max_abs_err_out": r["max_abs_err_out"]}
                  for n, r in fwd.items()},
          "dq": {n: brief(r, "dq_") for n, r in bwd.items()},
          "dkv": {n: brief(r, "dkv_") for n, r in bwd.items()},
          "bwd_library": {n: {"ms": r["library_ms"],
                              "backend": r.get("library_backend")}
                          for n, r in bwd.items()},
          "int8_mm": {n: {k: r[k] for k in (
              "ms", "bound_ms", "bound_by", "plain_ms", "host_us",
              "library_ms", "f16_ms", "max_abs_err")}
              for n, r in int8.items()}})
    return fwd, bwd, int8


# Llama-2-7B (meta-llama/Llama-2-7b-hf config.json: d 4096, 32 heads over
# 32 KV heads of 128, d_ff 11008, vocab 32000, rope θ 10000, 4096
# positions, "torch_dtype": "float16"), random weights; served at
# SERVE_FP16_LAYERS of its 32 layers to stay in the time limit, trained at
# TRAIN_FP16_LAYERS.
LLAMA2_7B = dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                 n_kv_heads=32, d_ff=11008, max_seq_len=4096,
                 rope_theta=10000.0, dtype="float16")
SERVE_FP16_LAYERS = 8
TRAIN_FP16_LAYERS = 2
TRAIN_FP16_SEQ = 4096
FP16_MAX = 65504.0


def _max_activations(torch, tf, model, prompt):
    """The largest |value| of each layer's output (the residual stream)
    and of the logits over one forward of ``prompt``: where f16 would
    overflow (past 65504) it shows here."""
    seen = []
    hooks = [layer.register_forward_hook(
        lambda _m, _i, out: seen.append(out[0].abs().max().item()))
        for layer in model.model.layers]
    try:
        with torch.inference_mode():
            logits = tf.forward(model.model, torch.as_tensor(
                [prompt], device=model.device), logits_at="last")
    finally:
        for h in hooks:
            h.remove()
    return {"layers": seen, "logits": logits.abs().max().item()}


def serve_fp16_phase(torch, np, tf, serve_cli, attention, int8_matmul,
                     card):
    """Llama-2-7B's widths in f16 at SERVE_FP16_LAYERS layers on the paged
    engine under ``--speculate ngram`` (``_width_engine``, after three
    solo requests at fresh 1500-token prompts: 33 new tokens, capturing
    the decode window's graph; one token for TTFT; 33 new tokens for ms a
    token), its streams held to the same engine on
    the plain attention by the margin rule and a 1500-token prefill's
    logits to the plain attention's; then one ``--quantize int8`` request
    on the same weights. Counts at zero before, read after; returns the
    flash launches (eager calls and n_layers a verify replay) and the int8
    launches."""
    cfg = tf.TransformerConfig(**dict(LLAMA2_7B,
                                      n_layers=SERVE_FP16_LAYERS))
    t0 = time.perf_counter()
    model = serve_cli.Model(cfg, seed=0, device="cuda")
    prompts, max_new = _width_traffic(np, cfg.vocab_size)
    # Fresh 1500-token prompts: the first captures its decode window's
    # graph, the second reads TTFT, the third decodes on replays.
    rng = np.random.default_rng(12)
    solo = [(name, rng.integers(0, cfg.vocab_size, 1500).tolist(), new)
            for name, new in (("capture_p1500", 33), ("ttft_p1500", 1),
                              ("decode_p1500", 33))]
    _zero_flash_counts(attention)
    got, r = _width_engine(torch, serve_cli, attention, model, prompts,
                           max_new, solo=solo)
    logits = _prefill_logits(torch, tf, model, prompts["p1500"])
    launches = attention.flash_fwd_launches + \
        cfg.n_layers * r["verify_graph_replays"]
    act = _max_activations(torch, tf, model, prompts["p1500"])
    before = attention.flash_fwd_launches
    with plain_attention(tf, attention):
        want, _ = _width_engine(torch, serve_cli, attention, model, prompts,
                                max_new)
        row = _logit_row(torch, logits, _prefill_logits(
            torch, tf, model, prompts["p1500"]))
    if attention.flash_fwd_launches != before:
        fail("serve_fp16: the plain-attention reference launched the kernel")
    for req, prompt in prompts.items():
        _check_response(f"serve_fp16 {req}", {"tokens": [got[req]]}, prompt,
                        max_new[req], cfg.vocab_size)
    if not r["spec_verifies"] or \
            r["verify_graph_replays"] != r["spec_verifies"] or \
            r["eager_chunks_on_cuda"] or r["eager_verifies_on_cuda"]:
        fail(f"serve_fp16: {r['spec_verifies']} verifies, "
             f"{r['verify_graph_replays']} verify replays, "
             f"{r['eager_chunks_on_cuda']} eager chunks")
    _hold_logit_row(row, "serve_fp16", "prefill_p1500")
    partings = _margin_partings(torch, tf, model, prompts, got, want,
                                "serve_fp16")
    peak = max(act["layers"] + [act["logits"]])
    if not math.isfinite(peak) or peak >= FP16_MAX or launches <= 0:
        fail(f"serve_fp16: largest |activation| {peak}, {launches} flash "
             f"launches")
    ttft = r["solo_latency_s"]["ttft_p1500"]
    decode_ms = (r["solo_latency_s"]["decode_p1500"] - ttft) / 32 * 1e3

    # One --quantize int8 request on the same weights (quantized in place).
    q_model = serve_cli.Model(cfg, weights=model.model, quantize="int8")
    counts = int8_matmul.int8_mm_launches, int8_matmul.int8_mm_captured
    flash0 = attention.flash_fwd_launches
    engine = serve_cli.ContinuousEngine(
        q_model, max_slots=2, chunk=32, prefill_chunk=512, kv_cache="paged",
        kv_block_size=16)
    try:
        t1 = time.perf_counter()
        (int8_tokens,) = engine.generate([prompts["p300"]], 16)
        int8_s = time.perf_counter() - t1
    finally:
        engine.shutdown()
    int8_launches = int8_matmul.int8_mm_launches - counts[0]
    int8_captured = int8_matmul.int8_mm_captured - counts[1]
    launches += attention.flash_fwd_launches - flash0
    _check_response("serve_fp16 int8", {"tokens": [int8_tokens]},
                    prompts["p300"], 16, cfg.vocab_size)
    if int8_launches + int8_captured <= 0:
        fail("serve_fp16: the int8 request launched no int8_mm kernel")
    emit({"phase": "serve_fp16", **card, "model": "llama2-7b",
          "dtype": "float16", "n_layers": cfg.n_layers,
          "n_layers_full": LLAMA2_7B["n_layers"],
          "weights_gb": weight_bytes(model.model) / 1e9,
          "ttft_s_p1500": ttft, "decode_ms_per_token_p1500": decode_ms,
          "solo_latency_s": r["solo_latency_s"],
          "prefill_p1500": row, "partings": partings,
          "max_abs_activation": act, "fp16_max": FP16_MAX,
          "flash_fwd_launches": launches,
          "int8": {"tokens": len(int8_tokens) - len(prompts["p300"]),
                   "wall_s": int8_s, "int8_mm_launches": int8_launches,
                   "int8_mm_captured": int8_captured},
          **{k: r[k] for k in ("ready_s", "n_prefills", "steps_done",
                               "ttft_s", "decode_tokens_per_s",
                               "spec_verifies", "spec_proposed",
                               "spec_accepted", "graph_captures",
                               "graph_replays", "verify_graph_replays")},
          "seconds": time.perf_counter() - t0})
    del model, q_model
    _free(torch)
    return launches, int8_launches


@contextlib.contextmanager
def plain_flash_training(torch, tf, attention):
    """Inside the block, the training step's attention
    (``transformer.flash_attention``) runs the flash kernels' plain
    versions on the card under autograd: ``flash_fwd_reference`` forward
    and ``flash_bwd_reference`` backward, with the kernels' (and JAX's
    Pallas kernels') rounding points: p to the input dtype before P V, dS
    before its products. The port itself never does this."""

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, sm_scale):
            out, lse = attention.flash_fwd_reference(
                q, k, v, causal=causal, sm_scale=sm_scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.sm_scale = causal, sm_scale
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = attention.flash_bwd_reference(
                q, k, v, out, lse, g, causal=ctx.causal,
                sm_scale=ctx.sm_scale)
            return dq, dk, dv, None, None

    attn = tf.flash_attention

    def plain(q, k, v, causal=True, sm_scale=None):
        return PlainFlash.apply(q, k, v, causal,
                                float(sm_scale or q.shape[-1] ** -0.5))

    tf.flash_attention = plain
    try:
        yield
    finally:
        tf.flash_attention = attn


# train_fp16's parameters whose gradients are not formed from a layer's
# own dS (wv from P^T dO, wo, the FFN, the second norm, ln_f): held by
# TRAIN_GRAD_TOL to the kernels' plain versions; the dS path reaches them
# only through the residual stream, mixed with the rest. wq and wk are
# formed from dS, and the first norm and the embedding sum them; at these
# widths dS is mostly below f16's smallest normal value (6.1e-5), so two
# f32 sums in another order round to other subnormals: the kernels and
# their plain versions, both 0.567 from the f32 step (relative L2 of wq's
# gradient), part by up to 0.087 (PERF.md §6).
# Every parameter is held to the f32 step by world_smoke's F32_ANCHOR: the
# kernels round no more than their plain versions.
TRAIN_FP16_PAST_DS = ("attn.wv", "attn.wo", "ln2", "ffn.", "ln_f")


def train_fp16_phase(torch, np, tf, attention, card):
    """Llama-2-7B's widths in f16 at TRAIN_FP16_LAYERS layers, B 1 ×
    TRAIN_FP16_SEQ: one step's loss and every gradient through the kernels
    (``FlashAttention.backward``) against the same step through the
    kernels' plain versions (``plain_flash_training``: JAX's rounding
    points) and the f32 step on the same weights widened: the loss within
    TRAIN_GRAD_TOL, the gradients not formed from dS
    (TRAIN_FP16_PAST_DS) within TRAIN_GRAD_TOL, and every gradient's
    relative L2 error from the f32 step within world_smoke's F32_ANCHOR of
    the plain versions' (see TRAIN_FP16_PAST_DS for why). The step on
    ``mha_reference`` under autograd, which rounds dP where the kernels
    round dS, is read beside. Counts at zero before, read after; returns
    the launches (fwd, dq, dkv)."""
    from container_engine_accelerators_tpu_torch.parallel import world_smoke

    t0 = time.perf_counter()
    cfg = tf.TransformerConfig(**dict(LLAMA2_7B,
                                      n_layers=TRAIN_FP16_LAYERS))
    model = tf.init_params(cfg, device="cuda", seed=0)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               (1, TRAIN_FP16_SEQ + 1))
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}

    def loss_and_grads(m, attn_impl):
        m.zero_grad(set_to_none=True)
        loss = tf.loss_fn(m, batch, attn_impl=attn_impl)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in m.named_parameters()}

    _zero_flash_counts(attention)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss_k, grads_k = loss_and_grads(model, "flash")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    launches = list(_flash_counts(attention))
    counted = _flash_counts(attention)
    with plain_flash_training(torch, tf, attention):
        loss_p, grads_p = loss_and_grads(model, "flash")
    if _flash_counts(attention) != counted:
        fail("train_fp16: the plain versions launched a kernel")
    past_ds = [n for n in grads_p if any(s in n for s in TRAIN_FP16_PAST_DS)]
    bad, errs = _grad_errors(torch, {n: grads_k[n] for n in past_ds},
                             {n: grads_p[n] for n in past_ds})
    _, all_params = _grad_errors(torch, grads_k, grads_p)
    loss_r, grads_r = loss_and_grads(model, "reference")
    _, vs_reference = _grad_errors(torch, grads_k, grads_r)
    wide = world_smoke.widened(torch, tf, model)
    loss_32, grads_32 = loss_and_grads(wide, "reference")
    del wide
    anchor = {name: _grad_errors(torch, g, grads_32)[1]["worst_rel_l2"]
              for name, g in (("kernels", grads_k),
                              ("plain_versions", grads_p),
                              ("mha_reference", grads_r))}
    del grads_k, grads_p, grads_r, grads_32
    row = {"phase": "train_fp16", **card, "model": "llama2-7b",
           "dtype": "float16", "n_layers": cfg.n_layers, "batch": 1,
           "seq_len": TRAIN_FP16_SEQ, "loss_kernels": loss_k,
           "loss_plain_versions": loss_p, "past_ds": errs,
           "all_params": all_params, "loss_mha_reference": loss_r,
           "vs_mha_reference": vs_reference, "loss_f32": loss_32,
           "worst_rel_l2_vs_f32": anchor, "tol": TRAIN_GRAD_TOL,
           "f32_anchor": world_smoke.F32_ANCHOR,
           "forward_backward_s": step_s, "launches_fwd_dq_dkv": launches,
           "seconds": time.perf_counter() - t0}
    emit(row)
    if bad or abs(loss_k - loss_p) > TRAIN_GRAD_TOL["loss_abs"] or \
            not math.isfinite(loss_k) or len(past_ds) != 6 * cfg.n_layers \
            + 1 or anchor["kernels"] > world_smoke.F32_ANCHOR * \
            anchor["plain_versions"]:
        fail(f"train_fp16: the step through the kernels disagrees with "
             f"their plain versions for {bad or 'the loss'}, or is further "
             f"from the f32 step ({anchor})")
    if launches != [cfg.n_layers] * 3:
        fail(f"train_fp16: fwd/dq/dkv launched {launches} times, want "
             f"{cfg.n_layers} each")
    del model
    _free(torch)
    return tuple(launches)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from container_engine_accelerators_tpu_torch.collectives import (
        device_bench as db,
    )
    from container_engine_accelerators_tpu_torch.models import quantization as q8
    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import serving_graphs
    from container_engine_accelerators_tpu_torch.models import train_cli
    from container_engine_accelerators_tpu_torch.models import transformer as tf
    from container_engine_accelerators_tpu_torch.ops import _ext, attention
    from container_engine_accelerators_tpu_torch.ops import int8_matmul
    from container_engine_accelerators_tpu_torch.ops import stream
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention,
        world_smoke,
    )

    # Plain versions compute in full f32 (no TF32), as the kernels do.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name, power = [s.strip() for s in smi.split(",", 1)]
    card = {"gpu": name, "power_limit": power}
    peaks = db.detect_generation(torch.device("cuda", 0))
    emit({"phase": "env", **card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "card_table": peaks and dataclasses.asdict(peaks)})
    if peaks != PEAK_CARD:
        fail(f"{torch.cuda.get_device_name(0)}: the bounds hold the peaks "
             f"of {PEAK_CARD.name}, and collectives/cards.py gives this "
             f"card {peaks}")

    t0 = time.perf_counter()
    _ext.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": i["seconds"],
                          "ptxas": ptxas_summary(i["ptxas"])}
                      for n, i in _ext.build_info.items()}})

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {c[0]: run_kernel_case(c, torch, attention, gen, serving_graphs)
            for c in KERNEL_CASES}
    bwd_rows = {c[0]: run_bwd_case(c, torch, attention, _ext, gen,
                                   serving_graphs)
                for c in BWD_CASES}
    _free(torch)
    int8_rows = {c[0]: run_int8_case(c, torch, int8_matmul, q8, gen,
                                     serving_graphs, attention)
                 for c in INT8_CASES}
    _free(torch)
    small_parity(torch, tf, serving_graphs, attention)
    int8_small_parity(torch, np, tf, serve_cli, int8_matmul, q8)
    paged_small_parity(torch, np, tf, serve_cli, attention)
    dense_small_parity(torch, np, tf, serve_cli, attention)
    spec_small_parity(torch, np, tf, serve_cli, attention)
    serve_launches, model, bf16 = serve(torch, np, tf, serve_cli, attention,
                                        card)
    bf16["weight_bytes"] = weight_bytes(model.model)
    paged_launches = serve_paged(torch, np, tf, serve_cli, attention, card,
                                 model)
    _free(torch)
    paged_graph_parity(torch, np, tf, serving_graphs, model, card)
    spec_launches = serve_spec(torch, np, tf, serve_cli, attention, card,
                               model, int8_matmul)
    dense_launches, bf16["dense"] = serve_dense(
        torch, np, tf, serve_cli, attention, card, model)
    _free(torch)
    robust_launches = serve_robust(torch, np, tf, serve_cli, attention,
                                   card, model)
    _free(torch)
    obs_launches = serve_obs(torch, np, serve_cli, attention, card, model,
                             bf16)
    _free(torch)
    handoff_launches = serve_handoff(torch, np, tf, serve_cli, attention,
                                     card, model)
    del model
    int8_launches, obs_int8_launches = serve_int8(
        torch, np, tf, serve_cli, attention, int8_matmul, q8, card, bf16)
    _free(torch)
    train_grads(torch, np, tf, attention)
    _free(torch)
    fwd_train, dq_train, dkv_train = train(torch, np, tf, attention, card)
    _free(torch)
    bert_launches = train_bert(torch, np, attention, card)
    _free(torch)
    _zero_flash_counts(attention)
    train_cli_phase(train_cli)
    cli_launches = [a + b for a, b in zip(
        _flash_counts(attention), train_cli_models(train_cli, attention))]
    _zero_flash_counts(attention)
    recovery_launches = train_recovery(torch, train_cli, attention)
    _free(torch)
    ring_launches, _ = ring_phase(torch, attention, ring_attention, world_smoke,
                                  card)
    _free(torch)
    pipeline_launches = pipeline_phase(torch, np, tf, attention,
                                       ring_attention, card)
    _free(torch)
    tp_launches = tensor_parallel_phase(torch, np, tf, attention, card)
    _free(torch)
    ep_launches = expert_parallel_phase(torch, np, tf, attention, card)
    _free(torch)
    moe_sp_launches = moe_sp_phase(torch, np, tf, attention, card)
    _free(torch)
    tp_whole_launches = tp_whole_phase(torch, np, tf, attention, card)
    _free(torch)
    int8_ring_launches = int8_ring_phase(torch, int8_matmul, q8, card)
    _free(torch)
    serve_tp_launches, serve_tp_int8_launches = serve_tp_phase(
        torch, np, tf, serve_cli, attention, int8_matmul, card)
    _free(torch)
    moe_launches, moe_int8_launches = serve_moe_phase(
        torch, np, tf, serve_cli, attention, int8_matmul, card)
    _free(torch)
    train_dist_launches = train_dist_phase(card)
    collectives_phase(card)
    bert_sp_launches = train_bert_sp(torch, np, attention, card)
    _free(torch)
    compile_cache_phase(card)
    train_cli_cache_phase(card)
    hostbench_phase()
    fleet_drills_phase()
    bench_launches, int8_decodes = device_bench_phase(
        torch, db, attention, int8_matmul, stream, card)
    _free(torch)
    hold_int8_decodes(torch, tf, int8_matmul, card, int8_decodes)
    del int8_decodes
    _free(torch)
    stream_rows = stream_kernel_rows(torch, db, stream, gen)
    _free(torch)
    head_widths_launches = head_widths_phase(torch, np, tf, serve_cli,
                                             attention, _ext, card)
    _free(torch)
    fp16_fwd, fp16_bwd, fp16_int8 = fp16_kernels_phase(
        torch, attention, _ext, int8_matmul, q8, gen, serving_graphs, card)
    serve_fp16_launches, serve_fp16_int8 = serve_fp16_phase(
        torch, np, tf, serve_cli, attention, int8_matmul, card)
    train_fp16_launches = train_fp16_phase(torch, np, tf, attention, card)
    training = {"train": (fwd_train, dq_train, dkv_train),
                "train_bert": bert_launches, "train_cli": cli_launches,
                "train_recovery": recovery_launches,
                "ring": ring_launches, "pipeline": pipeline_launches,
                "tensor_parallel": tp_launches,
                "expert_parallel": ep_launches,
                "moe_sp": moe_sp_launches, "tp_whole": tp_whole_launches,
                "train_dist": train_dist_launches,
                "train_bert_sp": bert_sp_launches,
                "device_bench": tuple(bench_launches[k] for k in (
                    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
                "head_widths": head_widths_launches,
                "train_fp16": train_fp16_launches}
    int8_launches["device_bench"] = bench_launches["int8_mm"]
    int8_launches["serve_fp16"] = serve_fp16_int8
    int8_launches["int8_ring"] = int8_ring_launches
    int8_launches["serve_tp_int8"] = serve_tp_int8_launches
    int8_launches["serve_moe"] = moe_int8_launches

    def by_path(i):
        return {path: counts[i] for path, counts in training.items()}

    src = "container_engine_accelerators_tpu_torch/ops/csrc/"
    replaces = "container_engine_accelerators_tpu/ops/attention.py:"
    main_row, bwd_row = rows[MAIN_CASE], bwd_rows[BWD_MAIN_CASE]
    # The same numbers at BERT-large's shape (train_bert's calls).
    bert_fwd, bert_bwd = rows[BERT_LARGE_CASE[0]], bwd_rows[BERT_LARGE_CASE[0]]

    def bert_shape(kind, err):
        row = bert_fwd if kind == "fwd" else bert_bwd
        pre = "" if kind == "fwd" else f"{kind}_"
        return {"case": BERT_LARGE_CASE[0], "max_abs_err": err,
                "ms": row[f"{pre}ms"], "plain_ms": row[f"{pre}plain_ms"],
                "bound_ms": row[f"{pre}bound_ms"],
                "bound_by": row[f"{pre}bound_by"],
                "library_ms": row["library_ms"] if kind == "fwd" else None,
                "host_us": row[f"{pre}host_us"],
                "graph_ms": row[f"{pre}graph_ms"]}
    int8_row = int8_rows[INT8_MAIN_CASE]
    # The same numbers at device_bench's S 32768 (bench_flash_long_context)
    # and at the pipeline phase's stage shape (S 4096).
    long_fwd = rows[LONG_CONTEXT_CASE[0]]
    long_bwd = bwd_rows[LONG_CONTEXT_CASE[0]]
    pp_fwd, pp_bwd = rows[PIPELINE_CASE[0]], bwd_rows[PIPELINE_CASE[0]]

    def case_shape(case, kind, err):
        row = rows[case] if kind == "fwd" else bwd_rows[case]
        pre = "" if kind == "fwd" else f"{kind}_"
        return {"case": case, "max_abs_err": err,
                "ms": row[f"{pre}ms"], "plain_ms": row[f"{pre}plain_ms"],
                "bound_ms": row[f"{pre}bound_ms"],
                "bound_by": row[f"{pre}bound_by"],
                "library_ms": row["library_ms"] if kind == "fwd" else None}

    def long_shape(kind, err):
        return case_shape(LONG_CONTEXT_CASE[0], kind, err)

    def pp_shape(kind, err):
        return case_shape(PIPELINE_CASE[0], kind, err)

    def tp_shape(kind, err):
        return case_shape(TP_LOCAL_CASE[0], kind, err)

    def widths(kind):
        """The head-width rows of ``kind``: every case of both tables
        whose D is not 32, 64 or 128, and the folded B * Hq; past D 256
        with the backend SDPA took (for dq and dk/dv: its backward's)."""
        table = rows if kind == "fwd" else bwd_rows
        errs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}[kind]
        pre = "" if kind == "fwd" else f"{kind}_"
        return {case: {**case_shape(case, kind, max(
            row[f"max_abs_err_{e}"] for e in errs)), "shape": row["shape"],
            "dtype": row["dtype"], "host_us": row[f"{pre}host_us"],
            **{k: row[k] for k in ("library_backend",) if k in row}}
            for case, row in table.items()
            if row["shape"]["D"] not in (32, 64, 128) or
            case.startswith("bhq")}
    tp_fwd, tp_bwd = rows[TP_LOCAL_CASE[0]], bwd_rows[TP_LOCAL_CASE[0]]

    def fp16(kind):
        """The fp16_kernels phase's rows of ``kind`` (and the wide
        forward's bf16 D 1024 row), each with its error, times, bound,
        host µs and, for the forward, SDPA's time and backend."""
        table = fp16_fwd if kind == "fwd" else fp16_bwd
        errs = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}[kind]
        pre = "" if kind == "fwd" else f"{kind}_"
        return {case: {
            "max_abs_err": max(row[f"max_abs_err_{e}"] for e in errs),
            "shape": row["shape"], "dtype": row["dtype"],
            **{k: row[f"{pre}{k}"] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "host_us")},
            "library_ms": row["library_ms"] if kind == "fwd" else None,
            **({"library_backend": row.get("library_backend")}
               if kind == "fwd" else {})}
            for case, row in table.items()}
    stream_src = "container_engine_accelerators_tpu_torch/ops/stream.py"
    bench_src = "container_engine_accelerators_tpu/collectives/device_bench.py:"

    def stream_entry(name, row, replaces):
        return {"name": name, "route": "triton", "source": stream_src,
                "replaces": bench_src + replaces,
                "launches": bench_launches[name],
                "launches_by_path": {"device_bench": bench_launches[name]},
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None,
                "shape": {"bytes": stream_rows["buffer_bytes"],
                          "dtype": stream_rows["dtype"]}}
    # No one PyTorch call computes dq alone or dk/dv alone (the library's
    # attention backward gives all three), so the two backward kernels
    # have no library_ms; "flash_bwd" beside the list holds the whole
    # backward (both kernels and delta) against the library's.
    emit({"kernels": [
        {
            "name": "flash_fwd", "route": "cuda",
            "source": src + "flash_fwd.cu",
            "replaces": replaces + "136",
            "launches": serve_launches + paged_launches + spec_launches
            + dense_launches + robust_launches + obs_launches
            + obs_int8_launches + handoff_launches + serve_tp_launches
            + moe_launches + serve_fp16_launches + sum(by_path(0).values()),
            "launches_by_path": {"serve": serve_launches,
                                 "serve_paged": paged_launches,
                                 "serve_spec": spec_launches,
                                 "serve_dense": dense_launches,
                                 "serve_robust": robust_launches,
                                 "serve_obs": obs_launches,
                                 "serve_obs_int8": obs_int8_launches,
                                 "serve_handoff": handoff_launches,
                                 "serve_tp": serve_tp_launches,
                                 "serve_moe": moe_launches,
                                 "serve_fp16": serve_fp16_launches,
                                 **by_path(0)},
            "max_abs_err": main_row["max_abs_err_out"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "ms_over_library": main_row["ms_over_library"],
            "host_us": main_row["host_us"],
            "shape": main_row["shape"],
            "bert_large": bert_shape("fwd", bert_fwd["max_abs_err_out"]),
            "long_context": long_shape("fwd", long_fwd["max_abs_err_out"]),
            "pipeline": pp_shape("fwd", pp_fwd["max_abs_err_out"]),
            "tp_local": tp_shape("fwd", tp_fwd["max_abs_err_out"]),
            "tp_serve": case_shape(TP_SERVE_CASE[0], "fwd",
                                   rows[TP_SERVE_CASE[0]]["max_abs_err_out"]),
            "tp_verify": {**case_shape(
                TP_VERIFY_CASE[0], "fwd",
                rows[TP_VERIFY_CASE[0]]["max_abs_err_out"]),
                "host_us": rows[TP_VERIFY_CASE[0]]["host_us"],
                "graph_ms": rows[TP_VERIFY_CASE[0]]["graph_ms"]},
            "head_widths": widths("fwd"),
            "float16": fp16("fwd"),
        },
        {
            "name": "flash_bwd_dq", "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": replaces + "203",
            "launches": sum(by_path(1).values()),
            "launches_by_path": by_path(1),
            "max_abs_err": bwd_row["max_abs_err_dq"],
            "ms": bwd_row["dq_ms"], "plain_ms": bwd_row["dq_plain_ms"],
            "bound_ms": bwd_row["dq_bound_ms"],
            "bound_by": bwd_row["dq_bound_by"],
            "library_ms": None,
            "host_us": bwd_row["dq_host_us"],
            "shape": bwd_row["shape"],
            "bert_large": bert_shape("dq", bert_bwd["max_abs_err_dq"]),
            "long_context": long_shape("dq", long_bwd["max_abs_err_dq"]),
            "pipeline": pp_shape("dq", pp_bwd["max_abs_err_dq"]),
            "tp_local": tp_shape("dq", tp_bwd["max_abs_err_dq"]),
            "head_widths": widths("dq"),
            "float16": fp16("dq"),
        },
        {
            "name": "flash_bwd_dkv", "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": replaces + "255",
            "launches": sum(by_path(2).values()),
            "launches_by_path": by_path(2),
            "max_abs_err": max(bwd_row["max_abs_err_dk"],
                               bwd_row["max_abs_err_dv"]),
            "ms": bwd_row["dkv_ms"], "plain_ms": bwd_row["dkv_plain_ms"],
            "bound_ms": bwd_row["dkv_bound_ms"],
            "bound_by": bwd_row["dkv_bound_by"],
            "library_ms": None,
            "host_us": bwd_row["dkv_host_us"],
            "shape": bwd_row["shape"],
            "bert_large": bert_shape("dkv", max(bert_bwd["max_abs_err_dk"],
                                                bert_bwd["max_abs_err_dv"])),
            "long_context": long_shape("dkv", max(
                long_bwd["max_abs_err_dk"], long_bwd["max_abs_err_dv"])),
            "pipeline": pp_shape("dkv", max(pp_bwd["max_abs_err_dk"],
                                            pp_bwd["max_abs_err_dv"])),
            "tp_local": tp_shape("dkv", max(tp_bwd["max_abs_err_dk"],
                                            tp_bwd["max_abs_err_dv"])),
            "head_widths": widths("dkv"),
            "float16": fp16("dkv"),
        },
        {
            "name": "int8_mm", "route": "cuda",
            "source": src + "int8_mm.cu",
            "replaces": "container_engine_accelerators_tpu/parallel/"
                        "overlap.py:100",
            "launches": sum(int8_launches.values()),
            "launches_by_path": int8_launches,
            "max_abs_err": int8_row["max_abs_err"],
            "ms": int8_row["ms"], "plain_ms": int8_row["plain_ms"],
            "bound_ms": int8_row["bound_ms"],
            "bound_by": int8_row["bound_by"],
            "library_ms": int8_row["library_ms"],
            "bf16_ms": int8_row["bf16_ms"],
            "int8pack_ms": int8_row["int8pack_ms"],
            "graph_ms": int8_row["graph_ms"],
            "host_us": int8_row["host_us"],
            "shape": int8_row["shape"],
            "tp_serve": {c[0]: {k: int8_rows[c[0]][k] for k in (
                "shape", "out_dtype", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "bf16_ms")}
                for c in TP_INT8_CASES},
            "float16": {name: {k: row[k] for k in (
                "shape", "out_dtype", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "f16_ms", "host_us")}
                for name, row in fp16_int8.items()},
        },
        stream_entry("stream_triad", stream_rows["stream_triad"], "234"),
        stream_entry("stream_read", stream_rows["stream_read"], "291"),
        stream_entry("stream_copy", stream_rows["stream_copy"], "309"),
    ], "flash_bwd": {
        "source": src + "flash_bwd.cu",
        "replaces": replaces + "771",
        "calls": sum(by_path(1).values()),
        "ms": bwd_row["bwd_ms"], "plain_ms": bwd_row["bwd_plain_ms"],
        "bound_ms": bwd_row["bwd_bound_ms"],
        "bound_by": bwd_row["bwd_bound_by"],
        "library_ms": bwd_row["library_ms"],
        "shape": bwd_row["shape"],
    }})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
