#!/usr/bin/env python3
# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""On-card smoke test of the PyTorch/H100 port (needs one CUDA GPU).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, serves full-width
Llama-3-8B (all 32 layers, random weights from seed 0) through the
port's HTTP server, one request at a time, through the paged
continuous-batching engine (warmed with ``--warmup=all``: every decode
window's CUDA graph captured before ready), with speculative decoding
(``--speculate ngram|draft``: every batched verify the replay of its
graph, the flash kernel at per-row bases read from device memory),
through the dense continuous-batching engine (the default
``--kv-cache``) and the ``--batch-window-ms`` micro-batcher, under
overload and injected faults (bounded admission with typed 429s,
deadlines, tenant classes, step retries, drains, a client that hangs
up), serves it
again with int8 weights (``--quantize int8``: every projection the
hand-written W8A16 kernel, eagerly and inside the captured graphs), and
trains it at full width
(depth cut to 8 layers) through ``make_train_step``, checking that every
prefill, every prefill segment and every training step went through the
kernels, and that every decode chunk replayed its captured graph. Each
phase prints one JSON line; a failed phase raises and the script exits
non-zero before its last line, which is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.

Phases: env, build, kernel (forward, one line per case; the host-bound
shapes also timed as a CUDA graph of 20 launches; then the int8 product's
rows, ``int8_mm_*``, at Llama-3-8B's projections), bwd_kernel (backward,
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
decode chunks), spec_small_parity (a tiny f32 engine's tokens with
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
token within SERVE_LOGITS_ATOL of its teacher-forced argmax), serve_int8
(``--quantize int8`` on generate, the dense engine and the speculating
paged engine; every served token held to the int8 reference), train_grads
(loss and every gradient through the kernels vs plain attention), train
(5 timed steps), train_cli, kernels (the summary line), then the card's
name and power limit, then the result.
"""

import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import logging
import math
import re
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

# NVIDIA H100 SXM data sheet, dense: the bounds below are against these.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12   # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# Tolerances of the kernel against its plain version on the same inputs.
# bf16: the kernel and the plain version both round p and out to bf16
# (8 significant bits, relative step 2^-8), but round p at different
# running maxima (the kernel's per-tile max, the plain version's row
# max), so an output element may differ by about one bf16 step of its
# magnitude. f32: only the summation order differs.
TOL = {
    "bfloat16": {"out_atol": 1e-2, "out_rtol": 1e-2, "lse_atol": 1e-4},
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


# The int8 kernel against int8_mm_reference on the same operands. bf16:
# both sum exact int8 x bf16 products in f32 and round the scaled sum to
# bf16 once, so only the order of the f32 sums differs: an output may sit
# one bf16 step (2^-7 of its magnitude) apart, plus the f32
# summation-order noise (far under 1e-3 at K 14336 for outputs of about
# unit size). f32: summation order only.
INT8_TOL = {"bfloat16": {"rtol": 2.0 ** -7, "atol": 1e-3},
            "float32": {"rtol": 1e-5, "atol": 1e-5}}


def emit(obj):
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
    costs, each after its kernel's name and integer template arguments
    (``flash_bwd_dq_sm90_kernel<128>``, ``int8_mm_sm90_kernel<8,1,8,2>``):
    registers, spills, and any note that ptxas serialised the kernel's
    wgmma instructions, which costs most of their rate."""
    kernel, lines = "?", []
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '.*?((?:flash_(?:fwd|"
                          r"bwd)_(?:dq_|dkv_)?(?:sm90|f32)|int8_mm_(?:sm90|"
                          r"bf16|f32))_kernel)(\w*)'", line)
        if found:
            args = ",".join(re.findall(r"L[ib](\d+)E", found.group(2)))
            kernel = f"{found.group(1)}<{args}>"
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


def flash_bound(batch, num_q_heads, num_kv_heads, seq_q, seq_k, d, dtype,
                causal, q_base=0, k_base=0, kv_len=None, kind="fwd"):
    """(bound_ms, bound_by) of one flash call of ``kind`` (see WORK): the
    larger of FLOPs / peak and bytes / HBM rate. K and V are read only
    below kv_len and, when causal, up to the last query's diagonal.
    ``q_base`` may be a list of one per batch row (the device base): the
    rows' work and bytes are summed."""
    flops_per_d, q_like, k_like, rows = WORK[kind]
    elt = 2 if dtype == "bfloat16" else 4
    q_bases = q_base if isinstance(q_base, (list, tuple)) else \
        [q_base] * batch
    flops = nbytes = 0
    kv = seq_k if kv_len is None else max(0, min(kv_len, seq_k))
    for qb in q_bases:
        pairs = num_q_heads * attended_pairs(seq_q, seq_k, causal, qb,
                                             k_base, kv_len)
        flops += flops_per_d * d * pairs
        keys_read = max(0, min(kv, qb - k_base + seq_q)) if causal else kv
        nbytes += elt * d * (q_like * num_q_heads * seq_q + num_kv_heads
                             * (2 * keys_read + (k_like - 2) * seq_k))
        nbytes += 4 * rows * num_q_heads * seq_q
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
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
                  "paged_sq64_qb2000", "verify_b8_sq16", "draft_d32_sq512",
                  "dense_seg_sq512_qb2560")
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


# (name, batch, seq_q, seq_k, causal, q_base, k_base, kv_len, hq, hkv, d,
#  dtype). The first four are the Llama-3-8B prefill shapes (Hq 32, Hkv 8,
# D 128): the serve phase's prompts of 300 (batch 2) and 1500 tokens land
# in the 512 and 2048 buckets. "main" marks the shape the kernels line
# reports. A list of q_base (one per batch row) is passed as the device
# ``base`` tensor of [q_base, k_base, kv_len] rows, as the verify does.
KERNEL_CASES = [
    ("causal_512_b2", 2, 512, 512, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_2048", 1, 2048, 2048, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_8192", 1, 8192, 8192, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    # Past 8192 keys the JAX package switches to its streaming forward.
    ("causal_16384", 1, 16384, 16384, True, 0, 0, None, 32, 8, 128,
     "bfloat16"),
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
    row["library_ms"] = library_ms(
        q, k, v, torch, attention, causal=causal, sm_scale=d ** -0.5,
        q_base=mask_base, k_base=k_base, kv_len=kv_len)
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


def library_ms(q, k, v, torch, attention, *, causal, sm_scale, q_base,
               k_base, kv_len):
    """Time of PyTorch's scaled_dot_product_attention on the same inputs
    and mask, as a yardstick only (the port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = _sdpa_mask(q, k, attention, causal, q_base, k_base, kv_len)
    if kw is None:
        return None
    return time_ms(
        lambda: sdpa(q, k, v, scale=sm_scale, enable_gqa=True, **kw), torch
    )


def library_bwd_ms(q, k, v, g, torch, attention, *, causal, sm_scale,
                   q_base, k_base, kv_len):
    """Time of the backward of scaled_dot_product_attention (autograd on
    the same inputs and mask: dq, dk and dv together), a yardstick only."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = _sdpa_mask(q, k, attention, causal, q_base, k_base, kv_len)
    if kw is None:
        return None
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*qkv, scale=sm_scale, enable_gqa=True, **kw)
    return time_ms(
        lambda: torch.autograd.grad(out, qkv, g, retain_graph=True), torch
    )


# Backward cases, the same tuple as KERNEL_CASES. S 16384 takes the JAX
# package's streaming dq and dk/dv branches (and streaming forward);
# "causal_8192" is the train phase's shape, reported on the kernels line.
BWD_CASES = [
    ("causal_2048", 1, 2048, 2048, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_8192", 1, 8192, 8192, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_16384", 1, 16384, 16384, True, 0, 0, None, 32, 8, 128,
     "bfloat16"),
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
]
BWD_MAIN_CASE = "causal_8192"


def _rel_err(got, ref):
    """Largest |got - ref| over the largest |ref| (1 where ref is 0)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def grad_errors(got, ref):
    """(largest |got - ref|, ||got - ref|| / ||ref||, worst row) of one
    gradient. Rows lie along the last axis; the worst row is the largest
    ||got_r - ref_r|| / (||ref_r|| + m), m the median norm of the nonzero
    rows of ref: each row is held to its own scale, and a row whose
    gradient cancels to about 0 (a causal first query) to the typical
    one."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    rel_l2 = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    rows = ref.norm(dim=-1)
    nonzero = rows[rows > 0]
    typical = nonzero.median() if nonzero.numel() else rows.new_zeros(())
    worst = (diff.norm(dim=-1) / (rows + typical).clamp_min(1e-30)).max()
    return diff.abs().max().item(), rel_l2, worst.item()


def run_bwd_case(case, torch, attention, _ext, gen):
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
    row["library_ms"] = library_bwd_ms(q, k, v, g, torch, attention, **kw)
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
]
INT8_MAIN_CASE = "m8_w1"
# Rows whose back-to-back time may read the wrapper's host time: also
# timed as a CUDA graph of GRAPH_LAUNCHES launches, and held bit-equal to
# the eager launch when replayed.
INT8_GRAPH_CASES = ("m1_w1", "m8_wq", "m8_wk", "m8_w1", "m8_w2",
                    "m16_w1", "m128_w1", "m128_w2")
# Weight bytes one timed pass cycles through, so that a launch finds its
# weight in HBM (the 50 MB L2 cannot hold them), as the decode does: it
# streams 218 MB of layer matrices a layer.
COLD_BYTES = 120e6


def int8_bound(m, k, n):
    """(bound_ms, bound_by) of one W8A16 product: the larger of 2MKN over
    the bf16 peak and K·N (int8) + 4N (scale) + 2MK (x) + 2MN (y) bytes
    over the HBM rate."""
    t_ops = 2.0 * m * k * n / PEAK_BF16_FLOPS
    t_bytes = (k * n + 4 * n + 2 * m * k + 2 * m * n) / HBM_BYTES_PER_S
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
                  attention):
    """One int8_mm row: the kernel against the plain version (bf16, within
    INT8_TOL), then its time on weights cycled through more than the L2
    holds, beside the plain version, the unfused PyTorch composition
    (``library_ms``), cuBLAS on a bf16 weight of the same shape
    (``bf16_ms``) and ``torch._weight_int8pack_mm`` where this torch runs
    it on CUDA."""
    name, m, k, n = case
    dt = torch.bfloat16
    x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    copies = max(1, min(GRAPH_LAUNCHES, math.ceil(COLD_BYTES / (k * n))))
    qts, scales = [], []
    for _ in range(copies):
        qw = q8.quantize_weight(
            torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5)
        qts.append(qw["q"].T.contiguous())
        scales.append(qw["scale"])
        del qw
    got = int8_matmul.int8_mm(x, qts[0], scales[0])
    torch.cuda.synchronize()
    ref = int8_matmul.int8_mm_reference(x, qts[0], scales[0])
    tol = INT8_TOL["bfloat16"]
    err = (got.float() - ref.float()).abs()
    excess = (err - tol["atol"] - tol["rtol"] * ref.float().abs()).max()
    row = {"phase": "kernel", "case": f"int8_mm_{name}", "kernel": "int8_mm",
           "shape": {"M": m, "K": k, "N": n}, "dtype": "bfloat16",
           "weight_copies": copies, "max_abs_err": err.max().item(),
           "tol": tol}
    if not torch.isfinite(got.float()).all() or excess.item() > 0:
        emit(row)
        fail(f"int8 case {name} disagrees with int8_mm_reference")
    kernel = _cycling(lambda i: int8_matmul.int8_mm(x, qts[i], scales[i]),
                      copies)
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
        lambda: int8_matmul.int8_mm_reference(x, qts[0], scales[0]), torch,
        budget_ms=100.0)
    row["bound_ms"], row["bound_by"] = int8_bound(m, k, n)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["library_ms"] = time_ms(_cycling(
        lambda i: ((x @ qts[i].to(dt).T) * scales[i]).to(dt), copies), torch)
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
    row["bf16_ms"] = time_ms(_cycling(lambda i: x @ ws[i], bf16_copies),
                             torch)
    row["ms_over_bf16"] = row["ms"] / row["bf16_ms"]
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


def serve(torch, np, tf, serve_cli, attention, card):
    """Full-width Llama-3-8B behind the port's HTTP server. ``card``: the
    GPU's name and power limit, printed beside the times."""
    cfg = tf.TransformerConfig.llama3_8b()
    t0 = time.perf_counter()
    model = serve_cli.Model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
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
            "p1500_tokens": results["p1500_again"]["tokens"][0]}
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
    traffic, against the dense ``tf.forward`` on the same context.
    Returns the kernel's launches."""
    cfg = model.cfg
    vocab = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    engine = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512, kv_block_size=16,
        kv_cache="paged",
    )
    # Each prefill call: (offset, segment length, true_pos, chunks
    # dispatched before it); each final segment's (tokens, logits).
    segments, finals = [], []
    paged_prefill = engine._paged_prefill

    def prefill_keeping_logits(*args, want_logits=False, **kw):
        seg, off, true_pos = args[2], args[3], args[6]
        segments.append((off, seg.shape[1], true_pos, engine.n_chunks))
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
                                           warmup_mode="all")
    try:
        serve_cli.wait_ready(state, timeout=600)
        ready_s = time.perf_counter() - t0
        port = server.server_address[1]
        warm = state["warmup"]
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
            chunks = engine.n_chunks
            deadline = time.monotonic() + 600
            while engine.n_chunks == chunks:
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
    launches = attention.flash_fwd_launches
    other = attention.flash_dq_launches + attention.flash_dkv_launches
    stats, kvs = engine.stats(), engine.kv_stats()
    graph_stats = engine.graph_stats()
    engine.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name, prompt in prompts.items():
        _check_response(name, results[name], prompt, max_new[name], vocab)
    windows = warm["cache_hits"] + warm["cache_misses"]
    warm_segments = warm["tasks"] - windows
    n_windows = len(tf.serving_shape_buckets(cfg, engine.prefill_chunk,
                                             engine.chunk)["windows"])
    if warm["cache_misses"] != n_windows or \
            at_ready["graph_captures"] != n_windows:
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
        "graph_captures": graph_stats["graph_captures"],
        "graph_replays": graph_stats["graph_replays"],
        "graph_capture_s": graph_stats["graph_capture_s"],
        "graph_pool_gb": graph_stats["graph_pool_bytes"] / 1e9,
        "eager_chunks_on_cuda": graph_stats["eager_chunks_on_cuda"],
        "max_memory_allocated_gb": peak_gb,
    })
    return launches


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
            x, _ = layer(x, positions, attend)
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


def _served_gaps(torch, tf, model, prompts, got):
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
            logits = tf.forward(model.model,
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
    rng = np.random.default_rng(5)  # serve_paged's prompts
    prefix = rng.integers(0, vocab, 1024).tolist()
    prompts = {"prefix_1024": prefix}
    for i in range(6):
        prompts[f"shared_{i}"] = prefix + rng.integers(0, vocab, 64).tolist()
    prompts["long_3000"] = rng.integers(0, vocab, 3000).tolist()
    max_new = {name: 32 for name in prompts}
    max_new["prefix_1024"] = 8
    results, latency = {}, {}

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

        def post(name):
            t1 = time.perf_counter()
            results[name] = serve_cli.post_generate(
                port, [prompts[name]], max_new[name])
            latency[name] = time.perf_counter() - t1

        post("prefix_1024")
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(7) as pool:
            futures = [pool.submit(post, f"shared_{i}") for i in range(6)]
            n = engine.n_chunks
            deadline = time.monotonic() + 600
            while engine.n_chunks == n:
                if time.monotonic() > deadline:
                    fail("serve_dense: no decode chunk after the shared "
                         "requests were posted")
                time.sleep(0.002)
            futures.append(pool.submit(post, "long_3000"))
            for f in futures:
                f.result(timeout=600)
        burst_s = time.perf_counter() - t1
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
    if warm["cache_misses"] != n_graphs or \
            at_ready["graph_captures"] != n_graphs:
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
    held = _served_gaps(torch, tf, model,
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
        at_ready = (attention.flash_fwd_launches, batcher.n_batches)
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
          "coalesced_calls": calls, "last_batch_rows": batcher.batch_rows,
          "queue_wait_s": list(batcher.queue_wait_s)[-BATCH_REQUESTS:],
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


def _post_status(port, body, headers=None, timeout=600):
    """POST /generate: (HTTP status, decoded body), a 429 or 500
    included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
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

    ran = engine.n_chunks + engine.spec_verifies
    for seam in seams:
        real = getattr(engine, seam)

        def wrapped(*args, _real=real, **kwargs):
            if "targeted" not in out and \
                    engine.n_chunks + engine.spec_verifies > ran and \
                    decoding() == rows:
                out["targeted"] = engine.drain(reason="serve_robust")
            return _real(*args, **kwargs)

        setattr(engine, seam, wrapped)


def _robust_gaps(torch, tf, model, case, prompts, streams, refs):
    """Every served token of ``streams`` within SERVE_LOGITS_ATOL of the
    dense forward's top logit on its own context (``_served_gaps``), and
    the count of streams equal to their reference."""
    held = _served_gaps(torch, tf, model, prompts, streams)
    equal = sum(a == b for a, b in zip(streams, refs))
    if held["gaps_over_tol"]:
        fail(f"serve_robust {case}: {held['gaps_over_tol']} served tokens "
             f"lie {SERVE_LOGITS_ATOL} or more below the dense forward's "
             f"top logit: {held}")
    return {"served_tokens": held, "equal_streams": equal,
            "streams": len(streams), "tol": SERVE_LOGITS_ATOL}


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
                    # Held until every request queued or was shed.
                    deadline = time.monotonic() + 600
                    while dense._q.qsize() + int(
                            dense._m_shed.labels("class_share").value) < 12:
                        if time.monotonic() > deadline:
                            fail("serve_robust tenants: the burst did not "
                                 "land")
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
    rng = np.random.default_rng(5)  # serve_dense's prompts
    prefix = rng.integers(0, vocab, 1024).tolist()
    prompts = {"prefix_1024": prefix}
    for i in range(6):
        prompts[f"shared_{i}"] = prefix + rng.integers(0, vocab, 64).tolist()
    prompts["long_3000"] = rng.integers(0, vocab, 3000).tolist()
    max_new = {name: 32 for name in prompts}
    max_new["prefix_1024"] = 8
    results = {}

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

        def post(name):
            results[name] = serve_cli.post_generate(
                port, [prompts[name]], max_new[name])

        post("prefix_1024")
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(7) as pool:
            futures = [pool.submit(post, f"shared_{i}") for i in range(6)]
            n = engine.n_chunks
            deadline = time.monotonic() + 600
            while engine.n_chunks == n:
                if time.monotonic() > deadline:
                    fail("serve_int8: no decode chunk after the shared "
                         "requests were posted")
                time.sleep(0.002)
            futures.append(pool.submit(post, "long_3000"))
            for f in futures:
                f.result(timeout=600)
        burst_s = time.perf_counter() - t1
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
    cfg = tf.TransformerConfig.llama3_8b()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve_cli.Model(cfg, seed=0, device="cuda", quantize="int8")
    torch.cuda.synchronize()
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
    _free(torch)
    with plain_int8(int8_matmul):
        held = _served_gaps(
            torch, tf, model, [p1500] + dense_prompts + spec_prompts,
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
            "serve_int8_spec": spec_row["int8_mm_launches"]}


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


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
    worst_l2, worst_max, worst_name, bad = 0.0, 0.0, None, []
    for name, ref in grads_r.items():
        got = grads_k[name].float()
        ref = ref.float()
        rel_l2 = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        _, max_rel = _rel_err(got, ref)
        if not torch.isfinite(got).all() or \
                rel_l2 > TRAIN_GRAD_TOL["rel_l2"] or \
                max_rel > TRAIN_GRAD_TOL["max_rel"]:
            bad.append(name)
        if rel_l2 > worst_l2:
            worst_l2, worst_name = rel_l2, name
        worst_max = max(worst_max, max_rel)
    row = {
        "phase": "train_grads", "model": "llama3-8b", "n_layers": 2,
        "batch": 1, "seq_len": 2048, "dtype": "bfloat16",
        "loss_kernels": loss_k, "loss_plain": loss_r,
        "n_params_compared": len(grads_r), "worst_rel_l2": worst_l2,
        "worst_rel_l2_param": worst_name, "worst_max_rel": worst_max,
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from container_engine_accelerators_tpu_torch.models import quantization as q8
    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import serving_graphs
    from container_engine_accelerators_tpu_torch.models import train_cli
    from container_engine_accelerators_tpu_torch.models import transformer as tf
    from container_engine_accelerators_tpu_torch.ops import _ext, attention
    from container_engine_accelerators_tpu_torch.ops import int8_matmul

    # Plain versions compute in full f32 (no TF32), as the kernels do.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name, power = [s.strip() for s in smi.split(",", 1)]
    card = {"gpu": name, "power_limit": power}
    emit({"phase": "env", **card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _ext.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": i["seconds"],
                          "ptxas": ptxas_summary(i["ptxas"])}
                      for n, i in _ext.build_info.items()}})

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {c[0]: run_kernel_case(c, torch, attention, gen, serving_graphs)
            for c in KERNEL_CASES}
    bwd_rows = {c[0]: run_bwd_case(c, torch, attention, _ext, gen)
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
    del model
    int8_launches = serve_int8(torch, np, tf, serve_cli, attention,
                               int8_matmul, q8, card, bf16)
    _free(torch)
    train_grads(torch, np, tf, attention)
    _free(torch)
    fwd_train, dq_train, dkv_train = train(torch, np, tf, attention, card)
    _free(torch)
    train_cli_phase(train_cli)

    src = "container_engine_accelerators_tpu_torch/ops/csrc/"
    replaces = "container_engine_accelerators_tpu/ops/attention.py:"
    main_row, bwd_row = rows[MAIN_CASE], bwd_rows[BWD_MAIN_CASE]
    int8_row = int8_rows[INT8_MAIN_CASE]
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
            + dense_launches + robust_launches + fwd_train,
            "launches_by_path": {"serve": serve_launches,
                                 "serve_paged": paged_launches,
                                 "serve_spec": spec_launches,
                                 "serve_dense": dense_launches,
                                 "serve_robust": robust_launches,
                                 "train": fwd_train},
            "max_abs_err": main_row["max_abs_err_out"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "ms_over_library": main_row["ms_over_library"],
            "host_us": main_row["host_us"],
            "shape": main_row["shape"],
        },
        {
            "name": "flash_bwd_dq", "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": replaces + "203",
            "launches": dq_train,
            "max_abs_err": bwd_row["max_abs_err_dq"],
            "ms": bwd_row["dq_ms"], "plain_ms": bwd_row["dq_plain_ms"],
            "bound_ms": bwd_row["dq_bound_ms"],
            "bound_by": bwd_row["dq_bound_by"],
            "library_ms": None,
            "host_us": bwd_row["dq_host_us"],
            "shape": bwd_row["shape"],
        },
        {
            "name": "flash_bwd_dkv", "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": replaces + "255",
            "launches": dkv_train,
            "max_abs_err": max(bwd_row["max_abs_err_dk"],
                               bwd_row["max_abs_err_dv"]),
            "ms": bwd_row["dkv_ms"], "plain_ms": bwd_row["dkv_plain_ms"],
            "bound_ms": bwd_row["dkv_bound_ms"],
            "bound_by": bwd_row["dkv_bound_by"],
            "library_ms": None,
            "host_us": bwd_row["dkv_host_us"],
            "shape": bwd_row["shape"],
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
        },
    ], "flash_bwd": {
        "source": src + "flash_bwd.cu",
        "replaces": replaces + "771",
        "calls": dq_train,
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
