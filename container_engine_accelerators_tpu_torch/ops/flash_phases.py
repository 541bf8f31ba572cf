# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Where the flash kernels' consumer warps spend their cycles.

    python -m container_engine_accelerators_tpu_torch.ops.flash_phases

Builds ops/csrc/flash_fwd.cu a second time with FLASH_FWD_PHASE_CLOCKS,
where each consumer warp adds the clock64 cycles it spends in each phase
(waiting for Q, for a K tile, for a V tile; Q·Kᵀ issued and waited; the
softmax; P·V issued and waited, with the stage's release; the epilogue) to
a grid-wide total. Runs the bf16 kernel at the Llama-3-8B prefill and
training shapes and prints one JSON line per shape: each phase's share of
the consumer warps' cycles, its mean cycles per warp and K/V tile, and the
instrumented and plain kernels' device times (the clock reads cost a
little). A consumer warpgroup's two products of a tile are 4.2 MFLOP,
1024 cycles of the SM's tensor cores at the dense bf16 rate (4096 FLOP a
cycle, 989 TFLOP/s over 132 SMs at 1.83 GHz), 512 for each product; with
two consumers sharing them, a warp that waits longer in `qk` and `pv` is
waiting on the tensor cores.

Then builds ops/csrc/flash_bwd.cu with FLASH_BWD_PHASE_CLOCKS and does the
same for both backward kernels at the training shapes (S 2048 and 8192),
one line per kernel and shape, per warp and streamed tile (a K/V tile of
the dq kernel, a (q head, q tile) pair of the dk/dv kernel): waiting for
the resident operand and each streamed tile (`wait`), the S and dP
products issued and waited (`scores`), the p and ds step (`p_ds`), the
dQ or dV and dK products issued and waited with the stage's release
(`grads`), and the epilogue. A consumer's products of a tile are 64 × 64
× D × 2 FLOP each (dq: three, dk/dv: four), 256 cycles each at D 128 at
the SM's dense rate, shared by two consumers. The instrumented build also
counts the streamed tiles the consumer warps walk, and the script fails
unless that count is what ``dq_tiles_visited`` and ``dkv_tiles_visited``
say each kernel walks.
Needs a GPU; imports nothing of JAX.
"""

import ctypes
import json
import subprocess
import sys

import torch

from container_engine_accelerators_tpu_torch.ops import _ext

DEFINES = ("FLASH_FWD_PHASE_CLOCKS",)
PHASES = ("wait_q", "wait_k", "qk", "softmax", "wait_v", "pv", "epilogue")
# (name, batch, seq, causal) at Hq 32, Hkv 8, D 128: the 2048 prefill
# bucket, the training length, and a non-causal shape without masks.
SHAPES = (("causal_2048", 1, 2048, True), ("causal_8192", 1, 8192, True),
          ("noncausal_4096", 1, 4096, False))
HQ, HKV, D = 32, 8, 128
BLOCK = 128  # the kernel's q rows per block and keys per K/V tile
CONSUMER_WARPS = 8


# The backward: dk/dv blocks hold 128 keys and stream 64-row q tiles of
# each q head of the GQA group; dq blocks hold 128 q rows and stream
# 64-key K/V tiles.
BWD_DEFINES = ("FLASH_BWD_PHASE_CLOCKS",)
BWD_PHASES = ("wait", "scores", "p_ds", "grads", "epilogue")
BWD_SHAPES = (("causal_2048", 1, 2048), ("causal_8192", 1, 8192))
DKV_KEYS, DKV_Q_TILE = 128, 64
DQ_ROWS, DQ_KEY_TILE = 128, 64


def dkv_tiles_visited(seq_q, seq_k, group, causal, q_base=0, k_base=0,
                      kv_len=None):
    """(q head, q tile) pairs the dk/dv kernel's blocks of one (batch, KV
    head) walk: for each 128-key block below kv_len, the group's q heads
    times the 64-row q tiles from the first with a row that sees the
    block's first key (global positions) on."""
    kv_len = seq_k if kv_len is None else kv_len
    n_qt = -(-seq_q // DKV_Q_TILE)
    total = 0
    for k0 in range(0, seq_k, DKV_KEYS):
        if k0 >= kv_len:
            continue
        first = max(0, k_base + k0 - q_base) // DKV_Q_TILE if causal else 0
        total += group * max(0, n_qt - first)
    return total


def dq_tiles_visited(seq_q, seq_k, causal, q_base=0, k_base=0, kv_len=None):
    """64-key K/V tiles the dq kernel's blocks of one (batch, q head)
    walk: up to the causal diagonal of each 128-row block's last row."""
    kv_len = seq_k if kv_len is None else kv_len
    total = 0
    for q0 in range(0, seq_q, DQ_ROWS):
        n_cols = kv_len
        if causal:
            q_last = q_base + min(q0 + DQ_ROWS, seq_q) - 1
            n_cols = max(0, min(kv_len, q_last - k_base + 1))
        total += -(-n_cols // DQ_KEY_TILE)
    return total


def tiles_visited(seq, causal):
    """K/V tiles the kernel's blocks walk for one (batch, head), Sq = Sk."""
    n_q = -(-seq // BLOCK)
    if not causal:
        return n_q * n_q
    return sum(-(-min(seq, (i + 1) * BLOCK) // BLOCK) for i in range(n_q))


def device_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bwd_phases(card, gen):
    """One JSON line per backward kernel and shape (see the docstring)."""
    lib = _ext._flash_bwd_lib(BWD_DEFINES)
    lib.flash_bwd_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.flash_bwd_phase_cycles.restype = ctypes.c_int
    # Per kernel: the phases' cycles, then the streamed tiles walked.
    per_kernel = len(BWD_PHASES) + 1
    cycles = (ctypes.c_ulonglong * (2 * per_kernel))()

    def read_cycles():
        err = lib.flash_bwd_phase_cycles(cycles)
        if err:
            raise RuntimeError(f"flash_bwd_phase_cycles failed ({err})")
        return {"dq": list(cycles[:per_kernel]),
                "dkv": list(cycles[per_kernel:])}

    for name, batch, seq in BWD_SHAPES:
        args, kw = _bwd_inputs(gen, batch, seq)
        dq, dk, dv = (torch.empty_like(t) for t in args[:3])
        calls = {
            "dq": lambda defines: _ext.flash_bwd_dq(
                *args, dq, defines=defines, **kw),
            "dkv": lambda defines: _ext.flash_bwd_dkv(
                *args, dk, dv, defines=defines, **kw),
        }
        tiles = {"dq": batch * HQ * dq_tiles_visited(seq, seq, True),
                 "dkv": batch * HKV * dkv_tiles_visited(
                     seq, seq, HQ // HKV, True)}
        for kernel, call in calls.items():
            call(BWD_DEFINES)
            torch.cuda.synchronize()
            read_cycles()  # zero the totals
            call(BWD_DEFINES)
            torch.cuda.synchronize()
            *per_phase, walked = read_cycles()[kernel]
            warp_tiles = tiles[kernel] * CONSUMER_WARPS
            if walked != warp_tiles:
                raise RuntimeError(
                    f"flash_bwd_{kernel} at {name}: the consumer warps walked "
                    f"{walked} streamed tiles, the model says {warp_tiles}")
            total = sum(per_phase)
            print(json.dumps({
                "kernel": f"flash_bwd_{kernel}",
                "shape": {"name": name, "B": batch, "Hq": HQ, "Hkv": HKV,
                          "S": seq, "D": D, "causal": True},
                "card": card,
                "streamed_tiles": tiles[kernel],
                "share": {p: c / total
                          for p, c in zip(BWD_PHASES, per_phase)},
                "cycles_per_warp_tile": {
                    p: c / warp_tiles
                    for p, c in zip(BWD_PHASES, per_phase)},
                "instrumented_ms": device_ms(lambda: call(BWD_DEFINES)),
                "ms": device_ms(lambda: call(())),
            }), flush=True)


def _bwd_inputs(gen, batch, seq):
    """q, k, v, dO, lse, delta and the causal keywords at one shape."""
    q, k, v, g = (torch.randn(batch, h, seq, D, generator=gen,
                              device="cuda").bfloat16()
                  for h in (HQ, HKV, HKV, HQ))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
    kw = dict(causal=True, sm_scale=D ** -0.5, q_base=0, k_base=0,
              kv_len=seq)
    _ext.flash_fwd(q, k, v, out, lse, **kw)
    delta = (out.float() * g.float()).sum(dim=-1)
    return (q, k, v, g, lse, delta), kw


def main():
    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    lib = _ext._flash_lib(DEFINES)
    lib.flash_fwd_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.flash_fwd_phase_cycles.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * len(PHASES))()

    def read_cycles():
        err = lib.flash_fwd_phase_cycles(cycles)
        if err:
            raise RuntimeError(f"flash_fwd_phase_cycles failed ({err})")
        return list(cycles)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, batch, seq, causal in SHAPES:
        q, k, v = (torch.randn(batch, h, seq, D, generator=gen,
                               device="cuda").bfloat16()
                   for h in (HQ, HKV, HKV))
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")

        def call(defines):
            _ext.flash_fwd(q, k, v, out, lse, causal=causal,
                           sm_scale=D ** -0.5, q_base=0, k_base=0,
                           kv_len=seq, defines=defines)

        call(DEFINES)
        torch.cuda.synchronize()
        read_cycles()  # zero the totals
        call(DEFINES)
        torch.cuda.synchronize()
        per_phase = read_cycles()
        total = sum(per_phase)
        warp_tiles = batch * HQ * tiles_visited(seq, causal) * CONSUMER_WARPS
        print(json.dumps({
            "shape": {"name": name, "B": batch, "Hq": HQ, "Hkv": HKV,
                      "S": seq, "D": D, "causal": causal},
            "card": card,
            "share": {p: c / total for p, c in zip(PHASES, per_phase)},
            "cycles_per_warp_tile": {p: c / warp_tiles
                                     for p, c in zip(PHASES, per_phase)},
            "instrumented_ms": device_ms(lambda: call(DEFINES)),
            "ms": device_ms(lambda: call(())),
        }), flush=True)
    bwd_phases(card, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
