# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Where the flash forward kernel's consumer warps spend their cycles.

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
waiting on the tensor cores. Needs a GPU; imports nothing of JAX.
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
