# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Time one checkout's flash kernels, to hold a change against its parent.

A kernel's time moves between cards and calls, so two commits are
compared on one card in one call, in turns: unpack the parent into a
directory the checkout's ``.gitignore`` lists (``git archive``), then run
this file on each tree, parent, change, change, parent:

    python3 container_engine_accelerators_tpu_torch/ops/flash_ab.py PARENT parent
    python3 container_engine_accelerators_tpu_torch/ops/flash_ab.py . change --wide
    python3 container_engine_accelerators_tpu_torch/ops/flash_ab.py . change --wide
    python3 container_engine_accelerators_tpu_torch/ops/flash_ab.py PARENT parent

Run by path, not ``-m``: the package is imported from the tree given,
which builds its own kernels into its own ``.torch_ext/``. Each run prints
one JSON line a shape, causal, in ``--dtype`` (bfloat16 by default;
float16 needs a tree whose kernels take it): the device ms (CUDA events,
a warm loop) of the forward, dq and dk/dv launches and the whole backward
(``flash_bwd``), then one line with the build seconds and the card's name
and power limit. The shapes: Llama-3-8B's heads at S 8192 and 2048, its
tp-4 rank (8 q heads over 2 KV heads, S 4096) and Gemma-2B's D 256 over one
KV head (S 4096); ``--wide`` adds the head widths past 256 (Gemma-2-2B's
and Gemma-3-1B's D 288 at S 4096, D 512 at S 2048, D 1024 at S 2048, the
widest the kernels take) with SDPA's forward and backward times beside
them. Needs a GPU.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# (name, (B, Hq, Hkv, S, D), what to time).
SHAPES = [
    ("causal_8192", (1, 32, 8, 8192, 128), ("fwd", "dq", "dkv")),
    ("causal_2048", (1, 32, 8, 2048, 128), ("fwd", "dq", "dkv", "bwd")),
    ("tp_local_s4096", (1, 8, 2, 4096, 128), ("dkv", "bwd")),
    ("gemma2b_d256_s4096", (1, 8, 1, 4096, 256), ("dq", "dkv", "bwd")),
]
WIDE_SHAPES = [
    ("gemma2_2b_d288_s4096", (1, 8, 4, 4096, 288),
     ("fwd", "dq", "dkv", "bwd", "sdpa")),
    ("gemma3_1b_d288_s4096", (1, 4, 1, 4096, 288),
     ("fwd", "dq", "dkv", "bwd", "sdpa")),
    ("d512_s2048", (1, 8, 8, 2048, 512), ("fwd", "dq", "dkv", "bwd", "sdpa")),
    ("d1024_s2048", (1, 4, 4, 2048, 1024), ("fwd", "sdpa")),
]


def time_ms(torch, fn, min_iters=5, budget_ms=400.0):
    """Mean device ms of fn() over a warm loop, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = max(min_iters, min(200, int(budget_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(torch, _ext, attention, shapes, label, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    for name, (batch, hq, hkv, seq, d), kinds in shapes:
        q, g = (torch.randn(batch, hq, seq, d, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn(batch, hkv, seq, d, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        kw = dict(causal=True, sm_scale=d ** -0.5)
        out, lse = attention.flash_fwd(q, k, v, **kw)
        delta = (out.float() * g.float()).sum(-1)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        ext = dict(kw, q_base=0, k_base=0, kv_len=seq)
        calls = {
            "fwd": lambda: attention.flash_fwd(q, k, v, **kw),
            "dq": lambda: _ext.flash_bwd_dq(q, k, v, g, lse, delta, dq,
                                            **ext),
            "dkv": lambda: _ext.flash_bwd_dkv(q, k, v, g, lse, delta, dk,
                                              dv, **ext),
            "bwd": lambda: attention.flash_bwd(q, k, v, out, lse, g, **kw),
        }
        row = {"label": label, "case": name, "dtype": dtype,
               **{f"{kind}_ms": time_ms(torch, calls[kind])
                  for kind in kinds if kind in calls}}
        if "sdpa" in kinds:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            o = sdpa(*qkv, is_causal=True, scale=kw["sm_scale"],
                     enable_gqa=True)
            row["sdpa_fwd_ms"] = time_ms(torch, lambda: sdpa(
                q, k, v, is_causal=True, scale=kw["sm_scale"],
                enable_gqa=True))
            row["sdpa_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                o, qkv, g, retain_graph=True))
        print(json.dumps(row), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("tree", help="the checkout whose kernels to time")
    parser.add_argument("label", help="a name for its lines (parent, ...)")
    parser.add_argument("--wide", action="store_true",
                        help="also the head widths past 256, with SDPA")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float16"])
    args = parser.parse_args()
    # The checkout's package, not this file's directory, comes first.
    sys.path[0] = str(Path(args.tree).resolve())
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from container_engine_accelerators_tpu_torch.ops import _ext, attention

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _ext.build()
    build_s = time.perf_counter() - t0
    run(torch, _ext, attention, SHAPES + (WIDE_SHAPES if args.wide else []),
        args.label, args.dtype)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"label": args.label, "build_s": build_s,
                      "card": smi.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
