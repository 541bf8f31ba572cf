#!/usr/bin/env python3
# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""On-card smoke test of the PyTorch/H100 port (needs one CUDA GPU).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then serves
full-width Llama-3-8B (all 32 layers, random weights from seed 0)
through the port's HTTP server and checks that every prefill went
through the kernel. Each phase prints one JSON line; a failed phase
raises and the script exits non-zero before its last line, which is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

Phases: env, build, kernel (one line per case), small_parity (a tiny f32
model on the card against the same weights on the CPU), serve, serve_logits
(prefill logits through the kernel vs plain attention), kernels (the
summary line), then the card's name and power limit, then the result.
"""

import json
import subprocess
import sys
import time

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


def flash_bound(batch, num_q_heads, num_kv_heads, seq_q, seq_k, d, dtype,
                causal, q_base=0, k_base=0, kv_len=None):
    """(bound_ms, bound_by) of one flash forward: the larger of
    FLOPs / peak (4 * D per visible pair: QK^T and PV) and bytes / HBM
    rate (q, k, v read once, out and the f32 lse written once)."""
    elt = 2 if dtype == "bfloat16" else 4
    pairs = batch * num_q_heads * attended_pairs(
        seq_q, seq_k, causal, q_base, k_base, kv_len
    )
    flops = 4 * d * pairs
    nbytes = elt * d * (2 * batch * num_q_heads * seq_q
                        + 2 * batch * num_kv_heads * seq_k)
    nbytes += 4 * batch * num_q_heads * seq_q
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


# (name, batch, seq_q, seq_k, causal, q_base, k_base, kv_len, hq, hkv, d,
#  dtype). The first four are the Llama-3-8B prefill shapes (Hq 32, Hkv 8,
# D 128): the serve phase's prompts of 300 (batch 2) and 1500 tokens land
# in the 512 and 2048 buckets. "main" marks the shape the kernels line
# reports.
KERNEL_CASES = [
    ("causal_512_b2", 2, 512, 512, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_2048", 1, 2048, 2048, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("causal_8192", 1, 8192, 8192, True, 0, 0, None, 32, 8, 128, "bfloat16"),
    ("q_base_1536", 1, 512, 2048, True, 1536, 0, None, 32, 8, 128,
     "bfloat16"),
    ("noncausal_kv_len", 1, 300, 1000, False, 0, 0, 777, 32, 8, 128,
     "bfloat16"),
    ("future_keys", 1, 200, 200, True, 0, 150, None, 32, 8, 128, "bfloat16"),
    ("d64_unaligned", 2, 1000, 1000, True, 0, 0, None, 8, 2, 64, "bfloat16"),
    ("f32_q_base", 1, 100, 300, True, 250, 0, None, 8, 2, 128, "float32"),
    ("f32_d64_kv_len", 2, 77, 300, False, 0, 0, 250, 4, 1, 64, "float32"),
]
MAIN_CASE = "causal_2048"


def run_kernel_case(case, torch, attention, gen):
    (name, batch, seq_q, seq_k, causal, q_base, k_base, kv_len, hq, hkv, d,
     dtype) = case
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = rand(batch, hq, seq_q, d), rand(batch, hkv, seq_k, d), \
        rand(batch, hkv, seq_k, d)
    kw = dict(causal=causal, sm_scale=d ** -0.5, q_base=q_base,
              k_base=k_base, kv_len=kv_len)
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
    row["plain_ms"] = time_ms(
        lambda: attention.flash_fwd_reference(q, k, v, **kw), torch,
        budget_ms=100.0,
    )
    row["bound_ms"], row["bound_by"] = flash_bound(
        batch, hq, hkv, seq_q, seq_k, d, dtype, causal, q_base, k_base,
        kv_len,
    )
    row["library_ms"] = library_ms(q, k, v, torch, attention, **kw)
    emit(row)
    return row


def library_ms(q, k, v, torch, attention, *, causal, sm_scale, q_base,
               k_base, kv_len):
    """Time of PyTorch's scaled_dot_product_attention on the same inputs
    and mask, as a yardstick only (the port never calls it). None where
    some row sees no key: there it computes another function (NaN)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    seq_q, seq_k = q.shape[2], k.shape[2]
    vis = attention._visible(seq_q, seq_k, causal, q_base, k_base, kv_len,
                             q.device)
    if not vis.any(dim=1).all():
        return None
    if causal and q_base == k_base and seq_q == seq_k and kv_len is None:
        kw = {"is_causal": True}
    elif not causal and kv_len is None:
        kw = {}
    else:
        kw = {"attn_mask": vis}
    return time_ms(
        lambda: sdpa(q, k, v, scale=sm_scale, enable_gqa=True, **kw), torch
    )


def small_parity(torch, tf, attention):
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
    lg = tf.forward(gpu, prompt.cuda()).cpu()
    lc = tf.forward(cpu, prompt)
    tg = tf.generate(gpu, prompt.cuda(), max_new_tokens=8).cpu()
    tc = tf.generate(cpu, prompt, max_new_tokens=8)
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
    requests = [("p17", p17, 32), ("p300_b2", p300, 32),
                ("p1500", p1500, 32), ("p1500_ttft", p1500, 1),
                ("p17_again", p17, 32)]

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
    if results["p17"]["tokens"] != results["p17_again"]["tokens"]:
        fail("the same greedy request gave different tokens")
    ttft = results["p1500_ttft"]["latency_s"]
    decode_ms = (results["p1500"]["latency_s"] - ttft) / 31 * 1e3
    emit({
        "phase": "serve", **card, "model": "llama3-8b",
        "n_layers": cfg.n_layers,
        "init_s": init_s, "requests": len(requests),
        "flash_fwd_launches": launches,
        "launches_per_prefill": cfg.n_layers,
        "latency_s": {n: r["latency_s"] for n, r in results.items()},
        "ttft_s_p1500": ttft, "decode_ms_per_token_p1500": decode_ms,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    })

    toks = torch.as_tensor(p1500, device="cuda")
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
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import transformer as tf
    from container_engine_accelerators_tpu_torch.ops import _ext, attention

    # Plain versions compute in full f32 (no TF32), as the kernel does.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name, power = [s.strip() for s in smi.split(",", 1)]
    emit({"phase": "env", "gpu": name, "power_limit": power,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _ext.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": i["seconds"],
                          "ptxas": [ln.strip() for ln in i["ptxas"].splitlines()
                                    if "Used" in ln or "spill" in ln]}
                      for n, i in _ext.build_info.items()}})

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {c[0]: run_kernel_case(c, torch, attention, gen)
            for c in KERNEL_CASES}
    small_parity(torch, tf, attention)
    launches = serve(torch, np, tf, serve_cli, attention,
                     {"gpu": name, "power_limit": power})

    main_row = rows[MAIN_CASE]
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "container_engine_accelerators_tpu_torch/ops/csrc/"
                  "flash_fwd.cu",
        "replaces": "container_engine_accelerators_tpu/ops/attention.py:136",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err_out"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
