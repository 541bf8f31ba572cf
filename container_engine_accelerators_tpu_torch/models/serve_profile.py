# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Where the serving time goes on the card: a torch.profiler breakdown.

    python -m container_engine_accelerators_tpu_torch.models.serve_profile

Builds full-width Llama-3-8B (random weights, seed 0) on the GPU, warms
up, then profiles one bucketed prefill (a 1500-token prompt in the 2048
bucket) and, separately, 16 decode steps after it, run eagerly and then
as replays of the step's CUDA graph (``serving_graphs.DenseDecodeGraphs``,
the server's decode); then the paged engine's programs on block pools
sized for 8 slots (block 16): one 512-token prefill segment at offset
2560 (window 4096), and a 16-step decode chunk over 8 rows (7 at
position 1088, one at 3000), run eagerly and as 16 replays of the
window's graph (``serving_graphs.PagedDecodeGraphs``, the engine's
decode), and speculation's verify as replays of its graph
(``serving_graphs.PagedVerifyGraphs``, width 16, window 2048): 4 verifies
of one row at position 1088 and 4 of 8 rows at positions 1040-2000; then
the dense engine's decode chunk at the paged chunk's shape (16 steps, 8
rows, 7 at 1088 and one at 3000, window 4096) over a dense cache of 8
slots, run eagerly and as 16 replays of its graph
(``serving_graphs.DenseChunkGraphs``): the same step without the page
gather; the replayed chunk also with ``mask_writes``, and timed against
the unmasked one with CUDA events; then the same model from the same seed
quantized to int8 (``--quantize int8``): the prefill, the replayed
one-row decode and the replayed dense chunk again, each product the
W8A16 kernel (``int8_mm``). For
each region it prints one JSON line: host wall time, the
span on the card between CUDA events around it, summed device (kernel)
time, the device's idle share of the wall time, the ops with the most
device time and the device time by kind (the port's flash kernels, its
int8 product, matrix products, the rest). The profiler's own host overhead inflates
wall time, so the idle share is an upper bound; chip_smoke.py times the
same path unprofiled. Graphs are captured before their region.
"""

import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from container_engine_accelerators_tpu_torch.models import quantization
from container_engine_accelerators_tpu_torch.models import serving_graphs
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.ops import paged_attention as pa


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or \
        getattr(event, "self_cuda_time_total", 0)


# Kernel-name fragments by kind, for the grouped split: the port's flash
# kernels, cuBLAS/CUTLASS products, and everything else (elementwise,
# reductions, copies, the optimizer's foreach kernels).
_KINDS = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("int8_mm", ("int8_mm",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
)


def _kind(key):
    return next((kind for kind, frags in _KINDS
                 if any(f in key for f in frags)), "other")


def _profiled(name, fn, top):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side kernel events only: a host op's own device time, and the
    # device-side range the profiler annotates for it ("aten::mm" on the
    # CUDA timeline), repeat the time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    events.sort(key=_device_us, reverse=True)
    row = {
        "phase": name, "wall_ms": wall_ms,
        "event_span_ms": start.elapsed_time(end), "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
        "top": [{"op": e.key[:80], "device_ms": _device_us(e) / 1e3,
                 "calls": e.count} for e in events[:top]],
    }
    by_kind = row["by_kind"] = {}
    for e in events:
        kind = by_kind.setdefault(_kind(e.key), {"device_ms": 0.0,
                                                 "calls": 0})
        kind["device_ms"] += _device_us(e) / 1e3
        kind["calls"] += e.count
    print(json.dumps(row), flush=True)


def main(top=12, decode_steps=16, prompt_len=1500):
    device = tf.resolve_device("cuda")
    cfg = tf.TransformerConfig.llama3_8b()
    model = tf.init_params(cfg, device=device, seed=0)
    rng = _profile_serving(model, top, decode_steps, prompt_len)
    _profile_paged(model, rng, top, decode_steps)
    torch.cuda.empty_cache()
    _profile_dense_chunk(model, top, decode_steps)
    del model
    torch.cuda.empty_cache()
    model = quantization.quantize_params(
        tf.init_params(cfg, device=device, seed=0))
    _profile_serving(model, top, decode_steps, prompt_len, prefix="int8_")
    torch.cuda.empty_cache()
    _profile_dense_chunk(model, top, decode_steps, prefix="int8_",
                         eager=False)
    return 0


def _profile_serving(model, top, decode_steps, prompt_len, prefix=""):
    """The 1500-token prefill, then ``decode_steps`` decode steps after it
    (eagerly for the unprefixed model, then as replays of the step's
    graph). Returns the random generator the prompt was drawn from."""
    cfg, device = model.cfg, model.device
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, prompt_len)), device=device)
    bucket = tf._length_bucket(prompt_len, cfg.max_seq_len)
    padded = torch.nn.functional.pad(prompt, (0, bucket - prompt_len))
    decoder = serving_graphs.DenseDecodeGraphs(model)
    # Warm: the kernel build, and the capture of the window's graph.
    tf.generate(model, prompt, max_new_tokens=4, decoder=decoder)

    state = {}

    def run_prefill():
        state["tok"], state["cache"] = tf.prefill(model, padded,
                                                  true_len=prompt_len)

    def run_decode():
        tok = state["tok"]
        for step in range(decode_steps):
            logits = tf.decode_logits(model, state["cache"], tok,
                                      prompt_len + step)
            tok = logits.argmax(dim=-1)

    def run_graph_decode():
        tok = state["tok"]
        for step in range(decode_steps):
            tok = decoder.step(tok, prompt_len + step).argmax(dim=-1)

    _profiled(f"{prefix}prefill_p1500", run_prefill, top)
    if not prefix:
        _profiled(f"decode_{decode_steps}_steps", run_decode, top)
    tf.prefill(model, padded, true_len=prompt_len, cache=decoder.cache(1))
    run_graph_decode()  # unprofiled once (the warm generate captured it)
    _profiled(f"{prefix}decode_{decode_steps}_steps_graphed",
              run_graph_decode, top)
    return rng


def _profile_paged(model, rng, top, decode_steps, slots=8, block_size=16):
    """The paged engine's programs at serve_paged's shapes: slot b owns
    blocks [1 + b * T, 1 + (b + 1) * T), T blocks a context."""
    cfg, device = model.cfg, model.device
    per_seq = cfg.max_seq_len // block_size
    pools = pa.init_paged_kv_cache(
        cfg.n_layers, 1 + slots * per_seq, cfg.n_kv_heads, block_size,
        cfg.head_dim, cfg.torch_dtype, device)
    tables = 1 + torch.arange(slots * per_seq, device=device).view(slots, -1)
    last = torch.zeros(slots, dtype=torch.long, device=device)
    offset, seg_len, window = 2560, 512, 4096
    seg = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, seg_len)),
                          device=device)
    first = offset // block_size
    seg_ids = tables[slots - 1, first:first + seg_len // block_size]
    positions = torch.full((slots,), 1088, device=device)
    positions[-1] = 3000
    active = torch.ones(slots, dtype=torch.bool, device=device)

    def run_segment():
        tf.paged_prefill_segment(
            model, pools, seg, offset, seg_ids, tables[slots - 1],
            offset + seg_len - 1, last, slots - 1, window=window,
            block_size=block_size, want_logits=True)

    def run_chunk():
        tf.paged_decode_chunk(model, pools, tables, last, positions, active,
                              steps=decode_steps, window=window,
                              block_size=block_size)

    runner = serving_graphs.PagedDecodeGraphs(
        model, pools, last.clone(), tuple(tables.shape), decode_steps,
        block_size)
    host = [t.cpu().numpy() for t in (tables, positions, active)]

    def run_graph_chunk():
        runner(*host, decode_steps, window)

    for fn in (run_segment, run_chunk, run_graph_chunk):  # warm, capture
        fn()
    _profiled(f"paged_prefill_seg{seg_len}_at{offset}", run_segment, top)
    _profiled(f"paged_decode_{decode_steps}_steps_{slots}_rows", run_chunk,
              top)
    _profiled(f"paged_decode_{decode_steps}_steps_{slots}_rows_graphed",
              run_graph_chunk, top)
    del runner
    _profile_verify(model, pools, tables.cpu().numpy(), rng, top,
                    block_size)


def _profile_verify(model, pools, tables, rng, top, block_size, width=16,
                    window=2048, verifies=4):
    """Speculation's verify at its serving shape: the replays of one
    captured ``paged_verify_batch`` per batch size, over rows at decode
    positions (one row at 1088; 8 rows spread over 1040-2000)."""
    runner = serving_graphs.PagedVerifyGraphs(
        model, pools, width, tables.shape[1], block_size)
    for rows, poss in ((1, [1088]),
                       (8, np.linspace(1040, 2000, 8).astype(int))):
        poss = np.asarray(poss)
        segs = rng.integers(0, model.cfg.vocab_size, (rows, width))
        pos = poss[:, None] + np.arange(width)
        bids = np.take_along_axis(tables[:rows], pos // block_size, 1)
        args = (segs, poss, bids, pos % block_size, tables[:rows], window)
        runner(*args)  # capture, and one replay

        def run_verify():
            for _ in range(verifies):
                runner(*args)

        _profiled(f"verify_{verifies}x_b{rows}_w{window}_graphed",
                  run_verify, top)


def _profile_dense_chunk(model, top, decode_steps, slots=8, window=4096,
                         reps=5, prefix="", eager=True):
    """The dense engine's decode chunk at the paged chunk's shape: its
    cache of ``slots`` rows holds random K/V, row b at its position. The
    replayed chunk is profiled unmasked and, with ``eager``, also eagerly
    and with ``mask_writes``, the two replayed variants timed against
    each other unprofiled. ``prefix`` starts each region's name."""
    cfg, device = model.cfg, model.device
    gen = torch.Generator(device=device).manual_seed(1)
    cache = tf.init_kv_cache(cfg, slots, device)
    for buf in cache.values():
        buf.normal_(generator=gen)
    tokens = torch.zeros(slots, dtype=torch.long, device=device)
    positions = torch.full((slots,), 1088, device=device)
    positions[-1] = 3000
    active = torch.ones(slots, dtype=torch.bool, device=device)

    def run_chunk():
        tf.decode_chunk(model, cache, tokens, positions, active,
                        steps=decode_steps, window=window)

    runner = serving_graphs.DenseChunkGraphs(model, cache, slots,
                                             decode_steps)
    host = [t.cpu().numpy() for t in (tokens, positions, active)]

    def run_graph_chunk(mask_writes=False):
        runner(*host, decode_steps, window, mask_writes)

    name = f"{prefix}dense_decode_{decode_steps}_steps_{slots}_rows"
    for fn in (run_chunk, run_graph_chunk):  # warm, capture
        fn()
    if not eager:
        _profiled(f"{name}_graphed", run_graph_chunk, top)
        return
    run_graph_chunk(True)
    _profiled(name, run_chunk, top)
    _profiled(f"{name}_graphed", run_graph_chunk, top)
    _profiled(f"{name}_graphed_masked", lambda: run_graph_chunk(True), top)
    # The masked step against the unmasked one, unprofiled: replayed
    # chunks timed with CUDA events, in the order unmasked, masked,
    # masked, unmasked, ``reps`` chunks each.
    ms = {False: [], True: []}
    for mask in (False, True, True, False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run_graph_chunk(mask)
        end.record()
        torch.cuda.synchronize()
        ms[mask].append(start.elapsed_time(end) / (reps * decode_steps))
    print(json.dumps({"phase": f"dense_chunk_step_mask_ab_{slots}_rows_w"
                      f"{window}", "reps": reps, "steps": decode_steps,
                      "unmasked_step_ms": ms[False],
                      "masked_step_ms": ms[True]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
