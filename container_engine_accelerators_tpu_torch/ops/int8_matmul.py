# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Weight-only int8 matrix product (W8A16): the CUDA kernel's wrapper and
its plain version.

Counterpart of the int8 branch of
``container_engine_accelerators_tpu/parallel/overlap.py:_chunk_mm``
(reached from ``transformer._mm``), and of nothing else of that module:

    y = ((x @ q) with f32 accumulation * scale).astype(out_dtype)

x (..., K) bf16, f16 or f32, q int8 (K, N), scale f32 (1, N): the
channel scale multiplies the f32 accumulator before the one cast, to x's
dtype by default; ``out_dtype=torch.float32`` with bf16 or f16 x keeps the
scaled accumulator unrounded (JAX's ``_chunk_mm(..., jnp.float32)``, the
tensor-parallel reduce-scatter's partial sums), on the same tensor-core
kernels. XLA fuses the
int8 convert into the matmul's operand read; in PyTorch
``(x @ q.to(x.dtype)) * scale`` would write and read a dequantized copy
of the weight on every call and round the product before the scale, so
the card runs a hand-written kernel (ops/csrc/int8_mm.cu).

The weight comes transposed here: ``qt`` (N, K), K contiguous, the
kernel's B operand layout (``quantization.Int8Weight`` keeps only that
copy). ``quantization.quantize_weight`` still returns JAX's (K, N) ``q``.

  int8_mm            CPU tensors go to ``int8_mm_reference``; CUDA
                     tensors launch the kernel (there is no fallback)
  int8_mm_reference  the plain version: (x.float() @ qt.float().T) *
                     scale, cast to ``out_dtype`` (x's by default)

``int8_mm_launches`` counts the calls that launch the kernel: not a call
that a CUDA graph captures (``int8_mm_captured`` counts those; the
graph's replays launch it, and their callers count them), nor one made
inside ``uncounted()`` (a capture's eager warm-up iterations,
``serving_graphs.GraphSet.capture``). So on an int8 path the launches
are 7 × layers × its eager forward calls, and each captured step
records 7 × layers.
"""

import contextlib
import threading

import torch

# Kernel launches made by int8_mm (CUDA tensors only), and the calls a
# CUDA graph captured instead (each replay of the graph launches them).
int8_mm_launches = 0
int8_mm_captured = 0
_local = threading.local()


@contextlib.contextmanager
def uncounted():
    """Launches made on this thread inside the block leave
    ``int8_mm_launches`` as it was (other threads count on)."""
    before = getattr(_local, "uncounted", False)
    _local.uncounted = True
    try:
        yield
    finally:
        _local.uncounted = before


def _check(x, qt, scale):
    if qt.dim() != 2 or qt.dtype != torch.int8:
        raise ValueError(f"qt must be an int8 (N, K) matrix, got {qt.dtype} "
                         f"{tuple(qt.shape)}")
    n, k = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"x's last dim {x.shape[-1]} != qt's K {k}")
    if scale.numel() != n or scale.dtype != torch.float32:
        raise ValueError(f"scale must hold {n} float32 values, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"x must be bfloat16, float16 or float32, got "
                         f"{x.dtype}")


def _out_dtype(x, out_dtype):
    out = x.dtype if out_dtype is None else out_dtype
    if out != x.dtype and out != torch.float32:
        raise ValueError(f"out_dtype must be x's dtype or float32, got "
                         f"{out_dtype}")
    return out


def int8_mm_reference(x, qt, scale, out_dtype=None):
    """Plain version of the kernel: the int8 weight and the activations in
    f32, one f32 product, the channel scale on it, one cast to
    ``out_dtype`` (default x's dtype)."""
    _check(x, qt, scale)
    out = _out_dtype(x, out_dtype)
    acc = torch.matmul(x.float(), qt.float().T)
    return (acc * scale.reshape(-1)).to(out)


def int8_mm(x, qt, scale, out_dtype=None):
    """y = ((x @ qt.T) in f32 * scale) in ``out_dtype`` (default x's
    dtype; float32 keeps the scaled accumulator unrounded), for x (..., K)
    and an int8 ``qt`` (N, K) with a float32 ``scale`` of N values. CPU
    tensors take the plain version; CUDA tensors launch the hand-written
    kernel (ops/csrc/int8_mm.cu), which raises on what it does not take:
    there is no fallback. The launch allocates its output (and any f32
    workspace the library asks for; none today) from PyTorch's allocator,
    reads nothing back to the host, and runs on the current stream, so it
    can be captured."""
    global int8_mm_launches, int8_mm_captured
    _check(x, qt, scale)
    out = _out_dtype(x, out_dtype)
    devices = {x.device.type, qt.device.type, scale.device.type}
    if devices == {"cpu"}:
        return int8_mm_reference(x, qt, scale, out)
    if devices != {"cuda"}:
        raise ValueError(f"x/qt/scale must all be on cpu or all on cuda, "
                         f"got {x.device}, {qt.device}, {scale.device}")
    from container_engine_accelerators_tpu_torch.ops import _ext

    n, k = qt.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    y = torch.empty(m, n, dtype=out, device=x.device)
    if m == 0 or n == 0:
        return y.view(*lead, n)
    if k == 0:
        return y.zero_().view(*lead, n)
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # the launch takes 16-byte aligned rows' base
    need = _ext.int8_mm_workspace_floats(x.dtype, m, n, k)
    workspace = torch.empty(need, dtype=torch.float32, device=x.device) \
        if need else None
    _ext.int8_mm(x2, qt, scale, y, workspace)
    if torch.cuda.is_current_stream_capturing():
        # The launch is recorded into a graph; its replays launch it, and
        # their callers count them.
        int8_mm_captured += 1
    elif not getattr(_local, "uncounted", False):
        int8_mm_launches += 1
    return y.view(*lead, n)
