# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""HBM streaming passes of the qualification rows: Triton kernels.

The JAX package's HBM rows (``collectives/device_bench.py``) run each step
of their loops as one XLA fusion, one pass over the buffer. Where no one
PyTorch call does a step well in one pass, the port has a kernel for it:

  triad                  z' = x + y·s + z·ε over bf16 or f32 buffers of one
                         length (``bench_hbm_bandwidth``'s triad, JAX
                         ``device_bench.py:234``): reads x, y and z once,
                         writes z' once, 4 × nbytes. ``out`` may be z.
                         No one ATen call computes it; ``addcmul`` then
                         ``add_`` moves 6 × nbytes and would be credited
                         with 4.
  triad_reference        its plain version
  stream_read            acc += Σ |x + b| in f32 over a bf16, f32 or int8
                         buffer (``bench_hbm_pattern_sweep``'s read, JAX
                         ``device_bench.py:291``): reads x once, 1 × nbytes.
                         ``torch.sum(x, dtype=float32)`` reads bf16 in one
                         pass but converts int8 to f32 first (a pass that
                         writes 4 × nbytes), and has no |x + b|.
  stream_read_reference  its plain version
  stream_copy            out = x·c + src[0]·ε over bf16 or f32, or
                         x + k + src[0] over int8, wrapping
                         (``bench_hbm_pattern_sweep``'s copy, JAX
                         ``device_bench.py:309``): reads x once, writes out
                         once, 2 × nbytes, with the one element of src read
                         by every program. ``addcmul`` does it in one pass
                         too, but through ATen's broadcast of the
                         one-element term it read 0.49 of the HBM rate in
                         bf16 and 0.29 in int8 on an H100 (PERF.md).
  stream_copy_reference  its plain version

All bound by bytes on an H100 (3.35 TB/s: 1.28 ms for the triad over
1 GiB, 0.32 ms for a 1 GiB read, 0.64 ms for a 1 GiB copy): a kernel has
only to keep enough loads in flight. The triad and the copy are one
program per ``TRIAD_BLOCK`` elements, 16-byte loads; the read is a
persistent grid (``READ_PROGRAMS_PER_SM`` programs an SM) whose programs
stride over the buffer, sum into a register vector, and add their total
to ``acc`` with one atomic each. The arithmetic runs in f32 (int8: int32)
in the order the plain versions use, and the triad and the copy are
compiled without fused multiply-adds, so the kernels round as their
plain versions do. Triton is imported at the first launch, and CPU
tensors take the plain versions (there is no fallback: a CUDA tensor
launches the kernel or raises). ``stream_triad_launches``,
``stream_read_launches`` and ``stream_copy_launches`` count the launches.
While a persistent compile cache is armed (``warmstart/cache.py``), each
launch that compiles a specialisation counts a hit or a miss of it
(``cache.count_triton``).
"""

import functools

import torch

from container_engine_accelerators_tpu_torch.warmstart import cache as ws_cache

TRIAD_BLOCK = 4096
READ_BLOCK = 4096
READ_PROGRAMS_PER_SM = 8
# Offsets are 32-bit in the kernels.
MAX_ELEMENTS = 2 ** 31 - 2 * max(TRIAD_BLOCK, READ_BLOCK)

stream_triad_launches = 0
stream_read_launches = 0
stream_copy_launches = 0

# triton.language, bound by _kernels() at the first launch: the kernels'
# bodies name it as a module global, where Triton looks names up.
tl = None


@functools.cache
def _kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def triad_kernel(x_ptr, y_ptr, z_ptr, out_ptr, s, eps, n,
                     BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
        y = tl.load(y_ptr + offs, mask=mask).to(tl.float32)
        z = tl.load(z_ptr + offs, mask=mask).to(tl.float32)
        out = x + y * s + z * eps
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def read_kernel(x_ptr, acc_ptr, bias, n, BLOCK: tl.constexpr):
        part = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(tl.program_id(0) * BLOCK, n,
                           tl.num_programs(0) * BLOCK):
            offs = start + tl.arange(0, BLOCK)
            mask = offs < n
            x = tl.load(x_ptr + offs, mask=mask, other=0).to(tl.float32)
            part += tl.where(mask, tl.abs(x + bias), 0.0)
        tl.atomic_add(acc_ptr, tl.sum(part, axis=0))

    @triton.jit
    def copy_kernel(x_ptr, src_ptr, out_ptr, c, eps, k, n,
                    BLOCK: tl.constexpr, INT8: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        s0 = tl.load(src_ptr)
        if INT8:
            x = tl.load(x_ptr + offs, mask=mask).to(tl.int32)
            out = x + (k + s0.to(tl.int32))
        else:
            x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
            # src[0]·ε rounded to the buffer's dtype, as the plain version
            # (and JAX's z[:1] * ε in that dtype) rounds it.
            t = (s0.to(tl.float32) * eps).to(out_ptr.dtype.element_ty)
            out = x * c + t.to(tl.float32)
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    return triton, triad_kernel, read_kernel, copy_kernel


def _specialisations(kernel):
    """Specialisations of one ``@triton.jit`` kernel compiled in this
    process: its in-memory cache, ``device_caches`` (device -> a tuple
    whose first item maps keys to compiled kernels) in Triton 3.2 and
    later, ``cache`` (device -> dict) before. Raises on a Triton that
    keeps neither."""
    caches = getattr(kernel, "device_caches", None)
    if caches is not None:
        return sum(len(entry[0]) for entry in caches.values())
    cache = getattr(kernel, "cache", None)
    if isinstance(cache, dict):
        return sum(len(per_device) for per_device in cache.values())
    raise RuntimeError(
        f"cannot read the compiled specialisations of {kernel!r}: this "
        f"Triton keeps neither device_caches nor cache")


def compiled_specialisations():
    """Specialisations of the stream kernels compiled in this process (0
    before the first launch)."""
    if _kernels.cache_info().currsize == 0:
        return 0
    return sum(_specialisations(k) for k in _kernels()[1:])


def _launch(kernel, grid, *args, **kwargs):
    """``kernel[grid](*args, **kwargs)``, counted against an armed
    compile cache (a free ``is None`` check when none is)."""
    return ws_cache.count_triton(
        lambda: _specialisations(kernel),
        lambda: kernel[grid](*args, **kwargs))


def _check_buffer(name, t, dtypes):
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.numel() > MAX_ELEMENTS:
        raise ValueError(f"{name} holds {t.numel()} elements, more than "
                         f"the kernels' 32-bit offsets take "
                         f"({MAX_ELEMENTS})")


def _devices(*tensors):
    devices = {t.device.type for t in tensors}
    if len(devices) != 1 or devices - {"cpu", "cuda"}:
        raise ValueError(f"tensors must all be on cpu or all on cuda, got "
                         f"{[str(t.device) for t in tensors]}")
    return devices.pop()


def triad_reference(x, y, z, s, eps):
    """x + y·s + z·ε in f32, rounded once to x's dtype."""
    return (x.float() + y.float() * s + z.float() * eps).to(x.dtype)


def triad(x, y, z, s, eps, out):
    """out = x + y·s + z·ε, for 1-D bf16 or f32 tensors of one length and
    dtype and Python floats ``s``, ``eps``; ``out`` may be ``z`` (each
    element is read before it is written). Returns ``out``."""
    global stream_triad_launches
    for name, t in (("x", x), ("y", y), ("z", z), ("out", out)):
        _check_buffer(name, t, (torch.bfloat16, torch.float32))
    if len({t.dtype for t in (x, y, z, out)}) != 1 or \
            len({t.numel() for t in (x, y, z, out)}) != 1:
        raise ValueError("x, y, z and out must share dtype and length")
    if _devices(x, y, z, out) == "cpu":
        return out.copy_(triad_reference(x, y, z, s, eps))
    triton, kernel, _, _ = _kernels()
    n = x.numel()
    _launch(kernel, (triton.cdiv(n, TRIAD_BLOCK),),
            x, y, z, out, float(s), float(eps), n, BLOCK=TRIAD_BLOCK,
            num_warps=8, enable_fp_fusion=False)
    stream_triad_launches += 1
    return out


def stream_read_reference(x, bias):
    """Σ |x + bias| over x in f32 (a 0-d f32 tensor)."""
    return torch.abs(x.float() + bias).sum()


def stream_read(x, acc, bias):
    """acc += Σ |x + bias| in f32 over a 1-D bf16, f32 or int8 ``x``;
    ``acc`` is a one-element f32 tensor on x's device, updated in place
    (on CUDA by the programs' atomic adds, so the order of the f32 sum
    varies from launch to launch). Returns ``acc``."""
    global stream_read_launches
    _check_buffer("x", x, (torch.bfloat16, torch.float32, torch.int8))
    if acc.numel() != 1 or acc.dtype != torch.float32:
        raise ValueError("acc must be a one-element float32 tensor")
    if _devices(x, acc) == "cpu":
        return acc.add_(stream_read_reference(x, bias))
    triton, _, kernel, _ = _kernels()
    n = x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = max(1, min(triton.cdiv(n, READ_BLOCK), sms * READ_PROGRAMS_PER_SM))
    _launch(kernel, (grid,), x, acc, float(bias), n, BLOCK=READ_BLOCK,
            num_warps=8)
    stream_read_launches += 1
    return acc


def stream_copy_reference(x, src, c=1.0, eps=0.0, k=0):
    """x·c + src[0]·ε (src[0]·ε rounded to x's dtype, the sum in f32,
    rounded once) for bf16 or f32 x; x + k + src[0], wrapping, for int8."""
    if x.dtype == torch.int8:
        return x + (src[:1] + k)
    return (x.float() * c + (src[:1] * eps).float()).to(x.dtype)


def stream_copy(x, src, out, c=1.0, eps=0.0, k=0):
    """out = x·c + src[0]·ε over 1-D bf16 or f32 tensors, or x + k +
    src[0] (wrapping) over int8 ones, with Python numbers ``c``, ``eps``
    (float dtypes) and ``k`` (int8, in [-128, 127]); x, src and out share
    dtype and length, and out must not hold src[0] (every program reads
    it). Returns ``out``."""
    global stream_copy_launches
    dtypes = (torch.bfloat16, torch.float32, torch.int8)
    for name, t in (("x", x), ("src", src), ("out", out)):
        _check_buffer(name, t, dtypes)
    if len({t.dtype for t in (x, src, out)}) != 1 or \
            len({t.numel() for t in (x, src, out)}) != 1:
        raise ValueError("x, src and out must share dtype and length")
    if out.data_ptr() <= src.data_ptr() < out.data_ptr() + out.nbytes:
        raise ValueError("out must not hold src[0]")
    int8 = x.dtype == torch.int8
    if int8 and not -128 <= k <= 127:
        raise ValueError(f"k must be an int8 value, got {k}")
    if _devices(x, src, out) == "cpu":
        return out.copy_(stream_copy_reference(x, src, c, eps, k))
    triton, _, _, kernel = _kernels()
    n = x.numel()
    _launch(kernel, (triton.cdiv(n, TRIAD_BLOCK),),
            x, src, out, float(c), float(eps), int(k), n, BLOCK=TRIAD_BLOCK,
            INT8=int8, num_warps=8, enable_fp_fusion=False)
    stream_copy_launches += 1
    return out
