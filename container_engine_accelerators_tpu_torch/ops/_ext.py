# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries land in
``.torch_ext/`` at the checkout root, or under the persistent compile
cache once one is configured (``warmstart/cache.py``,
``--compile-cache-dir``: :func:`set_build_dir`), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. While a
compile cache is armed, :func:`build` records a hit for each library it
finds and a miss for each ``nvcc`` it runs. A build with extra
preprocessor ``defines`` (an instrumented variant) is a library of its
own. Nothing here runs at import time: the first kernel call builds.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from container_engine_accelerators_tpu_torch.warmstart import cache as ws_cache

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
# Where libraries are built and looked up (set_build_dir).
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_fwd", "flash_bwd", "int8_mm")

# name -> {"seconds": build wall time (0.0 when reused), "ptxas": the
# assembler's register/shared-memory report, "path": the library}.
build_info = {}

_lock = threading.Lock()
_libs = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from source on first use"
        )
    return path


def set_build_dir(path):
    """Build and look up libraries under ``path`` from now on (None: the
    default ``.torch_ext/``). A library this process already loaded stays
    loaded from where it was built."""
    global BUILD_DIR
    BUILD_DIR = DEFAULT_BUILD_DIR if path is None else Path(path)


def _flags(defines):
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _library_path(name, defines=()):
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(f"\0{path.name}\0".encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES, defines=()):
    """Compile every source in ``names`` that has no library yet (with
    ``-D`` of each of ``defines``), one ``nvcc`` per source, all started
    together. Raises with the compiler's output if any fails. With a
    compile cache armed, each library found counts a hit and each nvcc
    run a miss. Processes building one library into a shared directory
    each write a temporary file of their own and rename it into place."""
    cache = ws_cache.active()
    pending = {}
    for name in names:
        path = _library_path(name, defines)
        key = name if not defines else f"{name}{list(defines)}"
        if path.exists():
            if cache is not None:
                cache.record_hit()
            build_info.setdefault(
                key, {"seconds": 0.0, "ptxas": "", "path": str(path)}
            )
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        if cache is not None:
            cache.record_miss()
        pending[key] = (proc, tmp, path, time.perf_counter())
    failed = []
    for key, (proc, tmp, path, t0) in pending.items():
        output, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {key}:\n{output}")
            continue
        os.replace(tmp, path)
        build_info[key] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": output,
            "path": str(path),
        }
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name, defines=()):
    """The ctypes handle of ``csrc/<name>.cu`` (built with ``defines``),
    built on first use."""
    with _lock:
        if (name, defines) not in _libs:
            build((name,), defines)
            _libs[name, defines] = ctypes.CDLL(
                str(_library_path(name, defines)))
        return _libs[name, defines]


def _flash_lib(defines=()):
    lib = load("flash_fwd", defines)
    if lib.flash_fwd_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [i32]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib.flash_fwd_launch.restype = i32
        # Set last: other threads take a non-None argtypes as "typed".
        lib.flash_fwd_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr,            # q, k, v, out, lse
            i32,                                # dtype: _DTYPE_CODE
            i32, i32, i32, i32, i32, i32,       # B, Hq, Hkv, Sq, Sk, D
            i32, ctypes.c_float,                # causal, sm_scale
            i32, i32, i32,                      # q_base, k_base, kv_len
            ptr,                                # base (B, 3) int32 or NULL
            ptr,                                # cudaStream_t
        ]
    return lib


# The launches' dtype codes (csrc/launch.cuh kDtype*): bf16 and f16 run the
# tensor-core kernels (one set, templated on the 16-bit element type), f32
# the check kernels.
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# int8_mm_launch's codes for a 16-bit x with an f32 y.
_INT8_TO_F32 = {torch.bfloat16: 3, torch.float16: 4}
# The head dims the flash kernels are built for (csrc/flash_fwd.cu,
# flash_bwd.cu); past the widest (wgmma's N stops at 256, and a wider
# accumulator would pass the register file) the wide kernels cut the
# outputs' columns into chunks of 64-column atoms (column_chunks).
FLASH_WIDTHS = (32, 64, 128, 256)
# The widest head dim the kernels take (csrc/launch.cuh kMaxHeadDim): the
# f32 check kernels hold a lane's columns of a row in registers.
MAX_HEAD_DIM = 1024
ATOM_COLS = 64
# Atoms of the outputs one wide block forms: O (fwd: 160 f32 registers a
# thread, so up to D 320 one block holds the whole O of its rows and forms
# the scores once), dQ (dq: 128, as at D 256), and each of dK and dV
# (dk/dv: 64 + 64 f32 registers a thread, as at D 128).
FWD_CHUNK_ATOMS = 5
DQ_CHUNK_ATOMS = 4
DKV_CHUNK_ATOMS = 2
# The wide forward keeps its 128-row q tile resident up to this many atoms
# (D 640: 160 KB beside a V stage and the K ring; csrc/flash_fwd.cu
# kWideTallAtoms); past it the streaming kernel forms O in chunks of
# FWD_STREAM_ATOMS.
FWD_TALL_ATOMS = 10
FWD_STREAM_ATOMS = 4
# A grid dimension past x holds at most this many blocks.
GRID_YZ_LIMIT = 65535


def kernel_head_dim(d):
    """(padded width, kernel width) of head dim ``d``: the wrappers below
    copy q, k and v (and dO) into zero-padded tensors of the padded width
    where it differs from d (TMA takes row strides that are multiples of
    16 bytes: d % 8 == 0), and the launch runs, at the padded width, the
    kernel built for the kernel width: the next of FLASH_WIDTHS, or past
    256 the wide kernels at the padded width itself, by column chunks
    (csrc dispatches on the same rule). Raises ValueError for d < 1 and
    past MAX_HEAD_DIM."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {d} is not supported by the flash kernels: they take "
            f"1 to {MAX_HEAD_DIM} (the f32 check kernels hold a row's "
            f"columns in registers)")
    width = -(-d // 8) * 8
    if width > FLASH_WIDTHS[-1]:
        return width, width
    return width, next(w for w in FLASH_WIDTHS if w >= width)


def column_chunks(width, max_atoms):
    """(n, per): a width's ceil(width / 64) atoms of 64 columns cut into n
    chunks of at most ``max_atoms`` atoms, spread evenly: chunk c holds
    atoms [c * per, min((c + 1) * per, atoms)), none empty. The wide
    kernels' grids (csrc/launch.cuh column_chunks, the same rule)."""
    atoms = -(-width // ATOM_COLS)
    n = -(-atoms // max_atoms)
    return n, -(-atoms // n)


def wide_fwd_plan(width):
    """(q resident, n_chunks, per) of the wide forward at padded width
    ``width`` past 256 (csrc/flash_fwd.cu launch_wide, the same rule): up
    to FWD_TALL_ATOMS atoms a block keeps its 128-row q tile resident and
    forms O's columns of one chunk of at most FWD_CHUNK_ATOMS atoms (one
    chunk, and so one score product a key tile, up to D 320); past them
    the streaming kernel, chunks of FWD_STREAM_ATOMS."""
    resident = -(-width // ATOM_COLS) <= FWD_TALL_ATOMS
    return (resident, *column_chunks(
        width, FWD_CHUNK_ATOMS if resident else FWD_STREAM_ATOMS))


def dkv_plan(batch, num_q_heads, num_kv_heads, seq_k, width, n_sm):
    """(split, n_chunks, per) of the 16-bit dk/dv launch at padded width
    ``width`` (csrc/launch.cuh dkv_plan, the same rule): column chunks (up
    to 256 one, column_chunks(width, 4): the kernels hold dK and dV whole
    or, at D 256, walk the q tiles twice; past 256 column_chunks(width,
    DKV_CHUNK_ATOMS)), and ``split``, the blocks a KV head's GQA group is
    spread over: where B * Hkv * key tiles (128 keys) * chunks is under the
    card's ``n_sm`` SMs, the smallest divisor of the group that brings the
    blocks to n_sm (the whole group where none does); else 1."""
    n_chunks, per = column_chunks(
        width, DKV_CHUNK_ATOMS if width > 256 else 4)
    blocks = batch * num_kv_heads * -(-seq_k // 128) * n_chunks
    group = num_q_heads // num_kv_heads
    split = 1
    if blocks < n_sm:
        for g in range(1, group + 1):
            if group % g:
                continue
            split = g
            if blocks * g >= n_sm:
                break
    return split, n_chunks, per


def dkv_partial_floats(batch, num_q_heads, num_kv_heads, seq_k, width,
                       n_sm):
    """f32 scratch the 16-bit dk/dv launch needs: the split blocks' partial
    dK and dV ([2][split][B * Hkv][Sk][width]), or 0 without a split
    (csrc's flash_bwd_dkv_partial_floats)."""
    split = dkv_plan(batch, num_q_heads, num_kv_heads, seq_k, width,
                     n_sm)[0]
    if split == 1:
        return 0
    return 2 * split * batch * num_kv_heads * seq_k * width


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def fold_rows(n):
    """(grid.y, grid.z) of a grid's ``n`` batch * heads rows, as
    csrc/launch.cuh's fold_rows lays them out: z = ceil(n / 65535) slices
    of y = ceil(n / z) rows, block row z * y + y_index, rows at or past n
    idle. n up to 65535 keeps the unfolded (n, 1)."""
    z = -(-n // GRID_YZ_LIMIT) if n > GRID_YZ_LIMIT else 1
    return -(-n // z), z


def _flash_bwd_lib(defines=()):
    lib = load("flash_bwd", defines)
    if lib.flash_bwd_dkv_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        common = [
            i32,                                # dtype: _DTYPE_CODE
            i32, i32, i32, i32, i32, i32,       # B, Hq, Hkv, Sq, Sk, D
            i32, ctypes.c_float,                # causal, sm_scale
            i32, i32, i32,                      # q_base, k_base, kv_len
            ptr,                                # cudaStream_t
        ]
        lib.flash_bwd_error_string.argtypes = [i32]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_bwd_dq_launch.restype = i32
        lib.flash_bwd_dkv_launch.restype = i32
        # q, k, v, dO, lse, delta, then the outputs.
        lib.flash_bwd_dq_launch.argtypes = [ptr] * 7 + common
        lib.flash_bwd_dkv_partial_floats.argtypes = [i32] * 6
        lib.flash_bwd_dkv_partial_floats.restype = ctypes.c_longlong
        # Set last: other threads take a non-None argtypes as "typed".
        lib.flash_bwd_dkv_launch.argtypes = [ptr] * 8 + common[:-1] + [
            i32, ptr, ctypes.c_longlong,        # n_sm, partial, its floats
            ptr,                                # cudaStream_t
        ]
    return lib


def _check(same_dtype, f32, device):
    """Every tensor on ``device`` (cuda), contiguous and 16-byte aligned;
    ``same_dtype`` share one dtype the kernels take, ``f32`` are float32.
    Raises ValueError before anything is built or launched."""
    for name, t in {**same_dtype, **f32}.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must be on {device} (cuda), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dtypes = {t.dtype for t in same_dtype.values()}
    if len(dtypes) != 1 or not dtypes <= set(_DTYPE_CODE):
        raise ValueError(
            f"{'/'.join(same_dtype)} must share one dtype of "
            f"{list(_DTYPE_CODE)}, got "
            f"{', '.join(str(t.dtype) for t in same_dtype.values())}"
        )
    for name, t in f32.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")


def _padded(t, width):
    """``t`` with its last dim zero-padded to ``width`` (a new contiguous
    tensor), or ``t`` itself where it is that wide already."""
    d = t.shape[-1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


def flash_fwd(q, k, v, out, lse, *, causal, sm_scale, q_base, k_base,
              kv_len, base=None, defines=()):
    """Launch the flash forward on PyTorch's current stream. Checks
    device, dtype, shape, contiguity and alignment, and raises on
    anything the kernel does not take or on a refused launch.
    ``base`` (a contiguous int32 (B, 3) tensor on q's device, or None):
    per batch row [q_base, k_base, kv_len], read by the kernel from
    device memory in place of the three ints, which it then ignores.
    ``defines`` picks an instrumented build (see flash_phases.py). A head
    dim that is not a multiple of 8 runs on zero-padded copies of q, k
    and v, and out is copied back from the kernel's padded output
    (kernel_head_dim)."""
    _check({"q": q, "k": k, "v": v, "out": out}, {"lse": lse}, q.device)
    batch, num_q_heads, seq_q, d = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    width, _ = kernel_head_dim(d)
    if out.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("out must be shaped like q and lse like q[:3]")
    if base is not None and (
            base.device != q.device or base.dtype != torch.int32
            or tuple(base.shape) != (batch, 3) or not base.is_contiguous()):
        raise ValueError(
            f"base must be a contiguous int32 ({batch}, 3) tensor on "
            f"{q.device}, got {base.dtype} {tuple(base.shape)} on "
            f"{base.device}")
    lib = _flash_lib(defines)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dest = out
    if width != d:
        q, k, v = (_padded(t, width) for t in (q, k, v))
        out = q.new_empty(q.shape)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype],
            batch, num_q_heads, num_kv_heads, seq_q, seq_k, width,
            int(bool(causal)), float(sm_scale),
            q_base, k_base, kv_len,
            None if base is None else base.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"flash_fwd launch failed: "
            f"{lib.flash_fwd_error_string(err).decode()} ({err})"
        )
    if dest is not out:
        dest.copy_(out[..., :d])


def _bwd_launch(fn_name, q, k, v, dout, lse, delta, outs, *, causal,
                sm_scale, q_base, k_base, kv_len, defines=()):
    _check({"q": q, "k": k, "v": v, "dout": dout, **outs},
           {"lse": lse, "delta": delta}, q.device)
    batch, num_q_heads, seq_q, d = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    width, _ = kernel_head_dim(d)
    if dout.shape != q.shape or lse.shape != q.shape[:3] or \
            delta.shape != q.shape[:3]:
        raise ValueError("dout must be shaped like q, lse and delta like "
                         "q[:3]")
    for name, t in outs.items():
        want = q.shape if name == "dq" else k.shape
        if t.shape != want:
            raise ValueError(f"{name} must be shaped {tuple(want)}")
    lib = _flash_bwd_lib(defines)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dests = outs
    if width != d:
        q, k, v, dout = (_padded(t, width) for t in (q, k, v, dout))
        outs = {name: t.new_empty(*t.shape[:3], width)
                for name, t in outs.items()}
    tail = ()
    if fn_name == "flash_bwd_dkv_launch":
        # The plan's f32 scratch for a split GQA group (bf16 and f16), from
        # PyTorch's allocator: the kernels allocate nothing.
        n_sm = sm_count(q.device.index)
        floats = 0
        if q.dtype != torch.float32:
            floats = dkv_partial_floats(
                batch, num_q_heads, num_kv_heads, seq_k, width, n_sm)
        partial = q.new_empty(floats, dtype=torch.float32) if floats else None
        tail = (n_sm, None if partial is None else partial.data_ptr(), floats)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs.values()), _DTYPE_CODE[q.dtype],
            batch, num_q_heads, num_kv_heads, seq_q, seq_k, width,
            int(bool(causal)), float(sm_scale),
            q_base, k_base, kv_len, *tail, stream,
        )
    if err:
        raise RuntimeError(
            f"{fn_name} failed: "
            f"{lib.flash_bwd_error_string(err).decode()} ({err})"
        )
    if dests is not outs:
        for name, t in dests.items():
            t.copy_(outs[name][..., :d])


def flash_bwd_dq(q, k, v, dout, lse, delta, dq, **kw):
    """Launch the dq kernel of csrc/flash_bwd.cu on PyTorch's current
    stream; checks, and pads a head dim that is not a multiple of 8, as
    ``flash_fwd`` does. Keywords: causal, sm_scale,
    q_base, k_base, kv_len, and ``defines`` for an instrumented build (see
    flash_phases.py)."""
    _bwd_launch("flash_bwd_dq_launch", q, k, v, dout, lse, delta,
                {"dq": dq}, **kw)


def flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, **kw):
    """Launch the dk/dv kernel of csrc/flash_bwd.cu (dk, dv per KV head,
    the GQA group summed in f32 and rounded once); as ``flash_bwd_dq``.
    Where ``dkv_plan`` splits the group over blocks, the launch also takes
    the f32 scratch of their partial sums and sums them in a second kernel
    in a fixed order (no atomics: the same bits every run)."""
    _bwd_launch("flash_bwd_dkv_launch", q, k, v, dout, lse, delta,
                {"dk": dk, "dv": dv}, **kw)


def _int8_mm_lib():
    lib = load("int8_mm")
    if lib.int8_mm_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.int8_mm_error_string.argtypes = [i32]
        lib.int8_mm_error_string.restype = ctypes.c_char_p
        lib.int8_mm_workspace_floats.argtypes = [i32] * 4
        lib.int8_mm_workspace_floats.restype = ctypes.c_longlong
        lib.int8_mm_launch.restype = i32
        # Set last: other threads take a non-None argtypes as "typed".
        lib.int8_mm_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr,            # x, qt, scale, y, workspace
            i32, i32, i32, i32,                 # dtype, M, N, K
            ptr,                                # cudaStream_t
        ]
    return lib


@functools.lru_cache(maxsize=None)
def int8_mm_workspace_floats(dtype, m, n, k):
    """Floats of f32 workspace the launch for (M, N, K) in ``dtype`` needs:
    0 for every shape of csrc/int8_mm.cu, which sums its K splits inside
    one launch (a thread-block cluster)."""
    return _int8_mm_lib().int8_mm_workspace_floats(_DTYPE_CODE[dtype], m, n,
                                                   k)


def int8_mm(x, qt, scale, y, workspace=None):
    """Launch csrc/int8_mm.cu on PyTorch's current stream: y (M, N) =
    ((x (M, K) @ qt (N, K)^T) in f32 * scale (N,)) in y's dtype, which is
    x's or, for bf16 or f16 x, float32 (the scaled accumulator unrounded).
    Checks device, dtype, shape and contiguity, and raises on anything the
    kernel does not take or on a refused launch. ``workspace``: a float32
    tensor of at least ``int8_mm_workspace_floats`` elements on x's
    device, or None where that is 0."""
    m, k = x.shape
    n = qt.shape[0]
    _check({"x": x}, {"scale": scale}, x.device)
    _check({"y": y}, {}, x.device)
    if y.dtype != x.dtype and not (x.dtype in _INT8_TO_F32
                                   and y.dtype == torch.float32):
        raise ValueError(f"y must be {x.dtype} (or float32 for bfloat16 or "
                         f"float16 x), got {y.dtype}")
    code = _DTYPE_CODE[x.dtype] if y.dtype == x.dtype else \
        _INT8_TO_F32[x.dtype]
    for name, t in {"qt": qt, "workspace": workspace}.items():
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if qt.dtype != torch.int8 or qt.shape != (n, k):
        raise ValueError(f"qt must be int8 ({n}, {k}), got {qt.dtype} "
                         f"{tuple(qt.shape)}")
    if tuple(y.shape) != (m, n) or scale.numel() != n:
        raise ValueError(f"y must be ({m}, {n}) and scale hold {n} values")
    lib = _int8_mm_lib()
    need = int8_mm_workspace_floats(x.dtype, m, n, k)
    if need and (workspace is None or workspace.dtype != torch.float32
                 or workspace.numel() < need):
        raise ValueError(f"the launch needs {need} float32 of workspace")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.int8_mm_launch(
            x.data_ptr(), qt.data_ptr(), scale.data_ptr(), y.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            code, m, n, k, stream,
        )
    if err:
        raise RuntimeError(
            f"int8_mm launch failed: "
            f"{lib.int8_mm_error_string(err).decode()} ({err})"
        )
