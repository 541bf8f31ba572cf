# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries land in
``.torch_ext/`` at the checkout root, named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one is reused. A build with extra
preprocessor ``defines`` (an instrumented variant) is a library of its
own. Nothing here runs at import time: the first kernel call builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_fwd", "flash_bwd")

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
    together. Raises with the compiler's output if any fails."""
    pending = {}
    for name in names:
        path = _library_path(name, defines)
        key = name if not defines else f"{name}{list(defines)}"
        if path.exists():
            build_info.setdefault(
                key, {"seconds": 0.0, "ptxas": "", "path": str(path)}
            )
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
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
            i32,                                # dtype: 0 bf16, 1 f32
            i32, i32, i32, i32, i32, i32,       # B, Hq, Hkv, Sq, Sk, D
            i32, ctypes.c_float,                # causal, sm_scale
            i32, i32, i32,                      # q_base, k_base, kv_len
            ptr,                                # base (B, 3) int32 or NULL
            ptr,                                # cudaStream_t
        ]
    return lib


_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
FLASH_HEAD_DIMS = (32, 64, 128)


def _flash_bwd_lib(defines=()):
    lib = load("flash_bwd", defines)
    if lib.flash_bwd_dkv_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        common = [
            i32,                                # dtype: 0 bf16, 1 f32
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
        # Set last: other threads take a non-None argtypes as "typed".
        lib.flash_bwd_dkv_launch.argtypes = [ptr] * 8 + common
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


def _check_shapes(q, k):
    batch, num_q_heads, seq_q, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel "
                         f"(takes {FLASH_HEAD_DIMS})")
    if batch * num_q_heads > 65535:
        raise ValueError(f"B*Hq = {batch * num_q_heads} exceeds the "
                         f"kernel's grid limit of 65535")


def flash_fwd(q, k, v, out, lse, *, causal, sm_scale, q_base, k_base,
              kv_len, base=None, defines=()):
    """Launch the flash forward on PyTorch's current stream. Checks
    device, dtype, shape, contiguity and alignment, and raises on
    anything the kernel does not take or on a refused launch.
    ``base`` (a contiguous int32 (B, 3) tensor on q's device, or None):
    per batch row [q_base, k_base, kv_len], read by the kernel from
    device memory in place of the three ints, which it then ignores.
    ``defines`` picks an instrumented build (see flash_phases.py)."""
    _check({"q": q, "k": k, "v": v, "out": out}, {"lse": lse}, q.device)
    batch, num_q_heads, seq_q, d = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    _check_shapes(q, k)
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
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype],
            batch, num_q_heads, num_kv_heads, seq_q, seq_k, d,
            int(bool(causal)), float(sm_scale),
            q_base, k_base, kv_len,
            None if base is None else base.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"flash_fwd launch failed: "
            f"{lib.flash_fwd_error_string(err).decode()} ({err})"
        )


def _bwd_launch(fn_name, q, k, v, dout, lse, delta, outs, *, causal,
                sm_scale, q_base, k_base, kv_len, defines=()):
    _check({"q": q, "k": k, "v": v, "dout": dout, **outs},
           {"lse": lse, "delta": delta}, q.device)
    batch, num_q_heads, seq_q, d = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    _check_shapes(q, k)
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
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs.values()), _DTYPE_CODE[q.dtype],
            batch, num_q_heads, num_kv_heads, seq_q, seq_k, d,
            int(bool(causal)), float(sm_scale),
            q_base, k_base, kv_len, stream,
        )
    if err:
        raise RuntimeError(
            f"{fn_name} failed: "
            f"{lib.flash_bwd_error_string(err).decode()} ({err})"
        )


def flash_bwd_dq(q, k, v, dout, lse, delta, dq, **kw):
    """Launch the dq kernel of csrc/flash_bwd.cu on PyTorch's current
    stream; checks as ``flash_fwd`` does. Keywords: causal, sm_scale,
    q_base, k_base, kv_len, and ``defines`` for an instrumented build (see
    flash_phases.py)."""
    _bwd_launch("flash_bwd_dq_launch", q, k, v, dout, lse, delta,
                {"dq": dq}, **kw)


def flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, **kw):
    """Launch the dk/dv kernel of csrc/flash_bwd.cu (dk, dv per KV head,
    the GQA group summed inside); as ``flash_bwd_dq``."""
    _bwd_launch("flash_bwd_dkv_launch", q, k, v, dout, lse, delta,
                {"dk": dk, "dv": dv}, **kw)
