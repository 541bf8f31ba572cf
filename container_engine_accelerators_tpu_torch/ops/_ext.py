# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries land in
``.torch_ext/`` at the checkout root, named by a hash of the source and
flags, so an edited source rebuilds and an unchanged one is reused.
Nothing here runs at import time: the first kernel call builds.
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
SOURCES = ("flash_fwd",)

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


def _library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES):
    """Compile every source in ``names`` that has no library yet, one
    ``nvcc`` per source, all started together. Raises with the compiler's
    output if any fails."""
    pending = {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            build_info.setdefault(
                name, {"seconds": 0.0, "ptxas": "", "path": str(path)}
            )
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in pending.items():
        output, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{output}")
            continue
        os.replace(tmp, path)
        build_info[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": output,
            "path": str(path),
        }
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return _libs[name]


def _flash_lib():
    lib = load("flash_fwd")
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
            ptr,                                # cudaStream_t
        ]
    return lib


_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
FLASH_HEAD_DIMS = (64, 128)


def flash_fwd(q, k, v, out, lse, *, causal, sm_scale, q_base, k_base,
              kv_len):
    """Launch the flash forward on PyTorch's current stream. Checks
    device, dtype, shape, contiguity and alignment, and raises on
    anything the kernel does not take or on a refused launch."""
    tensors = {"q": q, "k": k, "v": v, "out": out, "lse": lse}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device} (cuda), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODE or {k.dtype, v.dtype, out.dtype} != {
        q.dtype
    }:
        raise ValueError(
            f"q/k/v/out must share one dtype of {list(_DTYPE_CODE)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}"
        )
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    batch, num_q_heads, seq_q, d = q.shape
    _, num_kv_heads, seq_k, _ = k.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel "
                         f"(takes {FLASH_HEAD_DIMS})")
    if out.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("out must be shaped like q and lse like q[:3]")
    if batch * num_q_heads > 65535:
        raise ValueError(f"B*Hq = {batch * num_q_heads} exceeds the "
                         f"kernel's grid limit of 65535")
    lib = _flash_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODE[q.dtype],
            batch, num_q_heads, num_kv_heads, seq_q, seq_k, d,
            int(bool(causal)), float(sm_scale),
            q_base, k_base, kv_len, stream,
        )
    if err:
        raise RuntimeError(
            f"flash_fwd launch failed: "
            f"{lib.flash_fwd_error_string(err).decode()} ({err})"
        )
