// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Host-side launch helpers shared by the kernel sources: TMA tensor maps
// (cuTensorMapEncodeTiled, found through the runtime so the build needs no
// -lcuda) and the once-per-device opt-in to more than 48 KB of dynamic
// shared memory.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-3 map (d, rows, heads) of a contiguous (heads, rows, d) tensor of
// the 16-bit element type E (__nv_bfloat16 or __half) whose box is one
// swizzle atom of a tile `width` columns wide (0: d): min(width, 64)
// columns of `box_rows` rows of one head, with 128-byte swizzle (64-byte
// where a row of the tile is 64 bytes, width 32). Rows past `rows` and
// columns past `d` read as zeros, so a kernel built for `width` reads a
// tensor of d < width columns (d % 8 == 0: TMA takes row strides that are
// multiples of 16 bytes) as if it were zero-padded.
template <typename E>
inline bool encode_rows(CUtensorMap* map, const void* base, int d, int rows,
                        int heads, int box_rows, int width = 0) {
  static_assert(sizeof(E) == 2, "a 16-bit element type");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (width == 0) width = d;
  const int row_bytes = width * 2 < 128 ? width * 2 : 128;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)row_bytes / 2,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                std::is_same<E, __half>::value
                    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A rank-3 map (cols, rows, 1) of a contiguous (rows, cols) int8 matrix
// whose box is one swizzle atom: `box_cols` (64 or 128) columns of
// `box_rows` rows, with 64- or 128-byte swizzle to match. Needs cols % 16
// == 0 and a 16-byte aligned base (TMA's stride and address rules);
// columns past `cols` and rows past `rows` read as zeros.
inline bool encode_int8_rows(CUtensorMap* map, const void* base, int cols,
                             int rows, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols,
                                 (cuuint64_t)rows * cols};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launches' dtype codes (ops/_ext.py _DTYPE_CODE, the same numbers):
// bf16 and f16 run the tensor-core kernels, f32 the check kernels.
constexpr int kDtypeBf16 = 0;
constexpr int kDtypeF32 = 1;
constexpr int kDtypeF16 = 2;

// A 16-bit element type as a value (Elem<E>::type), for with_elem.
template <typename E>
struct Elem {
  using type = E;
};

// f(Elem<E>{}) for the element type of a 16-bit dtype code: __half for
// kDtypeF16, __nv_bfloat16 otherwise.
template <typename F>
auto with_elem(int dtype, F f) {
  return dtype == kDtypeF16 ? f(Elem<__half>{}) : f(Elem<__nv_bfloat16>{});
}

// A kernel width as a type (Width<D>::value), for with_width.
template <int D>
struct Width {
  static constexpr int value = D;
};

// The widest head dim the kernels take: the f32 check kernels hold a lane's
// columns of a row (d / 32 floats an array) in registers, up to 1024. The
// 16-bit kernels past 256 stream their operands in 64-column atoms and have
// no width of their own (ops/_ext.py MAX_HEAD_DIM, the same number).
constexpr int kMaxHeadDim = 1024;
// Columns of one 128-byte swizzle atom of a 16-bit element type.
constexpr int kAtomCols = 64;

// f(Width<D>{}) for the kernels' width D that takes head dim d: the next of
// 32, 64, 128 and 256 (d <= 256; ops/_ext.py kernel_head_dim, the same
// rule, is what the CPU tests hold).
template <typename F>
auto with_width(int d, F f) {
  return d <= 32    ? f(Width<32>{})
         : d <= 64  ? f(Width<64>{})
         : d <= 128 ? f(Width<128>{})
                    : f(Width<256>{});
}

// The f32 check kernels' width for head dim d: with_width's up to 256, then
// 512 and 1024.
template <typename F>
auto with_f32_width(int d, F f) {
  return d <= 256   ? with_width(d, f)
         : d <= 512 ? f(Width<512>{})
                    : f(Width<1024>{});
}

// Column chunks of a width past 256 (ops/_ext.py column_chunks, the same
// rule): its ceil(width / 64) atoms cut into n chunks of at most max_atoms
// each, spread evenly: chunk c holds atoms [c * per, min((c + 1) * per,
// atoms)), none of them empty.
struct Chunks {
  int n, per;
};

inline Chunks column_chunks(int width, int max_atoms) {
  const int atoms = (width + kAtomCols - 1) / kAtomCols;
  const int n = (atoms + max_atoms - 1) / max_atoms;
  return {n, (atoms + n - 1) / n};
}

// Atoms of dK and of dV one dk/dv block holds (64 + 64 f32 registers a
// thread, as at D 128).
constexpr int kDkvChunkAtoms = 2;

// The dk/dv grid (ops/_ext.py dkv_plan, the same rule) for a padded width
// `width`: column chunks (up to 256 one, column_chunks(width, 4): the
// kernels hold dK and dV whole or, at D 256, walk twice; past 256
// column_chunks(width, kDkvChunkAtoms)), and `split`, the blocks a KV
// head's GQA group is spread over: where B * Hkv * key tiles * chunks is
// under the card's `n_sm`, the smallest divisor of the group that brings
// the blocks to n_sm (the whole group where none does); else 1.
struct DkvPlan {
  int split;
  Chunks chunks;
};

inline DkvPlan dkv_plan(int batch, int hq, int hkv, int sk, int width,
                        int n_sm) {
  const Chunks chunks =
      column_chunks(width, width > 256 ? kDkvChunkAtoms : 4);
  const long long blocks =
      (long long)batch * hkv * ((sk + 127) / 128) * chunks.n;
  const int group = hq / hkv;
  int split = 1;
  if (blocks < n_sm) {
    for (int g = 1; g <= group; ++g) {
      if (group % g) continue;
      split = g;
      if (blocks * g >= n_sm) break;
    }
  }
  return {split, chunks};
}

// A grid's batch * heads rows folded over grid.y and grid.z, each at most
// 65535: z = ceil(n / 65535) slices of y = ceil(n / z) rows, so n up to
// 65535 keeps z = 1 and y = n. A block's row is folded_row(); rows at or
// past n (fewer than z) return at once. ops/_ext.py's fold_rows is the same
// rule, held by the CPU tests.
inline dim3 fold_rows(int x, int n) {
  const int z = n > 65535 ? (n + 65534) / 65535 : 1;
  return dim3(x, (n + z - 1) / z, z);
}

__device__ __forceinline__ int folded_row() {
  return blockIdx.z * gridDim.y + blockIdx.y;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device. `configured` (one per kernel) remembers the devices already set,
// so the attribute call is made once per device.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                               std::atomic<uint64_t>* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (configured->load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) configured->fetch_or(bit);
  return err;
}

}  // namespace host
