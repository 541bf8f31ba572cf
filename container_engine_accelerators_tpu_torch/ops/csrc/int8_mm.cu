// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Weight-only int8 matrix product (W8A16) for NVIDIA Hopper (sm_90a),
// written by hand.
//
// Replaces the int8 branch of
// container_engine_accelerators_tpu/parallel/overlap.py:_chunk_mm, which is
// no Pallas kernel: XLA fuses the int8 -> activation-dtype convert into the
// matmul's operand read there. Same contract:
//
//   y (M, N) = ((x (M, K) @ q (K, N)) with f32 accumulation * scale (N))
//              cast once to x's dtype,
//
// the per-output-channel f32 scale applied to the f32 accumulator, never to
// a rounded product. Here q comes transposed, qt (N, K) with K contiguous:
// the B operand of mma.sync's row.col form is K-major per output column, so
// one column's two neighbouring k values are one 16-bit load. Each int8 value
// converts to bf16 exactly (|q| <= 127 needs 7 significant bits of bf16's 8),
// and int8 x bf16 products are exact in f32, so the kernel and the plain
// version differ only in the order of their f32 sums.
//
// What bounds it on H100. Bytes = K*N (int8) + 4N (scale) + 2MK (x) + 2MN
// (y); work = 2MKN. Decode (M 1-8) and the verify (M 128) read each weight
// byte for a handful of rows: the product is bound by HBM, and the int8
// weight halves the bytes the bf16 product streams. Prefill (M 512-8192) is
// bound by the tensor cores' bf16 rate.
//
// What the design does about it (bf16 activations):
// - Tiles follow M: 16 x 64 output tiles with 256-deep K steps and eight
//   warps for M <= 16 (decode: rows past M are zero-filled in shared memory
//   and cost no HBM bytes), 64 x 128 with four warps up to M 256 (the
//   verify), 128 x 128 with eight warps and 64-deep steps beyond (prefill).
// - Loads overlap the math: a ring of 3-4 stages of x and qt tiles in
//   shared memory filled with 16-byte cp.async (zero-fill past M, N and
//   K), so several tiles of weight bytes are in flight per block.
// - When the output tiles alone do not give a block per SM (decode and
//   the smaller projections), K is split across blocks: each writes its f32
//   partial sums to a workspace and a second kernel sums the splits in index
//   order, scales and casts. No atomics, so a result is the same bit for
//   bit on every run, as the replayed serving graphs need.
// - Products are mma.sync m16n8k16 bf16 with f32 accumulation, A
//   fragments by ldmatrix; the int8 tile is converted to bf16 in
//   registers as its B fragments are read, with byte permutes and FP32
//   adds (the int -> float converts run at a quarter rate).
// Left for later, each to be tried with a measurement: wgmma with the
//   weight tile converted into a shared-memory bf16 tile, TMA loads, a
//   persistent grid, and a permuted qt layout for one 32-bit B load.
//
// f32 activations (for checking) run a plain SIMT kernel with f32 FMAs, the
// same contract; K is not split there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"

namespace {

// K is split when the output tiles give fewer blocks than the H100's 132
// SMs, into enough splits for about four blocks an SM (the sweep of
// bench/int8_mm_tiles.cu: at M 8, wq and w2 take 9 splits of 64 tiles).
constexpr int kSMs = 132;
constexpr int kTargetBlocks = 4 * kSMs;
constexpr int kMaxSplits = 64;

// Tile configurations by M. BM x BN outputs per block, BK-deep K steps in
// a ring of STAGES, WARPS_M x WARPS_N warps, each owning a (BM / WARPS_M) x
// (BN / WARPS_N) sub-tile.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_ = 4>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, kStages = STAGES_;
  static constexpr int WARPS_M = WM_, WARPS_N = WN_;
  static constexpr int kThreads = 32 * WM_ * WN_;
  static constexpr int MT = BM / WM_ / 16;  // m16 tiles per warp
  static constexpr int NT = BN / WN_ / 8;   // n8 tiles per warp
  // Rows padded by 16 bytes: the fragment reads hit distinct banks.
  static constexpr int XS = BK + 8;   // bf16 elements per x row
  static constexpr int QS = BK + 16;  // bytes per qt row
  static constexpr int kXBytes = BM * XS * 2;
  static constexpr int kQBytes = BN * QS;
  static constexpr int kBytes = STAGES_ * (kXBytes + kQBytes);
};

// Chosen on the card among other shapes, depths and warp counts
// (bench/int8_mm_tiles.cu; PERF.md):
// at M 8 the decode tile's eight warps and 256-byte rows of qt keep the
// most weight bytes in flight, and the prefill tile's 64-deep steps halve
// the barriers of 32-deep ones.
using Decode = Tile<16, 64, 256, 1, 8, 4>;
using Verify = Tile<64, 128, 32, 2, 2, 4>;
using Prefill = Tile<128, 128, 64, 2, 4, 3>;

int config_for(int m) { return m <= 16 ? 0 : (m <= 256 ? 1 : 2); }

template <typename T>
int splits_for(int m, int n, int k) {
  const int blocks = ((n + T::BN - 1) / T::BN) * ((m + T::BM - 1) / T::BM);
  const int k_tiles = (k + T::BK - 1) / T::BK;
  if (blocks >= kSMs || k_tiles < 2) return 1;
  int splits = (kTargetBlocks + blocks - 1) / blocks;
  if (splits > k_tiles) splits = k_tiles;
  return splits < kMaxSplits ? splits : kMaxSplits;
}

int plan_splits(int m, int n, int k) {
  switch (config_for(m)) {
    case 0: return splits_for<Decode>(m, n, k);
    case 1: return splits_for<Verify>(m, n, k);
    default: return splits_for<Prefill>(m, n, k);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (and nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two int8 values (low byte first) as a bf16x2 register, exactly, at the
// full rate of the integer and FP32 pipes (the int -> float converts run at
// a quarter of it): each byte, biased by
// 128, becomes the low byte of the f32 2^23 + (q + 128); subtracting
// 2^23 + 128 leaves q, an integer of at most 7 significant bits, so the f32
// word's upper half is q in bf16.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint16_t v) {
  const uint32_t biased = static_cast<uint32_t>(v) ^ 0x8080u;
  const float lo =
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7541)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The A fragment of an m16n8k16 product (rows r0..r0+15, k k0..k0+15 of a
// row-major bf16 tile with `stride` elements a row) in one ldmatrix.x4:
// lanes 0-15 address rows r0..r0+15 at k0, lanes 16-31 the same rows at
// k0 + 8.
__device__ __forceinline__ void load_a_frag(uint32_t* a, const uint16_t* tile,
                                            int stride, int r0, int k0,
                                            int lane) {
  const uint16_t* p =
      tile + (r0 + (lane % 16)) * stride + k0 + (lane / 16) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stages K tile `kt` of x rows [bm, bm + BM) and qt rows [bn, bn + BN) into
// shared memory. ALIGNED (K % 16 == 0, 16-byte aligned bases): 16-byte
// cp.async chunks, each wholly inside or outside K. Otherwise element by
// element with plain loads, which the next __syncthreads publishes.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_tile(
    const uint16_t* __restrict__ x, const int8_t* __restrict__ qt,
    uint16_t* xs, int8_t* qs, int m, int n, int k, int bm, int bn, int kt) {
  const int k0 = kt * T::BK;
  if constexpr (ALIGNED) {
    constexpr int kXChunks = T::BM * T::BK / 8;
    constexpr int kQChunks = T::BN * T::BK / 16;
    for (int c = threadIdx.x; c < kXChunks; c += T::kThreads) {
      const int r = c / (T::BK / 8), kc = (c % (T::BK / 8)) * 8;
      const bool ok = bm + r < m && k0 + kc < k;
      cp_async16(xs + r * T::XS + kc,
                 ok ? x + (size_t)(bm + r) * k + k0 + kc : x, ok);
    }
    for (int c = threadIdx.x; c < kQChunks; c += T::kThreads) {
      const int r = c / (T::BK / 16), kc = (c % (T::BK / 16)) * 16;
      const bool ok = bn + r < n && k0 + kc < k;
      cp_async16(qs + r * T::QS + kc,
                 ok ? qt + (size_t)(bn + r) * k + k0 + kc : qt, ok);
    }
  } else {
    for (int e = threadIdx.x; e < T::BM * T::BK; e += T::kThreads) {
      const int r = e / T::BK, kc = e % T::BK;
      const bool ok = bm + r < m && k0 + kc < k;
      xs[r * T::XS + kc] = ok ? x[(size_t)(bm + r) * k + k0 + kc] : 0;
    }
    for (int e = threadIdx.x; e < T::BN * T::BK; e += T::kThreads) {
      const int r = e / T::BK, kc = e % T::BK;
      const bool ok = bn + r < n && k0 + kc < k;
      qs[r * T::QS + kc] = ok ? qt[(size_t)(bn + r) * k + k0 + kc] : 0;
    }
  }
}

// One block: the BM x BN output tile (blockIdx.y, blockIdx.x) over split
// blockIdx.z of the K tiles. With one split, y = acc * scale in bf16;
// otherwise the f32 partial goes to ws (splits, M, N).
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(T::kThreads)
    int8_mm_bf16_kernel(const uint16_t* __restrict__ x,
                        const int8_t* __restrict__ qt,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                        int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs_base = reinterpret_cast<uint16_t*>(smem);
  int8_t* qs_base =
      reinterpret_cast<int8_t*>(smem + T::kStages * T::kXBytes);
  const int bn = blockIdx.x * T::BN, bm = blockIdx.y * T::BM;
  const int splits = gridDim.z, split = blockIdx.z;
  const int k_tiles = (k + T::BK - 1) / T::BK;
  const int kt0 = (int)((long long)split * k_tiles / splits);
  const int kt1 = (int)((long long)(split + 1) * k_tiles / splits);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / T::WARPS_N) * (T::BM / T::WARPS_M);
  const int wn = (warp % T::WARPS_N) * (T::BN / T::WARPS_N);

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (kt0 + s < kt1) {
      load_tile<T, ALIGNED>(x, qt, xs_base + s * (T::kXBytes / 2),
                            qs_base + s * T::kQBytes, m, n, k, bm, bn,
                            kt0 + s);
    }
    cp_async_commit();
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    cp_async_wait<T::kStages - 2>();
    __syncthreads();
    // Refill the stage every warp finished with in the last iteration.
    const int nxt = kt + T::kStages - 1;
    if (nxt < kt1) {
      const int s = (i + T::kStages - 1) % T::kStages;
      load_tile<T, ALIGNED>(x, qt, xs_base + s * (T::kXBytes / 2),
                            qs_base + s * T::kQBytes, m, n, k, bm, bn, nxt);
    }
    cp_async_commit();

    const uint16_t* xs = xs_base + (i % T::kStages) * (T::kXBytes / 2);
    const int8_t* qs = qs_base + (i % T::kStages) * T::kQBytes;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 16) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mi = 0; mi < T::MT; ++mi) {
        load_a_frag(a[mi], xs, T::XS, wm + mi * 16, kk, lane);
      }
#pragma unroll
      for (int ni = 0; ni < T::NT; ++ni) {
        const int8_t* col = qs + (wn + ni * 8 + g) * T::QS + kk + 2 * t;
        const uint32_t b0 =
            int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(col));
        const uint32_t b1 =
            int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(col + 8));
#pragma unroll
        for (int mi = 0; mi < T::MT; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator element e of an m16n8 tile: row g (+8 for e >= 2), column
  // 2t + (e & 1).
#pragma unroll
  for (int mi = 0; mi < T::MT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::NT; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = bm + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int c = bn + wn + ni * 8 + 2 * t + (e & 1);
        if (r >= m || c >= n) continue;
        if (splits == 1) {
          y[(size_t)r * n + c] = __float2bfloat16(acc[mi][ni][e] * scale[c]);
        } else {
          ws[((size_t)split * m + r) * n + c] = acc[mi][ni][e];
        }
      }
    }
  }
}

// The split-K epilogue: y = (sum of the splits' partials, in split order)
// * scale, cast once to bf16.
__global__ void int8_mm_reduce_kernel(const float* __restrict__ ws,
                                      const float* __restrict__ scale,
                                      __nv_bfloat16* __restrict__ y, int m,
                                      int n, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)m * n;
  if (idx >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[(size_t)s * total + idx];
  y[idx] = __float2bfloat16(sum * scale[idx % n]);
}

// f32 activations: one thread per output, 16 x 16 outputs per block, K in
// steps of 16 through shared memory.
__global__ void int8_mm_f32_kernel(const float* __restrict__ x,
                                   const int8_t* __restrict__ qt,
                                   const float* __restrict__ scale,
                                   float* __restrict__ y, int m, int n,
                                   int k) {
  __shared__ float xs[16][17];
  __shared__ float qs[16][17];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = blockIdx.y * 16 + ty, c = blockIdx.x * 16 + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += 16) {
    const int xr = blockIdx.y * 16 + ty, qr = blockIdx.x * 16 + ty;
    xs[ty][tx] = (xr < m && k0 + tx < k) ? x[(size_t)xr * k + k0 + tx] : 0.f;
    qs[ty][tx] = (qr < n && k0 + tx < k)
                     ? static_cast<float>(qt[(size_t)qr * k + k0 + tx])
                     : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) acc = fmaf(xs[ty][kk], qs[tx][kk], acc);
    __syncthreads();
  }
  if (r < m && c < n) y[(size_t)r * n + c] = acc * scale[c];
}

template <typename T, bool ALIGNED>
cudaError_t launch_tile(const void* x, const int8_t* qt, const float* scale,
                        void* y, float* ws, int m, int n, int k, int splits,
                        cudaStream_t stream) {
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      int8_mm_bf16_kernel<T, ALIGNED>, T::kBytes, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, splits);
  int8_mm_bf16_kernel<T, ALIGNED><<<grid, T::kThreads, T::kBytes, stream>>>(
      static_cast<const uint16_t*>(x), qt, scale,
      static_cast<__nv_bfloat16*>(y), ws, m, n, k);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bf16(const void* x, const int8_t* qt, const float* scale,
                        void* y, float* ws, int m, int n, int k, int splits,
                        cudaStream_t stream) {
  const bool aligned = k % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(qt) % 16 == 0;
  return aligned
             ? launch_tile<T, true>(x, qt, scale, y, ws, m, n, k, splits,
                                    stream)
             : launch_tile<T, false>(x, qt, scale, y, ws, m, n, k, splits,
                                     stream);
}

}  // namespace

// Floats of f32 workspace the bf16 launch for (m, n, k) needs: splits * m *
// n when it splits K, else 0 (f32 launches: always 0). The wrapper allocates
// it; the launch recomputes the same plan.
extern "C" long long int8_mm_workspace_floats(int dtype, int m, int n,
                                              int k) {
  if (dtype != 0 || m <= 0 || n <= 0 || k <= 0) return 0;
  const int splits = plan_splits(m, n, k);
  return splits > 1 ? (long long)splits * m * n : 0;
}

// dtype: 0 = bf16 x and y (the tensor-core kernel), 1 = f32 (the check
// kernel). x (m, k), qt (n, k) int8 and y (m, n) are contiguous; scale is
// (n,) f32; ws holds int8_mm_workspace_floats(dtype, m, n, k) floats, or is
// null when that is 0. Launches on `stream`, allocates nothing, and returns
// the first error of the set-up or the launch (0 on success).
extern "C" int int8_mm_launch(const void* x, const int8_t* qt,
                              const float* scale, void* y, float* ws,
                              int dtype, int m, int n, int k, void* stream) {
  if ((dtype != 0 && dtype != 1) || m <= 0 || n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((n + 15) / 16, (m + 15) / 16);
    int8_mm_f32_kernel<<<grid, dim3(16, 16), 0, st>>>(
        static_cast<const float*>(x), qt, scale, static_cast<float*>(y), m, n,
        k);
    return static_cast<int>(cudaGetLastError());
  }
  const int splits = plan_splits(m, n, k);
  if (splits > 1 && ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (config_for(m)) {
    case 0:
      err = launch_bf16<Decode>(x, qt, scale, y, ws, m, n, k, splits, st);
      break;
    case 1:
      err = launch_bf16<Verify>(x, qt, scale, y, ws, m, n, k, splits, st);
      break;
    default:
      err = launch_bf16<Prefill>(x, qt, scale, y, ws, m, n, k, splits, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const long long total = (long long)m * n;
    const int threads = 256;
    int8_mm_reduce_kernel<<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, st>>>(
            ws, scale, static_cast<__nv_bfloat16*>(y), m, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
