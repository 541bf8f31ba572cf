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
// a rounded product. Here q comes transposed, qt (N, K) with K contiguous
// (quantization.Int8Weight's layout). Each int8 value converts to bf16
// exactly (|q| <= 127 needs 7 significant bits of bf16's 8), and int8 x
// bf16 products are exact in f32, so the kernels and the plain version
// differ only in the order of their f32 sums.
//
// What bounds it on H100. Bytes = K*N (int8) + 4N (scale) + 2MK (x) + 2MN
// (y); work = 2MKN. Decode (M 1-8) and the verify (M 128) read each weight
// byte for a handful of rows: the product is bound by HBM, and the int8
// weight halves the bytes the bf16 product streams. Prefill (M 512-8192) is
// bound by the tensor cores' bf16 rate, which only wgmma reaches.
//
// What the design does about it (bf16 activations, the Hopper kernel
// int8_mm_sm90_kernel):
// - The operands are swapped: a block computes a tile of y^T, 64 output
//   channels per consumer warpgroup against BN tokens, so the weight is
//   wgmma's A operand and the tokens its N (8 or 16 at decode, 128 for the
//   verify, 256 at prefill). One kernel covers every M, and a decode row
//   costs no padding to wgmma's 64 rows.
// - The weight goes from shared memory to registers once: each consumer
//   thread reads its A fragment's byte pairs from the TMA-swizzled int8
//   tile and converts them with byte permutes and FP32 adds (the int ->
//   float converts run at a quarter rate) straight into wgmma's register
//   operand (m64nNk16, A from registers, x from shared memory as a K-major
//   B with 128-byte swizzle), one k16 step at a time, so a step's converts
//   run while the previous step's wgmma does. No bf16 copy of the weight
//   is written.
// - Loads overlap the math: one producer thread keeps a ring of stages (a
//   64- or 128-deep K slice of the int8 tile and of the x tile) in flight
//   with TMA, signalled through mbarriers; consumers release a stage after
//   their wgmma on it completes. No block-wide barrier in the K loop. TMA
//   zero-fills rows past M and N and columns past K. The weight's tensor
//   maps are cached; x's is encoded at each launch (and baked into a
//   captured graph's launch, whose static buffers keep it valid).
// - Where the output tiles give fewer blocks than SMs (decode, the verify,
//   the smaller projections), K is split across a thread-block cluster of
//   up to 8 blocks along K: the blocks' f32 partials are summed in rank
//   order through distributed shared memory by rank 0, which scales,
//   casts and writes y. One launch, no workspace, no atomics, so a result
//   is the same bit for bit on every run, as the replayed serving graphs
//   need.
// - The epilogue stages the bf16 tile in shared memory and writes y's rows
//   with 16-byte stores.
// Tried on the card and slower, so left out: converting stage i + 1's
//   fragments while stage i's wgmma run (two register sets of A), 64-deep
//   stages below M 257, K splits past one block an SM, 64-token tiles at
//   the verify. Not tried: the weight tile converted once into a shared
//   bf16 tile with both wgmma operands from shared memory, which still
//   pays every convert (the tile bench's -DINT8_MM_NO_CONVERT build bounds
//   what the converts cost); a persistent grid; a permuted qt layout for
//   wider fragment loads.
//
// The general path takes what a TMA map cannot describe (K % 16 != 0, K
// under one 128-deep stage, bases not 16-byte aligned): the earlier
// design's cp.async ring with ldmatrix and mma.sync m16n8k16, the same
// int8 -> bf16 convert, tiles by M, 16-byte cp.async where K % 16 == 0 and
// the bases are aligned and element-wise loads otherwise. f32 activations
// (for checking) run a plain SIMT kernel with f32 FMAs, the same contract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

// ---- the general path (mma.sync) -----------------------------------------

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

// The earlier design's tiles, chosen on the card among other shapes,
// depths and warp counts (bench/int8_mm_tiles.cu, which still times them
// with split K as that design launched them; the general path launches one
// split).
using Decode = Tile<16, 64, 256, 1, 8, 4>;
using Verify = Tile<64, 128, 32, 2, 2, 4>;
using Prefill = Tile<128, 128, 64, 2, 4, 3>;

int config_for(int m) { return m <= 16 ? 0 : (m <= 256 ? 1 : 2); }

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


// ---- the Hopper path (TMA, wgmma with the weight in registers) -----------

constexpr int kSMs = 132;
constexpr int kTmaMinK = 128;     // the least K the Hopper path takes

// BN tokens (wgmma's N) x 64 * C channels per block: C consumer
// warpgroups of 64 channels after one producer warpgroup, a ring of STAGES
// BK-deep K slices, MIN_BLOCKS blocks an SM. Shared memory: the ring (each
// stage the int8 tile, BC rows of BK bytes in TMA's BK-byte swizzle, then
// the x tile as BK / 64 atoms of 64 columns of BN rows, 128-byte swizzle),
// reused by the epilogue for the split-K partials and the staged y tile,
// then the full and empty barriers.
template <int BN_, int C_, int STAGES_, int MIN_BLOCKS_, int BK_ = 128>
struct Sm90Tile {
  static constexpr int BN = BN_, C = C_, kStages = STAGES_, BK = BK_;
  static_assert(BK_ == 64 || BK_ == 128, "one int8 swizzle atom a row");
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int BC = 64 * C_;
  static constexpr int kThreads = 128 * (C_ + 1);
  static_assert(C_ == 1 || C_ == 2, "one or two consumer warpgroups");
  // With two consumers, the producer hands its registers to them.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  // The largest cluster of K splits: rank 0 reads every other rank's
  // partial tile, which is small for one consumer's 64 x BN and large
  // for two consumers' 128 x 128 or 256.
  static constexpr int kMaxSplits = C_ == 1 ? 8 : 3;
  static constexpr int kQBytes = BC * BK;
  static constexpr int kXAtom = BN * 128;
  static constexpr int kStageBytes = kQBytes + BK / 64 * kXAtom;
  static constexpr int kAcc = BN / 2;         // f32 accumulators a thread
  static constexpr int kYStride = BC + 8;     // bf16 a staged y row
  static constexpr int kYBytes = BN * kYStride * 2;
  static constexpr int kPartBytes = C * 128 * kAcc * 4;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kBars = kRing;
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
  static_assert(kYBytes <= kRing && kPartBytes <= kRing, "epilogue");
  static_assert(kBytes <= 232448, "shared memory");
};

// Chosen on the card among other tokens, consumers, depths and splits
// (bench/int8_mm_tiles.cu; PERF.md). Decode: one consumer warpgroup, and
// three blocks an SM with 4-deep rings; beyond, two consumers share each x
// tile; from M 257 on, 256 tokens a block halve the x bytes a weight byte
// costs, in a 5-deep ring of 64-deep stages (two 128-deep ones fit).
using D8 = Sm90Tile<8, 1, 4, 3>;
using D16 = Sm90Tile<16, 1, 4, 3>;
using V128 = Sm90Tile<128, 2, 4, 1>;
using P256 = Sm90Tile<256, 2, 5, 1, 64>;

int sm90_config(int m) {
  return m <= 8 ? 0 : m <= 16 ? 1 : m <= 256 ? 2 : 3;
}

// Cluster size along K: as many splits as keep the grid within one block
// an SM (a cluster that waits for a second wave costs more than the
// split gains), at most T::kMaxSplits and the K slices.
template <typename T>
int sm90_splits(int m, int n, int k) {
  const int blocks = ((n + T::BC - 1) / T::BC) * ((m + T::BN - 1) / T::BN);
  const int k_tiles = (k + T::BK - 1) / T::BK;
  int splits = kSMs / blocks;
  if (splits > T::kMaxSplits) splits = T::kMaxSplits;
  if (splits > k_tiles) splits = k_tiles;
  return splits > 1 ? splits : 1;
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// acc += the stage's int8 tile (A) x its x tile at `xs` (B: BK / 64 atoms
// of 64 columns, K-major with 128-byte swizzle), for the thread at `q` (row
// row, byte 2t of the int8 tile; row + 8 is 8 * BK further). k16 step kk
// reads rows row and row + 8 at k pairs 16 kk + 2t and 16 kk + 2t + 8,
// each pair one 16-bit read converted to a bf16x2 register of the A
// fragment. TMA's swizzle moves 16-byte chunk kk of a row to chunk kk ^
// `swz`, the same for both rows (bits 7 and up of row * BK: row % 8 for
// 128-byte rows, row / 2 % 4 for 64-byte ones). The reads come first, then
// each step's converts and its wgmma, so the converts of step kk + 1 run
// while step kk's wgmma does; one commit group. With -DINT8_MM_NO_CONVERT
// (the tile bench's diagnostic build) the raw pairs go to wgmma instead:
// wrong products, timed to show what the converts cost.
template <typename T>
__device__ __forceinline__ void stage_wgmma(float (&acc)[T::kAcc],
                                            const uint8_t* q, int swz,
                                            const uint8_t* xs) {
  uint16_t v[T::BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const int off = (kk ^ swz) * 16;
    v[kk][0] = *reinterpret_cast<const uint16_t*>(q + off);
    v[kk][1] = *reinterpret_cast<const uint16_t*>(q + 8 * T::BK + off);
    v[kk][2] = *reinterpret_cast<const uint16_t*>(q + off + 8);
    v[kk][3] = *reinterpret_cast<const uint16_t*>(q + 8 * T::BK + off + 8);
  }
  sm90::fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#ifdef INT8_MM_NO_CONVERT
      a[r] = v[kk][r];
#else
      a[r] = int8x2_to_bf16x2(v[kk][r]);
#endif
    }
    sm90::wgmma_fence();
    sm90::WgmmaRS<T::BN, 0>::mma(
        acc, a,
        sm90::make_desc(xs + (kk / 4) * T::kXAtom + (kk % 4) * 32, 16,
                        8 * 128, sm90::kSwizzle128B),
        1);
  }
  sm90::wgmma_commit();
}

// One block: channels [bn, bn + BC) x tokens [bm, bm + BN) of y, over the
// K slices of cluster rank blockIdx.z of gridDim.z (one slice range a
// rank; the cluster spans z). Warpgroup 0 loads; warpgroup 1 + w owns
// channels [64w, 64w + 64) of the tile. In a consumer warp (w4 of its
// warpgroup) lane (g = lane / 4, t = lane % 4) holds channels 16 w4 + g and
// 16 w4 + g + 8, and tokens 8j + 2t, 8j + 2t + 1 of every 8 tokens j.
template <typename T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    int8_mm_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_x,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ y, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBars);
  uint64_t* empty = full + T::kStages;
  const int bn = blockIdx.x * T::BC, bm = blockIdx.y * T::BN;
  const int splits = gridDim.z;
  const int k_tiles = (k + T::BK - 1) / T::BK;
  const int kt0 = (int)((long long)blockIdx.z * k_tiles / splits);
  const int kt1 = (int)((long long)(blockIdx.z + 1) * k_tiles / splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4 * T::C);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer. Round r of a stage waits for the consumers to release
    // round r - 1 (the first round's wait passes at once).
    if constexpr (T::C > 1) sm90::regs_dealloc<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, st = i % T::kStages;
        sm90::mbar_wait(empty + st, ((i / T::kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full + st, T::kStageBytes);
        uint8_t* s = smem + st * T::kStageBytes;
        sm90::tma_load_3d(s, &tm_q, full + st, kt * T::BK, bn, 0);
        for (int a = 0; a < T::BK / 64; ++a) {
          sm90::tma_load_3d(s + T::kQBytes + a * T::kXAtom, &tm_x, full + st,
                            kt * T::BK + 64 * a, bm, 0);
        }
      }
    }
    // The split's two cluster barriers (see below), which every thread of
    // every block of the cluster passes.
    __syncwarp();
    if (splits > 1) {
      sm90::cluster_sync();
      sm90::cluster_sync();
    }
  } else {
    if constexpr (T::C > 1) sm90::regs_alloc<T::kConsumerRegs>();
    const int ctid = threadIdx.x - 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row = (ctid / 128) * 64 + 16 * warp + g;  // and row + 8

    float acc[T::kAcc];
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;

    const uint8_t* q = smem + row * T::BK + 2 * t;  // in stage 0
    const int swz = ((row * T::BK) >> 7) & (T::BK / 16 - 1);
    for (int i = 0; i < kt1 - kt0; ++i) {
      const int st = i % T::kStages;
      sm90::mbar_wait(full + st, (i / T::kStages) & 1);
      stage_wgmma<T>(acc, q + st * T::kStageBytes, swz,
                     smem + st * T::kStageBytes + T::kQBytes);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
    }
    // Every consumer is past its last wgmma: the ring is free.
    __syncwarp();
    consumer_sync(128 * T::C);

    if (splits > 1) {
      // Ranks 1.. leave their partials in their own ring; rank 0 adds them
      // in rank order after the first cluster barrier, and the second
      // keeps every rank's shared memory alive until rank 0 has read it.
      float4* part = reinterpret_cast<float4*>(smem);
      const uint32_t rank = sm90::cluster_rank();
      if (rank != 0) {
#pragma unroll
        for (int j = 0; j < T::kAcc / 4; ++j) {
          part[j * 128 * T::C + ctid] = make_float4(
              acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      sm90::cluster_sync();
      if (rank == 0) {
        for (int r = 1; r < splits; ++r) {
#pragma unroll
          for (int j = 0; j < T::kAcc / 4; ++j) {
            const float4 v =
                sm90::ld_cluster_f32x4(part + j * 128 * T::C + ctid, r);
            acc[4 * j] += v.x;
            acc[4 * j + 1] += v.y;
            acc[4 * j + 2] += v.z;
            acc[4 * j + 3] += v.w;
          }
        }
      }
      sm90::cluster_sync();
      if (rank != 0) return;
    }

    // Scale (per channel: per accumulator row), cast once, stage the tile
    // as y's rows (token-major) and write them with 16-byte stores.
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
    const int c0 = bn + row;
    const float s0 = c0 < n ? scale[c0] : 0.f;
    const float s1 = c0 + 8 < n ? scale[c0 + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * t + (e & 1);
        const int ch = row + 8 * (e >> 1);
        ys[tok * T::kYStride + ch] =
            __float2bfloat16(acc[4 * j + e] * (e >> 1 ? s1 : s0));
      }
    }
    consumer_sync(128 * T::C);
    const bool vec = n % 8 == 0;
    for (int e = ctid; e < T::BN * (T::BC / 8); e += 128 * T::C) {
      const int tok = e / (T::BC / 8), c = (e % (T::BC / 8)) * 8;
      const int r = bm + tok, col = bn + c;
      if (r >= m || col >= n) continue;
      const __nv_bfloat16* src = ys + tok * T::kYStride + c;
      __nv_bfloat16* dst = y + (size_t)r * n + col;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int u = 0; u < 8 && col + u < n; ++u) dst[u] = src[u];
      }
    }
  }
}

// TMA maps of the weights, which do not move: encoded once per (base, N,
// K, box), so a launch encodes only x's map.
bool weight_map(CUtensorMap* map, const int8_t* qt, int n, int k,
                int box_cols, int box_rows) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap>
      maps;
  const auto key = std::make_tuple(static_cast<const void*>(qt), n, k,
                                   box_cols, box_rows);
  std::lock_guard<std::mutex> lock(mu);
  const auto found = maps.find(key);
  if (found != maps.end()) {
    *map = found->second;
    return true;
  }
  if (!host::encode_int8_rows(map, qt, k, n, box_cols, box_rows)) {
    return false;
  }
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *map);
  return true;
}

template <typename T>
cudaError_t launch_sm90(const void* x, const int8_t* qt, const float* scale,
                        void* y, int m, int n, int k, int splits,
                        cudaStream_t stream) {
  static std::atomic<uint64_t> configured{0};
  cudaError_t err = host::allow_dynamic_smem(int8_mm_sm90_kernel<T>,
                                             T::kBytes, &configured);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_x;
  if (!weight_map(&tm_q, qt, n, k, T::BK, T::BC) ||
      !host::encode_bf16_rows(&tm_x, x, k, m, 1, T::BN)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + T::BC - 1) / T::BC, (m + T::BN - 1) / T::BN,
                     splits);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  void* args[] = {&tm_q, &tm_x, &scale, &out, &m, &n, &k};
  return cudaLaunchKernelExC(&cfg,
                             reinterpret_cast<const void*>(
                                 int8_mm_sm90_kernel<T>),
                             args);
}

template <typename T>
cudaError_t launch_sm90(const void* x, const int8_t* qt, const float* scale,
                        void* y, int m, int n, int k, cudaStream_t stream) {
  return launch_sm90<T>(x, qt, scale, y, m, n, k, sm90_splits<T>(m, n, k),
                        stream);
}

// What a TMA map describes: K a multiple of 16 (the row stride rule) and
// at least one 128-deep stage, 16-byte aligned bases.
bool tma_ok(const void* x, const int8_t* qt, int k) {
  return k % 16 == 0 && k >= kTmaMinK &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(qt) % 16 == 0;
}

// The general path: one split, 16-byte cp.async where aligned.
template <typename T>
cudaError_t launch_general(const void* x, const int8_t* qt,
                           const float* scale, void* y, int m, int n, int k,
                           cudaStream_t stream) {
  const bool aligned = k % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(qt) % 16 == 0;
  return aligned ? launch_tile<T, true>(x, qt, scale, y, nullptr, m, n, k,
                                        1, stream)
                 : launch_tile<T, false>(x, qt, scale, y, nullptr, m, n, k,
                                         1, stream);
}

}  // namespace

// Floats of f32 workspace the launch for (m, n, k) in `dtype` needs: 0 for
// every shape, since K splits are summed inside one launch. The callers'
// contract keeps the query and the workspace argument.
extern "C" long long int8_mm_workspace_floats(int dtype, int m, int n,
                                              int k) {
  (void)dtype, (void)m, (void)n, (void)k;
  return 0;
}

// dtype: 0 = bf16 x and y (the tensor-core kernels), 1 = f32 (the check
// kernel). x (m, k), qt (n, k) int8 and y (m, n) are contiguous; scale is
// (n,) f32; ws may be null (int8_mm_workspace_floats is 0). Launches on
// `stream`, allocates nothing, and returns the first error of the set-up
// or the launch (0 on success).
extern "C" int int8_mm_launch(const void* x, const int8_t* qt,
                              const float* scale, void* y, float* ws,
                              int dtype, int m, int n, int k, void* stream) {
  (void)ws;
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
  cudaError_t err;
  if (tma_ok(x, qt, k)) {
    switch (sm90_config(m)) {
      case 0: err = launch_sm90<D8>(x, qt, scale, y, m, n, k, st); break;
      case 1: err = launch_sm90<D16>(x, qt, scale, y, m, n, k, st); break;
      case 2: err = launch_sm90<V128>(x, qt, scale, y, m, n, k, st); break;
      default: err = launch_sm90<P256>(x, qt, scale, y, m, n, k, st);
    }
  } else {
    switch (config_for(m)) {
      case 0: err = launch_general<Decode>(x, qt, scale, y, m, n, k, st); break;
      case 1: err = launch_general<Verify>(x, qt, scale, y, m, n, k, st); break;
      default: err = launch_general<Prefill>(x, qt, scale, y, m, n, k, st);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
