// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Flash-attention backward for NVIDIA Hopper (sm_90a), written by hand: a dq
// kernel and a dk/dv kernel.
//
// Replaces four Pallas kernels of container_engine_accelerators_tpu/ops/
// attention.py, launched by _flash_bwd:
//   _bwd_dq_kernel (staged K/V, seq_k <= 8192) and _bwd_dq_stream_kernel
//     (K/V tiles streamed, seq_k > 8192) -> flash_bwd_dq_*_kernel;
//   _bwd_dkv_kernel (staged q/dO, seq_q <= 8192) and _bwd_dkv_stream_kernel
//     (q/dO tiles streamed, seq_q > 8192) -> flash_bwd_dkv_*_kernel.
// The TPU needed two kernels per gradient because its staged variants hold a
// whole sequence in VMEM. Here every block walks its long operand in 64-row
// tiles through shared memory whatever the length, so one kernel covers both
// branches.
//
// Contract (as the JAX kernels): q/dO (B, Hq, Sq, D), k/v (B, Hkv, Sk, D),
// lse/delta (B, Hq, Sq) f32 with delta = rowsum(dO * O); GQA kv_head =
// q_head / (Hq / Hkv); causal compare at GLOBAL positions q_base + i >=
// k_base + j; key columns >= kv_len masked; s = (q . k) * scale in f32;
// p = exp(s - lse); dp = dO . v; ds = p * (dp - delta) * scale.
// Rounding points of the JAX kernels: ds is cast to q's dtype before ds . k
// and ds^T . q, p to dO's dtype before p^T . dO; dq, dk and dv accumulate in
// f32 and are written once in the input dtype.
// Two deliberate differences: (1) a masked key contributes p = 0 explicitly
// (not exp(-1e30 - lse)), so a row that sees no key (lse = -1e30) gets a zero
// gradient, as the port's forward gives it out = 0; (2) the dk/dv kernel runs
// one block per KV head and sums the GQA group inside, in f32, so dk and dv
// are rounded once (the JAX kernel writes per-q-head outputs and its caller
// sums them), and key rows at or past kv_len get dk = dv = 0, the true
// gradient (the JAX caller slices those rows away).
//
// What bounds it on H100. Per visible (q, k) pair the dq kernel does three
// products (s, dp, dq: 6 * D FLOPs) and the dk/dv kernel four (s, dp, dv,
// dk: 8 * D FLOPs); bytes are q, k, v, dO, lse, delta read once and the
// gradients written once. At the Llama-3-8B training shapes (Hq 32, Hkv 8,
// D 128, causal S = 2048..16384) that is hundreds to thousands of FLOPs per
// byte, far above the card's ridge of about 295 (989 TFLOP/s bf16 dense over
// 3.35 TB/s): both kernels are bound by the tensor cores' bf16 rate.
//
// What the design does about it. Every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); scores and probabilities
// never leave registers; each staged tile is reused by the block's 64 rows;
// loops start (dk/dv) or stop (dq) at the causal diagonal and the mask runs
// only on tiles that cross it, the kv_len tail or a ragged edge. The dk/dv
// kernel keeps its two f32 accumulators (dk, dv: 2 x 16 x D per warp) in
// registers and reads the K/V A-fragments from shared memory, which with q
// and dO tiles needs 68 KB of dynamic shared memory at D 128. At D 128 it
// uses 255 registers and spills 8 bytes; rolling up its 16-row loop removes
// the spill but ran slower on H100 in a one-off trial. Not yet done (later
// work): wgmma, TMA and pipelined loads.
//
// bf16 runs those kernels. f32 (for checking) runs plain SIMT kernels: one
// warp per query row (dq) or per key row (dk/dv) that walks the visible
// partners one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows per block and per staged tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // row padding (bf16): conflict-free fragments

__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of a (rows, D) bf16 matrix into shared memory
// (row stride D + kPad), 16 bytes per thread per step; rows past n_rows are
// zero-filled, so ragged edges never read out of bounds.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int row0, int n_rows) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// A fragments (m16 x k16 per head-dim step) of the 16 rows of a shared tile
// that start at `row`, for head-dim step kk.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint16_t* tile,
                                       int stride, int row, int kk) {
  const int lane = threadIdx.x % 32;
  const uint16_t* r0 = tile + (row + lane / 4) * stride + 2 * (lane % 4) +
                       kk * 16;
  const uint16_t* r8 = r0 + 8 * stride;
  a[0] = ld32(r0);
  a[1] = ld32(r8);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r8 + 8);
}

// dq: one block = one (batch * q head, 64-row q tile). Warp w owns q rows
// [16w, 16w + 16); in the mma layout thread (g = lane / 4, t = lane % 4)
// holds rows g and g + 8, columns 2t and 2t + 1 of every 8-wide tile. The q
// and dO rows stay in registers as A fragments; K/V tiles of 64 keys are
// staged in shared memory, 16 keys per inner step.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int hq, int hkv, int sq,
                         int sk, int causal, float sm_scale, int q_base,
                         int k_base, int kv_len) {
  constexpr int kStride = D + kPad;
  constexpr int kDSteps = D / 16;   // k-steps of QK^T and dO V^T over D
  constexpr int kDTiles = D / 8;    // n-tiles of dS K over D
  __shared__ __align__(16) uint16_t ks[kTile * kStride];
  __shared__ __align__(16) uint16_t vs[kTile * kStride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq, kvh = (bh % hq) / (hq / hkv);
  const uint16_t* kg = k + ((size_t)b * hkv + kvh) * sk * D;
  const uint16_t* vg = v + ((size_t)b * hkv + kvh) * sk * D;

  // Stage q through ks and dO through vs; keep both as A fragments.
  load_tile<D>(ks, q + (size_t)bh * sq * D, q0, sq);
  load_tile<D>(vs, dout + (size_t)bh * sq * D, q0, sq);
  __syncthreads();
  uint32_t qa[kDSteps][4], da[kDSteps][4];
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    a_frag(qa[kk], ks, kStride, warp * 16, kk);
    a_frag(da[kk], vs, kStride, warp * 16, kk);
  }
  __syncthreads();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    row_lse[r] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    row_delta[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }

  // Key columns [0, n_cols) hold every key this tile can see: up to the
  // causal diagonal of its last real row, in global positions.
  const int q_first = q_base + q0;
  const int q_last = q_base + min(q0 + kTile, sq) - 1;
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_last - k_base + 1));
  const int n_tiles = (n_cols + kTile - 1) / kTile;
  const int row_g = q0 + warp * 16 + g;  // local row g; row g + 8 is +8

  float acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    load_tile<D>(ks, kg, k0, sk);
    load_tile<D>(vs, vg, k0, sk);
    __syncthreads();
    const bool mask = (causal && k_base + k0 + kTile - 1 > q_first) ||
                      k0 + kTile > kv_len || q0 + kTile > sq;

#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      // Scores and dO V^T for keys [16j, 16j + 16) of the tile.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
        const uint16_t* kr = ks + ((2 * j + h) * 8 + g) * kStride + 2 * t;
        const uint16_t* vr = vs + ((2 * j + h) * 8 + g) * kStride + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kDSteps; ++kk) {
          mma_16816(s[h], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
          mma_16816(dp[h], da[kk], ld32(vr + kk * 16),
                    ld32(vr + kk * 16 + 8));
        }
      }
      // ds = p * (dp - delta) * scale, with p = 0 on masked keys.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          bool vis = true;
          if (mask) {
            const int col = k0 + (2 * j + h) * 8 + 2 * t + (i & 1);
            const int row = row_g + 8 * r;
            vis = !((causal && q_base + row < k_base + col) ||
                    col >= kv_len || row >= sq);
          }
          const float p = vis ? expf(s[h][i] * sm_scale - row_lse[r]) : 0.f;
          s[h][i] = p * (dp[h][i] - row_delta[r]) * sm_scale;
        }
      }
      // acc += dS K: the accumulator layout of dS is its A-fragment layout;
      // B fragments of K pair two keys of one head-dim column.
      const uint32_t dsa[4] = {
          pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
          pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3]),
      };
      const uint16_t* kc0 = ks + (16 * j + 2 * t) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        const uint16_t* kc = kc0 + dn * 8;
        mma_16816(acc[dn], dsa, pack_u16(kc[0], kc[kStride]),
                  pack_u16(kc[8 * kStride], kc[9 * kStride]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= sq) continue;
    uint16_t* orow = dq + ((size_t)bh * sq + row) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_bf16(acc[dn][2 * r], acc[dn][2 * r + 1]);
    }
  }
}

// dk/dv: one block = one (batch * KV head, 64-key tile). Warp w owns key rows
// [16w, 16w + 16). The block loops over the group's q heads and, for each,
// over the 64-row q tiles from the causal diagonal on, in K-major
// orientation (scores s^T: keys x queries). dk and dv accumulate in f32
// registers across the whole group.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int hq, int hkv, int sq, int sk, int causal,
                          float sm_scale, int q_base, int k_base,
                          int kv_len) {
  constexpr int kStride = D + kPad;
  constexpr int kDSteps = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;
  uint16_t* vs = ks + kTile * kStride;
  uint16_t* qs = vs + kTile * kStride;
  uint16_t* dos = qs + kTile * kStride;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * kStride);
  float* delta_s = lse_s + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kTile;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;
  load_tile<D>(ks, k + (size_t)bkv * sk * D, k0, sk);
  load_tile<D>(vs, v + (size_t)bkv * sk * D, k0, sk);

  // The first q tile with a row that sees the tile's first key (global
  // positions, clamped at 0); a tile wholly past kv_len has no work.
  const int n_qt = (sq + kTile - 1) / kTile;
  int first_qt = causal ? max(0, k_base + k0 - q_base) / kTile : 0;
  if (k0 >= kv_len) first_qt = n_qt;
  const int key_g = k0 + warp * 16 + g;  // local key g; key g + 8 is +8

  float acc_dk[kDTiles][4], acc_dv[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[dn][i] = acc_dv[dn][i] = 0.f;
  }

  for (int hg = 0; hg < group; ++hg) {
    const size_t bh = (size_t)b * hq + (size_t)kvh * group + hg;
    const uint16_t* qg = q + bh * sq * D;
    const uint16_t* dog = dout + bh * sq * D;
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(qs, qg, q0, sq);
      load_tile<D>(dos, dog, q0, sq);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool in = q0 + i < sq;
        lse_s[i] = in ? lse[bh * sq + q0 + i] : 0.f;
        delta_s[i] = in ? delta[bh * sq + q0 + i] : 0.f;
      }
      __syncthreads();
      const bool mask = (causal && q_base + q0 < k_base + k0 + kTile - 1) ||
                        k0 + kTile > kv_len || q0 + kTile > sq;

#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        // s^T and V dO^T for query rows [16j, 16j + 16) of the q tile.
        float s[2][4], dp[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[h][i] = dp[h][i] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kDSteps; ++kk) {
          uint32_t ka[4], va[4];
          a_frag(ka, ks, kStride, warp * 16, kk);
          a_frag(va, vs, kStride, warp * 16, kk);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = ((2 * j + h) * 8 + g) * kStride + 2 * t + kk * 16;
            mma_16816(s[h], ka, ld32(qs + row), ld32(qs + row + 8));
            mma_16816(dp[h], va, ld32(dos + row), ld32(dos + row + 8));
          }
        }
        float p[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qc = (2 * j + h) * 8 + 2 * t + (i & 1);  // in the tile
            bool vis = true;
            if (mask) {
              const int key = key_g + 8 * (i >> 1);
              const int row = q0 + qc;
              vis = !((causal && q_base + row < k_base + key) ||
                      key >= kv_len || row >= sq);
            }
            p[h][i] = vis ? expf(s[h][i] * sm_scale - lse_s[qc]) : 0.f;
            s[h][i] = p[h][i] * (dp[h][i] - delta_s[qc]) * sm_scale;
          }
        }
        const uint32_t pa[4] = {
            pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3]),
        };
        const uint32_t dsa[4] = {
            pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3]),
        };
        // dv += P^T dO and dk += dS^T Q: B fragments pair two query rows of
        // one head-dim column.
        const uint16_t* dc0 = dos + (16 * j + 2 * t) * kStride + g;
        const uint16_t* qc0 = qs + (16 * j + 2 * t) * kStride + g;
#pragma unroll
        for (int dn = 0; dn < kDTiles; ++dn) {
          const uint16_t* dc = dc0 + dn * 8;
          const uint16_t* qc = qc0 + dn * 8;
          mma_16816(acc_dv[dn], pa, pack_u16(dc[0], dc[kStride]),
                    pack_u16(dc[8 * kStride], dc[9 * kStride]));
          mma_16816(acc_dk[dn], dsa, pack_u16(qc[0], qc[kStride]),
                    pack_u16(qc[8 * kStride], qc[9 * kStride]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_g + 8 * r;
    if (key >= sk) continue;
    const size_t off = ((size_t)bkv * sk + key) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      *reinterpret_cast<uint32_t*>(dk + off + dn * 8) =
          pack_bf16(acc_dk[dn][2 * r], acc_dk[dn][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dn * 8) =
          pack_bf16(acc_dv[dn][2 * r], acc_dv[dn][2 * r + 1]);
    }
  }
}

constexpr int kRowsPerBlock = 8;  // f32 check kernels: one warp per row

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// f32 dq: one warp per query row, lane holds D / 32 columns; the row's
// visible keys are [0, n_cols), walked one at a time.
template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int hq, int hkv, int sq,
                        int sk, int causal, float sm_scale, int q_base,
                        int k_base, int kv_len) {
  constexpr int kPer = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= sq) return;
  const int bh = blockIdx.y;
  const int b = bh / hq, kvh = (bh % hq) / (hq / hkv);
  const float* kg = k + ((size_t)b * hkv + kvh) * sk * D;
  const float* vg = v + ((size_t)b * hkv + kvh) * sk * D;
  const size_t off = ((size_t)bh * sq + row) * D;
  float qv[kPer], dov[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qv[i] = q[off + lane + 32 * i];
    dov[i] = dout[off + lane + 32 * i];
    acc[i] = 0.f;
  }
  const float row_lse = lse[(size_t)bh * sq + row];
  const float row_delta = delta[(size_t)bh * sq + row];
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_base + row - k_base + 1));
  for (int j = 0; j < n_cols; ++j) {
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s += qv[i] * kg[(size_t)j * D + lane + 32 * i];
      dp += dov[i] * vg[(size_t)j * D + lane + 32 * i];
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    const float p = expf(s * sm_scale - row_lse);
    const float ds = p * (dp - row_delta) * sm_scale;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] += ds * kg[(size_t)j * D + lane + 32 * i];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) dq[off + lane + 32 * i] = acc[i];
}

// f32 dk/dv: one warp per key row of one KV head; walks the group's q heads
// and, in each, the query rows that see the key.
template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int hq, int hkv, int sq, int sk, int causal,
                         float sm_scale, int q_base, int k_base, int kv_len) {
  constexpr int kPer = D / 32;
  const int lane = threadIdx.x % 32;
  const int key = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (key >= sk) return;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;
  const size_t off = ((size_t)bkv * sk + key) * D;
  float kv_[kPer], vv[kPer], adk[kPer], adv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    kv_[i] = k[off + lane + 32 * i];
    vv[i] = v[off + lane + 32 * i];
    adk[i] = adv[i] = 0.f;
  }
  const int first = causal ? max(0, k_base + key - q_base) : 0;
  for (int hg = 0; key < kv_len && hg < group; ++hg) {
    const size_t bh = (size_t)b * hq + (size_t)kvh * group + hg;
    for (int row = first; row < sq; ++row) {
      const float* qr = q + (bh * sq + row) * D;
      const float* dr = dout + (bh * sq + row) * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s += kv_[i] * qr[lane + 32 * i];
        dp += vv[i] * dr[lane + 32 * i];
      }
      s = warp_sum(s);
      dp = warp_sum(dp);
      const float p = expf(s * sm_scale - lse[bh * sq + row]);
      const float ds = p * (dp - delta[bh * sq + row]) * sm_scale;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        adv[i] += p * dr[lane + 32 * i];
        adk[i] += ds * qr[lane + 32 * i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dk[off + lane + 32 * i] = adk[i];
    dv[off + lane + 32 * i] = adv[i];
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * kTile * (D + kPad) * 2 + 2 * kTile * 4;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int dtype,
              int batch, int hq, int hkv, int sq, int sk, int causal,
              float sm_scale, int q_base, int k_base, int kv_len,
              cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((sq + kTile - 1) / kTile, batch * hq);
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        lse, delta, static_cast<uint16_t*>(dq), hq, hkv, sq, sk, causal,
        sm_scale, q_base, k_base, kv_len);
  } else {
    const dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, batch * hq);
    flash_bwd_dq_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), hq, hkv, sq, sk, causal, sm_scale,
        q_base, k_base, kv_len);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int dtype, int batch, int hq, int hkv, int sq, int sk,
               int causal, float sm_scale, int q_base, int k_base,
               int kv_len, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int kSmem = dkv_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sk + kTile - 1) / kTile, batch * hkv);
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, kSmem, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        lse, delta, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
        hq, hkv, sq, sk, causal, sm_scale, q_base, k_base, kv_len);
  } else {
    const dim3 grid((sk + kRowsPerBlock - 1) / kRowsPerBlock, batch * hkv);
    flash_bwd_dkv_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv,
        sq, sk, causal, sm_scale, q_base, k_base, kv_len);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int dtype, int hq, int hkv) {
  return (dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv;
}

}  // namespace

// dtype: 0 = bf16 (tensor-core kernels), 1 = f32 (check kernels). Tensors
// are contiguous and 16-byte aligned (the Python wrapper checks); lse and
// delta are f32. Each call launches one kernel on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int dtype, int batch, int hq,
                                   int hkv, int sq, int sk, int d, int causal,
                                   float sm_scale, int q_base, int k_base,
                                   int kv_len, void* stream) {
  if (bad_args(dtype, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    return launch_dq<32>(q, k, v, dout, lse, delta, dq, dtype, batch, hq, hkv,
                         sq, sk, causal, sm_scale, q_base, k_base, kv_len, st);
  }
  if (d == 64) {
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, dtype, batch, hq, hkv,
                         sq, sk, causal, sm_scale, q_base, k_base, kv_len, st);
  }
  if (d == 128) {
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, dtype, batch, hq,
                          hkv, sq, sk, causal, sm_scale, q_base, k_base,
                          kv_len, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int dtype, int batch,
                                    int hq, int hkv, int sq, int sk, int d,
                                    int causal, float sm_scale, int q_base,
                                    int k_base, int kv_len, void* stream) {
  if (bad_args(dtype, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, dtype, batch, hq,
                          hkv, sq, sk, causal, sm_scale, q_base, k_base,
                          kv_len, st);
  }
  if (d == 64) {
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, dtype, batch, hq,
                          hkv, sq, sk, causal, sm_scale, q_base, k_base,
                          kv_len, st);
  }
  if (d == 128) {
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, dtype, batch,
                           hq, hkv, sq, sk, causal, sm_scale, q_base, k_base,
                           kv_len, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
