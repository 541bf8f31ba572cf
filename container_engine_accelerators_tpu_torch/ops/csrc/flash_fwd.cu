// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Flash-attention forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces container_engine_accelerators_tpu/ops/attention.py:_attn_kernel
// (the Pallas kernel launched by _flash_fwd). Same contract: q (B, Hq, Sq, D),
// k/v (B, Hkv, Sk, D), GQA with kv_head = q_head / (Hq / Hkv); causal compare
// at GLOBAL positions q_base + i >= k_base + j; key columns >= kv_len masked;
// finite NEG_INF = -1e30; p cast to the input dtype before the PV product;
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)) in f32. A masked
// key contributes p = 0, so a row that sees no key gives out = 0 and
// lse = -1e30 whatever the tiling.
//
// What bounds it on H100. Work = 4 * D FLOPs per attended (q, k) pair (QK^T
// and PV, 2 * D each): B * Hq * Sq * Sk pairs non-causal, about half of that
// causal at Sq = Sk with q_base = 0. Bytes = q + k + v + out + lse, each once.
// At the Llama-3-8B prefill shapes (Hq 32, Hkv 8, D 128, causal Sq = Sk = S)
// that is about 0.4 * S FLOPs per byte; the card's ridge is 989 TFLOP/s bf16
// dense over 3.35 TB/s of HBM, about 295 FLOPs per byte. So a prefill bucket
// of 512 is bound by HBM, and from about S = 740 on (the 1024..8192 buckets)
// the kernel is bound by the tensor cores' bf16 rate.
//
// What the design does about it. Both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); the S x S scores never leave
// registers; each K/V tile is staged once in shared memory and reused by the
// block's 64 query rows; q tiles with the most causal work launch first; the
// loop stops at the last tile the causal diagonal reaches, and the mask runs
// only on tiles that cross the diagonal or the kv_len tail. Not yet done
// (later work): wgmma, TMA and warp-specialised pipelining of the K/V loads.
//
// bf16 runs that kernel. f32 (for checking) runs a plain SIMT kernel with
// one warp per query row that walks the visible keys one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;   // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;   // keys per shared-memory K/V tile
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // row padding (bf16): conflict-free fragments

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
  for (int i = threadIdx.x; i < kBlockK * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// One block = one (batch * q head, 64-row q tile). Warp w owns rows
// [16w, 16w + 16); in the mma layout thread (g = lane / 4, t = lane % 4)
// holds rows g and g + 8, columns 2t and 2t + 1 of every 8-wide tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      uint16_t* __restrict__ out, float* __restrict__ lse,
                      int hq, int hkv, int sq, int sk, int causal,
                      float sm_scale, int q_base, int k_base, int kv_len) {
  constexpr int kStride = D + kPad;
  constexpr int kDSteps = D / 16;        // k-steps of QK^T over the head dim
  constexpr int kDTiles = D / 8;         // n-tiles of PV over the head dim
  constexpr int kKTiles = kBlockK / 8;   // n-tiles of QK^T over the keys
  __shared__ __align__(16) uint16_t ks[kBlockK * kStride];
  __shared__ __align__(16) uint16_t vs[kBlockK * kStride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq, kvh = (bh % hq) / (hq / hkv);
  const uint16_t* qg = q + (size_t)bh * sq * D;
  const uint16_t* kg = k + ((size_t)b * hkv + kvh) * sk * D;
  const uint16_t* vg = v + ((size_t)b * hkv + kvh) * sk * D;

  // Stage the q tile through the K buffer; keep it as A fragments.
  load_tile<D>(ks, qg, q0, sq);
  __syncthreads();
  uint32_t qa[kDSteps][4];
  {
    const uint16_t* r0 = ks + (warp * 16 + g) * kStride + 2 * t;
    const uint16_t* r8 = r0 + 8 * kStride;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      qa[kk][0] = ld32(r0 + kk * 16);
      qa[kk][1] = ld32(r8 + kk * 16);
      qa[kk][2] = ld32(r0 + kk * 16 + 8);
      qa[kk][3] = ld32(r8 + kk * 16 + 8);
    }
  }
  __syncthreads();

  // Key columns [0, n_cols) hold every key this tile can see: up to the
  // causal diagonal of its last real row, in global positions.
  const int q_first = q_base + q0;
  const int q_last = q_base + min(q0 + kBlockQ, sq) - 1;
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_last - k_base + 1));
  const int n_tiles = (n_cols + kBlockK - 1) / kBlockK;
  const int qpos = q_first + warp * 16 + g;  // row g; row g + 8 is qpos + 8

  float acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    load_tile<D>(ks, kg, k0, sk);
    load_tile<D>(vs, vg, k0, sk);
    __syncthreads();

    float s[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint16_t* kr = ks + (nt * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        mma_16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }

    const bool mask = (causal && k_base + k0 + kBlockK - 1 > q_first) ||
                      k0 + kBlockK > kv_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * sm_scale;
        if (mask) {
          const int col = k0 + nt * 8 + 2 * t + (i & 1);
          const int row_pos = qpos + (i >> 1) * 8;
          if ((causal && row_pos < k_base + col) || col >= kv_len) {
            x = kNegInf;
          }
        }
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        // m == NEG_INF: every key so far is masked, and masked keys
        // contribute nothing (elsewhere exp(-1e30 - m) is already 0).
        const float p = m[r] == kNegInf ? 0.f : expf(s[nt][i] - m[r]);
        s[nt][i] = p;
        l[r] += p;
      }
    }
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // acc += P V. The scores' accumulator layout is the A-fragment layout
    // of P; B fragments of V pair two keys of one head-dim column.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]),
          pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]),
      };
      const uint16_t* v0 = vs + (16 * j + 2 * t) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        const uint16_t* vc = v0 + dn * 8;
        const uint32_t b0 = pack_u16(vc[0], vc[kStride]);
        const uint32_t b1 = pack_u16(vc[8 * kStride], vc[9 * kStride]);
        mma_16816(acc[dn], pa, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float l_safe = fmaxf(l[r], 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    uint16_t* orow = out + ((size_t)bh * sq + row) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8) = pack_bf16(
          acc[dn][2 * r] / l_safe, acc[dn][2 * r + 1] / l_safe);
    }
    if (t == 0) lse[(size_t)bh * sq + row] = m[r] + logf(l_safe);
  }
}

// f32 check path: one warp per query row, lane holds D / 32 columns; the
// row's visible keys are [0, n_cols), walked one at a time.
constexpr int kRowsPerBlock = 8;

template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                     int causal, float sm_scale, int q_base, int k_base,
                     int kv_len) {
  constexpr int kPer = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= sq) return;
  const int bh = blockIdx.y;
  const int b = bh / hq, kvh = (bh % hq) / (hq / hkv);
  const float* kg = k + ((size_t)b * hkv + kvh) * sk * D;
  const float* vg = v + ((size_t)b * hkv + kvh) * sk * D;
  const size_t q_off = ((size_t)bh * sq + row) * D;

  float qv[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qv[i] = q[q_off + lane + 32 * i];
    acc[i] = 0.f;
  }
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_base + row - k_base + 1));
  float m = kNegInf, l = 0.f;
  for (int j = 0; j < n_cols; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) s += qv[i] * kg[(size_t)j * D + lane + 32 * i];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    s *= sm_scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      acc[i] = acc[i] * alpha + p * vg[(size_t)j * D + lane + 32 * i];
    }
    m = m_new;
  }
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[q_off + lane + 32 * i] = acc[i] / l_safe;
  if (lane == 0) lse[(size_t)bh * sq + row] = m + logf(l_safe);
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* out,
            float* lse, int dtype, int batch, int hq, int hkv, int sq,
            int sk, int causal, float sm_scale, int q_base, int k_base,
            int kv_len, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
    flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), lse,
        hq, hkv, sq, sk, causal, sm_scale, q_base, k_base, kv_len);
  } else {
    const dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, batch * hq);
    flash_fwd_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, hq,
        hkv, sq, sk, causal, sm_scale, q_base, k_base, kv_len);
  }
}

}  // namespace

// dtype: 0 = bf16 (tensor-core kernel), 1 = f32 (check kernel). Tensors are
// contiguous and 16-byte aligned (the Python wrapper checks). Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int dtype, int batch,
                                int hq, int hkv, int sq, int sk, int d,
                                int causal, float sm_scale, int q_base,
                                int k_base, int kv_len, void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    launch<32>(q, k, v, out, lse, dtype, batch, hq, hkv, sq, sk, causal,
               sm_scale, q_base, k_base, kv_len, st);
  } else if (d == 64) {
    launch<64>(q, k, v, out, lse, dtype, batch, hq, hkv, sq, sk, causal,
               sm_scale, q_base, k_base, kv_len, st);
  } else if (d == 128) {
    launch<128>(q, k, v, out, lse, dtype, batch, hq, hkv, sq, sk, causal,
                sm_scale, q_base, k_base, kv_len, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
