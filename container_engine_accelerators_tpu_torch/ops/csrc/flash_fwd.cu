// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Flash-attention forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces container_engine_accelerators_tpu/ops/attention.py:_attn_kernel
// (the Pallas kernel launched by _flash_fwd) and _attn_stream_kernel (its
// streaming sibling past 8192 keys): one kernel covers both. Same contract:
// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), GQA with kv_head = q_head /
// (Hq / Hkv); causal compare at GLOBAL positions q_base + i >= k_base + j;
// key columns >= kv_len masked; finite NEG_INF = -1e30; p cast to the input
// dtype before the PV product; out = acc / max(l, 1e-30), lse = m +
// log(max(l, 1e-30)) in f32. A masked key contributes p = 0, so a row that
// sees no key gives out = 0 and lse = -1e30 whatever the tiling.
//
// The base. The Pallas kernel reads [q_base, k_base, kv_len] at run time
// from `base_ref`, scalar prefetch in device memory, so the speculative
// verify can run it at a traced decode position. Here the launch takes
// either the three as by-value arguments (every training and prefill
// caller) or `base`, a device int32 (B, 3) array of one [q_base, k_base,
// kv_len] per batch row. With `base`, a block reads its row's three values
// at entry and clamps kv_len to [0, Sk] itself; nothing on the host reads
// them, so a CUDA graph that captured the launch attends at whatever
// position the array holds when it replays. The TMA maps and the grid do
// not depend on the base.
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
// What the design does about it (bf16, head dims 32, 64 and 128):
// - Only wgmma reaches Hopper's tensor-core rate, so both products are
//   wgmma: S = Q K^T as m64n128k16 with Q and K read from shared memory
//   through descriptors, O += P V as m64nDk16 with P in registers (the f32
//   accumulator layout of S is the register layout of the A operand, so P
//   needs no shuffle) and V read MN-major (the descriptor's transpose bit;
//   V stays D-contiguous as it lies in memory).
// - Loads overlap the math: a producer warpgroup, one thread of which
//   issues TMA tile loads, keeps a 2-stage ring of 128-key K and V tiles
//   full, signalled through mbarriers (full: expect-tx bytes; empty: the
//   consumers' arrivals after their PV product of that stage). TMA writes
//   the swizzled layout wgmma reads and zero-fills rows past Sq or Sk, so
//   nothing is padded. The producer hands its registers to the consumers
//   (setmaxnreg).
// - K/V reuse: a block holds 128 query rows, two consumer warpgroups of 64
//   rows, so each K/V byte brought from L2 serves 128 rows.
// - The softmax, not the loads, is what the consumers wait on (phase
//   clocks of ops/flash_phases.py: waits for K and V take about 6 % of
//   their cycles). With two consumer warps a scheduler little latency is
//   hidden, so it keeps few instructions and short chains: the exp2 domain
//   (sm_scale * log2(e) folded in, lse = (m2 + log2 l) * ln 2), the row
//   max over raw scores in 4 partial maxima, p = exp2 of one FFMA, 4
//   partial sums, and masked scores set to -inf only on masked tiles.
// - Causal work only: q tiles with the most causal work launch first; the
//   loop stops at the last tile the causal diagonal of the block's last real
//   row reaches, and the mask runs only on tiles that cross the diagonal or
//   the kv_len tail.
// Tried on the card with the first, longer softmax and slower there, so
// left out: ping-pong turns of the two consumer warpgroups at the tensor
// cores, and issuing Q K^T of tile kt with P V of tile kt - 1 to overlap
// the softmax inside a warpgroup. Left for later, each to be tried only
// with a measurement: those two again with this softmax; a persistent
// grid; a TMA store of O; packing a GQA group's q heads into one block.
//
// f32 (for checking) runs a plain SIMT kernel with one warp per query row
// that walks the visible keys one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kBlockQ = 128;  // query rows per block: two consumers x 64
constexpr int kBlockK = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared-memory layout of one block for head dim D. Every tile (the q
// tile, and each stage's K and V tile) is 128 rows of D bf16 values in
// TMA's swizzled layout: D / kAtomCols atoms side by side, each 128 rows of
// kRowBytes (128-byte swizzle; 64-byte at D 32, whose rows are 64 bytes).
template <int D>
struct Layout {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kAtomCols = kRowBytes / 2;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kAtomBytes = 128 * kRowBytes;
  static constexpr int kTileBytes = 128 * D * 2;
  static constexpr int kSwizzle =
      kRowBytes == 128 ? sm90::kSwizzle128B : sm90::kSwizzle64B;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;                   // + stage * tile
  static constexpr int kV = kK + kStages * kTileBytes;    // + stage * tile
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kNumBars = 1 + 3 * kStages;        // q, full k/v, empty
  // Barriers, and slack to align the dynamic base to 1024 bytes.
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Phases of a consumer warp, for the instrumented build: with
// -DFLASH_FWD_PHASE_CLOCKS (ops/flash_phases.py) each consumer warp adds
// the clock64 cycles it spends in each phase to a grid-wide total; without
// it PhaseClock is empty and compiles away.
enum Phase { kWaitQ, kWaitK, kQK, kSoftmax, kWaitV, kPV, kEpilogue, kPhases };

#ifdef FLASH_FWD_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[kPhases];

struct PhaseClock {
  long long last;
  unsigned long long sum[kPhases] = {};
  __device__ PhaseClock() { last = clock64(); }
  __device__ void mark(Phase phase) {
    const long long now = clock64();
    sum[phase] += now - last;
    last = now;
  }
  __device__ void flush(int lane) {
    if (lane != 0) return;
    for (int i = 0; i < kPhases; ++i) atomicAdd(&g_phase_cycles[i], sum[i]);
  }
};
#else
struct PhaseClock {
  __device__ void mark(Phase) {}
  __device__ void flush(int) {}
};
#endif

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One block = one (batch * q head, 128-row q tile). Warpgroup 0 loads;
// warpgroups 1 and 2 each own 64 query rows. In a consumer, warp w and
// lane (g = lane / 4, t = lane % 4) hold rows 16w + g and 16w + g + 8 of
// their 64, and columns 8j + 2t, 8j + 2t + 1 of every 8-column chunk j.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      uint16_t* __restrict__ out, float* __restrict__ lse,
                      int hq, int hkv, int sq, int sk, int causal,
                      float scale_log2, int q_base_arg, int k_base_arg,
                      int kv_len_arg, const int* __restrict__ base) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heavy tiles first
  const int bh = blockIdx.y;
  const int kv_head = (bh / hq) * hkv + (bh % hq) / (hq / hkv);

  // The row's base, read once by one thread before the barrier below: the
  // producer and the consumers then walk the same number of tiles.
  __shared__ int base_s[3];
  if (threadIdx.x == 0) {
    if (base != nullptr) {
      const int* row = base + 3 * (bh / hq);
      base_s[0] = row[0];
      base_s[1] = row[1];
      base_s[2] = min(max(row[2], 0), sk);
    } else {
      base_s[0] = q_base_arg;
      base_s[1] = k_base_arg;
      base_s[2] = kv_len_arg;
    }
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty + s, kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int q_base = base_s[0], k_base = base_s[1], kv_len = base_s[2];

  // Key columns [0, n_cols) hold every key this tile can see: up to the
  // causal diagonal of its last real row, in global positions.
  const int q_last = q_base + min(q0 + kBlockQ, sq) - 1;
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_last - k_base + 1));
  const int n_tiles = (n_cols + kBlockK - 1) / kBlockK;

  if (threadIdx.x < 128) {
    // Producer. Round r of a stage waits for the consumers to release
    // round r - 1 (the first round's wait passes at once).
    sm90::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::mbar_arrive_expect_tx(bar_q, L::kTileBytes);
      for (int a = 0; a < L::kAtoms; ++a) {
        sm90::tma_load_3d(smem + L::kQ + a * L::kAtomBytes, &tm_q, bar_q,
                          a * L::kAtomCols, q0, bh);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        sm90::mbar_wait(empty + st, ((kt / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full_k + st, L::kTileBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          sm90::tma_load_3d(
              smem + L::kK + st * L::kTileBytes + a * L::kAtomBytes, &tm_k,
              full_k + st, a * L::kAtomCols, kt * kBlockK, kv_head);
        }
        sm90::mbar_arrive_expect_tx(full_v + st, L::kTileBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          sm90::tma_load_3d(
              smem + L::kV + st * L::kTileBytes + a * L::kAtomBytes, &tm_v,
              full_v + st, a * L::kAtomCols, kt * kBlockK, kv_head);
        }
      }
    }
  } else {
    sm90::regs_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;  // rows [64c, 64c + 64) of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * c + 16 * warp + g;  // and row0 + 8
    const int qpos0 = q_base + row0;
    const int first_qpos = q_base + q0 + 64 * c;
    const uint8_t* q_s = smem + L::kQ + 64 * c * L::kRowBytes;
    constexpr uint32_t kSbo = 8 * L::kRowBytes;

    float s[64];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, log2 domain
    float l[2] = {0.f, 0.f};          // this thread's partial row sums

    PhaseClock phases;
    if (n_tiles > 0) sm90::mbar_wait(bar_q, 0);
    phases.mark(kWaitQ);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      const uint32_t phase = (kt / kStages) & 1;
      const int k0 = kt * kBlockK;
      const uint8_t* k_s = smem + L::kK + st * L::kTileBytes;
      const uint8_t* v_s = smem + L::kV + st * L::kTileBytes;

      // S = Q K^T: D / 16 k-steps; a step is 32 bytes into an atom's row.
      sm90::mbar_wait(full_k + st, phase);
      phases.mark(kWaitK);
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk * 32 / L::kRowBytes) * L::kAtomBytes +
                        (kk * 32) % L::kRowBytes;
        sm90::WgmmaSS<128, 0>::mma(
            s, sm90::make_desc(q_s + off, 16, kSbo, L::kSwizzle),
            sm90::make_desc(k_s + off, 16, kSbo, L::kSwizzle), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      phases.mark(kQK);

      // Online softmax in the exp2 domain, with short dependency chains
      // (two consumer warps a scheduler hide little latency): the row max
      // over the raw scores (scale > 0 commutes with max) in 4 partial
      // maxima a row, p = exp2(s * scale - m) as one FFMA and ex2, the sum
      // in 4 partial sums a row. On a tile that needs the mask, a masked
      // score becomes -inf: it never raises the max and gives p = 0, and a
      // row that has seen no key keeps m = NEG_INF (exp2(-inf + 1e30) = 0).
      const bool mask = (causal && k_base + k0 + kBlockK - 1 > first_qpos) ||
                        k0 + kBlockK > kv_len;
      if (mask) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + 8 * j + 2 * t + (i & 1);
            const int row_pos = qpos0 + 8 * (i >> 1);
            if ((causal && row_pos < k_base + col) || col >= kv_len) {
              s[4 * j + i] = -INFINITY;
            }
          }
        }
      }
      float part[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int a = 0; a < 4; ++a) part[r][a] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& mx = part[i >> 1][j % 4];
          mx = fmaxf(mx, s[4 * j + i]);
        }
      }
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(part[r][0], part[r][1]),
                         fmaxf(part[r][2], part[r][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        alpha[r] = exp2_approx(m[r] - m_new);  // finite - finite: no NaN
        m[r] = m_new;
        neg_m[r] = -m_new;
#pragma unroll
        for (int a = 0; a < 4; ++a) part[r][a] = 0.f;
      }
      uint32_t p[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float pj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pj[i] = exp2_approx(fmaf(s[4 * j + i], scale_log2, neg_m[i >> 1]));
          part[i >> 1][j % 4] += pj[i];
        }
        // Chunks 2k and 2k + 1 form the A registers of the k-th k16 step.
        p[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(pj[0], pj[1]);
        p[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(pj[2], pj[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] +
               ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      phases.mark(kSoftmax);

      // O += P V: 8 k-steps of 16 keys; V MN-major, atoms along D.
      sm90::mbar_wait(full_v + st, phase);
      phases.mark(kWaitV);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        sm90::WgmmaRS<D, 1>::mma(
            o, a,
            sm90::make_desc(v_s + kk * 16 * L::kRowBytes, L::kAtomBytes, kSbo,
                            L::kSwizzle),
            1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
      phases.mark(kPV);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      uint16_t* orow = out + ((size_t)bh * sq + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
      // A row that saw a key has l >= 1 (its max contributes exp2(0)).
      if (t == 0) {
        lse[(size_t)bh * sq + row] =
            m[r] == kNegInf ? kNegInf : (m[r] + log2f(l[r])) * kLn2;
      }
    }
    phases.mark(kEpilogue);
    phases.flush(lane);
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
                     int kv_len, const int* __restrict__ base) {
  constexpr int kPer = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= sq) return;
  const int bh = blockIdx.y;
  const int b = bh / hq, kvh = (bh % hq) / (hq / hkv);
  if (base != nullptr) {
    q_base = base[3 * b];
    k_base = base[3 * b + 1];
    kv_len = min(max(base[3 * b + 2], 0), sk);
  }
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
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int batch, int hq, int hkv,
                        int sq, int sk, int causal, float sm_scale,
                        int q_base, int k_base, int kv_len, const int* base,
                        cudaStream_t stream) {
  using L = Layout<D>;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_fwd_sm90_kernel<D>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  // With no keys (Sk 0) no K/V tile is ever loaded; q stands in for the
  // K/V maps so that they still describe real memory.
  if (sk == 0) k = v = q;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!host::encode_bf16_rows(&tm_q, q, D, sq, batch * hq, kBlockQ) ||
      !host::encode_bf16_rows(&tm_k, k, D, sk > 0 ? sk : 1, batch * hkv,
                              kBlockK) ||
      !host::encode_bf16_rows(&tm_v, v, D, sk > 0 ? sk : 1, batch * hkv,
                              kBlockK)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<uint16_t*>(out), lse, hq, hkv, sq, sk,
      causal, sm_scale * kLog2e, q_base, k_base, kv_len, base);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int dtype, int batch, int hq, int hkv, int sq,
                   int sk, int causal, float sm_scale, int q_base, int k_base,
                   int kv_len, const int* base, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_bf16<D>(q, k, v, out, lse, batch, hq, hkv, sq, sk, causal,
                          sm_scale, q_base, k_base, kv_len, base, stream);
  }
  const dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, batch * hq);
  flash_fwd_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, hq, hkv,
      sq, sk, causal, sm_scale, q_base, k_base, kv_len, base);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = bf16 (the Hopper kernel), 1 = f32 (check kernel). Tensors are
// contiguous and 16-byte aligned (the Python wrapper checks). `base`, when
// not null, is a device int32 (batch, 3) array of [q_base, k_base, kv_len]
// per batch row, read by the kernel in place of the three ints. Launches on
// `stream`, allocates nothing, and returns the first error of the set-up
// or cudaGetLastError() after the launch (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int dtype, int batch,
                                int hq, int hkv, int sq, int sk, int d,
                                int causal, float sm_scale, int q_base,
                                int k_base, int kv_len, const int* base,
                                void* stream) {
  if ((dtype != 0 && dtype != 1) || hkv <= 0 || hq % hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 32) {
    err = launch<32>(q, k, v, out, lse, dtype, batch, hq, hkv, sq, sk, causal,
                     sm_scale, q_base, k_base, kv_len, base, st);
  } else if (d == 64) {
    err = launch<64>(q, k, v, out, lse, dtype, batch, hq, hkv, sq, sk, causal,
                     sm_scale, q_base, k_base, kv_len, base, st);
  } else if (d == 128) {
    err = launch<128>(q, k, v, out, lse, dtype, batch, hq, hkv, sq, sk,
                      causal, sm_scale, q_base, k_base, kv_len, base, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef FLASH_FWD_PHASE_CLOCKS
// Copies the per-phase cycle totals (kPhases values) to `host` and zeroes
// them; synchronous. Returns a cudaError_t (0 on success).
extern "C" int flash_fwd_phase_cycles(unsigned long long* host) {
  cudaError_t err =
      cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  if (err == cudaSuccess) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
