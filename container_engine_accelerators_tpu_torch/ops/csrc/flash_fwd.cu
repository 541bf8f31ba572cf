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
// sees no key gives out = 0 and lse = -1e30 whatever the tiling. The input
// dtype is bf16 or f16 (one set of kernels templated on the element type E:
// wgmma's .bf16 and .f16 kinds run at one rate with f32 accumulators, and
// TMA moves either as 16-bit elements), or f32 for checking.
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
// or f16 dense over 3.35 TB/s of HBM, about 295 FLOPs per byte. So a prefill
// bucket of 512 is bound by HBM, and from about S = 740 on (the 1024..8192
// buckets) the kernel is bound by the tensor cores' bf16 (f16) rate.
//
// Head dims. The kernel is built for D = 32, 64, 128 and 256; a head dim d
// in between (a multiple of 8: 80 and 96 run the D 128 kernel, 136..248 the
// D 256 one) runs the next D up with d passed at run time. Its TMA maps
// describe the tensors at their true d, read columns past d as zeros, and
// the epilogue stores d columns: the padding costs D / d in operations
// (1.33x at 96, 1.6x at 80) and nothing in bytes. At D 256 the K/V tiles
// are 64 keys (Layout). From 257 to 640 flash_fwd_wide_kernel keeps the
// block's Q tile resident and holds up to 320 columns of O in registers, so
// up to D 320 it forms S once per (q tile, key tile); past 320 it cuts O's
// columns into chunks, one block each; past 640 (to host::kMaxHeadDim)
// flash_fwd_wide_stream_kernel streams Q with K; see there.
//
// What the design does about it (bf16 and f16):
// - Only wgmma reaches Hopper's tensor-core rate, so both products are
//   wgmma: S = Q K^T as m64n128k16 (m64n64k16 at D 256) with Q and K read
//   from shared memory through descriptors, O += P V as m64nDk16 with P in
//   registers (the f32 accumulator layout of S is the register layout of
//   the A operand, so P needs no shuffle) and V read MN-major (the
//   descriptor's transpose bit; V stays D-contiguous as it lies in memory).
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
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared-memory layout of one block for head dim D. Every tile (the q
// tile of kBlockQ rows, and each stage's K and V tile of kBlockK keys) is
// D 16-bit values a row in TMA's swizzled layout: D / kAtomCols atoms side by
// side, each of kRowBytes a row (128-byte swizzle; 64-byte at D 32, whose
// rows are 64 bytes). K/V tiles are 128 keys, and 64 at D 256: there Q (64
// KB) and a 2-stage ring of 128-key tiles (256 KB) would pass the 227 KB a
// block may have, and S at 64 keys (32 f32 registers) leaves room for the
// 128 of O.
template <int D>
struct Layout {
  static constexpr int kBlockK = D > 128 ? 64 : 128;
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kAtomCols = kRowBytes / 2;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kQAtomBytes = kBlockQ * kRowBytes;
  static constexpr int kKVAtomBytes = kBlockK * kRowBytes;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;
  static constexpr int kSwizzle =
      kRowBytes == 128 ? sm90::kSwizzle128B : sm90::kSwizzle64B;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;                      // + stage * tile
  static constexpr int kV = kK + kStages * kKVBytes;      // + stage * tile
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kNumBars = 1 + 3 * kStages;        // q, full k/v, empty
  // Barriers, and slack to align the dynamic base to 1024 bytes.
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

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

// Online softmax of one tile of kBlockK keys for a consumer thread's two
// rows, in the exp2 domain, with short dependency chains (two consumer
// warps a scheduler hide little latency): the row max over the raw scores
// (scale > 0 commutes with max) in 4 partial maxima a row, p = exp2(s *
// scale - m) as one FFMA and ex2, the sum in 4 partial sums a row. On a
// tile that needs the `mask`, a masked score becomes -inf: it never raises
// the max and gives p = 0, and a row that has seen no key keeps m = NEG_INF
// (exp2(-inf + 1e30) = 0). Packs p, rounded to E, into the A registers of
// the P V product (chunks 2k and 2k + 1 form the k-th k16 step), updates the
// running max m and partial row sums l, and gives alpha, the factor by which
// each row's accumulator is to be rescaled.
template <typename E, int kBlockK>
__device__ __forceinline__ void softmax_step(
    float (&s)[kBlockK / 2], uint32_t (&p)[kBlockK / 4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], float scale_log2, bool mask,
    int causal, int k0, int qpos0, int k_base, int kv_len, int t) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
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
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float& mx = part[i >> 1][j % 4];
      mx = fmaxf(mx, s[4 * j + i]);
    }
  }
  float neg_m[2];
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
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
    float pj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pj[i] = exp2_approx(fmaf(s[4 * j + i], scale_log2, neg_m[i >> 1]));
      part[i >> 1][j % 4] += pj[i];
    }
    p[4 * (j / 2) + 2 * (j % 2)] = sm90::pack2<E>(pj[0], pj[1]);
    p[4 * (j / 2) + 2 * (j % 2) + 1] = sm90::pack2<E>(pj[2], pj[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] +
           ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
  }
}

// One block = one (batch * q head, 128-row q tile): the q tile is
// blockIdx.x, the row (batch * q head) folded_row() (launch.cuh). Warpgroup
// 0 loads; warpgroups 1 and 2 each own 64 query rows. In a consumer, warp w
// and lane (g = lane / 4, t = lane % 4) hold rows 16w + g and 16w + g + 8
// of their 64, and columns 8j + 2t, 8j + 2t + 1 of every 8-column chunk j.
// D is the kernel's width and `d` (<= D, a multiple of 8) the tensors': the
// TMA maps read columns past d as zeros, which leave Q K^T as it is and
// give zero columns of P V, and only the first d columns of out are
// stored. E is the element type of q, k, v and out.
template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      uint16_t* __restrict__ out, float* __restrict__ lse,
                      int n_bh, int hq, int hkv, int sq, int sk, int d,
                      int causal, float scale_log2, int q_base_arg,
                      int k_base_arg, int kv_len_arg,
                      const int* __restrict__ base) {
  using L = Layout<D>;
  constexpr int kBlockK = L::kBlockK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heavy tiles first
  const int bh = host::folded_row();
  if (bh >= n_bh) return;
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
      sm90::mbar_arrive_expect_tx(bar_q, L::kQBytes);
      for (int a = 0; a < L::kAtoms; ++a) {
        sm90::tma_load_3d(smem + L::kQ + a * L::kQAtomBytes, &tm_q, bar_q,
                          a * L::kAtomCols, q0, bh);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        sm90::mbar_wait(empty + st, ((kt / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full_k + st, L::kKVBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          sm90::tma_load_3d(
              smem + L::kK + st * L::kKVBytes + a * L::kKVAtomBytes, &tm_k,
              full_k + st, a * L::kAtomCols, kt * kBlockK, kv_head);
        }
        sm90::mbar_arrive_expect_tx(full_v + st, L::kKVBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          sm90::tma_load_3d(
              smem + L::kV + st * L::kKVBytes + a * L::kKVAtomBytes, &tm_v,
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

    float s[kBlockK / 2];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
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
      const uint8_t* k_s = smem + L::kK + st * L::kKVBytes;
      const uint8_t* v_s = smem + L::kV + st * L::kKVBytes;

      // S = Q K^T: D / 16 k-steps; a step is 32 bytes into an atom's row.
      sm90::mbar_wait(full_k + st, phase);
      phases.mark(kWaitK);
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int atom = kk * 32 / L::kRowBytes, col = (kk * 32) % L::kRowBytes;
        sm90::WgmmaSS<kBlockK, 0, E>::mma(
            s,
            sm90::make_desc(q_s + atom * L::kQAtomBytes + col, 16, kSbo,
                            L::kSwizzle),
            sm90::make_desc(k_s + atom * L::kKVAtomBytes + col, 16, kSbo,
                            L::kSwizzle),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      phases.mark(kQK);

      const bool mask = (causal && k_base + k0 + kBlockK - 1 > first_qpos) ||
                        k0 + kBlockK > kv_len;
      uint32_t p[kBlockK / 4];
      float alpha[2];
      softmax_step<E, kBlockK>(s, p, m, l, alpha, scale_log2, mask, causal,
                               k0, qpos0, k_base, kv_len, t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      phases.mark(kSoftmax);

      // O += P V: k-steps of 16 keys; V MN-major, atoms along D.
      sm90::mbar_wait(full_v + st, phase);
      phases.mark(kWaitV);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        sm90::WgmmaRS<D, 1, E>::mma(
            o, a,
            sm90::make_desc(v_s + kk * 16 * L::kRowBytes, L::kKVAtomBytes,
                            kSbo, L::kSwizzle),
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
      uint16_t* orow = out + ((size_t)bh * sq + row) * d + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (8 * j >= d) break;  // d % 8 == 0: a chunk is wholly in or out
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            sm90::pack2<E>(o[4 * j + 2 * r] * inv,
                           o[4 * j + 2 * r + 1] * inv);
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

// Head widths past 256 (to host::kMaxHeadDim). What bounds it: at D 288
// (Gemma-2-2B's and Gemma-3-1B's heads) the work is 4 * d FLOPs a visible
// pair over 4 * d * 2 bytes of q, k, v and out a row: bound by the tensor
// cores from about S 740 on, as at D 128. The first design (one block a
// 128-row q tile and column chunk of at most 4 atoms, every atom of Q and
// K streamed from L2 per key tile; now flash_fwd_wide_stream_kernel) ran at
// 12-19 % of that bound: at D 288 it moved 140 KB from L2 per block and
// 64-key tile (2.37 GB a call at Gemma-2-2B's widths, S 4096, about 5.7
// TB/s), formed S twice (two chunks) and issued its P V as one N = 64
// product an atom.
//
// This design, to kWideTallAtoms atoms (D 640):
// - Q stays resident. A block loads its 128-row q tile once by TMA, n_atoms
//   atoms of 64 columns (the width padded to atoms: 5 at D 288, 80 KB; 10 at
//   D 640, 160 KB), and keeps it in shared memory for the whole key walk;
//   each K/V byte brought from L2 serves its 128 rows (two consumer
//   warpgroups of 64). Past D 640 a 128-row tile does not fit beside the
//   K/V buffers; a 64-row one (one consumer warpgroup) ran 1.65x slower
//   than the streaming kernel at D 1024, which takes those widths.
// - K and V stream once per key tile: the tile's K atoms (every atom of d)
//   one 8 KB atom at a time through a ring of as many slots as the shared
//   memory left holds (up to kWideSlots: 8 at D 288, 7 at D 512, 3 at D
//   640), each slot handed back once the consumers' S products on it are
//   done; its V atoms (the block's chunk) side by side in a V stage, two
//   stages where they fit beside Q (to D 320), so that P V reads them as
//   one operand.
// - O in registers, up to kWideAtoms atoms (320 columns, 160 f32 registers a
//   consumer thread: the accumulator of one N = 256 product over four
//   atoms and one N = 64 product; S, the packed P and the softmax state
//   take most of the rest of the 240). So to D 320 one block holds the
//   whole O of its rows and forms S = Q K^T once per (q tile, key tile),
//   and every atom of O is updated from that one P, held in registers as
//   the A operand of the P V products: the second S product of the first
//   design (a third of its MMA work at D 288) and half of its Q/K traffic
//   are gone. From 321 to 640 O's columns are cut into chunks of at most
//   kWideAtoms atoms (host::column_chunks), one block each, and each chunk
//   block forms S over the whole d (2 chunks at D 512). Holding O of 128
//   rows at D 512 needs 256 KB of f32, the whole register file, so one P a
//   tile there would need P staged in shared memory for consumer
//   warpgroups that each own a column chunk (not built).
// - P V as one N = 256 product a k16 step (and one N = 64 for a fifth
//   atom), as the D 256 kernel does: five N = 64 products a step, one a V
//   atom in its own ring slot, ran 1.11x slower at D 288 (PERF.md).
// Per 64-key tile at D 288 a block moves 80 KB from L2 (140 KB before) and
// does 2 * 128 * 64 * 320 FLOPs of each product (S twice before).
constexpr int kWideAtoms = 5;
constexpr int kWideSlots = 8;
constexpr int kWideTallAtoms = 10;
// The dynamic shared memory a wide launch may take (226 KB; the rest of
// the 227 is the block's static base_s).
constexpr int kWideSmem = 231424;

struct WideLayout {
  static constexpr int kRows = 128;  // q rows a block: two consumers x 64
  static constexpr int kBlockK = 64;
  static constexpr int kRowBytes = 128;  // one 64-column atom of 16 bits
  static constexpr int kSlotBytes = kBlockK * kRowBytes;  // a K or V atom
  static constexpr int kVBytes = kWideAtoms * kSlotBytes;  // a V stage
  static constexpr int kQAtomBytes = kRows * kRowBytes;
  // Shared memory at `atoms` atoms: the q tile, the V stages, the K ring,
  // then the barriers (q; a full and an empty one a V stage and a K slot)
  // and slack to align the base to 1024 bytes. Two V stages where they
  // leave the ring 4 slots.
  __host__ __device__ static constexpr int fixed(int atoms) {
    return atoms * kQAtomBytes + 8 + 1024;
  }
  __host__ __device__ static constexpr int v_stages(int atoms) {
    return fixed(atoms) + 2 * (kVBytes + 16) + 4 * (kSlotBytes + 16) <=
                   kWideSmem
               ? 2
               : 1;
  }
  __host__ __device__ static constexpr int slots(int atoms) {
    const int fit = (kWideSmem - fixed(atoms) -
                     v_stages(atoms) * (kVBytes + 16)) /
                    (kSlotBytes + 16);
    return fit < kWideSlots ? fit : kWideSlots;
  }
  __host__ __device__ static constexpr int bytes(int atoms) {
    return fixed(atoms) + v_stages(atoms) * (kVBytes + 16) +
           slots(atoms) * (kSlotBytes + 16);
  }
};
static_assert(WideLayout::slots(kWideTallAtoms) >= 2 &&
                  WideLayout::bytes(kWideTallAtoms) <= kWideSmem &&
                  WideLayout::v_stages(kWideAtoms) == 2,
              "shared memory");

// A position in a ring of n slots: the slot and the parity of its round.
struct RingPos {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// One block = one (128-row q tile, column chunk, batch * q head):
// blockIdx.x is chunk + n_chunks * (q tiles from the last), the row folded
// as in flash_fwd_sm90_kernel. Warpgroup 0 loads (one thread); consumer c
// owns q rows [64c, 64c + 64) of the tile and O's columns of the chunk's
// atoms [a0, a0 + n_out): atoms a0..a0 + 3 in o (the accumulator layout of
// an N = 256 product: register 4j + i holds column 8j + 2t + (i & 1) of
// its 256), atom a0 + 4 in o4 (N = 64). Chunk 0 writes lse.
template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      uint16_t* __restrict__ out, float* __restrict__ lse,
                      int n_bh, int hq, int hkv, int sq, int sk, int d,
                      int causal, float scale_log2, int q_base_arg,
                      int k_base_arg, int kv_len_arg,
                      const int* __restrict__ base, int n_chunks, int per) {
  using L = WideLayout;
  constexpr int kBlockK = L::kBlockK;
  constexpr uint32_t kSbo = 8 * L::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) &
                              1023);
  const int n_atoms = (d + host::kAtomCols - 1) / host::kAtomCols;
  const int n_vst = L::v_stages(n_atoms);
  const int n_slots = L::slots(n_atoms);
  uint8_t* q_tile = smem;
  uint8_t* v_tile = q_tile + n_atoms * L::kQAtomBytes;  // + stage * kVBytes
  uint8_t* ring = v_tile + n_vst * L::kVBytes;  // + slot * kSlotBytes
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + n_slots * L::kSlotBytes);
  uint64_t* full_v = bar_q + 1;
  uint64_t* empty_v = full_v + n_vst;
  uint64_t* full = empty_v + n_vst;
  uint64_t* empty = full + n_slots;

  const int chunk = blockIdx.x % n_chunks;
  const int q0 = (gridDim.x / n_chunks - 1 - blockIdx.x / n_chunks) * L::kRows;
  const int bh = host::folded_row();
  if (bh >= n_bh) return;
  const int kv_head = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int a0 = chunk * per;
  const int n_out = min(per, n_atoms - a0);

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
    for (int s = 0; s < n_vst; ++s) {
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty_v + s, kConsumerWarps);
    }
    for (int s = 0; s < n_slots; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int q_base = base_s[0], k_base = base_s[1], kv_len = base_s[2];

  const int q_last = q_base + min(q0 + L::kRows, sq) - 1;
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_last - k_base + 1));
  const int n_tiles = (n_cols + kBlockK - 1) / kBlockK;

  if (threadIdx.x < 128) {
    sm90::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::mbar_arrive_expect_tx(bar_q, n_atoms * L::kQAtomBytes);
      for (int a = 0; a < n_atoms; ++a) {
        sm90::tma_load_3d(q_tile + a * L::kQAtomBytes, &tm_q, bar_q,
                          a * host::kAtomCols, q0, bh);
      }
      // Round r of a K slot or V stage waits for the consumers to release
      // round r - 1 (the first round's wait passes at once).
      RingPos pos;
      for (int kt = 0; kt < n_tiles; ++kt) {
        for (int a = 0; a < n_atoms; ++a) {
          sm90::mbar_wait(empty + pos.slot, pos.phase ^ 1);
          sm90::mbar_arrive_expect_tx(full + pos.slot, L::kSlotBytes);
          sm90::tma_load_3d(ring + pos.slot * L::kSlotBytes, &tm_k,
                            full + pos.slot, a * host::kAtomCols,
                            kt * kBlockK, kv_head);
          pos.next(n_slots);
        }
        const int vs = kt % n_vst;
        sm90::mbar_wait(empty_v + vs, ((kt / n_vst) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full_v + vs, n_out * L::kSlotBytes);
        for (int j = 0; j < n_out; ++j) {
          sm90::tma_load_3d(v_tile + vs * L::kVBytes + j * L::kSlotBytes,
                            &tm_v, full_v + vs, (a0 + j) * host::kAtomCols,
                            kt * kBlockK, kv_head);
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
    const uint8_t* q_s = q_tile + 64 * c * L::kRowBytes;

    float s[kBlockK / 2];
    float o[128], o4[32];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) o4[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar);
    };
    RingPos pos;
    int prev = 0;  // the slot of the group before the one in flight
    if (n_tiles > 0) sm90::mbar_wait(bar_q, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kBlockK;
      // S = Q K^T over the atoms of d, Q from the resident tile; k16 steps
      // wholly past d are skipped. One atom's group stays in flight.
      for (int a = 0; a < n_atoms; ++a) {
        const uint64_t q_desc =
            sm90::make_desc(q_s + a * L::kQAtomBytes, 16, kSbo,
                            sm90::kSwizzle128B);
        const uint64_t k_desc =
            sm90::make_desc(ring + pos.slot * L::kSlotBytes, 16, kSbo,
                            sm90::kSwizzle128B);
        sm90::mbar_wait(full + pos.slot, pos.phase);
        sm90::fence_regs(s);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (a * host::kAtomCols + 16 * kk >= d) break;
          sm90::WgmmaSS<kBlockK, 0, E>::mma(
              s, sm90::desc_advance(q_desc, 32 * kk),
              sm90::desc_advance(k_desc, 32 * kk), a > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        if (a > 0) release(empty + prev);
        prev = pos.slot;
        pos.next(n_slots);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      release(empty + prev);

      const bool mask = (causal && k_base + k0 + kBlockK - 1 > first_qpos) ||
                        k0 + kBlockK > kv_len;
      uint32_t p[kBlockK / 4];
      float alpha[2];
      softmax_step<E, kBlockK>(s, p, m, l, alpha, scale_log2, mask, causal,
                               k0, qpos0, k_base, kv_len, t);
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) o4[i] *= alpha[(i >> 1) & 1];

      // O[:, chunk] += P V[:, chunk], V read MN-major from its stage: one
      // N = 256 product over atoms a0..a0 + 3 (those past n_out read what
      // the stage holds there and land in columns never stored) and, with
      // a fifth atom, one N = 64 product.
      const int vs = kt % n_vst;
      const uint8_t* v_s = v_tile + vs * L::kVBytes;
      sm90::mbar_wait(full_v + vs, (kt / n_vst) & 1);
      sm90::fence_regs(o);
      sm90::fence_regs(o4);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
        sm90::WgmmaRS<256, 1, E>::mma(
            o, pa,
            sm90::make_desc(v_s + kk * 16 * L::kRowBytes, L::kSlotBytes,
                            kSbo, sm90::kSwizzle128B),
            1);
        if (n_out > 4) {
          sm90::WgmmaRS<64, 1, E>::mma(
              o4, pa,
              sm90::make_desc(v_s + 4 * L::kSlotBytes +
                                  kk * 16 * L::kRowBytes,
                              L::kSlotBytes, kSbo, sm90::kSwizzle128B),
              1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(o4);
      release(empty_v + vs);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      uint16_t* orow = out + ((size_t)bh * sq + row) * d + 2 * t;
      const int c0 = a0 * host::kAtomCols;
#pragma unroll
      for (int j = 0; j < 40; ++j) {
        const int col = c0 + 8 * j;
        // d % 8 == 0: an 8-column group is wholly in or out.
        if (j / 8 >= n_out || col >= d) break;
        const float lo = j < 32 ? o[4 * j + 2 * r] : o4[4 * (j - 32) + 2 * r];
        const float hi =
            j < 32 ? o[4 * j + 2 * r + 1] : o4[4 * (j - 32) + 2 * r + 1];
        *reinterpret_cast<uint32_t*>(orow + col) =
            sm90::pack2<E>(lo * inv, hi * inv);
      }
      if (t == 0 && chunk == 0) {
        lse[(size_t)bh * sq + row] =
            m[r] == kNegInf ? kNegInf : (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// Head widths past kWideTallAtoms atoms (D 640): column chunks of O with
// nothing resident. A block is one (128-row q tile, column chunk, batch * q
// head): it owns O's columns of its chunk's atoms (at most kStreamAtoms of
// 64 columns: 128 f32 registers a thread, as at D 256), and forms S = Q K^T
// over the whole width d, so every chunk block of a q tile holds the same m
// and l and writes its columns of out without a combine (chunk 0 writes
// lse). Per 64-key K tile the producer streams the (Q atom, K atom) pairs
// of the d columns through a ring of kScoreStages, then the tile's V atoms
// of the chunk through a ring of two. The consumers issue each atom's four
// k16 steps of S and hand the previous atom's stage back as soon as its
// products are done, so one group stays in flight. (A 64-row q tile kept
// resident, one consumer warpgroup, ran this width 1.65x slower on the
// card at D 1024: PERF.md.)
constexpr int kStreamAtoms = 4;

struct StreamLayout {
  static constexpr int kBlockK = 64;
  static constexpr int kScoreStages = 4;
  static constexpr int kRowBytes = 128;  // one 64-column atom of bf16
  static constexpr int kQAtomBytes = kBlockQ * kRowBytes;
  static constexpr int kKAtomBytes = kBlockK * kRowBytes;
  static constexpr int kScoreBytes = kQAtomBytes + kKAtomBytes;
  static constexpr int kVBytes = kStreamAtoms * kKAtomBytes;
  static constexpr int kScore = 0;                       // + stage * score
  static constexpr int kV = kScoreStages * kScoreBytes;  // + stage * V
  static constexpr int kBars = kV + 2 * kVBytes;
  static constexpr int kNumBars = 2 * kScoreStages + 4;  // full, empty x2
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_stream_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      uint16_t* __restrict__ out, float* __restrict__ lse,
                      int n_bh, int hq, int hkv, int sq, int sk, int d,
                      int causal, float scale_log2, int q_base_arg,
                      int k_base_arg, int kv_len_arg,
                      const int* __restrict__ base, int n_chunks, int per) {
  using L = StreamLayout;
  constexpr int kBlockK = L::kBlockK;
  constexpr int kS = L::kScoreStages;
  constexpr uint32_t kSbo = 8 * L::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full_s = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty_s = full_s + kS;
  uint64_t* full_v = empty_s + kS;
  uint64_t* empty_v = full_v + 2;

  const int chunk = blockIdx.x % n_chunks;
  const int q0 = (gridDim.x / n_chunks - 1 - blockIdx.x / n_chunks) * kBlockQ;
  const int bh = host::folded_row();
  if (bh >= n_bh) return;
  const int kv_head = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int n_atoms = (d + host::kAtomCols - 1) / host::kAtomCols;
  const int a0 = chunk * per;
  const int n_out = min(per, n_atoms - a0);

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
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(full_s + s, 1);
      sm90::mbar_init(empty_s + s, kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty_v + s, kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const int q_base = base_s[0], k_base = base_s[1], kv_len = base_s[2];

  const int q_last = q_base + min(q0 + kBlockQ, sq) - 1;
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_last - k_base + 1));
  const int n_tiles = (n_cols + kBlockK - 1) / kBlockK;

  if (threadIdx.x < 128) {
    sm90::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        for (int a = 0; a < n_atoms; ++a, ++it) {
          const int st = it % kS;
          uint8_t* stage = smem + L::kScore + st * L::kScoreBytes;
          sm90::mbar_wait(empty_s + st, ((it / kS) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(full_s + st, L::kScoreBytes);
          sm90::tma_load_3d(stage, &tm_q, full_s + st, a * host::kAtomCols,
                            q0, bh);
          sm90::tma_load_3d(stage + L::kQAtomBytes, &tm_k, full_s + st,
                            a * host::kAtomCols, kt * kBlockK, kv_head);
        }
        const int vs = kt % 2;
        sm90::mbar_wait(empty_v + vs, ((kt / 2) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full_v + vs, n_out * L::kKAtomBytes);
        for (int j = 0; j < n_out; ++j) {
          sm90::tma_load_3d(
              smem + L::kV + vs * L::kVBytes + j * L::kKAtomBytes, &tm_v,
              full_v + vs, (a0 + j) * host::kAtomCols, kt * kBlockK,
              kv_head);
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

    float s[kBlockK / 2];
    float o[kStreamAtoms][32];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kStreamAtoms; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar);
    };
    int it = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kBlockK;
      // S = Q K^T over the atoms of d; k16 steps wholly past d are skipped.
      for (int a = 0; a < n_atoms; ++a, ++it) {
        const int st = it % kS;
        const uint8_t* stage = smem + L::kScore + st * L::kScoreBytes;
        const uint64_t q_desc = sm90::make_desc(
            stage + 64 * c * L::kRowBytes, 16, kSbo, sm90::kSwizzle128B);
        const uint64_t k_desc = sm90::make_desc(
            stage + L::kQAtomBytes, 16, kSbo, sm90::kSwizzle128B);
        sm90::mbar_wait(full_s + st, (it / kS) & 1);
        sm90::fence_regs(s);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (a * host::kAtomCols + 16 * kk >= d) break;
          sm90::WgmmaSS<kBlockK, 0, E>::mma(
              s, sm90::desc_advance(q_desc, 32 * kk),
              sm90::desc_advance(k_desc, 32 * kk), a > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        if (a > 0) release(empty_s + (it - 1) % kS);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      release(empty_s + (it - 1) % kS);

      const bool mask = (causal && k_base + k0 + kBlockK - 1 > first_qpos) ||
                        k0 + kBlockK > kv_len;
      uint32_t p[kBlockK / 4];
      float alpha[2];
      softmax_step<E, kBlockK>(s, p, m, l, alpha, scale_log2, mask, causal,
                               k0, qpos0, k_base, kv_len, t);
#pragma unroll
      for (int j = 0; j < kStreamAtoms; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];
      }

      // O[:, chunk] += P V[:, chunk], one N = 64 product an atom.
      const int vs = kt % 2;
      const uint8_t* v_s = smem + L::kV + vs * L::kVBytes;
      sm90::mbar_wait(full_v + vs, (kt / 2) & 1);
#pragma unroll
      for (int j = 0; j < kStreamAtoms; ++j) sm90::fence_regs(o[j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
#pragma unroll
        for (int j = 0; j < kStreamAtoms; ++j) {
          if (j >= n_out) break;
          sm90::WgmmaRS<64, 1, E>::mma(
              o[j], pa,
              sm90::make_desc(v_s + j * L::kKAtomBytes + kk * 16 * L::kRowBytes,
                              L::kKAtomBytes, kSbo, sm90::kSwizzle128B),
              1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kStreamAtoms; ++j) sm90::fence_regs(o[j]);
      release(empty_v + vs);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      uint16_t* orow = out + ((size_t)bh * sq + row) * d + 2 * t;
#pragma unroll
      for (int j = 0; j < kStreamAtoms; ++j) {
        if (j >= n_out) break;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = (a0 + j) * host::kAtomCols + 8 * jj;
          if (col >= d) break;  // d % 8 == 0: a chunk is wholly in or out
          *reinterpret_cast<uint32_t*>(orow + col) =
              sm90::pack2<E>(o[j][4 * jj + 2 * r] * inv,
                             o[j][4 * jj + 2 * r + 1] * inv);
        }
      }
      if (t == 0 && chunk == 0) {
        lse[(size_t)bh * sq + row] =
            m[r] == kNegInf ? kNegInf : (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// f32 check path: one warp per query row, lane holds D / 32 columns (those
// at or past d are 0 and not stored); the row's visible keys are
// [0, n_cols), walked one at a time.
constexpr int kRowsPerBlock = 8;

template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int n_bh, int hq, int hkv,
                     int sq, int sk, int d, int causal, float sm_scale,
                     int q_base, int k_base, int kv_len,
                     const int* __restrict__ base) {
  constexpr int kPer = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int bh = host::folded_row();
  if (row >= sq || bh >= n_bh) return;
  const int b = bh / hq, kvh = (bh % hq) / (hq / hkv);
  if (base != nullptr) {
    q_base = base[3 * b];
    k_base = base[3 * b + 1];
    kv_len = min(max(base[3 * b + 2], 0), sk);
  }
  const float* kg = k + ((size_t)b * hkv + kvh) * sk * d;
  const float* vg = v + ((size_t)b * hkv + kvh) * sk * d;
  const size_t q_off = ((size_t)bh * sq + row) * d;

  float qv[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qv[i] = lane + 32 * i < d ? q[q_off + lane + 32 * i] : 0.f;
    acc[i] = 0.f;
  }
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_base + row - k_base + 1));
  float m = kNegInf, l = 0.f;
  for (int j = 0; j < n_cols; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (lane + 32 * i < d) s += qv[i] * kg[(size_t)j * d + lane + 32 * i];
    }
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
      const float vj = lane + 32 * i < d ? vg[(size_t)j * d + lane + 32 * i]
                                         : 0.f;
      acc[i] = acc[i] * alpha + p * vj;
    }
    m = m_new;
  }
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (lane + 32 * i < d) out[q_off + lane + 32 * i] = acc[i] / l_safe;
  }
  if (lane == 0) lse[(size_t)bh * sq + row] = m + logf(l_safe);
}

template <typename E, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int batch, int hq, int hkv, int sq, int sk,
                      int d, int causal, float sm_scale, int q_base,
                      int k_base, int kv_len, const int* base,
                      cudaStream_t stream) {
  using L = Layout<D>;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_fwd_sm90_kernel<E, D>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  // With no keys (Sk 0) no K/V tile is ever loaded; q stands in for the
  // K/V maps so that they still describe real memory.
  if (sk == 0) k = v = q;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!host::encode_rows<E>(&tm_q, q, d, sq, batch * hq, kBlockQ, D) ||
      !host::encode_rows<E>(&tm_k, k, d, sk > 0 ? sk : 1, batch * hkv,
                            L::kBlockK, D) ||
      !host::encode_rows<E>(&tm_v, v, d, sk > 0 ? sk : 1, batch * hkv,
                            L::kBlockK, D)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid = host::fold_rows((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  flash_fwd_sm90_kernel<E, D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<uint16_t*>(out), lse, batch * hq, hq,
      hkv, sq, sk, d, causal, sm_scale * kLog2e, q_base, k_base, kv_len,
      base);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int batch, int hq, int hkv,
                       int sq, int sk, int d, int causal, float sm_scale,
                       int q_base, int k_base, int kv_len, const int* base,
                       cudaStream_t stream) {
  const dim3 grid = host::fold_rows(
      (sq + kRowsPerBlock - 1) / kRowsPerBlock, batch * hq);
  flash_fwd_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse,
      batch * hq, hq, hkv, sq, sk, d, causal, sm_scale, q_base, k_base,
      kv_len, base);
  return cudaSuccess;
}

template <typename E>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, float* lse, int batch, int hq, int hkv,
                        int sq, int sk, int d, int causal, float sm_scale,
                        int q_base, int k_base, int kv_len, const int* base,
                        cudaStream_t stream) {
  const int atoms = (d + host::kAtomCols - 1) / host::kAtomCols;
  const bool resident = atoms <= kWideTallAtoms;
  static std::atomic<uint64_t> configured{0}, configured_stream{0};
  const cudaError_t err =
      resident ? host::allow_dynamic_smem(flash_fwd_wide_kernel<E>,
                                          kWideSmem, &configured)
               : host::allow_dynamic_smem(flash_fwd_wide_stream_kernel<E>,
                                          StreamLayout::kBytes,
                                          &configured_stream);
  if (err != cudaSuccess) return err;
  if (sk == 0) k = v = q;
  // Every box is one 64-column atom (width 64: 128-byte rows).
  CUtensorMap tm_q, tm_k, tm_v;
  if (!host::encode_rows<E>(&tm_q, q, d, sq, batch * hq, kBlockQ,
                            host::kAtomCols) ||
      !host::encode_rows<E>(&tm_k, k, d, sk > 0 ? sk : 1, batch * hkv, 64,
                            host::kAtomCols) ||
      !host::encode_rows<E>(&tm_v, v, d, sk > 0 ? sk : 1, batch * hkv, 64,
                            host::kAtomCols)) {
    return cudaErrorInvalidValue;
  }
  const host::Chunks chunks =
      host::column_chunks(d, resident ? kWideAtoms : kStreamAtoms);
  const dim3 grid = host::fold_rows(
      (sq + kBlockQ - 1) / kBlockQ * chunks.n, batch * hq);
  if (resident) {
    flash_fwd_wide_kernel<E><<<grid, kThreads, WideLayout::bytes(atoms),
                               stream>>>(
        tm_q, tm_k, tm_v, static_cast<uint16_t*>(out), lse, batch * hq, hq,
        hkv, sq, sk, d, causal, sm_scale * kLog2e, q_base, k_base, kv_len,
        base, chunks.n, chunks.per);
  } else {
    flash_fwd_wide_stream_kernel<E><<<grid, kThreads, StreamLayout::kBytes,
                                      stream>>>(
        tm_q, tm_k, tm_v, static_cast<uint16_t*>(out), lse, batch * hq, hq,
        hkv, sq, sk, d, causal, sm_scale * kLog2e, q_base, k_base, kv_len,
        base, chunks.n, chunks.per);
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = bf16 and 2 = f16 (the Hopper kernels), 1 = f32 (check kernel):
// host::kDtype*. Tensors are contiguous and 16-byte aligned (the Python
// wrapper checks). The head dim d is a multiple of 8 up to kMaxHeadDim (the
// wrapper pads any other d to a multiple of 8: ops/_ext.py
// kernel_head_dim): up to 256 it runs the kernel built for the next of 32,
// 64, 128 and 256, past it (bf16, f16) the wide kernel up to
// kWideTallAtoms atoms (D 640) and the streaming one past them. `base`, when
// not null, is a device int32 (batch, 3) array of [q_base, k_base, kv_len]
// per batch row, read by the kernel in place of the three ints. Launches on
// `stream`, allocates nothing, and returns the first error of the set-up or
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int dtype, int batch,
                                int hq, int hkv, int sq, int sk, int d,
                                int causal, float sm_scale, int q_base,
                                int k_base, int kv_len, const int* base,
                                void* stream) {
  if ((dtype != host::kDtypeBf16 && dtype != host::kDtypeF32 &&
       dtype != host::kDtypeF16) ||
      hkv <= 0 || hq % hkv || d <= 0 || d > host::kMaxHeadDim || d % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == host::kDtypeF32) {
    err = host::with_f32_width(d, [&](auto width) {
      return launch_f32<decltype(width)::value>(
          q, k, v, out, lse, batch, hq, hkv, sq, sk, d, causal, sm_scale,
          q_base, k_base, kv_len, base, st);
    });
  } else {
    err = host::with_elem(dtype, [&](auto elem) {
      using E = typename decltype(elem)::type;
      if (d > 256) {
        return launch_wide<E>(q, k, v, out, lse, batch, hq, hkv, sq, sk, d,
                              causal, sm_scale, q_base, k_base, kv_len, base,
                              st);
      }
      return host::with_width(d, [&](auto width) {
        return launch_tc<E, decltype(width)::value>(
            q, k, v, out, lse, batch, hq, hkv, sq, sk, d, causal, sm_scale,
            q_base, k_base, kv_len, base, st);
      });
    });
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
