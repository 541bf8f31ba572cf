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
// whole sequence in VMEM. Here every block streams its long operand in tiles
// through shared memory whatever the length, so one kernel covers both
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
// What the design does about it (bf16, head dims 32, 64 and 128). Both
// kernels have the forward's shape: 384 threads, a producer warpgroup whose
// one thread issues TMA loads into an mbarrier ring (full: expect-tx bytes;
// empty: the 8 consumer warps' arrivals) and hands its registers to two
// consumer warpgroups (setmaxnreg 24 / 240), each of which owns 64 rows of
// the block's resident operand and runs every product as wgmma.
// - dk/dv: a block is one (batch * KV head, 128-key tile); K and V stay
//   resident, consumer c owns keys [64c, 64c + 64). The producer streams
//   (q head of the GQA group, 64-row q tile) pairs from the causal first
//   tile on: q, dO and their 64 lse and delta values. Per pair, each
//   consumer computes S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//   operands K-major from shared memory), then dV += P^T dO and dK += dS^T Q
//   (m64nDk16 with P^T and dS^T from registers, the S^T accumulator's layout
//   being the A operand's, and dO and Q read MN-major with the transpose
//   bit). Nothing is transposed through shared memory. lse and delta belong
//   to columns of S^T: the producer warp copies each q tile's 64 of each
//   into the stage (plain loads; see the producer), and a thread reads
//   those of its columns from there. dV is issued as soon as P^T is packed,
//   so it runs while dS^T is formed. dK, dV (64 + 64 f32 registers at
//   D 128), S^T and dP^T (32 + 32) fit the consumer's 240, which is why q
//   tiles are 64 rows.
// - dq: a block is one (batch * q head, 128-row q tile); q and dO stay
//   resident, each thread keeps lse and delta of its two rows in registers,
//   and 64-key K/V tiles stream through a 2-stage ring. Per tile: S = Q K^T,
//   dP = dO V^T (SS, K and V K-major), then dQ += dS K (RS, K MN-major).
//   The loop stops at the last tile the causal diagonal of the block's last
//   real row reaches.
// - Heavy blocks launch first (key tile 0 sees every query; the last q tile
//   sees every key), and the mask runs only on tiles that cross the causal
//   diagonal, the kv_len tail or the ragged Sq edge. TMA zero-fills q and dO
//   rows past Sq and K/V rows past Sk, so nothing is padded.
// Measured on H100 (PERF.md): 128-key K/V tiles for dq ran slower than 64,
// and a 3-stage ring gained little, so the ring has 2 stages and dq's K/V
// tiles 64 keys. The consumers spend most of their cycles in the p/ds step. Left for later, each to be tried only with a measurement:
// fusing dq into the dk/dv kernel with f32 reduce-adds (5 products per
// pair, not 7), splitting a heavy dk/dv block's GQA group across blocks,
// a TMA store of the gradients.
//
// f32 (for checking) runs plain SIMT kernels: one warp per query row (dq) or
// per key row (dk/dv) that walks the visible partners one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 2;     // depth of the streamed operand's ring
constexpr int kDqKeys = 64;    // keys of a streamed K/V tile (dq)
constexpr int kResident = 128; // rows of the resident operand per block
constexpr int kStream = 64;    // rows of a streamed q/dO tile (dk/dv)

// Shared-memory geometry of bf16 tiles of head dim D in TMA's swizzled
// layout: D / kAtomCols atoms side by side, each `rows` rows of kRowBytes
// (128-byte swizzle; 64-byte at D 32, whose rows are 64 bytes).
template <int D>
struct Tiles {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kAtomCols = kRowBytes / 2;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kSwizzle =
      kRowBytes == 128 ? sm90::kSwizzle128B : sm90::kSwizzle64B;
  static constexpr uint32_t kSbo = 8 * kRowBytes;  // between 8-row groups
  // A resident tile (128 rows), a streamed q/dO tile (64 rows) and a
  // streamed K/V tile of the dq kernel (kDqKeys rows).
  static constexpr int kResAtomBytes = kResident * kRowBytes;
  static constexpr int kResBytes = kResident * D * 2;
  static constexpr int kStrAtomBytes = kStream * kRowBytes;
  static constexpr int kStrBytes = kStream * D * 2;
  static constexpr int kKeyAtomBytes = kDqKeys * kRowBytes;
  static constexpr int kKeyBytes = kDqKeys * D * 2;

  // Byte offset of k-step kk (16 values of D) in a K-major tile whose
  // atoms are `atom_bytes` apart: 32 bytes into an atom's rows.
  static __device__ __forceinline__ int kstep(int kk, int atom_bytes) {
    return (kk * 32 / kRowBytes) * atom_bytes + (kk * 32) % kRowBytes;
  }
  // Descriptor of a K-major operand at `p`; k-step kk is kstep bytes on.
  static __device__ __forceinline__ uint64_t kmajor(const uint8_t* p) {
    return sm90::make_desc(p, 16, kSbo, kSwizzle);
  }
  // Descriptor of an MN-major operand (its rows are the product's k
  // dimension, D its n) whose atoms are `atom_bytes` apart; rows
  // [16kk, 16kk + 16) are 16kk rows on.
  static __device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile,
                                                     int atom_bytes) {
    return sm90::make_desc(tile, atom_bytes, kSbo, kSwizzle);
  }
};

// dk/dv block: K and V resident (128 rows each), then a ring of q and dO
// tiles (64 rows each) with their 64 lse and 64 delta values.
template <int D>
struct DkvLayout {
  using T = Tiles<D>;
  static constexpr int kK = 0;
  static constexpr int kV = T::kResBytes;
  static constexpr int kQ = 2 * T::kResBytes;              // + stage * tile
  static constexpr int kDO = kQ + kStages * T::kStrBytes;  // + stage * tile
  static constexpr int kLse = kDO + kStages * T::kStrBytes;      // + 256 st
  // (kLse holds -lse * log2 e, the exponent's offset, not lse itself.)
  static constexpr int kDelta = kLse + kStages * kStream * 4;    // + 256 st
  static constexpr int kBars = kDelta + kStages * kStream * 4;
  static constexpr int kNumBars = 1 + 2 * kStages;  // k/v, full, empty
  static constexpr int kStageTx = 2 * T::kStrBytes;
  // Barriers, and slack to align the dynamic base to 1024 bytes.
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

// dq block: q and dO resident (128 rows each), then a ring of K and V
// tiles (kDqKeys keys each).
template <int D>
struct DqLayout {
  using T = Tiles<D>;
  static constexpr int kQ = 0;
  static constexpr int kDO = T::kResBytes;
  static constexpr int kK = 2 * T::kResBytes;              // + stage * tile
  static constexpr int kV = kK + kStages * T::kKeyBytes;   // + stage * tile
  static constexpr int kBars = kV + kStages * T::kKeyBytes;
  static constexpr int kNumBars = 1 + 2 * kStages;  // q/dO, full, empty
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
}

// Packs a 64 x N f32 accumulator (N / 2 registers) into the A registers
// of N / 16 k16 steps: chunks 2k and 2k + 1 form step k.
template <int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[R / 2],
                                       const float (&x)[R]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    a[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// acc (64 x D) += A (64 x K, the registers pack_a makes) * B (K x D, read
// MN-major through descriptor `b`, see Tiles::mnmajor): K / 16 RS wgmma
// steps, issued but not committed.
template <int D, int K>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[K / 4],
                                       uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    sm90::WgmmaRS<D, 1>::mma(
        acc, ak, sm90::desc_advance(b, kk * 16 * Tiles<D>::kRowBytes), 1);
  }
}

// Phases of a consumer warp, for the instrumented build: with
// -DFLASH_BWD_PHASE_CLOCKS (ops/flash_phases.py) each consumer warp adds
// the clock64 cycles it spends in each phase to a grid-wide total per
// kernel (0 dq, 1 dk/dv); without it PhaseClock is empty and compiles away.
// kWait: waiting for the resident operand and each streamed tile; kScores:
// the S and dP products issued and waited; kPds: the p and ds step (masks,
// exp2, packing); kGrads: the dV and dK (or dQ) products issued and
// waited, with the stage's release; kEpilogue: the gradient stores. The
// slot after the phases counts the streamed tiles the warps walked, which
// ops/flash_phases.py holds against its model of each kernel's walk.
enum Phase { kWait, kScores, kPds, kGrads, kEpilogue, kPhases };

#ifdef FLASH_BWD_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[2][kPhases + 1];

struct PhaseClock {
  long long last;
  unsigned long long sum[kPhases + 1] = {};
  __device__ PhaseClock() { last = clock64(); }
  __device__ void mark(Phase phase) {
    const long long now = clock64();
    sum[phase] += now - last;
    last = now;
  }
  __device__ void tile() { ++sum[kPhases]; }
  __device__ void flush(int kernel, int lane) {
    if (lane != 0) return;
    for (int i = 0; i <= kPhases; ++i) {
      atomicAdd(&g_phase_cycles[kernel][i], sum[i]);
    }
  }
};
#else
struct PhaseClock {
  __device__ void mark(Phase) {}
  __device__ void tile() {}
  __device__ void flush(int, int) {}
};
#endif

// dk/dv: one block = one (batch * KV head, 128-key tile), blockIdx.x the
// KV head and blockIdx.y the key tile, so key tile 0 (which, causal, sees
// every query) launches first. Warpgroup 0 loads; consumer c = 0, 1 owns
// keys [64c, 64c + 64). In a consumer, warp w and lane (g = lane / 4,
// t = lane % 4) hold keys 16w + g and 16w + g + 8 of its 64 (rows of S^T,
// dK, dV), and columns 8j + 2t, 8j + 2t + 1 of every 8-column chunk j
// (query rows of the q tile for S^T; head-dim columns for dK, dV).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int hq, int hkv, int sq, int sk, int causal,
                          float sm_scale, float scale_log2, int q_base,
                          int k_base, int kv_len) {
  using T = Tiles<D>;
  using L = DkvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kResident;
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;

  // The (q head, q tile) pairs of the block: for each head of the group,
  // the q tiles from the first with a row that sees the block's first key
  // (global positions, clamped at 0) on. A block wholly past kv_len has
  // none.
  const int n_qt = (sq + kStream - 1) / kStream;
  const int first_qt = causal ? max(0, k_base + k0 - q_base) / kStream : 0;
  const int per_head = k0 < kv_len ? max(0, n_qt - first_qt) : 0;
  const int n_items = group * per_head;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      // The TMA issue (with its expected bytes) and the 32 lanes that
      // store the stage's lse and delta.
      sm90::mbar_init(full + s, 1 + 32);
      sm90::mbar_init(empty + s, kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: warp 0. Round r of a stage waits for the consumers to
    // release round r - 1 (the first round's wait passes at once). Lane 0
    // issues the TMA loads; every lane stores two of the tile's 64
    // -lse * log2 e and delta values (0 for rows past Sq, which are masked)
    // from plain loads, then arrives. (A TMA box of an f32 vector at a row
    // offset that is not 16-byte aligned, any head past the first when
    // Sq % 4 != 0, stopped the kernel.)
    sm90::regs_dealloc<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32 && n_items > 0) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(bar_kv, 2 * T::kResBytes);
        for (int a = 0; a < T::kAtoms; ++a) {
          sm90::tma_load_3d(smem + L::kK + a * T::kResAtomBytes, &tm_k,
                            bar_kv, a * T::kAtomCols, k0, bkv);
          sm90::tma_load_3d(smem + L::kV + a * T::kResAtomBytes, &tm_v,
                            bar_kv, a * T::kAtomCols, k0, bkv);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % kStages;
        const int bh = b * hq + kvh * group + it / per_head;
        const int q0 = (first_qt + it % per_head) * kStream;
        sm90::mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(full + st, L::kStageTx);
          for (int a = 0; a < T::kAtoms; ++a) {
            const int off = st * T::kStrBytes + a * T::kStrAtomBytes;
            sm90::tma_load_3d(smem + L::kQ + off, &tm_q, full + st,
                              a * T::kAtomCols, q0, bh);
            sm90::tma_load_3d(smem + L::kDO + off, &tm_do, full + st,
                              a * T::kAtomCols, q0, bh);
          }
        }
        float* neg_lse_s =
            reinterpret_cast<float*>(smem + L::kLse) + st * kStream;
        float* delta_s =
            reinterpret_cast<float*>(smem + L::kDelta) + st * kStream;
#pragma unroll
        for (int i = lane; i < kStream; i += 32) {
          const bool in = q0 + i < sq;
          neg_lse_s[i] = in ? -lse[(size_t)bh * sq + q0 + i] * kLog2e : 0.f;
          delta_s[i] = in ? delta[(size_t)bh * sq + q0 + i] : 0.f;
        }
        sm90::mbar_arrive(full + st);
      }
    }
  } else {
    sm90::regs_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kc0 = k0 + 64 * c;               // the consumer's first key
    const int key0 = kc0 + 16 * warp + g;      // and key0 + 8
    // Descriptors of the consumer's K and V rows and of stage 0's q and dO
    // tiles, made once: a k-step or a stage moves them by a byte offset.
    const uint64_t k_desc = T::kmajor(smem + L::kK + 64 * c * T::kRowBytes);
    const uint64_t v_desc = T::kmajor(smem + L::kV + 64 * c * T::kRowBytes);
    const uint64_t q_desc = T::kmajor(smem + L::kQ);
    const uint64_t do_desc = T::kmajor(smem + L::kDO);
    const uint64_t q_mn = T::mnmajor(smem + L::kQ, T::kStrAtomBytes);
    const uint64_t do_mn = T::mnmajor(smem + L::kDO, T::kStrAtomBytes);

    float acc_dk[D / 2], acc_dv[D / 2], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

    PhaseClock phases;
    if (n_items > 0) sm90::mbar_wait(bar_kv, 0);
    phases.mark(kWait);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % kStages;
      const int q0 = (first_qt + it % per_head) * kStream;
      const uint32_t st_off = st * T::kStrBytes;
      const float* neg_lse_s =
          reinterpret_cast<const float*>(smem + L::kLse + st * kStream * 4);
      const float* delta_s =
          reinterpret_cast<const float*>(smem + L::kDelta + st * kStream * 4);
      sm90::mbar_wait(full + st, (it / kStages) & 1);
      phases.mark(kWait);
      phases.tile();

      // S^T = K Q^T and dP^T = V dO^T, committed as two groups.
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::WgmmaSS<64, 0>::mma(
            s, sm90::desc_advance(k_desc, T::kstep(kk, T::kResAtomBytes)),
            sm90::desc_advance(q_desc,
                               st_off + T::kstep(kk, T::kStrAtomBytes)),
            kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::WgmmaSS<64, 0>::mma(
            dp, sm90::desc_advance(v_desc, T::kstep(kk, T::kResAtomBytes)),
            sm90::desc_advance(do_desc,
                               st_off + T::kstep(kk, T::kStrAtomBytes)),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      phases.mark(kScores);

      // p^T = exp2(s * scale * log2 e - lse * log2 e). On a tile that needs
      // the mask, a hidden score becomes -inf and gives p = 0 exactly; rows
      // past Sq are masked too, so their p is 0 whatever lse stands there.
      const bool mask = (causal && q_base + q0 < k_base + kc0 + 63) ||
                        kc0 + 64 > kv_len || q0 + kStream > sq;
      if (mask) {
        // Kept a branch: without the asm the compiler turns the masking
        // into selects that run on every tile.
        asm volatile("");
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = q0 + 8 * j + 2 * t + (i & 1);
            const int key = key0 + 8 * (i >> 1);
            if ((causal && q_base + row < k_base + key) || key >= kv_len ||
                row >= sq) {
              s[4 * j + i] = -INFINITY;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(neg_lse_s +
                                                           8 * j + 2 * t);
        const float neg[2] = {l2.x, l2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[4 * j + i] = exp2_approx(fmaf(s[4 * j + i], scale_log2,
                                          neg[i & 1]));
        }
      }
      uint32_t pa[16];
      pack_a(pa, s);
      phases.mark(kPds);

      // dV += P^T dO, issued here to run while dS^T is formed.
      sm90::fence_regs(acc_dv);
      sm90::wgmma_fence();
      mma_rs<D, kStream>(acc_dv, pa, sm90::desc_advance(do_mn, st_off));
      sm90::wgmma_commit();
      phases.mark(kGrads);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(dp);
      phases.mark(kScores);

      // dS^T = P^T (dP^T - delta) * scale, rounded to bf16.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j +
                                                           2 * t);
        const float del[2] = {d2.x, d2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - del[i & 1]) *
                         sm_scale;
        }
      }
      uint32_t dsa[16];
      pack_a(dsa, s);
      phases.mark(kPds);

      // dK += dS^T Q; then the stage goes back to the producer.
      sm90::fence_regs(acc_dk);
      sm90::wgmma_fence();
      mma_rs<D, kStream>(acc_dk, dsa, sm90::desc_advance(q_mn, st_off));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dk);
      sm90::fence_regs(acc_dv);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
      phases.mark(kGrads);
    }

    // Keys at or past kv_len get zeros; no row past Sk is written.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= sk) continue;
      const float keep = key < kv_len ? 1.f : 0.f;
      const size_t off = ((size_t)bkv * sk + key) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
            pack_bf16(acc_dk[4 * j + 2 * r] * keep,
                      acc_dk[4 * j + 2 * r + 1] * keep);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(acc_dv[4 * j + 2 * r] * keep,
                      acc_dv[4 * j + 2 * r + 1] * keep);
      }
    }
    phases.mark(kEpilogue);
    phases.flush(1, lane);
  }
}

// dq: one block = one (batch * q head, 128-row q tile), blockIdx.x the q
// head and blockIdx.y counting q tiles from the last, so the tiles with
// the most causal work launch first. Consumer c owns rows [64c, 64c + 64);
// warp w and lane (g, t) hold rows 16w + g and 16w + g + 8 of its 64, and
// columns 8j + 2t, 8j + 2t + 1 of every chunk j (keys of the K/V tile for
// S and dP; head-dim columns for dQ).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int hq, int hkv, int sq,
                         int causal, float sm_scale, float scale_log2,
                         int q_base, int k_base, int kv_len) {
  using T = Tiles<D>;
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kResident;
  const int kv_head = (bh / hq) * hkv + (bh % hq) / (hq / hkv);

  // Key columns [0, n_cols) hold every key this tile can see: up to the
  // causal diagonal of its last real row, in global positions.
  const int q_last = q_base + min(q0 + kResident, sq) - 1;
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_last - k_base + 1));
  const int n_tiles = (n_cols + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::mbar_arrive_expect_tx(bar_q, 2 * T::kResBytes);
      for (int a = 0; a < T::kAtoms; ++a) {
        sm90::tma_load_3d(smem + L::kQ + a * T::kResAtomBytes, &tm_q, bar_q,
                          a * T::kAtomCols, q0, bh);
        sm90::tma_load_3d(smem + L::kDO + a * T::kResAtomBytes, &tm_do,
                          bar_q, a * T::kAtomCols, q0, bh);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        sm90::mbar_wait(empty + st, ((kt / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full + st, 2 * T::kKeyBytes);
        for (int a = 0; a < T::kAtoms; ++a) {
          const int off = st * T::kKeyBytes + a * T::kKeyAtomBytes;
          sm90::tma_load_3d(smem + L::kK + off, &tm_k, full + st,
                            a * T::kAtomCols, kt * kDqKeys, kv_head);
          sm90::tma_load_3d(smem + L::kV + off, &tm_v, full + st,
                            a * T::kAtomCols, kt * kDqKeys, kv_head);
        }
      }
    }
  } else {
    sm90::regs_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * c + 16 * warp + g;  // and row0 + 8
    const int first_qpos = q_base + q0 + 64 * c;
    // Descriptors of the consumer's q and dO rows and of stage 0's K and V
    // tiles, made once: a k-step or a stage moves them by a byte offset.
    const uint64_t q_desc = T::kmajor(smem + L::kQ + 64 * c * T::kRowBytes);
    const uint64_t do_desc = T::kmajor(smem + L::kDO + 64 * c * T::kRowBytes);
    const uint64_t k_desc = T::kmajor(smem + L::kK);
    const uint64_t v_desc = T::kmajor(smem + L::kV);
    const uint64_t k_mn = T::mnmajor(smem + L::kK, T::kKeyAtomBytes);

    // Rows past Sq see zero q and dO: their ds is 0 and they are not
    // written, so their lse and delta only need to be finite.
    float neg_lse[2], row_delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      neg_lse[r] = row < sq ? -lse[(size_t)bh * sq + row] * kLog2e : 0.f;
      row_delta[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }

    float acc[D / 2], s[kDqKeys / 2], dp[kDqKeys / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) s[i] = dp[i] = 0.f;

    PhaseClock phases;
    if (n_tiles > 0) sm90::mbar_wait(bar_q, 0);
    phases.mark(kWait);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      const int k0 = kt * kDqKeys;
      const uint32_t st_off = st * T::kKeyBytes;
      sm90::mbar_wait(full + st, (kt / kStages) & 1);
      phases.mark(kWait);
      phases.tile();

      // S = Q K^T and dP = dO V^T, committed as two groups.
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::WgmmaSS<kDqKeys, 0>::mma(
            s, sm90::desc_advance(q_desc, T::kstep(kk, T::kResAtomBytes)),
            sm90::desc_advance(k_desc,
                               st_off + T::kstep(kk, T::kKeyAtomBytes)),
            kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::WgmmaSS<kDqKeys, 0>::mma(
            dp, sm90::desc_advance(do_desc, T::kstep(kk, T::kResAtomBytes)),
            sm90::desc_advance(v_desc,
                               st_off + T::kstep(kk, T::kKeyAtomBytes)),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      phases.mark(kScores);

      const bool mask = (causal && k_base + k0 + kDqKeys - 1 > first_qpos) ||
                        k0 + kDqKeys > kv_len;
      if (mask) {
        asm volatile("");  // kept a branch, as in the dk/dv kernel
#pragma unroll
        for (int j = 0; j < kDqKeys / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + 8 * j + 2 * t + (i & 1);
            const int row_pos = q_base + row0 + 8 * (i >> 1);
            if ((causal && row_pos < k_base + col) || col >= kv_len) {
              s[4 * j + i] = -INFINITY;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) {
        s[i] = exp2_approx(fmaf(s[i], scale_log2, neg_lse[(i >> 1) & 1]));
      }
      phases.mark(kPds);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      phases.mark(kScores);
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) {
        s[i] = s[i] * (dp[i] - row_delta[(i >> 1) & 1]) * sm_scale;
      }
      uint32_t dsa[kDqKeys / 4];
      pack_a(dsa, s);
      phases.mark(kPds);

      // dQ += dS K, K read MN-major; then the stage goes back.
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      mma_rs<D, kDqKeys>(acc, dsa, sm90::desc_advance(k_mn, st_off));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
      phases.mark(kGrads);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      uint16_t* orow = dq + ((size_t)bh * sq + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
    phases.mark(kEpilogue);
    phases.flush(0, lane);
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
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int batch, int hq,
                           int hkv, int sq, int sk, int causal,
                           float sm_scale, int q_base, int k_base,
                           int kv_len, cudaStream_t stream) {
  using L = DqLayout<D>;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_bwd_dq_sm90_kernel<D>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  if (sq == 0) return cudaSuccess;
  // With no keys (Sk 0) no K/V tile is ever loaded; q stands in for the
  // K/V maps so that they still describe real memory.
  if (sk == 0) k = v = q;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!host::encode_bf16_rows(&tm_q, q, D, sq, batch * hq, kResident) ||
      !host::encode_bf16_rows(&tm_do, dout, D, sq, batch * hq, kResident) ||
      !host::encode_bf16_rows(&tm_k, k, D, sk > 0 ? sk : 1, batch * hkv,
                              kDqKeys) ||
      !host::encode_bf16_rows(&tm_v, v, D, sk > 0 ? sk : 1, batch * hkv,
                              kDqKeys)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(batch * hq, (sq + kResident - 1) / kResident);
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<uint16_t*>(dq), hq,
      hkv, sq, causal, sm_scale, sm_scale * kLog2e, q_base, k_base, kv_len);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            int batch, int hq, int hkv, int sq, int sk,
                            int causal, float sm_scale, int q_base,
                            int k_base, int kv_len, cudaStream_t stream) {
  using L = DkvLayout<D>;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_bwd_dkv_sm90_kernel<D>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  if (sk == 0) return cudaSuccess;
  // With no queries (Sq 0) every block has no q tile to walk, so the q-side
  // maps are never read; k only gives them a valid address.
  if (sq == 0) q = dout = k;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!host::encode_bf16_rows(&tm_q, q, D, sq > 0 ? sq : 1, batch * hq,
                              kStream) ||
      !host::encode_bf16_rows(&tm_do, dout, D, sq > 0 ? sq : 1, batch * hq,
                              kStream) ||
      !host::encode_bf16_rows(&tm_k, k, D, sk, batch * hkv, kResident) ||
      !host::encode_bf16_rows(&tm_v, v, D, sk, batch * hkv, kResident)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(batch * hkv, (sk + kResident - 1) / kResident);
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), hq, hkv, sq, sk, causal, sm_scale,
      sm_scale * kLog2e, q_base, k_base, kv_len);
  return cudaSuccess;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int dtype,
              int batch, int hq, int hkv, int sq, int sk, int causal,
              float sm_scale, int q_base, int k_base, int kv_len,
              cudaStream_t stream) {
  if (dtype == 0) {
    const cudaError_t err = launch_dq_bf16<D>(
        q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, sk, causal,
        sm_scale, q_base, k_base, kv_len, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
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
    const cudaError_t err = launch_dkv_bf16<D>(
        q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, causal,
        sm_scale, q_base, k_base, kv_len, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
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

// dtype: 0 = bf16 (the Hopper kernels), 1 = f32 (check kernels). Tensors
// are contiguous and 16-byte aligned (the Python wrapper checks); lse and
// delta are f32. Each call launches one kernel on `stream`, allocates
// nothing, and returns the first error of the set-up or cudaGetLastError()
// after the launch (0 on success).
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

#ifdef FLASH_BWD_PHASE_CLOCKS
// Copies the totals (2 x (kPhases + 1) values: the dq kernel's phase
// cycles and streamed tiles, then the dk/dv kernel's) to `host_cycles` and
// zeroes them; synchronous. Returns a cudaError_t (0 on success).
extern "C" int flash_bwd_phase_cycles(unsigned long long* host_cycles) {
  cudaError_t err = cudaMemcpyFromSymbol(host_cycles, g_phase_cycles,
                                         sizeof(g_phase_cycles));
  if (err == cudaSuccess) {
    const unsigned long long zero[2][kPhases + 1] = {};
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
