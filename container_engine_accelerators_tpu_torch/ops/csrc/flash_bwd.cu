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
// gradient, as the port's forward gives it out = 0; (2) the dk/dv kernel
// sums the GQA group in f32 (inside one block per KV head, or over the
// blocks of a split group and a fixed-order reduction), so dk and dv are
// rounded once (the JAX kernel writes per-q-head outputs and its caller
// sums them), and key rows at or past kv_len get dk = dv = 0, the true
// gradient (the JAX caller slices those rows away).
//
// What bounds it on H100. Per visible (q, k) pair the dq kernel does three
// products (s, dp, dq: 6 * D FLOPs) and the dk/dv kernel four (s, dp, dv,
// dk: 8 * D FLOPs); bytes are q, k, v, dO, lse, delta read once and the
// gradients written once. At the Llama-3-8B training shapes (Hq 32, Hkv 8,
// D 128, causal S = 2048..16384) that is hundreds to thousands of FLOPs per
// byte, far above the card's ridge of about 295 (989 TFLOP/s bf16 or f16
// dense over 3.35 TB/s): both kernels are bound by the tensor cores' rate.
//
// Head dims: the kernels are built for D = 32, 64, 128 and 256, and a head
// dim d in between (a multiple of 8) runs the next D up with d passed at
// run time, as in flash_fwd.cu: columns past d read as zeros through the
// TMA maps and are not stored, at D / d the operations. At D 256 the
// streamed tiles are 32 rows (dq: keys; dk/dv: q rows) and the dk/dv
// kernel walks its q tiles twice (DkvLayout). Past 256 (up to
// host::kMaxHeadDim) two more kernels cut the gradients' columns into
// chunks, every chunk block recomputing S and dP over the whole d (at d
// 288: dq 2 chunks, 1.7x its 6 * d FLOPs a pair; dk/dv 3, 2.1x its 8 * d),
// with every atom streamed from L2 per tile ("Head widths past 256").
//
// The GQA split. The dk/dv grid is B * Hkv * key tiles (* column chunks)
// blocks, which a model with few KV heads leaves short of the 132 SMs (one
// KV head at S 4096: 32 blocks). Where it is short, host::dkv_plan spreads
// each KV head's q heads over `split` blocks; each writes f32 partial dK and
// dV and dkv_reduce_kernel sums them in split order and rounds once, so dk
// and dv are still rounded once after the group sum in f32, and the same
// inputs give the same bits on every run (no atomics).
//
// What the design does about it (bf16 and f16). Both
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
// tiles 64 keys. The consumers spend most of their cycles in the p/ds
// step. Left for later, each to be tried only with a measurement: fusing
// dq into the dk/dv kernel with f32 reduce-adds (5 products per pair, not
// 7), a TMA store of the gradients, keeping the resident operand of the
// wide kernels resident where it fits.
//
// f32 (for checking) runs plain SIMT kernels: one warp per query row (dq) or
// per key row (dk/dv) that walks the visible partners one at a time.

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
constexpr int kResident = 128; // rows of the resident operand per block

// Shared-memory geometry of 16-bit tiles of head dim D in TMA's swizzled
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
  // A resident tile (128 rows); the streamed tiles are the layouts'.
  static constexpr int kResAtomBytes = kResident * kRowBytes;
  static constexpr int kResBytes = kResident * D * 2;

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
// tiles (kStream rows each) with their kStream lse and delta values. At D
// 256 the tiles are 32 rows (K and V take 128 KB, a 2-stage ring of 64-row
// tiles another 128 KB: past the 227 KB a block may have), and the block
// walks its q tiles twice, forming dV on the first walk and dK on the
// second (kPasses): dK and dV together would take 256 f32 registers a
// thread, past the consumers' 240. The second walk recomputes S^T, so the
// kernel does 10 * D FLOPs a visible pair instead of 8 * D. (Two blocks of
// 128 columns each, one walk, do 12 * D over the two, and ran 13-16 %
// slower on the card at Gemma-2B's shape: PERF.md.)
template <int D>
struct DkvLayout {
  using T = Tiles<D>;
  static constexpr int kStream = D > 128 ? 32 : 64;
  static constexpr int kPasses = D > 128 ? 2 : 1;
  static constexpr int kStrAtomBytes = kStream * T::kRowBytes;
  static constexpr int kStrBytes = kStream * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = T::kResBytes;
  static constexpr int kQ = 2 * T::kResBytes;           // + stage * tile
  static constexpr int kDO = kQ + kStages * kStrBytes;  // + stage * tile
  static constexpr int kLse = kDO + kStages * kStrBytes;  // + 4 kStream st
  // (kLse holds -lse * log2 e, the exponent's offset, not lse itself.)
  static constexpr int kDelta = kLse + kStages * kStream * 4;
  static constexpr int kBars = kDelta + kStages * kStream * 4;
  static constexpr int kNumBars = 1 + 2 * kStages;  // k/v, full, empty
  static constexpr int kStageTx = 2 * kStrBytes;
  // Barriers, and slack to align the dynamic base to 1024 bytes.
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

// dq block: q and dO resident (128 rows each), then a ring of K and V
// tiles (kKeys keys each: 64, and 32 at D 256, where q and dO take 128 KB
// and a 2-stage ring of 64-key tiles another 128 KB).
template <int D>
struct DqLayout {
  using T = Tiles<D>;
  static constexpr int kKeys = D > 128 ? 32 : 64;
  static constexpr int kKeyAtomBytes = kKeys * T::kRowBytes;
  static constexpr int kKeyBytes = kKeys * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = T::kResBytes;
  static constexpr int kK = 2 * T::kResBytes;           // + stage * tile
  static constexpr int kV = kK + kStages * kKeyBytes;   // + stage * tile
  static constexpr int kBars = kV + kStages * kKeyBytes;
  static constexpr int kNumBars = 1 + 2 * kStages;  // q/dO, full, empty
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (sm90::smem_addr(raw) & 1023)) & 1023);
}

// Packs a 64 x N f32 accumulator (N / 2 registers), rounded to E, into the
// A registers of N / 16 k16 steps: chunks 2k and 2k + 1 form step k.
template <typename E, int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[R / 2],
                                       const float (&x)[R]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    a[4 * (j / 2) + 2 * (j % 2)] = sm90::pack2<E>(x[4 * j], x[4 * j + 1]);
    a[4 * (j / 2) + 2 * (j % 2) + 1] =
        sm90::pack2<E>(x[4 * j + 2], x[4 * j + 3]);
  }
}

// acc (64 x D) += A (64 x K, the registers pack_a makes) * B (K x D, read
// MN-major through descriptor `b`, see Tiles::mnmajor): K / 16 RS wgmma
// steps, issued but not committed.
template <typename E, int D, int K>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[K / 4],
                                       uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    sm90::WgmmaRS<D, 1, E>::mma(
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

// Which gradients a walk of the dk/dv kernel over its q tiles forms.
template <bool Dv, bool Dk>
struct Grads {
  static constexpr bool kDv = Dv, kDk = Dk;
};

// dk/dv: one block = one (batch * KV head, GQA split, 128-key tile):
// blockIdx.x = bkv * split + gs and blockIdx.y the key tile, so key tile 0
// (which, causal, sees every query) launches first. The block walks the q
// heads [gs, gs + 1) * group / split of its KV head's group (host::dkv_plan
// splits a group where the blocks would not fill the card). With split 1
// it writes dk and dv in E; with a split it writes its f32 partial sums
// to `partial` ([2][split][B * Hkv][Sk][d], dk's then dv's), which
// dkv_reduce_kernel sums in split order. Warpgroup 0 loads; consumer c =
// 0, 1 owns keys [64c, 64c + 64). In a consumer, warp w and lane (g = lane
// / 4, t = lane % 4) hold keys 16w + g and 16w + g + 8 of its 64 (rows of
// S^T, dK, dV), and columns 8j + 2t, 8j + 2t + 1 of every 8-column chunk j
// (query rows of the q tile for S^T; head-dim columns for dK, dV). D is
// the kernel's width and `d` (<= D, a multiple of 8) the tensors', as in
// the forward: columns past d read as zeros and are not stored. E is the
// element type of q, k, v, dO, dk and dv.
template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int hq, int hkv, int sq, int sk, int d, int causal,
                          float sm_scale, float scale_log2, int q_base,
                          int k_base, int kv_len, int split,
                          float* __restrict__ partial) {
  using T = Tiles<D>;
  using L = DkvLayout<D>;
  constexpr int kStream = L::kStream;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int gs = blockIdx.x % split;
  const int bkv = blockIdx.x / split;
  const int n_bkv = gridDim.x / split;
  const int k0 = blockIdx.y * kResident;
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;
  const int heads = group / split;
  const int head0 = b * hq + kvh * group + gs * heads;

  // The (q head, q tile) pairs of the block: for each of its heads, the q
  // tiles from the first with a row that sees the block's first key
  // (global positions, clamped at 0) on. A block wholly past kv_len has
  // none. Each of the kPasses walks goes over all of them.
  const int n_qt = (sq + kStream - 1) / kStream;
  const int first_qt = causal ? max(0, k_base + k0 - q_base) / kStream : 0;
  const int per_head = k0 < kv_len ? max(0, n_qt - first_qt) : 0;
  const int n_items = heads * per_head;

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
    // issues the TMA loads; every lane stores its share of the tile's
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
      for (int it = 0; it < L::kPasses * n_items; ++it) {
        const int st = it % kStages;
        const int item = it % n_items;
        const int bh = head0 + item / per_head;
        const int q0 = (first_qt + item % per_head) * kStream;
        sm90::mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(full + st, L::kStageTx);
          for (int a = 0; a < T::kAtoms; ++a) {
            const int off = st * L::kStrBytes + a * L::kStrAtomBytes;
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
    const uint64_t q_mn = T::mnmajor(smem + L::kQ, L::kStrAtomBytes);
    const uint64_t do_mn = T::mnmajor(smem + L::kDO, L::kStrAtomBytes);

    PhaseClock phases;
    if (n_items > 0) sm90::mbar_wait(bar_kv, 0);
    phases.mark(kWait);

    // One walk over the block's items from ring position it0: S^T always,
    // then dV += P^T dO (grads.kDv) and dP^T and dK += dS^T Q (grads.kDk).
    auto walk = [&](auto grads, float (&acc_dv)[D / 2],
                    float (&acc_dk)[D / 2], int it0) {
      constexpr bool kDv = decltype(grads)::kDv;
      constexpr bool kDk = decltype(grads)::kDk;
      float s[kStream / 2], dp[kStream / 2];
#pragma unroll
      for (int i = 0; i < kStream / 2; ++i) s[i] = dp[i] = 0.f;
      for (int i = 0; i < n_items; ++i) {
        const int it = it0 + i;
        const int st = it % kStages;
        const int q0 = (first_qt + i % per_head) * kStream;
        const uint32_t st_off = st * L::kStrBytes;
        const float* neg_lse_s = reinterpret_cast<const float*>(
            smem + L::kLse + st * kStream * 4);
        const float* delta_s = reinterpret_cast<const float*>(
            smem + L::kDelta + st * kStream * 4);
        sm90::mbar_wait(full + st, (it / kStages) & 1);
        phases.mark(kWait);
        phases.tile();

        // S^T = K Q^T and dP^T = V dO^T, committed as two groups.
        sm90::fence_regs(s);
        if constexpr (kDk) sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          sm90::WgmmaSS<kStream, 0, E>::mma(
              s, sm90::desc_advance(k_desc, T::kstep(kk, T::kResAtomBytes)),
              sm90::desc_advance(q_desc,
                                 st_off + T::kstep(kk, L::kStrAtomBytes)),
              kk > 0);
        }
        sm90::wgmma_commit();
        if constexpr (kDk) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            sm90::WgmmaSS<kStream, 0, E>::mma(
                dp,
                sm90::desc_advance(v_desc, T::kstep(kk, T::kResAtomBytes)),
                sm90::desc_advance(do_desc,
                                   st_off + T::kstep(kk, L::kStrAtomBytes)),
                kk > 0);
          }
          sm90::wgmma_commit();
        }
        sm90::wgmma_wait<kDk ? 1 : 0>();
        sm90::fence_regs(s);
        phases.mark(kScores);

        // p^T = exp2(s * scale * log2 e - lse * log2 e). On a tile that
        // needs the mask, a hidden score becomes -inf and gives p = 0
        // exactly; rows past Sq are masked too, so their p is 0 whatever
        // lse stands there.
        const bool mask = (causal && q_base + q0 < k_base + kc0 + 63) ||
                          kc0 + 64 > kv_len || q0 + kStream > sq;
        if (mask) {
          // Kept a branch: without the asm the compiler turns the masking
          // into selects that run on every tile.
          asm volatile("");
#pragma unroll
          for (int j = 0; j < kStream / 8; ++j) {
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
        for (int j = 0; j < kStream / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(neg_lse_s +
                                                             8 * j + 2 * t);
          const float neg[2] = {l2.x, l2.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[4 * j + i] = exp2_approx(fmaf(s[4 * j + i], scale_log2,
                                            neg[i & 1]));
          }
        }
        if constexpr (kDv) {
          uint32_t pa[kStream / 4];
          pack_a<E>(pa, s);
          phases.mark(kPds);

          // dV += P^T dO, issued here to run while dS^T is formed.
          sm90::fence_regs(acc_dv);
          sm90::wgmma_fence();
          mma_rs<E, D, kStream>(acc_dv, pa, sm90::desc_advance(do_mn, st_off));
          sm90::wgmma_commit();
          phases.mark(kGrads);
        }
        if constexpr (kDk) {
          sm90::wgmma_wait<kDv ? 1 : 0>();
          sm90::fence_regs(dp);
          phases.mark(kScores);

          // dS^T = P^T (dP^T - delta) * scale, rounded to E.
#pragma unroll
          for (int j = 0; j < kStream / 8; ++j) {
            const float2 d2 = *reinterpret_cast<const float2*>(delta_s +
                                                               8 * j + 2 * t);
            const float del[2] = {d2.x, d2.y};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - del[i & 1]) *
                             sm_scale;
            }
          }
          uint32_t dsa[kStream / 4];
          pack_a<E>(dsa, s);
          phases.mark(kPds);

          // dK += dS^T Q.
          sm90::fence_regs(acc_dk);
          sm90::wgmma_fence();
          mma_rs<E, D, kStream>(acc_dk, dsa, sm90::desc_advance(q_mn, st_off));
          sm90::wgmma_commit();
        }
        // Then the stage goes back to the producer.
        sm90::wgmma_wait<0>();
        if constexpr (kDk) sm90::fence_regs(acc_dk);
        if constexpr (kDv) sm90::fence_regs(acc_dv);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + st);
        phases.mark(kGrads);
      }
    };

    // Keys at or past kv_len get zeros; no row past Sk is written, nor a
    // column past d. `which`: 0 dk, 1 dv (its half of `partial`).
    auto store = [&](uint16_t* grad, int which, const float (&acc)[D / 2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= sk) continue;
        const float keep = key < kv_len ? 1.f : 0.f;
        const size_t at = ((size_t)bkv * sk + key) * d + 2 * t;
        const size_t part = ((size_t)which * split + gs) * n_bkv * sk * d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (8 * j >= d) break;  // d % 8 == 0: a chunk is wholly in or out
          const float lo = acc[4 * j + 2 * r] * keep;
          const float hi = acc[4 * j + 2 * r + 1] * keep;
          if (partial != nullptr) {
            *reinterpret_cast<float2*>(partial + part + at + 8 * j) =
                make_float2(lo, hi);
          } else {
            *reinterpret_cast<uint32_t*>(grad + at + 8 * j) =
                sm90::pack2<E>(lo, hi);
          }
        }
      }
    };

    if constexpr (L::kPasses == 1) {
      float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
      walk(Grads<true, true>{}, acc_dv, acc_dk, 0);
      store(dk, 0, acc_dk);
      store(dv, 1, acc_dv);
    } else {
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      walk(Grads<true, false>{}, acc, acc, 0);
      store(dv, 1, acc);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      walk(Grads<false, true>{}, acc, acc, n_items);
      store(dk, 0, acc);
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
// S and dP; head-dim columns for dQ). `d` as in the dk/dv kernel; it is
// the last parameter because before `causal` it made the D 128 kernel 11 %
// slower on the card, the same source otherwise (PERF.md).
template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int hq, int hkv, int sq,
                         int causal, float sm_scale, float scale_log2,
                         int q_base, int k_base, int kv_len, int d) {
  using T = Tiles<D>;
  using L = DqLayout<D>;
  constexpr int kKeys = L::kKeys;
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
  const int n_tiles = (n_cols + kKeys - 1) / kKeys;

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
        sm90::mbar_arrive_expect_tx(full + st, 2 * L::kKeyBytes);
        for (int a = 0; a < T::kAtoms; ++a) {
          const int off = st * L::kKeyBytes + a * L::kKeyAtomBytes;
          sm90::tma_load_3d(smem + L::kK + off, &tm_k, full + st,
                            a * T::kAtomCols, kt * kKeys, kv_head);
          sm90::tma_load_3d(smem + L::kV + off, &tm_v, full + st,
                            a * T::kAtomCols, kt * kKeys, kv_head);
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
    const uint64_t k_mn = T::mnmajor(smem + L::kK, L::kKeyAtomBytes);

    // Rows past Sq see zero q and dO: their ds is 0 and they are not
    // written, so their lse and delta only need to be finite.
    float neg_lse[2], row_delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      neg_lse[r] = row < sq ? -lse[(size_t)bh * sq + row] * kLog2e : 0.f;
      row_delta[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }

    float acc[D / 2], s[kKeys / 2], dp[kKeys / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = dp[i] = 0.f;

    PhaseClock phases;
    if (n_tiles > 0) sm90::mbar_wait(bar_q, 0);
    phases.mark(kWait);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      const int k0 = kt * kKeys;
      const uint32_t st_off = st * L::kKeyBytes;
      sm90::mbar_wait(full + st, (kt / kStages) & 1);
      phases.mark(kWait);
      phases.tile();

      // S = Q K^T and dP = dO V^T, committed as two groups.
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::WgmmaSS<kKeys, 0, E>::mma(
            s, sm90::desc_advance(q_desc, T::kstep(kk, T::kResAtomBytes)),
            sm90::desc_advance(k_desc,
                               st_off + T::kstep(kk, L::kKeyAtomBytes)),
            kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::WgmmaSS<kKeys, 0, E>::mma(
            dp, sm90::desc_advance(do_desc, T::kstep(kk, T::kResAtomBytes)),
            sm90::desc_advance(v_desc,
                               st_off + T::kstep(kk, L::kKeyAtomBytes)),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      phases.mark(kScores);

      const bool mask = (causal && k_base + k0 + kKeys - 1 > first_qpos) ||
                        k0 + kKeys > kv_len;
      if (mask) {
        asm volatile("");  // kept a branch, as in the dk/dv kernel
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
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
      for (int i = 0; i < kKeys / 2; ++i) {
        s[i] = exp2_approx(fmaf(s[i], scale_log2, neg_lse[(i >> 1) & 1]));
      }
      phases.mark(kPds);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      phases.mark(kScores);
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        s[i] = s[i] * (dp[i] - row_delta[(i >> 1) & 1]) * sm_scale;
      }
      uint32_t dsa[kKeys / 4];
      pack_a<E>(dsa, s);
      phases.mark(kPds);

      // dQ += dS K, K read MN-major; then the stage goes back.
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      mma_rs<E, D, kKeys>(acc, dsa, sm90::desc_advance(k_mn, st_off));
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
      uint16_t* orow = dq + ((size_t)bh * sq + row) * d + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (8 * j >= d) break;  // d % 8 == 0: a chunk is wholly in or out
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            sm90::pack2<E>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
    phases.mark(kEpilogue);
    phases.flush(0, lane);
  }
}

// ---- Head widths past 256: column chunks ------------------------------
//
// As in flash_fwd.cu's wide kernel, nothing of width d stays resident: the
// score products (S and dP over the whole d) stream their operands' 64-
// column atoms through a ring of score stages, one stage an atom, and the
// consumers hand each atom's stage back once its products are done (one
// group stays in flight). A block forms only its column chunk of the
// gradients, from a second ring that holds the chunk's atoms of the
// operand its gradient products read (dq: K; dk/dv: q and dO). Every chunk
// block of a tile recomputes S and dP over the whole d.

constexpr int kAtomRowBytes = 128;  // a row of one 64-column 16-bit atom

// dq past 256: a block is one (batch * q head, 128-row q tile, column
// chunk of at most kDqChunkAtoms atoms: 128 f32 registers, as at D 256).
// A score stage holds one atom of the block's q and dO rows and of a
// 64-key K and V tile; the chunk ring the tile's K atoms of the chunk.
constexpr int kDqChunkAtoms = 4;

struct DqWideLayout {
  static constexpr int kKeys = 64;
  static constexpr int kScoreStages = 3;
  static constexpr int kResAtomBytes = kResident * kAtomRowBytes;
  static constexpr int kKeyAtomBytes = kKeys * kAtomRowBytes;
  static constexpr int kDO = kResAtomBytes;       // in a score stage
  static constexpr int kK = 2 * kResAtomBytes;
  static constexpr int kV = kK + kKeyAtomBytes;
  static constexpr int kScoreBytes = kV + kKeyAtomBytes;
  static constexpr int kKc = kScoreStages * kScoreBytes;  // + stage * chunk
  static constexpr int kKcBytes = kDqChunkAtoms * kKeyAtomBytes;
  static constexpr int kBars = kKc + 2 * kKcBytes;
  static constexpr int kNumBars = 2 * kScoreStages + 4;  // full, empty x2
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

// dk/dv past 256: a block is one (batch * KV head, GQA split, column chunk
// of kDkvChunkAtoms atoms, 128-key tile): the D <= 256 kernel's grid with
// blockIdx.x = (bkv * split + gs) * n_chunks + chunk. A score stage holds one atom of the block's K and V rows and of a
// 64-row q and dO tile; the chunk ring the tile's q and dO atoms of the
// chunk, with its 64 lse and delta values.
struct DkvWideLayout {
  static constexpr int kStream = 64;
  static constexpr int kScoreStages = 3;
  static constexpr int kResAtomBytes = kResident * kAtomRowBytes;
  static constexpr int kStrAtomBytes = kStream * kAtomRowBytes;
  static constexpr int kV = kResAtomBytes;        // in a score stage
  static constexpr int kQ = 2 * kResAtomBytes;
  static constexpr int kDO = kQ + kStrAtomBytes;
  static constexpr int kScoreBytes = kDO + kStrAtomBytes;
  static constexpr int kC = kScoreStages * kScoreBytes;  // + stage * chunk
  static constexpr int kCDO = host::kDkvChunkAtoms * kStrAtomBytes;
  static constexpr int kCBytes = 2 * kCDO;        // q's atoms, then dO's
  static constexpr int kLse = kC + 2 * kCBytes;   // + 4 kStream stage
  static constexpr int kDelta = kLse + 2 * kStream * 4;
  static constexpr int kBars = kDelta + 2 * kStream * 4;
  static constexpr int kNumBars = 2 * kScoreStages + 4;
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

// A K-major descriptor of an atom's 64-column rows at `p`, and of an
// MN-major one (its rows are the product's k dimension) whose atoms are
// `atom_bytes` apart.
__device__ __forceinline__ uint64_t atom_kmajor(const uint8_t* p) {
  return sm90::make_desc(p, 16, 8 * kAtomRowBytes, sm90::kSwizzle128B);
}
__device__ __forceinline__ uint64_t atom_mnmajor(const uint8_t* p,
                                                 int atom_bytes) {
  return sm90::make_desc(p, atom_bytes, 8 * kAtomRowBytes,
                         sm90::kSwizzle128B);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(bar);
}

// acc[j] (64 x 64: the chunk's atom j, j < n_out) += A (64 x 16 * kSteps,
// the registers pack_a makes) * B (the chunk's atom j at b + j *
// atom_bytes, its rows the product's k dimension, read MN-major): issued,
// not committed.
template <typename E, int kSteps, int kAtoms>
__device__ __forceinline__ void mma_chunk(float (&acc)[kAtoms][32],
                                          const uint32_t (&a)[kSteps * 4],
                                          const uint8_t* b, int atom_bytes,
                                          int n_out) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
#pragma unroll
    for (int j = 0; j < kAtoms; ++j) {
      if (j >= n_out) break;
      sm90::WgmmaRS<64, 1, E>::mma(
          acc[j], ak,
          atom_mnmajor(b + j * atom_bytes + kk * 16 * kAtomRowBytes,
                       atom_bytes),
          1);
    }
  }
}

template <int kAtoms>
__device__ __forceinline__ void fence_chunk(float (&acc)[kAtoms][32]) {
#pragma unroll
  for (int j = 0; j < kAtoms; ++j) sm90::fence_regs(acc[j]);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int hq, int hkv, int sq,
                         int causal, float sm_scale, float scale_log2,
                         int q_base, int k_base, int kv_len, int d,
                         int n_chunks, int per) {
  using L = DqWideLayout;
  constexpr int kKeys = L::kKeys;
  constexpr int kS = L::kScoreStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full_s = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty_s = full_s + kS;
  uint64_t* full_k = empty_s + kS;
  uint64_t* empty_k = full_k + 2;

  const int bh = blockIdx.x;
  const int chunk = blockIdx.y % n_chunks;
  const int q0 = (gridDim.y / n_chunks - 1 - blockIdx.y / n_chunks) *
                 kResident;
  const int kv_head = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int n_atoms = (d + host::kAtomCols - 1) / host::kAtomCols;
  const int a0 = chunk * per;
  const int n_out = min(per, n_atoms - a0);

  const int q_last = q_base + min(q0 + kResident, sq) - 1;
  int n_cols = kv_len;
  if (causal) n_cols = max(0, min(kv_len, q_last - k_base + 1));
  const int n_tiles = (n_cols + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(full_s + s, 1);
      sm90::mbar_init(empty_s + s, kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(empty_k + s, kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    sm90::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        for (int a = 0; a < n_atoms; ++a, ++it) {
          const int st = it % kS;
          uint8_t* stage = smem + st * L::kScoreBytes;
          const int col = a * host::kAtomCols;
          sm90::mbar_wait(empty_s + st, ((it / kS) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(full_s + st, L::kScoreBytes);
          sm90::tma_load_3d(stage, &tm_q, full_s + st, col, q0, bh);
          sm90::tma_load_3d(stage + L::kDO, &tm_do, full_s + st, col, q0, bh);
          sm90::tma_load_3d(stage + L::kK, &tm_k, full_s + st, col,
                            kt * kKeys, kv_head);
          sm90::tma_load_3d(stage + L::kV, &tm_v, full_s + st, col,
                            kt * kKeys, kv_head);
        }
        const int ks = kt % 2;
        sm90::mbar_wait(empty_k + ks, ((kt / 2) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full_k + ks, n_out * L::kKeyAtomBytes);
        for (int j = 0; j < n_out; ++j) {
          sm90::tma_load_3d(
              smem + L::kKc + ks * L::kKcBytes + j * L::kKeyAtomBytes, &tm_k,
              full_k + ks, (a0 + j) * host::kAtomCols, kt * kKeys, kv_head);
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
    const int rows = 64 * c * kAtomRowBytes;  // the consumer's rows of an atom

    float neg_lse[2], row_delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      neg_lse[r] = row < sq ? -lse[(size_t)bh * sq + row] * kLog2e : 0.f;
      row_delta[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }

    float acc[kDqChunkAtoms][32], s[kKeys / 2], dp[kKeys / 2];
#pragma unroll
    for (int j = 0; j < kDqChunkAtoms; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = dp[i] = 0.f;

    int it = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kKeys;
      // S = Q K^T and dP = dO V^T over the atoms of d.
      for (int a = 0; a < n_atoms; ++a, ++it) {
        const int st = it % kS;
        const uint8_t* stage = smem + st * L::kScoreBytes;
        sm90::mbar_wait(full_s + st, (it / kS) & 1);
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (a * host::kAtomCols + 16 * kk >= d) break;
          sm90::WgmmaSS<kKeys, 0, E>::mma(
              s, atom_kmajor(stage + rows + 32 * kk),
              atom_kmajor(stage + L::kK + 32 * kk), a > 0 || kk > 0);
          sm90::WgmmaSS<kKeys, 0, E>::mma(
              dp, atom_kmajor(stage + L::kDO + rows + 32 * kk),
              atom_kmajor(stage + L::kV + 32 * kk), a > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (a > 0) release(empty_s + (it - 1) % kS, lane);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      release(empty_s + (it - 1) % kS, lane);

      const bool mask = (causal && k_base + k0 + kKeys - 1 > first_qpos) ||
                        k0 + kKeys > kv_len;
      if (mask) {
        asm volatile("");  // kept a branch, as in the dk/dv kernel
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
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
      for (int i = 0; i < kKeys / 2; ++i) {
        const float p = exp2_approx(fmaf(s[i], scale_log2,
                                         neg_lse[(i >> 1) & 1]));
        s[i] = p * (dp[i] - row_delta[(i >> 1) & 1]) * sm_scale;
      }
      uint32_t dsa[kKeys / 4];
      pack_a<E>(dsa, s);

      // dQ[:, chunk] += dS K[:, chunk], K read MN-major.
      const int ks = kt % 2;
      sm90::mbar_wait(full_k + ks, (kt / 2) & 1);
      fence_chunk(acc);
      sm90::wgmma_fence();
      mma_chunk<E, kKeys / 16>(acc, dsa, smem + L::kKc + ks * L::kKcBytes,
                            L::kKeyAtomBytes, n_out);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_chunk(acc);
      release(empty_k + ks, lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      uint16_t* orow = dq + ((size_t)bh * sq + row) * d + 2 * t;
#pragma unroll
      for (int j = 0; j < kDqChunkAtoms; ++j) {
        if (j >= n_out) break;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = (a0 + j) * host::kAtomCols + 8 * jj;
          if (col >= d) break;  // d % 8 == 0: a chunk is wholly in or out
          *reinterpret_cast<uint32_t*>(orow + col) =
              sm90::pack2<E>(acc[j][4 * jj + 2 * r],
                             acc[j][4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int hq, int hkv, int sq, int sk, int d, int causal,
                          float sm_scale, float scale_log2, int q_base,
                          int k_base, int kv_len, int n_chunks, int per,
                          int split, float* __restrict__ partial) {
  using L = DkvWideLayout;
  constexpr int kStream = L::kStream;
  constexpr int kS = L::kScoreStages;
  constexpr int kAtoms = host::kDkvChunkAtoms;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full_s = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty_s = full_s + kS;
  uint64_t* full_c = empty_s + kS;
  uint64_t* empty_c = full_c + 2;

  const int chunk = blockIdx.x % n_chunks;
  const int gs = (blockIdx.x / n_chunks) % split;
  const int bkv = blockIdx.x / n_chunks / split;
  const int n_bkv = gridDim.x / (n_chunks * split);
  const int k0 = blockIdx.y * kResident;
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;
  const int heads = group / split;
  const int head0 = b * hq + kvh * group + gs * heads;
  const int n_atoms = (d + host::kAtomCols - 1) / host::kAtomCols;
  const int a0 = chunk * per;
  const int n_out = min(per, n_atoms - a0);

  const int n_qt = (sq + kStream - 1) / kStream;
  const int first_qt = causal ? max(0, k_base + k0 - q_base) / kStream : 0;
  const int per_head = k0 < kv_len ? max(0, n_qt - first_qt) : 0;
  const int n_items = heads * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(full_s + s, 1);
      sm90::mbar_init(empty_s + s, kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      // The chunk's TMA issue and the 32 lanes that store lse and delta.
      sm90::mbar_init(full_c + s, 1 + 32);
      sm90::mbar_init(empty_c + s, kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: warp 0; lane 0 issues the TMA loads, every lane stores its
    // share of a tile's -lse * log2 e and delta (as the D <= 256 kernel).
    sm90::regs_dealloc<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      int it = 0;
      for (int item = 0; item < n_items; ++item) {
        const int bh = head0 + item / per_head;
        const int q0 = (first_qt + item % per_head) * kStream;
        if (lane == 0) {
          for (int a = 0; a < n_atoms; ++a, ++it) {
            const int st = it % kS;
            uint8_t* stage = smem + st * L::kScoreBytes;
            const int col = a * host::kAtomCols;
            sm90::mbar_wait(empty_s + st, ((it / kS) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(full_s + st, L::kScoreBytes);
            sm90::tma_load_3d(stage, &tm_k, full_s + st, col, k0, bkv);
            sm90::tma_load_3d(stage + L::kV, &tm_v, full_s + st, col, k0,
                              bkv);
            sm90::tma_load_3d(stage + L::kQ, &tm_q, full_s + st, col, q0,
                              bh);
            sm90::tma_load_3d(stage + L::kDO, &tm_do, full_s + st, col, q0,
                              bh);
          }
        }
        const int cs = item % 2;
        uint8_t* cstage = smem + L::kC + cs * L::kCBytes;
        sm90::mbar_wait(empty_c + cs, ((item / 2) & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(full_c + cs,
                                      2 * n_out * L::kStrAtomBytes);
          for (int j = 0; j < n_out; ++j) {
            const int col = (a0 + j) * host::kAtomCols;
            sm90::tma_load_3d(cstage + j * L::kStrAtomBytes, &tm_q,
                              full_c + cs, col, q0, bh);
            sm90::tma_load_3d(cstage + L::kCDO + j * L::kStrAtomBytes,
                              &tm_do, full_c + cs, col, q0, bh);
          }
        }
        float* neg_lse_s = reinterpret_cast<float*>(smem + L::kLse) +
                           cs * kStream;
        float* delta_s = reinterpret_cast<float*>(smem + L::kDelta) +
                         cs * kStream;
#pragma unroll
        for (int i = lane; i < kStream; i += 32) {
          const bool in = q0 + i < sq;
          neg_lse_s[i] = in ? -lse[(size_t)bh * sq + q0 + i] * kLog2e : 0.f;
          delta_s[i] = in ? delta[(size_t)bh * sq + q0 + i] : 0.f;
        }
        sm90::mbar_arrive(full_c + cs);
      }
    }
  } else {
    sm90::regs_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kc0 = k0 + 64 * c;           // the consumer's first key
    const int key0 = kc0 + 16 * warp + g;  // and key0 + 8
    const int rows = 64 * c * kAtomRowBytes;  // its keys' rows of an atom

    float acc_dk[kAtoms][32], acc_dv[kAtoms][32];
    float s[kStream / 2], dp[kStream / 2];
#pragma unroll
    for (int j = 0; j < kAtoms; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dk[j][i] = acc_dv[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kStream / 2; ++i) s[i] = dp[i] = 0.f;

    int it = 0;
    for (int item = 0; item < n_items; ++item) {
      const int q0 = (first_qt + item % per_head) * kStream;
      // S^T = K Q^T and dP^T = V dO^T over the atoms of d.
      for (int a = 0; a < n_atoms; ++a, ++it) {
        const int st = it % kS;
        const uint8_t* stage = smem + st * L::kScoreBytes;
        sm90::mbar_wait(full_s + st, (it / kS) & 1);
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (a * host::kAtomCols + 16 * kk >= d) break;
          sm90::WgmmaSS<kStream, 0, E>::mma(
              s, atom_kmajor(stage + rows + 32 * kk),
              atom_kmajor(stage + L::kQ + 32 * kk), a > 0 || kk > 0);
          sm90::WgmmaSS<kStream, 0, E>::mma(
              dp, atom_kmajor(stage + L::kV + rows + 32 * kk),
              atom_kmajor(stage + L::kDO + 32 * kk), a > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (a > 0) release(empty_s + (it - 1) % kS, lane);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      release(empty_s + (it - 1) % kS, lane);

      const int cs = item % 2;
      const uint8_t* cstage = smem + L::kC + cs * L::kCBytes;
      const float* neg_lse_s =
          reinterpret_cast<const float*>(smem + L::kLse) + cs * kStream;
      const float* delta_s =
          reinterpret_cast<const float*>(smem + L::kDelta) + cs * kStream;
      sm90::mbar_wait(full_c + cs, (item / 2) & 1);

      // p^T, masked as in the D <= 256 kernel.
      const bool mask = (causal && q_base + q0 < k_base + kc0 + 63) ||
                        kc0 + 64 > kv_len || q0 + kStream > sq;
      if (mask) {
        asm volatile("");
#pragma unroll
        for (int j = 0; j < kStream / 8; ++j) {
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
      for (int j = 0; j < kStream / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(neg_lse_s + 8 * j +
                                                           2 * t);
        const float neg[2] = {l2.x, l2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[4 * j + i] = exp2_approx(fmaf(s[4 * j + i], scale_log2,
                                          neg[i & 1]));
        }
      }
      uint32_t pa[kStream / 4];
      pack_a<E>(pa, s);
      // dV[:, chunk] += P^T dO[:, chunk], issued to run while dS^T forms.
      fence_chunk(acc_dv);
      sm90::wgmma_fence();
      mma_chunk<E, kStream / 16>(acc_dv, pa, cstage + L::kCDO, L::kStrAtomBytes,
                              n_out);
      sm90::wgmma_commit();
#pragma unroll
      for (int j = 0; j < kStream / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j +
                                                           2 * t);
        const float del[2] = {d2.x, d2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - del[i & 1]) *
                         sm_scale;
        }
      }
      uint32_t dsa[kStream / 4];
      pack_a<E>(dsa, s);
      // dK[:, chunk] += dS^T Q[:, chunk].
      fence_chunk(acc_dk);
      sm90::wgmma_fence();
      mma_chunk<E, kStream / 16>(acc_dk, dsa, cstage, L::kStrAtomBytes, n_out);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_chunk(acc_dk);
      fence_chunk(acc_dv);
      release(empty_c + cs, lane);
    }

    // As the D <= 256 kernel's store: keys at or past kv_len get zeros.
    auto store = [&](uint16_t* grad, int which,
                     const float (&acc)[kAtoms][32]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= sk) continue;
        const float keep = key < kv_len ? 1.f : 0.f;
        const size_t at = ((size_t)bkv * sk + key) * d + 2 * t;
        const size_t part = ((size_t)which * split + gs) * n_bkv * sk * d;
#pragma unroll
        for (int j = 0; j < kAtoms; ++j) {
          if (j >= n_out) break;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = (a0 + j) * host::kAtomCols + 8 * jj;
            if (col >= d) break;
            const float lo = acc[j][4 * jj + 2 * r] * keep;
            const float hi = acc[j][4 * jj + 2 * r + 1] * keep;
            if (partial != nullptr) {
              *reinterpret_cast<float2*>(partial + part + at + col) =
                  make_float2(lo, hi);
            } else {
              *reinterpret_cast<uint32_t*>(grad + at + col) =
                  sm90::pack2<E>(lo, hi);
            }
          }
        }
      }
    };
    store(dk, 0, acc_dk);
    store(dv, 1, acc_dv);
  }
}

// dk and dv in E from the split dk/dv kernels' f32 partials ([2][split]
// [n] floats, n = B * Hkv * Sk * d, a multiple of 8): each value the sum
// of its `split` partials in split order, in f32, rounded once, so the
// result does not depend on which block finished first. blockIdx.y: 0 dk,
// 1 dv.
template <typename E>
__global__ void __launch_bounds__(256)
dkv_reduce_kernel(const float* __restrict__ partial,
                  uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                  long long n, int split) {
  uint16_t* out = blockIdx.y ? dv : dk;
  const float* src = partial + (size_t)blockIdx.y * split * n;
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       i < n; i += 4LL * gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(src + i);
    for (int g = 1; g < split; ++g) {
      const float4 x =
          *reinterpret_cast<const float4*>(src + (size_t)g * n + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<uint2*>(out + i) =
        make_uint2(sm90::pack2<E>(acc.x, acc.y),
                   sm90::pack2<E>(acc.z, acc.w));
  }
}

constexpr int kRowsPerBlock = 8;  // f32 check kernels: one warp per row

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Column lane + 32 i of a row of d values; 0 past d.
__device__ __forceinline__ float col(const float* row, int lane, int i,
                                     int d) {
  const int c = lane + 32 * i;
  return c < d ? row[c] : 0.f;
}

// Stores x as column lane + 32 i of a row of d values, if it is one.
__device__ __forceinline__ void put(float* row, int lane, int i, int d,
                                    float x) {
  const int c = lane + 32 * i;
  if (c < d) row[c] = x;
}

// f32 dq: one warp per query row (a block's rows along blockIdx.x, the
// batch * q head folded_row()), lane holds D / 32 columns of the d; the
// row's visible keys are [0, n_cols), walked one at a time.
template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int n_bh, int hq, int hkv,
                        int sq, int sk, int d, int causal, float sm_scale,
                        int q_base, int k_base, int kv_len) {
  constexpr int kPer = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int bh = host::folded_row();
  if (row >= sq || bh >= n_bh) return;
  const int b = bh / hq, kvh = (bh % hq) / (hq / hkv);
  const float* kg = k + ((size_t)b * hkv + kvh) * sk * d;
  const float* vg = v + ((size_t)b * hkv + kvh) * sk * d;
  const size_t off = ((size_t)bh * sq + row) * d;
  float qv[kPer], dov[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qv[i] = col(q + off, lane, i, d);
    dov[i] = col(dout + off, lane, i, d);
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
      s += qv[i] * col(kg + (size_t)j * d, lane, i, d);
      dp += dov[i] * col(vg + (size_t)j * d, lane, i, d);
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    const float p = expf(s * sm_scale - row_lse);
    const float ds = p * (dp - row_delta) * sm_scale;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      acc[i] += ds * col(kg + (size_t)j * d, lane, i, d);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) put(dq + off, lane, i, d, acc[i]);
}

// f32 dk/dv: one warp per key row of one KV head (batch * KV head the
// folded_row()); walks the group's q heads and, in each, the query rows
// that see the key.
template <int D>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int n_bkv, int hq, int hkv, int sq, int sk, int d,
                         int causal, float sm_scale, int q_base, int k_base,
                         int kv_len) {
  constexpr int kPer = D / 32;
  const int lane = threadIdx.x % 32;
  const int key = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int bkv = host::folded_row();
  if (key >= sk || bkv >= n_bkv) return;
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;
  const size_t off = ((size_t)bkv * sk + key) * d;
  float kv_[kPer], vv[kPer], adk[kPer], adv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    kv_[i] = col(k + off, lane, i, d);
    vv[i] = col(v + off, lane, i, d);
    adk[i] = adv[i] = 0.f;
  }
  const int first = causal ? max(0, k_base + key - q_base) : 0;
  for (int hg = 0; key < kv_len && hg < group; ++hg) {
    const size_t bh = (size_t)b * hq + (size_t)kvh * group + hg;
    for (int row = first; row < sq; ++row) {
      const float* qr = q + (bh * sq + row) * d;
      const float* dr = dout + (bh * sq + row) * d;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s += kv_[i] * col(qr, lane, i, d);
        dp += vv[i] * col(dr, lane, i, d);
      }
      s = warp_sum(s);
      dp = warp_sum(dp);
      const float p = expf(s * sm_scale - lse[bh * sq + row]);
      const float ds = p * (dp - delta[bh * sq + row]) * sm_scale;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        adv[i] += p * col(dr, lane, i, d);
        adk[i] += ds * col(qr, lane, i, d);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    put(dk + off, lane, i, d, adk[i]);
    put(dv + off, lane, i, d, adv[i]);
  }
}

template <typename E, int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int batch, int hq,
                           int hkv, int sq, int sk, int d, int causal,
                           float sm_scale, int q_base, int k_base,
                           int kv_len, cudaStream_t stream) {
  using L = DqLayout<D>;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_bwd_dq_sm90_kernel<E, D>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  if (sq == 0) return cudaSuccess;
  // With no keys (Sk 0) no K/V tile is ever loaded; q stands in for the
  // K/V maps so that they still describe real memory.
  if (sk == 0) k = v = q;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!host::encode_rows<E>(&tm_q, q, d, sq, batch * hq, kResident, D) ||
      !host::encode_rows<E>(&tm_do, dout, d, sq, batch * hq, kResident,
                              D) ||
      !host::encode_rows<E>(&tm_k, k, d, sk > 0 ? sk : 1, batch * hkv,
                              L::kKeys, D) ||
      !host::encode_rows<E>(&tm_v, v, d, sk > 0 ? sk : 1, batch * hkv,
                              L::kKeys, D)) {
    return cudaErrorInvalidValue;
  }
  // batch * hq along x (up to 2^31 - 1 blocks): no fold is needed.
  const dim3 grid(batch * hq, (sq + kResident - 1) / kResident);
  flash_bwd_dq_sm90_kernel<E, D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<uint16_t*>(dq), hq,
      hkv, sq, causal, sm_scale, sm_scale * kLog2e, q_base, k_base, kv_len,
      d);
  return cudaSuccess;
}

template <typename E, int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            int batch, int hq, int hkv, int sq, int sk, int d,
                            int causal, float sm_scale, int q_base,
                            int k_base, int kv_len, const host::DkvPlan& plan,
                            float* partial, cudaStream_t stream) {
  using L = DkvLayout<D>;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_bwd_dkv_sm90_kernel<E, D>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  if (sk == 0) return cudaSuccess;
  // With no queries (Sq 0) every block has no q tile to walk, so the q-side
  // maps are never read; k only gives them a valid address.
  if (sq == 0) q = dout = k;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!host::encode_rows<E>(&tm_q, q, d, sq > 0 ? sq : 1, batch * hq,
                              L::kStream, D) ||
      !host::encode_rows<E>(&tm_do, dout, d, sq > 0 ? sq : 1, batch * hq,
                              L::kStream, D) ||
      !host::encode_rows<E>(&tm_k, k, d, sk, batch * hkv, kResident, D) ||
      !host::encode_rows<E>(&tm_v, v, d, sk, batch * hkv, kResident, D)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(batch * hkv * plan.split, (sk + kResident - 1) / kResident);
  flash_bwd_dkv_sm90_kernel<E, D><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), hq, hkv, sq, sk, d, causal, sm_scale,
      sm_scale * kLog2e, q_base, k_base, kv_len, plan.split, partial);
  return cudaSuccess;
}

// The wide kernels' maps: every box one 64-column atom (width 64: 128-byte
// rows) of `rows` rows.
template <typename E>
bool encode_atoms(CUtensorMap* map, const void* t, int d, int n, int heads,
                  int rows) {
  return host::encode_rows<E>(map, t, d, n > 0 ? n : 1, heads, rows,
                                host::kAtomCols);
}

template <typename E>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int batch, int hq,
                           int hkv, int sq, int sk, int d, int causal,
                           float sm_scale, int q_base, int k_base, int kv_len,
                           cudaStream_t stream) {
  using L = DqWideLayout;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_bwd_dq_wide_kernel<E>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  if (sq == 0) return cudaSuccess;
  if (sk == 0) k = v = q;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_atoms<E>(&tm_q, q, d, sq, batch * hq, kResident) ||
      !encode_atoms<E>(&tm_do, dout, d, sq, batch * hq, kResident) ||
      !encode_atoms<E>(&tm_k, k, d, sk, batch * hkv, L::kKeys) ||
      !encode_atoms<E>(&tm_v, v, d, sk, batch * hkv, L::kKeys)) {
    return cudaErrorInvalidValue;
  }
  const host::Chunks chunks = host::column_chunks(d, kDqChunkAtoms);
  const dim3 grid(batch * hq, (sq + kResident - 1) / kResident * chunks.n);
  flash_bwd_dq_wide_kernel<E><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<uint16_t*>(dq), hq,
      hkv, sq, causal, sm_scale, sm_scale * kLog2e, q_base, k_base, kv_len,
      d, chunks.n, chunks.per);
  return cudaSuccess;
}

template <typename E>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            int batch, int hq, int hkv, int sq, int sk, int d,
                            int causal, float sm_scale, int q_base,
                            int k_base, int kv_len, const host::DkvPlan& plan,
                            float* partial, cudaStream_t stream) {
  using L = DkvWideLayout;
  static std::atomic<uint64_t> configured{0};
  const cudaError_t err = host::allow_dynamic_smem(
      flash_bwd_dkv_wide_kernel<E>, L::kBytes, &configured);
  if (err != cudaSuccess) return err;
  if (sk == 0) return cudaSuccess;
  if (sq == 0) q = dout = k;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_atoms<E>(&tm_q, q, d, sq, batch * hq, L::kStream) ||
      !encode_atoms<E>(&tm_do, dout, d, sq, batch * hq, L::kStream) ||
      !encode_atoms<E>(&tm_k, k, d, sk, batch * hkv, kResident) ||
      !encode_atoms<E>(&tm_v, v, d, sk, batch * hkv, kResident)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(batch * hkv * plan.split * plan.chunks.n,
                  (sk + kResident - 1) / kResident);
  flash_bwd_dkv_wide_kernel<E><<<grid, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), hq, hkv, sq, sk, d, causal, sm_scale,
      sm_scale * kLog2e, q_base, k_base, kv_len, plan.chunks.n,
      plan.chunks.per, plan.split, partial);
  return cudaSuccess;
}

template <int D>
void launch_dq_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int batch, int hq, int hkv, int sq, int sk,
                   int d, int causal, float sm_scale, int q_base, int k_base,
                   int kv_len, cudaStream_t stream) {
  const dim3 grid = host::fold_rows(
      (sq + kRowsPerBlock - 1) / kRowsPerBlock, batch * hq);
  flash_bwd_dq_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), batch * hq, hq, hkv, sq, sk, d,
      causal, sm_scale, q_base, k_base, kv_len);
}

template <int D>
void launch_dkv_f32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int batch, int hq, int hkv, int sq,
                    int sk, int d, int causal, float sm_scale, int q_base,
                    int k_base, int kv_len, cudaStream_t stream) {
  const dim3 grid = host::fold_rows(
      (sk + kRowsPerBlock - 1) / kRowsPerBlock, batch * hkv);
  flash_bwd_dkv_f32_kernel<D><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), batch * hkv,
      hq, hkv, sq, sk, d, causal, sm_scale, q_base, k_base, kv_len);
}

// The arguments no kernel takes: an unknown dtype, a q-head count that is
// not a multiple of the KV heads, a head dim that is not a multiple of 8 in
// [8, kMaxHeadDim].
bool bad_args(int dtype, int hq, int hkv, int d) {
  return (dtype != host::kDtypeBf16 && dtype != host::kDtypeF32 &&
          dtype != host::kDtypeF16) ||
         hkv <= 0 || hq % hkv || d <= 0 || d > host::kMaxHeadDim || d % 8;
}

}  // namespace

// dtype: 0 = bf16 and 2 = f16 (the Hopper kernels), 1 = f32 (check
// kernels): host::kDtype*. Tensors are contiguous and 16-byte aligned (the
// Python wrapper checks); lse and delta are f32. The head dim d (a multiple
// of 8 up to kMaxHeadDim) runs the kernels built for the next of 32, 64, 128
// and 256, as in flash_fwd.cu, and past 256 (bf16, f16) the column-chunk
// kernels. Each call
// launches on `stream`, allocates nothing, and returns the first error of
// the set-up or cudaGetLastError() after the launches (0 on success).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int dtype, int batch, int hq,
                                   int hkv, int sq, int sk, int d, int causal,
                                   float sm_scale, int q_base, int k_base,
                                   int kv_len, void* stream) {
  if (bad_args(dtype, hq, hkv, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dtype == host::kDtypeF32) {
    host::with_f32_width(d, [&](auto width) {
      launch_dq_f32<decltype(width)::value>(
          q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, sk, d, causal,
          sm_scale, q_base, k_base, kv_len, st);
      return 0;
    });
  } else {
    err = host::with_elem(dtype, [&](auto elem) {
      using E = typename decltype(elem)::type;
      if (d > 256) {
        return launch_dq_wide<E>(q, k, v, dout, lse, delta, dq, batch, hq,
                                 hkv, sq, sk, d, causal, sm_scale, q_base,
                                 k_base, kv_len, st);
      }
      return host::with_width(d, [&](auto width) {
        return launch_dq_tc<E, decltype(width)::value>(
            q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, sk, d, causal,
            sm_scale, q_base, k_base, kv_len, st);
      });
    });
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The dk/dv launch also takes the card's SM count `n_sm` for its plan
// (host::dkv_plan): where the plan splits the GQA group (bf16, f16), the
// blocks write f32 partials to `partial`, which must hold
// flash_bwd_dkv_partial_floats(...) floats (`partial_floats` says how
// many it does), and a second kernel sums them into dk and dv.
extern "C" long long flash_bwd_dkv_partial_floats(int batch, int hq, int hkv,
                                                  int sk, int d, int n_sm) {
  const host::DkvPlan plan = host::dkv_plan(batch, hq, hkv, sk, d, n_sm);
  return plan.split > 1 ? 2LL * plan.split * batch * hkv * sk * d : 0;
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int dtype, int batch,
                                    int hq, int hkv, int sq, int sk, int d,
                                    int causal, float sm_scale, int q_base,
                                    int k_base, int kv_len, int n_sm,
                                    float* partial, long long partial_floats,
                                    void* stream) {
  if (bad_args(dtype, hq, hkv, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == host::kDtypeF32) {
    host::with_f32_width(d, [&](auto width) {
      launch_dkv_f32<decltype(width)::value>(
          q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, d,
          causal, sm_scale, q_base, k_base, kv_len, st);
      return 0;
    });
    return static_cast<int>(cudaGetLastError());
  }
  const host::DkvPlan plan = host::dkv_plan(batch, hq, hkv, sk, d, n_sm);
  const long long need =
      flash_bwd_dkv_partial_floats(batch, hq, hkv, sk, d, n_sm);
  if (need > 0 && (partial == nullptr || partial_floats < need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* part = need > 0 ? partial : nullptr;
  const cudaError_t err = host::with_elem(dtype, [&](auto elem) {
    using E = typename decltype(elem)::type;
    cudaError_t e;
    if (d > 256) {
      e = launch_dkv_wide<E>(q, k, v, dout, lse, delta, dk, dv, batch, hq,
                             hkv, sq, sk, d, causal, sm_scale, q_base, k_base,
                             kv_len, plan, part, st);
    } else {
      e = host::with_width(d, [&](auto width) {
        return launch_dkv_tc<E, decltype(width)::value>(
            q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, sk, d,
            causal, sm_scale, q_base, k_base, kv_len, plan, part, st);
      });
    }
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess || part == nullptr || sk == 0) return e;
    const long long n = (long long)batch * hkv * sk * d;
    const long long blocks = (n / 4 + 255) / 256;
    dkv_reduce_kernel<E>
        <<<dim3(blocks < 1056 ? blocks : 1056, 2), 256, 0, st>>>(
            part, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), n,
            plan.split);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
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
