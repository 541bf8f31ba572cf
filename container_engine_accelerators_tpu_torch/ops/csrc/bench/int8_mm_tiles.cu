// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// The W8A16 kernel (../int8_mm.cu) timed in turns against its earlier
// mma.sync design and against variants of its own tiles and cluster
// splits, with a plain streaming read of the same weight bytes as the
// yardstick of what HBM gives a read of them. This is how the Hopper
// kernel's tiles, its cluster sizes and its M boundaries were chosen
// (PERF.md). The mma.sync design is the baseline: ../int8_mm.cu's mma.sync
// kernel (now its general path) at its tile for M, with its split-K plan
// and its fixed-order reduce kernel as a second launch. Every variant's
// output is held to an f32 product of the same operands (one bf16 step of
// |ref| plus 1e-3, as chip_smoke.py's INT8_TOL). Weights are cycled
// through copies that exceed the 50 MB L2, as the decode streams them.
// Build and run on the card, from this directory:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/int8_mm_tiles int8_mm_tiles.cu && /tmp/int8_mm_tiles
//
// and, to see what the int8 -> bf16 converts cost, the same with
// -DINT8_MM_NO_CONVERT (wrong products, so every line counts bad outputs)
// run as `/tmp/int8_mm_tiles quick` (the kernel and the baseline only).
//
// One line per (shape, variant): the cluster split (the baseline's K
// splits), blocks, microseconds a launch back to back (CUDA events over 60
// launches) and as a CUDA graph of 40 launches (replayed 5 times), and the
// graph time's share of the byte or operation bound. Each shape runs the
// baseline, the kernel as launched, the variants, the kernel, the
// baseline. At M 1, "gap" lines: the baseline, the kernel and the kernel
// without a cluster in a graph between launches of a kernel without
// shared memory, as a decode step interleaves them with PyTorch's
// element-wise kernels.

#include "../int8_mm.cu"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

static uint16_t f2bf(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);  // round to nearest even
  return static_cast<uint16_t>(u >> 16);
}

static float bf2f(uint16_t b) {
  const uint32_t u = static_cast<uint32_t>(b) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

static void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    printf("%s: %s\n", what, cudaGetErrorString(e));
    exit(1);
  }
}

// ---- the baseline: mma.sync, split K and a reduce kernel -------------------

// K split when the output tiles give fewer blocks than the SMs, into enough
// splits for about four blocks an SM, summed by a second kernel.
constexpr int kSplitKTargetBlocks = 4 * kSMs;
constexpr int kSplitKMaxSplits = 64;

template <typename T>
int splitk_splits(int m, int n, int k) {
  const int blocks = ((n + T::BN - 1) / T::BN) * ((m + T::BM - 1) / T::BM);
  const int k_tiles = (k + T::BK - 1) / T::BK;
  if (blocks >= kSMs || k_tiles < 2) return 1;
  int splits = (kSplitKTargetBlocks + blocks - 1) / blocks;
  if (splits > k_tiles) splits = k_tiles;
  return splits < kSplitKMaxSplits ? splits : kSplitKMaxSplits;
}

__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
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

// ---- operands -------------------------------------------------------------

// One shape's operands: x (m, k) bf16, `copies` int8 weights qt (n, k) with
// their scales, the output, the baseline's split-K workspace, and the f32
// product of copy 0 every variant is held to.
struct Buf {
  void* x;
  std::vector<int8_t*> q;
  std::vector<float*> s;
  void* y;
  float* ws;
  int m, n, k, copies;
  std::vector<float> ref;
};

// y = (x @ qt^T) * scale in f32, one thread an output.
__global__ void ref_kernel(const uint16_t* __restrict__ x,
                           const int8_t* __restrict__ qt,
                           const float* __restrict__ scale,
                           float* __restrict__ y, int m, int n, int k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, r = blockIdx.y;
  if (c >= n) return;
  float acc = 0.f;
  for (int i = 0; i < k; ++i) {
    acc = fmaf(__uint_as_float((uint32_t)x[(size_t)r * k + i] << 16),
               (float)qt[(size_t)c * k + i], acc);
  }
  y[(size_t)r * n + c] = acc * scale[c];
}

Buf make(int m, int k, int n) {
  Buf b;
  b.m = m;
  b.n = n;
  b.k = k;
  const size_t qbytes = (size_t)k * n;
  b.copies = (int)std::min<size_t>(20, (size_t)(150e6 / qbytes) + 1);
  std::vector<uint16_t> hx((size_t)m * k);
  srand(1);
  for (auto& v : hx) v = f2bf((rand() / (float)RAND_MAX - 0.5f) * 3.f);
  check(cudaMalloc(&b.x, hx.size() * 2), "malloc x");
  cudaMemcpy(b.x, hx.data(), hx.size() * 2, cudaMemcpyHostToDevice);
  std::vector<int8_t> hq(qbytes);
  std::vector<float> hs(n);
  for (auto& v : hs) v = 0.02f / sqrtf((float)k) * (1 + rand() % 5);
  for (int c = 0; c < b.copies; ++c) {
    for (auto& v : hq) v = (int8_t)(rand() % 255 - 127);
    int8_t* q;
    check(cudaMalloc(&q, qbytes), "malloc qt");
    cudaMemcpy(q, hq.data(), qbytes, cudaMemcpyHostToDevice);
    b.q.push_back(q);
    float* s;
    cudaMalloc(&s, n * 4);
    cudaMemcpy(s, hs.data(), n * 4, cudaMemcpyHostToDevice);
    b.s.push_back(s);
  }
  cudaMalloc(&b.y, (size_t)m * n * 2);
  check(cudaMalloc(&b.ws, (size_t)kSplitKMaxSplits * m * n * 4), "malloc ws");
  float* r;
  cudaMalloc(&r, (size_t)m * n * 4);
  ref_kernel<<<dim3((n + 127) / 128, m), 128>>>(
      static_cast<const uint16_t*>(b.x), b.q[0], b.s[0], r, m, n, k);
  check(cudaDeviceSynchronize(), "reference");
  b.ref.resize((size_t)m * n);
  cudaMemcpy(b.ref.data(), r, b.ref.size() * 4, cudaMemcpyDeviceToHost);
  cudaFree(r);
  return b;
}

void free_buf(Buf& b) {
  cudaFree(b.x);
  for (auto q : b.q) cudaFree(q);
  for (auto s : b.s) cudaFree(s);
  cudaFree(b.y);
  cudaFree(b.ws);
}

// ---- variants -------------------------------------------------------------

struct Variant {
  std::string name;
  int splits, blocks;
  std::function<cudaError_t(Buf&, int, cudaStream_t)> launch;
};

template <typename T>
Variant baseline(const char* name, const Buf& b) {
  const int splits = splitk_splits<T>(b.m, b.n, b.k);
  const int blocks = ((b.n + T::BN - 1) / T::BN) *
                     ((b.m + T::BM - 1) / T::BM) * splits;
  return {name, splits, blocks, [splits](Buf& b, int c, cudaStream_t st) {
            cudaError_t e = launch_tile<T, true, __nv_bfloat16>(
                b.x, b.q[c], b.s[c], b.y, b.ws, b.m, b.n, b.k, splits,
                                                 st);
            if (e == cudaSuccess && splits > 1) {
              const long long total = (long long)b.m * b.n;
              splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                  st>>>(b.ws, b.s[c],
                                        static_cast<__nv_bfloat16*>(b.y),
                                        b.m, b.n, splits);
            }
            return e;
          }};
}

Variant baseline_for(const Buf& b) {
  switch (config_for(b.m)) {
    case 0: return baseline<Decode>("mma.sync 16x64x256 w8", b);
    case 1: return baseline<Verify>("mma.sync 64x128x32 w4", b);
    default: return baseline<Prefill>("mma.sync 128x128x64 w8", b);
  }
}

// The Hopper kernel at tile T with `splits` (0: the kernel's own plan).
template <typename T>
Variant hopper(const std::string& name, const Buf& b, int splits = 0) {
  if (splits == 0) splits = sm90_splits<T>(b.m, b.n, b.k);
  const int k_tiles = (b.k + T::BK - 1) / T::BK;
  if (splits > k_tiles) splits = k_tiles;
  const int blocks = ((b.n + T::BC - 1) / T::BC) *
                     ((b.m + T::BN - 1) / T::BN) * splits;
  char label[96];
  snprintf(label, sizeof(label), "%s bn%d c%d s%d k%d", name.c_str(), T::BN,
           T::C, T::kStages, T::BK);
  return {label, splits, blocks, [splits](Buf& b, int c, cudaStream_t st) {
            return launch_sm90<T, __nv_bfloat16>(b.x, b.q[c], b.s[c], b.y, b.m,
                                                 b.n, b.k, splits, st);
          }};
}

// The kernel as int8_mm_launch runs it.
Variant product(const Buf& b) {
  return {"kernel (int8_mm_launch)", 0, 0,
          [](Buf& b, int c, cudaStream_t st) {
            const int err = int8_mm_launch(b.x, b.q[c], b.s[c], b.y, nullptr,
                                           0, b.m, b.n, b.k, st);
            return static_cast<cudaError_t>(err);
          }};
}

double bound_us(const Buf& b) {
  const double bytes =
      (double)b.k * b.n + 4.0 * b.n + 2.0 * b.m * b.k + 2.0 * b.m * b.n;
  return fmax(bytes / 3.35e12, 2.0 * b.m * b.k * b.n / 989e12) * 1e6;
}

void run(Buf& b, const Variant& v, cudaStream_t st) {
  cudaMemsetAsync(b.y, 0, (size_t)b.m * b.n * 2, st);
  check(v.launch(b, 0, st), v.name.c_str());
  check(cudaStreamSynchronize(st), v.name.c_str());
  std::vector<uint16_t> out((size_t)b.m * b.n);
  cudaMemcpy(out.data(), b.y, out.size() * 2, cudaMemcpyDeviceToHost);
  double maxerr = 0;
  long bad = 0;
  for (size_t i = 0; i < out.size(); ++i) {
    const double r = b.ref[i], d = fabs(bf2f(out[i]) - r);
    maxerr = d > maxerr ? d : maxerr;
    if (!(d <= fabs(r) / 128.0 + 1e-3)) ++bad;
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 3; ++i) v.launch(b, i % b.copies, st);
  const int iters = 60;
  cudaEventRecord(e0, st);
  for (int i = 0; i < iters; ++i) v.launch(b, i % b.copies, st);
  cudaEventRecord(e1, st);
  check(cudaEventSynchronize(e1), "eager");
  float eager_ms;
  cudaEventElapsedTime(&eager_ms, e0, e1);
  const int per_graph = 40, replays = 5;
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  check(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal),
        "capture");
  for (int i = 0; i < per_graph; ++i) v.launch(b, i % b.copies, st);
  check(cudaStreamEndCapture(st, &graph), "end capture");
  check(cudaGraphInstantiate(&exec, graph, 0), "instantiate");
  cudaGraphLaunch(exec, st);
  cudaEventRecord(e0, st);
  for (int i = 0; i < replays; ++i) cudaGraphLaunch(exec, st);
  cudaEventRecord(e1, st);
  check(cudaEventSynchronize(e1), "graph");
  float graph_ms;
  cudaEventElapsedTime(&graph_ms, e0, e1);
  cudaGraphExecDestroy(exec);
  cudaGraphDestroy(graph);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  const double graph_us = graph_ms / (per_graph * replays) * 1e3;
  printf("M%d K%d N%d %-34s split %2d blocks %5d  us %8.2f  graph_us %8.2f"
         "  share %.3f  maxerr %.4g bad %ld\n",
         b.m, b.k, b.n, v.name.c_str(), v.splits, v.blocks,
         eager_ms / iters * 1e3, graph_us, bound_us(b) / graph_us, maxerr,
         bad);
  fflush(stdout);
}

// The yardstick: every weight byte read once with 16-byte loads, spread
// over the whole card.
__global__ void stream_kernel(const int4* __restrict__ p, size_t n16,
                              int* out) {
  int4 acc = make_int4(0, 0, 0, 0);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n16;
       i += (size_t)gridDim.x * blockDim.x) {
    const int4 v = __ldg(p + i);
    acc.x ^= v.x;
    acc.y ^= v.y;
    acc.z ^= v.z;
    acc.w ^= v.w;
  }
  if ((acc.x ^ acc.y ^ acc.z ^ acc.w) == 0x12345678) out[0] = 1;
}

void stream_bench(Buf& b) {
  const size_t n16 = (size_t)b.k * b.n / 16;
  int* out;
  cudaMalloc(&out, 4);
  for (int blocks : {264, 528, 1056}) {
    auto pass = [&](int i) {
      stream_kernel<<<blocks, 512>>>(
          static_cast<const int4*>(static_cast<void*>(b.q[i % b.copies])),
          n16, out);
    };
    for (int i = 0; i < 3; ++i) pass(i);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    for (int i = 0; i < 60; ++i) pass(i);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    printf("stream %zu bytes, %d blocks x 512: us %.2f  GB/s %.1f\n",
           n16 * 16, blocks, ms / 60 * 1e3,
           n16 * 16 / (ms / 60 * 1e-3) / 1e9);
    cudaEventDestroy(e0);
    cudaEventDestroy(e1);
  }
  cudaFree(out);
}

// A kernel without shared memory, as PyTorch's element-wise kernels are,
// for the gap a W8A16 launch costs between two of them in a graph.
__global__ void neighbour_kernel(float* p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = p[i] * 0.5f + 1.f;
}

// Microseconds a graph of `count` rounds of fn(i) takes a round.
template <typename Fn>
double graph_round_us(Fn fn, int count, cudaStream_t st) {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  check(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal),
        "capture");
  for (int i = 0; i < count; ++i) fn(i);
  check(cudaStreamEndCapture(st, &graph), "end capture");
  check(cudaGraphInstantiate(&exec, graph, 0), "instantiate");
  cudaGraphLaunch(exec, st);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0, st);
  for (int r = 0; r < 5; ++r) cudaGraphLaunch(exec, st);
  cudaEventRecord(e1, st);
  check(cudaEventSynchronize(e1), "graph");
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaGraphExecDestroy(exec);
  cudaGraphDestroy(graph);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms / (5 * count) * 1e3;
}

// In a graph, a launch alone, the neighbour alone, and the two in turns:
// the gap is what the pair costs beyond its two parts.
void neighbour(Buf& b, const Variant& v, cudaStream_t st) {
  const int n = 4096;
  float* p;
  cudaMalloc(&p, n * 4);
  cudaMemset(p, 0, n * 4);
  auto nb = [&](int) { neighbour_kernel<<<n / 256, 256, 0, st>>>(p, n); };
  auto mm = [&](int i) { v.launch(b, i % b.copies, st); };
  const double alone = graph_round_us(mm, 40, st);
  const double other = graph_round_us(nb, 40, st);
  const double pair = graph_round_us([&](int i) { nb(i); mm(i); }, 40, st);
  printf("M%d K%d N%d %-34s graph_us alone %7.2f  neighbour %5.2f  pair "
         "%7.2f  gap %5.2f\n",
         b.m, b.k, b.n, v.name.c_str(), alone, other, pair,
         pair - alone - other);
  fflush(stdout);
  cudaFree(p);
}

// The baseline, the kernel, `extra` variants, the kernel, the baseline.
void turns(Buf& b, const std::vector<Variant>& extra, cudaStream_t st) {
  const Variant base = baseline_for(b), mine = product(b);
  run(b, base, st);
  run(b, mine, st);
  for (const Variant& v : extra) run(b, v, st);
  run(b, mine, st);
  run(b, base, st);
}

int main(int argc, char** argv) {
  // "quick": the kernel against the baseline at each shape, no variants.
  const bool quick = argc > 1 && strcmp(argv[1], "quick") == 0;
  cudaStream_t st;
  cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  const int layer[4][2] = {{4096, 4096}, {4096, 1024}, {4096, 14336},
                           {14336, 4096}};
  for (int m : {1, 8, 16}) {
    for (const auto& w : layer) {
      if (m == 16 && w[1] != 14336) continue;
      Buf b = make(m, w[0], w[1]);
      if (m == 8 && w[0] * w[1] > 4096 * 4096) stream_bench(b);
      std::vector<Variant> extra;
      if (!quick) {
        for (int s : {1, 2, 3, 4, 8}) {
          extra.push_back(m <= 8 ? hopper<D8>("D8", b, s)
                                 : hopper<D16>("D16", b, s));
        }
        extra.push_back(hopper<Sm90Tile<8, 1, 8, 2>>("D8s8b2", b));
        extra.push_back(hopper<Sm90Tile<16, 1, 8, 2>>("D16s8b2", b));
        extra.push_back(
            m <= 8 ? hopper<Sm90Tile<8, 1, 8, 3, 64>>("D8k64", b)
                   : hopper<Sm90Tile<16, 1, 8, 3, 64>>("D16k64", b));
      }
      turns(b, extra, st);
      if (m == 1) {
        neighbour(b, baseline_for(b), st);
        neighbour(b, product(b), st);
        neighbour(b, hopper<D8>("D8", b, 1), st);
      }
      free_buf(b);
    }
  }
  for (int n : {14336, 4096}) {
    const int k = n == 14336 ? 4096 : 14336;
    Buf b = make(128, k, n);
    std::vector<Variant> extra;
    if (!quick) {
      for (int s : {1, 2, 3}) extra.push_back(hopper<V128>("V128", b, s));
      extra.push_back(hopper<Sm90Tile<64, 2, 4, 1>>("V64", b));
      extra.push_back(hopper<Sm90Tile<128, 2, 8, 1, 64>>("V128k64", b));
    }
    turns(b, extra, st);
    free_buf(b);
  }
  for (int m : {512, 2048}) {
    for (int n : {14336, 4096}) {
      const int k = n == 14336 ? 4096 : 14336;
      Buf b = make(m, k, n);
      std::vector<Variant> extra;
      if (!quick) {
        for (int s : {1, 2}) extra.push_back(hopper<V128>("V128", b, s));
        for (int s : {1, 2, 3}) extra.push_back(hopper<P256>("P256", b, s));
        extra.push_back(hopper<Sm90Tile<256, 2, 2, 1>>("P256k128", b));
        extra.push_back(hopper<Sm90Tile<128, 2, 8, 1, 64>>("V128k64", b));
      }
      turns(b, extra, st);
      free_buf(b);
    }
  }
  return 0;
}
