// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Tile variants of the W8A16 kernel (../int8_mm.cu) timed against each
// other on the card, and a plain streaming read of the same weight bytes
// as the yardstick of what HBM gives a read of them. This is how the
// kernel's Decode, Verify and Prefill tiles were chosen (PERF.md, PR 9).
// Each variant's output is held to the kernel's own launch (one bf16 step
// of |ref| plus 1e-3). Weights are cycled through copies that exceed the
// 50 MB L2, as the decode streams them. Build and run on the card, from
// this directory:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/int8_mm_tiles int8_mm_tiles.cu && /tmp/int8_mm_tiles
//
// One line per (shape, variant, split count): microseconds a launch
// (CUDA events over 60 back-to-back launches, the split-K reduce
// included) and the share of the byte or operation bound.

#include "../int8_mm.cu"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

static float bf2f(uint16_t b) {
  const uint32_t u = static_cast<uint32_t>(b) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

static uint16_t f2bf(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);  // round to nearest even
  return static_cast<uint16_t>(u >> 16);
}

// One shape's operands: x (m, k) bf16, `copies` int8 weights qt (n, k) with
// their scales, the output and a split-K workspace.
struct Buf {
  void* x;
  std::vector<int8_t*> q;
  std::vector<float*> s;
  void* y;
  float* ws;
  int m, n, k, copies;
};

// Variant T with `splits` on weight copy c: the main kernel and, when K
// is split, the fixed-order reduce.
template <typename T>
void launch_v(Buf& b, int c, int splits, cudaStream_t st) {
  launch_tile<T, true>(b.x, b.q[c], b.s[c], b.y, b.ws, b.m, b.n, b.k, splits,
                       st);
  if (splits > 1) {
    const long long total = (long long)b.m * b.n;
    int8_mm_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        b.ws, b.s[c], static_cast<__nv_bfloat16*>(b.y), b.m, b.n, splits);
  }
}

static std::vector<uint16_t> ref;

template <typename T>
void run(const char* name, Buf& b, int splits) {
  int blocks = ((b.n + T::BN - 1) / T::BN) * ((b.m + T::BM - 1) / T::BM);
  int k_tiles = (b.k + T::BK - 1) / T::BK;
  if (splits > k_tiles) splits = k_tiles;
  cudaStream_t st = 0;
  cudaMemset(b.y, 0, (size_t)b.m * b.n * 2);
  launch_v<T>(b, 0, splits, st);
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    printf("%s: error %s\n", name, cudaGetErrorString(e));
    exit(1);
  }
  std::vector<uint16_t> out((size_t)b.m * b.n);
  cudaMemcpy(out.data(), b.y, out.size() * 2, cudaMemcpyDeviceToHost);
  double maxerr = 0; int bad = 0;
  for (size_t i = 0; i < out.size(); ++i) {
    float a = bf2f(out[i]), r = bf2f(ref[i]);
    const double d = fabs(a - r);
    maxerr = d > maxerr ? d : maxerr;
    if (d > fabs(r) / 128.0 + 1e-3) ++bad;
  }
  for (int i = 0; i < 3; ++i) launch_v<T>(b, i % b.copies, splits, st);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  int iters = 60;
  cudaEventRecord(e0, st);
  for (int i = 0; i < iters; ++i) launch_v<T>(b, i % b.copies, splits, st);
  cudaEventRecord(e1, st);
  cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  const double bytes =
      (double)b.k * b.n + 4.0 * b.n + 2.0 * b.m * b.k + 2.0 * b.m * b.n;
  const double bound =
      fmax(bytes / 3.35e12, 2.0 * b.m * b.k * b.n / 989e12) * 1e3;
  printf("M%d K%d N%d %-26s splits %2d blocks %5d  us %8.2f  share %.3f  "
         "maxerr %.4g bad %d\n",
         b.m, b.k, b.n, name, splits, blocks * splits, ms / iters * 1e3,
         bound / (ms / iters), maxerr, bad);
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
  }
  cudaFree(out);
}

// Random operands of one shape, and the kernel's own launch on the first
// weight copy as the reference every variant is held to.
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
  cudaMalloc(&b.x, hx.size() * 2);
  cudaMemcpy(b.x, hx.data(), hx.size() * 2, cudaMemcpyHostToDevice);
  std::vector<int8_t> hq(qbytes);
  std::vector<float> hs(n);
  for (auto& v : hs) v = 0.02f / sqrtf((float)k) * (1 + rand() % 5);
  for (int c = 0; c < b.copies; ++c) {
    for (auto& v : hq) v = (int8_t)(rand() % 255 - 127);
    int8_t* q;
    cudaMalloc(&q, qbytes);
    cudaMemcpy(q, hq.data(), qbytes, cudaMemcpyHostToDevice);
    b.q.push_back(q);
    float* s;
    cudaMalloc(&s, n * 4);
    cudaMemcpy(s, hs.data(), n * 4, cudaMemcpyHostToDevice);
    b.s.push_back(s);
  }
  cudaMalloc(&b.y, (size_t)m * n * 2);
  cudaMalloc(&b.ws, (size_t)64 * m * n * 4);
  const long long need = int8_mm_workspace_floats(0, m, n, k);
  const int err = int8_mm_launch(b.x, b.q[0], b.s[0], b.y,
                                 need ? b.ws : nullptr, 0, m, n, k, 0);
  cudaDeviceSynchronize();
  if (err) {
    printf("reference launch error %d\n", err);
    exit(1);
  }
  ref.resize((size_t)m * n);
  cudaMemcpy(ref.data(), b.y, ref.size() * 2, cudaMemcpyDeviceToHost);
  return b;
}

void free_buf(Buf& b) {
  cudaFree(b.x);
  for (auto q : b.q) cudaFree(q);
  for (auto s : b.s) cudaFree(s);
  cudaFree(b.y);
  cudaFree(b.ws);
}

// T at the split counts that bring its grid to each of `targets` blocks
// (0: no split).
template <typename T>
void sweep(const char* name, Buf& b, std::initializer_list<int> targets) {
  int blocks = ((b.n + T::BN - 1) / T::BN) * ((b.m + T::BM - 1) / T::BM);
  for (int tgt : targets) {
    int splits = tgt <= blocks ? 1 : (tgt + blocks - 1) / blocks;
    if (splits > 64) splits = 64;
    run<T>(name, b, splits);
  }
}

int main() {
  int shapes[3][2] = {{4096, 14336}, {14336, 4096}, {4096, 4096}};
  for (auto& sh : shapes) {
    Buf b = make(8, sh[0], sh[1]);
    if (sh[0] * sh[1] > 4096 * 4096) stream_bench(b);
    sweep<Tile<16, 128, 64, 1, 4, 4>>("D0 16x128x64 w4 s4", b, {132, 264, 528});
    sweep<Tile<16, 128, 128, 1, 4, 4>>("D1 16x128x128 w4 s4", b,
                                       {132, 264, 528});
    sweep<Tile<16, 64, 256, 1, 4, 3>>("D2 16x64x256 w4 s3", b, {132, 264, 528});
    sweep<Tile<16, 128, 64, 1, 4, 8>>("D3 16x128x64 w4 s8", b, {132, 264, 528});
    sweep<Tile<16, 64, 128, 1, 4, 4>>("D4 16x64x128 w4 s4", b, {132, 264, 528});
    sweep<Tile<16, 256, 64, 1, 8, 4>>("D5 16x256x64 w8 s4", b, {132, 264, 528});
    sweep<Tile<16, 64, 256, 1, 2, 4>>("D6 16x64x256 w2 s4", b,
                                      {264, 528, 1056});
    sweep<Tile<16, 32, 512, 1, 4, 3>>("E1 16x32x512 w4 s3", b, {0, 528});
    sweep<Tile<16, 64, 256, 1, 8, 4>>("E3 16x64x256 w8 s4", b, {0, 264, 528});
    sweep<Tile<16, 32, 256, 1, 4, 4>>("E4 16x32x256 w4 s4", b, {0, 528});
    sweep<Tile<16, 64, 512, 1, 8, 2>>("E5 16x64x512 w8 s2", b, {0, 264});
    sweep<Tile<16, 128, 256, 1, 8, 3>>("E6 16x128x256 w8 s3", b, {264, 528});
    free_buf(b);
  }
  {
    Buf b = make(128, 4096, 14336);
    sweep<Tile<64, 128, 32, 2, 2, 4>>("V0 64x128x32 w2x2 s4", b, {0});
    sweep<Tile<32, 128, 64, 1, 4, 4>>("V1 32x128x64 w1x4 s4", b, {0});
    sweep<Tile<16, 128, 64, 1, 4, 4>>("V2 16x128x64 w1x4 s4", b, {0});
    sweep<Tile<64, 64, 64, 2, 2, 4>>("V3 64x64x64 w2x2 s4", b, {0});
    sweep<Tile<128, 128, 32, 2, 4, 4>>("P0 128x128x32 w2x4 s4", b, {0, 264});
    free_buf(b);
  }
  for (int m : {512, 2048}) {
    Buf b = make(m, 4096, 14336);
    sweep<Tile<128, 128, 32, 2, 4, 4>>("P0 128x128x32 w2x4 s4", b, {0});
    sweep<Tile<128, 128, 64, 2, 4, 3>>("P1 128x128x64 w2x4 s3", b, {0});
    sweep<Tile<128, 256, 32, 2, 4, 3>>("P2 128x256x32 w2x4 s3", b, {0});
    sweep<Tile<256, 128, 32, 4, 2, 3>>("P3 256x128x32 w4x2 s3", b, {0});
    sweep<Tile<64, 128, 32, 2, 2, 4>>("P4 64x128x32 w2x2 s4", b, {0});
    sweep<Tile<128, 128, 32, 4, 2, 4>>("P5 128x128x32 w4x2 s4", b, {0});
    sweep<Tile<128, 64, 64, 4, 1, 4>>("P6 128x64x64 w4x1 s4", b, {0});
    free_buf(b);
  }
  return 0;
}
