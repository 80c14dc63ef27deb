// Gated linear recurrence scan for Hopper (sm_90a):
//   h_t = a_t * h_{t-1} + b_t   over (batch, seq, width), f32 carry.
//
// Replaces the TPU kernel src/repro/kernels/lru_scan/lru_scan.py
// ::lru_scan_pallas (grid step body `_kernel`). It computes what that
// kernel computes: an optional initial state h0 (batch, width) in f32, h in
// b's dtype, h_last (batch, width) in f32. It takes any sequence length;
// the Pallas kernel needs its chunk (min(256, seq)) to divide the length.
//
// Bound: bytes. The recurrence does 2 flops per element and moves a and b
// in and h out: at (1, 2048, 2560) f32 that is 63 MB, 0.019 ms at
// 3.35 TB/s. The TPU kernel's point is one HBM load and store per element
// through chunks resident in VMEM, with the carry in scratch across a
// sequential grid. Here no grid step follows another, and at batch 1 the
// width alone gives only 2,560 independent chains (80 warps for 132 SMs),
// each a chain of dependent FMAs, so the design is a two-pass scan over
// sequence segments:
//   * one block per (32 channels, batch row); its warps own consecutive
//     sequence segments (up to 32 of them), and lane = channel, so every
//     load and store of a warp is one coalesced 128-byte row (f32);
//   * pass 1: each warp runs its segment from h = 0 and keeps the segment's
//     composition (prod a, h_end) in shared memory;
//   * each warp folds the compositions of the segments before it into its
//     carry-in (h0 or 0 first), in order;
//   * pass 2: each warp runs its segment again from its carry-in and writes
//     h; the warp holding the last step writes h_last.
//   Loads are issued 8 steps ahead of the FMAs that use them (they do not
//   depend on h), so each warp keeps 16 loads in flight. a and b are read
//   twice (the second time mostly from the 50 MB L2) and h written once.
//
// C interface, loaded with ctypes: every pointer and the stream are void*;
// h0 may be null. Returns cudaGetLastError() after the launch (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;   // channels per block
constexpr int kMaxSeg = 32;  // sequence segments (warps) per block
constexpr int kAhead = 8;    // steps loaded before they are used

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kAhead steps of a and b from step t on; steps at or past t1 (and lanes
// past the width) are the identity (a = 1, b = 0).
template <typename TA, typename TB>
__device__ __forceinline__ void load_steps(const TA* ap, const TB* bp, int t,
                                           int t1, int w, bool ok,
                                           float (&av)[kAhead],
                                           float (&bv)[kAhead]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const bool in = ok && t + u < t1;
    av[u] = in ? to_f(ap[(long long)(t + u) * w]) : 1.f;
    bv[u] = in ? to_f(bp[(long long)(t + u) * w]) : 0.f;
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kLanes* kMaxSeg)
    lru_scan_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                    const float* __restrict__ h0, TB* __restrict__ h,
                    float* __restrict__ h_last, int l, int w, int seg) {
  __shared__ float ps[kMaxSeg][kLanes];
  __shared__ float hs[kMaxSeg][kLanes];
  const int lane = threadIdx.x, s = threadIdx.y, row = blockIdx.y;
  const int ch = blockIdx.x * kLanes + lane;
  const bool ok = ch < w;
  const int t0 = min(l, s * seg), t1 = min(l, t0 + seg);
  const long long base = (long long)row * l * w + (ok ? ch : 0);
  const TA* ap = a + base;
  const TB* bp = b + base;

  // pass 1: the segment's composition from h = 0
  float prod = 1.f, hend = 0.f;
  for (int t = t0; t < t1; t += kAhead) {
    float av[kAhead], bv[kAhead];
    load_steps(ap, bp, t, t1, w, ok, av, bv);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      hend = fmaf(av[u], hend, bv[u]);
      prod *= av[u];
    }
  }
  ps[s][lane] = prod;
  hs[s][lane] = hend;
  __syncthreads();

  // carry-in: h0 (or 0) through the segments before this one, in order
  float hh = (h0 != nullptr && ok) ? h0[(long long)row * w + ch] : 0.f;
  for (int j = 0; j < s; ++j) hh = fmaf(ps[j][lane], hh, hs[j][lane]);

  // pass 2: the segment again from its carry-in, writing h
  TB* hp = h + base;
  for (int t = t0; t < t1; t += kAhead) {
    float av[kAhead], bv[kAhead];
    load_steps(ap, bp, t, t1, w, ok, av, bv);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      hh = fmaf(av[u], hh, bv[u]);
      if (ok && t + u < t1) hp[(long long)(t + u) * w] = from_f<TB>(hh);
    }
  }
  if (ok && t0 < t1 && t1 == l) h_last[(long long)row * w + ch] = hh;
}

template <typename TA, typename TB>
int launch(const void* a, const void* b, const float* h0, void* h,
           float* h_last, int batch, int l, int w, cudaStream_t st) {
  const int nseg = l < kMaxSeg ? l : kMaxSeg;
  const int seg = (l + nseg - 1) / nseg;
  const dim3 block(kLanes, nseg);
  const dim3 grid((w + kLanes - 1) / kLanes, batch);
  lru_scan_kernel<TA, TB><<<grid, block, 0, st>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), h0,
      static_cast<TB*>(h), h_last, l, w, seg);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, h: (batch, seq, width) contiguous; h0 (batch, width) f32 or null;
// h_last (batch, width) f32. a_dtype and b_dtype: 0 = float32, 1 = bf16;
// h has b's dtype.
extern "C" int lru_scan_fwd(const void* a, const void* b, const void* h0,
                            void* h, void* h_last, int batch, int l, int w,
                            int a_dtype, int b_dtype, void* stream) {
  if (batch < 1 || batch > 65535 || l < 1 || w < 1 || a_dtype < 0 ||
      a_dtype > 1 || b_dtype < 0 || b_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (a_dtype == 0 && b_dtype == 0)
    return launch<float, float>(a, b, h0f, h, hl, batch, l, w, st);
  if (a_dtype == 0 && b_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, h0f, h, hl, batch, l, w, st);
  if (a_dtype == 1 && b_dtype == 0)
    return launch<__nv_bfloat16, float>(a, b, h0f, h, hl, batch, l, w, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h0f, h, hl, batch, l, w,
                                               st);
}
