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
// 3.35 TB/s. The TPU kernel reads each element once through chunks resident
// in VMEM, with the carry in scratch across a sequential grid. Here no grid
// step follows another, and at batch 1 the width alone gives only 2,560
// independent chains, so the sequence is cut into segments and the carry
// is composed across them, with one HBM read of a and b and one write of h:
//   * lane = channel, so every warp access is one coalesced 128-byte row
//     (f32); a thread owns kSteps consecutive steps of one channel (a
//     segment) and loads all of them into registers at once;
//   * it composes its segment from h = 0 into (prod a, h_end); warp 0
//     composes the block's segments in sequence order, through shared
//     memory, into the block's pair;
//   * a thread-block cluster of up to kMaxCluster blocks lies along the
//     sequence. After one cluster barrier, warp r copies block r's pair
//     (distributed shared memory) into its own block's shared memory, so
//     every remote read is in flight at once; each thread folds the pairs
//     of the blocks before its own, then the segments before its own, into
//     its carry-in, and warp 0 folds all of them into the carry past the
//     cluster's span;
//   * every thread replays its segment from the registers, starting from
//     its carry-in, and writes h; the thread holding the last step writes
//     h_last;
//   * the unit of work is one span (cluster * kWarps * kSteps steps) of one
//     channel group (32 channels of one batch row). The grid holds as many
//     clusters as the card keeps resident at once
//     (cudaOccupancyMaxActiveClusters), and each walks its channel groups'
//     spans in sequence order, the carry past one span being the carry into
//     the next, and loads the next span's steps while it composes this
//     one: the loads of one span overlap the barriers of the other. No
//     second kernel, no flag in global memory.
//   The cluster has ceil(seq / (kWarps * kSteps)) blocks, at most
//   kMaxCluster.
//
// Launch: cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension
// (1, cluster, 1). A cluster shape the card cannot schedule is refused
// there (or by the occupancy query); the error is returned to the
// wrapper, which raises.
//
// Tuning: kSteps, kWarps, kMaxCluster and kMinBlocks (the blocks an SM
// must hold, which caps the registers) were chosen by timing copies of
// this source with other values side by side (tools/kernel_variants.py).
// The committed choice, 16 steps, 8 warps, clusters of up to 8 blocks and
// 2 blocks an SM (120-124 registers, no spills), launches in 0.0343 ms at
// the RecurrentGemma-2B prefill's (1, 2048, 2560) f32, against 0.0355 for
// 8 steps at 4 blocks an SM, 0.0364 for clusters of 4 and 0.0430 for 16
// warps; at (8, 1000, 2560) 8 steps and clusters of 4 win by 5-7%
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has the run).
//
// Numerics: the carry is f32 and every update is one fmaf, as before; the
// products of a and the segment sums round where the composition puts
// them, which stays within the JAX suite's 1e-5 of the plain version
// (tests/test_torch_lru.py emulates this order on the CPU).
//
// Backward (lru_scan_bwd): the vector-Jacobian product of (h, h_last) is
// the reverse recurrence g_t = dh_t + a_{t+1} g_{t+1}, g_{L-1} = dh_{L-1} +
// dh_last, then db_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0, or 0) and
// dh0 = a_0 g_0. It is the same scan run from the end of the sequence: at
// step s of the reversed sequence (t = L-1-s) the multiplier is a_{t+1}
// (the identity at s = 0), the addend dh_t and the carry into the first
// step dh_last. So the backward is this kernel instantiated with kBwd: the
// same segments, cluster carry and persistent spans, with the loads and
// the stores indexed from the end; its replay also reads the forward's
// h_{t-1} and writes da_t and db_t. Bound: bytes, one pass reading a, h
// and dh and writing da and db, 20 B an f32 element: 839 MB, 0.250 ms at
// (8, 2048, 2560) f32 at 3.35 TB/s. The carry is f32 and g is rounded
// once to b's dtype for db; with bf16 b the saved h is bf16, so da_t uses
// h_{t-1} rounded to bf16 (the plain backward, autograd of the plain
// version, uses the f32 carry): da is then within a bf16 rounding of it.
//
// C interface, loaded with ctypes: every pointer and the stream are void*;
// h0 (and, in the backward, dh_last and dh0) may be null. Returns the
// launch's error (0 if none).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;      // channels per block
constexpr int kSteps = 16;      // steps a thread holds
constexpr int kWarps = 8;       // segments (warps) per block
constexpr int kMaxCluster = 8;  // blocks along the sequence
constexpr int kMinBlocks = 2;   // blocks an SM must hold (caps the registers)

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

// The kSteps steps of segment `seg` (steps seg * kSteps on, of the
// sequence in the scan's order) of one channel, all loads issued before any
// is used; steps past the end (and lanes past the width) are the identity
// (a = 1, b = 0). The backward's step s is t = l-1-s: multiplier a_{t+1}
// (the identity at s = 0), addend dh_t.
template <bool kBwd, typename TA, typename TB>
__device__ __forceinline__ void load_steps(const TA* ap, const TB* bp,
                                           int seg, int l, int w, bool ok,
                                           float (&av)[kSteps],
                                           float (&bv)[kSteps]) {
  const int s0 = seg * kSteps;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int s = s0 + u;
    const bool in = ok && s < l;
    const int t = kBwd ? l - 1 - s : s;
    av[u] = in && (!kBwd || s > 0)
                ? to_f(ap[(long long)(kBwd ? t + 1 : t) * w])
                : 1.f;
    bv[u] = in ? to_f(bp[(long long)t * w]) : 0.f;
  }
}

// The pointers of one scan. Forward: b the addends, cin = h0, out = h,
// last = h_last. Backward: b = dh, cin = dh_last, out = db, last = dh0, and
// h, h0 the forward's (h0 may be null), da the multipliers' gradient.
template <typename TA, typename TB>
struct Args {
  const TA* a;
  const TB* b;
  const float* cin;
  TB* out;
  float* last;
  const TB* h;
  const float* h0;
  TA* da;
  int batch, l, w;
};

// One work item of a cluster: span `span_idx` of the channel group
// `group` (32 channels of one batch row).
struct Item {
  long long base;  // offset of (row, step 0, this lane's channel)
  long long hrow;  // offset of (row, this lane's channel) in h0 and h_last
  int span_idx;
  bool ok;         // this lane's channel is inside the width
};

__device__ __forceinline__ Item locate(int q, int nspan, int gw, int l,
                                       int w) {
  const int group = blockIdx.x + (q / nspan) * gridDim.x;
  const int row = group / gw;
  const int ch = (group - row * gw) * kLanes + threadIdx.x;
  Item it;
  it.ok = ch < w;
  it.hrow = (long long)row * w + (it.ok ? ch : 0);
  it.base = (long long)row * l * w + (it.ok ? ch : 0);
  it.span_idx = q % nspan;
  return it;
}

// A persistent cluster of nc blocks along the sequence (grid (P, nc), P
// clusters resident at once) walks its work items: channel groups
// blockIdx.x, blockIdx.x + P, ..., each span by span in the scan's order
// (from the end of the sequence in the backward).
template <bool kBwd, typename TA, typename TB>
__global__ void __launch_bounds__(kLanes* kWarps, kMinBlocks)
    lru_scan_kernel(const Args<TA, TB> p) {
  __shared__ float seg_p[kWarps][kLanes], seg_h[kWarps][kLanes];
  __shared__ float blk_p[2][kLanes], blk_h[2][kLanes];  // by item parity
  __shared__ float rem_p[kMaxCluster][kLanes], rem_h[kMaxCluster][kLanes];
  __shared__ float carry_s[2][kLanes];  // into the item, by item parity
  cg::cluster_group cluster = cg::this_cluster();
  const int l = p.l, w = p.w;
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int seg0 = rank * kWarps + warp;  // this thread's segment in a span
  const int span = nc * kWarps * kSteps;
  const int nspan = (l + span - 1) / span;
  const int gw = (w + kLanes - 1) / kLanes;
  const int groups = gw * p.batch;
  const int mine_groups =
      groups > (int)blockIdx.x
          ? (groups - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int items = mine_groups * nspan;

  float av[kSteps], bv[kSteps], an[kSteps], bn[kSteps];
  if (items > 0) {
    const Item nx = locate(0, nspan, gw, l, w);
    load_steps<kBwd>(p.a + nx.base, p.b + nx.base, seg0, l, w, nx.ok, an,
                     bn);
  }
  for (int q = 0, par = 0; q < items; ++q, par ^= 1) {
    const Item it = locate(q, nspan, gw, l, w);
    const int t0 = (it.span_idx * nc * kWarps + seg0) * kSteps;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {  // loaded during the last item
      av[u] = an[u];
      bv[u] = bn[u];
    }
    if (q + 1 < items) {  // the next item's steps, while this one composes
      const Item nx = locate(q + 1, nspan, gw, l, w);
      load_steps<kBwd>(p.a + nx.base, p.b + nx.base,
                       nx.span_idx * nc * kWarps + seg0, l, w, nx.ok, an,
                       bn);
    }
    if (warp == 0 && it.span_idx == 0)  // a group starts from cin (or 0)
      carry_s[par][lane] = (p.cin != nullptr && it.ok) ? p.cin[it.hrow] : 0.f;
    float prod = 1.f, hend = 0.f;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      hend = fmaf(av[u], hend, bv[u]);
      prod *= av[u];
    }
    seg_p[warp][lane] = prod;
    seg_h[warp][lane] = hend;
    __syncthreads();
    if (warp == 0) {  // the block's pair, segments in order
      float pp = 1.f, hh = 0.f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) {
        hh = fmaf(seg_p[j][lane], hh, seg_h[j][lane]);
        pp *= seg_p[j][lane];
      }
      blk_p[par][lane] = pp;
      blk_h[par][lane] = hh;
    }
    cluster.sync();  // every block's pair is published
    for (int r = warp; r < nc; r += kWarps) {  // warp r fetches block r's
      rem_p[r][lane] = cluster.map_shared_rank(&blk_p[par][0], r)[lane];
      rem_h[r][lane] = cluster.map_shared_rank(&blk_h[par][0], r)[lane];
    }
    __syncthreads();
    // this thread's carry-in: the item's carry through the blocks before
    // this one, then through the segments before this one
    float hh = carry_s[par][lane];
#pragma unroll
    for (int r = 0; r < kMaxCluster - 1; ++r)
      if (r < rank) hh = fmaf(rem_p[r][lane], hh, rem_h[r][lane]);
    if (warp == 0) {  // the carry into the next span of this group
      float hc = hh;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r >= rank && r < nc) hc = fmaf(rem_p[r][lane], hc, rem_h[r][lane]);
      carry_s[par ^ 1][lane] = hc;
    }
#pragma unroll
    for (int j = 0; j < kWarps - 1; ++j)
      if (j < warp) hh = fmaf(seg_p[j][lane], hh, seg_h[j][lane]);
    if (!kBwd) {
      TB* hp = p.out + it.base;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        hh = fmaf(av[u], hh, bv[u]);
        if (it.ok && t0 + u < l) {
          hp[(long long)(t0 + u) * w] = from_f<TB>(hh);
          if (t0 + u == l - 1) p.last[it.hrow] = hh;
        }
      }
    } else {  // hh is g_t: db_t = g_t, da_t = g_t h_{t-1}, dh0 = a_0 g_0
      float hv[kSteps];  // h_{t-1} of each step, all loads issued first
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = l - 1 - (t0 + u);
        hv[u] = !(it.ok && t0 + u < l) ? 0.f
                : t > 0 ? to_f(p.h[it.base + (long long)(t - 1) * w])
                : p.h0 != nullptr ? p.h0[it.hrow]
                                  : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        hh = fmaf(av[u], hh, bv[u]);
        if (it.ok && t0 + u < l) {
          const int t = l - 1 - (t0 + u);
          const long long o = it.base + (long long)t * w;
          p.out[o] = from_f<TB>(hh);
          p.da[o] = from_f<TA>(hh * hv[u]);
          if (t == 0 && p.last != nullptr)
            p.last[it.hrow] = to_f(p.a[it.base]) * hh;
        }
      }
    }
    __syncthreads();  // seg_*, rem_* and carry_s are rewritten next item
  }
  // The next item's pairs go to the other parity buffer, so one barrier an
  // item suffices; this last one keeps every block's shared memory alive
  // until the other blocks have read it.
  cluster.sync();
}

// Blocks along the sequence for a length: enough to cover it with one span,
// at most kMaxCluster.
int cluster_for(int l) {
  const int per_block = kWarps * kSteps;
  const int need = (l + per_block - 1) / per_block;
  return need < kMaxCluster ? need : kMaxCluster;
}

template <bool kBwd, typename TA, typename TB>
int launch(const Args<TA, TB>& args, cudaStream_t st) {
  const int nc = cluster_for(args.l);
  const long long groups =
      (long long)((args.w + kLanes - 1) / kLanes) * args.batch;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kLanes, kWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nc;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as are resident at once (asked once per cluster size
  // and device), at most one per channel group
  static int resident[kMaxCluster + 1][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int& p = resident[nc][dev & 63];
  if (p == 0) {
    cfg.gridDim = dim3(1, nc, 1);
    err = cudaOccupancyMaxActiveClusters(
        &p, lru_scan_kernel<kBwd, TA, TB>, &cfg);
    if (err != cudaSuccess || p < 1) {
      cudaGetLastError();
      p = 0;
      return (int)(err != cudaSuccess ? err : cudaErrorLaunchOutOfResources);
    }
  }
  cfg.gridDim = dim3((unsigned)(groups < p ? groups : p), nc, 1);
  err = cudaLaunchKernelEx(&cfg, lru_scan_kernel<kBwd, TA, TB>, args);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int batch, int l, int w, int a_dtype, int b_dtype) {
  return batch < 1 || l < 1 || w < 1 ||
         (long long)((w + kLanes - 1) / kLanes) * batch > 0x7fffffff ||
         a_dtype < 0 || a_dtype > 1 || b_dtype < 0 || b_dtype > 1;
}

// Both directions, by the two dtypes (0 = float32, 1 = bf16).
template <bool kBwd>
int dispatch(const void* a, const void* b, const void* cin, void* out,
             void* last, const void* h, const void* h0, void* da, int batch,
             int l, int w, int a_dtype, int b_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(cin);
  const float* h0f = static_cast<const float*>(h0);
  float* lf = static_cast<float*>(last);
#define LRU_LAUNCH(TA, TB)                                                  \
  return launch<kBwd, TA, TB>(                                              \
      Args<TA, TB>{static_cast<const TA*>(a), static_cast<const TB*>(b), cf, \
                   static_cast<TB*>(out), lf, static_cast<const TB*>(h),    \
                   h0f, static_cast<TA*>(da), batch, l, w},                 \
      st)
  if (a_dtype == 0 && b_dtype == 0) LRU_LAUNCH(float, float);
  if (a_dtype == 0 && b_dtype == 1) LRU_LAUNCH(float, __nv_bfloat16);
  if (a_dtype == 1 && b_dtype == 0) LRU_LAUNCH(__nv_bfloat16, float);
  LRU_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef LRU_LAUNCH
}

}  // namespace

// The launch shape for a sequence length: {cluster, warps, steps}.
extern "C" void lru_scan_plan(int l, int* out) {
  out[0] = cluster_for(l < 1 ? 1 : l);
  out[1] = kWarps;
  out[2] = kSteps;
}

// a, b, h: (batch, seq, width) contiguous; h0 (batch, width) f32 or null;
// h_last (batch, width) f32. a_dtype and b_dtype: 0 = float32, 1 = bf16;
// h has b's dtype.
extern "C" int lru_scan_fwd(const void* a, const void* b, const void* h0,
                            void* h, void* h_last, int batch, int l, int w,
                            int a_dtype, int b_dtype, void* stream) {
  if (bad_shape(batch, l, w, a_dtype, b_dtype))
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(a, b, h0, h, h_last, nullptr, nullptr, nullptr,
                         batch, l, w, a_dtype, b_dtype, stream);
}

// The backward of lru_scan_fwd. a, h (the forward's output), dh, da, db:
// (batch, seq, width) contiguous, a and da in a's dtype, h, dh and db in
// b's; h0 (the forward's, f32), dh_last and dh0: (batch, width) f32, each
// may be null (no h0: h_{-1} = 0; no dh_last: zero; no dh0: not written).
extern "C" int lru_scan_bwd(const void* a, const void* h, const void* h0,
                            const void* dh, const void* dh_last, void* da,
                            void* db, void* dh0, int batch, int l, int w,
                            int a_dtype, int b_dtype, void* stream) {
  if (bad_shape(batch, l, w, a_dtype, b_dtype))
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(a, dh, dh_last, db, dh0, h, h0, da, batch, l, w,
                        a_dtype, b_dtype, stream);
}
