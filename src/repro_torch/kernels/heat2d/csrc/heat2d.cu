// Blocked red-black Gauss-Seidel tile sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/heat2d/heat2d.py::
// heat2d_sweep_pallas (grid step body `_kernel`): `sweeps` red-black passes
// u <- 0.25 * (((N + S) + W) + E) over every (tx, ty) tile of an (nx, ny)
// block. Within a tile the sweep is Gauss-Seidel in red-black order, colour
// by TILE-LOCAL parity (ii + jj) % 2; across tiles it is Jacobi: a neighbour
// in another tile, or past the block edge (the caller's halo strips, else
// zero), is read from the INPUT and stays frozen for all sweeps.
//
// Bound: memory. The least work is one read and one write of the grid,
// 2 * nx * ny * 4 B in f32: 2.15 GB at 16384^2, 0.64 ms at 3.35 TB/s. The
// arithmetic (5 flops per cell per sweep) is far below the f32 peak.
//
// Design. The TPU kernel keeps a tile in VMEM for all its sweeps, so HBM is
// touched once per tile whatever `sweeps` is. A 256x256 f32 tile is 256 KB,
// more than one block's 227 KB of shared memory, so here a tile is split
// into row bands over the blocks of one thread-block cluster (path
// "cluster_smem", kernel `tile_sweep`), one launch per call:
//   * the cluster size C (1, 2, 4 or 8) is the smallest whose band fits
//     kBandBudget bytes (three blocks an SM, so one block's loads or stores
//     overlap another's sweeps), else the smallest that fits a block's
//     227 KB; 256x256 gives C = 4, bands of 64 rows, 66.6 KB a block. Small
//     tiles are one block each (C = 1);
//   * a block loads its band once (16-byte loads where ty % 4 == 0, eight
//     in flight a thread), converting bf16 to f32 on the way in, and the
//     frozen strips it borders: the row above the tile (first band) and
//     below it (last band), and the columns left and right of its rows,
//     from the neighbour tiles' input, else the caller's halo ring, else
//     zeros;
//   * shared memory holds the band split by colour, two arrays of
//     ceil(ty / 2) cells a row: a cell of one colour reads only cells of the
//     other. A thread owns V (2 where ty % 4 == 0, else 1) adjacent
//     columns of the colour arrays over a run of rows and walks down them,
//     so a row of V updates costs one V-wide load, one scalar load and one
//     V-wide store, without bank conflicts; each row's code is compiled for
//     its colour parity, which alternates down the run;
//   * each half-sweep updates one colour in place. A band's first and last
//     rows read the neighbouring band's row straight from that block's
//     shared memory (DSMEM): those cells are of the other colour, which no
//     block writes in this half-sweep. Those loads are issued first and a
//     run walks towards them, so their latency hides behind its other rows.
//     One cluster barrier ends each half-sweep;
//   * a block writes its band to `out`, rounding to bf16 once on the way
//     out where the input is bf16. No working grid, no extra pass.
// A tile too large for eight blocks' shared memory (1024x1024 is 4 MB)
// takes path "global": the input is copied into an f32 working grid, then
// one launch a half-sweep updates one colour in place in global memory
// (kernel `half_sweep`; in-place is safe for the same reason), and bf16 is
// rounded by a last pass. The path is chosen from the tile's shape alone
// (heat2d_plan); both are hand-written kernels, neither falls back to the
// other.
//
// Launch: cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension
// (C, 1, 1) and the band's dynamic shared memory (opted in above 48 KB with
// cudaFuncSetAttribute). A cluster shape the card cannot schedule is
// refused there; the error is returned to the wrapper, which raises.
//
// Tuning: kBandBudget (which sets C) and kThreads were chosen by timing
// copies of this source with other values side by side
// (tools/kernel_variants.py). The committed choice, C = 4 for 256x256
// tiles and 256 threads (V = 2: 72 registers in f32, no spills), sweeps
// 16384^2 in 0.897 ms for one sweep and 1.429 ms for four, against 1.339
// and 2.246 ms with C = 2, 1.065 and 2.001 ms with C = 8, and 1.052 and
// 1.681 ms with 128 threads; at tile (128, 64) 128 threads win, 0.898
// against 1.044 ms (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has the run).
// V = 4 (four colour columns a thread) was slower and is not kept.
//
// Numerics: the sum order of the Pallas kernel and the plain version,
// with __fadd_rn / __fmul_rn so no FMA contraction can change a bit; the
// red-black order makes the update order within a colour irrelevant, so f32
// is bit-equal to the plain version on both paths.
//
// C interface, loaded with ctypes: every pointer and the stream are void*,
// the function returns the first launch error (0 if none).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                   // threads of a tile_sweep block
constexpr int kMaxCluster = 8;                  // portable cluster size
constexpr int kLoadBatch = 8;                   // loads a thread issues at once
constexpr size_t kBandBudget = 75776;           // bytes: three blocks an SM
constexpr size_t kMaxSmem = 232448;             // a block's shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive cells as f32, and back (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the high half of the f32 with the same value
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  auto bits = [](float x) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
  };
  *reinterpret_cast<uint2*>(p) = make_uint2(bits(v.x) | bits(v.y) << 16,
                                            bits(v.z) | bits(v.w) << 16);
}

// V consecutive floats of shared memory (local or another block's), in one
// access where V > 1 (the address is then 8V-byte aligned).
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void storev(float* p, const float (&x)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

// Shared-memory layout of a band of at most `rmax` rows of a tile `ty`
// wide: two colour arrays of rmax * ceil(ty / 2) cells (the second shifted
// by 16 banks, so a row's neighbouring cells, which alternate colours, load
// without conflicts), then the north and south strips (ty each) and the
// west and east columns (rmax each).
struct Band {
  int h;       // cells a row per colour
  int stride;  // floats from one colour array to the other
  __host__ __device__ Band(int rmax, int ty) {
    h = (ty + 1) / 2;
    stride = (rmax * h + 31) / 32 * 32 + 16;
  }
  __host__ __device__ size_t bytes(int rmax, int ty) const {
    return sizeof(float) * ((size_t)2 * stride + 2 * ty + 2 * rmax);
  }
};

// Cluster size for a tile (0: the tile takes the global path), and the
// dynamic shared memory of one block.
int plan(int tx, int ty, size_t* smem) {
  const size_t budgets[2] = {kBandBudget, kMaxSmem};
  for (size_t budget : budgets) {
    for (int c = 1; c <= kMaxCluster && c <= tx; c *= 2) {
      const int rmax = (tx + c - 1) / c;
      const size_t bytes = Band(rmax, ty).bytes(rmax, ty);
      if (bytes <= budget) {
        *smem = bytes;
        return c;
      }
    }
  }
  *smem = 0;
  return 0;
}

// Walks a flat index e = i * width + k in steps of kThreads without a
// division per step.
struct Walk {
  int i, k, di, dk, width;
  __device__ Walk(int start, int width_) : width(width_) {
    i = start / width;
    k = start - i * width;
    di = kThreads / width;
    dk = kThreads - di * width;
  }
  __device__ void next() {
    i += di;
    k += dk;
    if (k >= width) {
      k -= width;
      ++i;
    }
  }
};

// One (tx, ty) tile per cluster of C = gridDim.x / gy blocks; block `rank`
// of the cluster owns rows [rank * tx / C, (rank + 1) * tx / C) of it.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    tile_sweep(const T* __restrict__ u, T* __restrict__ out,
               const float* __restrict__ hn, const float* __restrict__ hs,
               const float* __restrict__ hw, const float* __restrict__ he,
               int nx, int ny, int tx, int ty, int sweeps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int gx = nx / tx, gy = ny / ty;
  const int gi = blockIdx.y, gj = blockIdx.x / nc;
  const int rmax = (tx + nc - 1) / nc;
  const int i0 = rank * tx / nc, rows = (rank + 1) * tx / nc - i0;
  const Band band(rmax, ty);
  const int hh = band.h;
  // colour array q (0 or 1) of this block, or of another block's band
  auto col = [&](int q) { return smem + (q & 1) * band.stride; };
  float* north = smem + 2 * band.stride;
  float* south = north + ty;
  float* west = south + ty;
  float* east = west + rmax;
  const int64_t top = (int64_t)gi * tx + i0;  // grid row of the band's row 0
  const int64_t left = (int64_t)gj * ty;      // grid column of the tile
  const int tid = threadIdx.x;

  // ---- load the band, split by colour, and the frozen strips it borders
  if (V > 1) {  // ty % 4 == 0: runs of four cells, two of each colour
    const int w4 = ty / 4, n4 = rows * w4;
    for (int e0 = tid; e0 < n4; e0 += kLoadBatch * kThreads) {
      float4 v[kLoadBatch];
#pragma unroll
      for (int q = 0; q < kLoadBatch; ++q) {  // all loads, then all stores
        const int e = e0 + q * kThreads;
        if (e < n4) {
          const int i = e / w4;
          v[q] = load4(u + (top + i) * ny + left + 4 * (e - i * w4));
        }
      }
#pragma unroll
      for (int q = 0; q < kLoadBatch; ++q) {
        const int e = e0 + q * kThreads;
        if (e < n4) {
          const int i = e / w4, jj = 4 * (e - i * w4);
          const int c = (i0 + i + jj) & 1;  // colour of cells jj and jj + 2
          *reinterpret_cast<float2*>(col(c) + i * hh + jj / 2) =
              make_float2(v[q].x, v[q].z);
          *reinterpret_cast<float2*>(col(c ^ 1) + i * hh + jj / 2) =
              make_float2(v[q].y, v[q].w);
        }
      }
    }
  } else {
    Walk it(tid, ty);
    for (int e = tid; e < rows * ty; e += kThreads, it.next()) {
      const int i = it.i, jj = it.k;
      col(i0 + i + jj)[i * hh + (jj >> 1)] =
          to_f32(u[(top + i) * ny + left + jj]);
    }
  }
  if (rank == 0)
    for (int jj = tid; jj < ty; jj += kThreads)
      north[jj] = gi > 0 ? to_f32(u[(top - 1) * ny + left + jj])
                         : (hn ? hn[left + jj] : 0.f);
  if (rank == nc - 1)
    for (int jj = tid; jj < ty; jj += kThreads)
      south[jj] = gi < gx - 1 ? to_f32(u[(top + rows) * ny + left + jj])
                              : (hs ? hs[left + jj] : 0.f);
  for (int i = tid; i < rows; i += kThreads) {
    west[i] = gj > 0 ? to_f32(u[(top + i) * ny + left - 1])
                     : (hw ? hw[top + i] : 0.f);
    east[i] = gj < gy - 1 ? to_f32(u[(top + i) * ny + left + ty])
                          : (he ? he[top + i] : 0.f);
  }
  // the neighbouring bands' colour arrays and their rows next to this band
  const float* up = nullptr;  // colour array 0 of the band above, if any
  const float* dn = nullptr;  // and of the band below
  int up_row = 0;
  if (rank > 0) {
    up = cluster.map_shared_rank(smem, rank - 1);
    up_row = i0 - (rank - 1) * tx / nc - 1;
  }
  if (rank < nc - 1) {
    dn = cluster.map_shared_rank(smem, rank + 1);
  }
  cluster.sync();

  // ---- sweeps: one colour a half-sweep, in place, one barrier each.
  // A thread owns V adjacent columns k0.. of the colour arrays over a run of
  // rows [ra, rb) and walks down them: the cell of colour c in row i and
  // column k sits at jj = 2k + ((c + ii) & 1), and its north and south are
  // the other colour's column k at rows i - 1 and i + 1, its west and east
  // columns k - 1 and k or k and k + 1 of row i. So a row costs one new
  // V-wide load of the other colour, at most one scalar load beside it, and
  // one V-wide store.
  const int runs = hh / V;  // V divides hh (ty % 2V == 0) where V > 1
  const int groups = runs < kThreads ? kThreads / runs : 1;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int c = 0; c < 2; ++c) {
      float* mine = col(c);
      const float* oth = col(c ^ 1);
      const int other = (c ^ 1) * band.stride;  // its offset in any band
      for (int slot = tid; slot < groups * runs; slot += kThreads) {
        const int g = slot / runs, k0 = (slot - g * runs) * V;
        const int ra = g * rows / groups, rb = (g + 1) * rows / groups;
        if (ra == rb) continue;
        // the other colour's columns k0.. at row i, for i in [-1, rows]
        auto columns = [&](int i, float(&x)[V]) {
          if (i < 0 && up) {
            loadv<V>(up + other + up_row * hh + k0, x);
          } else if (i >= rows && dn) {
            loadv<V>(dn + other + k0, x);
          } else if (i < 0 || i >= rows) {  // the frozen strip at jj
            const float* strip = i < 0 ? north : south;
            const int p = (c + i0 + (i < 0 ? 0 : rows - 1)) & 1;
#pragma unroll
            for (int v = 0; v < V; ++v)
              x[v] = strip[min(2 * (k0 + v) + p, ty - 1)];
          } else {
            loadv<V>(oth + i * hh + k0, x);
          }
        };
        // row i, of parity P = (c + ii) & 1 (a compile-time constant, so
        // each row's code has no branch on it), from the other colour's
        // columns above (n), in (m) and below (s) it
        auto update = [&](auto P, int i, const float(&n)[V],
                          const float(&m)[V], const float(&s)[V]) {
          constexpr int p = decltype(P)::value;
          const float* r = oth + i * hh;
          // the west of the first cell (p = 0) or east of the last (p = 1)
          float side;
          if constexpr (p)
            side = k0 + V < hh ? r[k0 + V] : east[i];
          else
            side = k0 > 0 ? r[k0 - 1] : west[i];
          float res[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            float w, e;
            if constexpr (p) {  // jj = 2k + 1: west is column k, east k + 1
              w = m[v];
              e = v < V - 1 ? m[v + 1] : side;
            } else {  // jj = 2k: west is column k - 1, east column k
              w = v > 0 ? m[v - 1] : side;
              // jj = ty - 1 only for an odd ty, so only where V == 1
              e = (V > 1 || 2 * k0 < ty - 1) ? m[v] : east[i];
            }
            res[v] = __fmul_rn(
                0.25f, __fadd_rn(__fadd_rn(__fadd_rn(n[v], s[v]), w), e));
          }
          if (V > 1 || 2 * k0 + p < ty) storev<V>(mine + i * hh + k0, res);
        };
        constexpr std::integral_constant<int, 0> even{};
        constexpr std::integral_constant<int, 1> odd{};
        auto parity_of = [&](int i) { return (c + i0 + i) & 1; };
        // The rows past the run come first: one of them may lie in another
        // block (DSMEM), and the walk goes towards it, so its latency hides
        // behind the run's other rows.
        float first_n[V], last_s[V], x[V], y[V], z[V];
        columns(ra - 1, first_n);
        columns(rb, last_s);
        if (ra == rb - 1) {
          columns(ra, y);
          if (parity_of(ra)) update(odd, ra, first_n, y, last_s);
          else update(even, ra, first_n, y, last_s);
        } else if (ra == 0 && up) {  // bottom-up: the band above comes last
          // rows rb - 1, rb - 2, ... alternate parities P, Q, P, ...
          auto walk = [&](auto P, auto Q) {
            columns(rb - 1, y);
            loadv<V>(oth + (rb - 2) * hh + k0, x);
            update(P, rb - 1, x, y, last_s);
            int i = rb - 2;
            for (; i - 1 > ra; i -= 2) {
#pragma unroll
              for (int v = 0; v < V; ++v) z[v] = y[v], y[v] = x[v];
              loadv<V>(oth + (i - 1) * hh + k0, x);
              update(Q, i, x, y, z);
#pragma unroll
              for (int v = 0; v < V; ++v) z[v] = y[v], y[v] = x[v];
              loadv<V>(oth + (i - 2) * hh + k0, x);
              update(P, i - 1, x, y, z);
            }
            if (i > ra) {  // row i has parity Q, row ra parity P
#pragma unroll
              for (int v = 0; v < V; ++v) z[v] = y[v], y[v] = x[v];
              loadv<V>(oth + (i - 1) * hh + k0, x);
              update(Q, i, x, y, z);
              update(P, ra, first_n, x, y);
            } else {  // i == ra: row ra has parity Q
              update(Q, ra, first_n, x, y);
            }
          };
          if (parity_of(rb - 1)) walk(odd, even);
          else walk(even, odd);
        } else {  // top-down: the band below (if any) comes last
          // rows ra, ra + 1, ... alternate parities P, Q, P, ...
          auto walk = [&](auto P, auto Q) {
            columns(ra, y);
            loadv<V>(oth + (ra + 1) * hh + k0, z);
            update(P, ra, first_n, y, z);
            int i = ra + 1;
            for (; i + 1 < rb - 1; i += 2) {
#pragma unroll
              for (int v = 0; v < V; ++v) x[v] = y[v], y[v] = z[v];
              loadv<V>(oth + (i + 1) * hh + k0, z);
              update(Q, i, x, y, z);
#pragma unroll
              for (int v = 0; v < V; ++v) x[v] = y[v], y[v] = z[v];
              loadv<V>(oth + (i + 2) * hh + k0, z);
              update(P, i + 1, x, y, z);
            }
            if (i < rb - 1) {  // row i has parity Q, row rb - 1 parity P
#pragma unroll
              for (int v = 0; v < V; ++v) x[v] = y[v], y[v] = z[v];
              loadv<V>(oth + (i + 1) * hh + k0, z);
              update(Q, i, x, y, z);
              update(P, rb - 1, y, z, last_s);
            } else {  // i == rb - 1: row rb - 1 has parity Q
              update(Q, rb - 1, y, z, last_s);
            }
          };
          if (parity_of(ra)) walk(odd, even);
          else walk(even, odd);
        }
      }
      cluster.sync();
    }
  }
  // No block reads another's shared memory after the last barrier, so each
  // writes its band and leaves.

  // ---- store the band, interleaving the colours back into rows
  if (V > 1) {
    const int w4 = ty / 4, n4 = rows * w4;
    Walk it(tid, w4);
    for (int e = tid; e < n4; e += kThreads, it.next()) {
      const int i = it.i, jj = 4 * it.k;
      const int q = (i0 + i + jj) & 1;
      const float2 a =
          *reinterpret_cast<const float2*>(col(q) + i * hh + jj / 2);
      const float2 b =
          *reinterpret_cast<const float2*>(col(q ^ 1) + i * hh + jj / 2);
      store4(out + (top + i) * ny + left + jj, make_float4(a.x, b.x, a.y, b.y));
    }
  } else {
    Walk it(tid, ty);
    for (int e = tid; e < rows * ty; e += kThreads, it.next()) {
      const int i = it.i, jj = it.k;
      out[(top + i) * ny + left + jj] =
          from_f32<T>(col(i0 + i + jj)[i * hh + (jj >> 1)]);
    }
  }
}

template <typename T, int V>
int launch_tiles(const T* u, T* out, const float* hn, const float* hs,
                 const float* hw, const float* he, int nx, int ny, int tx,
                 int ty, int sweeps, int nc, size_t smem, cudaStream_t st) {
  auto kernel = tile_sweep<T, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * (ny / ty), nx / tx, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, u, out, hn, hs, hw, he, nx, ny, tx,
                           ty, sweeps);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------ path "global" (big tiles)

template <typename T>
__global__ void load_f32(const T* __restrict__ u, float* __restrict__ work,
                         int64_t n) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    work[i] = to_f32(u[i]);
}

__global__ void store_bf16(const float* __restrict__ work,
                           __nv_bfloat16* __restrict__ out, int64_t n) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __float2bfloat16_rn(work[i]);
}

// One half-sweep: every cell of `colour` in every tile, in place in `work`.
template <typename T>
__global__ void half_sweep(const T* __restrict__ u, float* work,
                           const float* __restrict__ hn,
                           const float* __restrict__ hs,
                           const float* __restrict__ hw,
                           const float* __restrict__ he, int nx, int ny,
                           int tx, int ty, int colour) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ii = i % tx, jj = j % ty;
  if (((ii + jj) & 1) != colour) return;
  const int64_t idx = (int64_t)i * ny + j;

  float n, s, w, e;
  if (ii > 0) n = work[idx - ny];              // same tile: current state
  else if (i > 0) n = to_f32(u[idx - ny]);     // tile above: frozen input
  else n = hn ? hn[j] : 0.f;                   // block edge: halo or zero
  if (ii < tx - 1) s = work[idx + ny];
  else if (i < nx - 1) s = to_f32(u[idx + ny]);
  else s = hs ? hs[j] : 0.f;
  if (jj > 0) w = work[idx - 1];
  else if (j > 0) w = to_f32(u[idx - 1]);
  else w = hw ? hw[i] : 0.f;
  if (jj < ty - 1) e = work[idx + 1];
  else if (j < ny - 1) e = to_f32(u[idx + 1]);
  else e = he ? he[i] : 0.f;

  work[idx] = __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(n, s), w), e));
}

template <typename T>
int run_global(const T* u, float* work, const float* hn, const float* hs,
               const float* hw, const float* he, int nx, int ny, int tx,
               int ty, int sweeps, cudaStream_t stream) {
  const int64_t n = (int64_t)nx * ny;
  const int flat_threads = 256;
  const int64_t want = (n + flat_threads - 1) / flat_threads;
  const int flat_blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  load_f32<T><<<flat_blocks, flat_threads, 0, stream>>>(u, work, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 block(32, 8);
  const dim3 grid((ny + block.x - 1) / block.x, (nx + block.y - 1) / block.y);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int colour = 0; colour < 2; ++colour) {
      half_sweep<T><<<grid, block, 0, stream>>>(u, work, hn, hs, hw, he, nx,
                                                ny, tx, ty, colour);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

template <typename T>
int run(const T* u, T* out, float* work, const float* hn, const float* hs,
        const float* hw, const float* he, int nx, int ny, int tx, int ty,
        int sweeps, cudaStream_t s) {
  size_t smem = 0;
  const int nc = plan(tx, ty, &smem);
  if (nc > 0) {
    if (ty % 4 == 0)
      return launch_tiles<T, 2>(u, out, hn, hs, hw, he, nx, ny, tx, ty,
                                sweeps, nc, smem, s);
    return launch_tiles<T, 1>(u, out, hn, hs, hw, he, nx, ny, tx, ty,
                              sweeps, nc, smem, s);
  }
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  return run_global<T>(u, work, hn, hs, hw, he, nx, ny, tx, ty, sweeps, s);
}

}  // namespace

// The path a tile takes, from its shape alone: the cluster size (1-8) of
// path "cluster_smem", or 0 for path "global"; `smem` gets the dynamic
// shared memory of one block (0 on the global path).
extern "C" int heat2d_plan(int tx, int ty, void* smem) {
  size_t bytes = 0;
  const int nc = (tx > 0 && ty > 0) ? plan(tx, ty, &bytes) : 0;
  if (smem) *static_cast<long long*>(smem) = (long long)bytes;
  return nc;
}

// dtype 0: u and out are float32; dtype 1: bf16. `work` is only read on the
// global path (heat2d_plan() == 0): a float32 grid of nx * ny cells (for
// float32 it may be `out`). Halo pointers may be null (zeros);
// north/south hold ny values, west/east nx, all float32.
extern "C" int heat2d_sweep(const void* u, void* out, void* work,
                            const void* hn, const void* hs, const void* hw,
                            const void* he, int nx, int ny, int tx, int ty,
                            int sweeps, int dtype, void* stream) {
  if (nx <= 0 || ny <= 0 || tx <= 0 || ty <= 0 || nx % tx || ny % ty ||
      sweeps < 0 || nx / tx > 65535 || (nx + 7) / 8 > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* n_ = static_cast<const float*>(hn);
  const float* s_ = static_cast<const float*>(hs);
  const float* w_ = static_cast<const float*>(hw);
  const float* e_ = static_cast<const float*>(he);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(u), static_cast<float*>(out),
                      wk, n_, s_, w_, e_, nx, ny, tx, ty, sweeps, s);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  int err = run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(u), ob, wk,
                               n_, s_, w_, e_, nx, ny, tx, ty, sweeps, s);
  if (err || heat2d_plan(tx, ty, nullptr) > 0) return err;
  const int64_t n = (int64_t)nx * ny;
  const int64_t want = (n + 255) / 256;
  store_bf16<<<(int)(want < 132 * 64 ? want : 132 * 64), 256, 0, s>>>(wk, ob,
                                                                       n);
  return (int)cudaGetLastError();
}
