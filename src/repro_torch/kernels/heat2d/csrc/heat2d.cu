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
// Design, deliberately simple for a first kernel: the result tile cannot
// simply be staged in shared memory (a 256x256 f32 tile plus its ring is
// 266 KB, over the 227 KB a block may use), and the tile size is part of
// the result, so it must not be shrunk either. So there is no shared memory
// at all: the input is copied into a float32 working grid, then each
// half-sweep is one launch over the whole grid, one thread per cell, that
// updates the cells of one colour in place. In-place is safe because a cell
// of one colour reads, within its tile, only cells of the other colour; its
// cross-tile neighbours come from the unchanging input. That costs about
// 2 + 4 * sweeps grid passes, far off the bound. An SMEM-resident
// multi-sweep for tiles that fit, clusters/DSMEM for 256^2, or temporal
// blocking is later work.
//
// Numerics: the sum order of the Pallas kernel and the plain version,
// with __fadd_rn / __fmul_rn so no FMA contraction can change a bit. bf16
// input is computed in float32 (the working grid) and rounded once at the
// end, as the Pallas kernel computes in f32 and casts on the way out.
//
// C interface, loaded with ctypes: every pointer and the stream are void*,
// the function returns the first non-zero cudaGetLastError() (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
int run(const T* u, float* work, const float* hn, const float* hs,
        const float* hw, const float* he, int nx, int ny, int tx, int ty,
        int sweeps, cudaStream_t stream) {
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

}  // namespace

// dtype 0: u and out are float32 and `work` is `out`.
// dtype 1: u and out are bf16 and `work` is a float32 scratch grid.
// Halo pointers may be null (zeros); north/south hold ny values, west/east nx.
extern "C" int heat2d_sweep(const void* u, void* out, void* work,
                            const void* hn, const void* hs, const void* hw,
                            const void* he, int nx, int ny, int tx, int ty,
                            int sweeps, int dtype, void* stream) {
  if (nx <= 0 || ny <= 0 || tx <= 0 || ty <= 0 || nx % tx || ny % ty ||
      sweeps < 0 || (nx + 7) / 8 > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* n_ = static_cast<const float*>(hn);
  const float* s_ = static_cast<const float*>(hs);
  const float* w_ = static_cast<const float*>(hw);
  const float* e_ = static_cast<const float*>(he);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(u), wk, n_, s_, w_, e_, nx,
                      ny, tx, ty, sweeps, s);
  int err = run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(u), wk, n_,
                               s_, w_, e_, nx, ny, tx, ty, sweeps, s);
  if (err) return err;
  const int64_t n = (int64_t)nx * ny;
  const int64_t want = (n + 255) / 256;
  store_bf16<<<(int)(want < 132 * 64 ? want : 132 * 64), 256, 0, s>>>(
      wk, static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}
