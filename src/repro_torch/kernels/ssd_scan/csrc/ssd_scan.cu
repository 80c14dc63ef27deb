// Mamba-2 SSD within-chunk terms for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// ::ssd_pallas (grid step body `_kernel`). It computes that kernel's three
// outputs, in float32, for every (batch b, chunk c, head h) of q rows:
//   cs      = cumsum(dt * A) over the chunk
//   y_diag  = (C B^T o L) @ (x * dt),  L[i][j] = exp(cs_i - cs_j), j <= i
//   states  = (B * exp(cs_last - cs))^T @ (x * dt)          (n x p)
//   decay_in = exp(cs)
// x (b, l, h, p), B and C (b, l, n) in f32 or bf16, dt (b, l, h) and A (h)
// in f32; y_diag (b, c, q, h, p), states (b, c, h, n, p) and decay_in
// (b, c, q, h) in f32. The recurrence across chunks and the off-diagonal
// term stay in PyTorch, as they stay outside the Pallas call.
//
// Bound, at (b, l, h, p, n) = (1, 2048, 48, 64, 128), chunk 256, bf16: the
// bytes (x, dt, B, C in; the f32 y_diag, states and decay_in out) are
// 52 MB, 0.016 ms at 3.35 TB/s; the operations the causal half needs (C B^T
// once per chunk, (C B^T o L) @ (x dt) for j <= i and the states product
// per head) are 3.3 GFLOP, 0.0033 ms at the bf16 tensor-core rate. So the
// bound is the bytes'. This kernel's own SIMT f32 path has a ceiling of
// 0.049 ms for those operations at 67 TFLOP/s.
//
// Design, simple first (tensor cores, TMA and a persistent schedule are
// later work):
//   * Everything in f32 on the CUDA cores (SIMT): with f32 inputs the
//     products must keep f32 accuracy, and one path serves both types
//     (bf16 inputs are widened as they are loaded).
//   * One block of 256 threads per (tile, c, b x head group). A head group
//     is up to G heads (G * p <= 256), which share the C B^T products: the
//     Pallas grid recomputes them for each of the 48 heads, although B and
//     C do not depend on the head.
//   * Blocks of the first kind own 32 rows i of the chunk. They hold those
//     rows of C in shared memory and walk the key tiles j (32 keys each)
//     up to their last row only, so the causal half is skipped: for each
//     tile, C B^T (32 x 32) once, then for each head P = C B^T o L with
//     exp taken only where j <= i (exp of the positive differences above
//     the diagonal could overflow), then y += P @ (x dt) into registers.
//   * Blocks of the second kind own 32 rows of the state and walk the
//     whole chunk: states += B^T @ (x dt exp(cs_last - cs)).
//   * Every block first takes cs for its heads: one warp per head scans
//     the chunk (8 consecutive rows a lane, then a shuffle scan), in f64.
//     cs reaches -180 over a 256-row chunk at the model's decays, where an
//     f32 ulp is 1.5e-5: kept in f32, the differences cs_i - cs_j near the
//     diagonal (the largest entries of L) would carry that error, and 48
//     layers amplify it. In f64 the differences are exact to f32 before
//     expf.
//   Any chunk length and any state size up to 256 are taken; the head dim
//   is one of 8, 16, 32, 64, 128, 256 (an instantiation each).
//
// C interface, loaded with ctypes: every pointer and the stream are void*.
// Returns cudaGetLastError() after the launch (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTI = 32;  // rows i per block of the first kind
constexpr int kTJ = 32;  // keys j per tile
constexpr int kNB = 32;  // state rows per block of the second kind
constexpr int kMaxState = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Dims {
  int nc, q, h, n;  // chunks, chunk length, heads, state size
  int ngroups, ytiles;
};

template <int P>
struct Shape {
  static constexpr int G = (256 / P) < 4 ? (256 / P) : 4;  // heads a block
  static constexpr int GP = G * P;                         // x columns
  static constexpr int MP = P < 16 ? 1 : P / 16;  // columns a thread, a head
};

// Shared memory, in floats: cs (f64, two floats each) and dt of the
// group's heads over the chunk, then the larger of the two kinds' areas.
template <int P>
__host__ __device__ int smem_floats(int q, int n) {
  using S = Shape<P>;
  const int yarea = kTI * (n + 1) + kTJ * (n + 1) + kTJ * S::GP +
                    S::G * kTI * (kTJ + 1);
  const int sarea = kTJ * (kNB + 1) + kTJ * S::GP;
  return 3 * S::G * q + (yarea > sarea ? yarea : sarea);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ C, float* __restrict__ y_diag,
                     float* __restrict__ states, float* __restrict__ decay_in,
                     Dims d) {
  using S = Shape<P>;
  constexpr int G = S::G, GP = S::GP, MP = S::MP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = d.q, h = d.h, n = d.n;
  double* cs = reinterpret_cast<double*>(smem);  // [G][q]
  float* dts = reinterpret_cast<float*>(cs + G * q);  // [G][q]
  float* area = dts + G * q;

  const int c = blockIdx.y;
  const int bi = blockIdx.z / d.ngroups, grp = blockIdx.z % d.ngroups;
  const int h0 = grp * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = (long long)bi * d.nc * q + (long long)c * q;  // (b, t)

  // ---- cs = cumsum(dt * A) over the chunk, in f64, one warp per head
  for (int g = warp; g < G; g += kThreads / 32) {
    const int hh = h0 + g;
    const double a = hh < h ? A[hh] : 0.f;
    const int per = (q + 31) / 32;
    const int i0 = min(q, lane * per), i1 = min(q, i0 + per);
    double run = 0.0;
    for (int i = i0; i < i1; ++i) {
      const float v = hh < h ? dt[(row0 + i) * h + hh] : 0.f;
      dts[g * q + i] = v;
      run += (double)v * a;
      cs[g * q + i] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const double up = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += up;
    }
    const double excl = incl - run;
    for (int i = i0; i < i1; ++i) cs[g * q + i] += excl;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int e = tid; e < q * G; e += kThreads) {
      const int i = e / G, g = e % G;
      if (h0 + g < h)
        decay_in[(row0 + i) * h + h0 + g] = expf((float)cs[g * q + i]);
    }
  }

  const int rt = tid / 16, ct = tid % 16;  // 16 x 16 threads over outputs
  float acc[G][2][MP];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int m = 0; m < MP; ++m) acc[g][a][m] = 0.f;

  if (blockIdx.x < d.ytiles) {
    // ---------------------------------------------- y_diag for rows i0..
    const int i0 = blockIdx.x * kTI;
    const int LDN = n + 1;
    float* Cs = area;               // [kTI][n + 1]
    float* Bs = Cs + kTI * LDN;     // [kTJ][n + 1]
    float* Xs = Bs + kTJ * LDN;     // [kTJ][GP]  x * dt
    float* Ps = Xs + kTJ * GP;      // [G][kTI][kTJ + 1]
    for (int e = tid; e < kTI * n; e += kThreads) {
      const int r = e / n, k = e % n;
      Cs[r * LDN + k] =
          i0 + r < q ? to_f(C[(row0 + i0 + r) * n + k]) : 0.f;
    }
    const int i_last = min(q, i0 + kTI) - 1;
    const int ra = tid / 16, ja = tid % 16;  // C B^T: rows ra, ra + 16
    for (int j0 = 0; j0 <= i_last; j0 += kTJ) {
      __syncthreads();  // the previous tile is consumed (and Cs written)
      for (int e = tid; e < kTJ * n; e += kThreads) {
        const int r = e / n, k = e % n;
        Bs[r * LDN + k] =
            j0 + r < q ? to_f(B[(row0 + j0 + r) * n + k]) : 0.f;
      }
      for (int e = tid; e < kTJ * GP; e += kThreads) {
        const int r = e / GP, col = e % GP, g = col / P;
        const bool ok = j0 + r < q && h0 + g < h;
        Xs[e] = ok ? to_f(x[((row0 + j0 + r) * h + h0) * P + col]) *
                         dts[g * q + j0 + r]
                   : 0.f;
      }
      __syncthreads();
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
      const float* c0 = Cs + ra * LDN;
      const float* c1 = Cs + (ra + 16) * LDN;
      const float* b0 = Bs + ja * LDN;
      const float* b1 = Bs + (ja + 16) * LDN;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float cv0 = c0[k], cv1 = c1[k], bv0 = b0[k], bv1 = b1[k];
        s00 = fmaf(cv0, bv0, s00);
        s01 = fmaf(cv0, bv1, s01);
        s10 = fmaf(cv1, bv0, s10);
        s11 = fmaf(cv1, bv1, s11);
      }
      const float sv[2][2] = {{s00, s01}, {s10, s11}};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double* csg = cs + g * q;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int r = ra + 16 * u, jj = ja + 16 * v;
            const int i = i0 + r, j = j0 + jj;
            const bool ok = j <= i && i < q;  // j <= i < q: j in range too
            Ps[(g * kTI + r) * (kTJ + 1) + jj] =
                ok ? sv[u][v] * expf((float)(csg[i] - csg[j])) : 0.f;
          }
        }
      }
      __syncthreads();
      for (int jj = 0; jj < kTJ; ++jj) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float xv[MP];
#pragma unroll
          for (int m = 0; m < MP; ++m)
            xv[m] = (P >= 16 || ct < P) ? Xs[jj * GP + g * P + ct + 16 * m]
                                        : 0.f;
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const float pv = Ps[(g * kTI + rt + 16 * a) * (kTJ + 1) + jj];
#pragma unroll
            for (int m = 0; m < MP; ++m)
              acc[g][a][m] = fmaf(pv, xv[m], acc[g][a][m]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (h0 + g >= h) continue;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = i0 + rt + 16 * a;
        if (i >= q) continue;
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const int pp = ct + 16 * m;
          if (pp < P)
            y_diag[((row0 + i) * h + h0 + g) * P + pp] = acc[g][a][m];
        }
      }
    }
  } else {
    // ------------------------------------------- states for rows n0..
    const int n0 = (blockIdx.x - d.ytiles) * kNB;
    float* Bs = area;                 // [kTJ][kNB + 1]
    float* Xw = Bs + kTJ * (kNB + 1);  // [kTJ][GP]  x * dt * exp(cs_last - cs)
    for (int j0 = 0; j0 < q; j0 += kTJ) {
      __syncthreads();
      for (int e = tid; e < kTJ * kNB; e += kThreads) {
        const int r = e / kNB, k = e % kNB;
        Bs[r * (kNB + 1) + k] = j0 + r < q && n0 + k < n
                                    ? to_f(B[(row0 + j0 + r) * n + n0 + k])
                                    : 0.f;
      }
      for (int e = tid; e < kTJ * GP; e += kThreads) {
        const int r = e / GP, col = e % GP, g = col / P, j = j0 + r;
        const bool ok = j < q && h0 + g < h;
        Xw[e] = ok ? to_f(x[((row0 + j) * h + h0) * P + col]) *
                         dts[g * q + j] *
                         expf((float)(cs[g * q + q - 1] - cs[g * q + j]))
                   : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < kTJ; ++jj) {
        const float bv0 = Bs[jj * (kNB + 1) + rt];
        const float bv1 = Bs[jj * (kNB + 1) + rt + 16];
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int m = 0; m < MP; ++m) {
            const float xv = (P >= 16 || ct < P)
                                 ? Xw[jj * GP + g * P + ct + 16 * m]
                                 : 0.f;
            acc[g][0][m] = fmaf(bv0, xv, acc[g][0][m]);
            acc[g][1][m] = fmaf(bv1, xv, acc[g][1][m]);
          }
        }
      }
    }
    const long long st0 = ((long long)bi * d.nc + c) * h;  // (b, c) row
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (h0 + g >= h) continue;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int nn = n0 + rt + 16 * a;
        if (nn >= n) continue;
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const int pp = ct + 16 * m;
          if (pp < P)
            states[((st0 + h0 + g) * n + nn) * P + pp] = acc[g][a][m];
        }
      }
    }
  }
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, float* y_diag, float* states, float* decay_in,
           int b, int nc, int q, int h, int n, cudaStream_t st) {
  using S = Shape<P>;
  Dims d{nc, q, h, n, (h + S::G - 1) / S::G, (q + kTI - 1) / kTI};
  const long long z = (long long)b * d.ngroups;
  const int smem = smem_floats<P>(q, n) * (int)sizeof(float);
  if (z > 65535 || nc > 65535 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(d.ytiles + (n + kNB - 1) / kNB, nc, (unsigned)z);
  ssd_chunk_kernel<T, P><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), y_diag, states, decay_in, d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* B,
             const void* C, float* y, float* s, float* di, int b, int nc,
             int q, int h, int p, int n, cudaStream_t st) {
  switch (p) {
    case 8: return launch<T, 8>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st);
    case 16: return launch<T, 16>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st);
    case 32: return launch<T, 32>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st);
    case 64: return launch<T, 64>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st);
    case 128:
      return launch<T, 128>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st);
    case 256:
      return launch<T, 256>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b, nc*q, h, p), B and C (b, nc*q, n): all f32 (dtype 0) or all bf16
// (dtype 1); dt (b, nc*q, h) and A (h) f32; outputs f32: y_diag
// (b, nc, q, h, p), states (b, nc, h, n, p), decay_in (b, nc, q, h). All
// contiguous.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y_diag,
                             void* states, void* decay_in, int b, int nc,
                             int q, int h, int p, int n, int dtype,
                             void* stream) {
  if (b < 1 || nc < 1 || q < 1 || h < 1 || n < 1 || n > kMaxState ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* y = static_cast<float*>(y_diag);
  float* s = static_cast<float*>(states);
  float* di = static_cast<float*>(decay_in);
  if (dtype == 0)
    return dispatch<float>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, p, n, st);
  return dispatch<__nv_bfloat16>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, p,
                                 n, st);
}
