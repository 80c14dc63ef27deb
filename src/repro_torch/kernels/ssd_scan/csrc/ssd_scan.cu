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
// bound is the bytes', and the products have to run on the tensor cores to
// come near it (SIMT f32 alone would take 0.049 ms at 67 TFLOP/s).
//
// Design, bf16 inputs (the serving path):
//   * Blocks of 4 warps, of two kinds, per (b, c, group of G heads, slice of
//     up to 128 columns of a head): G heads share the C B^T products (the
//     Pallas grid recomputes them per head), G * W <= 128 columns.
//     - y_diag blocks own 64 rows i (16 a warp) and walk key tiles of 32
//       rows j up to their last row; a warp whose rows end before a tile
//       skips it, so only the causal half is computed. Per tile:
//       S = C B^T on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//       accumulate: the products of bf16 values are exact), then per head
//       P' = S o L o dt_j in f32 registers (dt goes with P's columns, so
//       the other operand, x, stays exact in bf16), exp taken only where
//       j <= i (exp of the positive differences above the diagonal could
//       overflow), and y += P' @ x on the tensor cores.
//     - states blocks own 64 state rows and walk the whole chunk:
//       states += B^T @ (x dt exp(cs_last - cs)), B^T's fragments loaded
//       from B's rows by ldmatrix.trans; B is exact in bf16.
//   * Each product has one exact bf16 operand (x, or B) and one f32 one
//     (P', or x dt exp(cs_last - cs)). The f32 operand is split into three
//     bf16 parts, v = hi + mid + lo (hi = bf16(v), mid = bf16(v - hi),
//     lo = bf16(the rest)), about 24 bits, and the three products are
//     summed in f32 (lo, mid, then hi). Two parts (about 16 bits) were
//     measured first, emulated on the CPU at the full-width chunk and the
//     model's decays: y_diag's error against float64 is 1.6e-5 with dt
//     folded into P (3.1e-5 with hi hi + hi lo + lo hi of P and x dt),
//     above the plain f32 version's 1.3e-5; three parts give 6.5e-7
//     (tests/test_torch_ssd.py::
//     test_kernel_precision_choice_beats_plain_float32).
//   * mma.sync, not wgmma: the kernel is bound by bytes; the A operands
//     of y's products (the parts of P') are built in registers between
//     the products, 16 rows a warp, where a warp's own rows decide what it
//     skips; and tiles of 16 rows keep ragged chunks cheap.
//   * Copies: B and C rows and raw x tiles arrive by 16-byte cp.async
//     (element loads where n is not a multiple of 8) into rows padded by
//     8 halves (conflict-free ldmatrix), two stages: tile j + 1 loads while
//     tile j computes. y_diag blocks read x as it arrives; states blocks
//     split x dt w once per tile into three shared tiles. The outputs go
//     through shared memory and leave as coalesced 16-byte stores of whole
//     rows (y_diag is half the bytes).
//   * Every block first takes cs for its heads: one warp per head scans
//     the chunk (consecutive rows a lane, then a shuffle scan), in f64.
//     cs reaches -180 over a 256-row chunk at the model's decays, where an
//     f32 ulp is 1.5e-5: kept in f32, the differences cs_i - cs_j near the
//     diagonal (the largest entries of L) would carry that error, and 48
//     layers amplify it. In f64 the differences are exact to f32 before
//     expf.
//   * The grid puts the heaviest row tiles first.
//   Any chunk length (ragged tiles are zero-filled and masked) and any
//   state size up to 256 (padded to 16 with zeros) are taken; the head dim
//   is one of 8, 16, 32, 64, 128, 256 (an instantiation each).
//
// f32 inputs keep a SIMT f32 path (no tensor-core split of f32 is needed
// there: it serves the all-f32 cases and the f32 model checks): blocks of
// 256 threads per (32 rows or 32 state rows, c, b x head group of up to 4
// heads), the same causal skipping, f64 cs and exp rule.
//
// C interface, loaded with ctypes: every pointer and the stream are void*.
// Returns cudaGetLastError() after the launch (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kThreads = 256;
constexpr int kTI = 32;  // rows i per block of the first kind
constexpr int kTJ = 32;  // keys j per tile
constexpr int kNB = 32;  // state rows per block of the second kind
constexpr int kMaxState = 256;

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

template <int P>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_simt(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ C, float* __restrict__ y_diag,
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
          i0 + r < q ? C[(row0 + i0 + r) * n + k] : 0.f;
    }
    const int i_last = min(q, i0 + kTI) - 1;
    const int ra = tid / 16, ja = tid % 16;  // C B^T: rows ra, ra + 16
    for (int j0 = 0; j0 <= i_last; j0 += kTJ) {
      __syncthreads();  // the previous tile is consumed (and Cs written)
      for (int e = tid; e < kTJ * n; e += kThreads) {
        const int r = e / n, k = e % n;
        Bs[r * LDN + k] =
            j0 + r < q ? B[(row0 + j0 + r) * n + k] : 0.f;
      }
      for (int e = tid; e < kTJ * GP; e += kThreads) {
        const int r = e / GP, col = e % GP, g = col / P;
        const bool ok = j0 + r < q && h0 + g < h;
        Xs[e] = ok ? x[((row0 + j0 + r) * h + h0) * P + col] *
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
                                    ? B[(row0 + j0 + r) * n + n0 + k]
                                    : 0.f;
      }
      for (int e = tid; e < kTJ * GP; e += kThreads) {
        const int r = e / GP, col = e % GP, g = col / P, j = j0 + r;
        const bool ok = j < q && h0 + g < h;
        Xw[e] = ok ? x[((row0 + j) * h + h0) * P + col] *
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

template <int P>
int launch_simt(const void* x, const float* dt, const float* A,
                const void* B, const void* C, float* y_diag, float* states,
                float* decay_in, int b, int nc, int q, int h, int n,
                cudaStream_t st) {
  using S = Shape<P>;
  Dims d{nc, q, h, n, (h + S::G - 1) / S::G, (q + kTI - 1) / kTI};
  const long long z = (long long)b * d.ngroups;
  const int smem = smem_floats<P>(q, n) * (int)sizeof(float);
  if (z > 65535 || nc > 65535 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_simt<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(d.ytiles + (n + kNB - 1) / kNB, nc, (unsigned)z);
  ssd_chunk_simt<P><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), y_diag, states, decay_in, d);
  return (int)cudaGetLastError();
}


// ------------------------------------------------- bf16: tensor cores
constexpr int kTcThreads = 128;  // 4 warps, 16 rows each
constexpr int kRowsY = 64;       // rows i per y_diag block
constexpr int kRowsS = 64;       // state rows per states block
constexpr int kKeys = 32;        // keys j per tile

template <int P>
struct TcShape {
  static constexpr int W = P > 128 ? 128 : P;  // columns of a head a block
  static constexpr int G = P >= 128 ? 1 : (128 / P < 4 ? 128 / P : 4);
  static constexpr int GW = G * W;             // x columns a block
  static constexpr int NT = W / 8;             // 8-column tiles a head
  static constexpr int LDX = GW + 8;           // x tile row, in halves
  static constexpr int LDO = GW + 4;           // output staging row, floats
};

// Shared memory of a block, in bytes: cs (f64), dt and (states blocks)
// dt exp(cs_last - cs) of its heads over the chunk; the B and raw x rings
// (two stages of kKeys rows each), which the output staging reuses after
// the last tile; then C's rows (y_diag blocks) or the three split x tiles
// (states blocks).
template <int P>
__host__ __device__ int tc_ring_offset(int q) {
  return TcShape<P>::G * q * 16;
}

template <int P>
__host__ __device__ int tc_union_offset(int q, int np) {
  const int ring = (2 * kKeys * (np + 8) + 2 * kKeys * TcShape<P>::LDX) * 2;
  const int staging = kRowsY * TcShape<P>::LDO * 4;
  return tc_ring_offset<P>(q) + (ring > staging ? ring : staging);
}

template <int P>
__host__ __device__ int tc_smem_bytes(int q, int np) {
  const int c = kRowsY * (np + 8) * 2, xs = 3 * kKeys * TcShape<P>::LDX * 2;
  return tc_union_offset<P>(q, np) + (c > xs ? c : xs);
}

struct TcDims {
  int nc, q, h, n, np;  // chunks, chunk, heads, state, state padded to 16
  int ngroups, slices, ytiles;
};

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: four (x4) or two (x2) 8x8 bf16 matrices, lane l giving the
// address of row l % 8 of matrix l / 8; plain, register i of lane (g, t)
// holds row g, columns 2t, 2t+1 of matrix i; .trans, rows 2t, 2t+1 of
// column g.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr double kLog2e = 1.4426950408889634;

// 2^x by the special-function unit (ex2.approx): about 2 ulp. Its
// argument is (cs_i - cs_j) log2(e), formed in f64, so L = 2^x keeps that
// relative accuracy however large |cs| grows.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// v = hi + mid + lo to about 24 bits, each part a bf16
__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// Rows [r0, r0 + rows) of a (q, n) bf16 slab into shared memory rows of
// np + 8 halves, zeros past q and past n. 16-byte copies where the rows
// allow them (n a multiple of 8), else element loads.
template <int NT = kTcThreads>  // threads that share the copies
__device__ __forceinline__ void load_bc(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int r0,
                                        int rows, int q, int n, int np,
                                        int tid) {
  const int ld = np + 8;
  if (n % 8 == 0) {
    for (int e = tid; e < rows * (np / 8); e += NT) {
      const int r = e / (np / 8), col = (e % (np / 8)) * 8;
      const bool ok = r0 + r < q && col < n;
      cp_async16(dst + r * ld + col,
                 ok ? src + (long long)(r0 + r) * n + col : src, ok);
    }
  } else {
    for (int e = tid; e < rows * np; e += NT) {
      const int r = e / np, col = e % np;
      dst[r * ld + col] = r0 + r < q && col < n
                              ? src[(long long)(r0 + r) * n + col]
                              : __float2bfloat16_rn(0.f);
    }
  }
}

// y_diag rows [i0, i0 + 64) (blocks of the first kind) or states rows
// [n0, n0 + 64) (second kind) of G heads' W columns, for one (b, c).
template <int P>
__global__ void __launch_bounds__(kTcThreads, 3)
    ssd_chunk_tc(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B,
                 const __nv_bfloat16* __restrict__ C,
                 float* __restrict__ y_diag, float* __restrict__ states,
                 float* __restrict__ decay_in, TcDims d) {
  using S = TcShape<P>;
  constexpr int G = S::G, W = S::W, GW = S::GW, NT = S::NT, LDX = S::LDX;
  const int q = d.q, h = d.h, n = d.n, np = d.np, LDN = np + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  double* cs = reinterpret_cast<double*>(smem);           // [G][q]
  float* dts = reinterpret_cast<float*>(cs + G * q);      // [G][q]
  float* wts = dts + G * q;  // [G][q] dt exp(cs_last - cs), states blocks
  unsigned char* ring = smem + tc_ring_offset<P>(q);
  // B rows [2][kKeys][LDN], raw x [2][kKeys][LDX]
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(ring);
  __nv_bfloat16* Xr = Bs + 2 * kKeys * LDN;
  float* Os = reinterpret_cast<float*>(ring);  // [64][LDO] after the loop
  unsigned char* uni = smem + tc_union_offset<P>(q, np);
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(uni);  // [64][LDN]
  // states blocks: x dt exp(cs_last - cs) as hi, mid and lo bf16 parts,
  // [3][kKeys][LDX], where y_diag blocks keep C's rows
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(uni);

  int rest = blockIdx.x;
  const int sl = rest % d.slices;
  rest /= d.slices;
  const int grp = rest % d.ngroups;
  rest /= d.ngroups;
  const int c = rest % d.nc, bi = rest / d.nc;
  const int h0 = grp * G, w0 = sl * W;
  const bool is_y = (int)blockIdx.y < d.ytiles;  // heaviest tiles first
  const int i0 = is_y ? (d.ytiles - 1 - blockIdx.y) * kRowsY : 0;
  const int n0 = is_y ? 0 : (blockIdx.y - d.ytiles) * kRowsS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4, mi = lane / 8;
  const long long row0 = (long long)bi * d.nc * q + (long long)c * q;

  // tiles of keys: up to the block's last row for y_diag, all for states
  const int nk = is_y ? (min(q, i0 + kRowsY) - 1) / kKeys + 1
                      : (q + kKeys - 1) / kKeys;
  auto load_tile = [&](int kt, int s) {
    const int j0 = kt * kKeys;
    load_bc(Bs + s * kKeys * LDN, B + row0 * n, j0, kKeys, q, n, np, tid);
    __nv_bfloat16* xr = Xr + s * kKeys * LDX;
    for (int e = tid; e < kKeys * (GW / 8); e += kTcThreads) {
      const int r = e / (GW / 8), col = (e % (GW / 8)) * 8, g = col / W;
      const bool ok = j0 + r < q && h0 + g < h;
      cp_async16(xr + r * LDX + col,
                 ok ? x + ((row0 + j0 + r) * h + h0 + g) * P + w0 + col % W
                    : x,
                 ok);
    }
  };
  if (is_y) load_bc(Cs, C + row0 * n, i0, kRowsY, q, n, np, tid);
  load_tile(0, 0);
  cp_async_commit();

  // ---- cs = cumsum(dt * A) over the chunk, in f64: dt of all rows at
  // once, then one warp per head scans it
  for (int e = tid; e < q * G; e += kTcThreads) {
    const int i = e / G, g = e % G;
    dts[g * q + i] = h0 + g < h ? dt[(row0 + i) * h + h0 + g] : 0.f;
  }
  __syncthreads();
  for (int g = warp; g < G; g += kTcThreads / 32) {
    const double a = h0 + g < h ? A[h0 + g] : 0.f;
    const int per = (q + 31) / 32;
    const int i0s = min(q, lane * per), i1s = min(q, i0s + per);
    double run = 0.0;
    for (int i = i0s; i < i1s; ++i) {
      run += (double)dts[g * q + i] * a;
      cs[g * q + i] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const double up = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += up;
    }
    const double excl = incl - run;
    for (int i = i0s; i < i1s; ++i) cs[g * q + i] += excl;
  }
  __syncthreads();
  if (!is_y) {
    for (int e = tid; e < q * G; e += kTcThreads) {
      const int g = e / q;
      wts[e] = dts[e] * fast_exp2((float)((cs[g * q + q - 1] - cs[e]) *
                                          kLog2e));
    }
  }
  if (is_y && i0 == 0 && sl == 0) {
    for (int e = tid; e < q * G; e += kTcThreads) {
      const int i = e / G, g = e % G;
      if (h0 + g < h)
        decay_in[(row0 + i) * h + h0 + g] = expf((float)cs[g * q + i]);
    }
  }

  float acc[G][NT][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[g][nt][0] = acc[g][nt][1] = acc[g][nt][2] = acc[g][nt][3] = 0.f;

  // rows of this warp: y_diag rows i (ra, rb) or state rows
  const int ra = (is_y ? i0 : n0) + 16 * warp + g8, rb = ra + 8;
  const bool warp_on = is_y ? true : n0 + 16 * warp < np;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1, j0 = kt * kKeys;
    if (kt + 1 < nk) {
      load_tile(kt + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xr = Xr + s * kKeys * LDX;
    const __nv_bfloat16* bt = Bs + s * kKeys * LDN;
    if (is_y) {
      // this warp's rows i end before the tile: nothing to add
      if (j0 <= i0 + 16 * warp + 15) {
        // S = C B^T, 16 rows x 32 keys, exact products in f32
        float sc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        const __nv_bfloat16* crow =
            Cs + (16 * warp + (mi & 1) * 8 + lane % 8) * LDN + (mi >> 1) * 8;
        const __nv_bfloat16* brow =
            bt + ((mi >> 1) * 8 + lane % 8) * LDN + (mi & 1) * 8;
        for (int kk = 0; kk < np / 16; ++kk) {
          uint32_t cf[4];
          ldsm_x4(cf, crow + kk * 16);
#pragma unroll
          for (int nt = 0; nt < 4; nt += 2) {
            uint32_t bf[4];
            ldsm_x4(bf, brow + nt * 8 * LDN + kk * 16);
            mma16816(sc[nt], cf, bf[0], bf[1]);
            mma16816(sc[nt + 1], cf, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const double* csg = cs + g * q;
          const float* dtg = dts + g * q;
          const double ca = ra < q ? csg[ra] : 0.0;
          const double cb = rb < q ? csg[rb] : 0.0;
          // P' = (S o L) dt_j, exp only where j <= i < q: dt goes with P,
          // so x stays exact in bf16
          float pv[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ra : rb;
              const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
              pv[nt][e] = j <= i && i < q
                              ? sc[nt][e] * dtg[j] *
                                    fast_exp2((float)(((e < 2 ? ca : cb) -
                                                       csg[j]) * kLog2e))
                              : 0.f;
            }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            // A fragments of P's 16-key slice ks in three parts
            uint32_t pa[3][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float* v = pv[2 * ks + (e >> 1)] + 2 * (e & 1);
              __nv_bfloat16 hv[2], mv[2], lv[2];
              split3(v[0], hv[0], mv[0], lv[0]);
              split3(v[1], hv[1], mv[1], lv[1]);
              pa[0][e] = pack2(hv[0], hv[1]);
              pa[1][e] = pack2(mv[0], mv[1]);
              pa[2][e] = pack2(lv[0], lv[1]);
            }
            const __nv_bfloat16* xrow = xr + ks * 16 * LDX + g * W;
#pragma unroll
            for (int nt = 0; nt < NT; nt += (NT > 1 ? 2 : 1)) {
              uint32_t xf[4];
              if constexpr (NT > 1) {
                ldsm_x4_t(xf, xrow + ((mi & 1) * 8 + lane % 8) * LDX +
                                  nt * 8 + (mi >> 1) * 8);
              } else {
                ldsm_x2_t(xf, xrow + (lane % 16) * LDX);
              }
#pragma unroll
              for (int u = 0; u < (NT > 1 ? 2 : 1); ++u)
#pragma unroll
                for (int z = 2; z >= 0; --z)  // lo, mid, hi
                  mma16816(acc[g][nt + u], pa[z], xf[2 * u], xf[2 * u + 1]);
            }
          }
        }
      }
    } else {
      // x dt exp(cs_last - cs_j) split into three bf16 parts
      for (int e = tid; e < kKeys * GW / 2; e += kTcThreads) {
        const int r = e / (GW / 2), col = (e % (GW / 2)) * 2, g = col / W;
        const int j = j0 + r;
        const float f = j < q ? wts[g * q + j] : 0.f;
        const __nv_bfloat162 raw =
            *reinterpret_cast<const __nv_bfloat162*>(xr + r * LDX + col);
        __nv_bfloat16 h0v, m0v, l0v, h1v, m1v, l1v;
        split3(__bfloat162float(raw.x) * f, h0v, m0v, l0v);
        split3(__bfloat162float(raw.y) * f, h1v, m1v, l1v);
        const int at = r * LDX + col;
        *reinterpret_cast<uint32_t*>(Xs + at) = pack2(h0v, h1v);
        *reinterpret_cast<uint32_t*>(Xs + kKeys * LDX + at) = pack2(m0v, m1v);
        *reinterpret_cast<uint32_t*>(Xs + 2 * kKeys * LDX + at) =
            pack2(l0v, l1v);
      }
      __syncthreads();
      // states += B^T (x dt w): B^T's A fragments from B rows by .trans;
      // B is exact, so three products (B lo, B mid, B hi)
      if (warp_on) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, bt + (ks * 16 + (mi >> 1) * 8 + lane % 8) * LDN +
                             n0 + 16 * warp + (mi & 1) * 8);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int nt = 0; nt < NT; nt += (NT > 1 ? 2 : 1))
#pragma unroll
              for (int z = 2; z >= 0; --z) {
                const __nv_bfloat16* xrow =
                    Xs + z * kKeys * LDX + ks * 16 * LDX + g * W + nt * 8;
                uint32_t xf[4];
                if constexpr (NT > 1) {
                  ldsm_x4_t(xf, xrow + ((mi & 1) * 8 + lane % 8) * LDX +
                                    (mi >> 1) * 8);
                } else {
                  ldsm_x2_t(xf, xrow + (lane % 16) * LDX);
                }
#pragma unroll
                for (int u = 0; u < (NT > 1 ? 2 : 1); ++u)
                  mma16816(acc[g][nt + u], bfr, xf[2 * u], xf[2 * u + 1]);
              }
        }
      }
    }
    __syncthreads();  // stage s and Xs are refilled next
  }

  // accumulators -> staging rows -> coalesced rows of W floats a head
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = 16 * warp + g8 + (e ? 8 : 0);
        *reinterpret_cast<float2*>(Os + r * S::LDO + g * W + nt * 8 +
                                   2 * t4) =
            make_float2(acc[g][nt][e], acc[g][nt][e + 1]);
      }
  __syncthreads();
  for (int e = tid; e < kRowsY * GW / 4; e += kTcThreads) {
    const int r = e / (GW / 4), col = (e % (GW / 4)) * 4, g = col / W;
    if (h0 + g >= h) continue;
    const float4 v = *reinterpret_cast<const float4*>(Os + r * S::LDO + col);
    if (is_y) {
      const int i = i0 + r;
      if (i < q)
        *reinterpret_cast<float4*>(
            y_diag + ((row0 + i) * h + h0 + g) * P + w0 + col % W) = v;
    } else {
      const int nn = n0 + r;
      if (nn < n)
        *reinterpret_cast<float4*>(
            states + ((((long long)bi * d.nc + c) * h + h0 + g) * n + nn) * P +
            w0 + col % W) = v;
    }
  }
}

template <int P>
int launch_tc(const void* x, const float* dt, const float* A, const void* B,
              const void* C, float* y_diag, float* states, float* decay_in,
              int b, int nc, int q, int h, int n, cudaStream_t st) {
  using S = TcShape<P>;
  const int np = (n + 15) / 16 * 16;
  TcDims d{nc, q, h, n, np, (h + S::G - 1) / S::G, P / S::W,
           (q + kRowsY - 1) / kRowsY};
  const long long blocks = (long long)b * nc * d.ngroups * d.slices;
  const int smem = tc_smem_bytes<P>(q, np);
  if (blocks > 0x7fffffffLL || smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_tc<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)blocks, d.ytiles + (np + kRowsS - 1) / kRowsS);
  ssd_chunk_tc<P><<<grid, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), y_diag, states, decay_in, d);
  return (int)cudaGetLastError();
}

template <int P>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, float* y, float* s, float* di, int b, int nc,
           int q, int h, int n, int dtype, cudaStream_t st) {
  return dtype == 0
             ? launch_simt<P>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st)
             : launch_tc<P>(x, dt, A, B, C, y, s, di, b, nc, q, h, n, st);
}

// ================================================================ backward
//
// ssd_chunk_bwd: the vector-Jacobian product of the three outputs above
// (kernels/ssd_scan/ref.py ssd_chunk_terms), per (b, c) and head, with
// u_j = x_j dt_j, S = C B^T, L_ij = exp(cs_i - cs_j) (j <= i), M = S o L,
// w_j = exp(cs_last - cs_j) and the cotangents dY (of y_diag), dSt (of the
// (n x p) states) and dD (of decay_in):
//   dM      = dY u^T (j <= i)            dl = dM o M   (d of cs_i - cs_j)
//   du_j    = sum_i M_ij dY_i + w_j V_j,  V_j = dSt^T B_j (a p-vector)
//   dw_j    = u_j . V_j
//   dC_i    = sum_h sum_j (dM o L)_ij B_j
//   dB_j    = sum_h sum_i (dM o L)_ij C_i + sum_h w_j dSt u_j
//   dcs_i   = rowsum(dl)_i - colsum(dl)_i + dD_i exp(cs_i) - dw_i w_i
//             (+ sum_j dw_j w_j at i = q-1)
//   dA_k    = sum_{i >= k} dcs_i            (the reverse cumsum, f64)
//   ddt_k   = dA_k A + du_k . x_k,  dx_k = du_k dt_k,  dA(h) += dA_k dt_k
// Nothing large is kept from the forward: cs (f64, as the forward takes
// it), S, L and u are recomputed. B and C are shared by every head (one
// group), so dB and dC sum over heads, and dA over (b, c, q): every sum has
// one owner that adds in a fixed order (a block looping over heads, or
// per-(b, c) partials summed by a second kernel), with no float atomics, so
// two calls give bit-equal gradients.
//
// Bound at Mamba-2 780M's training shape (8, 2048, 48, 64, 128), chunk 256,
// bf16: the bytes (x, B, C, dx, dB, dC in bf16; dt, dY, dSt, dD, ddt in
// f32) are 0.53 GB, 0.16 ms at 3.35 TB/s; the products of the causal half
// (S, dM, the M^T dY, V, dSt u, dC, dB) are 53 GFLOP, 0.054 ms at the bf16
// tensor-core rate: the bound is the bytes'.
//
// The kernels run on one stream in namespace ssd_bwd (which names them in
// a trace). bf16 inputs (the training path) take the tensor-core kernel
// bwd_tc (below, with its design): dM is formed once per (b, c, head, tile
// i, tile j), every product runs on mma.sync with bf16 parts, and the
// states' terms sit in the pass that owns rows j; around it bwd_cs,
// bwd_rows_sum (rowsum's partials), bwd_dC_sum (dC's), bwd_dt and bwd_dA.
// Head dims 128 and 256, and chunks too long for bwd_tc's shared memory,
// take the SIMT kernels in bf16 too.
//
// f32 inputs (the f32 model checks) keep nine SIMT f32 kernels (as the
// forward keeps its SIMT f32 path). Their sums over heads are cut into
// groups of kHeadGroup heads, a block each, whose partials a second kernel
// adds in group order:
//   1. bwd_cs     cs per (b, c, head), f64, into the workspace;
//   2. bwd_S      S = C B^T per (b, c), 32 x 32 tiles, j <= i;
//   3. bwd_rows   per (b, c, 32 rows i, head group), heads in order: dM,
//                 rowsum(dl) per head, and the group's sum of dM o L (in
//                 shared memory, each element by one thread) into the
//                 workspace;
//   4. bwd_dC     per (b, c, 32 rows i): the groups' sums added in order
//                 (sum_h dM o L, kept for 6.) and dC of its rows;
//   5. bwd_cols   per (b, c, head, 32 rows j): du (the M^T dY and the
//                 states terms), colsum(dl), dw, dx and du . x;
//   6. bwd_dBh    per (b, c, 32 rows j, head group): the group's sum of
//                 w_j dSt u_j, heads in order, into the workspace;
//   7. bwd_dB     per (b, c, 32 rows j): (sum_h dM o L)^T C, then the
//                 groups' sums of 6. in order;
//   8. bwd_dt     per (b, c, 8 heads), a warp per head: dcs, its reverse
//                 cumsum in f64, ddt, and the (b, c) partial of dA;
//   9. bwd_dA     per head, the partials summed over (b, c) in order.
// These do the products on the CUDA cores, and dM twice (kernels 3, 5).

namespace ssd_bwd {

constexpr int kT = 32;        // rows of a tile (i or j)
constexpr int kThreadsB = 256;
constexpr int kHeadGroup = 8;  // heads a block of the head sums adds

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The sum over the 16 lanes of a half warp (lanes 16k .. 16k+15); every
// lane gets the same bits (each step adds the same two values).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o /= 2) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

struct BDims {
  int bc, q, h, n;  // b * chunks, chunk length, heads, state size
};

// The workspace, in bytes from its start: cs (f64, (bc, h, q)), the
// partials of rowsum(dl) (f32, (T, 4, bc, h, q): row tile, row group, T =
// ceil(q / kJT); the SIMT kernels write part 0 only), colsum(dl), dw (f32, (bc, h, q)),
// du . x (f32, (bc, q, h)), dA's partials (f64, (bc, h)); then one region
// that the two paths use differently: the SIMT kernels' S and sum_h dM o L
// (f32, (bc, q, q)) and the head groups' partial sums of dM o L (f32,
// (groups, bc, q, q)) and of the states' dB term (f32, (groups, bc, q,
// n)); the tensor-core kernel's row-tile partials of dC (f32, (T, bc, q,
// n)). The size does not depend on the dtype, so it is the larger of the
// two.
struct Work {
  double* cs;
  float *S, *dS, *rows, *cols, *dw, *ddtu;
  double* dAp;
  float *dSp, *dBp, *dCp;
};

constexpr int kJT = 64;  // rows j a block of the tensor-core kernel owns

__host__ __device__ inline int head_groups(int h) {
  return (h + kHeadGroup - 1) / kHeadGroup;
}

__host__ __device__ inline long long align256(long long x) {
  return (x + 255) / 256 * 256;
}

inline long long work_layout(const BDims& d, char* base, Work* w) {
  const long long bhq = (long long)d.bc * d.h * d.q;
  const long long qq = (long long)d.bc * d.q * d.q;
  const long long g = head_groups(d.h);
  const long long T = (d.q + kJT - 1) / kJT;
  const long long sizes[10] = {8 * bhq,     16 * T * bhq, 4 * bhq,
                               4 * bhq,     4 * bhq,     8LL * d.bc * d.h,
                               4 * qq,      4 * qq,      4 * g * qq,
                               4 * g * d.bc * d.q * d.n};
  long long off[10], total = 0;
  for (int k = 0; k < 10; ++k) {
    off[k] = total;
    total += align256(sizes[k]);
  }
  const long long tc = off[6] + align256(4 * T * d.bc * d.q * d.n);
  if (w != nullptr) {
    w->cs = reinterpret_cast<double*>(base + off[0]);
    w->rows = reinterpret_cast<float*>(base + off[1]);
    w->cols = reinterpret_cast<float*>(base + off[2]);
    w->dw = reinterpret_cast<float*>(base + off[3]);
    w->ddtu = reinterpret_cast<float*>(base + off[4]);
    w->dAp = reinterpret_cast<double*>(base + off[5]);
    w->S = reinterpret_cast<float*>(base + off[6]);
    w->dS = reinterpret_cast<float*>(base + off[7]);
    w->dSp = reinterpret_cast<float*>(base + off[8]);
    w->dBp = reinterpret_cast<float*>(base + off[9]);
    w->dCp = reinterpret_cast<float*>(base + off[6]);
  }
  return total > tc ? total : tc;
}

// 1. cs = cumsum(dt * A) per (b, c, head), in f64, as the forward takes it:
// a warp per head, consecutive rows a lane, then a shuffle scan.
__global__ void __launch_bounds__(kThreadsB)
    bwd_cs(const float* __restrict__ dt, const float* __restrict__ A,
           double* __restrict__ cs, BDims d) {
  const int bc = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hh = blockIdx.y * (kThreadsB / 32) + warp;
  if (hh >= d.h) return;  // whole warps
  const int q = d.q;
  const long long row0 = (long long)bc * q;
  const double a = A[hh];
  const int per = (q + 31) / 32;
  const int i0 = min(q, lane * per), i1 = min(q, i0 + per);
  double* out = cs + ((long long)bc * d.h + hh) * q;
  double run = 0.0;
  for (int i = i0; i < i1; ++i) {
    run += (double)dt[(row0 + i) * d.h + hh] * a;
    out[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const double up = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += up;
  }
  const double excl = incl - run;
  for (int i = i0; i < i1; ++i) out[i] += excl;
}

// 2. S = C B^T per (b, c): a 32 x 32 tile a block, tiles with j <= i only.
template <typename T>
__global__ void __launch_bounds__(kThreadsB)
    bwd_S(const T* __restrict__ B, const T* __restrict__ C,
          float* __restrict__ S, BDims d) {
  const int it = blockIdx.x, jt = blockIdx.y, bc = blockIdx.z;
  if (jt > it) return;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int n = d.n, q = d.q, LDN = n + 1;
  float* Cs = reinterpret_cast<float*>(smem_b);  // [kT][n + 1]
  float* Bs = Cs + kT * LDN;                      // [kT][n + 1]
  const long long row0 = (long long)bc * q;
  const int i0 = it * kT, j0 = jt * kT, tid = threadIdx.x;
  for (int e = tid; e < kT * n; e += kThreadsB) {
    const int r = e / n, k = e % n;
    Cs[r * LDN + k] = i0 + r < q ? ld(C, (row0 + i0 + r) * n + k) : 0.f;
    Bs[r * LDN + k] = j0 + r < q ? ld(B, (row0 + j0 + r) * n + k) : 0.f;
  }
  __syncthreads();
  const int ra = tid / 16, ja = tid % 16;
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
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = i0 + ra + 16 * u, j = j0 + ja + 16 * v;
      if (i < q && j < q) S[(row0 + i) * q + j] = sv[u][v];
    }
}

// Rows of the head-dim tiles: P + 4 floats, so that every row starts on
// 16 bytes (tile_dm reads 4 head-dim values at once) and the 8 rows of a
// quarter warp's 16-byte loads fall in distinct banks.
template <int P>
__host__ __device__ constexpr int ldp() {
  return P + 4;
}

// The float offset, past q doubles of cs, where a block's float tiles
// start: 16-byte aligned whatever q.
__host__ __device__ inline int tiles_at(int q) { return (8 * q + 15) / 16 * 4; }

// Loads a 32-row tile of u = x dt (head hh, rows r0..) into Us[kT][ldp].
template <typename T, int P>
__device__ __forceinline__ void load_u(float* Us, const T* __restrict__ x,
                                       const float* __restrict__ dt,
                                       long long row0, int r0, int hh,
                                       const BDims& d) {
  for (int e = threadIdx.x; e < kT * P; e += kThreadsB) {
    const int r = e / P, pp = e % P, j = r0 + r;
    Us[r * ldp<P>() + pp] =
        j < d.q ? ld(x, ((row0 + j) * d.h + hh) * P + pp) *
                      dt[(row0 + j) * d.h + hh]
                : 0.f;
  }
}

// Loads a 32-row tile of dY (head hh, rows r0..) into Ys[kT][ldp].
template <int P>
__device__ __forceinline__ void load_dy(float* Ys, const float* __restrict__ dy,
                                        long long row0, int r0, int hh,
                                        const BDims& d) {
  for (int e = threadIdx.x; e < kT * P; e += kThreadsB) {
    const int r = e / P, pp = e % P, i = r0 + r;
    Ys[r * ldp<P>() + pp] =
        i < d.q ? dy[((row0 + i) * d.h + hh) * P + pp] : 0.f;
  }
}

// dM for the thread's 2 x 2 elements (rows ra, ra + 16 of Ys; rows ja,
// ja + 16 of Us): dY_i . u_j over the head dim, 4 values a load, summed in
// head-dim order.
template <int P>
__device__ __forceinline__ void tile_dm(const float* Ys, const float* Us,
                                        int ra, int ja, float (&m)[2][2]) {
  const float* y0 = Ys + ra * ldp<P>();
  const float* y1 = Ys + (ra + 16) * ldp<P>();
  const float* u0 = Us + ja * ldp<P>();
  const float* u1 = Us + (ja + 16) * ldp<P>();
  float m00 = 0.f, m01 = 0.f, m10 = 0.f, m11 = 0.f;
#pragma unroll 4
  for (int pp = 0; pp < P; pp += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(y0 + pp);
    const float4 a1 = *reinterpret_cast<const float4*>(y1 + pp);
    const float4 b0 = *reinterpret_cast<const float4*>(u0 + pp);
    const float4 b1 = *reinterpret_cast<const float4*>(u1 + pp);
    const float av0[4] = {a0.x, a0.y, a0.z, a0.w};
    const float av1[4] = {a1.x, a1.y, a1.z, a1.w};
    const float bv0[4] = {b0.x, b0.y, b0.z, b0.w};
    const float bv1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m00 = fmaf(av0[k], bv0[k], m00);
      m01 = fmaf(av0[k], bv1[k], m01);
      m10 = fmaf(av1[k], bv0[k], m10);
      m11 = fmaf(av1[k], bv1[k], m11);
    }
  }
  m[0][0] = m00;
  m[0][1] = m01;
  m[1][0] = m10;
  m[1][1] = m11;
}

template <int P>
__host__ __device__ inline int rows_smem(int q) {
  const int ldq = (q + 31) / 32 * 32 + 16;
  return 4 * (tiles_at(q) + 2 * kT * ldp<P>() + kT * ldq);
}

// 3. Per (b, c, 32 rows i, head group), the group's heads in order: per
// head dM against every key tile j <= i, rowsum(dl) of the head into the
// workspace, and the group's sum of dM o L accumulated in shared memory
// (each element by one thread, heads in order), then into the workspace.
template <typename T, int P>
__global__ void __launch_bounds__(kThreadsB)
    bwd_rows(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ dy, const double* __restrict__ cs,
             const float* __restrict__ S, float* __restrict__ rows,
             float* __restrict__ dSp, BDims d) {
  constexpr int LDP = ldp<P>();
  const int it = blockIdx.x, bc = blockIdx.y, q = d.q, h = d.h;
  const int h_lo = blockIdx.z * kHeadGroup;
  const int h_hi = min(h, h_lo + kHeadGroup);
  const int LDQ = (q + 31) / 32 * 32 + 16;  // rows 16 banks apart
  extern __shared__ __align__(16) unsigned char smem_b[];
  double* csh = reinterpret_cast<double*>(smem_b);           // [q]
  float* Ys = reinterpret_cast<float*>(smem_b) + tiles_at(q);  // [kT][LDP]
  float* Us = Ys + kT * LDP;                                   // [kT][LDP]
  float* acc = Us + kT * LDP;                                  // [kT][LDQ]
  const int tid = threadIdx.x, ra = tid / 16, ja = tid % 16;
  const int i0 = it * kT;
  const long long row0 = (long long)bc * q;
  const int jend = min(q, i0 + kT);  // keys j < jend
  for (int e = tid; e < kT * LDQ; e += kThreadsB) acc[e] = 0.f;
  for (int hh = h_lo; hh < h_hi; ++hh) {
    __syncthreads();  // the last head's tiles are consumed
    const double* csg = cs + ((long long)bc * h + hh) * q;
    for (int e = tid; e < q; e += kThreadsB) csh[e] = csg[e];
    load_dy<P>(Ys, dy, row0, i0, hh, d);
    float rp[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < jend; j0 += kT) {
      __syncthreads();  // Us consumed; csh and Ys written
      load_u<T, P>(Us, x, dt, row0, j0, hh, d);
      __syncthreads();
      float m[2][2];
      tile_dm<P>(Ys, Us, ra, ja, m);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = ra + 16 * u, i = i0 + r, j = j0 + ja + 16 * v;
          if (j <= i && i < q) {
            const float L = expf((float)(csh[i] - csh[j]));
            const float dml = m[u][v] * L;
            rp[u] = fmaf(dml, S[(row0 + i) * q + j], rp[u]);
            acc[r * LDQ + j] += dml;
          }
        }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float v = half_warp_sum(rp[u]);
      const int i = i0 + ra + 16 * u;
      if (ja == 0 && i < q) rows[((long long)bc * h + hh) * q + i] = v;
    }
  }
  __syncthreads();
  float* out = dSp + (long long)blockIdx.z * d.bc * q * q;
  for (int e = tid; e < kT * jend; e += kThreadsB) {
    const int r = e / jend, j = e % jend;
    if (i0 + r < q) out[(row0 + i0 + r) * q + j] = acc[r * LDQ + j];
  }
}

__host__ __device__ inline int dC_smem(int n) {
  return 4 * (kT * (kT + 1) + kT * (n + 1));
}

// 4. Per (b, c, 32 rows i): sum_h dM o L, the head groups' partial sums
// added in group order, into the workspace (for 7.), and dC of the rows.
template <typename T>
__global__ void __launch_bounds__(kThreadsB)
    bwd_dC(const T* __restrict__ B, const float* __restrict__ dSp,
           float* __restrict__ dS, T* __restrict__ dC, BDims d) {
  constexpr int LDT = kT + 1, NM = kMaxState / 16;
  const int it = blockIdx.x, bc = blockIdx.y, q = d.q, n = d.n;
  const int groups = head_groups(d.h), LDN = n + 1;
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* Ts = reinterpret_cast<float*>(smem_b);  // [kT][LDT]  rows i
  float* Bs = Ts + kT * LDT;                      // [kT][LDN]
  const int tid = threadIdx.x, ra = tid / 16, ja = tid % 16;
  const int i0 = it * kT;
  const long long row0 = (long long)bc * q;
  const long long part = (long long)d.bc * q * q;
  const int jend = min(q, i0 + kT);
  float ca[2][NM];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) ca[u][mm] = 0.f;
  for (int j0 = 0; j0 < jend; j0 += kT) {
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kThreadsB) {
      const int r = e / kT, jj = e % kT, i = i0 + r, j = j0 + jj;
      float v = 0.f;
      if (i < q && j < jend) {
        const long long o = (row0 + i) * q + j;
        for (int g = 0; g < groups; ++g) v += dSp[g * part + o];
        dS[o] = v;
      }
      Ts[r * LDT + jj] = v;
    }
    for (int e = tid; e < kT * n; e += kThreadsB) {
      const int r = e / n, k = e % n;
      Bs[r * LDN + k] = j0 + r < q ? ld(B, (row0 + j0 + r) * n + k) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kT; ++jj) {
      const float a0 = Ts[ra * LDT + jj], a1 = Ts[(ra + 16) * LDT + jj];
#pragma unroll
      for (int mm = 0; mm < NM; ++mm) {
        const int k = ja + 16 * mm;
        if (k < n) {
          const float bv = Bs[jj * LDN + k];
          ca[0][mm] = fmaf(a0, bv, ca[0][mm]);
          ca[1][mm] = fmaf(a1, bv, ca[1][mm]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + ra + 16 * u;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) {
      const int k = ja + 16 * mm;
      if (i < q && k < n) st(dC, (row0 + i) * n + k, ca[u][mm]);
    }
  }
}

template <int P>
__host__ __device__ inline int cols_smem(int q) {
  return 4 * (tiles_at(q) + 3 * kT * ldp<P>() + 2 * kT * (kT + 1) + 16 * kT);
}

// 5. Per (b, c, head, 32 rows j): du_j = sum_{i >= j} M_ij dY_i over the
// row tiles i, colsum(dl)_j, then V_j = dSt^T B_j (state in tiles of 32),
// du_j += w_j V_j, dw_j = u_j . V_j, dx_j = du_j dt_j and du_j . x_j.
template <typename T, int P>
__global__ void __launch_bounds__(kThreadsB)
    bwd_cols(const T* __restrict__ x, const float* __restrict__ dt,
             const T* __restrict__ B, const float* __restrict__ dy,
             const float* __restrict__ dst, const double* __restrict__ cs,
             const float* __restrict__ S, T* __restrict__ dx,
             float* __restrict__ cols, float* __restrict__ dw,
             float* __restrict__ ddtu, BDims d) {
  constexpr int LDP = ldp<P>(), LDT = kT + 1;
  constexpr int MP = P < 16 ? 1 : P / 16;  // head-dim columns a thread
  const int jt = blockIdx.x, hh = blockIdx.y, bc = blockIdx.z;
  const int q = d.q, h = d.h, n = d.n;
  extern __shared__ __align__(16) unsigned char smem_b[];
  double* csh = reinterpret_cast<double*>(smem_b);           // [q]
  float* Us = reinterpret_cast<float*>(smem_b) + tiles_at(q);  // [kT][LDP]
  float* Ys = Us + kT * LDP;                                   // [kT][LDP]
  float* Ds = Ys + kT * LDP;                          // [kT][LDP]  dSt rows
  float* Ms = Ds + kT * LDP;                          // [kT][LDT]  M^T
  float* Bs = Ms + kT * LDT;                          // [kT][LDT]  B_j cols
  float* red = Bs + kT * LDT;                         // [16][kT]
  const int tid = threadIdx.x, ra = tid / 16, ja = tid % 16;
  const int j0 = jt * kT;
  const long long row0 = (long long)bc * q;
  const long long hq = ((long long)bc * h + hh) * q;
  for (int e = tid; e < q; e += kThreadsB) csh[e] = cs[hq + e];
  load_u<T, P>(Us, x, dt, row0, j0, hh, d);
  float acc[2][MP], cp[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < MP; ++m) acc[a][m] = 0.f;
  for (int i0 = j0; i0 < q; i0 += kT) {
    __syncthreads();  // Ys and Ms consumed (csh and Us written)
    load_dy<P>(Ys, dy, row0, i0, hh, d);
    __syncthreads();
    float m[2][2];
    tile_dm<P>(Ys, Us, ra, ja, m);  // rows i (ra), columns j (ja)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = i0 + ra + 16 * u, j = j0 + ja + 16 * v;
        float M = 0.f;
        if (j <= i && i < q) {
          M = S[(row0 + i) * q + j] * expf((float)(csh[i] - csh[j]));
          cp[v] = fmaf(m[u][v], M, cp[v]);
        }
        Ms[(ja + 16 * v) * LDT + ra + 16 * u] = M;
      }
    __syncthreads();
    for (int ii = 0; ii < kT; ++ii) {
      const float m0 = Ms[ra * LDT + ii], m1 = Ms[(ra + 16) * LDT + ii];
#pragma unroll
      for (int mm = 0; mm < MP; ++mm) {
        const float yv =
            (P >= 16 || ja < P) ? Ys[ii * LDP + ja + 16 * mm] : 0.f;
        acc[0][mm] = fmaf(m0, yv, acc[0][mm]);
        acc[1][mm] = fmaf(m1, yv, acc[1][mm]);
      }
    }
  }
  // colsum(dl): the 16 row groups' partials of each column, in order
  red[ra * kT + ja] = cp[0];
  red[ra * kT + ja + 16] = cp[1];
  __syncthreads();
  if (tid < kT && j0 + tid < q) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[r * kT + tid];
    cols[hq + j0 + tid] = s;
  }
  // V_j = dSt^T B_j: (j rows ra, ra + 16) x (head dim ja + 16 m)
  float vv[2][MP];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < MP; ++m) vv[a][m] = 0.f;
  const float* dsth = dst + ((long long)bc * h + hh) * n * P;
  for (int k0 = 0; k0 < n; k0 += kT) {
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kThreadsB) {
      const int r = e / kT, kk = e % kT, j = j0 + r;
      Bs[r * LDT + kk] =
          j < q && k0 + kk < n ? ld(B, (row0 + j) * n + k0 + kk) : 0.f;
    }
    for (int e = tid; e < kT * P; e += kThreadsB) {
      const int kk = e / P, pp = e % P;
      Ds[kk * LDP + pp] =
          k0 + kk < n ? dsth[(long long)(k0 + kk) * P + pp] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kT; ++kk) {
      const float b0 = Bs[ra * LDT + kk], b1 = Bs[(ra + 16) * LDT + kk];
#pragma unroll
      for (int mm = 0; mm < MP; ++mm) {
        const float dv =
            (P >= 16 || ja < P) ? Ds[kk * LDP + ja + 16 * mm] : 0.f;
        vv[0][mm] = fmaf(b0, dv, vv[0][mm]);
        vv[1][mm] = fmaf(b1, dv, vv[1][mm]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int j = j0 + ra + 16 * a;
    const bool jv = j < q;
    const float w = jv ? expf((float)(csh[q - 1] - csh[j])) : 0.f;
    const float dtj = jv ? dt[(row0 + j) * h + hh] : 0.f;
    float dwp = 0.f, dtp = 0.f;
#pragma unroll
    for (int mm = 0; mm < MP; ++mm) {
      const int pp = ja + 16 * mm;
      if (P >= 16 || ja < P) {
        const long long o = ((row0 + j) * h + hh) * P + pp;
        const float xv = jv ? ld(x, o) : 0.f;
        dwp = fmaf(Us[(ra + 16 * a) * LDP + pp], vv[a][mm], dwp);
        const float du = fmaf(w, vv[a][mm], acc[a][mm]);
        dtp = fmaf(du, xv, dtp);
        if (jv) st(dx, o, du * dtj);
      }
    }
    dwp = half_warp_sum(dwp);
    dtp = half_warp_sum(dtp);
    if (ja == 0 && jv) {
      dw[hq + j] = dwp;
      ddtu[(row0 + j) * h + hh] = dtp;
    }
  }
}

__host__ __device__ inline int dB_smem(int n) {
  return 4 * (kT * (kT + 1) + kT * (n + 1) + kT);
}

// 6. Per (b, c, 32 rows j, head group): the group's sum of w_j dSt u_j,
// heads in order (head dim in tiles of 32), into the workspace.
template <typename T, int P>
__global__ void __launch_bounds__(kThreadsB)
    bwd_dBh(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ dst, const double* __restrict__ cs,
            float* __restrict__ dBp, BDims d) {
  constexpr int LDT = kT + 1, NM = kMaxState / 16;
  const int jt = blockIdx.x, bc = blockIdx.y, q = d.q, h = d.h, n = d.n;
  const int h_lo = blockIdx.z * kHeadGroup;
  const int h_hi = min(h, h_lo + kHeadGroup);
  const int LDN = n + 1;
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* Ts = reinterpret_cast<float*>(smem_b);  // [kT][LDT]  w u rows j
  float* Cs = Ts + kT * LDT;                      // [kT][LDN]  dSt^T
  float* ws = Cs + kT * LDN;                      // [kT]
  const int tid = threadIdx.x, ra = tid / 16, ja = tid % 16;
  const int j0 = jt * kT;
  const long long row0 = (long long)bc * q;
  float ca[2][NM];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) ca[u][mm] = 0.f;
  for (int hh = h_lo; hh < h_hi; ++hh) {
    const double* csg = cs + ((long long)bc * h + hh) * q;
    const float* dsth = dst + ((long long)bc * h + hh) * n * P;
    __syncthreads();
    if (tid < kT)
      ws[tid] = j0 + tid < q ? expf((float)(csg[q - 1] - csg[j0 + tid])) : 0.f;
    for (int p0 = 0; p0 < P; p0 += kT) {
      __syncthreads();  // ws written; Ts and Cs consumed
      for (int e = tid; e < kT * kT; e += kThreadsB) {
        const int r = e / kT, pp = e % kT, j = j0 + r;
        Ts[r * LDT + pp] =
            j < q && p0 + pp < P
                ? ld(x, ((row0 + j) * h + hh) * P + p0 + pp) *
                      dt[(row0 + j) * h + hh] * ws[r]
                : 0.f;
      }
      for (int e = tid; e < kT * n; e += kThreadsB) {
        const int k = e / kT, pp = e % kT;
        Cs[pp * LDN + k] =
            p0 + pp < P ? dsth[(long long)k * P + p0 + pp] : 0.f;
      }
      __syncthreads();
      for (int pp = 0; pp < kT; ++pp) {
        const float t0 = Ts[ra * LDT + pp], t1 = Ts[(ra + 16) * LDT + pp];
#pragma unroll
        for (int mm = 0; mm < NM; ++mm) {
          const int k = ja + 16 * mm;
          if (k < n) {
            const float cv = Cs[pp * LDN + k];
            ca[0][mm] = fmaf(t0, cv, ca[0][mm]);
            ca[1][mm] = fmaf(t1, cv, ca[1][mm]);
          }
        }
      }
    }
  }
  float* out = dBp + (long long)blockIdx.z * d.bc * q * n;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = j0 + ra + 16 * u;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) {
      const int k = ja + 16 * mm;
      if (j < q && k < n) out[(row0 + j) * n + k] = ca[u][mm];
    }
  }
}

// 7. Per (b, c, 32 rows j): dB_j = sum_{i >= j} (sum_h dM o L)_ij C_i, then
// the head groups' sums of 6. added in group order.
template <typename T>
__global__ void __launch_bounds__(kThreadsB)
    bwd_dB(const T* __restrict__ C, const float* __restrict__ dS,
           const float* __restrict__ dBp, T* __restrict__ dB, BDims d) {
  constexpr int LDT = kT + 1, NM = kMaxState / 16;
  const int jt = blockIdx.x, bc = blockIdx.y, q = d.q, n = d.n;
  const int groups = head_groups(d.h), LDN = n + 1;
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* Ts = reinterpret_cast<float*>(smem_b);  // [kT][LDT]  dS rows i
  float* Cs = Ts + kT * LDT;                      // [kT][LDN]
  const int tid = threadIdx.x, ra = tid / 16, ja = tid % 16;
  const int j0 = jt * kT;
  const long long row0 = (long long)bc * q;
  float ca[2][NM];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) ca[u][mm] = 0.f;
  for (int i0 = j0; i0 < q; i0 += kT) {
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kThreadsB) {
      const int ii = e / kT, jj = e % kT, i = i0 + ii, j = j0 + jj;
      Ts[ii * LDT + jj] = i < q && j < q ? dS[(row0 + i) * q + j] : 0.f;
    }
    for (int e = tid; e < kT * n; e += kThreadsB) {
      const int ii = e / n, k = e % n;
      Cs[ii * LDN + k] = i0 + ii < q ? ld(C, (row0 + i0 + ii) * n + k) : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < kT; ++ii) {
      const float t0 = Ts[ii * LDT + ra], t1 = Ts[ii * LDT + ra + 16];
#pragma unroll
      for (int mm = 0; mm < NM; ++mm) {
        const int k = ja + 16 * mm;
        if (k < n) {
          const float cv = Cs[ii * LDN + k];
          ca[0][mm] = fmaf(t0, cv, ca[0][mm]);
          ca[1][mm] = fmaf(t1, cv, ca[1][mm]);
        }
      }
    }
  }
  const long long part = (long long)d.bc * q * n;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = j0 + ra + 16 * u;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm) {
      const int k = ja + 16 * mm;
      if (j < q && k < n) {
        const long long o = (row0 + j) * n + k;
        float v = ca[u][mm];
        for (int g = 0; g < groups; ++g) v += dBp[g * part + o];
        st(dB, o, v);
      }
    }
  }
}

// 8. Per (b, c) and 8 heads, a warp per head: dcs, the reverse cumsum dA_k
// (f64), ddt and the (b, c) partial sum of dA_k dt_k.
__global__ void __launch_bounds__(kThreadsB)
    bwd_dt(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ ddi, Work w, float* __restrict__ ddt,
           BDims d) {
  const int bc = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = d.q, h = d.h;
  const long long row0 = (long long)bc * q;
  const int per = (q + 31) / 32;
  const int i0 = min(q, lane * per), i1 = min(q, i0 + per);
  {
    const int hh = blockIdx.y * (kThreadsB / 32) + warp;
    if (hh >= h) return;  // whole warps
    const long long hq = ((long long)bc * h + hh) * q;
    const double* c = w.cs + hq;
    const double clast = c[q - 1];
    float sw = 0.f;  // sum_j dw_j w_j, the gradient into cs_{q-1}
    for (int i = i0; i < i1; ++i)
      sw = fmaf(w.dw[hq + i], expf((float)(clast - c[i])), sw);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) sw += __shfl_xor_sync(~0u, sw, o);
    auto dcs = [&](int i) -> double {
      const float wi = expf((float)(clast - c[i]));
      double v = (double)w.rows[hq + i] - (double)w.cols[hq + i] +
                 (double)ddi[(row0 + i) * h + hh] * (double)expf((float)c[i]) -
                 (double)w.dw[hq + i] * (double)wi;
      return i == q - 1 ? v + (double)sw : v;
    };
    double tot = 0.0;
    for (int i = i0; i < i1; ++i) tot += dcs(i);
    double incl = tot;  // the sum over this lane and the lanes after it
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const double dn = __shfl_down_sync(~0u, incl, o);
      if (lane + o < 32) incl += dn;
    }
    double run = incl - tot, dap = 0.0;
    const double a = A[hh];
    for (int i = i1 - 1; i >= i0; --i) {
      run += dcs(i);  // dA_i = sum_{k >= i} dcs_k
      const long long o = (row0 + i) * h + hh;
      ddt[o] = (float)(run * a + (double)w.ddtu[o]);
      dap += run * (double)dt[o];
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) dap += __shfl_xor_sync(~0u, dap, o);
    if (lane == 0) w.dAp[(long long)bc * h + hh] = dap;
  }
}

// 9. dA per head: the (b, c) partials summed in order.
__global__ void bwd_dA(const double* __restrict__ dAp, float* __restrict__ dA,
                       BDims d) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  if (hh >= d.h) return;
  double s = 0.0;
  for (int bc = 0; bc < d.bc; ++bc) s += dAp[(long long)bc * d.h + hh];
  dA[hh] = (float)s;
}

// ------------------------------------------ bf16: the tensor-core kernel
// bwd_tc: per (b, c) and pair of row tiles j of kJT rows (tiles t and
// T - 1 - t, so that every block walks the same number of tiles i), all
// heads in order. For each tile j, head by head, the work comes in steps
// of kIS rows: first the tiles i >= j0 (dY_i and C_i), then the state in
// tiles of kIS rows (dSt's rows). Warp-specialised, 3 warpgroups:
//   * Warpgroup 0, the producer, copies each step's tiles with 16-byte
//     cp.async (C_i into the step's stage, one of kStages; the f32 tile
//     into a staging tile; at a head's first step also its x_j, cs and
//     dt_j), splits the f32 tile once into three bf16 parts in the stage
//     (each thread the pieces it copied itself), and arrives on the
//     stage's full mbarrier. It refills a stage once the stage's empty
//     mbarrier says every consumer warp is done with it, so it runs up to
//     two steps ahead.
//   * Warpgroups 1-2, 8 consumer warps: warp (r, c) owns rows j0 + 16 r ..
//     + 15 and half c of each step's columns, and waits for nothing but
//     its stage and its partner (r, 1 - c): the four row groups run apart
//     (no block barrier inside a tile). Per step i, warp (r, c) takes the
//     columns i0 + 16 c .. + 15, on mma.sync m16n8k16:
//       S^T  = B_j C_i^T                    (B, C exact: 1 product)
//       dM^T = dt_j (x_j dY_i^T)            (x exact, dY split: 3)
//     then in registers, j <= i < q: L = 2^((cs_i - cs_j) log2 e), M =
//     S L, dl = dM M (colsum into registers; the row group's partial of
//     rowsum into the workspace, added up by bwd_rows_sum), dM L added
//     into the block's sum over heads (shared memory, each element by one
//     thread, heads in order). The two warps of a row group swap their
//     M^T (as split A fragments), so each has the step's 32 columns, and
//     take half the head dim each:
//       du_j += M^T dY_i                    (both f32: 6 products of the
//     parts, hh hm mh mm hl lh, summed smallest first; fewer lose dx
//     against the plain f32 backward: tests/test_torch_recurrent_bwd.py::
//     test_ssd_bwd_kernel_precision_choice_beats_plain_float32).
//     Per state step (rows n of dSt), warp (r, c):
//       V_j += B_j[:, n] dSt[n, :]           (its half of the head dim; B
//                                             exact: 3 products)
//       dBs_j[n] += w_j dt_j (x_j dSt[n, :]^T)  (its half of the 32
//     states; x exact: 3; the states' dB term, summed over heads in shared
//     memory). At a head's last step: du += w V, dx = du dt (each warp its
//     half of the head dim), dw = u . V, du . x and colsum(dl) (the two
//     halves added in order) leave.
// After the last head (consumers only): dB_j = dBs_j + sum_i (sum_h dM o
// L)^T_ji C_i (the head sum split in three parts, C exact) leaves as bf16;
// the tile's partial of dC_i = sum_j (sum_h dM o L)_ij B_j (rows i >= j0)
// goes to the workspace, and bwd_dC_sum adds the tiles' partials in order.
// 384 threads leave ptxas 168 registers a thread, which the consumers fill
// (setmaxnreg cannot give them more: ptxas allocates for the whole kernel
// under the launch bound). Measured choices on the H100 (tools/
// ssd_bwd_ab.py and copies of this file): a producer of 64 threads, or
// copies issued two steps ahead of the splits, were slower; a single
// block-wide pipeline of 8 warps (no producer) took 1.35 times as long.
// Head dims up to 64, chunks up to what shared memory holds (256 at head
// dim 64 and state 128): at head dim 128 the stages and the head sum do not
// fit, and the SIMT kernels run.
constexpr int kIS = 32;       // rows i (or state rows) a step
constexpr int kProd = 128;    // producer threads (a warpgroup)
constexpr int kCons = 256;    // consumer threads
constexpr int kTcB = kProd + kCons;  // threads of bwd_tc
constexpr int kMaxTcP = 64;   // the largest head dim bwd_tc takes
constexpr int kStages = 3;    // the producer's stages

struct TDims {
  int bc, q, h, n, np;  // np: n padded to a multiple of kIS
  int q32, T, pairs;    // tiles of kIS rows i, tiles of kJT rows j, pairs
};

template <int P>
struct TcB {
  static constexpr int PK = P < 16 ? 16 : P;  // head dim padded to a k step
  static constexpr int LDX = PK + 8;          // x_j and split rows, halves
  static constexpr int NTP = P / 8;           // 8-column tiles of a head
  static constexpr int NTH = NTP > 1 ? NTP / 2 : 1;  // tiles a warp's half
  static constexpr int NT2 = NTH > 1 ? 2 : 1;  // tiles an ldmatrix gives
};

// Shared memory of bwd_tc, byte offsets: the head sum of dM o L (float4
// per (row group, tile i, 8-column tile, lane): the mma accumulator
// layout), the states' dB term (likewise, per (row group, 8-column tile of
// n, lane)), cs and dt of two heads, x_j of two heads, B_j, the producer's
// f32 staging tile, kStages stages (C_i, then the three split parts), the
// swapped M^T fragments, the halves' row sums, the mbarriers (full and
// empty per stage).
struct TcLayout {
  int dS, dBs, cs, dtb, x, Bj, raw, stage, xch, hs, bar, total;
  int stage_bytes, sp_at;  // a stage's size; its split parts' offset in it
};

template <int P>
__host__ __device__ inline TcLayout tc_layout(int q, int np) {
  using S = TcB<P>;
  const int q32 = (q + kIS - 1) / kIS, ldb = np + 8;
  const int cbytes = kIS * ldb * 2, spbytes = 3 * kIS * S::LDX * 2;
  const int sizes[11] = {4 * q32 * 4 * 32 * 16, 4 * (np / 8) * 32 * 16,
                         2 * q * 8,             2 * kJT * 4,
                         2 * kJT * S::LDX * 2,  kJT * ldb * 2,
                         kIS * P * 4,  kStages * (cbytes + spbytes),
                         8 * 3 * 32 * 16,       8 * 3 * 16 * 4,
                         2 * kStages * 8};
  int off[11], o = 0;
  for (int k = 0; k < 11; ++k) {
    off[k] = o;
    o += (sizes[k] + 15) / 16 * 16;
  }
  return TcLayout{off[0], off[1], off[2], off[3], off[4],  off[5],
                  off[6], off[7], off[8], off[9], off[10], o,
                  cbytes + spbytes, cbytes};
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

// named barrier `id` over `count` threads (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Waits for the phase of the given parity to complete. A wait that lasts
// some 20 s is a fault of the kernel (a stage never filled or released):
// it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > 40000000000LL)
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values as three packed bf16 pairs (hi, mid, lo): split3 of each,
// two values a conversion.
__device__ __forceinline__ void split3_pair(float a, float b, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h2);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m2 = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m2);
  hi = bf2_bits(h2);
  mid = bf2_bits(m2);
  lo = bf2_bits(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// A fragments (16 x 16) in three parts from two accumulator tiles (16 x 8
// each, columns 0-7 and 8-15 of the k step).
__device__ __forceinline__ void split3_frag(const float* c0, const float* c1,
                                            uint32_t a[3][4]) {
  split3_pair(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split3_pair(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split3_pair(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split3_pair(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

template <int P>
__global__ void __launch_bounds__(kTcB, 1)
    bwd_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
           const __nv_bfloat16* __restrict__ B,
           const __nv_bfloat16* __restrict__ C, const float* __restrict__ dy,
           const float* __restrict__ dst, const double* __restrict__ csw,
           __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ dB,
           float* __restrict__ rows, float* __restrict__ cols,
           float* __restrict__ dw, float* __restrict__ ddtu,
           float* __restrict__ dCp, TDims d) {
  using S = TcB<P>;
  using bf = __nv_bfloat16;
  constexpr int PK = S::PK, LDX = S::LDX, NTP = S::NTP, NTH = S::NTH;
  constexpr int NT2 = S::NT2;
  const int q = d.q, h = d.h, n = d.n, np = d.np, ldb = np + 8;
  const int q32 = d.q32, NT8 = np / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout lay = tc_layout<P>(q, np);
  const uint32_t sbase = smem_u32(smem);
  float4* dS4 = reinterpret_cast<float4*>(smem + lay.dS);
  float4* dBs4 = reinterpret_cast<float4*>(smem + lay.dBs);
  double* csb = reinterpret_cast<double*>(smem + lay.cs);  // [2][q]
  float* dtb = reinterpret_cast<float*>(smem + lay.dtb);   // [2][kJT]
  bf* xb = reinterpret_cast<bf*>(smem + lay.x);            // [2][kJT][LDX]
  bf* Bj = reinterpret_cast<bf*>(smem + lay.Bj);           // [kJT][ldb]
  float* raw = reinterpret_cast<float*>(smem + lay.raw);  // [kIS][P]
  // stage b: C_i [kIS][ldb], then the parts [3][kIS][LDX]
  auto stage_c = [&](int b) {
    return reinterpret_cast<bf*>(smem + lay.stage + b * lay.stage_bytes);
  };
  auto stage_p = [&](int b) {
    return reinterpret_cast<bf*>(smem + lay.stage + b * lay.stage_bytes +
                                 lay.sp_at);
  };
  uint4* xch = reinterpret_cast<uint4*>(smem + lay.xch);  // [8][3][32]
  float* hs = reinterpret_cast<float*>(smem + lay.hs);    // [8][3][16]
  auto full_bar = [&](int b) { return sbase + lay.bar + 8 * b; };
  auto empty_bar = [&](int b) {
    return sbase + lay.bar + 8 * kStages + 8 * b;
  };

  const int pair = blockIdx.x % d.pairs, bcid = blockIdx.x / d.pairs;
  const int tid = threadIdx.x;
  const bool producer = tid < kProd;
  const int ctid = tid - kProd;  // consumer thread index (0 .. 255)
  const int warp = ctid / 32, lane = tid % 32;  // consumer warp 0 .. 7
  const int wr = warp % 4, wc = warp / 4;  // row group, column half
  const int g8 = lane / 4, t4 = lane % 4, mi = lane / 8;
  const long long row0 = (long long)bcid * q;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // this warp's 8-column tiles of the head dim (none for c = 1 at P = 8)
  const int p_nt0 = wc * NTH;
  const bool p_on = p_nt0 < NTP;

  if (tid == 0) {
    for (int b = 0; b < kStages; ++b) {
      mbar_init(full_bar(b), kProd);  // every producer thread
      mbar_init(empty_bar(b), 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (PK > P) {  // columns P .. PK - 1 of x and the parts stay 0
    for (int e = tid; e < 2 * kJT * (PK - P); e += kTcB)
      xb[(e / (PK - P)) * LDX + P + e % (PK - P)] = __float2bfloat16_rn(0.f);
    for (int e = tid; e < kStages * 3 * kIS * (PK - P); e += kTcB) {
      const int r = e / (PK - P);  // row of stage r / (3 kIS)
      stage_p(r / (3 * kIS))[(r % (3 * kIS)) * LDX + P + e % (PK - P)] =
          __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();  // the mbarriers and the zero columns are in place
  // Both roles pass the same three block barriers a tile: before it
  // (the last tile's readers are done), after the consumers' set-up, and
  // after its heads (every head is in dS and dBs; the stages are idle).
  int gbase = 0;  // steps of the earlier tiles: the stages' use count

  if (producer) {
    // -------------------------------------------------------- producer
    for (int side = 0; side < 2; ++side) {
      const int jt = side == 0 ? pair : d.T - 1 - pair;
      if (side == 1 && jt == pair) break;
      const int j0 = jt * kJT, it0 = j0 / kIS;
      const int ni = q32 - it0, spH = ni + np / kIS, K = h * spH;
      __syncthreads();
      __syncthreads();
      // the copies of step k: at a head's first step also its x_j, cs, dt_j
      auto issue = [&](int k) {
        const int hh = k / spH, s = k % spH, b = (gbase + k) % kStages;
        if (s == 0) {
          bf* xd = xb + (hh & 1) * kJT * LDX;
          for (int e = tid; e < kJT * (P / 8); e += kProd) {
            const int r = e / (P / 8), c = (e % (P / 8)) * 8, j = j0 + r;
            const bool ok = j < q;
            cp_async16(xd + r * LDX + c,
                       ok ? x + ((row0 + j) * h + hh) * P + c : x, ok);
          }
          double* cd = csb + (hh & 1) * q;
          const double* cg = csw + ((long long)bcid * h + hh) * q;
          for (int e = tid; e < q; e += kProd) cp_async8(cd + e, cg + e);
          float* dd = dtb + (hh & 1) * kJT;
          for (int e = tid; e < kJT; e += kProd) {
            if (j0 + e < q)
              cp_async4(dd + e, dt + (row0 + j0 + e) * h + hh);
            else
              dd[e] = 0.f;
          }
        }
        if (s < ni) {
          const int i0 = (it0 + s) * kIS;
          for (int e = tid; e < kIS * (P / 4); e += kProd) {
            const int r = e / (P / 4), c = (e % (P / 4)) * 4, i = i0 + r;
            const bool ok = i < q;
            cp_async16(raw + r * P + c,
                       ok ? dy + ((row0 + i) * h + hh) * P + c : dy, ok);
          }
          load_bc<kProd>(stage_c(b), C + row0 * n, i0, kIS, q, n, np, tid);
        } else {
          const int r0 = (s - ni) * kIS;
          const float* src = dst + ((long long)bcid * h + hh) * n * P;
          for (int e = tid; e < kIS * (P / 4); e += kProd) {
            const int r = e / (P / 4), c = (e % (P / 4)) * 4;
            const bool ok = r0 + r < n;
            cp_async16(raw + r * P + c,
                       ok ? src + (long long)(r0 + r) * P + c : dst, ok);
          }
        }
      };
      // the f32 tile of step k as three parts, each thread the pieces it
      // copied (so no barrier between its wait and the split)
      auto split_own = [&](int k) {
        bf* o0 = stage_p((gbase + k) % kStages);
        for (int e = tid; e < kIS * (P / 4); e += kProd) {
          const int r = e / (P / 4), c = (e % (P / 4)) * 4;
          const float4 v = *reinterpret_cast<const float4*>(raw + r * P + c);
          uint32_t h0, m0, l0, h1, m1, l1;
          split3_pair(v.x, v.y, h0, m0, l0);
          split3_pair(v.z, v.w, h1, m1, l1);
          bf* o = o0 + r * LDX + c;
          *reinterpret_cast<uint2*>(o) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(o + kIS * LDX) = make_uint2(m0, m1);
          *reinterpret_cast<uint2*>(o + 2 * kIS * LDX) = make_uint2(l0, l1);
        }
      };
      // stage of use u is free once the consumers released use u - 1
      auto wait_free = [&](int k) {
        const int g = gbase + k;
        mbar_wait(empty_bar(g % kStages), ((g / kStages) & 1) ^ 1);
      };
      wait_free(0);
      issue(0);
      cp_async_commit();
      for (int k = 1; k <= K; ++k) {
        cp_async_wait<0>();  // step k - 1's copies (this thread's)
        split_own(k - 1);
        mbar_arrive(full_bar((gbase + k - 1) % kStages));
        if (k < K) {
          wait_free(k);
          issue(k);
          cp_async_commit();
        }
      }
      gbase += K;
      __syncthreads();
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  for (int side = 0; side < 2; ++side) {
    const int jt = side == 0 ? pair : d.T - 1 - pair;
    if (side == 1 && jt == pair) break;
    const int j0 = jt * kJT, it0 = j0 / kIS;
    const int ni = q32 - it0, spH = ni + np / kIS, K = h * spH;
    const int jr0 = j0 + 16 * wr + g8, jr1 = jr0 + 8;
    const bool wact = j0 + 16 * wr < q;

    __syncthreads();  // the previous tile's readers of dS, dBs, Bj are done
    {
      const int per_w = ni * 4 * 32;
      for (int e = ctid; e < 4 * per_w; e += kCons)
        dS4[((e / per_w) * q32 + it0) * 128 + e % per_w] = zero4;
      for (int e = ctid; e < 4 * NT8 * 32; e += kCons) dBs4[e] = zero4;
      load_bc<kCons>(Bj, B + row0 * n, j0, kJT, q, n, np, ctid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    {
      float du[NTH][4], vv[NTH][4], cpj[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < NTH; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) du[t][e] = vv[t][e] = 0.f;
      double csj0 = 0.0, csj1 = 0.0;
      float dtj0 = 0.f, dtj1 = 0.f, wj0 = 0.f, wj1 = 0.f;
      for (int k = 0; k < K; ++k) {
        const int hh = k / spH, s = k % spH;
        const int g = gbase + k, b = g % kStages;
        mbar_wait(full_bar(b), (g / kStages) & 1);
        const double* cs = csb + (hh & 1) * q;
        if (s == 0) {  // this head's dt_j, cs_j, w_j = exp(cs_last - cs_j)
          const float* dd = dtb + (hh & 1) * kJT;
          dtj0 = dd[16 * wr + g8];
          dtj1 = dd[16 * wr + g8 + 8];
          const double cl = cs[q - 1];
          csj0 = jr0 < q ? cs[jr0] : 0.0;
          csj1 = jr1 < q ? cs[jr1] : 0.0;
          wj0 = jr0 < q ? fast_exp2((float)((cl - csj0) * kLog2e)) : 0.f;
          wj1 = jr1 < q ? fast_exp2((float)((cl - csj1) * kLog2e)) : 0.f;
        }
        const bf* xw = xb + (hh & 1) * kJT * LDX + 16 * wr * LDX;
        // ldmatrix row addresses (shared, bytes): A from x_j and B_j's rows
        const uint32_t xrow = smem_u32(xw) +
                              2 * (((mi & 1) * 8 + lane % 8) * LDX +
                                   (mi >> 1) * 8);
        const uint32_t arow =
            sbase + lay.Bj +
            2 * ((16 * wr + (mi & 1) * 8 + lane % 8) * ldb + (mi >> 1) * 8);
        // B operands from the parts: rows 16 c .. as n (plain), or rows as
        // k (.trans, columns from this warp's half of the head dim)
        const uint32_t spa = smem_u32(stage_p(b));
        const uint32_t prow =
            spa +
            2 * ((16 * wc + (mi >> 1) * 8 + lane % 8) * LDX + (mi & 1) * 8);
        const uint32_t ptr = spa + 2 * (((mi & 1) * 8 + lane % 8) * LDX +
                                        (mi >> 1) * 8 + p_nt0 * 8);
        const uint32_t ptr1 = spa + 2 * ((lane % 16) * LDX);
        if (s < ni) {
          // ---------------------------------------------- a tile i
          const int itg = it0 + s, i0 = itg * kIS, c0 = i0 + 16 * wc;
          // the row group's 16 rows meet the columns of half k
          const bool on0 = wact && i0 + 15 >= j0 + 16 * wr;
          const bool on1 = wact && i0 + 31 >= j0 + 16 * wr;
          const bool hon = wc ? on1 : on0;
          float rp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
          uint32_t am[3][4];  // this half's M^T, split, as A fragments
#pragma unroll
          for (int z = 0; z < 3; ++z)
#pragma unroll
            for (int r = 0; r < 4; ++r) am[z][r] = 0u;
          if (hon) {
            float sc[2][4], dm[2][4];
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[t][e] = dm[t][e] = 0.f;
            // S^T = B_j C_i^T over the state
            const uint32_t crow =
                smem_u32(stage_c(b)) +
                2 * ((16 * wc + (mi >> 1) * 8 + lane % 8) * ldb +
                     (mi & 1) * 8);
            for (int kk = 0; kk < np / 16; ++kk) {
              uint32_t af[4], bfr[4];
              ldsm_x4(af, arow + 32 * kk);
              ldsm_x4(bfr, crow + 32 * kk);
              mma16816(sc[0], af, bfr[0], bfr[1]);
              mma16816(sc[1], af, bfr[2], bfr[3]);
            }
            // dM^T / dt_j = x_j dY_i^T over the head dim, dY's parts lo
            // first
#pragma unroll
            for (int ks = 0; ks < PK / 16; ++ks) {
              uint32_t af[4];
              ldsm_x4(af, xrow + 32 * ks);
#pragma unroll
              for (int z = 2; z >= 0; --z) {
                uint32_t bfr[4];
                ldsm_x4(bfr, prow + 2 * (z * kIS * LDX) + 32 * ks);
                mma16816(dm[0], af, bfr[0], bfr[1]);
                mma16816(dm[1], af, bfr[2], bfr[3]);
              }
            }
            // M, dl = dM o M, dM o L; j <= i < q only (exp of the positive
            // differences above the diagonal could overflow)
            float4* dsp = dS4 + (wr * q32 + itg) * 128 + 2 * wc * 32 + lane;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              float o[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = e < 2 ? jr0 : jr1;
                const int i = c0 + nt * 8 + 2 * t4 + (e & 1);
                float mv = 0.f, dl = 0.f, dml = 0.f;
                if (i >= j && i < q) {
                  const float L = fast_exp2(
                      (float)((cs[i] - (e < 2 ? csj0 : csj1)) * kLog2e));
                  const float dmv = dm[nt][e] * (e < 2 ? dtj0 : dtj1);
                  mv = sc[nt][e] * L;
                  dl = dmv * mv;
                  dml = dmv * L;
                }
                sc[nt][e] = mv;  // M^T from here on
                cpj[e >> 1] += dl;
                rp[nt][e & 1] += dl;
                o[e] = dml;
              }
              float4 a = dsp[nt * 32];
              a.x += o[0];
              a.y += o[1];
              a.z += o[2];
              a.w += o[3];
              dsp[nt * 32] = a;
            }
            split3_frag(sc[0], sc[1], am);
          }
          // rowsum's partial over the row group's 16 rows j, per column i,
          // into the workspace (part (jt, r))
          float* rowp =
              rows + ((((long long)jt * 4 + wr) * d.bc + bcid) * h + hh) * q;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float v = rp[nt][u];
              v += __shfl_xor_sync(~0u, v, 4);
              v += __shfl_xor_sync(~0u, v, 8);
              v += __shfl_xor_sync(~0u, v, 16);
              const int i = c0 + nt * 8 + 2 * t4 + u;
              if (g8 == 0 && i < q) rowp[i] = v;
            }
          // swap M^T with the other half of the row group
#pragma unroll
          for (int z = 0; z < 3; ++z)
            xch[(warp * 3 + z) * 32 + lane] =
                make_uint4(am[z][0], am[z][1], am[z][2], am[z][3]);
          bar_sync(1 + wr, 64);
          // du_j += M^T dY_i: both f32, six products of the parts
          if (p_on) {
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              if (!(ks ? on1 : on0)) continue;  // M^T is zero there
              uint32_t a[3][4];  // the k step's 16 columns, warp (r, ks)'s
#pragma unroll
              for (int z = 0; z < 3; ++z) {
                const uint4 v = xch[((wr + 4 * ks) * 3 + z) * 32 + lane];
                a[z][0] = v.x;
                a[z][1] = v.y;
                a[z][2] = v.z;
                a[z][3] = v.w;
              }
#pragma unroll
              for (int nt = 0; nt < NTH; nt += NT2) {
                uint32_t bh[4], bm[4], bl[4];
                if constexpr (NT2 > 1) {
                  const uint32_t yt = ptr + 2 * (ks * 16 * LDX + nt * 8);
                  ldsm_x4_t(bh, yt);
                  ldsm_x4_t(bm, yt + 2 * kIS * LDX);
                  ldsm_x4_t(bl, yt + 4 * kIS * LDX);
                } else {
                  const uint32_t yt =
                      ptr1 + 2 * (ks * 16 * LDX + (p_nt0 + nt) * 8);
                  ldsm_x2_t(bh, yt);
                  ldsm_x2_t(bm, yt + 2 * kIS * LDX);
                  ldsm_x2_t(bl, yt + 4 * kIS * LDX);
                }
#pragma unroll
                for (int u = 0; u < NT2; ++u) {
                  float* c = du[nt + u];
                  mma16816(c, a[2], bh[2 * u], bh[2 * u + 1]);
                  mma16816(c, a[0], bl[2 * u], bl[2 * u + 1]);
                  mma16816(c, a[1], bm[2 * u], bm[2 * u + 1]);
                  mma16816(c, a[1], bh[2 * u], bh[2 * u + 1]);
                  mma16816(c, a[0], bm[2 * u], bm[2 * u + 1]);
                  mma16816(c, a[0], bh[2 * u], bh[2 * u + 1]);
                }
              }
            }
          }
          // the partner reads this warp's M^T before it is written again
          bar_sync(1 + wr, 64);
        } else if (wact) {
          // ---------------------------------- state rows n0 .. n0 + kIS
          const int kc = s - ni;
          // V_j += B_j[:, n] dSt[n, :], this warp's half of the head dim
          if (p_on) {
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              uint32_t af[4];
              ldsm_x4(af, arow + 2 * (kc * kIS + ks * 16));
#pragma unroll
              for (int nt = 0; nt < NTH; nt += NT2) {
#pragma unroll
                for (int z = 2; z >= 0; --z) {
                  uint32_t bfr[4];
                  if constexpr (NT2 > 1) {
                    ldsm_x4_t(bfr, ptr + 2 * (z * kIS * LDX +
                                              ks * 16 * LDX + nt * 8));
                  } else {
                    ldsm_x2_t(bfr, ptr1 + 2 * (z * kIS * LDX +
                                               ks * 16 * LDX +
                                               (p_nt0 + nt) * 8));
                  }
#pragma unroll
                  for (int u = 0; u < NT2; ++u)
                    mma16816(vv[nt + u], af, bfr[2 * u], bfr[2 * u + 1]);
                }
              }
            }
          }
          // the states' dB term: w_j dt_j (x_j dSt[n, :]^T), this warp's
          // 16 of the step's 32 states
          float tm[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) tm[t][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < PK / 16; ++ks) {
            uint32_t af[4];
            ldsm_x4(af, xrow + 32 * ks);
#pragma unroll
            for (int z = 2; z >= 0; --z) {
              uint32_t bfr[4];
              ldsm_x4(bfr, prow + 2 * (z * kIS * LDX) + 32 * ks);
              mma16816(tm[0], af, bfr[0], bfr[1]);
              mma16816(tm[1], af, bfr[2], bfr[3]);
            }
          }
          const float s0 = wj0 * dtj0, s1 = wj1 * dtj1;
          float4* bp = dBs4 + (wr * NT8 + kc * 4 + 2 * wc) * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float4 a = bp[nt * 32];
            a.x = fmaf(s0, tm[nt][0], a.x);
            a.y = fmaf(s0, tm[nt][1], a.y);
            a.z = fmaf(s1, tm[nt][2], a.z);
            a.w = fmaf(s1, tm[nt][3], a.w);
            bp[nt * 32] = a;
          }
        }
        if (s == spH - 1) {
          // -------- the head's rows j: du, dx, then dw, du . x, colsum(dl)
          float dwp[2] = {0.f, 0.f}, dtp[2] = {0.f, 0.f};
          if (p_on) {
#pragma unroll
            for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const int col = (p_nt0 + nt) * 8 + 2 * t4 + (e & 1);
                const float xv =
                    __bfloat162float(xw[(g8 + 8 * r) * LDX + col]);
                const float wv = r ? wj1 : wj0, dv = r ? dtj1 : dtj0;
                const float duv = fmaf(wv, vv[nt][e], du[nt][e]);
                dwp[r] = fmaf(xv * dv, vv[nt][e], dwp[r]);
                dtp[r] = fmaf(duv, xv, dtp[r]);
                du[nt][e] = duv * dv;  // dx
                vv[nt][e] = 0.f;
              }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int o = 1; o < 4; o *= 2) {
              dwp[r] += __shfl_xor_sync(~0u, dwp[r], o);
              dtp[r] += __shfl_xor_sync(~0u, dtp[r], o);
              cpj[r] += __shfl_xor_sync(~0u, cpj[r], o);
            }
          if (t4 == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              hs[(warp * 3 + 0) * 16 + g8 + 8 * r] = dwp[r];
              hs[(warp * 3 + 1) * 16 + g8 + 8 * r] = dtp[r];
              hs[(warp * 3 + 2) * 16 + g8 + 8 * r] = cpj[r];
            }
          }
          const long long hq = ((long long)bcid * h + hh) * q;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = r ? jr1 : jr0;
            if (p_on && wact && j < q) {
              bf* o = dx + ((row0 + j) * h + hh) * P + p_nt0 * 8 + 2 * t4;
#pragma unroll
              for (int nt = 0; nt < NTH; ++nt)
                *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
                    __floats2bfloat162_rn(du[nt][2 * r], du[nt][2 * r + 1]);
            }
          }
          bar_sync(1 + wr, 64);
          if (wc == 0 && lane < 16) {  // the two halves, in order
            const int j = j0 + 16 * wr + lane;
            if (wact && j < q) {
              const float* a = hs + warp * 48 + lane;
              const float* c = hs + (warp + 4) * 48 + lane;
              dw[hq + j] = a[0] + c[0];
              ddtu[(row0 + j) * h + hh] = a[16] + c[16];
              cols[hq + j] = a[32] + c[32];
            }
          }
          bar_sync(1 + wr, 64);  // hs is written again at the next head
#pragma unroll
          for (int t = 0; t < NTH; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) du[t][e] = 0.f;
          cpj[0] = cpj[1] = 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar(b));  // this warp is done
      }
    }
    gbase += K;
    __syncthreads();  // every head is in dS and dBs; the stages are idle

    {
      // ------- dB_j = dBs_j + sum_i (sum_h dM o L)^T_ji C_i, i in order;
      // warp (r, c) takes the pairs of 8-column tiles of n with index = c
      // mod 2. C_i through the C tiles of stages 0 and 1.
      load_bc<kCons>(stage_c(0), C + row0 * n, it0 * kIS, kIS, q, n, np,
                     ctid);
      cp_async_commit();
      for (int s = 0; s < ni; ++s) {
        const int itg = it0 + s;
        if (s + 1 < ni) {
          load_bc<kCons>(stage_c((s + 1) & 1), C + row0 * n,
                         (itg + 1) * kIS, kIS, q, n, np, ctid);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        bar_sync(5, kCons);
        if (wact && itg * kIS + kIS - 1 >= j0 + 16 * wr) {
          const bf* ct = stage_c(s & 1) + ((mi & 1) * 8 + lane % 8) * ldb +
                         (mi >> 1) * 8;
          const float4* dsp = dS4 + (wr * q32 + itg) * 128 + lane;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const float4 f0 = dsp[2 * ks * 32], f1 = dsp[(2 * ks + 1) * 32];
            const float c0[4] = {f0.x, f0.y, f0.z, f0.w};
            const float c1[4] = {f1.x, f1.y, f1.z, f1.w};
            uint32_t a[3][4];
            split3_frag(c0, c1, a);
            for (int nt = 2 * wc; nt < NT8; nt += 4) {
              uint32_t bfr[4];
              ldsm_x4_t(bfr, ct + ks * 16 * ldb + nt * 8);
              float4* bp = dBs4 + (wr * NT8 + nt) * 32 + lane;
              const float4 v0 = bp[0], v1 = bp[32];
              float a0[4] = {v0.x, v0.y, v0.z, v0.w};
              float a1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
              for (int z = 2; z >= 0; --z) {
                mma16816(a0, a[z], bfr[0], bfr[1]);
                mma16816(a1, a[z], bfr[2], bfr[3]);
              }
              bp[0] = make_float4(a0[0], a0[1], a0[2], a0[3]);
              bp[32] = make_float4(a1[0], a1[1], a1[2], a1[3]);
            }
          }
        }
        bar_sync(5, kCons);  // stage s is refilled next
      }
      if (wact) {
        for (int nt = 2 * wc; nt < NT8; nt += 4)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float4 v = dBs4[(wr * NT8 + nt + u) * 32 + lane];
            const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = e < 2 ? jr0 : jr1;
              const int col = (nt + u) * 8 + 2 * t4 + (e & 1);
              if (j < q && col < n)
                dB[(row0 + j) * n + col] = __float2bfloat16_rn(vals[e]);
            }
          }
      }

      // -- dC's partial of this tile: rows i >= j0, (sum_h dM o L)_ij B_j
      const int nm = (q - j0 + 15) / 16;
      const long long cbase = ((long long)jt * d.bc + bcid) * q;
      for (int mt = warp; mt < nm; mt += 8) {
        const int ib = j0 + 16 * mt;
        for (int nt = 0; nt < NT8; nt += 2) {
          float c[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[u][e] = 0.f;
#pragma unroll 1
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t ap[3][4];  // rows i, k = j: gathered from dS's layout
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = ib + g8 + (r & 1) * 8;
              const int jl = ks * 16 + 2 * t4 + (r >> 1) * 8;  // even
              const int ii = i % kIS;
              // element (j, i) of the head sum: row group jl / 16, row
              // jl % 16; jl + 1 is the next row of the same 8: lane + 4
              const float* base = reinterpret_cast<const float*>(
                  dS4 + (((jl / 16) * q32 + i / kIS) * 4 + ii / 8) * 32);
              const int ln = ((jl % 16) % 8) * 4 + (ii % 8) / 2;
              const int e = ((jl % 16) / 8) * 2 + (ii & 1);
              split3_pair(base[ln * 4 + e], base[(ln + 4) * 4 + e],
                          ap[0][r], ap[1][r], ap[2][r]);
            }
            uint32_t bfr[4];
            ldsm_x4_t(bfr, Bj + (ks * 16 + (mi & 1) * 8 + lane % 8) * ldb +
                               nt * 8 + (mi >> 1) * 8);
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int z = 2; z >= 0; --z)
                mma16816(c[u], ap[z], bfr[2 * u], bfr[2 * u + 1]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = ib + g8 + (e >> 1) * 8;
              const int col = (nt + u) * 8 + 2 * t4 + (e & 1);
              if (i < q && col < n) dCp[(cbase + i) * n + col] = c[u][e];
            }
        }
      }
    }
  }
}

// rowsum(dl): bwd_tc's partials (row tile, row group) 0 .. 4 (i / kJT + 1)
// - 1 of row i, added in order into part 0.
__global__ void bwd_rows_sum(float* __restrict__ rows, BDims d) {
  const long long bhq = (long long)d.bc * d.h * d.q;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= bhq) return;
  const int i = (int)(e % d.q);
  float v = rows[e];
  for (int k = 1; k < 4 * (i / kJT + 1); ++k) v += rows[k * bhq + e];
  rows[e] = v;
}

// dC_i = the row tiles' partials 0 .. i / kJT, added in order.
__global__ void bwd_dC_sum(const float* __restrict__ dCp,
                           __nv_bfloat16* __restrict__ dC, BDims d) {
  const long long tot = (long long)d.bc * d.q * d.n;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= tot) return;
  const int i = (int)((e / d.n) % d.q);
  float v = dCp[e];
  for (int k = 1; k <= i / kJT; ++k) v += dCp[k * tot + e];
  dC[e] = __float2bfloat16_rn(v);
}

template <typename K>
cudaError_t smem_opt_in(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <typename T, int P>
int launch_bwd(const T* x, const float* dt, const float* A, const T* B,
               const T* C, const float* dy, const float* dst,
               const float* ddi, T* dx, float* ddt, float* dA, T* dB, T* dC,
               char* ws, int b, int nc, int q, int h, int n,
               cudaStream_t st) {
  const BDims d{b * nc, q, h, n};
  Work w;
  work_layout(d, ws, &w);
  const int tiles = (q + kT - 1) / kT;
  const int groups = head_groups(h);
  const int s_smem = 2 * kT * (n + 1) * 4;
  const int r_smem = rows_smem<P>(q), c_smem = cols_smem<P>(q);
  const int b_smem = dB_smem(n), dc_smem = dC_smem(n);
  if (r_smem > 232448 || c_smem > 232448 || s_smem > 232448 ||
      (long long)b * nc > 65535 || h > 65535)  // grid y and z
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = smem_opt_in(bwd_S<T>, s_smem)) != cudaSuccess ||
      (e = smem_opt_in(bwd_rows<T, P>, r_smem)) != cudaSuccess ||
      (e = smem_opt_in(bwd_dC<T>, dc_smem)) != cudaSuccess ||
      (e = smem_opt_in(bwd_cols<T, P>, c_smem)) != cudaSuccess ||
      (e = smem_opt_in(bwd_dBh<T, P>, b_smem)) != cudaSuccess ||
      (e = smem_opt_in(bwd_dB<T>, dc_smem)) != cudaSuccess)
    return (int)e;
  bwd_cs<<<dim3(d.bc, (h + 7) / 8), kThreadsB, 0, st>>>(dt, A, w.cs, d);
  bwd_S<T><<<dim3(tiles, tiles, d.bc), kThreadsB, s_smem, st>>>(B, C, w.S,
                                                               d);
  bwd_rows<T, P><<<dim3(tiles, d.bc, groups), kThreadsB, r_smem, st>>>(
      x, dt, dy, w.cs, w.S, w.rows, w.dSp, d);
  bwd_dC<T><<<dim3(tiles, d.bc), kThreadsB, dc_smem, st>>>(B, w.dSp, w.dS,
                                                           dC, d);
  bwd_cols<T, P><<<dim3(tiles, h, d.bc), kThreadsB, c_smem, st>>>(
      x, dt, B, dy, dst, w.cs, w.S, dx, w.cols, w.dw, w.ddtu, d);
  bwd_dBh<T, P><<<dim3(tiles, d.bc, groups), kThreadsB, b_smem, st>>>(
      x, dt, dst, w.cs, w.dBp, d);
  bwd_dB<T><<<dim3(tiles, d.bc), kThreadsB, dc_smem, st>>>(C, w.dS, w.dBp,
                                                           dB, d);
  bwd_dt<<<dim3(d.bc, (h + 7) / 8), kThreadsB, 0, st>>>(dt, A, ddi, w, ddt,
                                                        d);
  bwd_dA<<<(h + 127) / 128, 128, 0, st>>>(w.dAp, dA, d);
  return (int)cudaGetLastError();
}

// The bf16 path: bwd_cs, bwd_tc, bwd_dC_sum, bwd_dt, bwd_dA.
template <int P>
int launch_bwd_tc(const __nv_bfloat16* x, const float* dt, const float* A,
                  const __nv_bfloat16* B, const __nv_bfloat16* C,
                  const float* dy, const float* dst, const float* ddi,
                  __nv_bfloat16* dx, float* ddt, float* dA,
                  __nv_bfloat16* dB, __nv_bfloat16* dC, char* ws, int b,
                  int nc, int q, int h, int n, cudaStream_t st) {
  const BDims d{b * nc, q, h, n};
  Work w;
  work_layout(d, ws, &w);
  const int np = (n + kIS - 1) / kIS * kIS, T = (q + kJT - 1) / kJT;
  const TDims td{d.bc, q, h, n, np, (q + kIS - 1) / kIS, T, (T + 1) / 2};
  const int smem = tc_layout<P>(q, np).total;
  const long long tot = (long long)d.bc * q * n;
  if ((long long)d.bc * td.pairs > 0x7fffffffLL || h > 65535 ||
      (tot + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = smem_opt_in(bwd_tc<P>, smem);
  if (e != cudaSuccess) return (int)e;
  bwd_cs<<<dim3(d.bc, (h + 7) / 8), kThreadsB, 0, st>>>(dt, A, w.cs, d);
  bwd_tc<P><<<d.bc * td.pairs, kTcB, smem, st>>>(
      x, dt, B, C, dy, dst, w.cs, dx, dB, w.rows, w.cols, w.dw, w.ddtu,
      w.dCp, td);
  bwd_dC_sum<<<(unsigned)((tot + 255) / 256), 256, 0, st>>>(w.dCp, dC, d);
  const long long bhq = (long long)d.bc * h * q;
  bwd_rows_sum<<<(unsigned)((bhq + 255) / 256), 256, 0, st>>>(w.rows, d);
  bwd_dt<<<dim3(d.bc, (h + 7) / 8), kThreadsB, 0, st>>>(dt, A, ddi, w, ddt,
                                                        d);
  bwd_dA<<<(h + 127) / 128, 128, 0, st>>>(w.dAp, dA, d);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bwd_typed(const void* x, const float* dt, const float* A,
                     const void* B, const void* C, const float* dy,
                     const float* dst, const float* ddi, void* dx,
                     float* ddt, float* dA, void* dB, void* dC, char* ws,
                     int b, int nc, int q, int h, int n, int dtype,
                     cudaStream_t st) {
  if (dtype == 0)
    return launch_bwd<float, P>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
        static_cast<const float*>(C), dy, dst, ddi, static_cast<float*>(dx),
        ddt, dA, static_cast<float*>(dB), static_cast<float*>(dC), ws, b,
        nc, q, h, n, st);
  using bf = __nv_bfloat16;
  if constexpr (P <= kMaxTcP) {
    if (tc_layout<P>(q, (n + kIS - 1) / kIS * kIS).total <= 232448)
      return launch_bwd_tc<P>(
          static_cast<const bf*>(x), dt, A, static_cast<const bf*>(B),
          static_cast<const bf*>(C), dy, dst, ddi, static_cast<bf*>(dx), ddt,
          dA, static_cast<bf*>(dB), static_cast<bf*>(dC), ws, b, nc, q, h,
          n, st);
  }
  // head dims 128 and 256, or a chunk too long for bwd_tc's shared
  // memory: the SIMT kernels
  return launch_bwd<bf, P>(
      static_cast<const bf*>(x), dt, A, static_cast<const bf*>(B),
      static_cast<const bf*>(C), dy, dst, ddi, static_cast<bf*>(dx), ddt, dA,
      static_cast<bf*>(dB), static_cast<bf*>(dC), ws, b, nc, q, h, n, st);
}

}  // namespace ssd_bwd

}  // namespace

// x (b, nc*q, h, p), B and C (b, nc*q, n): all f32 (dtype 0) or all bf16
// (dtype 1); dt (b, nc*q, h) and A (h) f32; outputs f32: y_diag
// (b, nc, q, h, p), states (b, nc, h, n, p), decay_in (b, nc, q, h). All
// contiguous and 16-byte aligned.
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
  switch (p) {
    case 8:
      return launch<8>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, n, dtype, st);
    case 16:
      return launch<16>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, n, dtype, st);
    case 32:
      return launch<32>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, n, dtype, st);
    case 64:
      return launch<64>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, n, dtype, st);
    case 128:
      return launch<128>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, n, dtype,
                         st);
    case 256:
      return launch<256>(x, dtf, Af, B, C, y, s, di, b, nc, q, h, n, dtype,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bytes of the workspace ssd_chunk_bwd needs (the wrapper allocates it).
extern "C" long long ssd_chunk_bwd_workspace(int b, int nc, int q, int h,
                                             int n) {
  const ssd_bwd::BDims d{b * nc, q, h, n};
  return ssd_bwd::work_layout(d, nullptr, nullptr);
}

// The backward of ssd_chunk_fwd. Inputs as there (x, B, C all f32, dtype
// 0, or all bf16, dtype 1; dt, A f32) and the outputs' cotangents, f32:
// dy (b, nc, q, h, p), dst (b, nc, h, n, p) and ddi (b, nc, q, h). Writes
// dx (b, nc*q, h, p), dB and dC (b, nc*q, n) in the inputs' dtype, ddt
// (b, nc*q, h) and dA (h) in f32; ws: ssd_chunk_bwd_workspace bytes,
// 256-byte aligned. All contiguous. Returns cudaGetLastError() after the
// launches (0 if none).
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             const void* dst, const void* ddi, void* dx,
                             void* ddt, void* dA, void* dB, void* dC,
                             void* ws, int b, int nc, int q, int h, int p,
                             int n, int dtype, void* stream) {
  if (b < 1 || nc < 1 || q < 1 || h < 1 || n < 1 || n > kMaxState ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(dst);
  const float* dif = static_cast<const float*>(ddi);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  char* w = static_cast<char*>(ws);
#define SSD_BWD(PP)                                                      \
  case PP:                                                               \
    return ssd_bwd::launch_bwd_typed<PP>(x, dtf, Af, B, C, dyf, dsf, dif, \
                                         dx, ddtf, dAf, dB, dC, w, b, nc, \
                                         q, h, n, dtype, st)
  switch (p) {
    SSD_BWD(8);
    SSD_BWD(16);
    SSD_BWD(32);
    SSD_BWD(64);
    SSD_BWD(128);
    SSD_BWD(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SSD_BWD
}
