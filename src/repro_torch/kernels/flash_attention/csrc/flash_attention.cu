// Flash attention (forward) for Hopper (sm_90a): blocked online-softmax GQA
// attention, causal and/or sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_pallas (grid step body `_kernel`). It computes what that
// kernel computes, not its block schedule: q (b, sq, hq, d) against k, v
// (b, sk, hkv, d), positions arange on both sides, query head h reads KV head
// h / (hq / hkv), scores in f32 with scale 1/sqrt(d), causal mask
// k_pos <= q_pos, window mask k_pos > q_pos - window, masked scores -1e30 and
// masked probabilities exactly 0, f32 running max m, sum l and accumulator,
// out = acc / max(l, 1e-30) in q's dtype. A row that sees no key is zeros.
//
// Bound: operations. Causal prefill does 4 * b * hq * d flops per visible
// (query, key) pair; at (b, s, hq, hkv, d) = (1, 2048, 32, 8, 128) that is
// 34 GFLOP, 0.035 ms at the bf16 tensor-core peak of 989 TFLOP/s, while the
// bytes (q, k, v in, o out: 50 MB) take 0.015 ms at 3.35 TB/s.
//
// Design, simple first (wgmma/TMA and warp specialisation are later work):
//   * bf16, head dims 32 to 128: one block of 4 warps per (q tile of 64
//     rows, q head, batch);
//     each warp owns 16 query rows. Q is held in registers as mma.sync A
//     fragments. K/V tiles of 64 keys stream through shared memory with
//     cp.async, two stages, so tile j+1 loads while tile j computes; three
//     blocks share an SM (launch bounds: at most 170 registers, which
//     spills a few bytes at head dim 128; 3 x 70 KB of shared memory).
//     S = Q K^T and O += P V run on the tensor cores as
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate; K's and V's fragments
//     come from ldmatrix loads); P is rounded to bf16 for
//     the second product (the usual FlashAttention-2 choice; the Pallas
//     kernel multiplies in f32 - the difference is within the bf16
//     tolerance). The softmax statistics stay in f32 registers; the row sum
//     is kept per thread and reduced across the row's 4 lanes at the end.
//   * bf16, head dim 256 (RecurrentGemma): the O accumulator alone takes 128
//     registers a thread, so Q stays in shared memory (64 x 264 halves) and
//     its A fragments come from ldmatrix at each 16-wide step of d; K/V
//     tiles hold 32 keys (S is 16 registers), and two blocks share an SM
//     (launch bounds: at most 255 registers; 2 x 99 KB of shared memory).
//   * f32: no tensor-core path keeps f32 accuracy (TF32 keeps ~3 digits),
//     so one warp per query row, lane j scoring key j of a 32-key tile with
//     f32 FMAs from shared memory. Not on the serving path (bf16).
//   * Both skip key tiles that the causal or the window mask hides entirely
//     (a causal prefill does half the tiles), mask the ragged tail of q and
//     of k themselves (any sq, sk), and walk q tiles heaviest first; the
//     bf16 kernel computes no mask on tiles that every row sees whole.
//
// C interface, loaded with ctypes: every pointer and the stream are void*,
// the function returns cudaGetLastError() after the launch (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Problem {
  int sq, sk, hq, hkv, group;
  int causal, has_window, window;
  float scale_log2;  // log2(e) / sqrt(d): scores go through exp2
};

__device__ __forceinline__ bool visible(const Problem& p, int row, int col) {
  return col < p.sk && (!p.causal || col <= row) &&
         (!p.has_window || (long long)col > (long long)row - p.window);
}

// Key tiles [lo, hi) of `tile` keys that query rows [r0, r1] may see.
__device__ __forceinline__ void key_tiles(const Problem& p, int r0, int r1,
                                          int tile, int& lo, int& hi) {
  int last = p.sk - 1;
  if (p.causal && r1 < last) last = r1;
  int first = 0;
  if (p.has_window) {
    const long long f = (long long)r0 - p.window + 1;
    first = f < 0 ? 0 : (f > p.sk ? p.sk : (int)f);
  }
  lo = first / tile;
  hi = last < first ? lo : last / tile + 1;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// ------------------------------------------------------------------ bf16
constexpr int kBM = 64;     // query rows per block
constexpr int kWarps = 4;   // 16 query rows each

// Per head dim: keys per K/V tile, Q in shared memory (else registers), and
// blocks per SM for the launch bounds.
template <int D>
struct Tiling {
  static constexpr bool kWide = D > 128;
  static constexpr int kBN = kWide ? 32 : 64;
  static constexpr bool kQInSmem = kWide;
  static constexpr int kMinBlocks = kWide ? 2 : 3;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// c += a * b, m16n8k16, a row-major 16x16, b column-major 16x8, f32 c.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds, for lane (g, t) =
// (l / 4, l % 4), columns 2t and 2t+1 of row g of matrix i (ldmatrix_x4)
// or rows 2t and 2t+1 of column g (ldmatrix_x4_trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
constexpr int smem_bytes() {
  // K, V x 2 stages, and Q where it stays in shared memory
  return (2 * 2 * Tiling<D>::kBN + (Tiling<D>::kQInSmem ? kBM : 0)) *
         (D + 8) * (int)sizeof(__nv_bfloat16);
}

// One K tile and one V tile of kBN keys into shared memory (row stride
// D + 8 halves: conflict-free fragment reads); keys past sk are zeros.
template <int D>
__device__ __forceinline__ void load_kv(const __nv_bfloat16* kb,
                                        const __nv_bfloat16* vb,
                                        __nv_bfloat16* ks, __nv_bfloat16* vs,
                                        int key0, int sk, long long stride,
                                        int tid) {
  constexpr int LD = D + 8, CHUNKS = D / 8, kBN = Tiling<D>::kBN;
  for (int c = tid; c < kBN * CHUNKS; c += kWarps * 32) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool ok = key0 + r < sk;
    const long long off = ok ? (long long)(key0 + r) * stride + col : 0;
    cp_async16(ks + r * LD + col, kb + off, ok);
    cp_async16(vs + r * LD + col, vb + off, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32, Tiling<D>::kMinBlocks)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, Problem p) {
  constexpr int kBN = Tiling<D>::kBN;
  constexpr bool kQInSmem = Tiling<D>::kQInSmem;
  constexpr int LD = D + 8, KT = D / 16, NT = kBN / 8, OT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + 2 * kBN * LD;
  __nv_bfloat16* qs = vs + 2 * kBN * LD;  // [kBM][LD] where kQInSmem

  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const long long q_stride = (long long)p.hq * D;
  const long long kv_stride = (long long)p.hkv * D;
  const __nv_bfloat16* qb = q + ((long long)b * p.sq * p.hq + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * p.sk * p.hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long long)b * p.sk * p.hkv + hk) * D;
  __nv_bfloat16* ob = o + ((long long)b * p.sq * p.hq + h) * D;

  // Q as A fragments: rows row_a / row_b, columns 2t, 2t+1 (+8) of each
  // 16-wide slice of d; rows past sq are zeros. At head dim 256 Q goes to
  // shared memory with the first K/V tile instead, and each 16-wide slice
  // is loaded by ldmatrix where it is used.
  uint32_t qa[kQInSmem ? 1 : KT][4];
  if constexpr (kQInSmem) {
    for (int c = tid; c < kBM * (D / 8); c += kWarps * 32) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const bool ok = q0 + r < p.sq;
      cp_async16(qs + r * LD + col,
                 qb + (ok ? (long long)(q0 + r) * q_stride + col : 0), ok);
    }
  } else {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int c = kt * 16 + 2 * t;
      const bool a_ok = row_a < p.sq, b_ok = row_b < p.sq;
      qa[kt][0] = a_ok ? ld32(qb + row_a * q_stride + c) : 0u;
      qa[kt][1] = b_ok ? ld32(qb + row_b * q_stride + c) : 0u;
      qa[kt][2] = a_ok ? ld32(qb + row_a * q_stride + c + 8) : 0u;
      qa[kt][3] = b_ok ? ld32(qb + row_b * q_stride + c + 8) : 0u;
    }
  }

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  int lo, hi;
  key_tiles(p, q0, min(q0 + kBM, p.sq) - 1, kBN, lo, hi);
  if (lo < hi) load_kv<D>(kb, vb, ks, vs, lo * kBN, p.sk, kv_stride, tid);
  cp_async_commit();

  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {
      load_kv<D>(kb, vb, ks + (buf ^ 1) * kBN * LD, vs + (buf ^ 1) * kBN * LD,
                 (j + 1) * kBN, p.sk, kv_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt_s = ks + buf * kBN * LD;
    const __nv_bfloat16* vt_s = vs + buf * kBN * LD;

    // S = Q K^T: B[kk][n] = K[key n][dim kk]; one ldmatrix gives the B
    // fragments of two 8-key tiles.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int mi = lane / 8;
    const __nv_bfloat16* krow =
        kt_s + ((mi >> 1) * 8 + lane % 8) * LD + (mi & 1) * 8;
    if constexpr (kQInSmem) {
      // A fragments from shared Q: matrices (rows 0-7 | 8-15) x (dims 0-7
      // | 8-15) of the warp's 16 rows, in a[0..3] order
      const __nv_bfloat16* qrow =
          qs + (warp * 16 + (mi & 1) * 8 + lane % 8) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t qf[4];
        ldmatrix_x4(qf, qrow + kt * 16);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kb2[4];
          ldmatrix_x4(kb2, krow + nt * 8 * LD + kt * 16);
          mma16816(s[nt], qf, kb2[0], kb2[1]);
          mma16816(s[nt + 1], qf, kb2[2], kb2[3]);
        }
      }
    } else {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kb2[4];
          ldmatrix_x4(kb2, krow + nt * 8 * LD + kt * 16);
          mma16816(s[nt], qa[kt], kb2[0], kb2[1]);
          mma16816(s[nt + 1], qa[kt], kb2[2], kb2[3]);
        }
      }
    }

    // Mask (bit nt*4+e of vis), scale, running max over the row's 4 lanes.
    // A tile every row of the block sees whole needs no mask.
    const int key0 = j * kBN;
    const bool full =
        key0 + kBN <= p.sk && (!p.causal || key0 + kBN - 1 <= q0) &&
        (!p.has_window || (long long)key0 > (long long)q0 + kBM - 1 - p.window);
    uint32_t vis = ~0u;
    float mx_a = kNeg, mx_b = kNeg;
    if (full) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= p.scale_log2;
        mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
      }
    } else {
      vis = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + nt * 8 + 2 * t + (e & 1);
          const bool ok = visible(p, e < 2 ? row_a : row_b, col);
          vis |= (uint32_t)ok << (nt * 4 + e);
          s[nt][e] = ok ? s[nt][e] * p.scale_log2 : kNeg;
          if (e < 2) mx_a = fmaxf(mx_a, s[nt][e]);
          else mx_b = fmaxf(mx_b, s[nt][e]);
        }
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = (vis >> (nt * 4 + e)) & 1u
                             ? exp2f(s[nt][e] - (e < 2 ? m_a : m_b))
                             : 0.f;
        s[nt][e] = pe;
        if (e < 2) sum_a += pe;
        else sum_b += pe;
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      acc[i][0] *= al_a;
      acc[i][1] *= al_a;
      acc[i][2] *= al_b;
      acc[i][3] *= al_b;
    }

    // O += P V: the C fragments of S n-tiles 2kt, 2kt+1 are the A fragment
    // of P's 16-key slice kt; B[kk][n] = V[key kk][dim n], two 8-dim tiles
    // per transposed ldmatrix.
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      const uint32_t pa[4] = {pack(s[2 * kt][0], s[2 * kt][1]),
                              pack(s[2 * kt][2], s[2 * kt][3]),
                              pack(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      const __nv_bfloat16* vrow =
          vt_s + (kt * 16 + (mi & 1) * 8 + lane % 8) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int ot = 0; ot < OT; ot += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + ot * 8);
        mma16816(acc[ot], pa, vb[0], vb[1]);
        mma16816(acc[ot + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // buffer `buf` is refilled by the next iteration
  }
  if constexpr (kQInSmem) cp_async_wait<0>();  // Q's copy, if no tile ran

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 *= 2) {
    l_a += __shfl_xor_sync(~0u, l_a, o2);
    l_b += __shfl_xor_sync(~0u, l_b, o2);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    const int c = ot * 8 + 2 * t;
    if (row_a < p.sq)
      *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + c) =
          pack(acc[ot][0] / d_a, acc[ot][1] / d_a);
    if (row_b < p.sq)
      *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + c) =
          pack(acc[ot][2] / d_b, acc[ot][3] / d_b);
  }
}

// ------------------------------------------------------------------- f32
constexpr int kRows = 8;   // query rows per block, one warp each
constexpr int kKeys = 32;  // keys per tile, one lane each

template <int D>
__global__ void __launch_bounds__(kRows * 32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Problem p) {
  constexpr int PER = D / 32;  // output dims per lane
  // q rows [kRows][D], K tile [kKeys][D + 1], V tile [kKeys][D]: dynamic,
  // since head dim 256 needs 73 KB
  extern __shared__ float fsm[];
  float(*qs)[D] = reinterpret_cast<float(*)[D]>(fsm);
  float(*ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(fsm + kRows * D);
  float(*vs)[D] =
      reinterpret_cast<float(*)[D]>(fsm + kRows * D + kKeys * (D + 1));

  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int row = q0 + warp;
  const long long q_stride = (long long)p.hq * D;
  const long long kv_stride = (long long)p.hkv * D;
  const float* qb = q + ((long long)b * p.sq * p.hq + h) * D;
  const float* kb = k + ((long long)b * p.sk * p.hkv + hk) * D;
  const float* vb = v + ((long long)b * p.sk * p.hkv + hk) * D;
  float* ob = o + ((long long)b * p.sq * p.hq + h) * D;

  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < p.sq ? qb[(q0 + r) * q_stride + c] : 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  int lo, hi;
  key_tiles(p, q0, min(q0 + kRows, p.sq) - 1, kKeys, lo, hi);
  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < kKeys * D; i += blockDim.x) {
      const int r = i / D, c = i % D, key = j * kKeys + r;
      const bool ok = key < p.sk;
      ks[r][c] = ok ? kb[key * kv_stride + c] : 0.f;
      vs[r][c] = ok ? vb[key * kv_stride + c] : 0.f;
    }
    __syncthreads();
    const int col = j * kKeys + lane;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) s = fmaf(qs[warp][c], ks[lane][c], s);
    const bool ok = visible(p, row, col);
    s = ok ? s * p.scale_log2 : kNeg;
    const float mn = fmaxf(m, warp_max(s));
    const float alpha = exp2f(m - mn);
    const float pe = ok ? exp2f(s - mn) : 0.f;
    l = l * alpha + warp_sum(pe);
    m = mn;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
    for (int jj = 0; jj < kKeys; ++jj) {
      const float pj = __shfl_sync(~0u, pe, jj);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        acc[i] = fmaf(pj, vs[jj][lane + 32 * i], acc[i]);
    }
  }
  if (row < p.sq) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      ob[row * q_stride + lane + 32 * i] = acc[i] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           const Problem& p, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    constexpr int smem = smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.sq + kBM - 1) / kBM, p.hq, b);
    flash_fwd_bf16<D><<<grid, kWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), p);
  } else {
    constexpr int smem = (kRows * D + kKeys * (D + 1) + kKeys * D) *
                         (int)sizeof(float);
    if (smem > 48 * 1024) {  // head dim 256 only
      cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((p.sq + kRows - 1) / kRows, p.hq, b);
    flash_fwd_f32<D><<<grid, kRows * 32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (b, sq, hq, d); k, v: (b, sk, hkv, d); all contiguous, 16-byte
// aligned, of one dtype: 0 = float32, 1 = bf16. window is read only when
// has_window is set.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int sk, int hq, int hkv, int d, int causal,
                                   int has_window, int window, int dtype,
                                   void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 || b > 65535 ||
      hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Problem p{sq, sk, hq, hkv, hq / hkv, causal != 0, has_window != 0, window,
            0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      p.scale_log2 = kLog2e / sqrtf(32.f);
      return launch<32>(q, k, v, o, b, p, dtype, st);
    case 64:
      p.scale_log2 = kLog2e / sqrtf(64.f);
      return launch<64>(q, k, v, o, b, p, dtype, st);
    case 128:
      p.scale_log2 = kLog2e / sqrtf(128.f);
      return launch<128>(q, k, v, o, b, p, dtype, st);
    case 256:
      p.scale_log2 = kLog2e / sqrtf(256.f);
      return launch<256>(q, k, v, o, b, p, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
