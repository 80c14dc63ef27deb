// Flash attention (forward) for Hopper (sm_90a): blocked online-softmax GQA
// attention, causal and/or sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_pallas (grid step body `_kernel`). It computes what that
// kernel computes, not its block schedule: q (b, sq, hq, d) against k, v
// (b, sk, hkv, d), positions arange on both sides, query head h reads KV head
// h / (hq / hkv), scores in f32 with scale 1/sqrt(d), causal mask
// k_pos <= q_pos, window mask k_pos > q_pos - window, masked probabilities
// exactly 0 (its masked scores are -1e30), f32 running max m, sum l and
// accumulator, out = acc / max(l, 1e-30) in q's dtype. A row that sees no
// key is zeros.
//
// Bound: operations. Causal prefill does 4 * b * hq * d flops per visible
// (query, key) pair; at (b, s, hq, hkv, d) = (1, 2048, 32, 8, 128) that is
// 34 GFLOP, 0.035 ms at the bf16 tensor-core peak of 989 TFLOP/s, while the
// bytes (q, k, v in, o out: 50 MB) take 0.015 ms at 3.35 TB/s. Only wgmma
// reaches that peak, so the bf16 path is built around it:
//
//   * bf16, head dims 32, 64, 128 and 256, one template. A block of three
//     warpgroups owns a tile of 128 query rows of one (batch, q head).
//     Warpgroup 0 is the producer: after `setmaxnreg` gives its registers
//     away, one thread loads Q once and then keeps K and V tiles in flight
//     with TMA (cp.async.bulk.tensor over 4-D tensor maps of the (b, s, h,
//     d) tensors) through a K ring and a V ring of two stages each, every
//     stage with a full and an empty mbarrier: a K stage is released as
//     soon as S has read it, a V stage after P V. Warpgroups 1 and 2 are
//     the consumers (240 registers each); each owns 64 query rows and, for
//     key tile j:
//       S_j = Q K_j^T      wgmma, both operands in shared memory (K-major),
//       O += P_j-1 V_j-1   wgmma with P from registers (bf16 A fragments)
//                          and V read from shared memory as an MN-major B
//                          operand (no transposed copy), issued right
//                          after S_j, so it runs while the softmax of S_j
//                          is computed in f32 registers, as before;
//     then O is rescaled to the new row maxima and P_j is rounded to bf16
//     and repacked as the next A operand (the accumulator and A-fragment
//     layouts agree). The softmax is lean (in the first version of this
//     design it, not the products, held the kernel back on an H100):
//     masks only on tiles that some row sees in part, as a visible column
//     range per row; masked scores -inf, so exp2 gives their exact 0
//     without a test; the scale folded into one FMA; exp2 on the
//     special-function unit (ex2.approx, about 2 ulp, far below P's bf16
//     rounding). The two consumers take turns to issue their products
//     (two named barriers), so one's softmax overlaps the other's products
//     (FlashAttention-3's schedule). Shared tiles are stored as TMA writes
//     them: rows of 64 columns (128 bytes, 128-byte swizzle; head dim 32:
//     64 bytes, 64-byte swizzle), one such panel per 64 columns of d, the
//     layout the wgmma descriptors name. TMA zero-fills rows past sq and
//     sk; the kernel masks the ragged tail, causal and window itself, and
//     both consumers walk every key tile of the block (a tile that hides
//     all of one consumer's rows adds zeros), which keeps their turns in
//     step. Key tiles hold 128 keys (head dim 256: 64, so that the 64 x 256
//     f32 O accumulator, S and P fit in 240 registers). The output goes
//     back through the consumer's own Q rows in shared memory and a TMA
//     store, which clips rows past sq.
//   * f32: no tensor-core path keeps f32 accuracy (TF32 keeps ~3 digits),
//     so one warp per query row, lane j scoring key j of a 32-key tile with
//     f32 FMAs from shared memory. Not on the serving path (bf16).
//   * Both skip key tiles that the causal or the window mask hides entirely
//     (a causal prefill does half the tiles), mask the ragged tail of q and
//     of k themselves (any sq, sk), and start the heaviest q tiles first.
//
// The tensor maps are encoded on the host at each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no link
// against libcuda), and passed as __grid_constant__ parameters.
//
// C interface, loaded with ctypes: every pointer and the stream are void*,
// the function returns cudaGetLastError() after the launch (0 if none).

#include <cuda.h>
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

// The keys [lo, hi] query row `row` sees (lo > hi: none).
__device__ __forceinline__ void visible_cols(const Problem& p, int row,
                                             int& lo, int& hi) {
  hi = p.causal && row < p.sk - 1 ? row : p.sk - 1;
  lo = 0;
  if (p.has_window) {
    const long long f = (long long)row - p.window + 1;
    lo = f < 0 ? 0 : (f > p.sk ? p.sk : (int)f);
  }
}

// 2^x by the special-function unit (ex2.approx, flushing subnormals):
// about 2 ulp, far below the bf16 rounding of P; 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
constexpr int kBM = 128;      // query rows per block: 64 per consumer
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kStages = 2;     // K ring and V ring

template <int D>
struct Tiling {
  static constexpr int kBN = D > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kPanel = D < 64 ? D : 64;  // columns per panel
  static constexpr int kRowB = kPanel * 2;        // bytes per panel row
  static constexpr int kPanels = D / kPanel;
  // wgmma layout type and TMA swizzle of a panel: 128- or 64-byte rows
  static constexpr uint64_t kLayout = kRowB == 128 ? 1 : 2;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // one K (or V) tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes +
                               8 * (4 * kStages + 1);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in .x
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mbarriers (shared::cta), TMA, wgmma and register-count helpers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// Waits for the phase of the given parity to complete. A wait that lasts
// some 20 s is a fault of the kernel (a tile never loaded or released): it
// traps, so the launch fails instead of hanging the card.
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
    if (start == 0) start = clock64();
    else if (clock64() - start > 40000000000LL) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One box of a 4-D tensor map at (c0, c1, c2, c3), innermost first, into
// shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a panel: start address, leading and
// stride byte offsets, layout type (1: 128-byte swizzle, 2: 64-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait
// for the asynchronous products that write it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps a register A operand alive (its registers unreused) until the
// wait for the products that read it.
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The wgmma products, bf16 in, f32 accumulator of N / 2 registers a thread
// for an m64nNk16 product (one overload per N the kernel uses).
// S (+)= Q K^T, m64n64k16: A and B (K-major) from shared memory; S is
// zeroed first unless `accumulate`
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// S (+)= Q K^T, m64n128k16: A and B (K-major) from shared memory; S is
// zeroed first unless `accumulate`
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O += P V, m64n32k16: A (P) from registers, B (V, MN-major) from
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V, m64n64k16: A (P) from registers, B (V, MN-major) from
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V, m64n128k16: A (P) from registers, B (V, MN-major) from
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V, m64n256k16: A (P) from registers, B (V, MN-major) from
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap qm,
                   const __grid_constant__ CUtensorMap km,
                   const __grid_constant__ CUtensorMap vm,
                   const __grid_constant__ CUtensorMap om, Problem p) {
  using T = Tiling<D>;
  constexpr int kBN = T::kBN, kPanel = T::kPanel, kRowB = T::kRowB;
  constexpr uint32_t kSbo = 8 * kRowB;  // 8 rows of a panel
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: a swizzle pattern repeats every 8 panel rows
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t qs = base;                    // [panel][kBM][kPanel]
  const uint32_t ks = qs + T::kQBytes;         // [stage][panel][kBN][kPanel]
  const uint32_t vs = ks + kStages * T::kKVBytes;
  const uint32_t bars = vs + kStages * T::kKVBytes;
  // mbarriers: K full, V full, K empty, V empty (one per stage each), Q
  auto bar = [&](int kind, int s) { return bars + 8 * (kind * kStages + s); };
  const uint32_t qbar = bars + 8 * 4 * kStages;
  constexpr int kFullK = 0, kFullV = 1, kEmptyK = 2, kEmptyV = 3;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.group;
  const int tid = threadIdx.x, wg = tid / 128;
  // q tiles are the grid's slowest dimension, heaviest first: the last
  // blocks to start are the lightest of every head
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  int lo, hi;
  key_tiles(p, q0, min(q0 + kBM, p.sq) - 1, kBN, lo, hi);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(kFullK, s), 1);
      mbar_init(bar(kFullV, s), 1);
      mbar_init(bar(kEmptyK, s), 8);  // one arrival per consumer warp
      mbar_init(bar(kEmptyV, s), 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && lo < hi) {
      mbar_expect(qbar, T::kQBytes);
      for (int c = 0; c < T::kPanels; ++c)
        tma_load(qs + c * kBM * kRowB, &qm, c * kPanel, h, q0, b, qbar);
      for (int j = lo; j < hi; ++j) {
        const int i = j - lo, s = i % kStages;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        const uint32_t kt = ks + s * T::kKVBytes, vt = vs + s * T::kKVBytes;
        mbar_wait(bar(kEmptyK, s), free_parity);
        mbar_expect(bar(kFullK, s), T::kKVBytes);
        for (int c = 0; c < T::kPanels; ++c)
          tma_load(kt + c * kBN * kRowB, &km, c * kPanel, hk, j * kBN, b,
                   bar(kFullK, s));
        mbar_wait(bar(kEmptyV, s), free_parity);
        mbar_expect(bar(kFullV, s), T::kKVBytes);
        for (int c = 0; c < T::kPanels; ++c)
          tma_load(vt + c * kBN * kRowB, &vm, c * kPanel, hk, j * kBN, b,
                   bar(kFullV, s));
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1, ltid = tid - 128 * wg;
    const int warp = ltid / 32, lane = ltid % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group, column
    const int row0 = q0 + 64 * w;
    const int row_a = row0 + 16 * warp + g, row_b = row_a + 8;
    const uint32_t qw = qs + 64 * w * kRowB;  // this warpgroup's Q rows
    // The two consumers take turns to issue their products (named
    // barriers 3 and 4: each waits on its own and releases the other's),
    // so one's products run while the other computes its softmax.
    auto turn_wait = [&] {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + w) : "memory");
    };
    auto turn_pass = [&] {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - w) : "memory");
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    uint32_t pa[kBN / 16][4];  // P of the previous tile, bf16 A fragments

    // O += P V for the tile in stage s: V's 16-key slice kk as an MN-major
    // B operand; panels of 64 columns are kBN rows apart (leading offset)
    auto issue_pv = [&](int s) {
      const uint32_t vt = vs + s * T::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs(o, pa[kk], make_desc(vt + kk * 16 * kRowB, kBN * kRowB,
                                      kSbo, T::kLayout));
    };

    if (lo < hi) {
      mbar_wait(qbar, 0);
      if (w == 1) turn_pass();  // the first turn is consumer 0's
    }
    for (int j = lo; j < hi; ++j) {
      const int i = j - lo, s = i % kStages;
      const int sp = (i + kStages - 1) % kStages;  // the previous tile's
      mbar_wait(bar(kFullK, s), (i / kStages) & 1);
      if (i > 0) mbar_wait(bar(kFullV, sp), ((i - 1) / kStages) & 1);
      const uint32_t kt = ks + s * T::kKVBytes;

      // S = Q K^T over d in steps of 16 (32 bytes inside a panel row),
      // then O += P V of the previous tile, issued back to back
      float sc[kBN / 2];
      turn_wait();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / kPanel, off = (kk * 16 % kPanel) * 2;
        wgmma_ss(sc, make_desc(qw + c * kBM * kRowB + off, 16, kSbo,
                               T::kLayout),
                 make_desc(kt + c * kBN * kRowB + off, 16, kSbo, T::kLayout),
                 kk > 0);
      }
      wgmma_commit();
      if (i > 0) issue_pv(sp);
      wgmma_commit();  // (empty for the first tile)
      turn_pass();
      // S's group is the older of the two: all but the newest done = S done
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin(sc);
      if (lane == 0) mbar_arrive(bar(kEmptyK, s));  // S has read K

      // Masked scores become -inf, so their probabilities come out as
      // exactly 0; a tile every row of the warpgroup sees whole needs no
      // mask. Register 4 n8 + e holds row (e < 2 ? row_a : row_b), column
      // 8 n8 + 2t + (e & 1) of the tile. The running max is kept in
      // log2 units (scaled); a row that has seen no key yet keeps -inf
      // and exponentiates against 0.
      const int key0 = j * kBN;
      const bool whole =
          key0 + kBN <= p.sk && (!p.causal || key0 + kBN - 1 <= row0) &&
          (!p.has_window ||
           (long long)key0 > (long long)row0 + 63 - p.window);
      if (!whole) {
        int lo_a, hi_a, lo_b, hi_b;
        visible_cols(p, row_a, lo_a, hi_a);
        visible_cols(p, row_b, lo_b, hi_b);
#pragma unroll
        for (int r = 0; r < kBN / 2; ++r) {
          const int col = key0 + 8 * (r / 4) + 2 * t + (r & 1);
          const bool ok = (r & 2) ? col >= lo_b && col <= hi_b
                                  : col >= lo_a && col <= hi_a;
          if (!ok) sc[r] = -INFINITY;
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) {
        if (r & 2) mx_b = fmaxf(mx_b, sc[r]);
        else mx_a = fmaxf(mx_a, sc[r]);
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 *= 2) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, o2));
      }
      const float mn_a = fmaxf(m_a, mx_a * p.scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * p.scale_log2);
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = fast_exp2(m_a - mu_a), al_b = fast_exp2(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) {
        sc[r] = fast_exp2(fmaf(sc[r], p.scale_log2, (r & 2) ? -mu_b : -mu_a));
        if (r & 2) sum_b += sc[r];
        else sum_a += sc[r];
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;

      // the previous tile's P V has landed in O: release its V, rescale O
      // to the new maxima and make this tile's P the next A operand (keys
      // 16kk..16kk+15 are S registers 8kk..8kk+7: the accumulator and
      // A-operand layouts agree)
      wgmma_wait_all();
      pin(o);
      pin(pa);
      if (i > 0 && lane == 0) mbar_arrive(bar(kEmptyV, sp));
#pragma unroll
      for (int r = 0; r < D / 2; ++r) o[r] *= (r & 2) ? al_b : al_a;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }
    if (lo < hi) {  // the last tile's P V
      const int i = hi - lo, sp = (i - 1) % kStages;
      mbar_wait(bar(kFullV, sp), ((i - 1) / kStages) & 1);
      turn_wait();
      wgmma_fence();
      issue_pv(sp);
      wgmma_commit();
      if (w == 0) turn_pass();  // consumer 1 has no turn left to wait for
      wgmma_wait_all();
      pin(o);
      pin(pa);
      if (lane == 0) mbar_arrive(bar(kEmptyV, sp));
    }

    // out = acc / l, as bf16 into this warpgroup's Q rows (swizzled as the
    // tensor map expects), then one TMA store per panel
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 *= 2) {
      l_a += __shfl_xor_sync(~0u, l_a, o2);
      l_b += __shfl_xor_sync(~0u, l_b, o2);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    constexpr uint32_t kMask = kRowB == 128 ? 7 : 3;
#pragma unroll
    for (int r = 0; r < D / 2; r += 2) {
      const int col = 8 * (r / 4) + 2 * t, c = col / kPanel;
      const int row = 16 * warp + g + ((r & 2) ? 8 : 0);
      const float inv = (r & 2) ? inv_b : inv_a;
      uint32_t off = row * kRowB + (col % kPanel) * 2;
      off ^= ((off >> 7) & kMask) << 4;
      *reinterpret_cast<uint32_t*>(smem + (qw - base) + c * kBM * kRowB +
                                   off) = pack(o[r] * inv, o[r + 1] * inv);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
    if (ltid == 0) {
      for (int c = 0; c < T::kPanels; ++c)
        tma_store(&om, qw + c * kBM * kRowB, c * kPanel, h, row0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
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


// cuTensorMapEncodeTiled from libcuda, through the runtime's entry-point
// query: the library needs no link against it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D bf16 map over a contiguous (b, s, h, d) tensor, boxes of `rows`
// positions by `panel` columns of one head, swizzled as the panel's row
// width asks (128 or 64 bytes). Rows past s read as zeros and are not
// written.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int b,
              int s, int h, int d, int rows, int panel) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)panel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             panel * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           const Problem& p, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    using T = Tiling<D>;
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap qm, km, vm, om;
    if (!make_map(enc, &qm, q, b, p.sq, p.hq, D, kBM, T::kPanel) ||
        !make_map(enc, &km, k, b, p.sk, p.hkv, D, T::kBN, T::kPanel) ||
        !make_map(enc, &vm, v, b, p.sk, p.hkv, D, T::kBN, T::kPanel) ||
        !make_map(enc, &om, o, b, p.sq, p.hq, D, 64, T::kPanel))
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(p.hq, b, (p.sq + kBM - 1) / kBM);
    flash_fwd_bf16<D><<<grid, kThreads, T::kSmem, st>>>(qm, km, vm, om, p);
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
