// Softmax attention with an online softmax over KV tiles (flash attention),
// forward only, bf16 q/k/v on Hopper's tensor cores. q: (b, h, sq, d);
// k, v: (b, hk, skv, d) with hk | h (GQA: kv head = q head / (h / hk));
// out: (b, h, sq, d) contiguous bf16. Causal masking is aligned to the end
// of the KV sequence (query row r sits at KV position r + skv - sq), an
// optional sliding window keeps keys k > q - window, and keys at or past
// skv are masked in the kernel. The fp32 instance stays in
// flash_attention.cu (fp32 FFMA, the reference's fp32 rounding).
//
// Replaces the TPU kernel repro.kernels.flash_attention.flash_attention_padded
// / _flash_kernel, whose grid walked (b*h, sq/bq, skv/bk) with the KV axis
// sequential and m, l and the accumulator resident in VMEM. Here one CTA
// owns one (batch, head, 128-row query block), heaviest causal blocks first,
// and loops over only its live KV tiles (causal and window bound the range:
// the counterpart of pl.when(live)). Semantics follow _flash_kernel: the
// running max starts at the finite -1e30 and a masked score never raises it
// (here a masked score is -inf, where _flash_kernel writes -1e30: the max
// comes out the same), masked probabilities are exactly 0, the denominator
// is clamped at 1e-30 (a query with no live key returns exactly 0), m, l and
// the accumulator are fp32, and the output is rounded once to bf16.
//
// Bound on the H100: operations. Causal prefill does 4*d FLOPs per live
// (query, key) pair; at the model path's (1, 32, 8192, 128) layer that is
// 0.55 TFLOP against 0.14 GB, 0.556 ms at the bf16 tensor-core peak (989
// TFLOP/s) and 0.04 ms of bytes. The FFMA design topped out at the 67
// TFLOP/s fp32 peak; this one runs both products on wgmma:
//
// - Warp specialisation: 3 warpgroups. Warpgroups 0 and 1 (consumers) own
//   64 query rows each; one thread of warpgroup 2 (producer) issues every
//   load. setmaxnreg gives the consumers 240 registers, the producer 24.
// - TMA: Q once per CTA, K and V tiles (128 keys for d <= 128, 64 for
//   d = 256) into a 2-stage ring; K and V of a stage each have a full
//   mbarrier (the TMA's bytes) and an empty one (the 8 consumer warps). The
//   tensor maps are built on the host per call over the strided
//   (b, heads, rows, d) views, so the model's (B, S, H, d) activations are
//   read in place; rows past sq / skv and columns past d arrive as zeros, so
//   nothing is padded in memory. Tiles land 128-byte swizzled, in panels of
//   64 columns (d = 32 and 80 are zero-padded to 64 and 128 in shared
//   memory; zero columns add nothing to Q.K^T).
// - S = Q.K^T: m64nBKk16 wgmma, A = Q and B = K from shared memory, both
//   K-major (d-contiguous). Products of bf16 values are exact in fp32, so S
//   differs from the reference only in the fp32 sum order.
// - Softmax in registers, in wgmma's accumulator layout: a row lives in the
//   4 threads of a quad, so its max takes two xor shuffles; the scale and
//   log2(e) fold into one FFMA before each ex2. Only tiles on the causal
//   diagonal, the window edge or the skv edge evaluate the mask.
// - Overlap: a consumer issues tile t's Q.K^T and tile t-1's P.V together
//   and waits only for the scores, so the tensor cores run P.V while it
//   computes tile t's softmax (the first tile is peeled off the loop, so
//   ptxas sees straight-line waits and does not serialize the wgmmas).
// - P.V on wgmma with P split in two: P_hi = bf16(p), P_lo = bf16(p - P_hi),
//   both from registers (the S accumulator layout is the A-fragment layout),
//   B = V from shared memory with the transpose flag (V is d-contiguous).
//   The two products go into one fp32 accumulator in a fixed order. A
//   single bf16 P misses the smoke's bf16 limit (rtol 1e-2, atol 1e-4) on
//   1-3 % of outputs; the split keeps p to about 16 bits and the error to
//   one output ulp, for 6*d FLOPs issued per pair instead of 4*d. l sums
//   the fp32 p.
// - No atomics and no sum across CTAs: two runs give the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int kBQ = 128;                       // query rows per CTA
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kPanelCols = 64;                 // bf16 columns per 128-byte row
constexpr int kRowBytes = 128;
constexpr float kNegInf = -1e30f;              // _flash_kernel's NEG_INF
// Launch entry codes above the CUDA error range: the tensor map was refused.
constexpr int kEncodeError = 10000;

template <int D>
struct Tile {
  static constexpr int kDP = (D + kPanelCols - 1) / kPanelCols * kPanelCols;
  static constexpr int kPanels = kDP / kPanelCols;
  static constexpr int kBK = D > 128 ? 64 : 128;    // keys per KV tile
  static constexpr int kQSteps = (D + 15) / 16;     // k-steps of Q.K^T
  static constexpr int kQPanel = kBQ * kRowBytes;   // bytes of one Q panel
  static constexpr int kKVPanel = kBK * kRowBytes;  // ... of one K/V panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKVPanel;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // 1024 bytes of slack to align the base to the 128-byte swizzle's atom.
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 4 * kStages);
};

struct Params {
  void* out;
  int h, hk, sq, skv;
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // softmax scale * log2(e): p = 2^((s - m) * scale_log2)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ----
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that outlasts
// ~10 s of clock cycles traps, so a broken pipeline fails the launch instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  constexpr long long kWatchdogCycles = 20000000000LL;
  long long start = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) {
      start = clock64();
    } else if ((n & 1023) == 0 && clock64() - start > kWatchdogCycles) {
      __trap();
    }
  }
}

// One box of a 4-D tensor map (innermost coordinate first) into shared
// memory, completing `bytes` of the mbarrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// ---- wgmma m64nNk16, bf16 in, fp32 accumulate (scale_d = 0: D = A.B) ----
// d[0:32] += A(64x16, smem) * B(16x64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:64] += A(64x16, smem) * B(16x128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:32] += A(64x16, registers) * B(16x64, smem, N-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// d[0:64] += A(64x16, registers) * B(16x128, smem, N-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// d[0:128] += A(64x16, registers) * B(16x256, smem, N-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// 2^x on the SFU (ex2.approx: relative error ~2^-22, far below a bf16 ulp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<D>;
  constexpr int kBK = T::kBK;
  constexpr int kS = kBK / 2;     // score accumulators per thread
  constexpr int kO = T::kDP / 2;  // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::kQBytes;             // kStages K tiles
  const uint32_t sV = sK + kStages * T::kKVBytes;  // kStages V tiles
  // mbarriers: Q full, then per stage K full, V full, K empty, V empty.
  const uint32_t bar_q = base + T::kBarOffset;
  auto bar = [&](int kind, int s) {
    return bar_q + 8u * (1 + kind * kStages + s);
  };
  enum { kKFull, kVFull, kKEmpty, kVEmpty };

  const int b = blockIdx.x / p.h;
  const int hq = blockIdx.x % p.h;
  const int hkv = hq / (p.h / p.hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first

  // The CTA's live KV range: _flash_kernel's `live` test.
  const int offs = p.skv - p.sq;
  int k_begin = 0;
  int k_end = p.skv;
  if (p.causal) k_end = min(k_end, min(q0 + kBQ, p.sq) - 1 + offs + 1);
  if (p.window > 0) k_begin = max(0, q0 + offs - p.window + 1);
  const int t_begin = k_begin / kBK;
  const int n_tiles = k_end > k_begin ? (k_end + kBK - 1) / kBK - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(kKFull, s), 1);
      mbar_init(bar(kVFull, s), 1);
      mbar_init(bar(kKEmpty, s), 4 * kConsumers);  // one arrival per warp
      mbar_init(bar(kVEmpty, s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ======== producer: one thread issues every TMA load ========
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int c = 0; c < T::kPanels; ++c) {
        tma_load(sQ + c * T::kQPanel, &tq, bar_q, c * kPanelCols, q0, hq, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t used = ((it / kStages) - 1) & 1;  // the phase to free
        const int k0 = (t_begin + it) * kBK;
        if (it >= kStages) mbar_wait(bar(kKEmpty, s), used);
        mbar_expect_tx(bar(kKFull, s), T::kKVBytes);
        for (int c = 0; c < T::kPanels; ++c) {
          tma_load(sK + s * T::kKVBytes + c * T::kKVPanel, &tk, bar(kKFull, s),
                   c * kPanelCols, k0, hkv, b);
        }
        if (it >= kStages) mbar_wait(bar(kVEmpty, s), used);
        mbar_expect_tx(bar(kVFull, s), T::kKVBytes);
        for (int c = 0; c < T::kPanels; ++c) {
          tma_load(sV + s * T::kKVBytes + c * T::kKVPanel, &tv, bar(kVFull, s),
                   c * kPanelCols, k0, hkv, b);
        }
      }
    }
  } else {
    // ======== consumers: 64 query rows per warpgroup ========
    // Tile t's scores are issued together with tile t-1's P.V, so the
    // tensor cores work on P.V while this warpgroup does tile t's softmax.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // Accumulator element i of this thread sits at row row0 + 8 * ((i/2)%2)
    // and column 8 * (i/4) + col0 + i%2 (wgmma's m64nN fp32 layout).
    const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
    const int col0 = (lane & 3) * 2;
    const int pos0 = row0 + offs;  // KV position of query row row0
    // The warpgroup's query positions, for the per-tile mask test.
    const int wq_lo = q0 + wg * 64 + offs;
    const int wq_hi = wq_lo + 63;
    const uint32_t sQw = sQ + wg * 64 * kRowBytes;

    float o[kO];
    zero(o);
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    // P split into two bf16 A fragments per 16 keys: element pairs (8j, 8j+1),
    // (8j+2, 8j+3), (8j+4, 8j+5), (8j+6, 8j+7) of the score accumulator are
    // registers a0..a3 of k-step j.
    uint32_t p_hi[kBK / 16][4];
    uint32_t p_lo[kBK / 16][4];

    // S = Q . K^T of tile slot s, issued as one wgmma group.
    // The first k-step overwrites sc (scale_d = 0): no other instruction
    // may write the accumulator inside the wgmma pipeline, or ptxas
    // serializes it.
    auto issue_scores = [&](float (&sc)[kS], int s) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T::kQSteps; ++j) {
        const uint32_t off = (j / 4) * T::kQPanel + (j % 4) * 32;
        const uint32_t offk = (j / 4) * T::kKVPanel + (j % 4) * 32;
        wgmma_ss(sc, smem_desc(sQw + off, 16, 1024),
                 smem_desc(sK + s * T::kKVBytes + offk, 16, 1024), j > 0);
      }
      wgmma_commit();
    };
    // O += P_hi . V, then O += P_lo . V, per 16 keys of V slot s.
    auto issue_pv = [&](int s) {
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        // V rows 16j..16j+15; the next 64 columns sit one panel further.
        const uint64_t dv = smem_desc(
            sV + s * T::kKVBytes + j * 16 * kRowBytes, T::kKVPanel, 1024);
        wgmma_rs(o, p_hi[j], dv, 1);
        wgmma_rs(o, p_lo[j], dv, 1);
      }
      wgmma_commit();
    };
    // Online softmax of the tile at k0, in sc: mask where needed, the new
    // row max m (of the raw scores), p = 2^((s - m) * scale_log2) in place
    // (one FFMA and one ex2 per score), this thread's row sums rs, and
    // alpha = 2^((m_old - m_new) * scale_log2) per row.
    auto softmax = [&](float (&sc)[kS], int k0, float (&alpha)[2],
                       float (&rs)[2]) {
      const bool full = k0 + kBK <= p.skv &&
                        (!p.causal || k0 + kBK - 1 <= wq_lo) &&
                        (p.window <= 0 || k0 > wq_hi - p.window);
      auto live = [&](int i) {
        const int kp = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int qp = pos0 + 8 * ((i >> 1) & 1);
        return kp < p.skv && (!p.causal || kp <= qp) &&
               (p.window <= 0 || kp > qp - p.window);
      };
      // A masked score becomes -inf here: it never raises the running max
      // (which starts at the finite -1e30, so a row with no live key keeps
      // m = -1e30 and l = 0 and returns 0), and 2^-inf is exactly the 0
      // that _flash_kernel gives a masked probability.
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        sc[i] = (full || live(i)) ? sc[i] : __int_as_float(0xff800000);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float mc[2];  // the running max in the exponent's units
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2((m[r] - m_new) * p.scale_log2);
        mc[r] = m_new * p.scale_log2;
        m[r] = m_new;
        rs[r] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], p.scale_log2, -mc[r]));
        rs[r] += sc[i];
      }
    };
    // Fold a tile's alpha and row sums into l and O, and split its p.
    auto update = [&](const float (&sc)[kS], const float (&alpha)[2],
                      const float (&rs)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < kS; i += 2) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[i], sc[i + 1]);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(sc[i] - hf.x, sc[i + 1] - hf.y);
        p_hi[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      float alpha[2];
      float rs[2];
      {  // the first tile: scores and softmax only
        mbar_wait(bar(kKFull, 0), 0);
        float sc[kS];
        issue_scores(sc, 0);
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(bar(kKEmpty, 0));
        softmax(sc, t_begin * kBK, alpha, rs);
        update(sc, alpha, rs);
      }
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int sp = (it - 1) % kStages;  // the previous tile's slot
        mbar_wait(bar(kKFull, s), (it / kStages) & 1);
        float sc[kS];
        issue_scores(sc, s);
        mbar_wait(bar(kVFull, sp), ((it - 1) / kStages) & 1);
        issue_pv(sp);
        wgmma_wait<1>();  // the scores are in; P.V may still run
        if (lane == 0) mbar_arrive(bar(kKEmpty, s));
        softmax(sc, (t_begin + it) * kBK, alpha, rs);
        wgmma_wait<0>();  // the previous tile's P.V is done with O and P
        fence_regs(o);
        fence_regs(p_hi);
        fence_regs(p_lo);
        if (lane == 0) mbar_arrive(bar(kVEmpty, sp));
        update(sc, alpha, rs);
      }
      const int s = (n_tiles - 1) % kStages;
      mbar_wait(bar(kVFull, s), ((n_tiles - 1) / kStages) & 1);
      issue_pv(s);
      wgmma_wait<0>();
      fence_regs(o);
    }

    // ---- epilogue: O / max(l, 1e-30), rounded once to bf16 ----
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) +
                        ((long long)b * p.h + hq) * p.sq * D;
#pragma unroll
    for (int c = 0; c < kO / 4; ++c) {
      const int col = 8 * c + col0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (col < D && row < p.sq) {
          *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * D + col) =
              __floats2bfloat162_rn(o[4 * c + 2 * r] / den[r],
                                    o[4 * c + 2 * r + 1] / den[r]);
        }
      }
    }
  }
}

// ---- host: tensor maps and launch ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library needs no link against libcuda.
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
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A bf16 (batch, heads, rows, d) view with element strides (sb, sh, ss) and
// unit stride on d, cut into boxes of 64 columns x box_rows rows, 128-byte
// swizzled; reads past rows or d fill zeros. Returns 0 or kEncodeError + the
// driver's code (kEncodeError alone: no entry point).
int make_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
             int batch, long long sb, long long sh, long long ss,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeError;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, long long q_sb,
           long long q_sh, long long q_ss, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           int batch, const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, D, p.sq, p.h, batch, q_sb, q_sh, q_ss, kBQ);
  if (rc == 0) {
    rc = make_map(&tk, k, D, p.skv, p.hk, batch, k_sb, k_sh, k_ss, T::kBK);
  }
  if (rc == 0) {
    rc = make_map(&tv, v, D, p.skv, p.hk, batch, v_sb, v_sh, v_ss, T::kBK);
  }
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch * p.h),
                  static_cast<unsigned>((p.sq + kBQ - 1) / kBQ));
  flash_tc_kernel<D><<<grid, kThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_tc_bf16(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int batch,
    int h, int hk, int sq, int skv, int d, int causal, int window, float scale,
    void* stream) {
  const Params p{out, h, hk, sq, skv, causal, window,
                 scale * 1.4426950408889634f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_TC_ARGS                                                      \
  q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, batch, p, \
      s
  switch (d) {
    case 32: return launch<32>(FLASH_TC_ARGS);
    case 64: return launch<64>(FLASH_TC_ARGS);
    case 80: return launch<80>(FLASH_TC_ARGS);
    case 128: return launch<128>(FLASH_TC_ARGS);
    case 256: return launch<256>(FLASH_TC_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_TC_ARGS
}
