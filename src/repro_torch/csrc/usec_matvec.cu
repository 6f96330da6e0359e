// Y(M, C) = X(M, K) @ W(K, C), fp32 accumulation, X fp32 or bf16.
//
// Replaces the TPU kernel repro.kernels.usec_matvec.usec_matvec_padded /
// _matvec_kernel. There the grid walked (M/bm, K/bk) tiles in order with the
// output tile resident across the K loop. Here one CTA computes one output
// row (and a tile of up to 8 columns): its 8 warps each reduce one eighth of
// K in registers (warp_dot.cuh), then one thread per column sums the 8
// partials from shared memory in a fixed order. Ragged M, K and C are
// handled in the kernel: the wrapper pads nothing, and X may be a strided
// view (row stride ldx), so a block of the staged tile buffer is read in
// place.
//
// Bound: memory. Each X element is used for C multiply-adds, so at the main
// path's C = 1 the kernel moves 4 bytes per 2 flops; the least time is
// (M*K*sizeof(X) + K*C*4 + M*C*4) / 3.35 TB/s. A main-path block is
// 20 x 6000 fp32, about 0.15 us of bytes: a launch costs more than that, so
// the per-block executor path pays a launch per block whatever the kernel
// does (the segmented kernel is the fix). Splitting K over the CTA's warps
// is what keeps a 20-row call from being latency-bound on a few SMs: 160
// warps with loads in flight instead of 20.
#include "warp_dot.cuh"

using usec::kColTile;
using usec::kThreads;
using usec::kWarp;

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
    matvec_kernel(const T* __restrict__ x, int ldx, const float* __restrict__ w,
                  int ldw, float* __restrict__ y, int ldy, int k, int c) {
  constexpr int kWarps = kThreads / kWarp;
  __shared__ float part[kWarps][CT];
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, c - c0);
  const int warp = threadIdx.x / kWarp;
  // Chunks of K are multiples of 8 elements, so every warp's chunk of a
  // 16-byte-aligned row starts 16-byte aligned (8 bf16 or 2 x 4 fp32).
  const int chunk = ((k + kWarps - 1) / kWarps + 7) & ~7;
  const int k0 = min(k, warp * chunk);
  const int k1 = min(k, k0 + chunk);
  float acc[CT];
  usec::warp_row_dot<T, CT>(x + (size_t)row * ldx + k0, k1 - k0,
                            w + (size_t)k0 * ldw + c0, ldw, nc, acc);
  if ((threadIdx.x & (kWarp - 1)) == 0) {
#pragma unroll
    for (int j = 0; j < CT; ++j) part[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += part[q][threadIdx.x];
    y[(size_t)row * ldy + c0 + threadIdx.x] = s;
  }
}

template <typename T>
static int launch(const void* x, int ldx, const void* w, int ldw, void* y,
                  int ldy, int m, int k, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows = (unsigned)m;
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  if (c == 1) {
    matvec_kernel<T, 1><<<dim3(rows, 1), kThreads, 0, s>>>(
        xp, ldx, wp, ldw, yp, ldy, k, c);
  } else {
    const unsigned col_tiles = (unsigned)((c + kColTile - 1) / kColTile);
    matvec_kernel<T, kColTile><<<dim3(rows, col_tiles), kThreads, 0, s>>>(
        xp, ldx, wp, ldw, yp, ldy, k, c);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int usec_matvec_f32(const void* x, int ldx, const void* w, int ldw,
                               void* y, int ldy, int m, int k, int c,
                               void* stream) {
  return launch<float>(x, ldx, w, ldw, y, ldy, m, k, c, stream);
}

extern "C" int usec_matvec_bf16(const void* x, int ldx, const void* w, int ldw,
                                void* y, int ldy, int m, int k, int c,
                                void* stream) {
  return launch<__nv_bfloat16>(x, ldx, w, ldw, y, ldy, m, k, c, stream);
}
