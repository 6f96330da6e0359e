// Y(M, C) = X(M, K) @ W(K, C), fp32 accumulation, X fp32 or bf16.
//
// Replaces the TPU kernel repro.kernels.usec_matvec.usec_matvec_padded /
// _matvec_kernel. There the grid walked (M/bm, K/bk) tiles in order with the
// output tile resident across the K loop. Here K is split across a thread
// block cluster: 8 CTAs per (output row, tile of up to 8 columns), each
// reducing one eighth of K with its 4 warps (warp_dot.cuh; at K = 6000 a CTA
// reads 750 values, one or two 16-byte loads per thread, all in flight at
// once). Each CTA sums its warps' partials in a fixed order into shared
// memory; rank 0 of the cluster then reads the 8 CTA partials through
// distributed shared memory in rank order and writes the row. No atomics
// and no global scratch, so the sum order is fixed and two runs give the
// same bits. Ragged M, K and C are handled in the kernel: the wrapper pads
// nothing, and X may be a strided view (row stride ldx), so a block of the
// staged tile buffer is read in place.
//
// Bound: memory. Each X element is used for C multiply-adds, so at the main
// path's C = 1 the kernel moves 4 bytes per 2 flops; the least time is
// (M*K*sizeof(X) + K*C*4 + M*C*4) / 3.35 TB/s, about 0.15 us for a
// main-path block of 20 x 6000 fp32. A call that small is latency-bound:
// what counts is how many loads are in flight at once and on how many SMs.
// One CTA per row put a 20-row block on 20 SMs, each warp walking a chain of
// loads; the cluster split puts it on 160 CTAs with every load issued up
// front, and the per-block executor path still pays a launch per block (the
// segmented kernel is the fix for that).
#include <cooperative_groups.h>

#include "warp_dot.cuh"

namespace cg = cooperative_groups;
using usec::kColTile;
using usec::kWarp;

namespace {

constexpr int kCluster = 8;  // CTAs per row (usec_matvec.py: CLUSTER)
constexpr int kMvThreads = 128;                // threads per CTA
constexpr int kMvWarps = kMvThreads / kWarp;   // warps per CTA

// A length-n run split in `parts` chunks that are multiples of 8 elements,
// so every chunk of a 16-byte-aligned row starts 16-byte aligned.
__device__ __forceinline__ int chunk_of(int n, int parts) {
  return ((n + parts - 1) / parts + 7) & ~7;
}

template <typename T, int CT>
__global__ void __launch_bounds__(kMvThreads)
    matvec_kernel(const T* __restrict__ x, int ldx, const float* __restrict__ w,
                  int ldw, float* __restrict__ y, int ldy, int k, int c) {
  __shared__ float part[kMvWarps][CT];
  __shared__ float cta_sum[CT];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / kCluster;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, c - c0);
  const int warp = threadIdx.x / kWarp;
  const int cta_chunk = chunk_of(k, kCluster);
  const int ck0 = min(k, rank * cta_chunk);
  const int ck1 = min(k, ck0 + cta_chunk);
  const int warp_chunk = chunk_of(ck1 - ck0, kMvWarps);
  const int k0 = min(ck1, ck0 + warp * warp_chunk);
  const int k1 = min(ck1, k0 + warp_chunk);
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
    for (int q = 0; q < kMvWarps; ++q) s += part[q][threadIdx.x];
    cta_sum[threadIdx.x] = s;
  }
  cluster.sync();  // every CTA's partial is written
  if (rank == 0 && threadIdx.x < nc) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      s += cluster.map_shared_rank(cta_sum, r)[threadIdx.x];
    }
    y[(size_t)row * ldy + c0 + threadIdx.x] = s;
  }
  cluster.sync();  // no CTA leaves while rank 0 still reads its partial
}

template <typename T, int CT>
int launch_cluster(const T* x, int ldx, const float* w, int ldw, float* y,
                   int ldy, int m, int k, int c, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m) * kCluster,
                     static_cast<unsigned>((c + CT - 1) / CT));
  cfg.blockDim = dim3(kMvThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, matvec_kernel<T, CT>, x, ldx,
                                           w, ldw, y, ldy, k, c);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, int ldx, const void* w, int ldw, void* y, int ldy,
           int m, int k, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  if (c == 1) {
    return launch_cluster<T, 1>(xp, ldx, wp, ldw, yp, ldy, m, k, c, s);
  }
  return launch_cluster<T, kColTile>(xp, ldx, wp, ldw, yp, ldy, m, k, c, s);
}

}  // namespace

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
