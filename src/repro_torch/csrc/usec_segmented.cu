// Every worker's whole block list in one launch:
//   out[n, i] = (staged[n, slot[n, i], off[n, i] : off[n, i] + br, :] @ W)
//               * include[n, i]                       for i <  n_blocks[n]
//   out[n, i] = 0                                     for i >= n_blocks[n]
// Output (N, B_max, br, C) fp32.
//
// Replaces the TPU kernel repro.kernels.usec_segmented.usec_segmented_padded /
// _segmented_kernel, which ran one worker's list per pallas_call with the
// (slot, offset) indices scalar-prefetched and the K loop as a grid axis.
// Here the grid is (N * B_max, row groups, column tiles): each CTA loads its
// own slot, offset and the worker's trip count, and each warp reduces one
// block row over K in registers (warp_dot.cuh). A padding block
// (i >= n_blocks[n]) reads nothing and writes zeros: the zero-trip rule of
// the reference's lax.cond. The include weight is applied in the epilogue,
// after the product, the reference's op order. The ragged K tail is handled
// in the kernel, so the staged buffer is never padded or copied.
//
// Bound: memory. The least time is the bytes of the real blocks' rows (plus
// W, the plan arrays and the output) over 3.35 TB/s; at the paper's Sec. V
// size with S = 0 that is all of X, 144 MB, about 43 us a step.
#include "warp_dot.cuh"

using usec::kColTile;
using usec::kRowsPerCta;
using usec::kThreads;
using usec::kWarp;

template <int CT>
__global__ void __launch_bounds__(kThreads) segmented_kernel(
    const float* __restrict__ staged, int worker_stride, int slot_stride,
    int ldx, int t_slots, int rows_per_tile, const int* __restrict__ slot,
    const int* __restrict__ off, const int* __restrict__ n_blocks,
    const float* __restrict__ include, const float* __restrict__ w, int ldw,
    float* __restrict__ out, int b_max, int block_rows, int k, int c) {
  const int blk = blockIdx.x;  // n * b_max + i
  const int n = blk / b_max;
  const int i = blk - n * b_max;
  const int r = blockIdx.y * kRowsPerCta + threadIdx.x / kWarp;
  if (r >= block_rows) return;  // whole warp leaves together
  const int c0 = blockIdx.z * CT;
  const int nc = min(CT, c - c0);
  const bool lead = (threadIdx.x & (kWarp - 1)) == 0;
  float* o = out + ((size_t)blk * block_rows + r) * c + c0;
  if (i >= n_blocks[n]) {
    if (lead) {
      for (int j = 0; j < nc; ++j) o[j] = 0.f;
    }
    return;
  }
  const int s = slot[blk];
  const int start = off[blk];
  if (s < 0 || s >= t_slots || start < 0 ||
      start + block_rows > rows_per_tile) {
    // A plan index outside the staged buffer never reads out of bounds: the
    // block comes out NaN, which the runner's verify reports.
    if (lead) {
      for (int j = 0; j < nc; ++j) o[j] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const float* row = staged + (size_t)n * worker_stride +
                     (size_t)s * slot_stride + (size_t)(start + r) * ldx;
  float acc[CT];
  usec::warp_row_dot<float, CT>(row, k, w + c0, ldw, nc, acc);
  if (lead) {
    const float g = include[blk];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (j < nc) o[j] = acc[j] * g;
    }
  }
}

extern "C" int usec_segmented_f32(
    const void* staged, int worker_stride, int slot_stride, int ldx,
    int t_slots, int rows_per_tile, const void* slot, const void* off,
    const void* n_blocks, const void* include, const void* w, int ldw,
    void* out, int n_workers, int b_max, int block_rows, int k, int c,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)n_workers * (unsigned)b_max;
  const unsigned row_groups =
      (unsigned)((block_rows + kRowsPerCta - 1) / kRowsPerCta);
  const float* sp = static_cast<const float*>(staged);
  const int* slp = static_cast<const int*>(slot);
  const int* ofp = static_cast<const int*>(off);
  const int* nbp = static_cast<const int*>(n_blocks);
  const float* inp = static_cast<const float*>(include);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (c == 1) {
    segmented_kernel<1><<<dim3(blocks, row_groups, 1), kThreads, 0, s>>>(
        sp, worker_stride, slot_stride, ldx, t_slots, rows_per_tile, slp, ofp,
        nbp, inp, wp, ldw, op, b_max, block_rows, k, c);
  } else {
    const unsigned col_tiles = (unsigned)((c + kColTile - 1) / kColTile);
    segmented_kernel<kColTile>
        <<<dim3(blocks, row_groups, col_tiles), kThreads, 0, s>>>(
            sp, worker_stride, slot_stride, ldx, t_slots, rows_per_tile, slp,
            ofp, nbp, inp, wp, ldw, op, b_max, block_rows, k, c);
  }
  return static_cast<int>(cudaGetLastError());
}
