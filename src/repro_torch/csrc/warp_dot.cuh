// Device code shared by the USEC kernels: one warp reduces a run of K of one
// output row, in fp32, against a tile of up to CT columns of W.
//
// Lanes stride the contraction dim K with 16-byte loads when the row is
// 16-byte aligned (4 fp32 or 8 bf16 values per lane per load), then finish
// the ragged tail with scalar loads. Each lane keeps CT fp32 accumulators in
// registers; a butterfly of warp shuffles sums them, so every lane ends with
// the full dot products. X is read exactly once; W (K x CT fp32) is small and
// re-read from L1/L2 by every warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace usec {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                  // threads per CTA
constexpr int kRowsPerCta = kThreads / kWarp;  // segmented: a warp per row
constexpr int kColTile = 8;                    // columns per warp (registers)

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// acc[j] = sum_k row[k] * w[k * ldw + j] for j < nc, on every lane of the
// calling warp. All 32 lanes must call it (the shuffles need the full warp).
template <typename T, int CT>
__device__ __forceinline__ void warp_row_dot(const T* __restrict__ row, int k,
                                             const float* __restrict__ w,
                                             int ldw, int nc, float (&acc)[CT]) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int j = 0; j < CT; ++j) acc[j] = 0.f;
  constexpr int V = Vec<T>::n;
  int tail = 0;  // first K index left to the scalar loop
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int nvec = k / V;
#pragma unroll 4
    for (int i = lane; i < nvec; i += kWarp) {
      float xv[V];
      Vec<T>::load(row + (size_t)i * V, xv);
      const float* wp = w + (size_t)i * V * ldw;
#pragma unroll
      for (int e = 0; e < V; ++e) {
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (j < nc) acc[j] = fmaf(xv[e], wp[(size_t)e * ldw + j], acc[j]);
        }
      }
    }
    tail = nvec * V;
  }
  for (int kk = tail + lane; kk < k; kk += kWarp) {
    const float xs = Vec<T>::one(row + kk);
    const float* wp = w + (size_t)kk * ldw;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (j < nc) acc[j] = fmaf(xs, wp[j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    }
  }
}

}  // namespace usec

// Name of a CUDA error code returned by a launch entry point.
extern "C" const char* usec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
