// Softmax attention with an online softmax over KV tiles (flash attention),
// forward only, fp32: q: (b, h, sq, d); k, v: (b, hk, skv, d) with hk | h
// (GQA: kv head = q head / (h / hk)); out: (b, h, sq, d) contiguous fp32.
// Every product and sum in fp32 FFMA, so the kernel keeps the reference's
// fp32 rounding (the model path's fp32 runs go through it). bf16 inputs go
// to the tensor-core kernel of flash_attention_tc.cu. Causal masking is
// aligned to the end of the KV sequence (query row r sits at KV position
// r + skv - sq), an optional sliding window keeps keys k > q - window, and
// keys at or past skv are masked in the kernel.
//
// Replaces the TPU kernel repro.kernels.flash_attention.flash_attention_padded
// / _flash_kernel. There the grid was (b*h, sq/bq, skv/bk) with the KV axis
// innermost and sequential, the running max m, denominator l and the
// accumulator resident in VMEM across it, dead KV blocks skipped by pl.when,
// and every operand padded to block multiples by the wrapper. Here one CTA
// owns one (batch, head, 64-row query block): the KV axis is a loop inside
// the CTA over only the live tiles (the first and last live tile come from
// causal and window, the counterpart of pl.when(live)); m, l and the
// accumulator stay in registers; ragged sq and skv are masked here, so
// nothing is padded; the GQA map is index arithmetic, so KV is never
// repeated. Q, K and V are read through their (batch, head, row) strides, so
// the model's (B, S, H, d) activations are read in place.
//
// Semantics follow _flash_kernel line by line: masked scores are the finite
// -1e30, masked probabilities are 0, and the denominator is clamped at
// 1e-30, so a row with no live key returns 0, not NaN. Every sum runs in a
// fixed order (fixed loops, butterfly shuffles, no atomics): two runs give
// the same bits.
//
// Bound on the H100: operations, 4*d FLOPs per live (query, key) pair at
// the fp32 FFMA peak of 67 TFLOP/s (fp32 has no tensor-core rate that keeps
// fp32 rounding). What the design does for the FFMA rate: each thread owns
// a 4 x 2 block of scores and a 4 x d/16 block of the output, the tiles it
// multiplies are staged in shared memory with Q and K transposed, so a
// thread reads 4 query rows with one 16-byte load and 2 keys with one
// 8-byte load per step of d (8 FFMA per 2 loads), and the heaviest causal
// query blocks are scheduled first.
#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 32;             // keys per KV tile
constexpr int kThreads = 256;       // a 16 x 16 grid of threads
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kCols = kBK / 16;     // score columns per thread
constexpr int kQStride = kBQ + 4;   // row stride of the transposed Q and P
constexpr int kKStride = kBK + 4;   // row stride of the transposed K
constexpr float kNegInf = -1e30f;   // _flash_kernel's NEG_INF
static_assert(kRows == 4 && kCols == 2, "the inner loops load float4 / float2");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_sh, q_ss;  // strides in elements: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int h, hk, sq, skv;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

// 16-byte vector loads of 4 fp32 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float (&x)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};

// Load kRowsIn rows of D values starting at row r0 (rows at or past `limit`
// read as zeros) into shared memory transposed: dst[c * stride + r].
// Consecutive threads take consecutive rows, so the shared stores are free
// of bank conflicts.
template <typename T, int D, int kRowsIn>
__device__ __forceinline__ void stage_transposed(const T* src, long long ld,
                                                 int r0, int limit,
                                                 float* dst, int stride) {
  constexpr int V = Vec<T>::n;
  for (int i = threadIdx.x; i < kRowsIn * (D / V); i += kThreads) {
    const int r = i % kRowsIn;
    const int c = (i / kRowsIn) * V;
    float x[V];
    if (r0 + r < limit) {
      Vec<T>::load(src + (long long)(r0 + r) * ld + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[(c + e) * stride + r] = x[e];
  }
}

// The same for V, kept row-major: dst[r * D + c].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* src, long long ld, int r0,
                                           int limit, float* dst) {
  constexpr int V = Vec<T>::n;
  for (int i = threadIdx.x; i < kBK * (D / V); i += kThreads) {
    const int r = i / (D / V);
    const int c = (i % (D / V)) * V;
    float x[V];
    if (r0 + r < limit) {
      Vec<T>::load(src + (long long)(r0 + r) * ld + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(dst + r * D + c + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (D * kQStride + D * kKStride + kBK * D + kBK * kQStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int kOut = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [D][kQStride], Q^T
  float* sK = sQ + D * kQStride;                // [D][kKStride], K^T
  float* sV = sK + D * kKStride;                // [kBK][D]
  float* sP = sV + kBK * D;                     // [kBK][kQStride], P^T

  const int bh = blockIdx.x;
  const int b = bh / p.h;
  const int hq = bh % p.h;
  const int hkv = hq / (p.h / p.hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int r0 = ty * kRows;   // this thread's first query row in the block
  const int c0 = tx * kCols;   // ... and first key of each tile

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hkv * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hkv * p.v_sh;

  stage_transposed<T, D, kBQ>(qg, p.q_ss, q0, p.sq, sQ, kQStride);

  // The live KV range of this query block: _flash_kernel's `live` test.
  const int offs = p.skv - p.sq;
  const int q_lo = q0 + offs;
  const int q_hi = min(q0 + kBQ, p.sq) - 1 + offs;
  int k_begin = 0;
  int k_end = p.skv;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  if (p.window > 0) k_begin = max(0, q_lo - p.window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage_transposed<T, D, kBK>(kg, p.k_ss, k0, p.skv, sK, kKStride);
    stage_rows<T, D>(vg, p.v_ss, k0, p.skv, sV);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + d * kQStride + r0);
      const float2 kv = *reinterpret_cast<const float2*>(sK + d * kKStride + c0);
      const float qa[kRows] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[kCols] = {kv.x, kv.y};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }

    // Mask, running max, probabilities, rescale: one row is spread over the
    // 16 threads of a half-warp, which combine with xor shuffles (every lane
    // ends with the same bits).
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + r0 + i + offs;
      bool live[kCols];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + c0 + j;
        live[j] = k_pos < p.skv;
        if (p.causal) live[j] = live[j] && k_pos <= q_pos;
        if (p.window > 0) live[j] = live[j] && k_pos > q_pos - p.window;
        s[i][j] = live[j] ? s[i][j] * p.scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
      }
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        row_sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      *reinterpret_cast<float4*>(sP + (c0 + j) * kQStride + r0) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P @ V over this tile's keys.
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(sP + c * kQStride + r0);
      const float pa[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

  T* og = static_cast<T*>(p.out) + ((long long)b * p.h + hq) * p.sq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + r0 + i;
    if (r >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      og[(long long)r * D + tx + 16 * j] = Vec<T>::store(acc[i][j] / den);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(batch * p.h),
                  static_cast<unsigned>((p.sq + kBQ - 1) / kBQ));
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int batch, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<T, 32>(p, batch, s);
    case 64: return launch<T, 64>(p, batch, s);
    case 80: return launch<T, 80>(p, batch, s);
    case 128: return launch<T, 128>(p, batch, s);
    case 256: return launch<T, 256>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int batch,
    int h, int hk, int sq, int skv, int d, int causal, int window, float scale,
    void* stream) {
  const Params p{q,    k,    v,    out, q_sb, q_sh,   q_ss,   k_sb,
                 k_sh, k_ss, v_sb, v_sh, v_ss, h,    hk,     sq,
                 skv,  causal, window, scale};
  return dispatch<float>(p, batch, d, stream);
}
