// zlib's CRC32 of every tile of a staged buffer, in one launch:
//   out[i] = crc32(bytes of tile i)            for i < n_tiles
// where tile i is the tile_bytes bytes at base + i * tile_stride. The result
// equals zlib.crc32 bit for bit, so the integrity checker's staging-time
// fingerprints (repro_torch.faults.integrity.tile_checksum) stay the one
// source of truth for what a clean tile is.
//
// Replaces no TPU kernel: the JAX package fingerprints the host copy with
// zlib (repro.faults.integrity.tile_checksum), and on the card the kernels
// read the card's copy, so the audit has to read that copy too.
//
// Algorithm. A tile is cut into kChunk-byte chunks counted from its END
// (chunk j covers bytes [L - (j+1)*kChunk, L - j*kChunk)), so the head chunk
// is the only partial one and its missing bytes are leading zeros, which a
// zero-initialised CRC register ignores. Each thread computes the raw CRC
// (register starts at 0, no final XOR) of one chunk with slicing-by-4 over
// 16-byte loads, its tables in shared memory. CRC is linear over GF(2), and
// appending n zero bytes multiplies the register by x^(8n) mod P, so
//   crc32(tile) = x^(8L) * 0xFFFFFFFF  ^  XOR_j x^(8 kChunk j) * raw_j  ^  ~0
// (zlib's crc32_combine algebra). The powers come from the wrapper: thread t
// of CTA b multiplies by pow_t[t] = x^(8 kChunk t), the CTA's XOR of its
// threads by pow_b[b] = x^(8 kChunk kThreads b), and CTA 0 of a tile adds
// the constant term. Each CTA XORs its share into out[tile] with atomicXor
// (the wrapper zeroes out first); XOR is associative and commutative, so the
// order the CTAs land in cannot change the bits.
//
// Bound: memory. Every byte is read once; at the paper's Sec. V size the
// staged buffer is 6 x 3000 x 6000 fp32 = 432 MB, 0.129 ms at 3.35 TB/s. The
// table lookups (one per byte, four per 32-bit word) run from shared memory
// beside the loads. Neighbouring threads read chunks kChunk bytes apart, so
// the loads are not coalesced; a simple kernel is enough for an audit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr unsigned kPoly = 0xEDB88320u;  // zlib's reflected CRC-32 polynomial
constexpr int kChunk = 512;              // bytes one thread CRCs
constexpr int kThreads = 256;            // chunks one CTA folds

// a * b mod P in zlib's reflected representation (bit 31 is x^0).
__device__ __forceinline__ unsigned multmodp(unsigned a, unsigned b) {
  unsigned p = 0;
#pragma unroll 8
  for (int i = 31; i >= 0; --i) {
    if ((a >> i) & 1u) p ^= b;
    b = (b & 1u) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

__global__ void __launch_bounds__(kThreads) tile_crc_kernel(
    const unsigned char* __restrict__ base, long long tile_stride,
    long long tile_bytes, const unsigned* __restrict__ pow_t,
    const unsigned* __restrict__ pow_b, unsigned init, int vec,
    unsigned* __restrict__ out) {
  __shared__ unsigned tab[4][256];
  __shared__ unsigned warp_acc[kThreads / 32];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) {
    unsigned c = (unsigned)i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ kPoly : c >> 1;
    tab[0][i] = c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    for (int i = tid; i < 256; i += kThreads) {
      const unsigned prev = tab[k - 1][i];
      tab[k][i] = (prev >> 8) ^ tab[0][prev & 0xffu];
    }
    __syncthreads();
  }

  const int tile = blockIdx.y;
  const long long j = (long long)blockIdx.x * kThreads + tid;
  const unsigned char* t0 = base + (long long)tile * tile_stride;
  const long long hi = tile_bytes - j * kChunk;  // this chunk's end
  const long long lo = hi - kChunk;              // < 0 only for the head
  unsigned c = 0;
  if (hi > 0) {
    const long long start = lo < 0 ? 0 : lo;
    if (vec) {
      // tile_bytes, tile_stride and base are 16-byte multiples, so start is.
      const uint4* p = reinterpret_cast<const uint4*>(t0 + start);
      const int n = (int)((hi - start) >> 4);
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const uint4 v = __ldg(p + i);
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c ^= w[q];
          c = tab[3][c & 0xffu] ^ tab[2][(c >> 8) & 0xffu] ^
              tab[1][(c >> 16) & 0xffu] ^ tab[0][c >> 24];
        }
      }
    } else {
      for (long long i = start; i < hi; ++i) {
        c = tab[0][(c ^ t0[i]) & 0xffu] ^ (c >> 8);
      }
    }
    c = multmodp(pow_t[tid], c);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c ^= __shfl_xor_sync(0xffffffffu, c, o);
  if ((tid & 31) == 0) warp_acc[tid >> 5] = c;
  __syncthreads();
  if (tid == 0) {
    unsigned v = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v ^= warp_acc[w];
    v = multmodp(pow_b[blockIdx.x], v);
    if (blockIdx.x == 0) v ^= init;
    atomicXor(out + tile, v);
  }
}

}  // namespace

extern "C" int tile_crc32(const void* base, long long tile_stride,
                          long long tile_bytes, int n_tiles, const void* pow_t,
                          const void* pow_b, int n_ctas, unsigned init,
                          int vec, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_crc_kernel<<<dim3((unsigned)n_ctas, (unsigned)n_tiles, 1), kThreads, 0,
                    s>>>(static_cast<const unsigned char*>(base), tile_stride,
                         tile_bytes, static_cast<const unsigned*>(pow_t),
                         static_cast<const unsigned*>(pow_b), init, vec,
                         static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
