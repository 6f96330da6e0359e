#!/usr/bin/env python3
"""What sets the pace of the tile audit's CRC32 kernel on the card?

Run from the repository root on a CUDA card:  python3 checksum_probe.py

Times, at the Sec. V staged buffer (6 x 3 tiles of 1000 x 6000 fp32,
432 MB, one launch over all 18 tiles), two designs of the kernel in three
modes each:

- ``chunk``: the first design (one thread per 512-byte chunk, 256-thread
  CTAs, one CTA row per tile, slicing-by-4 tables once per CTA in shared
  memory, four lookups per 32-bit word with data-dependent banks);
- ``span``: the shipped design (``src/repro_torch/csrc/tile_checksum.cu``,
  included as it is: lane-interleaved 512-byte spans, bank-replicated
  tables, a persistent grid);

``full`` is the kernel; ``loads`` reads every byte with the same loads and
XOR-folds the words without a lookup; ``lookups`` makes the same lookups on
words made in registers, reading nothing. The modes share the grid, the
fold and the atomics. Each ``full`` result is held to ``zlib.crc32``.
Times are CUDA events over back-to-back launches (the kernel alone, no
fill), two rounds in opposite orders. One JSON line per measurement; the
card's name and power limit first.
"""

import ctypes
import importlib
import json
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

# The module, not the ops function that repro_torch.kernels exports by the
# same name.
tc = importlib.import_module("repro_torch.kernels.tile_checksum")

SOURCE = r"""
#include "tile_checksum.cu"

namespace {

// ---- the first design, one thread per 512-byte chunk ----
template <int MODE>
__global__ void __launch_bounds__(256) chunk_kernel(
    const unsigned char* __restrict__ base, long long tile_bytes,
    const unsigned* __restrict__ pow_t, const unsigned* __restrict__ pow_b,
    unsigned init, unsigned* __restrict__ out) {
  __shared__ unsigned tab[4][256];
  __shared__ unsigned warp_acc[8];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += 256) {
    unsigned c = (unsigned)i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ kPoly : c >> 1;
    tab[0][i] = c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    for (int i = tid; i < 256; i += 256) {
      const unsigned prev = tab[k - 1][i];
      tab[k][i] = (prev >> 8) ^ tab[0][prev & 0xffu];
    }
    __syncthreads();
  }
  const int tile = blockIdx.y;
  const long long j = (long long)blockIdx.x * 256 + tid;
  const unsigned char* t0 = base + (long long)tile * tile_bytes;
  const long long hi = tile_bytes - j * 512;
  const long long lo = hi - 512;
  unsigned c = 0;
  if (hi > 0) {
    const long long start = lo < 0 ? 0 : lo;
    const uint4* p = reinterpret_cast<const uint4*>(t0 + start);
    const int n = (int)((hi - start) >> 4);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      uint4 v;
      if (MODE == 2) {
        const unsigned h = (unsigned)(j * 131 + i) * 0x9E3779B9u;
        v = make_uint4(h, h ^ 0x5bd1e995u, h + 0x27d4eb2du, h * 3u);
      } else {
        v = __ldg(p + i);
      }
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c ^= w[q];
        if (MODE != 1) {
          c = tab[3][c & 0xffu] ^ tab[2][(c >> 8) & 0xffu] ^
              tab[1][(c >> 16) & 0xffu] ^ tab[0][c >> 24];
        }
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
    for (int w = 0; w < 8; ++w) v ^= warp_acc[w];
    v = multmodp(pow_b[blockIdx.x], v);
    if (blockIdx.x == 0) v ^= init;
    atomicXor(out + tile, v);
  }
}

// ---- the shipped design with its loads or its lookups taken out ----
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) span_variant(
    const unsigned char* __restrict__ base, long long tile_stride,
    long long tile_bytes, long long n_tiles, long long spans, unsigned x512,
    unsigned x4, const unsigned* __restrict__ lane_pow,
    const unsigned* __restrict__ pow_lo, const unsigned* __restrict__ pow_hi,
    unsigned* __restrict__ out) {
  extern __shared__ uint4 smem[];
  unsigned* far = reinterpret_cast<unsigned*>(smem);
  unsigned* near = far + kFarWords;
  for (int e = threadIdx.x; e < 1024; e += kThreads) {
    const unsigned v = unsigned(e & 0xff) << (8 * (e >> 8));
    const unsigned f = multmodp(x512, v);
    uint4* dst = reinterpret_cast<uint4*>(far + 32 * e);
#pragma unroll
    for (int r = 0; r < 8; ++r) dst[r] = make_uint4(f, f, f, f);
    near[e] = multmodp(x4, v);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned* tl = far + lane;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long total = n_tiles * spans;
  const long long each = total / n_warps, extra = total % n_warps;
  long long a = warp * each + (warp < extra ? warp : extra);
  const long long b = a + each + (warp < extra ? 1 : 0);
  const unsigned my_pow = lane_pow[lane];
  while (a < b) {
    const long long t = a / spans;
    const long long t_end = (t + 1) * spans;
    const long long e = b < t_end ? b : t_end;
    const unsigned char* tile = base + t * tile_stride;
    long long off = tile_bytes - (t_end - a) * kSpan + 16 * lane;
    unsigned c0 = 0u, c1 = 0u, c2 = 0u, c3 = 0u;
    for (long long s = a; s < e; s += kBatch) {
      uint4 w[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (MODE == 2) {
          const unsigned h = (unsigned)((s + i) * 131 + lane) * 0x9E3779B9u;
          w[i] = make_uint4(h, h ^ 0x5bd1e995u, h + 0x27d4eb2du, h * 3u);
        } else {
          w[i] = s + i < e ? load_span<true>(tile, off + i * kSpan)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (s + i < e) {
          if (MODE == 1) {
            c0 ^= w[i].x; c1 ^= w[i].y; c2 ^= w[i].z; c3 ^= w[i].w;
          } else {
            c0 = far_step(tl, c0) ^ w[i].x;
            c1 = far_step(tl, c1) ^ w[i].y;
            c2 = far_step(tl, c2) ^ w[i].z;
            c3 = far_step(tl, c3) ^ w[i].w;
          }
        }
      }
      off += kBatch * kSpan;
    }
    unsigned u = near_step(near, c0) ^ c1;
    u = near_step(near, u) ^ c2;
    u = near_step(near, u) ^ c3;
    u = multmodp(my_pow, u);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) u ^= __shfl_xor_sync(0xffffffffu, u, o);
    if (lane == 0) {
      const long long g = t_end - e;
      u = multmodp(pow_lo[g & 0xff], u);
      u = multmodp(pow_hi[g >> 8], u);
      atomicXor(out + t, u);
    }
    a = e;
  }
}

}  // namespace

extern "C" int probe_chunk(int mode, const void* base, long long tile_bytes,
                           int n_tiles, const void* pow_t, const void* pow_b,
                           int n_ctas, unsigned init, void* out,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_ctas, (unsigned)n_tiles, 1);
  const auto* b = static_cast<const unsigned char*>(base);
  const auto* pt = static_cast<const unsigned*>(pow_t);
  const auto* pb = static_cast<const unsigned*>(pow_b);
  auto* o = static_cast<unsigned*>(out);
  if (mode == 0) chunk_kernel<0><<<grid, 256, 0, s>>>(b, tile_bytes, pt, pb, init, o);
  if (mode == 1) chunk_kernel<1><<<grid, 256, 0, s>>>(b, tile_bytes, pt, pb, init, o);
  if (mode == 2) chunk_kernel<2><<<grid, 256, 0, s>>>(b, tile_bytes, pt, pb, init, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_span(int mode, const void* base, long long tile_bytes,
                          long long n_tiles, long long spans, unsigned x512,
                          unsigned x4, const void* lane_pow,
                          const void* pow_lo, const void* pow_hi, int n_ctas,
                          void* out, void* stream) {
  if (mode == 0) {
    return tile_crc32(base, tile_bytes, tile_bytes, n_tiles, spans, x512, x4,
                      lane_pow, pow_lo, pow_hi, n_ctas, 1, out, stream);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const unsigned char*>(base);
  const auto* lp = static_cast<const unsigned*>(lane_pow);
  const auto* lo = static_cast<const unsigned*>(pow_lo);
  const auto* hi = static_cast<const unsigned*>(pow_hi);
  auto* o = static_cast<unsigned*>(out);
  if (mode == 1) {
    cudaFuncSetAttribute(span_variant<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    span_variant<1><<<n_ctas, kThreads, kSmemBytes, s>>>(
        b, tile_bytes, tile_bytes, n_tiles, spans, x512, x4, lp, lo, hi, o);
  } else {
    cudaFuncSetAttribute(span_variant<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    span_variant<2><<<n_ctas, kThreads, kSmemBytes, s>>>(
        b, tile_bytes, tile_bytes, n_tiles, spans, x512, x4, lp, lo, hi, o);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

MODES = ("full", "loads", "lookups")
ITERS = 30


def build() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "checksum_probe.cu"
    src.write_text(SOURCE)
    lib = out_dir / "checksum_probe.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib), str(src)], capture_output=True, text=True)
    print(json.dumps({"phase": "build", "rc": proc.returncode, "ptxas": [
        ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
        if "registers" in ln or "spill" in ln or "error" in ln]}),
        flush=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib))


def u32(values, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, dtype=np.uint32)
                            .view(np.int32)).to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("checksum_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    lib = build()
    p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)
    lib.probe_chunk.argtypes = [i, p, ll, i, p, p, i, u, p, p]
    lib.probe_span.argtypes = [i, p, ll, ll, ll, u, u, p, p, p, i, p, p]
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    staged = torch.randn((6, 3, 1000, 6000), device=dev)
    n_tiles, tile_bytes = 18, 1000 * 6000 * 4
    n_bytes = n_tiles * tile_bytes
    host = staged.cpu().numpy().reshape(n_tiles, -1)
    want = [zlib.crc32(t.tobytes()) for t in host]
    stream = _build.stream_handle(dev)
    out = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    init = tc._init_term(tile_bytes)

    # The first design's constants: x^(8 512 t) for the 256 chunks of a
    # CTA, x^(8 512 256 b) for the CTAs of a tile.
    chunks = -(-tile_bytes // 512)
    chunk_ctas = -(-chunks // 256)
    pow_t = u32(tc._powers_of(tc._x8n(512), 256), dev)
    pow_b = u32(tc._powers_of(tc._x8n(512 * 256), chunk_ctas), dev)
    spans = -(-tile_bytes // tc.SPAN)
    k = tc.span_constants(spans)
    lane_pow, pow_lo, pow_hi = (u32(k[n], dev)
                                for n in ("lane_pow", "pow_lo", "pow_hi"))
    grid = tc.tile_checksum_grid(staged, 2)

    def run(design, mode):
        m = MODES.index(mode)
        if design == "chunk":
            code = lib.probe_chunk(m, staged.data_ptr(), tile_bytes, n_tiles,
                                   pow_t.data_ptr(), pow_b.data_ptr(),
                                   chunk_ctas, init, out.data_ptr(), stream)
        else:
            code = lib.probe_span(m, staged.data_ptr(), tile_bytes, n_tiles,
                                  spans, k["x512"], k["x4"],
                                  lane_pow.data_ptr(), pow_lo.data_ptr(),
                                  pow_hi.data_ptr(), grid["ctas"],
                                  out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"{design}/{mode}: CUDA error {code}")

    for design in ("chunk", "span"):
        out.zero_()
        if design == "span":
            out.fill_(init - (1 << 32) if init >> 31 else init)
        run(design, "full")
        got = (out.cpu().to(torch.int64) & 0xFFFFFFFF).tolist()
        print(json.dumps({"phase": "check", "design": design,
                          "equals_zlib": got == want}), flush=True)
        if got != want:
            return 1

    cases = [(d, m) for d in ("chunk", "span") for m in MODES]
    for rnd, order in enumerate((cases, cases[::-1])):
        for design, mode in order:
            for _ in range(3):
                run(design, mode)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                run(design, mode)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / ITERS
            print(json.dumps({
                "phase": "time", "round": rnd, "design": design,
                "mode": mode, "ms": ms,
                "gb_per_s": n_bytes / ms / 1e6,
                "bound_share": n_bytes / 3.35e12 * 1e3 / ms,
                "grid": ({"ctas": chunk_ctas * n_tiles, "threads": 256}
                         if design == "chunk" else
                         {"ctas": grid["ctas"], "threads": 32 * tc.WARPS})}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
