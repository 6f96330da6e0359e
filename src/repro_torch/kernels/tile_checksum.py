"""Hopper kernel for the tile audit: zlib's CRC32 of every staged tile.

The integrity checker fingerprints each staged replica tile with
``zlib.crc32`` at staging time (:func:`repro_torch.faults.integrity.
tile_checksum`) and re-checks them on verified steps. On the card the kernels
read the card's copy of the staged buffer, so the audit must read that copy:
this kernel checksums every tile of it in one launch, bit for bit equal to
zlib, and the runner compares the result with the checker's fingerprints.
It replaces no TPU kernel (the JAX package audits its host copy with zlib).
Source: ``csrc/tile_checksum.cu``; plain version: :func:`tile_checksum_plain`.

Bound on the H100: memory. Every byte is read once; the Sec. V staged buffer
(6 x 3000 x 6000 fp32, 432 MB) takes 0.129 ms at 3.35 TB/s. Its 432 M table
lookups (one per byte) take about 0.06 ms when each warp-wide lookup is one
shared-memory wavefront, which the design makes sure of.

Design: a tile is cut into :data:`SPAN`-byte spans counted from its end, so
only the head span is partial and its missing bytes act as leading zeros. A
warp reads a span with one coalesced 16-byte load per lane. Lane ``l`` keeps
one raw CRC register (zero start, no final XOR) per 32-bit word of its 16
bytes; each word recurs every ``SPAN`` bytes, so the register advances
``SPAN`` bytes per span through slicing tables built for that distance
(``x^(8 SPAN)``), kept 32 times over in shared memory so that lane ``l``
reads bank ``l`` only. The spans of the whole buffer, in address order, are
dealt out as one contiguous run per warp over a persistent grid of one CTA
of :data:`WARPS` warps per SM; a run is cut where a tile ends. At a piece's
end the lane folds its four registers (``x^32`` tables) and multiplies by
its lane multiplier ``x^(8 (500 - 16 l))``; the warp XORs its lanes, and the
piece, ending ``g`` spans before its tile's end, is multiplied by
``x^(8 SPAN g) = pow_hi[g >> 8] * pow_lo[g & 255]`` (zlib's
``crc32_combine`` algebra) and XORed into its tile's word. The word starts
at the constant term ``x^(8L) * 0xFFFFFFFF ^ 0xFFFFFFFF``, zlib's initial
value and final XOR. Every multiplier is precomputed here
(:func:`span_constants`), and the plain version runs the same runs, chains
and multipliers, vectorized over the runs, so the CPU tests hold the
kernel's constants to zlib.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["SPAN", "WARPS", "span_constants", "tile_checksum_cuda",
           "tile_checksum_grid", "tile_checksum_plain"]

POLY = 0xEDB88320   # zlib's reflected CRC-32 polynomial
SPAN = 512          # bytes a warp reads per step (csrc kSpan): 32 lanes x 16
WARPS = 32          # warps per CTA (kWarps)
H100_SMS = 132      # the plain version's default grid: one CTA per SM
DYNAMIC_SMEM = 4 * (4 * 256 * 32 + 4 * 256)  # the tables (kSmemBytes)
X0 = 1 << 31        # x^0 in the reflected representation


def _multmodp(a: int, b: int) -> int:
    """``a * b`` mod P in zlib's reflected representation (bit 31 = x^0)."""
    p = 0
    for i in range(31, -1, -1):
        if (a >> i) & 1:
            p ^= b
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    return p


@functools.lru_cache(maxsize=None)
def _x8n(n: int) -> int:
    """``x^(8 n)`` mod P: the register multiplier of ``n`` zero bytes."""
    p, sq = X0, 1 << 23   # x^0, and x^8 (appending one byte)
    while n:
        if n & 1:
            p = _multmodp(sq, p)
        sq = _multmodp(sq, sq)
        n >>= 1
    return p


def _init_term(tile_bytes: int) -> int:
    """zlib's initial value carried through the tile, and its final XOR."""
    return _multmodp(_x8n(tile_bytes), 0xFFFFFFFF) ^ 0xFFFFFFFF


def _powers_of(step: int, n: int):
    out = [X0]
    for _ in range(n - 1):
        out.append(_multmodp(step, out[-1]))
    return out


@functools.lru_cache(maxsize=None)
def span_constants(spans: int) -> Dict[str, object]:
    """The multipliers the kernel is handed for tiles of ``spans`` spans:
    ``x512`` (``x^(8 SPAN)``, the chains' step) and ``x4`` (``x^32``, the
    fold), ``lane_pow[l] = x^(8 (SPAN - 16 l - 12))``, ``pow_lo[i] =
    x^(8 SPAN i)`` for ``i < 256`` and ``pow_hi[j] = x^(8 SPAN 256 j)`` for
    the ``ceil(spans / 256)`` values of ``g >> 8``."""
    return {
        "x512": _x8n(SPAN), "x4": _x8n(4),
        "lane_pow": [_x8n(SPAN - 16 * lane - 12) for lane in range(32)],
        "pow_lo": _powers_of(_x8n(SPAN), 256),
        "pow_hi": _powers_of(_x8n(SPAN * 256), max(1, -(-spans // 256))),
    }


def _tile_shape(x: torch.Tensor, tile_dims: int) -> Tuple[tuple, int]:
    if not 0 <= tile_dims <= x.ndim:
        raise ValueError(f"tile_dims={tile_dims} for a {x.ndim}-d tensor")
    lead = tuple(x.shape[: x.ndim - tile_dims])
    n_elem = int(np.prod(x.shape[x.ndim - tile_dims:], dtype=np.int64))
    return lead, n_elem * x.element_size()


def _n_ctas(total_spans: int, sms: int, per_sm: int) -> int:
    """The persistent grid: every SM's resident CTAs, fewer when the buffer
    has fewer spans than that many warps."""
    return max(1, min(sms * per_sm, -(-total_spans // WARPS)))


def _runs(total: int, spans: int, n_warps: int):
    """The kernel's work split: the ``total`` spans in address order, one
    contiguous run per warp (the first ``total % n_warps`` warps one span
    more), each run cut where a tile ends. Returns (tile, start, end) int64
    arrays of the non-empty pieces, in global span ids."""
    w = np.arange(n_warps + 1, dtype=np.int64)
    each, extra = divmod(total, n_warps)
    cuts = np.union1d(w * each + np.minimum(w, extra),
                      np.arange(0, total + 1, spans, dtype=np.int64))
    start, end = cuts[:-1], cuts[1:]
    keep = end > start
    start, end = start[keep], end[keep]
    return start // spans, start, end


# ---------------------------------------------------------------------- #
# Plain PyTorch version
# ---------------------------------------------------------------------- #
def _mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a * b`` mod P over int64 tensors holding 32-bit values."""
    a, b = torch.broadcast_tensors(a, b)
    p = torch.zeros_like(b)
    for i in range(31, -1, -1):
        p = p ^ torch.where(((a >> i) & 1) == 1, b, 0)
        b = torch.where((b & 1) == 1, (b >> 1) ^ POLY, b >> 1)
    return p


def _table(step: int, device) -> torch.Tensor:
    """(4, 256) int64: entry (k, v) multiplies ``v << 8k`` by ``step``."""
    v = torch.arange(256, dtype=torch.int64, device=device)
    v = v[None, :] << (8 * torch.arange(4, device=device))[:, None]
    return _mulmod(torch.tensor(step, dtype=torch.int64, device=device), v)


def _advance(tab: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (tab[0][c & 0xFF] ^ tab[1][(c >> 8) & 0xFF]
            ^ tab[2][(c >> 16) & 0xFF] ^ tab[3][(c >> 24) & 0xFF])


def _xor_rows(c: torch.Tensor) -> torch.Tensor:
    """XOR over dim 1 of an (n, m) int64 tensor, as a pairwise tree."""
    while c.shape[1] > 1:
        if c.shape[1] % 2:
            c = torch.cat([c, torch.zeros_like(c[:, :1])], dim=1)
        c = c[:, 0::2] ^ c[:, 1::2]
    return c[:, 0] if c.shape[1] else torch.zeros_like(c[:, 0])


def _xor_into(n: int, index: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[i] = XOR of v[j] over index[j] == i (int64, 32-bit values): the
    parity of each bit's count."""
    bit = torch.arange(32, device=v.device)
    counts = torch.zeros((n, 32), dtype=torch.int64, device=v.device)
    counts.index_add_(0, index, (v[:, None] >> bit) & 1)
    return ((counts & 1) << bit).sum(dim=1)


def tile_checksum_plain(x: torch.Tensor, tile_dims: int = 2,
                        n_warps: int = None) -> torch.Tensor:
    """Plain version of the kernel, on whatever device ``x`` lies on.

    The last ``tile_dims`` dims of ``x`` form a tile, the leading dims index
    the tiles. Returns int64 CRC32s (values in [0, 2^32)) of each tile's
    bytes, shaped like the leading dims: ``zlib.crc32`` of each tile. The
    spans are split over ``n_warps`` warps as the kernel splits them (by
    default its grid on this device, or on an H100 for a host tensor); the
    result does not depend on the split."""
    lead, tile_bytes = _tile_shape(x, tile_dims)
    n = int(np.prod(lead, dtype=np.int64))
    dev = x.device
    if n == 0 or tile_bytes == 0:
        return torch.zeros(lead, dtype=torch.int64, device=dev)
    spans = -(-tile_bytes // SPAN)
    total = n * spans
    if n_warps is None:
        sms = (torch.cuda.get_device_properties(dev).multi_processor_count
               if dev.type == "cuda" else H100_SMS)
        n_warps = WARPS * _n_ctas(total, sms, 1)
    # Every span as 32 lanes x 4 little-endian words (the head left-padded
    # with zero bytes), and one zero span at the end for padding.
    buf = torch.zeros((total + 1) * SPAN, dtype=torch.uint8, device=dev)
    buf[:total * SPAN].view(n, spans * SPAN)[:, spans * SPAN - tile_bytes:] \
        = x.contiguous().reshape(-1).view(torch.uint8).reshape(n, tile_bytes)
    words = buf.view(torch.int32).view(total + 1, 32, 4)
    tile, start, end = _runs(total, spans, n_warps)
    # Pieces as rows, right-aligned: column i of a piece holds its span
    # end - width + i; columns before its start read the zero span (leading
    # zeros leave a zero register at zero).
    width = int((end - start).max())
    idx = end[:, None] - width + np.arange(width)
    idx = np.where(idx >= start[:, None], idx, total)
    spans_of = words[torch.as_tensor(idx, device=dev)]
    k = span_constants(spans)
    far, near = _table(k["x512"], dev), _table(k["x4"], dev)
    c = torch.zeros(spans_of[:, 0].shape, dtype=torch.int64, device=dev)
    for i in range(width):
        c = _advance(far, c) ^ (spans_of[:, i].to(torch.int64) & 0xFFFFFFFF)
    u = _advance(near, c[..., 0]) ^ c[..., 1]
    u = _advance(near, u) ^ c[..., 2]
    u = _advance(near, u) ^ c[..., 3]

    def const(key):
        return torch.tensor(k[key], dtype=torch.int64, device=dev)

    u = _xor_rows(_mulmod(const("lane_pow")[None, :], u))
    g = torch.as_tensor((tile + 1) * spans - end, device=dev)
    u = _mulmod(const("pow_lo")[g & 0xFF], u)
    u = _mulmod(const("pow_hi")[g >> 8], u)
    acc = _xor_into(n, torch.as_tensor(tile, device=dev), u)
    return (acc ^ _init_term(tile_bytes)).reshape(lead)


# ---------------------------------------------------------------------- #
# The kernel
# ---------------------------------------------------------------------- #
_CONSTS = {}
_OCCUPANCY = {}


def _device_constants(spans: int, device):
    key = (spans, str(device))
    got = _CONSTS.get(key)
    if got is None:
        k = span_constants(spans)
        got = tuple(
            torch.from_numpy(np.asarray(k[name], dtype=np.uint32)
                             .view(np.int32)).to(device)
            for name in ("lane_pow", "pow_lo", "pow_hi"))
        _CONSTS[key] = got
    return got


def _entry():
    lib = _build.library("tile_checksum")
    fn = lib.tile_crc32
    if fn.argtypes is None:
        p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint)
        fn.argtypes = [p, ll, ll, ll, ll, u, u, p, p, p, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _ctas_per_sm(device) -> int:
    key = str(device)
    if key not in _OCCUPANCY:
        lib, _ = _entry()
        got = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib, lib.tile_crc32_occupancy(ctypes.byref(got)),
                         "tile_checksum occupancy")
        if got.value < 1:
            raise RuntimeError("tile_checksum: no CTA fits on an SM")
        _OCCUPANCY[key] = got.value
    return _OCCUPANCY[key]


def tile_checksum_grid(x: torch.Tensor, tile_dims: int = 2) -> Dict:
    """The kernel's launch for ``x`` (a CUDA tensor): CTAs, CTAs an SM
    holds, SMs, warps, spans, and waves (CTAs over what the card holds at
    once; at most 1, the grid is persistent)."""
    lead, tile_bytes = _tile_shape(x, tile_dims)
    n = int(np.prod(lead, dtype=np.int64))
    spans = -(-tile_bytes // SPAN)
    per_sm = _ctas_per_sm(x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ctas = _n_ctas(n * spans, sms, per_sm)
    return {"ctas": ctas, "ctas_per_sm": per_sm, "sms": sms,
            "warps": ctas * WARPS, "spans": n * spans,
            "waves": ctas / (sms * per_sm)}


def tile_checksum_cuda(x: torch.Tensor, tile_dims: int = 2) -> torch.Tensor:
    """Launch the kernel: the CRC32 of every tile of ``x`` (a contiguous CUDA
    tensor; the last ``tile_dims`` dims form a tile). Returns int64 on the
    card, shaped like the leading dims. Raises on anything the kernel does
    not take, and on a launch error."""
    if not x.is_cuda:
        raise ValueError("tile_checksum_cuda needs a CUDA tensor; use the "
                         "plain version for host tensors")
    if not x.is_contiguous():
        raise ValueError("tile_checksum_cuda needs a contiguous tensor")
    lead, tile_bytes = _tile_shape(x, tile_dims)
    n = int(np.prod(lead, dtype=np.int64))
    init = _init_term(tile_bytes)
    out = torch.full((n,), init - (1 << 32) if init >> 31 else init,
                     dtype=torch.int32, device=x.device)
    if n and tile_bytes:
        spans = -(-tile_bytes // SPAN)
        grid = tile_checksum_grid(x, tile_dims)
        lane_pow, pow_lo, pow_hi = _device_constants(spans, x.device)
        k = span_constants(spans)
        vec = int(x.data_ptr() % 16 == 0 and tile_bytes % 16 == 0)
        lib, fn = _entry()
        code = fn(x.data_ptr(), tile_bytes, tile_bytes, n, spans, k["x512"],
                  k["x4"], lane_pow.data_ptr(), pow_lo.data_ptr(),
                  pow_hi.data_ptr(), grid["ctas"], vec, out.data_ptr(),
                  _build.stream_handle(x.device))
        _build.check(lib, code, "tile_checksum launch")
        tile_checksum_cuda.launches += 1
    return (out.to(torch.int64) & 0xFFFFFFFF).reshape(lead)


tile_checksum_cuda.launches = 0
