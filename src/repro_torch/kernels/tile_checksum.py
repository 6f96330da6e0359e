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
(6 x 3000 x 6000 fp32, 432 MB) takes 0.129 ms at 3.35 TB/s.

Design: a tile is cut into :data:`CHUNK`-byte chunks counted from its end,
so only the head chunk is partial and its missing bytes act as leading zeros.
One thread computes one chunk's raw CRC (zero start, no final XOR) with
slicing-by-4 tables in shared memory; the chunk CRCs are folded with zlib's
``crc32_combine`` algebra: chunk ``j`` (from the end) is multiplied by
``x^(8 * CHUNK * j)`` mod P, the products are XORed, and the constant term
``x^(8L) * 0xFFFFFFFF ^ 0xFFFFFFFF`` brings in zlib's initial value and
final XOR. The powers are precomputed here (two small tables: within a CTA
and per CTA). The plain version runs the same chunked algorithm with
vectorized table gathers over all chunks at once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["CHUNK", "tile_checksum_cuda", "tile_checksum_plain"]

POLY = 0xEDB88320   # zlib's reflected CRC-32 polynomial
CHUNK = 512         # bytes a thread CRCs (csrc/tile_checksum.cu's kChunk)
THREADS = 256       # chunks a CTA folds (kThreads)
_MAX_TILES = 65535  # the grid's y dimension


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
    p, sq = 1 << 31, 1 << 23   # x^0, and x^8 (appending one byte)
    while n:
        if n & 1:
            p = _multmodp(sq, p)
        sq = _multmodp(sq, sq)
        n >>= 1
    return p


def _init_term(tile_bytes: int) -> int:
    """zlib's initial value carried through the tile, and its final XOR."""
    return _multmodp(_x8n(tile_bytes), 0xFFFFFFFF) ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _powers(n_ctas: int) -> Tuple[List[int], List[int]]:
    """(pow_t, pow_b): ``x^(8 CHUNK t)`` for the THREADS chunks of a CTA and
    ``x^(8 CHUNK THREADS b)`` for the ``n_ctas`` CTAs of a tile."""
    pow_t, step = [1 << 31], _x8n(CHUNK)
    for _ in range(THREADS - 1):
        pow_t.append(_multmodp(step, pow_t[-1]))
    pow_b, step = [1 << 31], _x8n(CHUNK * THREADS)
    for _ in range(n_ctas - 1):
        pow_b.append(_multmodp(step, pow_b[-1]))
    return pow_t, pow_b


def _tile_shape(x: torch.Tensor, tile_dims: int) -> Tuple[tuple, int]:
    if not 0 <= tile_dims <= x.ndim:
        raise ValueError(f"tile_dims={tile_dims} for a {x.ndim}-d tensor")
    lead = tuple(x.shape[: x.ndim - tile_dims])
    n_elem = int(np.prod(x.shape[x.ndim - tile_dims:], dtype=np.int64))
    return lead, n_elem * x.element_size()


# ---------------------------------------------------------------------- #
# Plain PyTorch version
# ---------------------------------------------------------------------- #
def _tables(device) -> torch.Tensor:
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        t0.append(c)
    tabs = [t0]
    for _ in range(3):
        prev = tabs[-1]
        tabs.append([(v >> 8) ^ t0[v & 0xFF] for v in prev])
    return torch.tensor(tabs, dtype=torch.int64, device=device)


def _mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``a * b`` mod P over int64 tensors holding 32-bit values."""
    a, b = torch.broadcast_tensors(a, b)
    p = torch.zeros_like(b)
    for i in range(31, -1, -1):
        p = p ^ torch.where(((a >> i) & 1) == 1, b, 0)
        b = torch.where((b & 1) == 1, (b >> 1) ^ POLY, b >> 1)
    return p


def _xor_rows(c: torch.Tensor) -> torch.Tensor:
    """XOR over dim 1 of an (n, m) int64 tensor, as a pairwise tree."""
    while c.shape[1] > 1:
        if c.shape[1] % 2:
            c = torch.cat([c, torch.zeros_like(c[:, :1])], dim=1)
        c = c[:, 0::2] ^ c[:, 1::2]
    return c[:, 0] if c.shape[1] else torch.zeros_like(c[:, 0])


def tile_checksum_plain(x: torch.Tensor, tile_dims: int = 2) -> torch.Tensor:
    """Plain version of the kernel, on whatever device ``x`` lies on.

    The last ``tile_dims`` dims of ``x`` form a tile, the leading dims index
    the tiles. Returns int64 CRC32s (values in [0, 2^32)) of each tile's
    bytes, shaped like the leading dims: ``zlib.crc32`` of each tile."""
    lead, tile_bytes = _tile_shape(x, tile_dims)
    n = int(np.prod(lead, dtype=np.int64))
    dev = x.device
    if n == 0 or tile_bytes == 0:
        return torch.zeros(lead, dtype=torch.int64, device=dev)
    b = x.contiguous().reshape(-1).view(torch.uint8).reshape(n, tile_bytes)
    n_chunks = -(-tile_bytes // CHUNK)
    pad = n_chunks * CHUNK - tile_bytes
    if pad:
        b = torch.cat([torch.zeros((n, pad), dtype=torch.uint8, device=dev),
                       b], dim=1)
    b = b.reshape(n, n_chunks, CHUNK)
    tab = _tables(dev)
    c = torch.zeros((n, n_chunks), dtype=torch.int64, device=dev)
    for k in range(0, CHUNK, 4):
        w = b[:, :, k: k + 4].to(torch.int64)
        c = c ^ (w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
                 | (w[..., 3] << 24))
        c = (tab[3][c & 0xFF] ^ tab[2][(c >> 8) & 0xFF]
             ^ tab[1][(c >> 16) & 0xFF] ^ tab[0][c >> 24])
    # Chunk i from the start is chunk n_chunks - 1 - i from the end.
    pow_t, pow_b = _powers(-(-n_chunks // THREADS))
    j = torch.arange(n_chunks - 1, -1, -1, device=dev)
    pw = _mulmod(torch.tensor(pow_b, dtype=torch.int64, device=dev)[
        j // THREADS], torch.tensor(pow_t, dtype=torch.int64, device=dev)[
        j % THREADS])
    acc = _xor_rows(_mulmod(pw[None, :], c))
    return (acc ^ _init_term(tile_bytes)).reshape(lead)


# ---------------------------------------------------------------------- #
# The kernel
# ---------------------------------------------------------------------- #
_TABLES = {}


def _device_powers(n_ctas: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (n_ctas, str(device))
    got = _TABLES.get(key)
    if got is None:
        got = tuple(
            torch.from_numpy(np.asarray(v, dtype=np.uint32).view(np.int32))
            .to(device) for v in _powers(n_ctas))
        _TABLES[key] = got
    return got


def _entry():
    lib = _build.library("tile_checksum")
    fn = lib.tile_crc32
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, i, p, p, i, ctypes.c_uint, i, p, p]
        fn.restype = ctypes.c_int
    return lib, fn


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
    if n > _MAX_TILES:
        raise ValueError(f"{n} tiles exceed the kernel's grid ({_MAX_TILES})")
    out = torch.zeros((n,), dtype=torch.int32, device=x.device)
    if n and tile_bytes:
        n_ctas = -(-(-(-tile_bytes // CHUNK)) // THREADS)
        pow_t, pow_b = _device_powers(n_ctas, x.device)
        vec = int(x.data_ptr() % 16 == 0 and tile_bytes % 16 == 0)
        lib, fn = _entry()
        code = fn(x.data_ptr(), tile_bytes, tile_bytes, n, pow_t.data_ptr(),
                  pow_b.data_ptr(), n_ctas, _init_term(tile_bytes), vec,
                  out.data_ptr(), _build.stream_handle(x.device))
        _build.check(lib, code, "tile_checksum launch")
        tile_checksum_cuda.launches += 1
    return (out.to(torch.int64) & 0xFFFFFFFF).reshape(lead)


tile_checksum_cuda.launches = 0
