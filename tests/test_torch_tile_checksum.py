"""The tile audit's checksum: ``tile_checksum`` (the kernel's plain version
on the host, the kernel itself on the card) against ``zlib.crc32``, and the
runner's audit counters on the host path it keeps.

The checksum cuts a tile into 512-byte spans counted from its end, deals the
buffer's spans out as one contiguous run per warp (cut where a tile ends),
and folds each piece's lane registers with zlib's combine algebra and the
wrapper's precomputed multipliers; the plain version runs the same split for
any number of warps. The cases below straddle every boundary of that scheme
(empty tiles, a partial head span, exactly one span, a span and a byte,
several spans a tile, more spans than warps and more warps than spans, runs
crossing tile ends) and include all-zero and all-ones tiles.
Tolerance: bit for bit (an integer checksum).
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, strategies as st  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.tile_checksum import (  # noqa: E402
    SPAN,
    WARPS,
    _multmodp,
    _x8n,
    span_constants,
    tile_checksum_cuda,
    tile_checksum_plain,
)

# Tile lengths on the boundaries of the span split (the kernel's 16-byte
# vector path and its byte path both).
BOUNDARY_BYTES = (1, 3, 16, SPAN - 1, SPAN, SPAN + 1, SPAN + 16, 2 * SPAN,
                  4096 + 17, 37 * SPAN, 37 * SPAN + 1)


def _zlib_rows(x: np.ndarray):
    """zlib's CRC32 of each row of a 2-d array."""
    return [zlib.crc32(np.ascontiguousarray(r).tobytes()) for r in x]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _bytes(rng, fill, n, length):
    if fill == "random":
        return rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    return np.full((n, length), 0 if fill == "zeros" else 255,
                   dtype=np.uint8)


@given(
    n_spans=st.integers(min_value=0, max_value=40),
    tail=st.integers(min_value=0, max_value=SPAN - 1),
    fill=st.sampled_from(("random", "zeros", "ones")),
    n_tiles=st.integers(min_value=1, max_value=3),
    n_warps=st.sampled_from((1, 2, 3, 7, WARPS, 132 * WARPS)),
    seed=st.integers(min_value=0, max_value=2 ** 16),
)
def test_plain_equals_zlib_property(n_spans, tail, fill, n_tiles, n_warps,
                                    seed):
    """Any tile length (whole spans plus a tail that makes the head span
    partial), random, all-zero and all-ones bytes, the spans split over
    any number of warps (runs of many spans, runs across tile ends, more
    warps than spans): the plain version is zlib's CRC32 of every tile."""
    length = n_spans * SPAN + tail
    x = _bytes(np.random.default_rng(seed), fill, n_tiles, length)
    got = tile_checksum_plain(torch.from_numpy(x), tile_dims=1,
                              n_warps=n_warps)
    assert got.dtype == torch.int64
    assert got.tolist() == _zlib_rows(x)


@pytest.mark.parametrize("n_warps", [1, 5, 132 * WARPS])
@pytest.mark.parametrize("tile_bytes", BOUNDARY_BYTES)
def test_plain_span_boundaries_equal_zlib(tile_bytes, n_warps):
    """The span split's boundary lengths: a partial head, exactly one span,
    a span and one byte, a span and 16 bytes, several spans; one warp (one
    run across every tile), a few, and the H100 grid's 4224 warps (more
    warps than spans)."""
    rng = np.random.default_rng(tile_bytes)
    for fill in ("random", "zeros", "ones"):
        x = _bytes(rng, fill, 3, tile_bytes)
        got = tile_checksum_plain(torch.from_numpy(x), 1, n_warps=n_warps)
        assert got.tolist() == _zlib_rows(x)


def test_span_constants_equal_zlib():
    """The multipliers the wrapper hands the kernel, against zlib: a word at
    lane l, word q of a span is carried to the span's end by A4^(3-q) and
    lane_pow[l]; x512 and x4 are the chain's and the fold's steps; pow_lo
    and pow_hi carry a span's raw CRC over g later spans, for every g the
    tables hold (the plain version split into one-span runs uses each)."""
    k = span_constants(600)
    rng = np.random.default_rng(19)

    def raw(msg: bytes) -> int:
        # zlib's register with a zero start and no final XOR.
        return zlib.crc32(msg, 0xFFFFFFFF) ^ zlib.crc32(b"\0" * len(msg),
                                                         0xFFFFFFFF)

    for lane in range(32):
        for q in range(4):
            w = int(rng.integers(1, 2 ** 32))
            msg = bytearray(SPAN)
            msg[16 * lane + 4 * q: 16 * lane + 4 * q + 4] = w.to_bytes(
                4, "little")
            u = w
            for _ in range(3 - q):
                u = _multmodp(k["x4"], u)
            assert _multmodp(k["lane_pow"][lane], u) == raw(bytes(msg))
    assert k["x512"] == _x8n(SPAN) and k["x4"] == _x8n(4)
    span = rng.integers(0, 256, size=SPAN, dtype=np.uint8).tobytes()
    for g in (0, 1, 255, 256, 257, 599):
        hi, lo = k["pow_hi"][g >> 8], k["pow_lo"][g & 255]
        assert _multmodp(hi, _multmodp(lo, raw(span))) == raw(
            span + b"\0" * (SPAN * g))
    assert len(k["pow_lo"]) == 256 and len(k["pow_hi"]) == 3
    x = rng.integers(0, 256, size=(2, 600 * SPAN), dtype=np.uint8)
    assert tile_checksum_plain(torch.from_numpy(x), 1,
                               n_warps=1200).tolist() == _zlib_rows(x)


def test_plain_unaligned_base_equals_zlib():
    """A tile buffer that starts one byte past an allocation (the kernel's
    byte path on the card), tiles of odd length."""
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.integers(0, 256, size=4 * 1333 + 1,
                                        dtype=np.uint8))
    x = buf[1:].view(4, 1333)
    assert tile_checksum_plain(x, 1, n_warps=3).tolist() == _zlib_rows(
        x.numpy())


@pytest.mark.parametrize("shape", [(2, 3, 40, 6), (6, 3, 20, 517),
                                   (1, 1, 1, 1), (2, 2, 0, 5)])
def test_staged_buffer_tiles_equal_zlib(shape):
    """A staged (N, slots, rows, cols) fp32 buffer: one checksum per
    (worker, slot) tile, shaped (N, slots), through the ops route."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    got = ops.tile_checksum(torch.from_numpy(x), 2)
    assert tuple(got.shape) == shape[:2]
    assert got.reshape(-1).tolist() == _zlib_rows(
        x.reshape(shape[0] * shape[1], shape[2] * shape[3]))


def test_cpu_route_never_launches_the_kernel():
    before = tile_checksum_cuda.launches
    ops.tile_checksum(torch.ones(2, 3, 4), 1)
    assert tile_checksum_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tile_checksum_cuda(torch.ones(2, 3, 4))


def test_checker_precomputed_sums_and_staging_check():
    """The checker compares whichever checksums it is handed: zlib over
    the host copy, or precomputed ones (the card's). ``tile_mismatches``
    (the staging-time check) counts no audit."""
    from repro_torch.core import cyclic_placement
    from repro_torch.faults import IntegrityChecker
    from repro_torch.faults.integrity import corrupt_tile
    from repro_torch.runtime import make_exact_matrix, stage_matrix

    x = make_exact_matrix(96, 0)
    pl = cyclic_placement(4, 4, 3)
    sm = stage_matrix(x, pl, 24)
    chk = IntegrityChecker(x, staged=sm.staged, slot_of=sm.slot_of,
                           holders=pl.holders, block_rows=8)
    sums = ops.tile_checksum(torch.from_numpy(sm.staged), 2).numpy()
    assert chk.tile_mismatches(None, sums=sums) == []
    assert chk.tile_audits == 0
    corrupt_tile(sm.staged[1, 0])
    want = chk.audit_tiles(sm.staged)
    bad = ops.tile_checksum(torch.from_numpy(sm.staged), 2).numpy()
    assert chk.audit_tiles(None, sums=bad) == want == [
        (1, 0, int(chk.tile_of[(1, 0)]))]
    assert chk.tile_audits == 2
    g = want[0][2]
    assert chk.find_donor(None, g, 1, range(4), sums=bad) == \
        chk.find_donor(sm.staged, g, 1, range(4))


@pytest.mark.parametrize("segmented", [None, "auto"])
def test_runner_cpu_audit_counters(segmented):
    """On the host the runner keeps the zlib audit of the host copy: one
    ``tile_audits`` count per verified step, one re-stage per corrupt
    tile, and the run stays bitwise the clean one."""
    from test_torch_faults import engine, schedule

    from repro_torch.runtime import make_exact_matrix

    def run(faults):
        eng = engine("repro_torch", segmented=segmented, device="cpu",
                     verify_results="always")
        return eng.run(make_exact_matrix(384, 0), n_steps=5,
                       faults=schedule("repro_torch", faults))

    clean = run(None)
    hit = run([("tile_corruption", 2, 3)])
    assert clean.integrity["tile_audits"] == hit.integrity["tile_audits"] == 5
    assert (clean.integrity["restaged"], hit.integrity["restaged"]) == (0, 1)
    assert [r.action for r in hit.fault_records] == ["restaged"]
    assert hit.result.eigvec.tobytes() == clean.result.eigvec.tobytes()


# ---------------------------------------------------------------------- #
# The kernel itself (needs the card)
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("tile_bytes", sorted(set(BOUNDARY_BYTES) | {
    4096, SPAN * WARPS + 16, 3 * SPAN * WARPS + 1, 1000 * 6000 * 4}))
def test_tile_checksum_kernel_vs_zlib_on_card(cuda_device, tile_bytes):
    """One launch checksums every tile: random, all-zero and all-ones
    bytes, 16-byte aligned lengths (the vector path) and odd ones (the
    byte path), the span split's boundaries, up to one Sec. V cyclic tile
    (24 MB)."""
    rng = np.random.default_rng(tile_bytes)
    n = 3 if tile_bytes < 10 ** 7 else 2
    for fill in ("random", "zeros", "ones"):
        x = _bytes(rng, fill, n, tile_bytes)
        before = tile_checksum_cuda.launches
        got = ops.tile_checksum(torch.from_numpy(x).to(cuda_device), 1)
        assert tile_checksum_cuda.launches == before + 1
        assert got.cpu().tolist() == _zlib_rows(x)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_bytes", [3, 16])
def test_tile_checksum_kernel_many_tiles_and_unaligned_base(cuda_device,
                                                            tile_bytes):
    """More than 65,535 tiles in one launch (the first design's grid limit),
    and a buffer one byte past an allocation (the byte path)."""
    n = 70_001
    rng = np.random.default_rng(tile_bytes)
    x = rng.integers(0, 256, size=(n, tile_bytes), dtype=np.uint8)
    got = ops.tile_checksum(torch.from_numpy(x).to(cuda_device), 1)
    assert got.cpu().tolist() == _zlib_rows(x)
    buf = torch.from_numpy(rng.integers(0, 256, size=3 * 4099 + 1,
                                        dtype=np.uint8)).to(cuda_device)
    shifted = buf[1:].view(3, 4099)
    assert shifted.data_ptr() % 16 == 1
    assert ops.tile_checksum(shifted, 1).cpu().tolist() == _zlib_rows(
        shifted.cpu().numpy())
