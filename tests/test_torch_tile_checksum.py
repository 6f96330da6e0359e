"""The tile audit's checksum: ``tile_checksum`` (the kernel's plain version
on the host, the kernel itself on the card) against ``zlib.crc32``, and the
runner's audit counters on the host path it keeps.

The checksum cuts a tile into 512-byte chunks counted from its end and folds
the chunks' CRCs with zlib's combine algebra; the cases below straddle every
boundary of that scheme (empty tiles, tails of 1 to 511 bytes, one chunk,
one CTA's 256 chunks and more) and include all-zero and all-ones tiles.
Tolerance: bit for bit (an integer checksum).
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, strategies as st  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.tile_checksum import (  # noqa: E402
    CHUNK,
    THREADS,
    tile_checksum_cuda,
    tile_checksum_plain,
)


def _zlib_rows(x: np.ndarray):
    """zlib's CRC32 of each row of a 2-d array."""
    return [zlib.crc32(np.ascontiguousarray(r).tobytes()) for r in x]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@given(
    n_chunks=st.integers(min_value=0, max_value=2 * THREADS + 3),
    tail=st.integers(min_value=0, max_value=CHUNK - 1),
    fill=st.sampled_from(("random", "zeros", "ones")),
    n_tiles=st.integers(min_value=1, max_value=3),
    seed=st.integers(min_value=0, max_value=2 ** 16),
)
def test_plain_equals_zlib_property(n_chunks, tail, fill, n_tiles, seed):
    """Any tile length (whole chunks plus a tail that straddles the chunk
    boundary), random, all-zero and all-ones bytes: the plain version is
    zlib's CRC32 of every tile."""
    length = n_chunks * CHUNK + tail
    rng = np.random.default_rng(seed)
    if fill == "random":
        x = rng.integers(0, 256, size=(n_tiles, length), dtype=np.uint8)
    else:
        x = np.full((n_tiles, length), 0 if fill == "zeros" else 255,
                    dtype=np.uint8)
    got = tile_checksum_plain(torch.from_numpy(x), tile_dims=1)
    assert got.dtype == torch.int64
    assert got.tolist() == _zlib_rows(x)


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
@pytest.mark.parametrize("tile_bytes", [1, 511, 512, 513, 4096,
                                        CHUNK * THREADS + 16,
                                        3 * CHUNK * THREADS + 1,
                                        1000 * 6000 * 4])
def test_tile_checksum_kernel_vs_zlib_on_card(cuda_device, tile_bytes):
    """One launch checksums every tile: random, all-zero and all-ones
    bytes, 16-byte aligned lengths (the vector path) and odd ones (the
    byte path), up to one Sec. V cyclic tile (24 MB)."""
    rng = np.random.default_rng(tile_bytes)
    n = 3 if tile_bytes < 10 ** 7 else 2
    for fill in ("random", "zeros", "ones"):
        if fill == "random":
            x = rng.integers(0, 256, size=(n, tile_bytes), dtype=np.uint8)
        else:
            x = np.full((n, tile_bytes), 0 if fill == "zeros" else 255,
                        dtype=np.uint8)
        before = tile_checksum_cuda.launches
        got = ops.tile_checksum(torch.from_numpy(x).to(cuda_device), 1)
        assert tile_checksum_cuda.launches == before + 1
        assert got.cpu().tolist() == _zlib_rows(x)
