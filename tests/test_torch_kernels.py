"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these tests
hold them case for case (``tests/test_kernels.py``'s shapes) against the
reference kernels in Pallas interpret mode, on the same numpy-seeded inputs:
bitwise on integer-grid data, ``rtol = atol = 1e-4`` on normal fp32 (the
reference's own stated tolerance: its K-tiled accumulation vs one flat
dot), ``2e-2`` for bf16 X. The hand-written CUDA kernels themselves are held
against the plain versions by the ``cuda``-marked tests at the end, which
run only with an NVIDIA GPU (and by ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import matvec_ref  # noqa: E402
from repro_torch.kernels.usec_matvec import usec_matvec_cuda  # noqa: E402
from repro_torch.kernels.usec_segmented import (  # noqa: E402
    segmented_plain,
    usec_segmented_cuda,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _operands(rng, m, k, c, bf16):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, c) if c > 1 else (k,)).astype(np.float32)
    if bf16:
        # Both frameworks round fp32 -> bf16 to nearest even: same bits.
        return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                torch.as_tensor(x).to(torch.bfloat16),
                torch.as_tensor(w).to(torch.bfloat16))
    return jnp.asarray(x), jnp.asarray(w), torch.as_tensor(x), \
        torch.as_tensor(w)


@pytest.mark.parametrize(
    "m,k,c,bf16,tol",
    [
        (256, 512, 1, False, 1e-4),
        (300, 517, 1, False, 1e-4),   # ragged M and K
        (64, 100, 3, False, 1e-4),
        (256, 512, 4, True, 2e-2),
        (128, 128, 1, True, 2e-2),
        (1000, 96, 1, False, 1e-4),
    ],
)
def test_usec_matvec_plain_vs_reference_kernel(m, k, c, bf16, tol):
    rng = np.random.default_rng(m * 7 + k)
    xj, wj, xt, wt = _operands(rng, m, k, c, bf16)
    if bf16:
        assert np.array_equal(
            np.asarray(xj.astype(jnp.float32)), xt.float().numpy())
    want = np.asarray(ref_ops.usec_matvec(xj, wj, mode="interpret"))
    got = ops.usec_matvec(xt, wt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,c", [(20, 6000, 1), (37, 517, 3),
                                   (64, 640, 128)])
def test_usec_matvec_bitwise_on_integer_grid(m, k, c):
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 4, size=(m, k)).astype(np.float32)
    w = (rng.integers(-8, 9, size=(k, c)) / 16.0).astype(np.float32)
    want = np.asarray(ref_ops.usec_matvec(x, w, mode="interpret"))
    got = ops.usec_matvec(torch.as_tensor(x), torch.as_tensor(w)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.float64),
                          x.astype(np.float64) @ w.astype(np.float64))


def test_usec_matmat_chunks_match_reference():
    rng = np.random.default_rng(11)
    x = rng.integers(-3, 4, size=(40, 300)).astype(np.float32)
    w = (rng.integers(-8, 9, size=(300, 300)) / 16.0).astype(np.float32)
    want = np.asarray(ref_ops.usec_matmat(x, w, mode="interpret"))
    got = ops.usec_matmat(torch.as_tensor(x), torch.as_tensor(w))
    assert np.array_equal(got.numpy(), want)


def _random_block_list(rng, t, rpt, k, c, b, block_rows):
    staged = rng.normal(size=(t, rpt, k)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    slot = rng.integers(0, t, size=b).astype(np.int32)
    off = (rng.integers(0, rpt // block_rows, size=b)
           * block_rows).astype(np.int32)
    inc = rng.choice([0.0, 1.0], size=b).astype(np.float32)
    return staged, w, slot, off, inc


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("t,rpt,k,c,b", [
    (3, 64, 256, 1, 7),
    (2, 32, 100, 3, 5),     # contraction-dim tail
    (4, 96, 768, 8, 12),
])
def test_usec_segmented_plain_vs_reference_kernel(t, rpt, k, c, b):
    block_rows = 16
    rng = np.random.default_rng(t * 100 + k)
    staged, w, slot, off, inc = _random_block_list(
        rng, t, rpt, k, c, b, block_rows)
    want = np.asarray(ref_ops.usec_segmented(
        staged, slot, off, inc, w, block_rows=block_rows, mode="interpret"))
    st, wt, sl, of, it = _t(staged, w, slot, off, inc)
    got = ops.usec_segmented(st, sl, of, it, wt, block_rows=block_rows)
    assert tuple(got.shape) == (b, block_rows, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_usec_segmented_bitwise_on_integer_grid_data():
    block_rows = 16
    rng = np.random.default_rng(0)
    t, rpt, k, c, b = 3, 64, 640, 2, 9
    staged = rng.integers(-3, 4, size=(t, rpt, k)).astype(np.float32)
    w = (rng.integers(-8, 9, size=(k, c)) / 16.0).astype(np.float32)
    slot = rng.integers(0, t, size=b).astype(np.int32)
    off = (rng.integers(0, rpt // block_rows, size=b)
           * block_rows).astype(np.int32)
    inc = rng.choice([0.0, 1.0], size=b).astype(np.float32)
    want = np.asarray(ref_ops.usec_segmented(
        staged, slot, off, inc, w, block_rows=block_rows, block_k=256,
        mode="interpret"))
    got = ops.usec_segmented(*_t(staged, slot, off, inc, w),
                             block_rows=block_rows).numpy()
    assert np.array_equal(got, want)


def test_usec_segmented_all_workers_matches_per_worker_reference():
    """The batched form (every worker's list at once, trip counts below
    B_max, a zero-trip worker) equals the reference kernel run worker by
    worker, with the blocks past each trip count zero."""
    block_rows, n, t, rpt, k, c, b = 16, 4, 3, 48, 300, 3, 6
    rng = np.random.default_rng(4)
    staged = rng.integers(-3, 4, size=(n, t, rpt, k)).astype(np.float32)
    w = (rng.integers(-8, 9, size=(k, c)) / 16.0).astype(np.float32)
    slot = rng.integers(0, t, size=(n, b)).astype(np.int32)
    off = (rng.integers(0, rpt // block_rows, size=(n, b))
           * block_rows).astype(np.int32)
    inc = rng.choice([0.0, 1.0], size=(n, b)).astype(np.float32)
    n_blocks = np.array([b, 0, 3, 1], dtype=np.int32)
    got = ops.usec_segmented(*_t(staged, slot, off, inc, w),
                             block_rows=block_rows,
                             n_blocks=torch.as_tensor(n_blocks)).numpy()
    assert got.shape == (n, b, block_rows, c)
    for wk in range(n):
        want = np.asarray(ref_ops.usec_segmented(
            staged[wk], slot[wk], off[wk], inc[wk], w,
            block_rows=block_rows, mode="interpret"))
        nb = n_blocks[wk]
        assert np.array_equal(got[wk, :nb], want[:nb])
        assert not got[wk, nb:].any()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    staged, w, slot, off, inc = _random_block_list(rng, 2, 32, 64, 1, 4, 16)
    before = (usec_matvec_cuda.launches, usec_segmented_cuda.launches)
    x = torch.as_tensor(staged[0])
    wt = torch.as_tensor(w)
    for mode in (None, "auto"):
        assert torch.equal(ops.usec_matvec(x, wt, mode=mode),
                           matvec_ref(x, wt))
        assert torch.equal(
            ops.usec_segmented(*_t(staged, slot, off, inc), wt,
                               block_rows=16, mode=mode),
            ops.usec_segmented(*_t(staged, slot, off, inc), wt,
                               block_rows=16, mode="ref"))
    out = torch.empty(32)
    assert ops.usec_matvec(x, wt[:, 0], out=out) is not None
    assert torch.equal(out, matvec_ref(x, wt[:, 0]))
    assert (usec_matvec_cuda.launches,
            usec_segmented_cuda.launches) == before


def test_forcing_the_kernel_on_host_tensors_raises():
    x, w = torch.ones(8, 8), torch.ones(8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.usec_matvec(x, w, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.usec_segmented(torch.ones(1, 16, 8), torch.zeros(2),
                           torch.zeros(2), torch.ones(2), w, block_rows=16,
                           mode="cuda")


@pytest.mark.parametrize("mode", ["pallas", "interpret", "triton"])
def test_unknown_modes_raise(mode):
    x, w = torch.ones(8, 8), torch.ones(8)
    with pytest.raises(ValueError, match="'cuda'"):
        ops.usec_matvec(x, w, mode=mode)
    with pytest.raises(ValueError):
        ops.executor_matmul(mode)


# ---------------------------------------------------------------------- #
# The CUDA kernels themselves (need the card)
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,c", [(20, 6000, 1), (300, 517, 3),
                                   (20, 6000, 128)])
def test_usec_matvec_kernel_vs_plain_on_card(cuda_device, m, k, c):
    rng = np.random.default_rng(m + k + c)
    x = torch.as_tensor(rng.integers(-3, 4, size=(m, k + 8))
                        .astype(np.float32), device=cuda_device)[:, 4:4 + k]
    w = torch.as_tensor((rng.integers(-8, 9, size=(k, c)) / 16.0)
                        .astype(np.float32), device=cuda_device)
    before = usec_matvec_cuda.launches
    assert torch.equal(ops.usec_matvec(x, w), matvec_ref(x, w))
    assert usec_matvec_cuda.launches == before + 1
    xn = torch.randn((m, k), device=cuda_device)
    wn = torch.randn((k, c), device=cuda_device)
    ref = matvec_ref(xn, wn)
    err = (ops.usec_matvec(xn, wn) - ref).abs().max() / ref.abs().max()
    assert float(err) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k,c", [(6000, 1), (517, 3), (640, 128)])
def test_usec_segmented_kernel_vs_plain_on_card(cuda_device, k, c):
    rng = np.random.default_rng(k + c)
    n, t, rpt, b, br = 6, 3, 60, 6, 20
    dev = cuda_device
    staged = torch.as_tensor(rng.integers(-3, 4, size=(n, t, rpt, k))
                             .astype(np.float32), device=dev)
    w = torch.as_tensor((rng.integers(-8, 9, size=(k, c)) / 16.0)
                        .astype(np.float32), device=dev)
    slot = torch.as_tensor(rng.integers(0, t, size=(n, b)),
                           dtype=torch.int32, device=dev)
    off = torch.as_tensor(rng.integers(0, rpt // br, size=(n, b)) * br,
                          dtype=torch.int32, device=dev)
    inc = torch.as_tensor(rng.integers(0, 2, size=(n, b)),
                          dtype=torch.float32, device=dev)
    nb = torch.as_tensor([6, 0, 2, 5, 1, 6], dtype=torch.int32, device=dev)
    args = (staged, slot, off, inc, nb, w, br)
    assert torch.equal(usec_segmented_cuda(*args), segmented_plain(*args))
