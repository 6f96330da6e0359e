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

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.ref import matvec_ref  # noqa: E402
from repro_torch.kernels.usec_matvec import usec_matvec_cuda  # noqa: E402
from repro_torch.kernels.usec_segmented import (  # noqa: E402
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


# tests/test_kernels.py's flash-attention cases.
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True, None, "float32"),
    (2, 4, 2, 100, 260, 64, True, None, "float32"),    # GQA, ragged
    (1, 2, 1, 64, 300, 32, False, None, "float32"),    # bidirectional
    (1, 2, 2, 256, 256, 64, True, 128, "float32"),     # sliding window
    (1, 4, 4, 1, 384, 64, True, None, "float32"),      # decode shape
    (1, 2, 2, 200, 200, 128, True, 64, "float32"),
    (1, 2, 2, 128, 128, 64, True, None, "bfloat16"),
]


def _flash_operands(rng, b, h, hk, sq, skv, d, dtype):
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((b, h, sq, d), (b, hk, skv, d), (b, hk, skv, d))]
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays])


@pytest.mark.parametrize("b,h,hk,sq,skv,d,causal,window,dtype", FLASH_CASES)
def test_flash_attention_plain_vs_reference_kernel(b, h, hk, sq, skv, d,
                                                   causal, window, dtype):
    """The port's plain flash attention against the Pallas kernel in
    interpret mode, within the reference test's own tolerance (2e-3 fp32,
    2e-2 bf16)."""
    rng = np.random.default_rng(b + h + sq + skv)
    (qj, kj, vj), (qt, kt, vt) = _flash_operands(rng, b, h, hk, sq, skv, d,
                                                 dtype)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                   mode="interpret")
    before = flash_attention_cuda.launches
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert flash_attention_cuda.launches == before
    assert got.dtype == qt.dtype and tuple(got.shape) == want.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_flash_attention_routes():
    q = torch.ones(1, 2, 4, 32)
    k = torch.ones(1, 1, 4, 32)
    assert torch.equal(ops.flash_attention(q, k, k, mode="ref"),
                       flash_attention_plain(q, k, k))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k, mode="cuda")
    for mode in ("pallas", "interpret"):
        with pytest.raises(ValueError, match="'cuda'"):
            ops.flash_attention(q, k, k, mode=mode)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_plain(q, torch.ones(1, 3, 4, 32), torch.ones(1, 3, 4, 32))


# The bf16 limits of chip_smoke.py's ATTN_TOL: both sides compute in fp32
# and round once, so they may differ by about 2.5 bf16 ulps.
BF16_RTOL, BF16_ATOL = 1e-2, 1e-4


def _tc_emulation(q, k, v, causal, window, split=True):
    """The bf16 tensor-core kernel's arithmetic (csrc/flash_attention_tc.cu)
    in plain PyTorch: KV tiles of 128 keys (64 at d = 256); S = Q·Kᵀ from
    bf16 operands with fp32 sums; the online softmax in the log2 domain with
    the finite -1e30 mask; l summed from the fp32 p; P·V from p split into
    two bf16 parts into one fp32 accumulator (only the first part when
    ``split`` is False); the output rounded once."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // hk, dim=1)
    vf = v.float().repeat_interleave(h // hk, dim=1)
    qf = q.float()
    bk = 64 if d > 128 else 128
    c = d ** -0.5 * math.log2(math.e)
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, bk):
        k1 = min(k0 + bk, skv)
        kpos = torch.arange(k0, k1)[None, :]
        live = torch.ones((sq, k1 - k0), dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window:
            live &= kpos > qpos - window
        s = torch.where(live, (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * c,
                        -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(live, torch.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16)
        o = o * alpha + p_hi.float() @ vf[:, :, k0:k1]
        if split:
            p_lo = (p - p_hi.float()).to(torch.bfloat16)
            o = o + p_lo.float() @ vf[:, :, k0:k1]
        m = m_new
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def _bf16_attention_operands(seed, h, hk, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32))
            .to(torch.bfloat16)
            for s in ((1, h, sq, d), (1, hk, skv, d), (1, hk, skv, d))]


def _outside_bf16_limit(got, want):
    """How many outputs miss the bf16 limit."""
    err = (got.float() - want.float()).abs()
    return int((err > BF16_ATOL + BF16_RTOL * want.float().abs()).sum())


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_split_p_emulation_within_bf16_limits(d, window):
    """The tensor-core kernel's rounding (split P) stays within the smoke's
    bf16 limits of the plain version at every head_dim, causal and
    windowed, with GQA 2:1 and a KV sequence longer than the queries."""
    q, k, v = _bf16_attention_operands(d, 4, 2, 700, 1024, d)
    got = _tc_emulation(q, k, v, True, window)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    assert _outside_bf16_limit(got, want) == 0


def test_single_bf16_p_misses_bf16_limits():
    """The limits have teeth: with P rounded once to bf16 (no P_lo), the
    same arithmetic misses them on some outputs at sq = skv = 1024,
    d = 128."""
    q, k, v = _bf16_attention_operands(128, 2, 1, 1024, 1024, 128)
    want = flash_attention_plain(q, k, v, causal=True)
    assert _outside_bf16_limit(_tc_emulation(q, k, v, True, None), want) == 0
    single = _tc_emulation(q, k, v, True, None, split=False)
    assert _outside_bf16_limit(single, want) > 0


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
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vs_plain_on_card(cuda_device, d, dtype):
    """GQA 4:1, causal, ragged lengths; a windowed call; queries with no
    live key (sq > skv) give 0; GQA 16:1 with sq not a multiple of 128 and
    skv > sq. Bitwise run to run. bf16 goes to the tensor-core kernel, fp32
    to the FFMA kernel. Both sides compute in fp32 and round once, so bf16
    allows about 2.5 ulps (rtol 1e-2)."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    rtol, atol = (1e-2, 1e-4) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    route = ("launches_tc" if dtype == torch.bfloat16 else "launches_ffma")
    other = ("launches_ffma" if dtype == torch.bfloat16 else "launches_tc")
    for (b, h, hk, sq, skv, window) in ((2, 8, 2, 200, 333, None),
                                        (2, 8, 2, 300, 300, 96),
                                        (2, 8, 2, 100, 60, None),
                                        (1, 16, 1, 200, 333, None)):
        q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
                   for s in ((b, h, sq, d), (b, hk, skv, d), (b, hk, skv, d)))
        before = {n: getattr(flash_attention_cuda, n)
                  for n in ("launches", route, other)}
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        assert flash_attention_cuda.launches == before["launches"] + 1
        assert getattr(flash_attention_cuda, route) == before[route] + 1
        assert getattr(flash_attention_cuda, other) == before[other]
        assert torch.equal(got, ops.flash_attention(q, k, v, window=window))
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        live = torch.isfinite(want.float()).all(dim=-1)
        err = (got.float() - want.float()).abs()[live]
        assert bool((err <= atol + rtol * want.float().abs()[live]).all())
        assert not bool(got[~live].any())
