"""The segmented kernel's two routes: which one a call takes, what the
wrapper refuses, and (on the card) both kernels against the plain version.

The wrapper picks the kernel from W's width alone
(:func:`segmented_route`): one column goes to the warp-per-row kernel, more
to the tiled kernel, which stages W in shared memory for 48 rows and reads
X once. The ``cuda`` cases hold each kernel bitwise to
:func:`segmented_plain` on integer-grid data (every partial sum exact in
fp32, so the summation order cannot show), within ``1e-5`` of the largest
output on normal data (fp32 sums in another order), and bitwise run to run.
This file imports no JAX, so it runs on the card as it is:

    PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_usec_segmented.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.usec_segmented import (  # noqa: E402
    _check_args,
    segmented_plain,
    segmented_route,
    usec_segmented_cuda,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("c", [1, 2, 3, 7, 8, 31, 32, 33, 128])
def test_route_is_warp_for_one_column_and_tiled_above(c):
    assert segmented_route(c) == ("warp" if c == 1 else "tiled")


def _args(n=2, t=3, rpt=40, k=24, b=4, c=32, br=20):
    return [torch.zeros((n, t, rpt, k)),
            torch.zeros((n, b), dtype=torch.int32),
            torch.zeros((n, b), dtype=torch.int32),
            torch.ones((n, b)),
            torch.full((n,), b, dtype=torch.int32),
            torch.zeros((k, c)), br]


def test_checked_shapes_of_a_call_the_kernels_take():
    assert _check_args(*_args()) == (2, 3, 40, 24, 4, 32)


def _huge_stride(a):
    # one worker, so the view needs no storage past its first worker
    a[0] = a[0].as_strided((1, 3, 40, 24), (2 ** 31, 40 * 24, 24, 1))
    a[1:5] = [p[:1] for p in a[1:5]]


def _wide_w(a):
    c = 32 * 65535 + 1
    a[5] = torch.empty(c).as_strided((24, c), (0, 1))


@pytest.mark.parametrize("bad,match", [
    (lambda a: a.__setitem__(0, a[0].double()), "staged must be"),
    (lambda a: a.__setitem__(0, a[0][0]), "staged must be"),
    (lambda a: a.__setitem__(1, a[1][:1]), "plan arrays must be"),
    (lambda a: a.__setitem__(1, a[1].long()), "blk_slot"),
    (lambda a: a.__setitem__(2, a[2].t().contiguous().t()), "blk_off"),
    (lambda a: a.__setitem__(3, a[3].int()), "blk_include"),
    (lambda a: a.__setitem__(4, a[4][:1]), "n_blocks"),
    (lambda a: a.__setitem__(5, torch.zeros((23, 32))), "w must be"),
    (lambda a: a.__setitem__(5, torch.zeros((24, 32)).half()), "w must be"),
    (lambda a: a.__setitem__(6, 16), "must divide"),
    (lambda a: a.__setitem__(6, 0), "must divide"),
    (lambda a: a.__setitem__(0, a[0].transpose(2, 3).contiguous()
                             .transpose(2, 3)), "unit column stride"),
    (lambda a: a.__setitem__(5, torch.zeros((32, 24)).t()),
     "unit column stride"),
    (_huge_stride, "exceeds int32"),
    (_wide_w, "tiled kernel's grid"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(bad, match):
    a = _args()
    bad(a)
    with pytest.raises(ValueError, match=match):
        _check_args(*a)


def test_host_tensors_never_reach_a_kernel():
    before = (usec_segmented_cuda.launches,
              usec_segmented_cuda.launches_tiled)
    with pytest.raises(ValueError, match="CUDA"):
        usec_segmented_cuda(*_args())
    assert (usec_segmented_cuda.launches,
            usec_segmented_cuda.launches_tiled) == before


def _layout(full, k):
    """``full``'s first ``k`` entries of its last axis: a view whose rows
    start 16-byte aligned when the full width is a multiple of 4."""
    return full[..., :k]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,c", [(6000, 1), (517, 3), (640, 128)]
    + [(k, c) for k in (517, 6007) for c in (2, 8, 32, 33)])
def test_usec_segmented_kernel_vs_plain_on_card(cuda_device, k, c):
    """Each (K, C) twice: contiguous (rows unaligned at odd K, W at odd C)
    and as views of buffers padded to a multiple of 4 (aligned rows, ragged
    tail). 12 blocks of 20 rows a worker, so a 48-row tile spans several
    plan blocks with unrelated (slot, offset); a worker with no blocks, one
    whose real rows end inside a tile, include weights 0 and 1, and one
    slot outside the buffer, which turns that block alone into NaN."""
    rng = np.random.default_rng(k + c)
    n, t, rpt, b, br = 6, 3, 120, 12, 20
    dev = cuda_device
    tiled = segmented_route(c) == "tiled"
    nb = torch.as_tensor([12, 0, 2, 5, 1, 12], dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.integers(0, t, size=(n, b)),
                           dtype=torch.int32, device=dev)
    off = torch.as_tensor(rng.integers(0, rpt // br, size=(n, b)) * br,
                          dtype=torch.int32, device=dev)
    inc = torch.as_tensor(rng.integers(0, 2, size=(n, b)),
                          dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(k * 100 + c)
    for pad in (0, 4 + (-k % 4)):
        kw, cw = k + pad, c + (-c % 4 if pad else 0)
        staged = _layout(torch.as_tensor(
            rng.integers(-3, 4, size=(n, t, rpt, kw)).astype(np.float32),
            device=dev), k)
        w = torch.as_tensor((rng.integers(-8, 9, size=(k, cw)) / 16.0)
                            .astype(np.float32), device=dev)[:, :c]
        args = (staged, slot, off, inc, nb, w, br)
        before = (usec_segmented_cuda.launches,
                  usec_segmented_cuda.launches_tiled)
        got = usec_segmented_cuda(*args)
        assert usec_segmented_cuda.launches == before[0] + 1
        assert usec_segmented_cuda.launches_tiled == before[1] + int(tiled)
        assert torch.equal(got, segmented_plain(*args))
        assert torch.equal(usec_segmented_cuda(*args), got)

        xn = _layout(torch.randn((n, t, rpt, kw), generator=g, device=dev), k)
        wn = torch.randn((k, cw), generator=g, device=dev)[:, :c]
        normal = (xn, slot, off, inc, nb, wn, br)
        ref = segmented_plain(*normal)
        got = usec_segmented_cuda(*normal)
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
        assert torch.equal(usec_segmented_cuda(*normal), got)

        bad = slot.clone()
        bad[3, 1] = t
        got = usec_segmented_cuda(staged, bad, off, inc, nb, w, br)
        assert bool(torch.isnan(got[3, 1]).all())
        keep = torch.ones((n, b), dtype=torch.bool, device=dev)
        keep[3, 1] = False
        assert torch.equal(got[keep], segmented_plain(*args)[keep])
