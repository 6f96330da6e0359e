"""The port's operator cost model (``repro_torch.launch.op_cost``), the twin
of the reference's HLO cost analyzer (``tests/test_runtime.py``'s
``test_hlo_cost_*``): flops of a Python loop of products, the trip-count
extrapolation of the usec step's uneven loop, the collective conventions on
a fake 4-rank mesh, the bytes rules, live memory, and the flash operator's
flop formula and fake implementation. Meta tensors throughout: nothing is
allocated and no kernel runs."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_flops,
    live_pairs,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshSpec, flat_group, make_fake_mesh  # noqa: E402
from repro_torch.launch.op_cost import (  # noqa: E402
    MemoryTracker,
    extrapolate,
    traced,
)

META = "meta"


def test_loop_of_products_counts_every_trip():
    """Twin of test_hlo_cost_scan_multiplication: 8 products of 32 x 32,
    exactly 8 * 2 * 32**3 flops (the reference's scan body times its known
    trip count; here every trip is dispatched)."""
    x = torch.ones(32, 32, device=META)
    w = torch.ones(32, 32, device=META)
    with traced() as tc:
        c = x
        for _ in range(8):
            c = torch.tanh(c @ w)
        c.sum()
    assert tc.cost.flops == 8 * 2 * 32 ** 3
    assert tc.cost.dynamic_loops == 0


def _usec_cell():
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              param_dtype="float32",
                              grad_accum_dtype="float32")
    return cfg, dict(n_workers=2, t_stage=2, b_max=6, tile_samples=1,
                     seq=16, zero1=False)


def test_static_trips_extrapolation_equals_five_trips():
    """Twin of test_hlo_cost_dynamic_while_default: the usec step traced at
    1 and 2 trips and extrapolated to 5 equals its trace at 5 trips
    (flops, bytes, collectives), with one dynamic loop."""
    cfg, args = _usec_cell()
    res = dryrun.trace_usec(cfg, None, trips=(1, 2, 5), **args)
    one, two, five = res["costs"]
    got = extrapolate(one, two, 5.0)
    assert got.flops == five.flops
    assert got.bytes == pytest.approx(five.bytes, rel=1e-12)
    assert got.collectives == five.collectives
    assert got.dynamic_loops == 1
    assert got.peak_bytes == max(one.peak_bytes, two.peak_bytes)
    assert five.flops > two.flops > one.flops > 0


def test_collective_conventions_on_a_fake_mesh():
    """On a fake 2 x 2 mesh: all-reduce counts the tensor, all-gather its
    input, reduce-scatter its input (the output x the group), as
    hlo_cost.py:296-299 does; each group's whole-tensor bytes (the layers'
    stats convention: all-gather the output) under its name."""
    import torch.distributed as dist

    mesh = make_fake_mesh(MeshSpec((2, 2), ("data", "model")))
    try:
        data = flat_group(mesh, ("data",))
        model = mesh.get_group("model")
        x = torch.zeros(8, device=META)  # 32 bytes
        with traced() as tc:
            dist.all_reduce(x, group=data)
            out = torch.empty(16, device=META)
            dist.all_gather_into_tensor(out, x, group=model)
            half = torch.empty(4, device=META)
            dist.reduce_scatter_tensor(half, x, group=data)
            a2a = torch.empty(8, device=META)
            dist.all_to_all_single(a2a, x, group=model)
        c = tc.cost
        assert c.collectives == {"all-reduce": 32, "all-gather": 32,
                                 "reduce-scatter": 32, "all-to-all": 32}
        assert c.groups[data.group_name] == {"collectives": 2,
                                             "bytes": 32 + 32}
        assert c.groups[model.group_name] == {"collectives": 2,
                                              "bytes": 64 + 32}
        assert dist.get_world_size() == 4 and dist.get_backend() == "fake"
    finally:
        dist.destroy_process_group()


def test_bytes_views_casts_and_partial_writes():
    """Views move nothing; a cast counts its read and its write; an
    elementwise op its operands and result; ``index_put_`` and
    ``index_add_`` twice the region written; ``copy_`` source plus
    destination; ``empty`` nothing."""
    x = torch.ones(64, 64, device=META)  # 16 KiB
    idx = torch.arange(8, device=META)
    src = torch.ones(8, 64, device=META)
    cases = [
        (lambda: x.t(), 0),
        (lambda: x.view(-1), 0),
        (lambda: x[3:5], 0),
        (lambda: x.to(torch.bfloat16), 16384 + 8192),
        (lambda: x + x, 3 * 16384),
        (lambda: x.index_add_(0, idx, src), 2 * 2048),
        (lambda: x[idx].fill_(0), None),
        (lambda: x[:8].copy_(src), 2048 + 2048),
        (lambda: torch.empty(1024, device=META), 0),
    ]
    for fn, want in cases:
        with traced() as tc:
            fn()
        if want is not None:
            assert tc.cost.bytes == want, fn


def test_memory_tracker_counts_storages_once_and_frees_them():
    mem = MemoryTracker()
    with traced(mem) as tc:
        a = torch.empty(1024, device=META)  # 4 KiB
        v = a[10:20]
        b = a * 2
        assert mem.live == 8192
        del a
        assert mem.live == 8192  # the view keeps the storage
        del v, b
        assert mem.live == 0
        torch.empty(256, device=META)  # freed at once
    assert tc.cost.peak_bytes == 8192
    assert mem.live == 0


@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, None, 64, 64), (False, None, 48, 80), (True, 16, 64, 64),
    (True, None, 1, 100), (True, 7, 33, 90)])
def test_flash_operator_flops_and_fake_output(causal, window, sq, skv):
    """The flash operator on meta tensors: its fake implementation gives the
    output's shape and dtype and launches nothing; FlopCounterMode counts
    4 * d per live (query, key) pair, the pairs the plain version's mask
    keeps."""
    from torch.utils.flop_counter import FlopCounterMode

    b, h, hk, d = 2, 4, 2, 32
    q = torch.empty(b, h, sq, d, device=META, dtype=torch.bfloat16)
    k = torch.empty(b, hk, skv, d, device=META, dtype=torch.bfloat16)
    before = flash_attention_cuda.launches
    with FlopCounterMode(display=False) as fc:
        out = ops.flash_attention(q, k, k, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype and out.is_meta
    assert flash_attention_cuda.launches == before
    assert fc.get_total_flops() == flash_flops(q.shape, k.shape, causal,
                                               window)
    qp = torch.arange(sq)[:, None] + skv - sq
    kp = torch.arange(skv)[None, :]
    keep = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    assert live_pairs(sq, skv, causal, window) == int(keep.sum())
    assert flash_flops(q.shape, k.shape, causal, window) == \
        4 * d * b * h * int(keep.sum())


def test_flash_operator_refuses_host_tensors_and_the_plain_route_stays():
    q = torch.ones(1, 2, 4, 32)
    k = torch.ones(1, 1, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        torch.ops.repro_torch.flash_attention(q, k, k, True, None, None)
    assert not ops.card_route(None, q)
    assert ops.card_route(None, q.to(META))
    assert not ops.card_route("ref", q.to(META))
