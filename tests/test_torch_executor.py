"""The port's single-card executor against the JAX package's shard_map
executor, on the same block plans.

The reference ``make_matvec_executor`` runs in a subprocess with 4 forced
host devices (``conftest.run_with_devices``), once for every case below, in
both its per-block and segmented modes. The port runs the SAME ``BlockPlan``
arrays, carried across with ``from_reference``, on the CPU. On the
integer-grid matrices of the exactness contract (``make_exact_matrix`` and
a ``quantize_unit`` operand) outputs must be bitwise-equal; on normal fp32
data the combine is still exact and only the in-block K order differs, so
``rtol = atol = 1e-4`` (the reference kernels' stated tolerance).
"""

import dataclasses
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

from repro.core import make_placement as ref_make_placement  # noqa: E402
from repro.core import solve_assignment  # noqa: E402
from repro.core.plan import compile_plan  # noqa: E402
from repro.runtime import executor as ref_exec  # noqa: E402
from repro.runtime.elastic_runner import quantize_unit  # noqa: E402
from repro_torch.api.workload import MatMat, MatVec  # noqa: E402
from repro_torch.runtime import executor as port_exec  # noqa: E402
from repro_torch.runtime.elastic_runner import (  # noqa: E402
    make_exact_matrix,
)

BLOCK_ROWS = 16
DIM = 768
# (name, placement kind, J, S, available, stragglers, columns, exact data)
CASES = [
    ("cyclic_s0_full", "cyclic", 2, 0, (0, 1, 2, 3), (), 1, True),
    ("cyclic_s0_preempt", "cyclic", 2, 0, (0, 1, 3), (), 1, True),
    ("man_s1_straggler", "man", 3, 1, (0, 1, 2, 3), (2,), 1, True),
    ("man_s1_preempt_straggler", "man", 3, 1, (0, 2, 3), (3,), 1, True),
    ("cyclic_s1_matmat", "cyclic", 3, 1, (0, 1, 2, 3), (1,), 3, True),
    ("man_s0_normal", "man", 2, 0, (0, 1, 2, 3), (), 1, False),
]


def _case_inputs(case):
    name, kind, j, s, avail, bad, cols, exact = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    p = ref_make_placement(kind, 4, 4 if kind == "cyclic" else 0, j)
    rpt = DIM // p.n_tiles
    if exact:
        x = make_exact_matrix(DIM, seed=3)
        w = np.stack([quantize_unit(rng.normal(size=DIM).astype(np.float32))
                      for _ in range(cols)], axis=1)
    else:
        x = rng.normal(size=(DIM, DIM)).astype(np.float32)
        w = rng.normal(size=(DIM, cols)).astype(np.float32)
    if cols == 1:
        w = w[:, 0]
    speeds = np.array([1.0, 2.0, 3.5, 5.0])
    sol = solve_assignment(p, speeds, available=avail, stragglers=s)
    plan = compile_plan(p, sol, rows_per_tile=rpt, stragglers=s,
                        speeds=speeds, row_align=BLOCK_ROWS)
    sm = ref_exec.stage_matrix(x, p, rpt)
    b_max = max(len(z) for z in p.storage_sets()) * rpt // BLOCK_ROWS
    bp = ref_exec.block_plan(plan, sm.slot_of, BLOCK_ROWS, stragglers=bad,
                             b_max=b_max)
    return sm, bp, w, plan


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    """Run the reference executor for every case in ONE subprocess."""
    d = tmp_path_factory.mktemp("executor_parity")
    for case in CASES:
        sm, bp, w, _ = _case_inputs(case)
        np.savez(os.path.join(d, f"{case[0]}.npz"), staged=sm.staged, w=w,
                 **{f: getattr(bp, f) for f in (
                     "blk_slot", "blk_off", "blk_goff", "blk_include",
                     "n_blocks")})
    code = f"""
        import numpy as np
        from repro.api.workload import MatMat, MatVec
        from repro.launch.mesh import make_worker_mesh
        from repro.runtime.executor import make_matvec_executor
        mesh = make_worker_mesh(4)
        for name, cols in {[(c[0], c[6]) for c in CASES]!r}:
            a = dict(np.load("{d}/" + name + ".npz"))
            wl = MatVec() if cols == 1 else MatMat()
            out = {{}}
            for mode in ("block", "segmented"):
                fn = make_matvec_executor(
                    mesh, "data", rows_total={DIM}, block_rows={BLOCK_ROWS},
                    matmul=wl.executor_fn(None),
                    segmented_fn=(wl.segmented_fn(None, {BLOCK_ROWS})
                                  if mode == "segmented" else None))
                out[mode] = np.asarray(fn(
                    a["staged"], a["blk_slot"], a["blk_off"], a["blk_goff"],
                    a["blk_include"], a["n_blocks"], a["w"]))
            np.savez("{d}/" + name + "_out.npz", **out)
        print("done")
    """
    assert "done" in run_with_devices(code, n_devices=4)
    return d


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("mode", ["block", "segmented"])
def test_executor_matches_reference(reference_outputs, case, mode):
    name, _, _, _, _, _, cols, exact = case
    sm, bp, w, _ = _case_inputs(case)
    want = np.load(os.path.join(reference_outputs, f"{name}_out.npz"))[mode]
    staged, dplan = port_exec.from_reference(
        sm.staged, sm.slot_of, dataclasses.asdict(bp), "cpu")
    wl = MatVec() if cols == 1 else MatMat()
    step = port_exec.make_matvec_executor(
        rows_total=DIM, block_rows=BLOCK_ROWS, matmul=wl.executor_fn(None),
        segmented_fn=(wl.segmented_fn(None, BLOCK_ROWS)
                      if mode == "segmented" else None))
    got = step(staged.staged, dplan, torch.as_tensor(w)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if exact:
        assert np.array_equal(got, want)
        x64 = np.concatenate([
            sm.staged[n, sm.slot_of[n, g]] for g in range(sm.slot_of.shape[1])
            for n in [int(np.flatnonzero(sm.slot_of[:, g] >= 0)[0])]
        ]).astype(np.float64)
        assert np.array_equal(got.astype(np.float64), x64 @ w)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_straggler_include_override_matches_rebuilt_plan(case):
    """Passing refreshed include weights to the step equals rebuilding the
    block plan under that straggler set (the runner's per-step path)."""
    name, kind, j, s, avail, bad, cols, _ = case
    sm, bp, w, plan = _case_inputs(case)
    staged, dplan = port_exec.from_reference(
        sm.staged, sm.slot_of, dataclasses.asdict(bp), "cpu")
    step = port_exec.make_matvec_executor(
        rows_total=DIM, block_rows=BLOCK_ROWS,
        matmul=MatVec().executor_fn(None))
    inc = port_exec.refresh_include(bp, plan, bad)
    got = step(staged.staged, dplan, torch.as_tensor(w),
               include=torch.as_tensor(inc))
    want = step(staged.staged, dplan, torch.as_tensor(w))
    assert torch.equal(got, want)


def test_block_plan_bitwise_matches_reference_and_loop_oracle():
    """The port's vectorized ``block_plan`` equals the reference's, and its
    own loop-form ``block_plan_reference``, field for field."""
    from repro_torch.core import make_placement, solve_assignment as solve
    from repro_torch.core.plan import compile_plan as port_compile

    fields = ("blk_slot", "blk_off", "blk_goff", "blk_include", "n_blocks",
              "blk_seg_t", "blk_prio")
    rng = np.random.default_rng(7)
    checked = 0
    while checked < 30:
        n = int(rng.integers(3, 7))
        j = int(rng.integers(2, n))
        s = int(rng.integers(0, min(2, j - 1) + 1))
        kind = str(rng.choice(["cyclic", "man"]))
        speeds = np.maximum(rng.exponential(1.0, n), 1e-2)
        avail = tuple(sorted(rng.choice(
            n, size=int(rng.integers(max(1, n - 2), n + 1)),
            replace=False).tolist()))
        bad = (tuple(rng.choice(avail, size=min(s, len(avail)),
                                replace=False).tolist()) if s else ())
        out = []
        for mk, sv, cp, ex in (
                (ref_make_placement, solve_assignment, compile_plan,
                 ref_exec),
                (make_placement, solve, port_compile, port_exec)):
            p = mk(kind, n, n if kind == "cyclic" else 0, j)
            try:
                if p.restrict(avail).replication < 1 + s:
                    break
            except Exception:
                break
            plan = cp(p, sv(p, speeds, available=avail, stragglers=s),
                      rows_per_tile=96, stragglers=s, speeds=speeds,
                      row_align=16)
            sm = ex.stage_matrix(np.zeros((p.n_tiles * 96, 2), np.float32),
                                 p, 96)
            out.append(ex.block_plan(plan, sm.slot_of, 16, stragglers=bad))
            if ex is port_exec:
                out.append(ex.block_plan_reference(plan, sm.slot_of, 16,
                                                   stragglers=bad))
        if len(out) < 3:
            continue
        for f in fields:
            assert np.array_equal(getattr(out[0], f), getattr(out[1], f)), f
            assert np.array_equal(getattr(out[1], f), getattr(out[2], f)), f
        checked += 1
