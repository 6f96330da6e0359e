"""The port's planning layer is the JAX package's, bit for bit.

``repro_torch.core`` and ``repro_torch.runtime.simulate`` are NumPy copies of
``repro.core`` / ``repro.runtime.simulate`` (the port may not import the
reference). These differential tests draw the same seeded instances through
both packages and require identical bytes: assignment solutions, compiled
plans, batched fills, the decentral local rule and batched simulation. The
instance generators are copies of ``tests/test_plan_batch.py`` and
``tests/test_decentral.py``, parameterized by the package they build with.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.core.decentral as ref_decentral  # noqa: E402
import repro.core.filling as ref_filling  # noqa: E402
import repro.core.plan as ref_plan  # noqa: E402
import repro.runtime.simulate as ref_sim  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.decentral as port_decentral  # noqa: E402
import repro_torch.core.filling as port_filling  # noqa: E402
import repro_torch.core.plan as port_plan  # noqa: E402
import repro_torch.runtime.simulate as port_sim  # noqa: E402

SEEDS = [0, 1, 7, 2026, 424242]


def _random_instances(core, rng, n_batch):
    """Random (placement, solution, S, speeds) stack over cyclic + MAN
    placements, random memberships (incl. degenerate single-survivor) —
    ``tests/test_plan_batch.py``'s generator, built with ``core``."""
    placements, sols, strags, speeds_l = [], [], [], []
    while len(sols) < n_batch:
        n = int(rng.integers(3, 8))
        j = int(rng.integers(2, min(4, n) + 1))
        if rng.random() < 0.15:
            j = n  # full replication: single-survivor memberships possible
        kind = rng.choice(["cyclic", "man"])
        p = core.cyclic_placement(n, n, j) if kind == "cyclic" \
            else core.man_placement(n, j)
        speeds = rng.exponential(1.0, n) + 0.05
        avail = list(range(n))
        for _ in range(int(rng.integers(0, j))):
            if len(avail) <= 1:
                break
            cand = [a for a in avail]
            rng.shuffle(cand)
            for d in cand:
                trial = tuple(x for x in avail if x != d)
                try:
                    p.restrict(trial)
                except Exception:
                    continue
                avail = list(trial)
                break
        restricted = p.restrict(avail)
        S = int(rng.integers(0, restricted.replication))
        placements.append(p)
        sols.append(core.solve_assignment(p, speeds, available=avail,
                                          stragglers=S))
        strags.append(S)
        speeds_l.append(speeds)
    return placements, sols, strags, speeds_l


def _random_memberships(rng, p, k):
    """k random feasible memberships of placement ``p`` (full set first) —
    ``tests/test_decentral.py``'s generator."""
    n = p.n_machines
    out = [tuple(range(n))]
    while len(out) < k:
        avail = list(range(n))
        for _ in range(int(rng.integers(0, p.replication))):
            if len(avail) <= 1:
                break
            cand = list(avail)
            rng.shuffle(cand)
            for d in cand:
                trial = tuple(x for x in avail if x != d)
                try:
                    p.restrict(trial)
                except Exception:
                    continue
                avail = list(trial)
                break
        out.append(tuple(avail))
    return out


def _both(seed, n_batch):
    """The same instance stack from both packages (same draws)."""
    a = _random_instances(ref_core, np.random.default_rng(seed), n_batch)
    b = _random_instances(port_core, np.random.default_rng(seed), n_batch)
    return a, b


def _assert_solutions_identical(a, b):
    assert a.c_star == b.c_star  # bitwise, not approx
    assert tuple(a.machines) == tuple(b.machines)
    assert a.mu.tobytes() == b.mu.tobytes()
    assert a.loads.tobytes() == b.loads.tobytes()


def _segments(plan):
    # Segment classes differ between the packages; compare their fields.
    return [dataclasses.astuple(s) for s in plan.segments]


def _assert_plans_identical(a, b):
    assert _segments(a) == _segments(b)
    for name in ("seg_tile", "seg_start", "seg_len", "seg_id", "n_valid"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes(), name
    assert a.loads().tobytes() == b.loads().tobytes()
    assert a.include_mask(()).tobytes() == b.include_mask(()).tobytes()
    assert a.stragglers == b.stragglers
    assert a.rows_per_tile == b.rows_per_tile


def _assert_step_plans_identical(a, b):
    assert tuple(a.available) == tuple(b.available)
    _assert_solutions_identical(a.solution, b.solution)
    _assert_plans_identical(a.plan, b.plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_assignment_and_compile_plan_bitwise(seed):
    (pa, sa, ka, va), (pb, sb, kb, vb) = _both(seed, 6)
    rng = np.random.default_rng(seed + 1)
    rpt = int(rng.integers(16, 200))
    align = int(rng.choice([1, 8, 16]))
    for i in range(len(sa)):
        _assert_solutions_identical(sa[i], sb[i])
        a = ref_core.compile_plan(pa[i], sa[i], rows_per_tile=rpt,
                                  stragglers=ka[i], speeds=va[i],
                                  row_align=align)
        b = port_core.compile_plan(pb[i], sb[i], rows_per_tile=rpt,
                                   stragglers=kb[i], speeds=vb[i],
                                   row_align=align)
        _assert_plans_identical(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_compile_plan_batch_bitwise(seed):
    (pa, sa, ka, va), (pb, sb, kb, vb) = _both(seed, 5)
    a = ref_plan.compile_plan_batch(pa, sa, rows_per_tile=96, stragglers=ka,
                                    speeds=va, row_align=16)
    b = port_plan.compile_plan_batch(pb, sb, rows_per_tile=96, stragglers=kb,
                                     speeds=vb, row_align=16)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _assert_plans_identical(x, y)


@pytest.mark.parametrize("seed", SEEDS)
def test_fill_assignment_batch_bitwise(seed):
    rng = np.random.default_rng(seed)
    mus, machs, strags = [], [], []
    for _ in range(int(rng.integers(1, 40))):
        n = int(rng.integers(1, 12))
        S = int(rng.integers(0, min(3, max(n - 1, 0)) + 1))
        L = 1 + S
        for _ in range(100):
            mu = rng.dirichlet(np.ones(n)) * L
            if mu.max() <= 1.0:
                break
        else:
            mu = np.full(n, L / n)
        mus.append(mu)
        machs.append([int(x) for x in rng.permutation(100)[:n]])
        strags.append(S)
    a = ref_filling.fill_assignment_batch(mus, machs, strags)
    b = port_filling.fill_assignment_batch(mus, machs, strags)
    for x, y in zip(a, b, strict=True):
        assert x.groups == y.groups
        assert x.fractions.tobytes() == y.fractions.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_local_replan_batch_bitwise(seed):
    (pa, _, _, va), (pb, _, _, vb) = _both(seed, 1)
    rng = np.random.default_rng(seed + 2)
    memberships = _random_memberships(rng, pa[0], int(rng.integers(2, 6)))
    s_cap = min(pa[0].restrict(m).replication for m in memberships) - 1
    S = int(rng.integers(0, s_cap + 1))
    masks = [ref_core.membership_bitmask(m, pa[0].n_machines)
             for m in memberships]
    assert masks == [port_core.membership_bitmask(m, pb[0].n_machines)
                     for m in memberships]
    kw = dict(rows_per_tile=96, row_align=16)
    try:
        a = ref_decentral.local_replan_batch(masks, pa[0], va[0], S, **kw)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)[:20]):
            port_decentral.local_replan_batch(masks, pb[0], vb[0], S, **kw)
        return
    b = port_decentral.local_replan_batch(masks, pb[0], vb[0], S, **kw)
    assert len(a) == len(b) == len(memberships)
    for x, y in zip(a, b):
        _assert_step_plans_identical(x, y)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("completion", ["coverage", "order"])
def test_simulate_batch_bitwise(seed, completion):
    rng = np.random.default_rng(seed)
    n = 6
    speeds = rng.exponential(1.0, n) + 0.05
    sols = {}
    for name, core in (("ref", ref_core), ("port", port_core)):
        p = core.cyclic_placement(n, n, 3)
        sols[name] = [core.solve_assignment(p, speeds, stragglers=S)
                      for S in (0, 1, 2)]
    plans_a = ref_plan.compile_plan_batch(
        ref_core.cyclic_placement(n, n, 3), sols["ref"], rows_per_tile=96,
        stragglers=[0, 1, 2], speeds=speeds)
    plans_b = port_plan.compile_plan_batch(
        port_core.cyclic_placement(n, n, 3), sols["port"], rows_per_tile=96,
        stragglers=[0, 1, 2], speeds=speeds)
    realized = rng.exponential(1.0, (200, n)) + 0.05
    pidx = rng.integers(0, 3, 200)
    dropped = rng.random((200, n)) < 0.1
    a = ref_sim.simulate_batch(ref_sim.PlanStack.from_batch(plans_a),
                               realized, dropped=dropped, plan_index=pidx,
                               on_infeasible="inf", completion=completion)
    b = port_sim.simulate_batch(port_sim.PlanStack.from_batch(plans_b),
                                realized, dropped=dropped, plan_index=pidx,
                                on_infeasible="inf", completion=completion)
    assert a.completion_times.tobytes() == b.completion_times.tobytes()
    assert np.isfinite(b.completion_times).any()


@pytest.mark.parametrize("replan", ["central", "decentral"])
def test_scheduler_churn_sequence_bitwise(replan):
    """Algorithm 1's master over a churn walk with EWMA updates: the same
    step plans from both packages, central and decentral."""
    rng = np.random.default_rng(5)
    cls_a = (ref_core.USECScheduler if replan == "central"
             else ref_core.DecentralPlanner)
    cls_b = (port_core.USECScheduler if replan == "central"
             else port_core.DecentralPlanner)
    pa = ref_core.man_placement(5, 3)
    pb = port_core.man_placement(5, 3)
    speeds = rng.exponential(1.0, 5) + 0.05
    a = cls_a(pa, rows_per_tile=80, initial_speeds=speeds, stragglers=1,
              row_align=16)
    b = cls_b(pb, rows_per_tile=80, initial_speeds=speeds, stragglers=1,
              row_align=16)
    for avail in _random_memberships(rng, pa, 6):
        meas = {int(m): float(rng.exponential(1.0) + 0.1) for m in avail}
        _assert_step_plans_identical(a.plan_step(avail, dict(meas)),
                                     b.plan_step(avail, dict(meas)))
