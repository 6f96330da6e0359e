"""Quickstart: the USEC core in one page (the PyTorch port's twin of
``examples/quickstart.py``).

Builds the paper's own §III example — 6 workers with speeds [1,2,4,8,16,32],
6 data tiles, 3-fold uncoded replication — solves the optimal computation
assignment with and without straggler tolerance, realizes it with the
filling algorithm, and verifies recoverability under every straggler set.

The planning layer runs on the host: ``--device`` is accepted for the
examples' common command line and touches nothing.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (
    compile_plan,
    cyclic_placement,
    man_placement,
    repetition_placement,
    solve_assignment,
    verify_plan_coverage,
)

SPEEDS = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    ap.parse_args(argv)


    # 1. An uncoded storage placement: tile g lives on workers {g, g+1, g+2}.
    placement = cyclic_placement(n_machines=6, n_tiles=6, replication=3)
    print("storage sets:", [sorted(s) for s in placement.storage_sets()])

    # 2. The optimal heterogeneous assignment (paper eq. (6)): c* = 1/7.
    sol = solve_assignment(placement, SPEEDS)
    print(f"cyclic     c* = {sol.c_star:.6f}  loads = {np.round(sol.loads, 3)}")
    print(f"repetition c* = {solve_assignment(repetition_placement(6, 6, 3), SPEEDS).c_star:.6f}")
    man = man_placement(6, 3)
    print(f"MAN        c* = {solve_assignment(man, SPEEDS).c_star * 6 / man.n_tiles:.6f} (normalized)")

    # 3. Straggler tolerance S=1: every row computed by 2 workers (eq. (8)).
    sol_s = solve_assignment(placement, SPEEDS, stragglers=1)
    plan = compile_plan(placement, sol_s, rows_per_tile=1000, stragglers=1, speeds=SPEEDS)
    print(f"S=1        c* = {sol_s.c_star:.6f}  segments = {len(plan.segments)}")

    # 4. Any single worker may vanish; the combine still covers every row once.
    verify_plan_coverage(plan, 6, straggler_sets=[()] + [(w,) for w in range(6)])
    print("coverage verified under all 1-straggler sets ✓")

    # 5. Elasticity: worker 5 (the fastest) is preempted; re-plan instantly.
    sol_e = solve_assignment(placement, SPEEDS, available=[0, 1, 2, 3, 4])
    print(f"preempt w5 c* = {sol_e.c_star:.6f} (load shifts to surviving holders)")


if __name__ == "__main__":
    main()
