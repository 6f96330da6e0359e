"""USEC core: the paper's contribution as a composable planning library.

Layers (all pure host-side, consumed by the jitted runtime as arrays):

  placement   — uncoded storage placements (repetition / cyclic / MAN)
  assignment  — exact solver for the load-balancing LP, eqs. (6)/(8)
  filling     — Algorithm 2: fractional loads -> integral 1+S-redundant row sets
  plan        — padded, recompile-free executable plans + coverage checks
  speed       — EWMA heterogeneous-speed estimation (Algorithm 1)
  elastic     — availability traces, membership events, transition waste
  scheduler   — the adaptive master loop tying it all together
  decentral   — the master-less re-planning rule (pure local function +
                replicated plan table), bitwise-equal to the scheduler
"""

from .assignment import AssignmentSolution, lower_bound, solve_assignment
from .decentral import (
    DeadScheduler,
    DecentralPlanner,
    PlanTable,
    SchedulerKilledError,
    SpeedSnapshot,
    bitmask_members,
    local_replan,
    local_replan_batch,
    membership_bitmask,
)
from .elastic import (
    AvailabilityTrace,
    ElasticEvent,
    MarkovChurnTrace,
    scripted_trace,
    transition_waste,
)
from .filling import (
    TileAssignment,
    fill_assignment,
    homogeneous_assignment,
    verify_assignment,
)
from .placement import (
    LostTileError,
    Placement,
    custom_placement,
    cyclic_placement,
    make_placement,
    man_placement,
    repetition_placement,
)
from .plan import CompiledPlan, Segment, compile_plan, integerize_fractions, verify_plan_coverage
from .scheduler import StepPlan, USECScheduler
from .speed import SpeedEstimator

__all__ = [
    "AssignmentSolution",
    "AvailabilityTrace",
    "CompiledPlan",
    "DeadScheduler",
    "DecentralPlanner",
    "ElasticEvent",
    "LostTileError",
    "MarkovChurnTrace",
    "Placement",
    "PlanTable",
    "SchedulerKilledError",
    "Segment",
    "SpeedEstimator",
    "SpeedSnapshot",
    "StepPlan",
    "TileAssignment",
    "USECScheduler",
    "bitmask_members",
    "compile_plan",
    "custom_placement",
    "cyclic_placement",
    "fill_assignment",
    "homogeneous_assignment",
    "integerize_fractions",
    "local_replan",
    "local_replan_batch",
    "lower_bound",
    "make_placement",
    "membership_bitmask",
    "man_placement",
    "repetition_placement",
    "scripted_trace",
    "solve_assignment",
    "transition_waste",
    "verify_assignment",
    "verify_plan_coverage",
]
