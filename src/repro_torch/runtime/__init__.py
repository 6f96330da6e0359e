"""Execution substrate: the single-card USEC executor, the live elastic
runner, wall-clock simulation and the batched scenario engine.

- **simulation** (:mod:`.simulate`, :mod:`.scenarios`) — pure-NumPy
  analytical completion times, batched over thousands of scenario draws;
- **real execution** (:mod:`.elastic_runner`, :mod:`.executor`) — churn-driven
  steps run on the card through the hand-written kernels, with EWMA speed
  re-estimation from measured step times;
- **checkpointing** (:mod:`.checkpoint`) — atomic ``.npz`` + manifest
  checkpoints in the JAX package's format.

The simulation layer and the runner's host-side classes are pure NumPy and
import eagerly; the executor needs torch and resolves lazily (PEP 562), so
the planners and the simulator run without torch installed.
"""

from .checkpoint import (
    CheckpointCorruptError,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from .elastic_runner import (
    ElasticRunner,
    HostSharedClock,
    PowerIterationResult,
    RunnerConfig,
    StepReport,
    SyntheticSpeedClock,
    make_exact_matrix,
    quantize_unit,
)
from .scenarios import (
    ChurnStep,
    ChurnSweepResult,
    ScenarioResult,
    SweepConfig,
    draw_scenarios,
    summarize,
    sweep_cell,
    sweep_churn,
    sweep_grid,
)
from .simulate import (
    BatchTiming,
    PlanStack,
    SpeedProcess,
    StepTiming,
    StragglerProcess,
    build_plan_stack,
    exponential_speeds,
    simulate_batch,
    simulate_step,
    worker_times,
)

_TORCH_EXPORTS = {
    "BlockPlan": "executor",
    "DevicePlan": "executor",
    "StagedMatrix": "executor",
    "block_plan": "executor",
    "device_plan": "executor",
    "from_reference": "executor",
    "make_matvec_executor": "executor",
    "refresh_include": "executor",
    "stage_matrix": "executor",
}


def __getattr__(name):
    if name in _TORCH_EXPORTS:
        import importlib

        mod = importlib.import_module(f".{_TORCH_EXPORTS[name]}", __name__)
        value = getattr(mod, name)
        globals()[name] = value  # cache for subsequent lookups
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BatchTiming",
    "BlockPlan",
    "CheckpointCorruptError",
    "ChurnStep",
    "ChurnSweepResult",
    "DevicePlan",
    "ElasticRunner",
    "HostSharedClock",
    "PlanStack",
    "PowerIterationResult",
    "RunnerConfig",
    "ScenarioResult",
    "SpeedProcess",
    "StagedMatrix",
    "StepReport",
    "StepTiming",
    "StragglerProcess",
    "SweepConfig",
    "SyntheticSpeedClock",
    "block_plan",
    "build_plan_stack",
    "device_plan",
    "draw_scenarios",
    "exponential_speeds",
    "from_reference",
    "latest_checkpoint",
    "make_exact_matrix",
    "make_matvec_executor",
    "quantize_unit",
    "refresh_include",
    "restore_checkpoint",
    "save_checkpoint",
    "simulate_batch",
    "simulate_step",
    "stage_matrix",
    "summarize",
    "sweep_cell",
    "sweep_churn",
    "sweep_grid",
    "worker_times",
]
