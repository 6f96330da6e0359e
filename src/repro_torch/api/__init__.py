"""The workload-agnostic front door to the elastic framework.

One import surface for "run this computation elastically":

    from repro_torch.api import ElasticEngine, EngineConfig, Policy, MatMat

    engine = ElasticEngine(MatMat(w), Policy(placement="man", replication=2,
                                             stragglers=1),
                           EngineConfig(n_draws=2000), backend="simulate",
                           n_machines=4)
    result = engine.run(events=my_trace, n_steps=32)

Flip ``backend="device"`` and the SAME config, placement, availability
trace and straggler policy execute live on the card through the hand-written
kernels instead of analytically. See :mod:`repro_torch.api.engine` for the
contract, :mod:`repro_torch.api.workload` for the workload protocol and the
shipped workloads, and :mod:`repro_torch.api.policy` for the scheduling
policy object.
"""

from .engine import ElasticEngine, EngineConfig, EngineResult
from .policy import Policy
from .workload import (
    MapReduceRows,
    MatMat,
    MatVec,
    MatVecPowerIteration,
    Workload,
)

__all__ = [
    "ElasticEngine",
    "EngineConfig",
    "EngineResult",
    "MapReduceRows",
    "MatMat",
    "MatVec",
    "MatVecPowerIteration",
    "Policy",
    "Workload",
]
