"""Policy: one object for every scheduling decision the framework exposes.

Before this module, each caller threaded the scheduler's knobs differently —
the live runner took ``stragglers``/``gamma`` through ``RunnerConfig``, the
sweep driver took a loose ``tolerance`` kwarg and solved the LP itself, and
the straggler-tolerance lookahead was eight keyword arguments on a scheduler
method. A :class:`Policy` names all of them once:

- **placement kind** (repetition / cyclic / MAN / custom) + replication,
- **straggler tolerance S** — a fixed integer, or ``"auto"`` to pick S by
  the batched lookahead (:meth:`USECScheduler.select_straggler_tolerance`),
- **waste-averse re-planning** (``waste_epsilon``) and the EWMA ``gamma``,

and knows how to build the placement and the scheduler it describes. Both
:class:`~repro_torch.api.engine.ElasticEngine` backends and the refactored
:class:`~repro_torch.runtime.elastic_runner.ElasticRunner` consume schedulers
exclusively through this object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.placement import Placement, custom_placement, make_placement
from repro_torch.core.scheduler import USECScheduler

__all__ = ["Policy"]


@dataclass(frozen=True)
class Policy:
    """Every scheduling choice of an elastic run, in one place.

    Attributes:
      placement: placement family — "repetition" | "cyclic" | "man" |
        "custom" (the latter takes ``holders``).
      replication: J, copies per tile (storage cost).
      n_tiles: G; 0 derives it (N for repetition/cyclic, C(N, J) for MAN —
        a positive mismatch with C(N, J) raises, see
        :func:`repro_torch.core.placement.make_placement`).
      holders: explicit per-tile holder sets for ``placement="custom"``.
      stragglers: S — an int, or ``"auto"`` to select S by the scheduler's
        batched lookahead. The engine resolves ``"auto"`` ONCE per run, at
        the starting membership (the lookahead itself costs a plan + batch
        simulation per candidate; re-selecting every churn event would
        dominate the step); the committed S then applies to every later
        membership, so severe churn can make an aggressively chosen S
        infeasible — plan feasibility errors name the tolerance.
      candidates / lookahead_draws / expected_stragglers / straggle_mode /
        lookahead_quantile: the ``"auto"`` lookahead's environment model
        (see :meth:`USECScheduler.select_straggler_tolerance`).
      waste_epsilon: > 0 enables transition-waste-averse plan reuse.
      gamma: EWMA mixing factor of the speed estimator.
      homogeneous: plan as if all speeds were equal (the paper's Fig. 4
        baseline).
      replan: who makes the re-planning decision — ``"central"`` (the
        Algorithm-1 master, a single point of failure) or ``"decentral"``
        (every worker evaluates the pure local rule of
        :mod:`repro_torch.core.decentral` over replicated state; the live path
        is a plan-table lookup keyed by membership bitmask, bitwise-equal
        to the central solver, and the run survives a mid-run scheduler
        kill).
      verify_results: silent-corruption defense — ``"off"`` (trust worker
        bits), ``"sample"`` (audit staged tiles and Freivalds-check linear
        partials every :data:`~repro_torch.faults.integrity.SAMPLE_PERIOD` steps)
        or ``"always"`` (every step). A failed check quarantines the
        producing worker's partial (masked / re-served by a surviving
        holder), censors its timing from the EWMA, and graylists repeat
        offenders; a corrupted staged tile is re-staged from a surviving
        replica holder. See :class:`~repro_torch.faults.integrity.IntegrityChecker`.
    """

    placement: str = "cyclic"
    replication: int = 2
    n_tiles: int = 0
    holders: Optional[Tuple[Tuple[int, ...], ...]] = None
    stragglers: Union[int, str] = 0
    candidates: Tuple[int, ...] = (0, 1, 2)
    lookahead_draws: int = 256
    expected_stragglers: int = 1
    straggle_mode: str = "uniform"
    lookahead_quantile: float = 0.95
    waste_epsilon: float = 0.0
    gamma: float = 0.5
    homogeneous: bool = False
    replan: str = "central"
    verify_results: str = "off"

    def __post_init__(self):
        allowed = ("repetition", "cyclic", "man", "custom")
        if self.placement not in allowed:
            # Fail at construction, not steps later inside make_placement.
            raise ValueError(
                f"placement must be one of {allowed}, got "
                f"{self.placement!r}")
        if isinstance(self.stragglers, str):
            if self.stragglers != "auto":
                raise ValueError(
                    f"stragglers must be an int or 'auto', got "
                    f"{self.stragglers!r}")
        elif int(self.stragglers) < 0:
            raise ValueError("stragglers must be >= 0")
        if self.replan not in ("central", "decentral"):
            raise ValueError(
                f"replan must be 'central' or 'decentral', got "
                f"{self.replan!r}")
        if self.verify_results not in ("off", "sample", "always"):
            raise ValueError(
                f"verify_results must be one of ('off', 'sample', "
                f"'always'), got {self.verify_results!r}")

    # ------------------------------------------------------------------ #
    @property
    def auto_stragglers(self) -> bool:
        return self.stragglers == "auto"

    def base_stragglers(self) -> int:
        """The tolerance plans start from (lookahead re-commits 'auto')."""
        return 0 if self.auto_stragglers else int(self.stragglers)

    def make_placement(self, n_machines: int) -> Placement:
        """Build the placement this policy names over ``n_machines``."""
        if self.placement == "custom":
            if not self.holders:
                raise ValueError("placement='custom' requires holders")
            return custom_placement(n_machines, self.holders)
        # MAN derives G = C(N, J) itself (0 = accept); the others default
        # to one tile per machine.
        n_tiles = (
            self.n_tiles if self.placement == "man"
            else (self.n_tiles or n_machines)
        )
        return make_placement(
            self.placement, n_machines, n_tiles, self.replication)

    def make_scheduler(
        self,
        placement: Placement,
        rows_per_tile: int,
        initial_speeds: Sequence[float],
        row_align: int = 1,
        t_max: Optional[int] = None,
        kind: Optional[str] = None,
    ) -> USECScheduler:
        """The Algorithm 1 master this policy configures.

        ``kind`` overrides the planner class: ``"central"`` builds the
        classic :class:`USECScheduler`, ``"decentral"`` a
        :class:`~repro_torch.core.decentral.DecentralPlanner` (same interface,
        same bits, master-less live path). None follows ``self.replan``.
        """
        kind = self.replan if kind is None else kind
        if kind not in ("central", "decentral"):
            raise ValueError(
                f"kind must be 'central' or 'decentral', got {kind!r}")
        cls = USECScheduler
        if kind == "decentral":
            from repro_torch.core.decentral import DecentralPlanner

            cls = DecentralPlanner
        return cls(
            placement,
            rows_per_tile=rows_per_tile,
            initial_speeds=np.asarray(initial_speeds, dtype=np.float64),
            stragglers=self.base_stragglers(),
            gamma=self.gamma,
            row_align=row_align,
            t_max=t_max,
            homogeneous=self.homogeneous,
            waste_epsilon=self.waste_epsilon,
        )

    def resolve_stragglers(
        self,
        scheduler: USECScheduler,
        available: Sequence[int],
        jitter_sigma: float = 0.3,
        seed: int = 0,
        commit: bool = True,
        completion: str = "coverage",
    ) -> int:
        """The effective S for ``available``: the fixed value, or the
        lookahead's pick (``commit=True`` adopts it on the scheduler).
        ``completion`` is the consume model the lookahead prices under —
        the engine passes ``"order"`` when the runner executes
        ``arrival="first"`` so the chosen S matches the realized
        semantics."""
        if not self.auto_stragglers:
            return int(self.stragglers)
        best, _ = scheduler.select_straggler_tolerance(
            available,
            candidates=self.candidates,
            n_draws=self.lookahead_draws,
            expected_stragglers=self.expected_stragglers,
            straggle_mode=self.straggle_mode,
            jitter_sigma=jitter_sigma,
            quantile=self.lookahead_quantile,
            seed=seed,
            commit=commit,
            completion=completion,
        )
        return best
