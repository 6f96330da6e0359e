"""Adaptive speed estimation (paper Algorithm 1, lines 1, 4, 14).

Workers report per-step measured throughput ``nu[n] = mu[n] / (tau2 - tau1)``
(load over wall time); the master keeps an exponentially-weighted moving
average  ``s_hat <- gamma * nu + (1 - gamma) * s_hat``.

Machines that were preempted (or straggled and reported nothing) simply keep
their previous estimate — exactly the paper's behaviour, since line 4 only
mixes in measurements that arrived.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class SpeedEstimator:
    """EWMA speed tracker over the full machine population [N]."""

    def __init__(self, initial: Sequence[float], gamma: float = 0.5):
        self._s = np.asarray(initial, dtype=np.float64).copy()
        if np.any(self._s <= 0):
            raise ValueError("initial speeds must be strictly positive")
        if not (0.0 < gamma <= 1.0):
            raise ValueError("gamma must be in (0, 1]")
        self.gamma = float(gamma)

    @property
    def speeds(self) -> np.ndarray:
        return self._s.copy()

    def set_speed(self, n: int, value: float) -> None:
        """Overwrite one machine's estimate (no EWMA mixing) — used to pin a
        never-measured machine at the fleet average until it reports."""
        if value <= 0 or not np.isfinite(value):
            raise ValueError(f"speed must be positive and finite, got {value}")
        self._s[int(n)] = float(value)

    def load_speeds(self, speeds: Sequence[float]) -> None:
        """Replace the whole estimate vector (checkpoint restore). The
        values are adopted bit-for-bit — no EWMA mixing — so a resumed run
        continues from exactly the estimator state that was saved."""
        s = np.asarray(speeds, dtype=np.float64).copy()
        if s.shape != self._s.shape:
            raise ValueError(
                f"speed vector shape {s.shape} != estimator shape "
                f"{self._s.shape}")
        if np.any(s <= 0) or not np.all(np.isfinite(s)):
            raise ValueError("speeds must be strictly positive and finite")
        self._s = s

    def update(self, measured: Dict[int, float]) -> np.ndarray:
        """Mix in per-machine measurements {machine_id: nu}. Returns s_hat."""
        for n, nu in measured.items():
            if nu <= 0 or not np.isfinite(nu):
                continue  # a stalled/absent worker contributes nothing
            self._s[n] = self.gamma * nu + (1.0 - self.gamma) * self._s[n]
        return self.speeds

    def measure(self, loads: Dict[int, float], durations: Dict[int, float],
                exclude: Optional[Sequence[int]] = None) -> Dict[int, float]:
        """nu[n] = mu[n] / duration[n] for workers that finished.

        ``exclude`` censors workers whose measurements are quarantined —
        a worker flagged by the integrity layer returned corrupt bits,
        so its timing is equally untrustworthy and must not reach the
        EWMA (the resulting update is bit-identical to one that never
        saw the worker; see
        :func:`repro_torch.faults.integrity.censor_measurements`)."""
        skip = set() if exclude is None else {int(n) for n in exclude}
        out = {}
        for n, mu in loads.items():
            if n in skip:
                continue
            d = durations.get(n)
            if d is not None and d > 0 and mu > 0:
                out[n] = mu / d
        return out
