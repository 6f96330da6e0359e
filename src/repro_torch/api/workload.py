"""Workload protocol: what a computation must provide to run elastically.

The port of :mod:`repro.api.workload`. The paper's framework (Algorithm 1 +
eq. (8)) never looks inside the computation — it only needs the work to split
into *tiles* over an uncoded placement, with any row of a stored tile
computable by any holder:

- :meth:`Workload.stage`       — data -> the (q, r) row matrix to tile,
- :meth:`Workload.tile_compute`— the per-block pure function a worker runs
  on its plan slice (torch tensors; plugged into the executor),
- :meth:`Workload.combine`     — assembled per-row partials -> step result
  (host side; identity for linear workloads),
- :meth:`Workload.verify`      — step result vs a float64 host reference.

Shipped here: :class:`MatVec` / :class:`MatVecPowerIteration` (the paper's
§V application), :class:`MatMat` (multi-column ``Y = X @ W``, through the
blocked :func:`repro_torch.kernels.ops.usec_matmat` path) and
:class:`MapReduceRows` (any pure per-row torch function plus a host-side
fold). Host-side methods are pure NumPy; torch is only touched by
``tile_compute`` / ``executor_fn`` / ``segmented_fn`` (so the simulate
backend never imports it).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np

__all__ = [
    "MapReduceRows",
    "MatMat",
    "MatVec",
    "MatVecPowerIteration",
    "Workload",
]


class Workload:
    """Protocol + shared plumbing for elastic workloads.

    Subclasses override the protocol methods (``stage``, ``tile_compute`` /
    ``executor_fn``, ``combine``, ``verify``) plus the iterative-driver hooks
    (``init_operand``, ``consume``, ``finalize``) as needed. A workload
    instance carries per-run state (see :meth:`reset`); the engine resets it
    at the start of every run.

    Attributes:
      name: short identifier.
      out_cols: static per-row output width of ``tile_compute`` when it
        differs from the operand's column count (None = follows operand).
      linear: True when the per-step result is a linear map of the operand
        (``y = X @ w``).
    """

    name: str = "workload"
    out_cols: Optional[int] = None
    linear: bool = False

    # ------------------------------------------------------------------ #
    # The protocol
    # ------------------------------------------------------------------ #
    def stage(self, data: Any) -> np.ndarray:
        """Return the (q, r) row matrix whose rows are tiled over the
        placement (the paper's X). The default accepts a 2-d array."""
        x = np.asarray(data)
        if x.ndim != 2:
            raise ValueError(f"{self.name}: data must be a (q, r) matrix, "
                             f"got shape {x.shape}")
        return x

    def tile_compute(self, staged_block, operand):
        """Compute one staged plan slice: ``partial = f(block rows,
        operand)`` on torch tensors ((block_rows, r) block, 2-d operand) ->
        (block_rows, cols). Must be pure — the elastic machinery recomputes
        rows on any holder."""
        raise NotImplementedError

    def executor_fn(self, mode: Optional[str] = None) -> Callable:
        """The block function ``f(xb, w2, out=None)`` the executor binds
        once at build time; it writes the (block_rows, cols) result into
        ``out`` when given. The default wraps :meth:`tile_compute`;
        workloads with kernel dispatch (``mode`` = a kernel route of
        :mod:`repro_torch.kernels.ops`) override this instead."""
        del mode  # the default tile_compute path has no kernel dispatch

        def fn(xb, w2, out=None):
            y = self.tile_compute(xb, w2)
            return y if out is None else out.copy_(y)

        return fn

    def fused_update(self, mode: Optional[str] = None) -> Optional[Callable]:
        """The on-device iterate update ``f(raw_result, operand) -> next
        operand`` the fused window driver applies between its K steps (torch
        tensors on the card; no host synchronisation). ``raw_result`` is the
        assembled pre-``combine`` output.

        None opts the workload out of fusion (the engine falls back to
        stepwise dispatch). The default is the fixed-point identity, but ONLY
        when :meth:`consume` is not overridden: a workload with its own host
        consume and no device twin must not silently diverge under fusion.
        Overrides must be **bitwise-identical** to the host ``consume``
        operand chain (see :meth:`MatVecPowerIteration.fused_update`)."""
        del mode
        if type(self).consume is not Workload.consume:
            return None
        return lambda y, w: w

    def segmented_fn(
        self, mode: Optional[str] = None, block_rows: int = 16,
    ) -> Optional[Callable]:
        """The whole-block-list compute of the segmented executor path:
        ``f(staged, slot, off, include, w2, n_blocks=...) -> (N, B,
        block_rows, cols)`` partials with the include weights applied and
        zeros past each worker's trip count. None disables the path for a
        workload.

        The default gathers every block's rows once and maps
        :meth:`executor_fn` over the block axis with ``torch.vmap`` (one
        batched call), correct for any pure ``tile_compute``. The linear
        workloads override this with the ``usec_segmented`` kernel
        (:func:`repro_torch.kernels.ops.usec_segmented`)."""
        fn = self.executor_fn(mode)

        def seg(staged, slot, off, include, w2, n_blocks=None):
            import torch

            from repro_torch.kernels.ref import gather_block_rows

            n, t, rpt, k = staged.shape
            b = slot.shape[1]
            base = torch.arange(n, device=staged.device)[:, None] * t
            xg = gather_block_rows(
                staged.reshape(n * t, rpt, k),
                (slot.to(torch.int64) + base).reshape(-1),
                off.reshape(-1), block_rows)
            part = torch.vmap(lambda xb: fn(xb, w2))(xg)
            part = part.reshape(n, b, block_rows, -1).to(torch.float32) \
                * include[:, :, None, None]
            if n_blocks is None:
                return part
            valid = (torch.arange(b, device=staged.device)[None, :]
                     < n_blocks.to(staged.device)[:, None])
            return torch.where(valid[:, :, None, None], part,
                               torch.zeros_like(part))

        return seg

    def combine(self, partials: np.ndarray):
        """Host-side combine of the fully-reduced per-row partials into the
        step result. Identity for linear workloads."""
        return partials

    def verify(self, result, operand: np.ndarray, x64: Optional[np.ndarray],
               mode: str, atol: float) -> None:
        """Check the step result against a float64 host reference.

        mode: ``"exact"`` (bitwise) or ``"allclose"``. Raises
        AssertionError on mismatch, ValueError on unknown mode."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # Iterative-driver hooks (the engine's per-step loop)
    # ------------------------------------------------------------------ #
    def reset(self) -> None:
        """Clear per-run state; called by the engine before every run."""

    def init_operand(self, rows_total: int,
                     operand: Optional[np.ndarray] = None) -> np.ndarray:
        """The step-0 operand. ``operand`` is the caller-supplied override
        (``ElasticEngine.run(operand=...)``)."""
        if operand is None:
            raise ValueError(
                f"{self.name}: an operand is required "
                "(pass operand= to run(), or use a workload that owns one)")
        return np.asarray(operand)

    def consume(self, result, operand: np.ndarray) -> np.ndarray:
        """Fold one step result into the driver state; returns the next
        step's operand (default: operand unchanged — fixed-point reruns)."""
        return operand

    def finalize(self, runner, reports: List, last_result,
                 last_operand: np.ndarray):
        """Build the run-level result object (default: last step result)."""
        return last_result

    # ------------------------------------------------------------------ #
    # Analytical model hooks (the simulate backend)
    # ------------------------------------------------------------------ #
    def cost_scale(self) -> float:
        """Per-row work relative to a single matvec row (scales analytical
        completion times; 1.0 keeps them bitwise equal to the matvec
        simulator)."""
        return 1.0


def _segmented_linear(mode: Optional[str], block_rows: int) -> Callable:
    """The linear workloads' segmented dispatch: the ``usec_segmented``
    kernel on the card, the plain gathered matmul on the host — ONE binding
    shared by :class:`MatVec` and :class:`MatMat`."""
    import functools

    from repro_torch.kernels.ops import check_mode, usec_segmented

    check_mode(mode)
    return functools.partial(usec_segmented, block_rows=block_rows,
                             mode=mode)


def _verify_linear(y, ref: np.ndarray, what: str, mode: str,
                   atol: float) -> None:
    """Shared exact/allclose check used by the linear workloads."""
    if mode == "exact":
        y64 = np.asarray(y, dtype=np.float64)
        if not np.array_equal(y64, ref):
            flat = int(np.argmax(np.asarray(y64 != ref).ravel()))
            raise AssertionError(
                f"y != {what} (exact): first mismatch at flat index {flat}: "
                f"{np.asarray(y).ravel()[flat]!r} vs {ref.ravel()[flat]!r}"
            )
    elif mode == "allclose":
        err = float(np.max(np.abs(y - ref)))
        scale = float(np.max(np.abs(ref))) or 1.0
        if err > atol * scale:
            raise AssertionError(
                f"y != {what}: max abs err {err} (scale {scale})")
    else:
        raise ValueError(f"unknown verify mode {mode!r}")


class MatVec(Workload):
    """``y = X @ w`` per step.

    The executor's per-block compute is the ``usec_matvec`` kernel on the
    card and the plain fp32 product on the host
    (:func:`repro_torch.kernels.ops.executor_matmul`)."""

    name = "matvec"
    linear = True

    def tile_compute(self, staged_block, operand):
        return self.executor_fn(None)(staged_block, operand)

    def executor_fn(self, mode: Optional[str] = None) -> Callable:
        from repro_torch.kernels.ops import executor_matmul

        return executor_matmul(mode)

    def segmented_fn(self, mode: Optional[str] = None,
                     block_rows: int = 16) -> Optional[Callable]:
        return _segmented_linear(mode, block_rows)

    def verify(self, result, operand, x64, mode, atol) -> None:
        if x64 is None:
            raise ValueError("verify requires the staged matrix (x64)")
        ref = x64 @ np.asarray(operand, dtype=np.float64)
        _verify_linear(result, ref, "X @ w", mode, atol)


class MatVecPowerIteration(MatVec):
    """Power iteration driven through elastic matvec steps (paper §V).

    Bit for bit the JAX package's driver: the iterate is normalized and
    snapped to a 2^-bits grid each step
    (:func:`repro_torch.runtime.elastic_runner.quantize_unit`), so with
    integer-valued X the combine verifies bit-exactly, and the per-step
    Rayleigh quotient / residual bookkeeping matches
    :class:`~repro_torch.runtime.elastic_runner.PowerIterationResult`.
    """

    name = "power_iteration"

    def __init__(self, w0: Optional[np.ndarray] = None,
                 quantize_bits: Optional[int] = 8, seed: int = 0):
        self.w0 = w0
        self.quantize_bits = quantize_bits
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.residuals: List[float] = []
        self.eigval: float = 0.0

    def init_operand(self, rows_total, operand=None):
        from repro_torch.runtime.elastic_runner import quantize_unit

        w0 = operand if operand is not None else self.w0
        rng = np.random.default_rng(self.seed)
        w = (
            np.asarray(w0, dtype=np.float32) if w0 is not None
            else rng.normal(size=rows_total).astype(np.float32)
        )
        if self.quantize_bits:
            w = quantize_unit(w, self.quantize_bits)
        return w

    def consume(self, result, operand):
        from repro_torch.runtime.elastic_runner import quantize_unit, unit_vector

        w64 = operand.astype(np.float64)
        self.eigval = float(w64 @ result) / float(w64 @ w64)
        num = float(np.linalg.norm(result - self.eigval * w64))
        den = float(np.linalg.norm(result)) or 1.0
        self.residuals.append(num / den)
        if self.quantize_bits:
            return quantize_unit(result, self.quantize_bits)
        return unit_vector(result)

    def fused_update(self, mode: Optional[str] = None) -> Optional[Callable]:
        """The device twin of the host iterate chain: normalize (and snap to
        the 2^-bits grid) on the card, bitwise-identical to
        :func:`~repro_torch.runtime.elastic_runner.quantize_unit` /
        :func:`~repro_torch.runtime.elastic_runner.unit_vector`: both square,
        tree-reduce, sqrt, divide and round with the same explicit
        elementwise schedule in float32 (IEEE ops are exact given the order,
        and nothing here fuses a multiply and an add). The all-zero fallback
        is chosen by ``torch.where``, not by a branch on device data.

        The per-step residual/eigenvalue statistics stay on the host: the
        engine replays :meth:`consume` on the window's (ys, ws) outputs and
        discards its returned operand."""
        del mode
        if type(self).consume is not MatVecPowerIteration.consume:
            # A subclass with its own host consume chain has no device twin
            # here: fall back to stepwise rather than diverge.
            return None
        bits = self.quantize_bits

        def upd(y, w):
            import torch

            from repro_torch.runtime.elastic_runner import _tree_sumsq

            del w
            v = y.to(torch.float32)
            u = v / torch.sqrt(_tree_sumsq(v, torch))
            if not bits:
                return u
            q = (torch.round(u * (1 << bits)) / float(1 << bits)).to(
                torch.float32)
            fallback = torch.zeros_like(u).reshape(-1).scatter(
                0, torch.argmax(torch.abs(v)).reshape(1), 1.0
            ).reshape(u.shape)
            return torch.where(torch.any(q != 0), q, fallback)

        return upd

    def finalize(self, runner, reports, last_result, last_operand):
        from repro_torch.runtime.elastic_runner import PowerIterationResult

        return PowerIterationResult(
            reports=reports,
            eigvec=last_operand,
            eigval=self.eigval,
            residuals=self.residuals,
            churn_events=runner.churn_events,
            plans_compiled=runner.plans_compiled,
            cache_hits=runner.cache_hits,
            total_waste=runner.total_waste,
            executor_cache_size=runner.executor_cache_size,
        )


class MatMat(Workload):
    """``Y = X @ W`` per step, W multi-column (r, c).

    Rows of X split over the elastic placement exactly as for matvec, each
    worker computes its block against the full W, and the combine assembles
    Y. Dispatched through the blocked
    :func:`repro_torch.kernels.ops.usec_matmat` path.

    ``w`` fixes the operand at construction; pass ``operand=`` to ``run()``
    to override. Analytical completion times scale by c (each row costs c
    matvec rows).
    """

    name = "matmat"
    linear = True

    def __init__(self, w: Optional[np.ndarray] = None):
        self.w = None if w is None else np.asarray(w, dtype=np.float32)
        if self.w is not None and self.w.ndim != 2:
            raise ValueError(f"MatMat operand must be (r, c), got {self.w.shape}")
        self._cols = None if self.w is None else int(self.w.shape[1])

    def tile_compute(self, staged_block, operand):
        return self.executor_fn(None)(staged_block, operand)

    def executor_fn(self, mode: Optional[str] = None) -> Callable:
        from repro_torch.kernels.ops import executor_matmul

        return executor_matmul(mode, workload="matmat")

    def segmented_fn(self, mode: Optional[str] = None,
                     block_rows: int = 16) -> Optional[Callable]:
        return _segmented_linear(mode, block_rows)

    def init_operand(self, rows_total, operand=None):
        w = self.w if operand is None else np.asarray(operand, dtype=np.float32)
        if w is None:
            raise ValueError("MatMat needs W: construct MatMat(w) or pass operand=")
        if w.ndim != 2:
            raise ValueError(f"MatMat operand must be (r, c), got {w.shape}")
        self._cols = int(w.shape[1])
        return w

    def verify(self, result, operand, x64, mode, atol) -> None:
        if x64 is None:
            raise ValueError("verify requires the staged matrix (x64)")
        ref = x64 @ np.asarray(operand, dtype=np.float64)
        _verify_linear(result, ref, "X @ W", mode, atol)

    def cost_scale(self) -> float:
        if self._cols is None:
            # Silently returning 1.0 would label unscaled matvec times as
            # "matmat" on the simulate backend.
            raise ValueError(
                "MatMat cost_scale needs the column count: construct "
                "MatMat(w) (the device backend sets it from the operand)")
        return float(self._cols)


class MapReduceRows(Workload):
    """Arbitrary per-row pure function + monoid combine over all rows.

    The "beyond linear computations" workload: ``row_fn(xb, w2)`` maps each
    staged row block (a (block_rows, r) torch tensor; the operand as a 2-d
    tensor) to a (block_rows, out_cols) value in torch (it must be pure —
    the elastic machinery may recompute rows on any holder), the executor
    assembles the per-row map output with exactly-once semantics across
    churn and stragglers, and ``reduce_fn`` folds the assembled (q,
    out_cols) NumPy array into the step result on the host (any monoid:
    sum, max, logsumexp, histogram merge, ...).

    ``ref_row_fn(x64, operand) -> (q, out_cols) float64`` is the NumPy
    reference for ``verify`` (it checks the *map* output — the part the
    distributed machinery is responsible for); like ``row_fn``, it receives
    the operand in its executor form (a 1-d operand arrives as an (r, 1)
    column). ``cost`` is the per-row work relative to a matvec row (the
    simulate backend's scaling). The segmented mode runs ``row_fn`` over
    every block at once through the base :meth:`Workload.segmented_fn`.
    """

    name = "map_reduce_rows"

    def __init__(
        self,
        row_fn: Callable,
        reduce_fn: Callable[[np.ndarray], Any],
        out_cols: int = 1,
        ref_row_fn: Optional[Callable] = None,
        operand: Optional[np.ndarray] = None,
        cost: float = 1.0,
        name: Optional[str] = None,
    ):
        self.row_fn = row_fn
        self.reduce_fn = reduce_fn
        self.out_cols = int(out_cols)
        self.ref_row_fn = ref_row_fn
        self.operand = (
            None if operand is None else np.asarray(operand, dtype=np.float32)
        )
        self.cost = float(cost)
        if name:
            self.name = name

    def tile_compute(self, staged_block, operand):
        return self.row_fn(staged_block, operand)

    def init_operand(self, rows_total, operand=None):
        if operand is not None:
            return np.asarray(operand, dtype=np.float32)
        if self.operand is not None:
            return self.operand
        # row_fn may not use the operand at all; feed a fixed placeholder so
        # the executor signature stays uniform.
        return np.zeros((1,), dtype=np.float32)

    def combine(self, partials):
        return self.reduce_fn(np.asarray(partials))

    def verify(self, result, operand, x64, mode, atol) -> None:
        # ``result`` here is the raw assembled map output (the runner
        # verifies before the host-side reduce): that is the quantity the
        # distributed machinery must deliver exactly once per row.
        if self.ref_row_fn is None:
            raise ValueError(
                f"{self.name}: verify requires ref_row_fn (a NumPy reference "
                "of row_fn)")
        if x64 is None:
            raise ValueError("verify requires the staged matrix (x64)")
        op = np.asarray(operand)
        op2 = op if op.ndim == 2 else op[:, None]
        ref = np.asarray(self.ref_row_fn(x64, op2), dtype=np.float64)
        ref = ref.reshape(x64.shape[0], self.out_cols)
        _verify_linear(result, ref, f"{self.name} map", mode, atol)

    def cost_scale(self) -> float:
        return self.cost
