"""USEC executor on one card: the worker axis as a batch dimension.

The executor realizes the paper's computation assignment:

- every worker stages verbatim copies of the tiles its placement Z_n assigns
  (uncoded storage),
- the compiled plan gives each worker a *block list* (fixed-size row blocks of
  its stored tiles) plus an inclusion weight per block,
- workers run their own trip count over the block list, then meet at one
  combine (the "master combine").

Redundant (1+S) blocks are computed by all their holders; the inclusion mask
(0/1) selects exactly one surviving copy per block, so the combine
reconstructs ``y = X w`` exactly even when straggler contributions are
dropped.

The JAX reference (:mod:`repro.runtime.executor`) shards the worker axis over
N devices and combines with a ``psum``. On one card the worker axis is a
leading batch dimension of the staged buffer and of the plan arrays, and the
combine is one ``index_add_`` of every worker's per-block partials into the
output rows. It stays exact off the integer grid too: every row has exactly
one included holder, and every other contribution is an exact zero.

Two modes share that combine:

- per-block (``segmented_fn=None``): the host walks each worker's trip count
  (host NumPy from the plan) and launches the block matmul once per real
  block, writing into a compact (N, B, block_rows, cols) buffer;
- segmented: one call covers every worker's whole block list (the
  :func:`repro_torch.kernels.ops.usec_segmented` kernel, one launch a step).

Staging, block plans and include refreshes are NumPy, copied verbatim from
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import CompiledPlan


# ---------------------------------------------------------------------- #
# Staging (host-side): uncoded copies per placement
# ---------------------------------------------------------------------- #
@dataclass
class StagedMatrix:
    """Per-worker staged tile copies of the data matrix X.

    staged:    (N, T_stage, rows_per_tile, r) — worker n's local tile copies
               (zeros in unused slots). This J-fold duplication *is* the
               paper's uncoded storage cost.
    slot_of:   (N, G) int32 — staged slot of tile g on worker n (-1 if absent).
    """

    staged: np.ndarray
    slot_of: np.ndarray

    @property
    def t_stage(self) -> int:
        return self.staged.shape[1]


def stage_matrix(x: np.ndarray, placement, rows_per_tile: int) -> StagedMatrix:
    """Copy each tile of X onto its placement holders (host memory)."""
    n = placement.n_machines
    g_total = placement.n_tiles
    q, r = x.shape
    if q != g_total * rows_per_tile:
        raise ValueError(f"X has {q} rows != G*rows_per_tile = {g_total * rows_per_tile}")
    z = placement.storage_sets()
    t_stage = max(len(s) for s in z)
    staged = np.zeros((n, t_stage, rows_per_tile, r), dtype=x.dtype)
    slot_of = np.full((n, g_total), -1, dtype=np.int32)
    for worker in range(n):
        for slot, g in enumerate(sorted(z[worker])):
            staged[worker, slot] = x[g * rows_per_tile: (g + 1) * rows_per_tile]
            slot_of[worker, g] = slot
    return StagedMatrix(staged, slot_of)


# ---------------------------------------------------------------------- #
# Block plans: segments -> fixed-size work units
# ---------------------------------------------------------------------- #
@dataclass
class BlockPlan:
    """Per-worker fixed-size block lists (padded).

    blk_slot:    (N, B) int32  — staged slot holding the block's tile
    blk_off:     (N, B) int32  — row offset within the tile
    blk_goff:    (N, B) int32  — global output row offset
    blk_include: (N, B) float32 — combine weight (1 = this copy is used)
    n_blocks:    (N,)  int32  — per-worker trip count
    block_rows:  rows per block (static)
    blk_seg_t:   (N, B) int32 — the plan slot ``t`` each block came from
                 (-1 on padding). Lets :func:`refresh_include` recompute the
                 combine weights for a new straggler set without re-expanding
                 the block lists (the elastic runner's per-step hot path).
    blk_prio:    (N, B, 1+S) int32 — the combine-priority order of the
                 block's segment group (-1 on padding). The fused executor
                 gathers include weights for ANY straggler bitmask straight
                 from this array on device (:func:`device_include_weights`),
                 so mid-window stragglers never touch the host.
    """

    blk_slot: np.ndarray
    blk_off: np.ndarray
    blk_goff: np.ndarray
    blk_include: np.ndarray
    n_blocks: np.ndarray
    block_rows: int
    blk_seg_t: Optional[np.ndarray] = None
    blk_prio: Optional[np.ndarray] = None

    @property
    def b_max(self) -> int:
        return self.blk_slot.shape[1]


def _empty_block_plan(n: int, cap: int, block_rows: int, width: int) -> BlockPlan:
    return BlockPlan(
        blk_slot=np.zeros((n, cap), np.int32),
        blk_off=np.zeros((n, cap), np.int32),
        blk_goff=np.zeros((n, cap), np.int32),
        blk_include=np.zeros((n, cap), np.float32),
        n_blocks=np.zeros((n,), np.int32),
        block_rows=block_rows,
        blk_seg_t=np.full((n, cap), -1, np.int32),
        blk_prio=np.full((n, cap, width), -1, np.int32),
    )


def block_plan(
    plan: CompiledPlan,
    slot_of: np.ndarray,
    block_rows: int,
    stragglers: Sequence[int] = (),
    b_max: Optional[int] = None,
) -> BlockPlan:
    """Expand a CompiledPlan's segments into per-worker block lists.

    Requires the plan to have been compiled with ``row_align == block_rows``
    (and ``block_rows | rows_per_tile``) so every segment is block-aligned.

    Vectorized NumPy segment expansion: every (worker, slot) segment emits
    ``seg_len // block_rows`` blocks via one repeat/cumsum pass, in the same
    (worker, slot, block) order as the original triple loop —
    :func:`block_plan_reference` keeps that loop form as the bitwise test
    oracle.
    """
    if plan.rows_per_tile % block_rows:
        raise ValueError(
            f"block_rows={block_rows} must divide rows_per_tile={plan.rows_per_tile}"
        )
    inc = plan.include_mask(stragglers)
    n, t_cap = plan.seg_len.shape
    ln = plan.seg_len.astype(np.int64)
    live = ln > 0
    if np.any(ln[live] % block_rows):
        raise ValueError(
            "segment not block-aligned; compile the plan with "
            f"row_align={block_rows}"
        )
    nb = ln // block_rows                       # (N, T) blocks per segment
    # Flatten row-major: per-worker segments stay contiguous and ordered by
    # slot, so per-worker block positions are a simple offset subtraction.
    nb_flat = nb.ravel()
    total = int(nb_flat.sum())
    per_worker = nb.sum(axis=1)
    cap = int(per_worker.max()) if n else 0
    if b_max is not None:
        if b_max < cap:
            raise ValueError(f"b_max={b_max} < needed {cap}")
        cap = b_max
    cap = max(cap, 1)
    _, _, _, _, prio = plan.seg_arrays()
    width = prio.shape[1] if prio.size else 1 + plan.stragglers
    bp = _empty_block_plan(n, cap, block_rows, width)
    bp.n_blocks[:] = per_worker.astype(np.int32)
    if total == 0:
        return bp

    seg_idx = np.repeat(np.arange(n * t_cap, dtype=np.int64), nb_flat)
    # Within-segment block index: position minus the segment's first position.
    seg_starts = np.concatenate(([0], np.cumsum(nb_flat)))[:-1]
    b_in_seg = np.arange(total, dtype=np.int64) - seg_starts[seg_idx]
    w_of = seg_idx // t_cap
    # Per-worker slot index: position minus the worker's first position.
    w_starts = np.concatenate(([0], np.cumsum(per_worker)))[:-1]
    pos = np.arange(total, dtype=np.int64) - w_starts[w_of]

    g = plan.seg_tile.ravel()[seg_idx].astype(np.int64)
    off = plan.seg_start.ravel()[seg_idx].astype(np.int64) + b_in_seg * block_rows
    slot = slot_of[w_of, g]
    if np.any(slot < 0):
        w_bad = int(w_of[np.argmax(slot < 0)])
        g_bad = int(g[np.argmax(slot < 0)])
        raise RuntimeError(f"worker {w_bad} assigned tile {g_bad} it does not store")
    t_of = seg_idx % t_cap

    bp.blk_slot[w_of, pos] = slot.astype(np.int32)
    bp.blk_off[w_of, pos] = off.astype(np.int32)
    bp.blk_goff[w_of, pos] = (g * plan.rows_per_tile + off).astype(np.int32)
    bp.blk_include[w_of, pos] = inc.ravel()[seg_idx].astype(np.float32)
    bp.blk_seg_t[w_of, pos] = t_of.astype(np.int32)
    sid = plan.seg_id.ravel()[seg_idx]
    if prio.size:
        bp.blk_prio[w_of, pos] = prio[sid]
    return bp


def block_plan_reference(
    plan: CompiledPlan,
    slot_of: np.ndarray,
    block_rows: int,
    stragglers: Sequence[int] = (),
    b_max: Optional[int] = None,
) -> BlockPlan:
    """The original triple-loop block expansion — the test oracle for the
    vectorized :func:`block_plan` (bitwise-identical output, asserted by
    ``tests/test_executor_blocks.py``)."""
    if plan.rows_per_tile % block_rows:
        raise ValueError(
            f"block_rows={block_rows} must divide rows_per_tile={plan.rows_per_tile}"
        )
    inc = plan.include_mask(stragglers)
    _, _, _, _, prio = plan.seg_arrays()
    width = prio.shape[1] if prio.size else 1 + plan.stragglers
    n = plan.n_machines
    lists = [[] for _ in range(n)]
    for w in range(n):
        for t in range(plan.t_max):
            ln = int(plan.seg_len[w, t])
            if ln == 0:
                continue
            if ln % block_rows:
                raise ValueError(
                    "segment not block-aligned; compile the plan with "
                    f"row_align={block_rows}"
                )
            g = int(plan.seg_tile[w, t])
            st = int(plan.seg_start[w, t])
            slot = int(slot_of[w, g])
            if slot < 0:
                raise RuntimeError(f"worker {w} assigned tile {g} it does not store")
            use = float(inc[w, t])
            sid = int(plan.seg_id[w, t])
            for b in range(ln // block_rows):
                off = st + b * block_rows
                lists[w].append(
                    (slot, off, g * plan.rows_per_tile + off, use, t, sid)
                )
    cap = max((len(l) for l in lists), default=0)
    if b_max is not None:
        if b_max < cap:
            raise ValueError(f"b_max={b_max} < needed {cap}")
        cap = b_max
    cap = max(cap, 1)
    bp = _empty_block_plan(n, cap, block_rows, width)
    for w in range(n):
        for i, (slot, off, goff, use, t, sid) in enumerate(lists[w]):
            bp.blk_slot[w, i] = slot
            bp.blk_off[w, i] = off
            bp.blk_goff[w, i] = goff
            bp.blk_include[w, i] = use
            bp.blk_seg_t[w, i] = t
            if prio.size:
                bp.blk_prio[w, i] = prio[sid]
        bp.n_blocks[w] = len(lists[w])
    return bp


def refresh_include(
    bp: BlockPlan, plan: CompiledPlan, stragglers: Sequence[int] = ()
) -> np.ndarray:
    """Recompute ``blk_include`` for a new per-step straggler set.

    The block *geometry* (slots, offsets, trip counts) depends only on the
    plan; the combine weights depend on which holders straggled this step.
    Gathering the plan's (N, T_max) include mask through ``blk_seg_t`` turns
    a straggler change into an O(N·B) array swap — no block re-expansion, no
    recompilation. Returns a fresh (N, B) float32 array; ``bp`` is unchanged.
    """
    if bp.blk_seg_t is None:
        raise ValueError("BlockPlan was built without blk_seg_t; rebuild via block_plan()")
    inc = plan.include_mask(stragglers)                      # (N, T_max)
    t = np.maximum(bp.blk_seg_t, 0)
    rows = np.arange(bp.blk_slot.shape[0])[:, None]
    out = inc[rows, t].astype(np.float32)
    out[bp.blk_seg_t < 0] = 0.0
    return out



# ---------------------------------------------------------------------- #
# Device side
# ---------------------------------------------------------------------- #
@dataclass
class DevicePlan:
    """A :class:`BlockPlan` on the device, uploaded once per plan.

    slot/off: (N, B) int32; include: (N, B) float32 (no-straggler weights);
    n_blocks: (N,) int32; rows: (N * B * block_rows,) int64 output row of
    every compact partial row (the combine's scatter index); prio: (N, B,
    1+S) int32 combine-priority order of each block's segment (-1 on
    padding; None when the block plan carries none); valid: (N, B) float32,
    1.0 on real blocks; blocks: each worker's real (slot, offset) pairs as
    host ints, which the per-block path walks on the host.
    """

    slot: torch.Tensor
    off: torch.Tensor
    include: torch.Tensor
    n_blocks: torch.Tensor
    rows: torch.Tensor
    prio: Optional[torch.Tensor]
    valid: torch.Tensor
    blocks: List[List[Tuple[int, int]]]
    block_rows: int


def device_plan(bp: BlockPlan, device) -> DevicePlan:
    """Upload a block plan's arrays to ``device``."""
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    br = bp.block_rows
    rows = (bp.blk_goff.astype(np.int64)[..., None]
            + np.arange(br, dtype=np.int64)).reshape(-1)
    blocks = [
        list(zip(bp.blk_slot[n, :nb].tolist(), bp.blk_off[n, :nb].tolist()))
        for n, nb in enumerate(bp.n_blocks.tolist())
    ]
    valid = (
        bp.blk_seg_t >= 0 if bp.blk_seg_t is not None
        else np.arange(bp.b_max)[None, :] < bp.n_blocks[:, None]
    )
    return DevicePlan(
        slot=put(bp.blk_slot, torch.int32), off=put(bp.blk_off, torch.int32),
        include=put(bp.blk_include, torch.float32),
        n_blocks=put(bp.n_blocks, torch.int32), rows=put(rows, torch.int64),
        prio=None if bp.blk_prio is None else put(bp.blk_prio, torch.int32),
        valid=put(valid, torch.float32), blocks=blocks, block_rows=br,
    )


def from_reference(
    staged: np.ndarray,
    slot_of: np.ndarray,
    block_plan: Dict[str, np.ndarray],
    device,
) -> Tuple[StagedMatrix, DevicePlan]:
    """The JAX package's staged tile buffer and ``BlockPlan`` arrays (as
    NumPy; ``block_plan`` holds the BlockPlan fields by name, e.g.
    ``dataclasses.asdict`` of one) as the port's :class:`StagedMatrix`,
    whose ``staged`` is a tensor on ``device``, and :class:`DevicePlan`."""
    dev = torch.device(device)
    fields = {k: block_plan[k] for k in (
        "blk_slot", "blk_off", "blk_goff", "blk_include", "n_blocks",
        "blk_seg_t", "blk_prio") if block_plan.get(k) is not None}
    bp = BlockPlan(
        **{k: np.asarray(v) for k, v in fields.items()},
        block_rows=int(block_plan["block_rows"]),
    )
    sm = StagedMatrix(
        staged=torch.as_tensor(np.asarray(staged), device=dev),
        slot_of=np.asarray(slot_of, dtype=np.int32),
    )
    return sm, device_plan(bp, dev)


def device_include_weights(
    prio: torch.Tensor, valid: torch.Tensor, bad: torch.Tensor
) -> torch.Tensor:
    """On-device twin of :func:`refresh_include`: (N, B) combine weights
    from a straggler bitmask, without a host round trip.

    For every block the winner is the first **non-straggling** machine in
    its segment's combine-priority order (exactly
    :meth:`CompiledPlan.include_mask`); the weight is 1.0 iff this worker is
    that winner and the block is real. Gathers and compares only, so a
    straggler set inside a fused window is device data.

    Args:
      prio: (N, B, 1+S) int32, -1 on padding (:attr:`BlockPlan.blk_prio`).
      valid: (N, B), nonzero on real blocks.
      bad: (N,) bool straggler bitmask over the machine population.

    The caller validates feasibility on the host (some non-straggler per
    segment); with a dead segment this picks its highest-priority holder
    instead of raising.
    """
    idx = prio.clamp(min=0).to(torch.int64)
    ok = torch.logical_not(
        torch.index_select(bad, 0, idx.reshape(-1)).reshape(idx.shape))
    # argmax takes no bool on CUDA; on ties it returns the first index.
    first = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)
    winner = torch.gather(prio, -1, first)[..., 0]
    ids = torch.arange(prio.shape[0], dtype=prio.dtype,
                       device=prio.device)[:, None]
    return ((winner == ids) & (valid != 0)).to(torch.float32)


def _default_matmul(xb, w2, out=None):
    y = xb.to(torch.float32) @ w2.to(torch.float32)
    return y if out is None else out.copy_(y)


def _make_body(
    rows_total: int,
    block_rows: int,
    mm: Callable,
    out_cols: Optional[int],
    segmented_fn: Optional[Callable],
) -> Callable:
    """The one-step computation shared by the stepwise, per-worker and fused
    executors, so the three drivers run the same math.

    ``body(staged, slot, off, n_blocks, rows, blocks, include, w) -> y`` runs
    the workers of ``staged`` (all N, or a one-worker slice) on their (n, B)
    plan rows: per-block, one ``mm`` per host-listed block into a compact
    (n, B, block_rows, cols) buffer, then the include weights; segmented,
    one ``segmented_fn`` call over every listed worker's block list. Then
    one ``index_add_`` of the compact partials into the output rows. Every
    row gets exactly one included holder and exact zeros otherwise, so the
    combine is exact on any data.
    """

    def body(staged, slot, off, n_blocks, rows, blocks, include, w):
        w2 = w if w.ndim == 2 else w[:, None]
        cols = w2.shape[1] if out_cols is None else out_cols
        n, b = slot.shape
        if segmented_fn is not None:
            compact = segmented_fn(staged, slot, off, include, w2,
                                   n_blocks=n_blocks)
        else:
            # Zero-trip blocks (padding, preempted workers) keep their
            # zeros, as the reference's per-worker fori_loop never writes
            # past its trip count.
            compact = torch.zeros((n, b, block_rows, cols),
                                  dtype=torch.float32, device=staged.device)
            for wk, blks in enumerate(blocks):
                st = staged[wk]
                for i, (s, o) in enumerate(blks):
                    mm(st[s, o: o + block_rows], w2, out=compact[wk, i])
            compact.mul_(include[:, :, None, None])
        y = torch.zeros((rows_total, cols), dtype=torch.float32,
                        device=staged.device)
        y.index_add_(0, rows, compact.reshape(-1, cols))
        # A 1-d operand squeezes back to a vector only when the output width
        # follows the operand; an explicit out_cols keeps its matrix shape.
        return y if (w.ndim == 2 or out_cols is not None) else y[:, 0]

    return body


def make_matvec_executor(
    rows_total: int,
    block_rows: int,
    matmul: Optional[Callable] = None,
    out_cols: Optional[int] = None,
    segmented_fn: Optional[Callable] = None,
) -> Callable:
    """Build the USEC step for a fixed geometry.

    Returns ``step(staged, plan, w, include=None) -> y`` where ``staged`` is
    the (N, T, rows_per_tile, r) tensor of :class:`StagedMatrix`, ``plan`` a
    :class:`DevicePlan`, ``w`` an (r,) or (r, c) tensor on the same device
    and ``include`` an (N, B) float32 override of the plan's combine
    weights. The output is (rows_total[, c]) float32, fully combined.

    ``matmul(xb, w2, out)`` is the per-block compute, writing the
    (block_rows, cols) product of one block into ``out`` (default: an fp32
    product; the workloads pass :func:`repro_torch.kernels.ops.
    executor_matmul`, the ``usec_matvec`` kernel on the card). ``out_cols``
    pins the per-row output width when it differs from the operand's
    column count.

    ``segmented_fn(staged, slot, off, include, w2, n_blocks=...)`` swaps the
    per-block loop for one call over every worker's block list, returning
    the (N, B, block_rows, cols) partials with the include weights applied
    (a workload's ``segmented_fn(mode)``: the ``usec_segmented`` kernel on
    the card).
    """
    body = _make_body(rows_total, block_rows, matmul or _default_matmul,
                      out_cols, segmented_fn)

    def step(staged, plan: DevicePlan, w, include=None):
        inc = plan.include if include is None else include
        return body(staged, plan.slot, plan.off, plan.n_blocks, plan.rows,
                    plan.blocks, inc, w)

    return step


def make_worker_executor(
    rows_total: int,
    block_rows: int,
    matmul: Optional[Callable] = None,
    out_cols: Optional[int] = None,
    segmented_fn: Optional[Callable] = None,
) -> Callable:
    """Build the per-worker partial of first-arrival execution.

    Returns ``partial(staged, widx, plan, w, include) -> y_n``: worker
    ``widx``'s **unmasked** (rows_total[, c]) partial over its block list in
    ``plan`` (a :class:`DevicePlan`). The caller passes ``plan.valid[widx]``
    as ``include`` (weight 1 on every real block): the realized straggler
    set is not known at dispatch, so first-arrival masking is the master's
    business, applied on the host per row once arrivals decide the winners.

    Per-block mode launches the block compute once per real block of that
    worker; segmented mode makes one ``segmented_fn`` call over the
    ``[widx:widx+1]`` slices of the staged buffer and the plan, which are
    contiguous. The math is :func:`make_matvec_executor`'s body on a
    one-worker slice, so a winner gather of these partials is
    bitwise-equal to the barrier combine on the same plan.
    """
    body = _make_body(rows_total, block_rows, matmul or _default_matmul,
                      out_cols, segmented_fn)

    def partial(staged, widx: int, plan: DevicePlan, w, include):
        n, b = plan.slot.shape
        sl = slice(widx, widx + 1)
        return body(staged[sl], plan.slot[sl], plan.off[sl],
                    plan.n_blocks[sl], plan.rows.view(n, -1)[widx],
                    [plan.blocks[widx]], include.reshape(1, b), w)

    return partial


_WINDOW_FIELDS = ("slot", "off", "n_blocks", "rows", "prio", "valid")


class FusedExecutor:
    """The K-step window driver (see :func:`make_fused_executor`).

    ``cache_size`` counts the programs it has built: the captured CUDA
    graphs of the segmented mode on the card (one for the whole run: churn
    is data and the window is always K long), else 1 once it has run.
    ``replays`` counts graph replays (one per window).
    """

    def __init__(self, body, fuse_steps: int, update: Callable,
                 segmented: bool):
        self.body = body
        self.fuse_steps = fuse_steps
        self.update = update
        self.segmented = segmented
        self.cache_size = 0
        self.replays = 0
        self._graph = None
        self._static = None
        self._out = None

    def _loop(self, staged, stacks, blocks, bad, active, w):
        """K steps on device data only: no fetch, no branch on a device
        value. ``stacks`` maps each of :data:`_WINDOW_FIELDS` to a sequence
        of K per-step tensors (or a (K, ...) stack)."""
        ys, ws = [], []
        for k in range(self.fuse_steps):
            act = active[k]
            include = device_include_weights(
                stacks["prio"][k], stacks["valid"][k], bad[k])
            # Inactive padding: zero trip counts and weights, so the body
            # degenerates to a combine of zeros.
            include = include * act.to(torch.float32)
            nblk = stacks["n_blocks"][k] * act.to(torch.int32)
            y = self.body(staged, stacks["slot"][k], stacks["off"][k], nblk,
                          stacks["rows"][k], blocks[k], include, w)
            # ... and the padding iterate carries through unchanged (the
            # update of a zero output may be NaN; where discards it).
            w_next = torch.where(act, self.update(y, w), w)
            ys.append(y)
            ws.append(w)
            w = w_next
        return w, torch.stack(ys), torch.stack(ws)

    def __call__(self, staged, plans: Sequence[DevicePlan], bad: np.ndarray,
                 active: np.ndarray, w):
        K = self.fuse_steps
        if len(plans) != K or bad.shape[0] != K or active.shape[0] != K:
            raise ValueError(f"a window is {K} steps: got {len(plans)} "
                             f"plans, bad {bad.shape}, active {active.shape}")
        dev = staged.device
        bad_d = torch.as_tensor(np.ascontiguousarray(bad, dtype=bool),
                                device=dev)
        act_d = torch.as_tensor(np.ascontiguousarray(active, dtype=bool),
                                device=dev)
        if not (self.segmented and staged.is_cuda):
            # Per-block mode (its launch count follows the plan) and the
            # host: the same loop, eagerly. Inactive steps walk no blocks.
            blocks = [p.blocks if a else [[]] * len(p.blocks)
                      for p, a in zip(plans, active.tolist())]
            stacks = {f: [getattr(p, f) for p in plans]
                      for f in _WINDOW_FIELDS}
            self.cache_size = 1
            return self._loop(staged, stacks, blocks, bad_d, act_d, w)
        if self._graph is None:
            self._capture(staged, plans, bad_d, act_d, w)
        st = self._static
        for k, p in enumerate(plans):
            for f in _WINDOW_FIELDS:
                st[f][k].copy_(getattr(p, f))
        st["bad"].copy_(bad_d)
        st["active"].copy_(act_d)
        st["w"].copy_(w)
        self._graph.replay()
        self.replays += 1
        return self._out

    def _capture(self, staged, plans, bad_d, act_d, w):
        """Capture the window loop once over static buffers. A capture that
        fails raises: there is no eager fallback on the card."""
        st = {f: torch.stack([getattr(p, f) for p in plans])
              for f in _WINDOW_FIELDS}
        st.update(bad=bad_d.clone(), active=act_d.clone(), w=w.clone())
        blocks = [None] * self.fuse_steps

        def run():
            return self._loop(staged, st, blocks, st["bad"], st["active"],
                              st["w"])

        # Warm up on a side stream first (library loads, allocator pools),
        # as CUDA graph capture requires.
        side = torch.cuda.Stream(device=staged.device)
        side.wait_stream(torch.cuda.current_stream(staged.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(staged.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        self._static, self._out, self._graph = st, out, graph
        self.cache_size += 1


def make_fused_executor(
    rows_total: int,
    block_rows: int,
    fuse_steps: int,
    matmul: Optional[Callable] = None,
    out_cols: Optional[int] = None,
    update: Optional[Callable] = None,
    segmented_fn: Optional[Callable] = None,
) -> FusedExecutor:
    """Build the K-step fused window driver.

    Returns ``window(staged, plans, bad, active, w) -> (w_out, ys, ws)``:

      plans:  K :class:`DevicePlan`\\ s, one per step, so a membership change
              inside the window is data (the runner pads a short window
              with its last plan).
      bad:    (K, N) bool host array, per-step straggler bitmasks.
      active: (K,) bool host array, live steps. Inactive padding steps get
              zero trip counts and zero weights, and the iterate carries
              through them unchanged, so the window is always K steps long.
      w:      the iterate carry, (r,) or (r, c), on the device.
      ys:     (K, rows_total[, c]) per-step raw outputs, on the device.
      ws:     (K, ...) the operand each step consumed.

    Include weights are computed on the device from ``bad``
    (:func:`device_include_weights`) and ``update`` (the workload's
    ``fused_update``, e.g. the power-iteration normalize + quantize) runs on
    the device between steps: there is no host synchronisation inside a
    window. The per-step body is the stepwise executor's, so a window is
    bitwise-equal to K stepwise steps.

    In segmented mode on the card the K-step loop is captured once as a CUDA
    graph over static buffers; each window copies its plans, masks and carry
    into them and replays the graph (the returned tensors are the graph's
    outputs, valid until the next window). Per-block mode walks the host
    block lists eagerly: its launch count follows the plan.
    """
    body = _make_body(rows_total, block_rows, matmul or _default_matmul,
                      out_cols, segmented_fn)
    upd = update if update is not None else (lambda y, w: w)
    return FusedExecutor(body, fuse_steps, upd, segmented_fn is not None)
