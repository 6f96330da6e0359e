"""Peaks of one H100 and the least time each measured piece of work needs.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at the 700 W
limit): HBM3 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s,
bfloat16 on the tensor cores 989 TFLOP/s. The port's §V kernels compute
in float32 FFMA, so that is their compute peak; a model's matmuls and
flash attention run in bfloat16 on the tensor cores.
(``bound_ms`` is a copy of the repository's smoke test's arithmetic.)

Work is counted from the configuration, never from the program: each input
byte read once, each needed output byte written once, whatever the kernel
reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
F32 = 4


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    """The least time in ms and which bound sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def segmented_work(dim: int, copies: int, cols: int):
    """Bytes and flops of the ``usec_segmented`` calls of one step: the
    plan's real blocks cover every row of X ``copies`` (1 + S) times; each
    such row is read once (``dim`` float32), the operand (dim, cols) once,
    and each computed row writes ``cols`` partials."""
    rows = dim * copies
    n_bytes = F32 * (rows * dim + dim * cols + rows * cols)
    n_flops = 2.0 * rows * dim * cols
    return n_bytes, n_flops


def step_work(dim: int, cols: int = 1):
    """The least work of one step whatever implements it: X once (no
    redundancy), the operand once, the result once."""
    n_bytes = F32 * (dim * dim + 2 * dim * cols)
    n_flops = 2.0 * dim * dim * cols
    return n_bytes, n_flops


def segmented_share(rec: dict, kind: str, steps_key: str, cols: int):
    """``usec_segmented``'s share of its roofline in a traced slice (%).

    The least time is that of the rows the plan's real blocks need, each
    once (:func:`segmented_work`), per step or window the slice completed;
    the time is the trace's ``segmented_kernel`` time. Where the trace kept
    fewer of the kernel's records than the launches counted, its time is
    scaled up by the missing share (the launches of a slice do like work).
    None where the slice has nothing to read."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or not tr or not tr[steps_key]:
        return None
    ks = [v for k, v in tr["kernels"].items()
          if k.startswith("segmented_kernel")]
    secs = sum(v[0] for v in ks)
    kept = sum(v[1] for v in ks)
    if kept <= 0 or secs <= 0:
        return None
    made = tr["launches"]["segmented_kernel"]
    if made > kept:
        secs *= made / kept
    least_ms, _ = bound_ms(*segmented_work(rec["dim"], rec["copies"], cols))
    return 100.0 * tr[steps_key] * least_ms * 1e-3 / secs
