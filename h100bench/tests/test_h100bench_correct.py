"""``correct``: a sound run passes; the control and each fault the cells
can have fail. On the CPU at a small X, with the timed path broken
underneath the harness (the exchange between chips has no counterpart:
every cell runs on one card)."""

import numpy as np
import pytest
import torch

from h100bench.harness import bench, main, reference
from h100bench.tests.conftest import tiny

POWERIT = ["powerit.cyclic.churn", "powerit.man-s1.first",
           "powerit.man-s1.barrier"]
SERVE = ["serve.cyclic.poisson"]


def _unchanged(y, w):
    return np.asarray(w, dtype=np.float32).reshape(y.shape).copy()


def _half(y, w):
    y = np.array(y, copy=True)
    h = y.shape[-1] // 2 if y.ndim == 2 else y.shape[0] // 2
    if y.ndim == 2:          # a served window: half its columns dropped
        y[:, h:] = 0
        y[:, :h] *= 2
    else:                    # a step: half its rows dropped
        y[h:] = 0
        y[:h] *= 2
    return y


def _altered(y, w):
    y = np.array(y, copy=True)
    y.reshape(-1)[y.size // 3] += 2.0 ** -8
    return y


FAULTS = {"unchanged": _unchanged, "half_batch": _half,
          "altered": _altered}


def _break_steps(monkeypatch, fault):
    from repro_torch.runtime.elastic_runner import ElasticRunner

    step = ElasticRunner.step

    def broken(self, w, *a, **k):
        y, rep = step(self, w, *a, **k)
        return fault(y, w), rep

    monkeypatch.setattr(ElasticRunner, "step", broken)


def _break_windows(monkeypatch, fault):
    from repro_torch.api import ElasticEngine

    submit = ElasticEngine.submit

    def broken(self, operand, *a, **k):
        y, reps = submit(self, operand, *a, **k)
        return fault(np.asarray(y), operand), reps

    monkeypatch.setattr(ElasticEngine, "submit", broken)


@pytest.mark.parametrize("name", POWERIT + SERVE)
def test_a_sound_run_is_correct(run_tiny, name):
    out = run_tiny(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", POWERIT + SERVE)
def test_a_fault_is_not_correct(run_tiny, monkeypatch, name, fault):
    if name in SERVE:
        _break_windows(monkeypatch, FAULTS[fault])
    else:
        _break_steps(monkeypatch, FAULTS[fault])
    out = run_tiny(name)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("precision", sorted(reference.CONTROLS))
@pytest.mark.parametrize("name", POWERIT + SERVE)
def test_the_control_is_not_correct(name, precision):
    """The reference at TF32 (and at bfloat16) in the program's place
    fails the cell's comparison (``h100bench/control.py``, at a small X)."""
    from h100bench import control

    cell = tiny(name)
    ctx = bench.Context(cell=cell, seed=11, seconds=1.0, trace=False,
                        device=torch.device("cpu"), t_start=0.0)
    matmul = reference.CONTROLS[precision]
    if cell.traffic["generator"] == "open_loop":
        rec = control.serve_outputs(ctx, 64, matmul)
    else:
        rec = control.powerit_outputs(ctx, 4, matmul)
    verdict = bench.generator(cell.traffic).check(ctx, rec)
    correct, checks = main.judge(verdict["checks"], cell.limits)
    assert not correct, checks


def test_tf32_rounding():
    """``to_tf32`` keeps 11 significant bits, ties to even: X's diagonal
    (12 bits) moves, its integers and the 2^-8-grid iterates do not."""
    v = torch.tensor([2561 / 64, 2945 / 64, 2563 / 64, -2561 / 64, 6.0,
                      -3.0, 255 / 256, 1 / 256, 0.0], dtype=torch.float32)
    got = reference.to_tf32(v).tolist()
    assert got == [2560 / 64, 2944 / 64, 2564 / 64, -2560 / 64, 6.0, -3.0,
                   255 / 256, 1 / 256, 0.0]


@pytest.mark.parametrize("name", POWERIT + SERVE)
def test_x_is_exact_in_float32_not_in_tf32(name):
    """Every diagonal entry of the cell's X has 12 significant bits, so
    TF32 rounds it; every other entry is a small integer it keeps; and no
    partial sum of a row against a unit 2^-8-grid vector (norm at most
    1 + 2^-9 sqrt(D)) reaches 2^24 steps of 2^-14, so float32 holds every
    partial sum."""
    from h100bench.harness import data

    cell = tiny(name)
    x = data.make_matrix(cell.cfg, 5, torch.device("cpu"))
    d = x.diagonal().clone()
    assert bool((reference.to_tf32(d) != d).all())
    off = x - torch.diag(d)
    assert bool((reference.to_tf32(off) == off).all())
    assert bool((off == off.round()).all())
    d_x = x.shape[0]
    bound = float(torch.linalg.vector_norm(
        x.to(torch.float64), dim=1).max()) * (1 + 2 ** -9 * d_x ** 0.5)
    assert bound < 2 ** 24 * 2 ** -14
