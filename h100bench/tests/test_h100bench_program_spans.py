"""The traced run's breakdown names the program's own spans: an idle gap
under a span of ``repro_torch`` nested in the harness's ``bench.job`` goes
to the program span (``trace._name_gaps`` takes the innermost host op or
span), not to ``bench.job``."""

import pytest
import torch

from h100bench.harness import trace


def test_a_gap_goes_to_the_innermost_program_span():
    host = [(0, 1000, "bench.job", 1), (1, 999, "engine.run", 1),
            (10, 500, "engine.step", 1), (20, 490, "runner.step", 1),
            (30, 100, "runner.adopt", 1), (200, 210, "aten::empty", 1)]
    gaps = [(40, 60), (300, 400), (600, 700), (204, 206)]
    named = dict(trace._name_gaps(gaps, host))
    assert named == pytest.approx({"runner.adopt": 20e-9,
                                   "runner.step": 100e-9,
                                   "engine.run": 100e-9,
                                   "aten::empty": 2e-9})


def test_gaps_in_a_profiled_engine_run_go_to_its_spans():
    """A CPU engine run inside ``bench.job`` under the profiler: a gap
    over each ``runner.ingest`` (the EWMA's host arithmetic, no torch op)
    is named ``runner.ingest``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import (
        ElasticEngine,
        EngineConfig,
        MatVecPowerIteration,
        Policy,
    )
    from repro_torch.runtime import SyntheticSpeedClock, make_exact_matrix

    eng = ElasticEngine(
        MatVecPowerIteration(seed=0),
        Policy(placement="cyclic", replication=3, stragglers=0),
        EngineConfig(block_rows=20, segmented="ref"),
        backend="device", n_machines=6,
        clock=SyntheticSpeedClock([1000.0 * 2 ** k for k in range(6)],
                                  jitter_sigma=0.03, seed=0),
        device="cpu")
    eng.prepare(make_exact_matrix(1200, 0))
    eng.run(None, n_steps=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.job"):
            eng.run(None, n_steps=6)
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]
    ingest = [(s, t) for s, t, n, _ in host if n == "runner.ingest"]
    assert len(ingest) == 6
    named = trace._name_gaps(ingest, host)
    assert [n for n, _ in named] == ["runner.ingest"]
    assert named[0][1] == pytest.approx(
        1e-9 * sum(t - s for s, t in ingest))


@pytest.mark.parametrize("name", ["powerit.cyclic.churn",
                                  "serve.cyclic.poisson"])
def test_the_span_window_tool_reads_a_tiny_cpu_window(name):
    """``tools/span_window.py`` runs a cell's window under a Recorder and
    gives each span figure it prints; the harness's ``trace`` is left as
    it was."""
    from conftest import tiny

    from h100bench.tools import span_window

    before = trace.Slice, trace.warm_profiler
    out = span_window.run(tiny(name), 2 ** 31 + 11, 0.4,
                          torch.device("cpu"), log=lambda s: None)
    assert (trace.Slice, trace.warm_profiler) == before
    assert out["correct"] is True
    if name.startswith("powerit"):
        assert out["engine_steps"] == out["iterations"] > 0
        assert 0.9 < out["engine_run_cover"] <= 1.0
        for k in ("runner.host_ms", "runner.update_ms",
                  "executor.dispatch_ms", "ingest_plus_adopt_ms"):
            assert out[k] > 0.0
        assert 0.0 <= out["runner.solve_share"] <= 100.0
        assert out["count_per_step"]["runner.step"] == 1.0
    else:
        assert out["windows"] > 0
        assert out["serve.queue_wait_ms"] > 0.0
        assert out["serve.host_ms"] > 0.0
        assert out["serve.device_allocs_per_window"] == 0.0
