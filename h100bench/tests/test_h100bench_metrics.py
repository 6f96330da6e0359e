"""Each metric's reader on a recorded run, and the roofline arithmetic."""

import math

import numpy as np
import pytest

from h100bench.harness import bench, roofline

D = 36000


def powerit_rec():
    return {
        "kind": "powerit", "setup_s": 21.5, "window_s": 10.0,
        "iterations": 3200, "dim": D, "copies": 1,
        "steps": [(0.0019, 0.0002, 1.2), (0.0019, 0.0004, 1.4)],
        "trace": {"window_s": 3.0, "busy_s": 1.8, "iterations": 960,
                  "n_kernels": 3840,
                  "kernels": {"segmented_kernel<1>": [1.62, 960],
                              "Memcpy HtoD (Pageable -> Device)": [0.01, 960]},
                  "launches": {"segmented_kernel": 960}},
    }


def serve_rec():
    lat = np.linspace(0.1, 0.5, 101)
    lat[-1] = np.nan
    return {
        "kind": "serve", "setup_s": 20.0, "window_s": 10.0,
        "queries": 101, "latency_s": lat, "limit_ms": 400.0,
        "batch_cols": 32, "dim": D, "copies": 1,
        "polls": [(0.17, 16), (0.19, 32)],
        "trace": {"window_s": 3.0, "busy_s": 2.85, "windows": 18,
                  "n_kernels": 54,
                  "kernels": {"segmented_kernel<8>": [2.88, 18]},
                  "launches": {"segmented_kernel": 18}},
    }


def read(name, rec):
    return bench.reader(name)(rec)


def test_powerit_readers():
    rec = powerit_rec()
    assert read("iter_ms", rec) == pytest.approx(10.0 / 3200 * 1e3)
    assert read("setup_s", rec) == 21.5
    assert read("runner.replan_ms", rec) == pytest.approx(0.3)
    assert read("planner.modeled_iter_ms", rec) == pytest.approx(1300.0)
    assert read("executor.launches_per_iter", rec) == pytest.approx(4.0)
    assert read("device_idle.powerit", rec) == pytest.approx(40.0)
    least = 4 * (D * D + 2 * D) / 3.35e12
    assert read("iter_mfu", rec) == pytest.approx(
        100 * least / (10.0 / 3200))
    seg = 4 * (D * D + D + D) / 3.35e12
    assert read("usec_segmented_roofline.powerit", rec) == pytest.approx(
        100 * 960 * seg / 1.62)
    for name in ("query_p95_ms", "queries_per_s", "serve.batch_fill",
                 "serve.poll_ms", "device_idle.serve",
                 "usec_segmented_roofline.serve"):
        assert read(name, rec) is None


def test_serve_readers():
    rec = serve_rec()
    # Nearest rank: the 96th of 101 sorted latencies (one never answered).
    assert read("query_p95_ms", rec) == pytest.approx(
        1e3 * np.sort(rec["latency_s"][:-1])[95])
    assert read("queries_per_s", rec) == pytest.approx(76 / 10.0)
    assert read("serve.batch_fill", rec) == pytest.approx(100 * 48 / 64)
    assert read("serve.poll_ms", rec) == pytest.approx(180.0)
    assert read("device_idle.serve", rec) == pytest.approx(5.0)
    least = roofline.bound_ms(*roofline.segmented_work(D, 1, 32))[0]
    assert read("usec_segmented_roofline.serve", rec) == pytest.approx(
        100 * 18 * least * 1e-3 / 2.88)
    assert read("iter_ms", rec) is None


def test_a_tail_with_unanswered_queries_reads_nothing():
    rec = serve_rec()
    rec["latency_s"][-10:] = np.nan      # 10 % never answered
    assert read("query_p95_ms", rec) is None


def test_roofline_scales_time_for_dropped_records():
    rec = powerit_rec()
    full = read("usec_segmented_roofline.powerit", rec)
    rec["trace"]["kernels"]["segmented_kernel<1>"] = [1.62 * 959 / 960, 959]
    assert read("usec_segmented_roofline.powerit", rec) == pytest.approx(
        full)


def test_no_record_no_roofline():
    rec = powerit_rec()
    rec["trace"]["kernels"] = {}
    assert read("usec_segmented_roofline.powerit", rec) is None


@pytest.mark.parametrize("dim,copies,cols,n_bytes,bound_by", [
    (36000, 1, 1, 4 * (36000 ** 2 + 2 * 36000), "bytes"),
    (36000, 2, 1, 4 * (72000 * 36000 + 36000 + 72000), "bytes"),
    (36000, 1, 32, 4 * (36000 ** 2 + 2 * 36000 * 32), "bytes"),
    (1000, 1, 4096, 4 * (1000 ** 2 + 2 * 1000 * 4096), "operations"),
])
def test_segmented_work(dim, copies, cols, n_bytes, bound_by):
    b, f = roofline.segmented_work(dim, copies, cols)
    assert b == n_bytes
    assert f == 2.0 * dim * copies * dim * cols
    ms, by = roofline.bound_ms(b, f)
    assert by == bound_by
    assert ms == pytest.approx(1e3 * max(b / 3.35e12, f / 67e12))


def test_step_work_counts_x_once():
    b, f = roofline.step_work(36000)
    assert b == 4 * (36000 ** 2 + 2 * 36000) and f == 2.0 * 36000 ** 2
    assert math.isclose(roofline.bound_ms(b, f)[0], 1.5475, rel_tol=1e-3)
