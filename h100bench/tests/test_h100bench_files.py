"""Every cell, configuration, mix and metric the benchmark names loads, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from h100bench.harness import bench, configs

B = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def top_level_ok(b):
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["h100bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def four_chip_cells_ok(b):
    """At most a quarter of the cells, rounded down, ask for four cards,
    or one."""
    fours = [w["name"] for w in b["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(b["workloads"]) // 4), fours


def config_entry_ok(cfg, root=bench.ROOT):
    """A ``configs`` entry of BENCHMARK.json and its file."""
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((root / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
        assert key in data["reduced"]
    configs.check(data)


def test_top_level_keys():
    top_level_ok(B)


def test_four_chip_cells_within_a_quarter():
    four_chip_cells_ok(B)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    c = bench.cell(name, B)
    assert c.chips in (1, 4)
    assert c.cfg["name"] == c.entry["config"]
    assert NAME.match(name) and NAME.match(c.entry["traffic"])
    assert len(c.entry["why"]) <= 200
    gen = bench.generator(c.traffic)
    assert callable(gen.run) and callable(gen.check)
    for lim in c.limits.values():
        assert lim["limit"] >= 0


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    config_entry_ok(cfg)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert Path(bench.HERE / "metrics" / f"{m['name']}.py").is_file()
    assert callable(bench.reader(m["name"]))
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        # Every cell that reports this metric reports what it moves.
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_enough(name):
    e2e = [m["name"] for m in bench.metrics_for(B, name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.metrics_for(B, name, True)


def test_layer_names_agree():
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
