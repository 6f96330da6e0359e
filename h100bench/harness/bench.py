"""Find a cell's pieces by name: BENCHMARK.json at the checkout's root names
the cell's configuration and traffic mix; each is a file of its own.

- ``configs/<config>.json``: the deployment, as it is run (its path is the
  configuration's ``file`` in BENCHMARK.json);
- ``traffic/<traffic>.json``: the mix's parameters, including the
  ``generator`` (a module ``h100bench/traffic/<generator>.py``) that reads
  them;
- ``workloads/<cell>.json``: the cell's correctness limits, each with the
  readings it was set from;
- ``metrics/<metric>.py``: one reader per metric, ``read(rec)`` returning a
  number or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent      # h100bench/
ROOT = HERE.parent                                   # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    entry: dict
    cfg: dict
    traffic: dict
    limits: Dict[str, Any]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    bench = benchmark(root) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / cfgs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
    return Cell(name, entry, cfg, traffic, limits)


def host_env(cfg: dict) -> None:
    """The deployment's host settings (``host_env`` of its configuration,
    e.g. math-library threads) into the environment. Called before torch
    or numpy is imported, which read them once."""
    import os

    for k, v in cfg.get("host_env", {}).items():
        os.environ[str(k)] = str(v)


def generator(traffic: dict):
    """The traffic generator module a mix names."""
    return importlib.import_module(
        f"h100bench.traffic.{traffic['generator']}")


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with a ``workloads`` list only in
    those cells."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` (loaded by path: names hold
    dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Context:
    """What a generator needs for one run."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    log: Callable[[str], None] = print
