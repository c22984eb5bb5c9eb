"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell names a configuration and a traffic mix; each is a data file under
``perfbench/configs/`` and ``perfbench/traffic/``, and each per-layer metric
is a reader of its own under ``perfbench/metrics/``. Adding a cell, a
configuration, a traffic mix or a metric adds files and entries; no file
here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent.parent  # perfbench/
ROOT = BENCH_DIR.parent  # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file as it is run
    traffic: dict  # the traffic file
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files read. Raises KeyError for an unknown cell."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"], root)) as f:
        traffic = json.load(f)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "perfbench" / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "perfbench" / "metrics" / f"{name}.py"


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``: it declares NAME,
    UNIT, LAYER, SOURCE, BETTER, MOVES and ``read(record) -> float | None``."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if module.NAME != name:
        raise ValueError(f"{path}: declares NAME {module.NAME!r}, expected {name!r}")
    return module
