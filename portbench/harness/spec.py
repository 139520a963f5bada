"""What a run is: its cell, configuration, traffic mix, limits and metrics.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``portbench/configs/<config>.json`` (the path is the config's ``file``);
- ``portbench/traffic/<traffic>.json``;
- ``portbench/limits/<workload>.json``: the limits the correctness check
  holds that cell to;
- ``portbench/metrics/<metric>.py``: a reader with ``read(trace) -> float |
  None`` and, optionally, ``WATCH``: the program's functions whose calls it
  counts (see :mod:`portbench.harness.trace`).

A cell, configuration, mix or metric is added by adding files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # metric entries this cell reports with --trace 0
    per_layer: tuple  # metric entries this cell reports with --trace 1


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or workload in cells


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` of ``root/BENCHMARK.json``, with its
    configuration, traffic and limits read. Raises ``KeyError`` for a name
    the file does not hold."""
    spec = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(root / "portbench" / "limits" / f"{workload}.json")
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=tuple(m for m in spec["end_to_end"]
                         if _reports(m, workload)),
        per_layer=tuple(m for m in spec["per_layer"]
                        if _reports(m, workload)),
    )


def load_reader(metric: str, root: Path = ROOT):
    """The reader module of per-layer metric ``metric``
    (``portbench/metrics/<metric>.py``), loaded from its file: a metric's
    name may hold dots, which an import path cannot."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
