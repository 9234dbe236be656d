"""Finds a cell's files by the names in BENCHMARK.json: the cell, its
configuration (`configs[].file`), its traffic mix
(`portbench/traffic/<traffic>.json`), its correctness check
(`portbench/checks/<cell>.json`) and a reader for each metric it reports
(`portbench/metrics/<metric>.py`). A later cell, mix, configuration or
metric is a file added beside these; no code names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    root: str
    workload: dict
    config: dict
    traffic: dict
    check: dict
    metrics: list  # BENCHMARK.json entries this cell reports: end_to_end, then per_layer

    @property
    def name(self) -> str:
        return self.workload["name"]

    def reader(self, metric: str):
        """The module of `portbench/metrics/<metric>.py`: its `read(record)`
        gives the metric's value, or None where the run has nothing to read."""
        path = os.path.join(self.root, "portbench", "metrics", metric + ".py")
        mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod

    def reported(self, kind: str) -> list:
        """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
        return [m for k, m in self.metrics if k == kind]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    metrics = [(kind, m) for kind in ("end_to_end", "per_layer") for m in bench[kind]
               if workload in m.get("workloads", [workload])]
    return Cell(root=root, workload=cell, config=_json(os.path.join(root, entry["file"])),
                traffic=_json(os.path.join(root, "portbench", "traffic",
                                           cell["traffic"] + ".json")),
                check=_json(os.path.join(root, "portbench", "checks", workload + ".json")),
                metrics=metrics)
