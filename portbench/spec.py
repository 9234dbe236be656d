"""Finds a cell's files by the names in BENCHMARK.json: the cell, its
configuration (`configs[].file`), the model family that configuration's
"model" names (`portbench/families/<family>.py`, with its plain reference
`portbench/references/<family>.py`), its traffic mix
(`portbench/traffic/<traffic>.json`), its correctness check
(`portbench/checks/<cell>.json`) and a reader for each metric it reports
(`portbench/metrics/<metric>.py`). A later cell, mix, configuration, model
family or metric is a file added beside these; no code names one."""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_file(path: str, name: str):
    """The module of the Python file at `path`, executed anew under `name`."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reference_of(family_file: str):
    """A family's plain reference: `references/<f>.py` beside the
    `families/<f>.py` at `family_file`."""
    families, fname = os.path.split(os.path.abspath(family_file))
    return load_file(os.path.join(os.path.dirname(families), "references", fname),
                     "portbench_reference_" + fname[:-3])


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

    @functools.cached_property
    def family(self):
        """The module of `portbench/families/<family>.py`, loaded once a
        cell: every line of the harness that knows the architecture (the
        weights' spec, the program's model, what a request or a batch
        carries and the call that hands it over, the plain reference)."""
        name = self.config["model"]["family"]
        return load_file(family_path(self.root, name), "portbench_family_" + name)

    def reader(self, metric: str):
        """The module of `portbench/metrics/<metric>.py`: its `read(record)`
        gives the metric's value, or None where the run has nothing to read."""
        return load_file(os.path.join(self.root, "portbench", "metrics", metric + ".py"),
                         f"portbench_metric_{metric}")

    def reported(self, kind: str) -> list:
        """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
        return [m for k, m in self.metrics if k == kind]


def family_path(root: str, name: str) -> str:
    return os.path.join(root, "portbench", "families", name + ".py")


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
    config = _json(os.path.join(root, entry["file"]))
    family = config.get("model", {}).get("family")
    if family is None:
        raise ValueError(f"{entry['file']}: its \"model\" has no \"family\" key, the name of "
                         "the model family whose portbench/families/<family>.py builds it")
    if not os.path.isfile(family_path(root, family)):
        raise ValueError(f"{entry['file']}: no portbench/families/{family}.py for its "
                         f"\"family\" {family!r}")
    metrics = [(kind, m) for kind in ("end_to_end", "per_layer") for m in bench[kind]
               if workload in m.get("workloads", [workload])]
    return Cell(root=root, workload=cell, config=config,
                traffic=_json(os.path.join(root, "portbench", "traffic",
                                           cell["traffic"] + ".json")),
                check=_json(os.path.join(root, "portbench", "checks", workload + ".json")),
                metrics=metrics)
