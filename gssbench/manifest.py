"""``BENCHMARK.json`` and the files it names, found by name.

* a workload's configuration: the ``file`` of its ``configs`` entry;
* its traffic: ``gssbench/traffic/<traffic>.json``;
* a graph family: ``gssbench/graphs/<family>.py`` (``generate(params,
  seed)``);
* a metric's reader: ``gssbench/metrics/<metric>.py`` (``read(run)``,
  returning a number or ``None`` when the run holds nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """The parsed ``BENCHMARK.json`` with lookups by name."""

    def __init__(self, data: dict, root: Path = ROOT):
        self.data = data
        self.root = Path(root)
        self._readers: Dict[str, Callable] = {}

    @classmethod
    def load(cls, root: Path = ROOT) -> "Manifest":
        with open(Path(root) / "BENCHMARK.json") as f:
            return cls(json.load(f), root)

    @staticmethod
    def _named(entries: List[dict], name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named(self.data["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.data["configs"], name, "config")
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(HERE / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports (``--trace 0``)."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics ``cell`` reports (``--trace 1``): those
        that list it, and those without a list whose end-to-end metric it
        reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str) -> Callable:
        if metric not in self._readers:
            module = load_module(HERE / "metrics" / f"{metric}.py",
                                 "gssbench_metric_" + metric.replace(".", "_")
                                 .replace("-", "_"))
            self._readers[metric] = module.read
        return self._readers[metric]


def generator(family: str):
    """The module of a graph family, ``gssbench/graphs/<family>.py``."""
    return load_module(HERE / "graphs" / f"{family}.py",
                       "gssbench_graph_" + family.replace("-", "_"))
