"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes as run, its source, the
  keys changed from the source (``reduced``) and the sizes assumed;
* ``traffic/<traffic>.json``: the round's shape and schedule;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, each a ``read(ctx)`` that returns a number or None;
* ``limits/<cell>.json``: the limit of each number the comparison reads,
  with the readings it was set from.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    limits: dict = field(default_factory=dict)

    def reader(self, metric: dict):
        """The metric's ``read(ctx)``."""
        pkg = "end_to_end" if metric in self.end_to_end else "metrics"
        mod = importlib.import_module(f"fedbench.{pkg}.{metric['name']}")
        return mod.read


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, metrics and
    limits; raises if any of them is missing."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    cell = Cell(
        name=name, chips=int(entry["chips"]),
        config_name=entry["config"], traffic_name=entry["traffic"],
        config=_json(root / cfg_entry["file"]),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _for(m, name)],
        per_layer=[m for m in bench["per_layer"] if _for(m, name)],
        limits=_json(HERE / "limits" / f"{name}.json")["limits"])
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m)              # fails here if a reader is missing
    return cell
