"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file of its own under this benchmark's folder:

  configs/<config>.json    the deployment: board size, the node's engine
                           settings, chips, the board pools, the control
  traffic/<traffic>.json   the mix: its entry, call width, deep boards a
                           call, how answers are sampled for the check
  entries/<entry>.py       the loop that drives the program (``run``)
  metrics/<metric>.py      one reader a metric (``read``)

A later cell, mix or metric is added by adding files and entries, never by
editing one that is here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(path: str, name: str):
    """Import the file at ``path`` as a module of its own (its name may hold
    dots, which an import statement cannot)."""
    spec = importlib.util.spec_from_file_location(f"gpubench_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable   # (runner.Run) -> float, or None where nothing was read


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    entry: Callable
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


class Catalog:
    """The benchmark as ``BENCHMARK.json`` (or ``bench``) and the files
    under ``bench_dir`` describe it."""

    def __init__(self, bench: Optional[dict] = None, bench_dir: str = BENCH_DIR,
                 root: str = ROOT):
        self.root = root
        self.bench_dir = bench_dir
        self.bench = bench if bench is not None else _load_json(
            os.path.join(root, "BENCHMARK.json"))

    def config(self, name: str) -> dict:
        cfg = _load_json(os.path.join(self.bench_dir, "configs", f"{name}.json"))
        cfg["name"] = name
        return cfg

    def traffic(self, name: str) -> dict:
        mix = _load_json(os.path.join(self.bench_dir, "traffic", f"{name}.json"))
        mix["name"] = name
        return mix

    def entry(self, name: str) -> Callable:
        return _module(os.path.join(self.bench_dir, "entries", f"{name}.py"),
                       f"entry_{name}").run

    def reader(self, name: str) -> Callable:
        return _module(os.path.join(self.bench_dir, "metrics", f"{name}.py"),
                       f"metric_{name}").read

    def _metrics(self, kind: str, workload: str) -> list:
        out = []
        for m in self.bench.get(kind, []):
            if "workloads" in m and workload not in m["workloads"]:
                continue
            out.append(Metric(m["name"], m["unit"], self.reader(m["name"])))
        return out

    def cell(self, workload: str) -> Cell:
        for w in self.bench["workloads"]:
            if w["name"] == workload:
                break
        else:
            known = ", ".join(w["name"] for w in self.bench["workloads"])
            raise KeyError(f"no workload {workload!r} (have: {known})")
        traffic = self.traffic(w["traffic"])
        return Cell(
            name=workload,
            chips=int(w["chips"]),
            config=self.config(w["config"]),
            traffic=traffic,
            entry=self.entry(traffic["entry"]),
            end_to_end=self._metrics("end_to_end", workload),
            per_layer=self._metrics("per_layer", workload),
        )

    def path(self, relative: str) -> str:
        """A path under the benchmark's folder, as a config names it."""
        return os.path.join(self.bench_dir, relative)
