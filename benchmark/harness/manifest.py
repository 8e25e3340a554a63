"""Everything the harness finds by name.

`BENCHMARK.json` at the root of the checkout names the cells. A cell names a
configuration (`configs/<config>.json`: the deployment's sizes, the model and
its inductive regime) and a traffic mix (`traffic/<mix>.json`: the entry that
the window drives and its parameters). The configuration's `model` names its
adapter (`harness/adapters/<model>.py`), the mix's `kind` the code that runs
it (`harness/kinds/<kind>.py`). The per-layer metrics are readers
(`metrics/<metric>.py`, each with `read(ctx)`), each cell's limits of
`correct` are `limits/<cell>.json`, and each configuration's operation and
byte counts are `roofline/<config>.py`. A later change adds a cell, a mix, a
model, a kind or a metric as new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(kind: str, name: str) -> Optional[ModuleType]:
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        return None
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Optional[ModuleType]:
    return _module("metrics", name)


def roofline(config_name: str) -> Optional[ModuleType]:
    return _module("roofline", config_name)


class Cell:
    """One entry of `workloads`, with its configuration, mix and metrics."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = bench or manifest()
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.chips = int(entry["chips"])
        self.config_name = entry["config"]
        self.traffic_name = entry["traffic"]
        self.config = config(self.config_name)
        self.traffic = traffic(self.traffic_name)
        self.end_to_end: List[dict] = [m for m in bench["end_to_end"] if self._mine(m)]
        mine = {m["name"] for m in self.end_to_end}
        self.per_layer: List[dict] = [
            m for m in bench["per_layer"]
            if self._mine(m) and ("workloads" in m or m["moves"] in mine)]

    def _mine(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: metric_reader(m["name"]) for m in self.per_layer}
