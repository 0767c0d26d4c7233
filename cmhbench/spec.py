"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics. Everything that belongs to one of them sits in a
file of its own under this folder, found by the name the list gives:

- a configuration: the file its entry names (``configs/<name>.json``);
- a configuration's method (its ``method``): the port's side in
  ``methods/<method>.py`` and the plain reference in
  ``reference/<method>.py``, the name in lower case;
- a traffic mix: ``traffic/<name>.json``, whose ``kind`` names the module
  in ``kinds/`` that reads it;
- a cell's limits for ``correct``: ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(outcome)``
  returns the metric or None when the run holds nothing to read.

A new configuration, mix, cell or metric is therefore new files and new
entries, and no edit of a file that is already here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    with open(ROOT / _by_name(bench["configs"], name, "config")["file"]) as f:
        return json.load(f)


def method(cfg: dict):
    """The module of ``methods/`` that builds the configuration's method."""
    return importlib.import_module(f"cmhbench.methods.{cfg['method'].lower()}")


def reference(cfg: dict):
    """The module of ``reference/`` that holds the method's plain reference."""
    return importlib.import_module(f"cmhbench.reference.{cfg['method'].lower()}")


def traffic(name: str) -> dict:
    with open(PKG / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str) -> Dict[str, float]:
    with open(PKG / "limits" / f"{cell_name}.json") as f:
        return json.load(f)["limits"]


def metrics(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell_name`` reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str) -> Callable[[object], Optional[float]]:
    """``read`` of ``metrics/<name>.py``, loaded from its file (a metric's
    name may hold dots)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cmhbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
