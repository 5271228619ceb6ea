"""Finding a benchmark's parts by name, so that a new cell, configuration,
traffic mix or per-layer metric is a new file and never an edit:

* ``configs/<config>.json``: a configuration (its sizes, source, and the
  ``runner`` that drives it);
* ``workloads/<cell>.json``: a cell, naming its configuration and its
  traffic mix, with its ``why`` and the limits of its check;
* ``traffic/<traffic>.json``: a traffic mix's parameters;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(record)``;
* ``runners/<runner>.py``: the code that runs one kind of cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Callable, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load(kind: str, name: str, base: pathlib.Path = HERE) -> dict:
    """``<base>/<kind>/<name>.json``, with its ``name`` filled in."""
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = json.loads(path.read_text())
    spec.setdefault("name", name)
    return spec


def cell_spec(name: str, base: pathlib.Path = HERE):
    """(cell, its configuration, its traffic) by the cell's name."""
    cell = load("workloads", name, base)
    return (cell, load("configs", cell["config"], base),
            load("traffic", cell["traffic"], base))


def workload_entry(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def runner(name: str):
    return importlib.import_module(f"portbench.runners.{name}")


def metric_reader(name: str, base: pathlib.Path = HERE
                  ) -> Optional[Callable[[dict], Optional[float]]]:
    """``read`` of ``metrics/<name>.py``, or None where there is none."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end_for(bench: dict, cell: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_for(bench: dict, cell: str) -> list:
    """The per-layer metrics a cell reports: those listing it, and those
    with no list whose end-to-end metric it reports."""
    moves = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]
