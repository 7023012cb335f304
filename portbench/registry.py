"""Everything of a cell is found by name under this folder:

* ``workloads/<cell>.json``: the cell (config, traffic, entry, warm-up,
  sample, traced solves, limits, why);
* ``configs/<config>.json``: the configuration (family, problem,
  reference, solver keyword arguments, schedule, source, assumed, reduced);
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``problems/<problem>.py``, ``reference/<reference>.py``,
  ``solvers/<family>.py``: the forcing, the plain reference and the
  driver of a solver family;
* ``metrics/<metric>.py``: one reader per metric.

A new cell, configuration, traffic mix, family or metric is a new file
here and an entry in ``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not _NAME.fullmatch(name) or ".." in name:
        raise ValueError(f"not a {kind} name: {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py``, imported once per process."""
    key = f"portbench.{kind}." + re.sub(r"[^A-Za-z0-9_]", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(
        key, _path(kind, name, ".py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


def cell(name: str) -> dict:
    """The cell ``name`` with its configuration and traffic mix loaded
    under ``"config"`` and ``"traffic"`` (their names under
    ``"config_name"`` and ``"traffic_name"``)."""
    out = dict(load_json("workloads", name), name=name)
    out["config_name"], out["traffic_name"] = out["config"], out["traffic"]
    out["config"] = load_json("configs", out["config_name"])
    out["traffic"] = load_json("traffic", out["traffic_name"])
    return out


def benchmark() -> dict:
    with open(BENCHMARK) as fh:
        return json.load(fh)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[str]:
    """The metrics ``BENCHMARK.json`` asks of ``cell_name``: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    section = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in section
            if cell_name in m.get("workloads", [cell_name])]
