"""BENCHMARK.json and the files it names agree; a new cell, configuration,
traffic mix, family and metric are new files and entries only."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import registry

REPO = registry.HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_benchmark_names_files_that_agree():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        data = registry.load_json("configs", c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        registry.load_module("solvers", data["family"])
        registry.load_module("problems", data["problem"])
        registry.load_module("reference", data["reference"])
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        assert (cell["config_name"], cell["traffic_name"]) == (w["config"],
                                                               w["traffic"])
        assert w["config"] in configs and cell["why"] == w["why"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert registry.load_module("metrics", m["name"]).UNIT == m["unit"]
        assert m.get("moves", "solve_ms") in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


def test_every_file_name_is_made_of_name_characters():
    for path in registry.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel


def test_metrics_of_follows_workloads_keys():
    bench = registry.benchmark()
    assert registry.metrics_of(bench, "p3d-257-ff32", False) == [
        "solve_ms", "solve_ms_p90", "setup_s"]
    assert "solve_roofline" in registry.metrics_of(bench, "p3d-257-ff32",
                                                   True)
    assert registry.metrics_of(bench, "not-a-cell", True) == []


def test_names_are_checked_before_any_file_is_read():
    with pytest.raises(ValueError):
        registry.load_json("workloads", "../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        registry.load_json("workloads", "no-such-cell")


ADDED = {
    "configs/tiny2d-gmg.json": None,  # from poisson2d-gmg, cut small
    "workloads/tiny-2d.json": None,
    "traffic/closed-pool4.json": json.dumps(
        {"loop": "closed", "callers": 1, "pool": 4, "noise_rel": 0.001}),
    "solvers/gmg-twin.py": "from portbench.registry import load_module\n"
                           "globals().update(vars(load_module('solvers', "
                           "'gmg')))\n",
    "metrics/answers.sampled.py": "UNIT = 'solves'\n\n\ndef read(run):\n"
                                  "    return float(run.attempted)\n",
}

DRIVE = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
from portbench import harness, registry
cell = registry.cell("tiny-2d")
run, checks = harness.run_cell(cell, 7, 0.2, False, "cpu", time.perf_counter())
names = registry.metrics_of(registry.benchmark(), "tiny-2d", False)
print(json.dumps({"correct": harness.passed(checks),
                  "metrics": harness.read_metrics(run, names),
                  "file": registry.__file__}))
"""


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(registry.HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.BENCHMARK, copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}

    config = registry.load_json("configs", "poisson2d-gmg")
    config["family"] = "gmg-twin"
    config["solver"].update(shape=[33, 33], num_levels=3, pad_align=64)
    cell = dict(registry.load_json("workloads", "p2d-1025-ff32"),
                config="tiny2d-gmg", traffic="closed-pool4")
    files = dict(ADDED)
    files["configs/tiny2d-gmg.json"] = json.dumps(config)
    files["workloads/tiny-2d.json"] = json.dumps(cell)
    for rel, text in files.items():
        (copy / "portbench" / rel).write_text(text)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2d-gmg", "source": config["source"],
                             "file": "portbench/configs/tiny2d-gmg.json",
                             "reduced": ["shape"], "why": "a test"})
    bench["workloads"].append({"name": "tiny-2d", "config": "tiny2d-gmg",
                               "traffic": "closed-pool4", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "answers.sampled", "unit": "solves",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-2d"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", DRIVE, str(copy), str(REPO)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(result["file"]).parent == copy / "portbench"
    assert result["correct"] is True
    assert set(result["metrics"]) == {"solve_ms", "solve_ms_p90", "setup_s",
                                      "answers.sampled"}
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path
