"""The port's metrics module (``multigrid_prj_tpu_torch/utils/metrics.py``)
against the JAX package's: ``PhaseTimer.report()`` in the JAX format,
``SolveMetrics`` exported alike, ``fence`` taking the first tensor in the
order of ``jax.tree_util.tree_leaves`` through nested lists, tuples and
dicts, and ``trace`` (off with ``None``; a Chrome trace of the CPU ops
with a directory)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from multigrid_prj_tpu.utils import metrics as jmetrics
from multigrid_prj_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def test_phase_timer_report_matches_jax():
    phases = {"init": 0.25, "solve": 1.5000004, "io": 1e-7}
    t, j = tmetrics.PhaseTimer(), jmetrics.PhaseTimer()
    t.phases.update(phases)
    j.phases.update(phases)
    assert t.report() == j.report()
    assert t.report().splitlines()[1] == "solve: 1.500000 seconds"
    with t.phase("init", result_to_fence=torch.ones(3)):
        pass
    with t.phase("new"):
        pass
    assert t.phases["init"] > 0.25 and list(t.phases) == ["init", "solve",
                                                          "io", "new"]


def test_solve_metrics_match_jax(tmp_path):
    h = np.array([1.0, 0.12, 0.013, 0.0011, 1.3e-4])
    kw = dict(history=h, wall_time_s=0.5, nnz=4681, cycles=4)
    t, j = tmetrics.SolveMetrics(**kw), jmetrics.SolveMetrics(**kw)
    assert t.to_dict() == j.to_dict()
    t.write_csv(str(tmp_path / "t.csv"))
    j.write_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def _tree(leaf):
    """One nested structure, its leaves made by ``leaf(i)`` for i = 0, 1,
    ...; dict keys out of sorted order, as tree_leaves sorts them."""
    return [{"z": (leaf(0), leaf(1)), "a": [leaf(2), {"m": leaf(3)}]},
            (leaf(4),), leaf(5)]


@pytest.mark.parametrize("wrap", [lambda t: t, lambda t: {"b": [], "c": t},
                                  lambda t: ([], ((t,),)), lambda t: t[2]])
def test_fence_takes_jax_first_leaf(wrap):
    jleaves = jax.tree_util.tree_leaves(wrap(_tree(lambda i: np.full(2, i))))
    ttree = wrap(_tree(lambda i: torch.full((2,), float(i))))
    first = tmetrics._first_tensor(ttree)
    assert float(first[0]) == float(jleaves[0][0])
    assert tmetrics.fence(ttree) is None


def test_fence_without_tensors_does_nothing():
    for x in (None, [], {"a": 1.0, "b": [np.ones(3)]}, (2, "s"),
              torch.empty(0)):
        assert tmetrics.fence(x) is None


def test_trace_off_and_on_cpu(tmp_path):
    with tmetrics.trace(None):
        pass
    assert not list(tmp_path.iterdir())
    logdir = str(tmp_path / "trace")
    with tmetrics.trace(logdir):
        x = torch.arange(64.0).reshape(8, 8)
        (x @ x).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names
