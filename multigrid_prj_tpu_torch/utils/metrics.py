"""Structured metrics, timers and profiling hooks (port of
``multigrid_prj_tpu/utils/metrics.py``).

* :func:`fence` -- completion fence: one element of the first tensor of a
  result fetched to the host;
* :class:`PhaseTimer` -- named wall-clock phases (the reference's
  init/solve split), fenced; with an ``owner``, an object's set-up record
  (each phase's self seconds, the first solve's, and a ``mg.setup.<phase>``
  span), the first :data:`SETUP_LOG_CAP` of a process in
  :data:`SETUP_LOG`;
* :class:`SolveMetrics` -- the residual history with its derived
  convergence factors and throughput, exported as JSON or CSV;
* :func:`trace` -- a ``torch.profiler`` trace of a block (CPU, plus the
  card's kernels where there is a card), written as a Chrome trace file;
* :func:`span` -- a named range in the trace of whatever profiler records
  (the solvers' ``mg.*`` spans), nothing when none records;
* :func:`fetch` -- a solver loop's scalar fetch to the host, counted in
  ``COUNTERS["host_syncs"]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

# program counters: "host_syncs" counts the calls of fetch (a host sync
# each on the card), "kernel_builds" the loads of the kernel library that
# ran nvcc (kernels/_build.library); read the change over a block of work
COUNTERS = {"host_syncs": 0, "kernel_builds": 0}
_NO_SPAN = contextlib.nullcontext()
# the range a span opens: torch's record-function context without the
# Python op dispatch of torch.profiler.record_function, which costs several
# times as much host time per range while a profiler records (PERF.md)
_range = torch._C._profiler._RecordFunctionFast


def _first_tensor(x):
    """The first tensor in ``x``, looking inside lists, tuples and dicts
    (dicts in sorted key order, as ``jax.tree_util.tree_leaves``)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def fence(x) -> None:
    """Completion fence: fetch one element of the first tensor in ``x`` to
    the host (CUDA work is asynchronous; this waits for the stream that
    made it).  Does nothing when ``x`` holds no tensor."""
    t = _first_tensor(x)
    if t is None:
        return
    if t.numel():
        t.reshape(-1)[:1].tolist()
    elif t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


# set-up records (PhaseTimer with an owner): the first SETUP_LOG_CAP of the
# process, in the order they were made (a server that builds a solver per
# request fills it once); a reader takes an owner's first record
SETUP_LOG_CAP = 16
SETUP_LOG: list["PhaseTimer"] = []
SETUP_SPAN = "mg.setup."  # + the phase's name
_SETUP_LOCK = threading.Lock()
_setup_open = threading.local()  # .stack: the open set-up blocks' nested s


@contextlib.contextmanager
def _self_timed():
    """Time the block by the host's clock; on a normal exit the yielded
    list holds its self seconds: its wall less the walls of the set-up
    blocks opened directly inside it on this thread, so a second counts
    once, in the innermost block."""
    stack = _setup_open.__dict__.setdefault("stack", [])
    out = []
    stack.append(0.0)
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        wall = time.perf_counter() - t0
        nested = stack.pop()
        if stack:
            stack[-1] += wall
    out.append(wall - nested)


@dataclasses.dataclass
class PhaseTimer:
    """Named wall-clock phases (the reference's init/solve split).

    With an ``owner`` (``"GMGSolver"``, ``"AMGSolver"``, ``"P1System"``,
    ``"TriangularMesh"``, ``"kernel_library"``) it is that object's set-up
    record, kept in :data:`SETUP_LOG` while the log has room, and always
    on: a phase adds its self seconds (host clock, less the set-up phases
    and first solves nested in it) and, while a profiler records, opens
    the span ``mg.setup.<phase>``; :meth:`solve_span` keeps the first
    solve's self seconds in ``first_solve_s``.  A few clock reads per
    build, one check per later solve."""

    phases: dict[str, float] = dataclasses.field(default_factory=dict)
    owner: Optional[str] = None
    first_solve_s: Optional[float] = None

    def __post_init__(self):
        if self.owner is not None:
            with _SETUP_LOCK:
                if len(SETUP_LOG) < SETUP_LOG_CAP:
                    SETUP_LOG.append(self)

    @contextlib.contextmanager
    def phase(self, name: str, result_to_fence: Any = None):
        if self.owner is not None:
            with span(SETUP_SPAN + name), _self_timed() as out:
                yield
                if result_to_fence is not None:
                    fence(result_to_fence)
            self.phases[name] = self.phases.get(name, 0.0) + out[0]
            return
        t0 = time.perf_counter()
        yield
        if result_to_fence is not None:
            fence(result_to_fence)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def solve_span(self, name: str):
        """A solve's root span ``name`` (:func:`span`).  Until a solve has
        returned it also keeps that solve's self seconds in
        ``first_solve_s``: from the span's start to its end, just after
        the solve's last fetch (the combine's few launches after that
        fetch run on).  It adds no sync and no launch."""
        if self.first_solve_s is not None:
            return span(name)
        return self._first_solve(name)

    @contextlib.contextmanager
    def _first_solve(self, name: str):
        with span(name), _self_timed() as out:
            yield
        self.first_solve_s = out[0]

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.6f} seconds" for k, v in self.phases.items())


@dataclasses.dataclass
class SolveMetrics:
    """Per-solve record: history + derived convergence data + throughput."""

    history: np.ndarray
    wall_time_s: float = 0.0
    nnz: int = 0
    cycles: int = 0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def iterations(self) -> int:
        return max(len(self.history) - 1, 0)

    @property
    def reduction_factors(self) -> np.ndarray:
        h = self.history
        return h[1:] / np.where(h[:-1] == 0, 1.0, h[:-1])

    @property
    def convergence_factor(self) -> float:
        """Geometric mean reduction per iteration (tail-weighted)."""
        f = self.reduction_factors
        if f.size == 0:
            return 0.0
        tail = f[len(f) // 2:]
        return float(np.exp(np.mean(np.log(np.maximum(tail, 1e-300)))))

    @property
    def nnz_per_s(self) -> float:
        if self.wall_time_s <= 0:
            return 0.0
        return self.nnz * self.cycles / self.wall_time_s

    def to_dict(self) -> dict:
        return {
            "iterations": self.iterations,
            "final_residual": float(self.history[-1]) if len(self.history) else None,
            "convergence_factor": self.convergence_factor,
            "wall_time_s": self.wall_time_s,
            "nnz": self.nnz,
            "cycles": self.cycles,
            "nnz_per_s": self.nnz_per_s,
            "history": [float(x) for x in self.history],
            **self.extra,
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    def write_csv(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("iteration,residual,reduction\n")
            h = self.history
            for k, r in enumerate(h):
                red = "" if k == 0 else f"{h[k] / h[k - 1]:.6e}"
                fh.write(f"{k},{r:.17e},{red}\n")


# The solvers' profiler spans (:func:`span`; ranges only while a torch
# profiler records), shared by ``gmg.GMGSolver`` and ``amg.AMGSolver``.  A
# solve is one root span; inside it the outer loop's stages, and inside
# mg.outer.cycle the cycle's stages of level k (L0 the finest) and the
# bottom solve.  The nesting alone tells the solves apart.
SPAN_SOLVE_REFINED = "mg.solve_refined"
SPAN_SOLVE = "mg.solve"
SPAN_SPLIT = "mg.outer.split"  # padding or permutation, b / c pair, ||b||^2
SPAN_FF_RESIDUAL = "mg.outer.ff_residual"  # with the pair update before it
SPAN_FETCH = "mg.fetch"  # a norm and its fetch to the host
SPAN_CYCLE = "mg.outer.cycle"
SPAN_COMBINE = "mg.outer.combine"  # u_hi + u_lo, the crop or permutation
SPAN_BOTTOM = "mg.bottom"
# ops/krylov.cg_arrays (inside mg.outer.cycle for an inner_cg correction):
# each operator apply, the dot products and norms that feed alpha, beta and
# the history, the vector updates, each preconditioner call (a cycle's
# mg.L<k>.* and mg.bottom spans inside it), its stop test in mg.fetch; and
# the correction's restriction to the zero-boundary subspace and back
SPAN_CG_APPLY = "mg.cg.apply"
SPAN_CG_DOT = "mg.cg.dot"
SPAN_CG_UPDATE = "mg.cg.update"
SPAN_CG_PRECOND = "mg.cg.precond"
SPAN_CG_MASK = "mg.cg.mask"
STAGES = ("pre_smooth", "residual", "restrict", "prolong_add", "post_smooth")


class LevelSpans(NamedTuple):
    """The span names of one level's cycle stages."""
    pre_smooth: str
    residual: str
    restrict: str  # with the zero coarse correction; the fused down-leg
    prolong_add: str
    post_smooth: str


_LEVEL_SPANS: dict[int, LevelSpans] = {}


def level_spans(k: int) -> LevelSpans:
    """``mg.L{k}.<stage>`` for each stage, built once per level index."""
    names = _LEVEL_SPANS.get(k)
    if names is None:
        names = _LEVEL_SPANS[k] = LevelSpans(
            *(f"mg.L{k}.{stage}" for stage in STAGES))
    return names


def span(name: str):
    """A record-function range named ``name`` while a torch profiler
    records (the profiler's own enabled flag), else the one shared no-op
    context: one check, nothing allocated, no string made.

    The range is a host event of the recording profiler, on the clock of
    its device events, recorded as a host op (not as a user annotation, so
    nothing is drawn on the device's timeline); a launch made inside it is
    a runtime call inside every span then open, and carries its kernel's
    correlation id."""
    if _profiler._is_profiler_enabled:
        return _range(name)
    return _NO_SPAN


def fetch(x) -> float:
    """``x.item()``, counted in ``COUNTERS["host_syncs"]``: the one scalar
    a solver loop fetches to the host (on the card the host waits for the
    device there).  Returns what ``float(x)`` returns, or ``bool(x)`` for
    a boolean ``x``.  The solvers call it inside their ``mg.fetch`` span,
    together with the norm it fetches."""
    COUNTERS["host_syncs"] += 1
    return x.item()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace context (no-op when ``logdir`` is None).

    Records CPU activity, and CUDA activity when there is a card; on exit
    ``tensorboard_trace_handler`` writes ``*.pt.trace.json`` (a Chrome
    trace, no tensorboard package needed) into ``logdir``.  The trace
    carries the solvers' ``mg.*`` spans (:func:`span`): a solve's root
    span (``mg.solve_refined``, ``mg.solve``), the outer loop's stages and
    each level's cycle stages beneath it, on the kernels' clock; the
    solvers' fetches are counted in ``COUNTERS["host_syncs"]``."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
