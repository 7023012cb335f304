"""The program's own ``mg.*`` spans in a ``torch.profiler`` trace: a cell's
device time and idle time split by the innermost span, and the program's
host syncs per solve.

A solve of ``GMGSolver`` opens one root span (``mg.solve_refined`` or
``mg.solve``); inside it the outer loop's stages and ``mg.outer.cycle``,
inside that each level's cycle stages ``mg.L<k>.<stage>`` and
``mg.bottom``.  A span's path (``mg.solve_refined/mg.outer.cycle/
mg.L0.restrict``) keys the split:

* a device event goes to the innermost span open on the solving thread at
  its launch, the CUDA runtime call with the same correlation id, so a
  kernel that runs after its span has closed on the host still counts for
  it;
* an idle gap between device events goes to the innermost span open at
  the gap's midpoint.

The harness's traced slice keeps sums only (``trace.Trace``), so
:func:`of_run` profiles a slice of its own after a traced run, with the
cell's solver, traffic and ``trace_solves``; the right-hand sides come
from :data:`SEED`, since the split is per solve.
"""

from __future__ import annotations

import dataclasses
import re

from portbench import trace as tracing

ROOTS = ("mg.solve_refined", "mg.solve")
# the outer loop's float-float arithmetic around the cycle
OUTER = ("mg.outer.split", "mg.outer.ff_residual", "mg.fetch",
         "mg.outer.pair_update", "mg.outer.combine")
_CYCLE = re.compile(r"mg\.outer\.cycle|mg\.bottom|mg\.L\d+\.\w+")
TRANSFER = re.compile(r"mg\.L\d+\.(restrict|prolong_add)")
SEED = 1_000_003


def layer(path: str) -> str | None:
    """``"cycle"`` for a path through ``mg.outer.cycle``, a level's stage or
    ``mg.bottom``; ``"outer"`` for a root or a path that ends in one of
    :data:`OUTER` otherwise; ``None`` outside a solve."""
    names = path.split("/")
    if names[0] not in ROOTS:
        return None
    if any(_CYCLE.fullmatch(n) for n in names):
        return "cycle"
    return "outer" if names[-1] in OUTER + ROOTS else None


@dataclasses.dataclass
class Split:
    solves: int  # root spans in the trace
    busy: dict  # span path -> device seconds launched inside it
    idle: dict  # span path -> idle seconds with their midpoint inside it
    unlaunched_s: float  # device seconds whose launch was not found
    host_syncs: int | None = None  # COUNTERS["host_syncs"] over the slice

    def busy_ms_per_solve(self, keep) -> float:
        return sum(s for p, s in self.busy.items() if keep(p)) \
            / self.solves * 1e3

    def idle_ms_per_solve(self, keep) -> float:
        return sum(s for p, s in self.idle.items() if keep(p)) \
            / self.solves * 1e3


def _is_runtime(e) -> bool:
    """A CUDA API call on the host (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...), not a torch op."""
    return e.name.startswith("cu") and "::" not in e.name


def _device_events(events):
    """The device's work: its events less the ranges of spans drawn on its
    timeline (as ``trace.summarize`` counts them)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not (getattr(e, "is_user_annotation", False)
                     or e.name == tracing.SPAN or e.name.startswith("mg."))]


def _innermost(spans, queries):
    """``spans``: ``(start, end, path)`` of one thread, properly nested;
    ``queries``: ``(time, key)``.  Returns ``{key: path}`` of the innermost
    span open at each query's time (queries outside every span left out)."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] < order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def _paths(host):
    """``{thread: [(start, end, path)]}`` of the ``mg.*`` spans on the
    threads that hold a root span."""
    threads = {e.thread for e in host if e.name in ROOTS}
    by_thread = {}
    for e in host:
        if e.thread in threads and e.name.startswith("mg."):
            by_thread.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    out = {}
    for thread, spans in by_thread.items():
        stack, paths = [], []
        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] < start:
                stack.pop()
            path = f"{stack[-1][2]}/{name}" if stack else name
            stack.append((start, end, path))
            paths.append((start, end, path))
        out[thread] = paths
    return out


def reduce(events, host_syncs: int | None = None) -> Split:
    """``events``: the profiler's ``events()``."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = _device_events(events)
    spans = _paths(host)
    solves = sum(1 for e in host if e.name in ROOTS and e.thread in spans)
    launch = {e.id: e for e in host if _is_runtime(e)}

    busy, unlaunched = {}, 0.0
    queries = {thread: [] for thread in spans}
    for i, e in enumerate(device):
        call = launch.get(e.id)
        if call is None:
            unlaunched += e.time_range.elapsed_us()
        elif call.thread in queries:
            queries[call.thread].append((call.time_range.start, i))
    for thread, qs in queries.items():
        for i, path in _innermost(spans[thread], qs).items():
            us = device[i].time_range.elapsed_us()
            busy[path] = busy.get(path, 0.0) + us / 1e6

    idle = {}
    gaps, end = [], None
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in device):
        if end is not None and start > end:
            gaps.append(((start + end) / 2, (start - end) / 1e6))
        end = stop if end is None else max(end, stop)
    found = {}
    for thread in spans:  # a gap goes to the first solving thread's span
        for j, path in _innermost(spans[thread], [
                (mid, j) for j, (mid, _) in enumerate(gaps)]).items():
            found.setdefault(j, path)
    for j, path in found.items():
        idle[path] = idle.get(path, 0.0) + gaps[j][1]
    return Split(solves=solves, busy=busy, idle=idle,
                 unlaunched_s=unlaunched / 1e6, host_syncs=host_syncs)


def measure(cell: dict, device, count: int) -> Split:
    """Profile ``count`` solves of ``cell`` (after one that starts the
    profiler up) on ``device``, with the program's host-sync counter read
    around them (``None`` where the program has none)."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, registry
    from portbench import traffic as traffic_gen

    config, kw = cell["config"], cell["config"]["solver"]
    family = registry.load_module("solvers", config["family"])
    problem = registry.load_module("problems", config["problem"])
    pool = traffic_gen.make_pool(problem, kw["shape"], kw["length"],
                                 cell["traffic"], SEED, device)
    solver = family.build(config, device)
    counters = getattr(importlib.import_module(
        "multigrid_prj_tpu_torch.utils.metrics"), "COUNTERS", None)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        family.solve(solver, cell["entry"], pool[0])
        harness.sync(device)
    before = counters["host_syncs"] if counters else 0
    with profile(activities=activities) as prof:
        for i in range(count):
            family.solve(solver, cell["entry"], pool[(1 + i) % len(pool)])
        harness.sync(device)
    syncs = counters["host_syncs"] - before if counters else None
    return reduce(prof.events(), syncs)


_LAST: list = [None, None]  # the run last measured, and its split


def of_run(run) -> Split | None:
    """The split of a slice of ``run``'s cell, measured once per run; only
    after a traced run on the card, and ``None`` where the program has no
    root span."""
    import torch

    tr = run.trace
    if tr is None or tr.busy_s <= 0 or not torch.cuda.is_available():
        return None
    if _LAST[0] is not run:
        _LAST[:] = [run, measure(run.cell, torch.device(
            "cuda", torch.cuda.current_device()),
            int(run.cell["trace_solves"]))]
    split = _LAST[1]
    return split if split.solves else None
