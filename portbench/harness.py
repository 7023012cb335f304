"""One run of one cell: set-up, the measured window, an optional traced
slice, and the comparison with the plain reference that decides
``correct``.

The window is a closed loop with one caller: each solve takes the next
right-hand side of the pool and the next starts as soon as it has returned
and the device has finished it.  The window is timed by the host's clock,
each solve also between CUDA events around it.  Once the window has
closed, the answers of a sample of its solves, drawn from the seed by
reservoir sampling, are compared with the reference's solutions.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time
import traceback

import torch

from portbench import registry
from portbench import trace as tracing
from portbench import traffic as traffic_gen

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "multigrid_prj_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (whole) is in ``FORBIDDEN``."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a run measured: every metric reader reads one of these."""
    cell: dict
    family: object
    setup_s: float
    window_s: float
    durations_s: list  # per completed solve (see _SolveClock)
    attempted: int
    failed: int
    iterations: list  # per completed solve
    launches: dict  # wrapper launches over the window
    memory_peak_bytes: int
    trace: tracing.Trace | None = None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.items = size, 0, []
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        k = self._rng.randrange(self.seen)
        if k < self.size:
            self.items[k] = item


class _SolveClock:
    """One solve's time: on the card between two CUDA events, recorded
    before the solve's first operation and after its last, on the device's
    clock, which resolves a 10 ms solve where the host's clock does not;
    on the CPU by the host's clock.  ``stop`` waits for the device."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.begin.elapsed_time(self.end) / 1e3
        return time.perf_counter() - self.t0


def _prewarm_allocator(u, count: int, device) -> None:
    """Have the caching allocator hold ``count`` blocks of an answer's
    size, so that answers kept for the sample take no new device memory
    inside the window."""
    if torch.device(device).type != "cuda":
        return
    nbytes = u.untyped_storage().nbytes()
    blocks = [torch.empty(nbytes, dtype=torch.uint8, device=device)
              for _ in range(count)]
    del blocks


def _traced_solves(family, solver, entry, pool, start, count, device):
    """``count`` solves under ``torch.profiler`` (after one untimed traced
    solve that starts the profiler up): the reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        family.solve(solver, entry, pool[start % len(pool)])
        sync(device)
    iterations = []
    with profile(activities=activities) as prof:
        sync(device)
        t0 = time.perf_counter()
        for i in range(count):
            with record_function(tracing.SPAN):
                ans = family.solve(solver, entry,
                                   pool[(start + 1 + i) % len(pool)])
            iterations.append(ans.iterations)
        sync(device)
        window_s = time.perf_counter() - t0
    return tracing.summarize(prof.events(), window_s,
                             tracing.port_kernel_names(), count, iterations)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple[Run, list]:
    """Run ``cell`` (as :func:`registry.cell` gives it) once.  Returns the
    :class:`Run` and the checks, ``(name, value, limit)`` each."""
    config, mix = cell["config"], cell["traffic"]
    if mix["loop"] != "closed" or int(mix["callers"]) != 1:
        raise ValueError(f"the generator drives one closed-loop caller, "
                         f"not {mix}")
    family = registry.load_module("solvers", config["family"])
    problem = registry.load_module("problems", config["problem"])
    kw = config["solver"]
    entry = cell["entry"]
    pool = traffic_gen.make_pool(problem, kw["shape"], kw["length"], mix,
                                 seed, device)
    solver = family.build(config, device)
    warmup = int(cell["warmup_solves"])
    ans = None
    for i in range(warmup):
        ans = family.solve(solver, entry, pool[i % len(pool)])
        sync(device)
    if ans is not None:
        _prewarm_allocator(ans.u, int(cell["sample"]) + 1, device)
    del ans
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    sample = Reservoir(int(cell["sample"]), seed)
    durations, iterations, residuals = [], [], []
    attempted = failed = 0
    j = warmup % len(pool)
    clock = _SolveClock(device)
    before = family.launch_counts()
    t_begin = t_end = time.perf_counter()
    while t_end - t_begin < seconds:
        attempted += 1
        try:
            clock.start()
            ans = family.solve(solver, entry, pool[j])
            elapsed = clock.stop()
        except Exception:  # a failed solve is counted, and the loop goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=sys.stderr)
            t_end = time.perf_counter()
            j = (j + 1) % len(pool)
            continue
        t_end = time.perf_counter()
        durations.append(elapsed)
        iterations.append(ans.iterations)
        residuals.append(ans.residual)
        failed += not ans.converged
        sample.offer((j, ans.u))
        j = (j + 1) % len(pool)
    window_s = t_end - t_begin
    after = family.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    ans = None

    traced = None
    if trace:
        traced = _traced_solves(family, solver, entry, pool, j,
                                int(cell["trace_solves"]), device)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    del solver
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell=cell, family=family, setup_s=setup_s, window_s=window_s,
              durations_s=durations, attempted=attempted, failed=failed,
              iterations=iterations, launches=launches,
              memory_peak_bytes=peak, trace=traced)
    return run, compare(cell, pool, sample.items, residuals, failed)


def compare(cell: dict, pool: list, answers: list, residuals: list,
            failed: int) -> list:
    """The numbers that decide ``correct``, each with its limit:
    ``failed`` (solves that raised or did not converge), the largest final
    history entry against the configuration's ``tol``, and the largest
    ``||u - u*|| / ||u*||`` over the sampled answers, ``u*`` the plain
    reference's float64 solution for the same right-hand side."""
    config = cell["config"]
    kw = config["solver"]
    reference = registry.load_module("reference", config["reference"])
    exact = {}
    worst = None if not answers else 0.0
    for j, u in answers:
        if j not in exact:
            exact[j] = reference.solve(pool[j], kw["alpha"], kw["length"])
        ref = exact[j]
        err = float(torch.linalg.vector_norm(u.to(ref.dtype) - ref)
                    / torch.linalg.vector_norm(ref))
        worst = err if err != err else max(worst, err)  # keep a NaN
    limits = cell["limits"]
    return [("failed", failed, 0),
            ("history_final", max(residuals) if residuals else None,
             float(kw["tol"])),
            ("u_rel_err", worst, float(limits["u_rel_err"]))]


def passed(checks: list) -> bool:
    return all(value is not None and value == value and value <= limit
               for _, value, limit in checks)


def read_metrics(run: Run, names: list[str]) -> dict:
    """Each named metric's reader applied to ``run``; a reader that finds
    nothing to read returns ``None`` and its metric is left out."""
    out = {}
    for name in names:
        reader = registry.load_module("metrics", name)
        value = reader.read(run)
        if value is not None and value == value and abs(value) != float("inf"):
            out[name] = {"value": float(value), "unit": reader.UNIT}
    return out
