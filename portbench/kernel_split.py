"""A profiled slice's device time keyed by (innermost ``mg.*`` span path,
kernel), and the kernels' shares of their roofline.

``spans.Split`` keys device time by span path alone, so it cannot tell
which kernel ran at which level.  Here each device event is put on the
innermost span open at its launch, by ``spans``' own matching, and on its
kernel's name (:func:`kernel_name`).  A kernel's share of its roofline
(:func:`roofline_share`) prices each launch by ``roofline.stage_cost`` of
the stage it carries out, on the logical grid of the level its span names
(``mg.L<k>.<stage>``; the outer loop's spans work on the finest level), by
its bytes alone against ``roofline.HBM_BYTES_PER_S``: every stencil kernel
of the port is bound by bytes.

:func:`of_run` profiles one slice per traced run, as ``spans.of_run`` does
(the harness's own slice keeps sums only), with the cell's solver, traffic
and ``trace_solves``, its right-hand sides from ``spans.SEED``.  On the
card the slice's device timeline is held to CUDA events recorded around
it: the profiler converts its timestamps with a clock rate it fits over
each trace, and one slice on the H100 read every kernel ~2.1 times
faster than it ran (its shares 139–204 %), while the harness's slice of
the same run, and the next runs, read true.
"""

from __future__ import annotations

import dataclasses
import re

from portbench import roofline, spans
from portbench import trace as tracing

_LEVEL = re.compile(r"mg\.L(\d+)\.")
# a slice whose device events span more or less than the CUDA events around
# it timed, by more than this share, is profiled again, up to ATTEMPTS in all
CLOCK_TOLERANCE = 0.02
ATTEMPTS = 3


def kernel_name(name: str) -> str:
    """A device event's kernel: its short name (``trace.short_name``)
    without template arguments and namespaces."""
    return tracing.short_name(name).split("<", 1)[0].rsplit("::", 1)[-1]


@dataclasses.dataclass
class KernelSplit:
    spans: spans.Split  # the same slice keyed by span path alone
    kernels: dict  # (span path, kernel) -> [device seconds, launches]
    device_s: float  # every device event's time, inside a span or not
    span_s: float  # from the first device event's start to the last's end
    iterations: list  # per solve of the slice

    def covered_s(self) -> float:
        """Device seconds launched inside some span of a solve."""
        return sum(self.spans.busy.values())

    def agrees(self, elapsed_s: float) -> bool:
        """Whether the slice's device events span ``elapsed_s``, timed by
        CUDA events recorded around them, within ``CLOCK_TOLERANCE``."""
        return abs(self.span_s - elapsed_s) <= CLOCK_TOLERANCE * elapsed_s


def reduce(events, iterations=()) -> KernelSplit:
    """``events``: the profiler's ``events()``; ``iterations``: of each
    solve they hold.  A device event whose launch no span encloses is left
    out of ``kernels``."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = spans._device_events(events)
    paths = spans._paths(host)
    launch = {e.id: e for e in host if spans._is_runtime(e)}
    queries = {thread: [] for thread in paths}
    for i, e in enumerate(device):
        call = launch.get(e.id)
        if call is not None and call.thread in queries:
            queries[call.thread].append((call.time_range.start, i))
    kernels = {}
    for thread, qs in queries.items():
        for i, path in spans._innermost(paths[thread], qs).items():
            entry = kernels.setdefault((path, kernel_name(device[i].name)),
                                       [0.0, 0])
            entry[0] += device[i].time_range.elapsed_us() / 1e6
            entry[1] += 1
    device_s = sum(e.time_range.elapsed_us() for e in device) / 1e6
    span_s = (max(e.time_range.end for e in device)
              - min(e.time_range.start for e in device)) / 1e6 \
        if device else 0.0
    return KernelSplit(spans=spans.reduce(events), kernels=kernels,
                       device_s=device_s, span_s=span_s,
                       iterations=list(iterations))


def measure(cell: dict, device, count: int) -> KernelSplit | None:
    """Profile ``count`` solves of ``cell`` (after one that starts the
    profiler up) on ``device``.  On the card, a slice that does not agree
    with the CUDA events around it (:meth:`KernelSplit.agrees`) is profiled
    again; ``None`` where none of ``ATTEMPTS`` agrees."""
    import sys

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, registry
    from portbench import traffic as traffic_gen

    config, kw = cell["config"], cell["config"]["solver"]
    family = registry.load_module("solvers", config["family"])
    problem = registry.load_module("problems", config["problem"])
    pool = traffic_gen.make_pool(problem, kw["shape"], kw["length"],
                                 cell["traffic"], spans.SEED, device)
    solver = family.build(config, device)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        family.solve(solver, cell["entry"], pool[0])
        harness.sync(device)
    for _ in range(ATTEMPTS):
        clock = harness._SolveClock(device)
        with profile(activities=activities) as prof:
            clock.start()
            iterations = [family.solve(solver, cell["entry"],
                                       pool[(1 + i) % len(pool)]).iterations
                          for i in range(count)]
            elapsed_s = clock.stop()  # waits for the device
        split = reduce(prof.events(), iterations)
        if torch.device(device).type != "cuda" or split.agrees(elapsed_s):
            return split
        print(f"kernel_split: the slice's device events span "
              f"{split.span_s:.6f} s, CUDA events {elapsed_s:.6f} s: "
              f"profiled again", file=sys.stderr)
    return None


_LAST: list = [None, None]  # the run last measured, and its split


def of_run(run) -> KernelSplit | None:
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
    return split if split is not None and split.spans.solves else None


def level_of(path: str) -> int:
    """The level a span path works on: ``k`` of its innermost
    ``mg.L<k>.<stage>``, else 0, the finest (the outer loop's spans)."""
    found = _LEVEL.match(path.rsplit("/", 1)[-1])
    return int(found[1]) if found else 0


def share(split: KernelSplit, picks: dict, shapes: list) -> float | None:
    """The least time of the picked launches over their device time, in
    percent.  ``picks``: ``{kernel: (span regex, roofline stage)}``, a
    launch picked where its kernel is a key and its innermost span matches
    the regex; ``shapes``: each level's logical grid.  ``None`` where no
    launch is picked."""
    least = spent = 0.0
    for (path, kernel), (seconds, launches) in split.kernels.items():
        pick = picks.get(kernel)
        if pick is None or not re.fullmatch(pick[0], path.rsplit("/", 1)[-1]):
            continue
        nbytes, _ = roofline.stage_cost(pick[1], shapes[level_of(path)])
        least += launches * nbytes / roofline.HBM_BYTES_PER_S
        spent += seconds
    return 100.0 * least / spent if spent > 0 else None


def roofline_share(run, picks: dict) -> float | None:
    """:func:`share` of ``run``'s slice, on its configuration's levels."""
    split = of_run(run)
    if split is None:
        return None
    return share(split, picks, run.family.level_shapes(run.cell["config"]))
