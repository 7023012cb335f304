"""Reduction of a ``torch.profiler`` trace of some solves to the numbers
the per-layer metrics read.

Busy time is ``chip_smoke.profile_run``'s arithmetic (PR 14), frozen here:
the summed duration of every device event; the port runs one stream, so
its kernels run one at a time and the sum is the device's busy time.  A
device event is one of the port's kernels when its name is a
``__global__`` function of the port's ``csrc/*.cu``, read from the sources
at run time; every other device event (torch's elementwise kernels and
reductions, cuBLAS, copies) is a plain op.  Each idle gap between device
events is put down to the innermost host op that ran at its midpoint.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import re
from pathlib import Path

SPAN = "portbench.solve"  # the benchmark's span around each solve
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^()]*\)"
                     r"\s*)?([A-Za-z_]\w*)\s*\(")


def port_kernel_names(package: str = "multigrid_prj_tpu_torch") -> frozenset:
    """Names of the ``__global__`` functions in the package's ``csrc``."""
    spec = importlib.util.find_spec(package)
    csrc = Path(list(spec.submodule_search_locations)[0]) / "csrc"
    found = set()
    for src in sorted(csrc.glob("*.cu")):
        found.update(_GLOBAL.findall(src.read_text()))
    return frozenset(found)


def short_name(name: str) -> str:
    """A device event's name without ``void``, anonymous namespaces and
    its argument list (the balanced ``(...)`` it ends with)."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.replace("(anonymous namespace)::", "")[:200]


def is_port_kernel(name: str, kernels: frozenset) -> bool:
    return short_name(name).split("<", 1)[0] in kernels


@dataclasses.dataclass
class Trace:
    window_s: float  # host wall of the traced solves
    busy_s: float  # summed device event time
    port_s: float  # ... of the port's csrc kernels
    plain_s: float  # ... of every other device event
    by_name: dict  # short name -> [seconds, count]
    gaps: dict  # host op at an idle gap -> seconds
    solves: int
    iterations: list  # per traced solve


def summarize(events, window_s: float, kernels: frozenset, solves: int,
              iterations: list) -> Trace:
    """``events``: the profiler's ``events()``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # a span's range drawn on the device's timeline is no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name == SPAN):
                device.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    by_name, busy_us, port_us = {}, 0.0, 0.0
    for e in device:
        us = e.time_range.elapsed_us()
        busy_us += us
        if is_port_kernel(e.name, kernels):
            port_us += us
        entry = by_name.setdefault(short_name(e.name), [0.0, 0])
        entry[0] += us / 1e6
        entry[1] += 1
    return Trace(window_s=window_s, busy_s=busy_us / 1e6,
                 port_s=port_us / 1e6, plain_s=(busy_us - port_us) / 1e6,
                 by_name=by_name, gaps=_gaps(device, host), solves=solves,
                 iterations=list(iterations))


def _gaps(device, host) -> dict:
    """Idle time between consecutive device events, by the innermost host
    op (on the thread that ran the solves) open at the gap's midpoint."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    mids = []
    end = None
    for start, stop in spans:
        if end is not None and start > end:
            mids.append(((start + end) / 2, (start - end) / 1e6))
        end = stop if end is None else max(end, stop)
    threads = {e.thread for e in host if e.name == SPAN}
    ops = sorted(((e.time_range.start, -e.time_range.end, e.name)
                  for e in host if e.thread in threads),
                 key=lambda t: (t[0], t[1]))
    out, stack, i = {}, [], 0
    for mid, seconds in sorted(mids):
        while i < len(ops) and ops[i][0] <= mid:
            start, neg_end, name = ops[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((-neg_end, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1] if stack else "outside the solve span"
        if label == SPAN:
            label = "python between torch ops"
        out[label] = out.get(label, 0.0) + seconds
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The traced run's ``breakdown``: device ops by time, idle gaps by
    the host op."""
    ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(trace.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, s] for name, (s, _) in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}
