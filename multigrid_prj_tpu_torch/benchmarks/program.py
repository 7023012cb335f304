"""A chain of calls as one replayable program, as the JAX harnesses jit a
chain into one XLA program: on the card one CUDA graph, so the host's cost
per launch stays out of the timing.  Both ablation harnesses and
``chip_smoke.py`` time through it.

The kernel wrappers count a launch each time they launch (``LAUNCHES``):
in the warm call, and again while a graph is captured, which records the
launch without running it; a replay runs the launches again without
calling the wrappers.  ``CAPTURED`` and ``REPLAYED`` count those two, so
the launches the device ran are ``executed_launches()``.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops.cuda_stencil import LAUNCHES

# kernel name -> launches recorded in graphs / run by their replays since
# the last reset_program_counts()
CAPTURED: dict[str, int] = {}
REPLAYED: dict[str, int] = {}


def reset_program_counts() -> None:
    CAPTURED.clear()
    REPLAYED.clear()


def executed_launches() -> dict[str, int]:
    """Launches the device ran since ``LAUNCHES`` and these counters were
    last reset: the wrapper counts less the captured ones, plus the
    replayed ones."""
    return {k: v - CAPTURED.get(k, 0) + REPLAYED.get(k, 0)
            for k, v in LAUNCHES.items()}


def _add(counts, launches):
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v


class Program:
    """``reps`` calls of ``fn(*args)`` (results dropped) as one replayable
    program.  On the card (``cuda``; by default where ``args[0]`` lies) one
    CUDA graph, captured after one warm call that builds the kernels and
    fills the allocator; on the CPU the calls themselves.  ``replay()``
    enqueues the program; calling the object also waits for it."""

    def __init__(self, fn, *args, reps=1, cuda=None):
        def run():
            for _ in range(reps):
                fn(*args)

        self._run, self.graph, self.launches = run, None, {}
        if not (args[0].is_cuda if cuda is None else cuda):
            return
        fn(*args)
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run()
        self.launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                         if v != before.get(k, 0)}
        _add(CAPTURED, self.launches)

    def replay(self):
        if self.graph is None:
            self._run()
            return
        self.graph.replay()
        _add(REPLAYED, self.launches)

    def __call__(self):
        self.replay()
        if self.graph is not None:
            torch.cuda.synchronize()
