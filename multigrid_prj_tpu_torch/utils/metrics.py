"""Per-solve metrics (port of ``SolveMetrics`` from
``multigrid_prj_tpu/utils/metrics.py``; numpy only): the residual history
with its derived convergence factors and throughput, exported as JSON or
CSV.  The JAX module's ``fence``, ``PhaseTimer`` and ``trace`` wrap JAX's
dispatch and profiler and are not part of the port.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


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
