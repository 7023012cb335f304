"""Checkpoint / resume for long solves (port of
``multigrid_prj_tpu/utils/checkpoint.py``).

A compressed ``.npz`` of the solver state in the JAX package's layout, key
for key: ``u``, ``b``, ``history``, ``config`` (JSON as a uint8 buffer) and
any extra arrays.  So a checkpoint written by either package loads and
resumes in the other.  Tensors are written from the host (``.cpu()``);
loading returns numpy; :func:`resume_solve` continues on the solver's
device in the stored dtype.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, u, b, history, config: Optional[dict] = None,
                    **arrays) -> None:
    """Write solver state as compressed npz (+ JSON-encoded config)."""
    np.savez_compressed(
        path,
        u=_host(u),
        b=_host(b),
        history=_host(history),
        config=np.frombuffer(
            json.dumps(config or {}).encode(), dtype=np.uint8
        ),
        **{k: _host(v) for k, v in arrays.items()},
    )


def load_checkpoint(path: str) -> dict[str, Any]:
    """Load a checkpoint; returns dict with u, b, history, config, extras
    (numpy arrays)."""
    with np.load(path) as z:
        out: dict[str, Any] = {k: z[k] for k in z.files if k != "config"}
        out["config"] = json.loads(bytes(z["config"]).decode() or "{}")
    return out


def resume_solve(solver, path: str):
    """Resume a :class:`multigrid_prj_tpu_torch.gmg.GMGSolver` solve from
    ``path``: continue the outer iteration from the stored ``u`` on
    ``solver.device`` (in the stored dtype) and concatenate the residual
    histories."""
    state = load_checkpoint(path)
    b = torch.from_numpy(state["b"]).to(solver.device)
    u0 = torch.from_numpy(state["u"]).to(solver.device)
    result = solver.solve(b, u0=u0)
    prior = np.asarray(state["history"])
    result.history = np.concatenate([prior[:-1], np.asarray(result.history)])
    return result
