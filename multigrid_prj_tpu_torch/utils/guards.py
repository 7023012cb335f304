"""Numerical guards (port of ``check_finite`` from
``multigrid_prj_tpu/utils/guards.py``)."""

from __future__ import annotations

import numpy as np
import torch


def check_finite(x, name: str = "array") -> None:
    """Raise ``ValueError`` if ``x`` (tensor or numpy array) holds NaN/Inf."""
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    bad = int((~torch.isfinite(t)).sum())
    if bad:
        raise ValueError(
            f"{name} contains {bad} non-finite value(s) (NaN/Inf); "
            "refusing to run the solver on poisoned input"
        )
