"""Numerical guards (port of ``multigrid_prj_tpu/utils/guards.py``):
NaN/Inf detection on tensors and numpy arrays.

* :func:`count_nonfinite` -- the number of NaN/Inf entries as a tensor on
  the input's device (no host sync, so usable inside a solve);
* :func:`check_finite` -- host-side validation raising :class:`ValueError`
  with the offending array's name;
* :func:`guard_solve_io` -- decorator for solver entry points that checks
  every array argument before the call and the result's ``u`` / ``x``
  after it.

The messages are the JAX module's, word for word.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def count_nonfinite(x) -> torch.Tensor:
    """Number of NaN/Inf entries, a 0-dim tensor on ``x``'s device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return (~torch.isfinite(t)).sum()


def check_finite(x, name: str = "array") -> None:
    """Raise ``ValueError`` if ``x`` (tensor or numpy array) holds NaN/Inf."""
    bad = int(count_nonfinite(x))
    if bad:
        raise ValueError(
            f"{name} contains {bad} non-finite value(s) (NaN/Inf); "
            "refusing to run the solver on poisoned input"
        )


def _is_array(a) -> bool:
    return isinstance(a, (torch.Tensor, np.ndarray))


def guard_solve_io(fn):
    """Decorator: validate every array argument of a solve entry point.

    Checks positional/keyword tensor and numpy arguments before the call;
    on return, checks the result's ``u`` / ``x`` attributes, so NaNs
    produced inside a diverging solve surface with a clear error instead
    of propagating into files and plots.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        for i, a in enumerate(args):
            if _is_array(a):
                check_finite(a, f"argument {i} of {fn.__qualname__}")
        for k, a in kwargs.items():
            if _is_array(a):
                check_finite(a, f"{k}= of {fn.__qualname__}")
        out = fn(*args, **kwargs)
        for attr in ("u", "x"):
            val = getattr(out, attr, None)
            if _is_array(val):
                check_finite(val, f"{fn.__qualname__} result .{attr}")
        return out

    return wrapper
