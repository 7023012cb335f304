"""Text vector I/O in the reference's format (the numpy parts of
``multigrid_prj_tpu/utils/io.py``, copied): first line ``n``, then one value
per line -- the format of ``x.mtx`` and the ``MGGS4.txt`` residual history.
"""

from __future__ import annotations

import os

import numpy as np


def save_vector(path: str | os.PathLike, vec, fmt: str = "%.17g") -> None:
    """Write ``n`` then one value per line."""
    v = np.asarray(vec).reshape(-1)
    with open(path, "w") as fh:
        fh.write(f"{v.size}\n")
        for x in v:
            fh.write((fmt % x) + "\n")


def save_history(path: str | os.PathLike, history) -> None:
    """Residual-history writer -- the reference's ``MGGS4.txt`` artifact."""
    save_vector(path, history)


def load_vector(path: str | os.PathLike) -> np.ndarray:
    """Read a vector file written by :func:`save_vector` (or the reference)."""
    with open(path) as fh:
        n = int(fh.readline().split()[0])
        vals = np.loadtxt(fh, dtype=np.float64, ndmin=1)
    if vals.size != n:
        raise ValueError(f"{path}: header says {n} values, found {vals.size}")
    return vals
