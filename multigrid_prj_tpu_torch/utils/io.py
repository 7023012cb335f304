"""Text vector/matrix I/O in the reference's formats (``multigrid_prj_tpu/
utils/io.py``, copied; numpy only):

* vector file: first line ``n``, then one value per line -- the format of
  ``x.mtx`` and the ``MGGS4.txt`` residual history;
* matrix file: header ``rows cols nnz``, then ``i j v`` triplet lines;
* MatrixMarket (BASELINE config 3's "imported MatrixMarket system").
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


def save_matrix_coo(path: str | os.PathLike, rows, cols, vals, shape, fmt="%.17g"):
    """Triplet text writer: ``rows cols nnz`` header then ``i j v`` lines
    (``utilities.hpp:27-41``)."""
    rows = np.asarray(rows).reshape(-1)
    cols = np.asarray(cols).reshape(-1)
    vals = np.asarray(vals).reshape(-1)
    with open(path, "w") as fh:
        fh.write(f"{shape[0]} {shape[1]} {vals.size}\n")
        for i, j, v in zip(rows, cols, vals):
            fh.write(f"{i} {j} " + (fmt % v) + "\n")


def load_matrix_coo(path: str | os.PathLike):
    """Read a triplet text file; returns ``(rows, cols, vals, shape)``.

    Auto-detects a ``%%MatrixMarket`` banner and delegates to
    :func:`load_matrix_market` (0-based triplets either way).
    """
    with open(path) as fh:
        first = fh.readline()
        if first.lstrip().startswith("%%MatrixMarket"):
            pass  # fall through to the MM parser below
        else:
            r, c, nnz = (int(t) for t in first.split())
            data = np.loadtxt(fh, dtype=np.float64, ndmin=2)
            if data.shape[0] != nnz:
                raise ValueError(
                    f"{path}: header says {nnz} entries, found {data.shape[0]}")
            return (
                data[:, 0].astype(np.int64),
                data[:, 1].astype(np.int64),
                data[:, 2],
                (r, c),
            )
    return load_matrix_market(path)


# ---------------------------------------------------------------------------
# MatrixMarket (the format of BASELINE config 3's "imported MatrixMarket
# system"; the reference's own ``x.mtx`` artifacts are plain vector files
# despite the extension — both are accepted by the AMG CLI's -matrix path)
# ---------------------------------------------------------------------------


def save_matrix_market(path: str | os.PathLike, rows, cols, vals, shape,
                       symmetric: bool = False, fmt: str = "%.17g") -> None:
    """Write ``coordinate real general|symmetric`` MatrixMarket (1-based).

    With ``symmetric=True`` only the lower triangle is stored (entries must
    already be lower-triangular or will be mirrored down).
    """
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    vals = np.asarray(vals, dtype=np.float64).reshape(-1)
    if symmetric and rows.size:
        # coalesce duplicate triplets (COO accumulation semantics) ...
        key = rows * int(shape[1]) + cols
        order = np.argsort(key, kind="stable")
        key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        vals = np.add.reduceat(vals, starts)
        rows, cols = rows[starts], cols[starts]
        # ... then keep ONE entry per unordered pair, stored lower-triangular
        # (when both (i,j) and (j,i) are present they must be equal — the
        # operator is symmetric — so dropping the upper copy loses nothing)
        lo_r, lo_c = np.maximum(rows, cols), np.minimum(rows, cols)
        _, first = np.unique(lo_r * int(shape[1]) + lo_c, return_index=True)
        rows, cols, vals = lo_r[first], lo_c[first], vals[first]
    kind = "symmetric" if symmetric else "general"
    with open(path, "w") as fh:
        fh.write(f"%%MatrixMarket matrix coordinate real {kind}\n")
        fh.write(f"{shape[0]} {shape[1]} {vals.size}\n")
        for i, j, v in zip(rows, cols, vals):
            fh.write(f"{i + 1} {j + 1} " + (fmt % v) + "\n")


def load_matrix_market(path: str | os.PathLike):
    """Read a MatrixMarket file; returns 0-based ``(rows, cols, vals, shape)``.

    Supports the subset a solver needs: object ``matrix``, formats
    ``coordinate`` (sparse) and ``array`` (dense, column-major), fields
    ``real``/``integer``/``pattern`` (pattern entries get value 1.0),
    symmetries ``general``/``symmetric``/``skew-symmetric`` (the stored
    triangle is expanded to the full matrix; coordinate format only —
    array-format symmetric files use a packed-triangle layout this loader
    rejects explicitly).
    """
    with open(path) as fh:
        banner = fh.readline().split()
        if len(banner) < 4 or banner[0] != "%%MatrixMarket":
            raise ValueError(f"{path}: not a MatrixMarket file")
        obj, fmt_kind = banner[1].lower(), banner[2].lower()
        field = banner[3].lower() if len(banner) > 3 else "real"
        symmetry = banner[4].lower() if len(banner) > 4 else "general"
        if obj != "matrix":
            raise ValueError(f"{path}: unsupported object {obj!r}")
        if field == "complex":
            raise ValueError(f"{path}: complex matrices are not supported")
        line = fh.readline()
        while line.lstrip().startswith("%") or not line.strip():
            if line == "":  # EOF — readline() returns '' forever from here
                raise ValueError(f"{path}: missing size line")
            line = fh.readline()
        sizes = [int(t) for t in line.split()]
        if fmt_kind == "array":
            if symmetry != "general":
                # MM array symmetric/skew files store only the n(n+1)/2
                # lower-triangle values (packed); this loader does not
                # unpack that layout — fail loudly instead of misreading.
                raise ValueError(
                    f"{path}: array-format {symmetry!r} matrices (packed "
                    "lower triangle) are not supported; convert to "
                    "coordinate format"
                )
            r, c = sizes
            vals = np.loadtxt(fh, dtype=np.float64).reshape(-1)
            if vals.size != r * c:
                raise ValueError(f"{path}: expected {r * c} array values, "
                                 f"found {vals.size}")
            # array format is column-major dense; emit all entries as triplets
            cols_full, rows_full = np.meshgrid(np.arange(c), np.arange(r))
            return (rows_full.reshape(-1, order="F").astype(np.int64),
                    cols_full.reshape(-1, order="F").astype(np.int64),
                    vals, (r, c))
        if fmt_kind != "coordinate":
            raise ValueError(f"{path}: unsupported format {fmt_kind!r}")
        r, c, nnz = sizes
        if nnz == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0), (r, c))
        ncols_data = 2 if field == "pattern" else 3
        data = np.loadtxt(fh, dtype=np.float64, ndmin=2)
        if data.shape[0] != nnz:
            raise ValueError(f"{path}: header says {nnz} entries, found "
                             f"{data.shape[0]}")
        rows = data[:, 0].astype(np.int64) - 1
        cols = data[:, 1].astype(np.int64) - 1
        vals = (np.ones(nnz) if data.shape[1] < 3 or ncols_data == 2
                else data[:, 2])
    if symmetry in ("symmetric", "skew-symmetric") and rows.size:
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, sign * vals[off]])
    return rows, cols, vals, (r, c)
