"""ctypes bindings for the native runtime library (``native/mgtpu.cpp``).

The port's copy of ``multigrid_prj_tpu/native.py``'s bindings, over the
same source and the same built library (``native/build/libmgtpu.so``), so
the AMG setup of both packages takes the same path.  The library
accelerates the host-side runtime the reference wrote in C++ -- the gmsh
data loader, COO->CSR compression, and the sequential setup-phase graph
algorithms (greedy coloring, RCM, the reference's greedy coarsening).
Every entry point has a pure-Python fallback; ``available()`` reports which
path is active.  Which path runs matters for parity: the native
``csr_transpose`` keeps explicit zeros that the fallback drops.

The library is built on demand with ``make -C native`` (g++, no external
deps) at the first call that needs it, never at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_HERE, "native", "build", "libmgtpu.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False

_LL = ctypes.c_longlong
_PLL = ctypes.POINTER(_LL)
_PD = ctypes.POINTER(ctypes.c_double)
_PU8 = ctypes.POINTER(ctypes.c_ubyte)


def _build() -> bool:
    makefile_dir = os.path.join(_HERE, "native")
    if not os.path.exists(os.path.join(makefile_dir, "Makefile")):
        return False
    try:
        subprocess.run(
            ["make", "-C", makefile_dir, "-s"],
            check=True, capture_output=True, timeout=300,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src = os.path.join(_HERE, "native", "mgtpu.cpp")
    stale = (os.path.exists(_SO) and os.path.exists(src)
             and os.path.getmtime(src) > os.path.getmtime(_SO))
    if (not os.path.exists(_SO) or stale) and not _build():
        if not os.path.exists(_SO):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.mgtpu_free.argtypes = [ctypes.c_void_p]
    lib.mgtpu_coo_to_csr.restype = _LL
    lib.mgtpu_coo_to_csr.argtypes = [
        _LL, _LL, _PLL, _PLL, _PD,
        ctypes.POINTER(_PLL), ctypes.POINTER(_PLL), ctypes.POINTER(_PD),
    ]
    lib.mgtpu_greedy_coloring.restype = ctypes.c_int
    lib.mgtpu_greedy_coloring.argtypes = [
        _LL, _PLL, _PLL, ctypes.POINTER(ctypes.c_int)
    ]
    lib.mgtpu_rcm.restype = ctypes.c_int
    lib.mgtpu_rcm.argtypes = [_LL, _PLL, _PLL, _PLL]
    lib.mgtpu_greedy_coarsen.restype = ctypes.c_int
    lib.mgtpu_greedy_coarsen.argtypes = [
        _LL, _PLL, _PLL, _LL, ctypes.POINTER(ctypes.c_byte)
    ]
    lib.mgtpu_spgemm.restype = _LL
    lib.mgtpu_spgemm.argtypes = [
        _LL, _LL, _PLL, _PLL, _PD, _PLL, _PLL, _PD,
        ctypes.POINTER(_PLL), ctypes.POINTER(_PLL), ctypes.POINTER(_PD),
    ]
    lib.mgtpu_csr_transpose.restype = ctypes.c_int
    lib.mgtpu_csr_transpose.argtypes = [
        _LL, _LL, _PLL, _PLL, _PD, _PLL, _PLL, _PD,
    ]
    lib.mgtpu_parse_msh.restype = ctypes.c_int
    lib.mgtpu_parse_msh.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(_PD), ctypes.POINTER(_LL),
        ctypes.POINTER(_PLL), ctypes.POINTER(_LL),
        ctypes.POINTER(_PU8), ctypes.c_char_p, _LL,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_ll(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _copy_free(lib, ptr, count, np_dtype, ctype):
    arr = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,)
    ).astype(np_dtype, copy=True)
    lib.mgtpu_free(ptr)
    return arr


def coo_to_csr(rows, cols, vals, n_rows: int):
    """Native COO->CSR; returns (indptr, indices, data) or None if no lib."""
    lib = _load()
    if lib is None:
        return None
    rows, cols = _as_ll(rows), _as_ll(cols)
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.float64))
    o_indptr, o_indices, o_data = _PLL(), _PLL(), _PD()
    nnz = lib.mgtpu_coo_to_csr(
        _LL(n_rows), _LL(rows.size),
        rows.ctypes.data_as(_PLL), cols.ctypes.data_as(_PLL),
        vals.ctypes.data_as(_PD),
        ctypes.byref(o_indptr), ctypes.byref(o_indices), ctypes.byref(o_data),
    )
    if nnz < 0:
        raise ValueError("mgtpu_coo_to_csr failed (row index out of range?)")
    indptr = _copy_free(lib, o_indptr, n_rows + 1, np.int64, _LL)
    indices = _copy_free(lib, o_indices, nnz, np.int64, _LL)
    data = _copy_free(lib, o_data, nnz, np.float64, ctypes.c_double)
    return indptr, indices, data


def spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
           n: int, m_out: int):
    """Native Gustavson SpGEMM ``C = A @ B``; returns (indptr, indices,
    data) or None if no lib.  Same contribution order as the NumPy
    expansion path: identical structure, values to the last ulp — see
    native/mgtpu.cpp."""
    lib = _load()
    if lib is None:
        return None
    a_indptr, a_indices = _as_ll(a_indptr), _as_ll(a_indices)
    b_indptr, b_indices = _as_ll(b_indptr), _as_ll(b_indices)
    a_data = np.ascontiguousarray(np.asarray(a_data, dtype=np.float64))
    b_data = np.ascontiguousarray(np.asarray(b_data, dtype=np.float64))
    o_indptr, o_indices, o_data = _PLL(), _PLL(), _PD()
    nnz = lib.mgtpu_spgemm(
        _LL(n), _LL(m_out),
        a_indptr.ctypes.data_as(_PLL), a_indices.ctypes.data_as(_PLL),
        a_data.ctypes.data_as(_PD),
        b_indptr.ctypes.data_as(_PLL), b_indices.ctypes.data_as(_PLL),
        b_data.ctypes.data_as(_PD),
        ctypes.byref(o_indptr), ctypes.byref(o_indices), ctypes.byref(o_data),
    )
    if nnz < 0:
        raise ValueError("mgtpu_spgemm failed (column index out of range?)")
    indptr = _copy_free(lib, o_indptr, n + 1, np.int64, _LL)
    indices = _copy_free(lib, o_indices, nnz, np.int64, _LL)
    data = _copy_free(lib, o_data, nnz, np.float64, ctypes.c_double)
    return indptr, indices, data


def csr_transpose(indptr, indices, data, n: int, m: int):
    """Native counting-sort CSR transpose; returns (indptr, indices, data)
    or None if no lib."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _as_ll(indptr), _as_ll(indices)
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
    nnz = int(indptr[-1])
    o_indptr = np.zeros(m + 1, dtype=np.int64)
    o_indices = np.zeros(nnz, dtype=np.int64)
    o_data = np.zeros(nnz, dtype=np.float64)
    rc = lib.mgtpu_csr_transpose(
        _LL(n), _LL(m),
        indptr.ctypes.data_as(_PLL), indices.ctypes.data_as(_PLL),
        data.ctypes.data_as(_PD),
        o_indptr.ctypes.data_as(_PLL), o_indices.ctypes.data_as(_PLL),
        o_data.ctypes.data_as(_PD),
    )
    if rc != 0:
        raise ValueError("mgtpu_csr_transpose failed")
    return o_indptr, o_indices, o_data


def greedy_coloring(indptr, indices, n: int):
    """Native greedy coloring; returns (colors, n_colors) or None."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _as_ll(indptr), _as_ll(indices)
    colors = np.zeros(n, dtype=np.int32)
    nc = lib.mgtpu_greedy_coloring(
        _LL(n), indptr.ctypes.data_as(_PLL), indices.ctypes.data_as(_PLL),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if nc < 0:
        raise ValueError("mgtpu_greedy_coloring failed")
    return colors.astype(np.int64), int(nc)


def rcm(indptr, indices, n: int):
    """Native reverse Cuthill-McKee permutation, or None."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _as_ll(indptr), _as_ll(indices)
    perm = np.zeros(n, dtype=np.int64)
    rc = lib.mgtpu_rcm(_LL(n), indptr.ctypes.data_as(_PLL),
                       indices.ctypes.data_as(_PLL),
                       perm.ctypes.data_as(_PLL))
    if rc != 0:
        raise ValueError("mgtpu_rcm failed")
    return perm


def greedy_coarsen(s_ptr, s_cols, n: int, seed_index: int):
    """Native reference-compat greedy coarsening, or None."""
    lib = _load()
    if lib is None:
        return None
    s_ptr, s_cols = _as_ll(s_ptr), _as_ll(s_cols)
    labels = np.zeros(n, dtype=np.int8)
    rc = lib.mgtpu_greedy_coarsen(
        _LL(n), s_ptr.ctypes.data_as(_PLL), s_cols.ctypes.data_as(_PLL),
        _LL(seed_index), labels.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
    )
    if rc != 0:
        raise ValueError("mgtpu_greedy_coarsen failed")
    return labels


def parse_msh(path: str):
    """Native gmsh parser; returns (nodes, tris, on_boundary) or None."""
    lib = _load()
    if lib is None:
        return None
    o_nodes, o_tris, o_bnd = _PD(), _PLL(), _PU8()
    n, m = _LL(0), _LL(0)
    err = ctypes.create_string_buffer(256)
    rc = lib.mgtpu_parse_msh(
        path.encode(), ctypes.byref(o_nodes), ctypes.byref(n),
        ctypes.byref(o_tris), ctypes.byref(m), ctypes.byref(o_bnd),
        err, _LL(len(err)),
    )
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    nn, mm = n.value, m.value
    nodes = _copy_free(lib, o_nodes, 2 * nn, np.float64, ctypes.c_double)
    tris = _copy_free(lib, o_tris, 3 * mm, np.int64, _LL)
    bnd = _copy_free(lib, o_bnd, nn, np.uint8, ctypes.c_ubyte)
    return nodes.reshape(nn, 2), tris.reshape(mm, 3), bnd.astype(bool)
