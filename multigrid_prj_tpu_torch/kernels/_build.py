"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles each source (``csrc/stencil2d.cu``, ``csrc/stencil3d.cu``,
``csrc/spmv.cu``, ``csrc/krylov.cu``, ``csrc/ablation.cu``) for ``sm_90a``
into an object file, all at once in parallel, and links them into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library goes to ``multigrid_prj_tpu_torch/build/`` (git-ignored) and
is rebuilt when any source is newer than it.  Nothing is built or loaded
at import time.  The load is a set-up record of its own (``utils/metrics``,
owner ``kernel_library``), and a load that ran nvcc counts in
``COUNTERS["kernel_builds"]``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from multigrid_prj_tpu_torch.utils.metrics import COUNTERS, PhaseTimer

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "stencil2d.cu", _PKG / "csrc" / "stencil3d.cu",
           _PKG / "csrc" / "spmv.cu", _PKG / "csrc" / "krylov.cu",
           _PKG / "csrc" / "ablation.cu")
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libmg_stencil.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false",  # no FMA contraction: the kernels are bit-equal to twins
    "-Xptxas", "-v",  # per-kernel registers / spills in the build log
    "-Xcompiler", "-fPIC",
]

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong  # a vector's length
_ip = ctypes.POINTER(ctypes.c_int)  # the tile geometry of the tiled
# kernels
_SIGNATURES = {
    "mg_rbgs_color": [_vp, _vp, _i, _i, _i, _i, _f, _i, _vp],
    "mg_rbgs_fused": [_vp, _vp, _vp, _i, _i, _i, _i, _f, _i, _ip, _vp],
    "mg_residual": [_vp, _vp, _vp, _i, _i, _i, _i, _f, _vp],
    "mg_ff_residual": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _vp],
    "mg_ff_update_residual": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                              _i, _i, _i, _i, _f, _vp],
    "mg_apply": [_vp, _vp, _i, _i, _i, _i, _f, _vp],
    "mg_jacobi": [_vp, _vp, _vp, _i, _i, _i, _i, _f, _i, _f, _f, _vp],
    "mg_jacobi_fused": [_vp, _vp, _vp, _i, _i, _i, _i, _f, _i, _i, _f, _f,
                        _ip, _vp],
    "mg_restrict_fw": [_vp, _vp, _i, _i, _i, _i, _vp],
    "mg_prolong_add": [_vp, _vp, _vp, _i, _i, _ip, _vp],
    "mg_prolong_add_point": [_vp, _vp, _vp, _i, _i, _vp],
    "mg_apply3d": [_vp, _vp, _i, _i, _i, _i, _i, _i, _f, _ip, _vp],
    "mg_apply3d_point": [_vp, _vp, _i, _i, _i, _i, _i, _i, _f, _vp],
    "mg_residual3d": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _ip, _vp],
    "mg_ff_residual3d": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                         _f, _ip, _vp],
    "mg_ff_update_residual3d": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                _i, _i, _i, _i, _i, _i, _f, _ip, _vp],
    "mg_restrict_fw3d": [_vp, _vp, _i, _i, _i, _ip, _vp],
    "mg_prolong_add3d": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _ip, _vp],
    "mg_rbgs3d_color": [_vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f, _i, _vp],
    "mg_rbgs3d_fused": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f, _i,
                        _ip, _vp],
    "mg_rbgs3d_resident": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f,
                           _i, _i, _vp],
    "mg_jacobi3d": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f, _i, _f, _f,
                    _i, _ip, _vp],
    "mg_jacobi3d_resident": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f,
                             _i, _f, _f, _i, _i, _vp],
    "mg_jacobi3d_sweep": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f, _i,
                          _f, _f, _vp],
    "mg_ell_spmv": [_vp, _vp, _vp, _vp, _i, _i, _vp],
    "mg_ell_spmv_axpy": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    "mg_ell_cheb_step": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _f, _f,
                         _i, _vp],
    "mg_ell_ff_residual": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i,
                           _vp],
    "mg_rbgs_color_sweep": [_vp, _vp, _vp, _i, _i, _i, _i, _f, _i, _vp],
    "mg_rbgs_resfilter": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _f, _i,
                          _ip, _vp],
    "mg_apply_chain": [_vp, _vp, _i, _i, _i, _i, _f, _i, _ip, _vp],
    "mg_ell_spmm": [_vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    "mg_rbgs_fused_ext": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _f, _i, _ip,
                          _vp],
    "mg_cg_xr_update": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _i, _i,
                        _vp],
    "mg_cg_p_update": [_vp, _vp, _vp, _vp, _ll, _i, _i, _vp],
    "mg_probe_copy": [_vp, _vp, _i, _i, _i, _vp],
    "mg_probe_neighbour": [_vp, _vp, _i, _i, _i, _i, _vp],
    "mg_probe_carry": [_vp, _vp, _i, _i, _i, _vp],
    "mg_probe_spmv": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of multigrid_prj_tpu_torch cannot be built")


def _run(cmd, proc):
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}{err}")
    return out + err


def build(force: bool = False) -> dict:
    """Compile the library if it is missing or older than a source.

    Returns ``{"path", "seconds", "built", "log"}``; ``log`` is nvcc's
    output (``-Xptxas -v`` register report) when a build ran.
    """
    newest = max(src.stat().st_mtime for src in SOURCES)
    if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return {"path": str(LIBRARY), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in SOURCES]
        # one nvcc per source, all started together
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        try:
            log = "".join(_run(cmd, proc)
                          for cmd, proc in zip(compiles, procs))
        finally:
            for proc in procs:  # after a failure, stop the other compiles
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp = Path(tmpdir) / LIBRARY.name
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        log += _run(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
        os.replace(tmp, LIBRARY)  # atomic: concurrent loaders see old or new
    return {"path": str(LIBRARY), "seconds": time.perf_counter() - t0,
            "built": True, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes:
    the set-up phase ``kernel_library``, with ``kernel_build`` (the
    staleness check, and nvcc where it ran) inside it."""
    record = PhaseTimer(owner="kernel_library")
    with record.phase("kernel_library"):
        with record.phase("kernel_build"):
            built = build()
        lib = ctypes.CDLL(str(LIBRARY))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    COUNTERS["kernel_builds"] += built["built"]
    return lib
