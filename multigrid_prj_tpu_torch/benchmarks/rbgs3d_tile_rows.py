"""Tile-height probe of the z-marching 3D red-black tile of
``csrc/stencil3d.cu`` (``rbgs3d_zmarch_kernel``).

The kernel is compiled for tiles of ``Zm<P>::TY`` rows.  For each variant
``lo:hi`` this builds the kernel library from a copy of the source whose
tiles have ``lo`` rows up to 4 passes and ``hi`` above (under
``multigrid_prj_tpu_torch/build/tile_rows3d/``), holds the smoother at 1-4
and 9 sweeps to its twin at a padded non-cubic shape, config 4's 65^3 level
and 257^3, and times it at 257^3 and 513^3 (config 4's finest level and
the 513^3 path's) from CUDA-graph replays (``benchmarks/program.py``).  The
card only.

    python -m multigrid_prj_tpu_torch.benchmarks.rbgs3d_tile_rows [lo:hi ...]

Prints one line per variant: equal to the twin, and device microseconds per
call by sweep count at each size.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from multigrid_prj_tpu_torch.benchmarks.rbgs_tile_rows import device_us
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3

VARIANTS = ("32:32", "16:32", "24:32")
CHECK_SHAPES = [((20, 24, 136), (17, 21, 129)), ((65, 65, 65), None),
                ((257, 257, 257), None)]
TIME_SHAPES = [(257, 257, 257), (513, 513, 513)]
SWEEPS = (1, 2, 4)
ALPHA = 1.0
_ANCHOR = "static constexpr int TY = P <= 4 ? 32 : 32;"


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda() for _ in range(2))
    return u, b, 1.0 / ((logical or shape)[0] - 1)


def _equal_to_twin():
    ok = True
    for i, (shape, logical) in enumerate(CHECK_SHAPES):
        u, b, h = _inputs(shape, logical, seed=i)
        for s in (1, 2, 3, 4, 9):
            ok &= torch.equal(
                c3.red_black_gauss_seidel_3d(u, b, ALPHA, h, sweeps=s,
                                             logical_shape=logical),
                c3.red_black_gauss_seidel_3d_plain(u, b, ALPHA, h, s,
                                                   logical))
        del u, b
    return ok


def run(variants):
    source = _build.SOURCES[1].read_text()
    if _ANCHOR not in source:
        raise RuntimeError(f"{_build.SOURCES[1]} no longer declares "
                           f"'{_ANCHOR}'")
    saved = _build.SOURCES, _build.LIBRARY, c3._RB3_TILE_ROWS
    out_dir = _build.BUILD_DIR / "tile_rows3d"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    try:
        for var in variants:
            lo, hi = (int(x) for x in var.split(":"))
            src = out_dir / f"stencil3d_{lo}_{hi}.cu"
            src.write_text(source.replace(
                _ANCHOR, f"static constexpr int TY = P <= 4 ? {lo} : {hi};"))
            sources = list(saved[0])
            sources[1] = src
            _build.SOURCES = tuple(sources)
            _build.LIBRARY = out_dir / f"libmg_stencil_{lo}_{hi}.so"
            _build.library.cache_clear()
            _build.build(force=True)
            c3._RB3_TILE_ROWS = (lo, hi)
            c3._geometry3d.cache_clear()
            ok = _equal_to_twin()
            times = {}
            for shape in TIME_SHAPES:
                u, b, h = _inputs(shape, None, seed=7)
                times[shape[0]] = {s: device_us(
                    lambda s=s: c3.red_black_gauss_seidel_3d(
                        u, b, ALPHA, h, sweeps=s)) for s in SWEEPS}
                del u, b
                torch.cuda.empty_cache()
            rows.append((var, ok, times))
            print(f"[tile rows 3d {lo}:{hi}] equal to the twin: {ok}; device "
                  "us per call by sweeps: " + "; ".join(
                      f"{n}^3 {({k: round(v, 1) for k, v in t.items()})}"
                      for n, t in times.items()), flush=True)
    finally:
        _build.SOURCES, _build.LIBRARY, c3._RB3_TILE_ROWS = saved
        _build.library.cache_clear()
        c3._geometry3d.cache_clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="tile rows up to 4 passes : rows above")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rbgs3d_tile_rows: needs a CUDA device", file=sys.stderr)
        return 1
    rows = run(args.variants)
    return 0 if all(ok for _, ok, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
