"""Tile-height probe of the colour-split red-black tiles of
``csrc/stencil2d.cu`` (``rbgs_fused_kernel``, ``rbgs_resfilter_kernel``).

The kernels are compiled for tiles of 64 rows (``RbTile::EH``).  For each
variant ``lo:hi`` this builds the kernel library from a copy of the source
whose tiles have ``lo`` rows up to 4 passes and ``hi`` above (under
``multigrid_prj_tpu_torch/build/tile_rows/``), holds the smoother at 1-4
and 9 sweeps and the down-leg at 0-3 to their twins at the 1025^2 path's
finest level, an odd unpadded shape and 8448^2, and times both at 8448^2
(logical 8193^2) from CUDA-graph replays (``benchmarks/program.py``).  The
card only.

    python -m multigrid_prj_tpu_torch.benchmarks.rbgs_tile_rows [lo:hi ...]

Prints one line per variant: equal to the twins, and device microseconds
per call by sweep count.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from multigrid_prj_tpu_torch.benchmarks.program import Program
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

VARIANTS = ("64:64", "48:48", "96:96", "64:96", "32:48")
SHAPES = [((8448, 8448), (8193, 8193)), ((1280, 1280), (1025, 1025)),
          ((385, 385), None)]
ALPHA = 10.0
_ANCHOR = "static constexpr int EH = 64;"


def device_us(fn, reps=5, runs=7):
    """Median device time (us) per call of ``fn``: ``reps`` calls as one
    CUDA graph, its replays timed with CUDA events."""
    prog = Program(fn, reps=reps, cuda=True)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prog.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) * 1e3 / reps


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda() for _ in range(2))
    return u, b, 10.0 / ((logical or shape)[0] - 1)


def _equal_to_twins(inputs):
    ok = True
    for (_shape, logical), (u, b, h) in inputs:
        for s in (1, 2, 3, 4, 9):
            ok &= torch.equal(
                cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=s,
                                          logical_shape=logical),
                cs.red_black_gauss_seidel_plain(u, b, ALPHA, h, s, logical))
        if logical is None:
            continue
        for s in range(4):
            got = cs.rbgs_residual_restrict(u, b, ALPHA, h, s, logical)
            want = cs.rbgs_residual_restrict_plain(u, b, ALPHA, h, s, logical)
            ok &= all(torch.equal(g, w) for g, w in zip(got, want))
    return ok


def run(variants):
    source = _build.SOURCES[0].read_text()
    if _ANCHOR not in source:
        raise RuntimeError(f"{_build.SOURCES[0]} no longer declares "
                           f"'{_ANCHOR}'")
    saved = _build.SOURCES, _build.LIBRARY, cs.rbgs_tile
    out_dir = _build.BUILD_DIR / "tile_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    inputs = [(sl, _inputs(*sl, seed=i)) for i, sl in enumerate(SHAPES)]
    (shape, logical), (u, b, h) = inputs[0]
    rows = []
    try:
        for var in variants:
            lo, hi = (int(x) for x in var.split(":"))
            src = out_dir / f"stencil2d_{lo}_{hi}.cu"
            src.write_text(source.replace(
                _ANCHOR, f"static constexpr int EH = P <= 4 ? {lo} : {hi};"))
            _build.SOURCES = (src,) + tuple(saved[0][1:])
            _build.LIBRARY = out_dir / f"libmg_stencil_{lo}_{hi}.so"
            _build.library.cache_clear()
            _build.build(force=True)

            def tile(passes, lo=lo, hi=hi):
                hr, hc, _, cols = saved[2](passes)
                return hr, hc, lo if passes <= 4 else hi, cols

            cs.rbgs_tile = tile
            ok = _equal_to_twins(inputs)
            smoother = {s: device_us(
                lambda s=s: cs.red_black_gauss_seidel(
                    u, b, ALPHA, h, sweeps=s, logical_shape=logical))
                for s in (1, 2, 3, 4)}
            downleg = {s: device_us(
                lambda s=s: cs.rbgs_residual_restrict(u, b, ALPHA, h, s,
                                                      logical))
                for s in range(4)}
            rows.append((var, ok, smoother, downleg))
            print(f"[tile rows {lo}:{hi}] equal to the twins: {ok}; "
                  f"{shape[0]}x{shape[1]} device us per call, smoother by "
                  f"sweeps {({k: round(v, 1) for k, v in smoother.items()})},"
                  f" down-leg {({k: round(v, 1) for k, v in downleg.items()})}",
                  flush=True)
    finally:
        _build.SOURCES, _build.LIBRARY, cs.rbgs_tile = saved
        _build.library.cache_clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="tile rows up to 4 passes : rows above")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rbgs_tile_rows: needs a CUDA device", file=sys.stderr)
        return 1
    rows = run(args.variants)
    return 0 if all(ok for _, ok, _, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
