"""Depth and tile-height probe of the 3D residual's z-chunked march of
``csrc/stencil3d.cu`` (``stencil3d_march_kernel<true>``).

The kernel is compiled with ``kR3Ahead`` = 4 planes in flight and tiles of
``kR3Y`` = 8 rows by ``kR3X`` = 64 columns.  For each variant
``ahead:rows[:cols]`` this builds the kernel library from a copy of the
source with those constants (under
``multigrid_prj_tpu_torch/build/r3_march/``), holds the residual to its twin
and to ``b`` less the one-thread-per-point apply (the march's point oracle)
at every level of config 4 and at a shape whose nz is no multiple of its
chunk, and times it at 257^3 and 513^3 from CUDA-graph replays
(``benchmarks/program.py``) and with L2 flushed.  The card only.

    python -m multigrid_prj_tpu_torch.benchmarks.residual3d_march_probe \\
        [ahead:rows[:cols] ...]

Prints one line per variant and size: equal to the twin and the point
oracle, and device microseconds per call.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from multigrid_prj_tpu_torch.benchmarks.rbgs_tile_rows import device_us
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3

VARIANTS = ("4:8", "2:8", "8:8", "4:4", "4:8:32", "4:4:128")
CHECK_SHAPES = [(257, 257, 257), (129, 129, 129), (65, 65, 65),
                (33, 33, 33), (17, 17, 17), (71, 45, 77)]
TIME_SHAPES = [(257, 257, 257), (513, 513, 513)]
_ANCHORS = ("constexpr int kR3Ahead = 4;", "constexpr int kR3Y = 8;",
            "constexpr int kR3X = 64;")
FLUSH_BYTES = 200 * 2 ** 20


def flushed_us(fn, runs=10):
    """Median device time (us) of one call of ``fn`` after a read of
    ``FLUSH_BYTES`` (4x the H100's L2), CUDA events."""
    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")
    fn()
    times = []
    for _ in range(runs):
        torch.sum(buf, dim=0, out=sink)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) * 1e3


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda() for _ in range(2))
    return u, b, 1.0 / (shape[0] - 1)


def _calls(u, b, h):
    return (lambda: c3.poisson_residual_3d(u, b, 1.0, h),
            lambda: b - c3._apply3d_launch(u, 1.0, h, None, "apply3d_point"),
            lambda: c3.poisson_residual_3d_plain(u, b, 1.0, h))


def run(variants):
    source = _build.SOURCES[1].read_text()
    for anchor in _ANCHORS:
        if anchor not in source:
            raise RuntimeError(f"{_build.SOURCES[1]} no longer declares "
                               f"'{anchor}'")
    saved = _build.SOURCES, _build.LIBRARY, c3._R3_AHEAD, c3._R3_TILE
    out_dir = _build.BUILD_DIR / "r3_march"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    try:
        for var in variants:
            ahead, ty, *cols = (int(x) for x in var.split(":"))
            tx = cols[0] if cols else saved[3][0]
            src = out_dir / f"stencil3d_{ahead}_{ty}_{tx}.cu"
            src.write_text(source.replace(
                _ANCHORS[0], f"constexpr int kR3Ahead = {ahead};").replace(
                _ANCHORS[1], f"constexpr int kR3Y = {ty};").replace(
                _ANCHORS[2], f"constexpr int kR3X = {tx};"))
            _build.SOURCES = (saved[0][0], src) + tuple(saved[0][2:])
            _build.LIBRARY = out_dir / f"libmg_stencil_{ahead}_{ty}_{tx}.so"
            _build.library.cache_clear()
            _build.build(force=True)
            c3._R3_AHEAD, c3._R3_TILE = ahead, (tx, ty)
            ok = True
            for i, shape in enumerate(CHECK_SHAPES):
                march, point, twin = _calls(*_inputs(shape, seed=i))
                got = march()
                ok &= torch.equal(got, twin()) and torch.equal(got, point())
            for shape in TIME_SHAPES:
                march = _calls(*_inputs(shape, seed=9))[0]
                t = {"march": device_us(march, reps=10),
                     "march L2 flushed": flushed_us(march)}
                rows.append((var, shape, ok, t))
                print(f"[residual3d march {ahead} ahead, {ty} x {tx}] "
                      f"equal to the twin and the point oracle: {ok}; "
                      f"{'x'.join(map(str, shape))} device us per call "
                      f"{({k: round(v, 1) for k, v in t.items()})}",
                      flush=True)
                torch.cuda.empty_cache()
    finally:
        _build.SOURCES, _build.LIBRARY, c3._R3_AHEAD, c3._R3_TILE = saved
        _build.library.cache_clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="planes in flight : tile rows [: tile columns]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("residual3d_march_probe: needs a CUDA device", file=sys.stderr)
        return 1
    rows = run(args.variants)
    return 0 if all(ok for _, _, ok, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
