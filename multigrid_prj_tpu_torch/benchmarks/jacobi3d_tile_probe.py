"""Tile probe of the 3D Jacobi smoother's z-chunked march of
``csrc/stencil3d.cu`` (``jacobi3d_march_kernel<S>``).

The kernel is compiled with tiles of ``kJ3W`` = 64 columns by ``kJ3H`` = 24
rows (512 threads: a lane per column, each thread 3 rows), ``kJ3Ahead`` = 3
planes in flight and ``kJ3MinBlocks`` = 2 (the blocks per SM its registers
must allow, ``__launch_bounds__``).  For each variant
``cols:rows[:ahead[:blocks]]`` this builds the kernel library from a copy
of the source with those constants (under
``multigrid_prj_tpu_torch/build/j3_tile/``), holds the smoother at 1 .. 5
sweeps, omega 0.8, to its twin and to the per-sweep kernel at every level
of config 4 and at a shape whose extents are no multiple of the tile or
the chunk, and times the 2-sweep call (omega 0.8) at 257^3 and 513^3 from
CUDA-graph replays (``benchmarks/program.py``) and with L2 flushed, beside
two per-sweep launches, and the 1- and 4-sweep calls at 257^3.  The card
only.

    python -m multigrid_prj_tpu_torch.benchmarks.jacobi3d_tile_probe \\
        [cols:rows[:ahead[:blocks]] ...]

Prints one line per variant and size: equal to the twin and the per-sweep
kernel, and device microseconds per call.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from multigrid_prj_tpu_torch.benchmarks.rbgs_tile_rows import device_us
from multigrid_prj_tpu_torch.benchmarks.residual3d_march_probe import (
    flushed_us,
)
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3

# 512 threads a block: columns x (512 / columns) thread rows, rows a
# multiple of the thread rows; without the fourth field, 2 blocks per SM
VARIANTS = ("64:24", "64:24:3:1", "64:16", "64:32", "32:32", "128:16",
            "64:24:2", "64:24:4")
CHECK_SHAPES = [(257, 257, 257), (129, 129, 129), (65, 65, 65),
                (33, 33, 33), (71, 45, 77)]
TIME_SHAPES = [(257, 257, 257), (513, 513, 513)]
OMEGA = 0.8
_ANCHORS = ("constexpr int kJ3W = 64;", "constexpr int kJ3H = 24;",
            "constexpr int kJ3Ahead = 3;", "constexpr int kJ3MinBlocks = 2;")
LADDER = (1, 4)  # sweeps timed at 257^3 besides 2


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda() for _ in range(2))
    return u, b, 1.0 / (shape[0] - 1)


def _calls(u, b, h, sweeps):
    return (lambda: c3.jacobi_3d(u, b, 1.0, h, omega=OMEGA, sweeps=sweeps),
            lambda: c3._jacobi3d_per_sweep(u, b, 1.0, h, OMEGA, sweeps),
            lambda: c3.jacobi_3d_plain(u, b, 1.0, h, OMEGA, sweeps))


def _registers(log):
    """sweeps -> (registers, spill store bytes) of jacobi3d_march_kernel<S>
    from nvcc's -Xptxas -v log."""
    out, cur = {}, None
    for ln in log.splitlines():
        hit = re.search(r"jacobi3d_march_kernelILi(\d)EE", ln)
        if "Compiling entry function" in ln:
            cur = int(hit.group(1)) if hit else None
            continue
        spill = re.search(r"(\d+) bytes spill stores", ln)
        if spill and cur:
            out[cur] = [None, int(spill.group(1))]
        used = re.search(r"Used (\d+) registers", ln)
        if used and cur:
            out.setdefault(cur, [None, None])[0] = int(used.group(1))
    return {k: tuple(v) for k, v in sorted(out.items())}


def run(variants):
    source = _build.SOURCES[1].read_text()
    for anchor in _ANCHORS:
        if anchor not in source:
            raise RuntimeError(f"{_build.SOURCES[1]} no longer declares "
                               f"'{anchor}'")
    saved = _build.SOURCES, _build.LIBRARY, c3._J3_TILE, c3._J3_AHEAD
    out_dir = _build.BUILD_DIR / "j3_tile"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    try:
        for var in variants:
            tx, ty, *rest = (int(x) for x in var.split(":"))
            ahead = rest[0] if rest else saved[3]
            blocks = rest[1] if len(rest) > 1 else 2
            tag = f"{tx}_{ty}_{ahead}_{blocks}"
            src = out_dir / f"stencil3d_{tag}.cu"
            src.write_text(source.replace(
                _ANCHORS[0], f"constexpr int kJ3W = {tx};").replace(
                _ANCHORS[1], f"constexpr int kJ3H = {ty};").replace(
                _ANCHORS[2], f"constexpr int kJ3Ahead = {ahead};").replace(
                _ANCHORS[3], f"constexpr int kJ3MinBlocks = {blocks};"))
            _build.SOURCES = (saved[0][0], src) + tuple(saved[0][2:])
            _build.LIBRARY = out_dir / f"libmg_stencil_{tag}.so"
            _build.library.cache_clear()
            log = _build.build(force=True)["log"]
            regs = _registers(log)
            c3._J3_TILE, c3._J3_AHEAD = (tx, ty), ahead
            ok = True
            for i, shape in enumerate(CHECK_SHAPES):
                u, b, h = _inputs(shape, seed=i)
                for sweeps in range(1, 6):
                    march, per_sweep, twin = _calls(u, b, h, sweeps)
                    got = march()
                    ok &= (torch.equal(got, twin())
                           and torch.equal(got, per_sweep()))
            for shape in TIME_SHAPES:
                inputs = _inputs(shape, seed=9)
                march, per_sweep, _ = _calls(*inputs, 2)
                t = {"march": device_us(march, reps=10),
                     "march L2 flushed": flushed_us(march),
                     "per-sweep": device_us(per_sweep, reps=10),
                     "per-sweep L2 flushed": flushed_us(per_sweep)}
                if shape == TIME_SHAPES[0]:
                    for s in LADDER:
                        march, per_sweep, _ = _calls(*inputs, s)
                        t[f"march {s} sweeps"] = device_us(march, reps=10)
                        t[f"per-sweep {s} sweeps"] = device_us(per_sweep,
                                                               reps=10)
                rows.append((var, shape, ok, t))
                print(f"[jacobi3d march {tx} x {ty}, {ahead} ahead, "
                      f"{blocks} blocks per SM allowed; registers by sweeps "
                      f"{regs}] equal to the twin and the per-sweep kernel: "
                      f"{ok}; {'x'.join(map(str, shape))} 2 sweeps, device "
                      f"us per call "
                      f"{({k: round(v, 1) for k, v in t.items()})}",
                      flush=True)
                del inputs
                torch.cuda.empty_cache()
    finally:
        _build.SOURCES, _build.LIBRARY, c3._J3_TILE, c3._J3_AHEAD = saved
        _build.library.cache_clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="tile columns : tile rows [: planes in flight "
                    "[: blocks per SM]]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("jacobi3d_tile_probe: needs a CUDA device", file=sys.stderr)
        return 1
    rows = run(args.variants)
    return 0 if all(ok for _, _, ok, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
