"""Chunk probe of the 3D red-black smoother's z-chunked march of
``csrc/stencil3d.cu`` (``rbgs3d_zmarch_kernel<S>``).

The kernel cuts each x-y tile's march into z-chunks: ``zc = ceil(nz /
max(kZmTargetBlocks // tiles, 1))``, at least ``kZmMinChunk`` planes, and
its registers are capped at ``kZmRegisters`` (``__maxnreg__``).  For each
variant ``target:min[:registers]`` this builds the kernel library from a
copy of the source with those constants (32 registers let two blocks share
an SM; under ``multigrid_prj_tpu_torch/build/rb3_chunk/``), holds the
smoother at 1-4
and 9 sweeps to its twin at a padded non-cubic shape and at config 4's
z-marching levels, and times the 2-sweep call (V(2,2)'s) at 257^3, 129^3,
65^3 and 33^3 from CUDA-graph replays (``benchmarks/program.py``) and with
L2 flushed, and the 1- and 4-sweep calls at 257^3.  Target 1 gives every
tile one chunk of nz planes: the march before the z-split.  The card
only.

    python -m multigrid_prj_tpu_torch.benchmarks.rbgs3d_chunk_probe \\
        [target:min[:registers] ...]

Prints one line per variant and size: equal to the twin, the chunk, the
registers and spills by sweeps, and device microseconds per call.
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

# the rule's 132 (one wave of one block per SM) at 48 registers, one chunk
# of nz planes (the march before the z-split), other register caps (32: two
# blocks per SM), two waves, a chunk floor
VARIANTS = ("132:1", "1:1", "132:1:40", "132:1:56", "132:1:64", "132:1:32",
            "264:1:32", "264:1", "132:2")
CHECK_SHAPES = [((20, 24, 136), (17, 21, 129)), ((129, 129, 129), None),
                ((65, 65, 65), None), ((33, 33, 33), None)]
TIME_SHAPES = [(257, 257, 257), (129, 129, 129), (65, 65, 65), (33, 33, 33)]
LADDER = (1, 4)  # sweeps timed at 257^3 besides 2
_ANCHORS = ("constexpr int kZmTargetBlocks = 132;",
            "constexpr int kZmMinChunk = 1;",
            "constexpr int kZmRegisters = 48;")


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .cuda() for _ in range(2))
    return u, b, 1.0 / ((logical or shape)[0] - 1)


def _registers(log):
    """sweeps -> (registers, spill store bytes) of rbgs3d_zmarch_kernel<S>
    from nvcc's -Xptxas -v log."""
    out, cur = {}, None
    for ln in log.splitlines():
        hit = re.search(r"rbgs3d_zmarch_kernelILi(\d)EE", ln)
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


def _smooth(u, b, h, sweeps, logical=None):
    return lambda: c3.red_black_gauss_seidel_3d(u, b, 1.0, h, sweeps=sweeps,
                                                logical_shape=logical)


def _equal_to_twin():
    ok = True
    for i, (shape, logical) in enumerate(CHECK_SHAPES):
        u, b, h = _inputs(shape, logical, seed=i)
        for s in (1, 2, 3, 4, 9):
            ok &= torch.equal(_smooth(u, b, h, s, logical)(),
                              c3.red_black_gauss_seidel_3d_plain(
                                  u, b, 1.0, h, s, logical))
        del u, b
    return ok


def run(variants):
    source = _build.SOURCES[1].read_text()
    for anchor in _ANCHORS:
        if anchor not in source:
            raise RuntimeError(f"{_build.SOURCES[1]} no longer declares "
                               f"'{anchor}'")
    saved = (_build.SOURCES, _build.LIBRARY, c3._RB3_TARGET_BLOCKS,
             c3._RB3_MIN_CHUNK)
    out_dir = _build.BUILD_DIR / "rb3_chunk"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    try:
        for var in variants:
            target, least, *rest = (int(x) for x in var.split(":"))
            regs = rest[0] if rest else 48
            tag = f"{target}_{least}_{regs}"
            text = source.replace(
                _ANCHORS[0], f"constexpr int kZmTargetBlocks = {target};"
            ).replace(
                _ANCHORS[1], f"constexpr int kZmMinChunk = {least};"
            ).replace(_ANCHORS[2], f"constexpr int kZmRegisters = {regs};")
            src = out_dir / f"stencil3d_{tag}.cu"
            src.write_text(text)
            _build.SOURCES = (saved[0][0], src) + tuple(saved[0][2:])
            _build.LIBRARY = out_dir / f"libmg_stencil_{tag}.so"
            _build.library.cache_clear()
            used = _registers(_build.build(force=True)["log"])
            c3._RB3_TARGET_BLOCKS, c3._RB3_MIN_CHUNK = target, least
            c3._geometry3d.cache_clear()
            ok = _equal_to_twin()
            for shape in TIME_SHAPES:
                u, b, h = _inputs(shape, None, seed=9)
                reps = 5 if shape[0] > 200 else 20
                t = {"2 sweeps": device_us(_smooth(u, b, h, 2), reps=reps),
                     "2 sweeps L2 flushed": flushed_us(_smooth(u, b, h, 2))}
                if shape == TIME_SHAPES[0]:
                    for s in LADDER:
                        t[f"{s} sweeps"] = device_us(_smooth(u, b, h, s),
                                                     reps=reps)
                chunk = c3.rbgs3d_tile(4, shape)[6]
                rows.append((var, shape, ok, t))
                print(f"[rbgs3d chunk {target}:{least}, at most {regs} "
                      f"registers; registers, spill bytes by sweeps "
                      f"{used}] equal to the twin: {ok}; "
                      f"{'x'.join(map(str, shape))} chunk {chunk} (2 "
                      f"sweeps), device us per call "
                      f"{({k: round(v, 1) for k, v in t.items()})}",
                      flush=True)
                del u, b
                torch.cuda.empty_cache()
    finally:
        (_build.SOURCES, _build.LIBRARY, c3._RB3_TARGET_BLOCKS,
         c3._RB3_MIN_CHUNK) = saved
        _build.library.cache_clear()
        c3._geometry3d.cache_clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="target blocks : least planes per chunk [: "
                    "registers per thread at most, default 48]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rbgs3d_chunk_probe: needs a CUDA device", file=sys.stderr)
        return 1
    rows = run(args.variants)
    return 0 if all(ok for _, _, ok, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
