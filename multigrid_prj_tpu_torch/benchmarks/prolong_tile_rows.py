"""Strip-height probe of the prolong-add stream of ``csrc/stencil2d.cu``
(``prolong_add_stream_kernel``).

The kernel is compiled for strips of ``kPaStrip`` = 2 coarse rows a warp
walks.  For each variant (a strip height) this builds the kernel library
from a copy of the source with that height (under
``multigrid_prj_tpu_torch/build/prolong_rows/``), holds the stream to its
twin and to the one-thread-per-point kernel at every level of the 8193^2 /
pad 256 hierarchy and at a coarse shape whose column count is no multiple
of 4, and times one call at 8448^2 and 8192^2 (fine) from CUDA-graph
replays (``benchmarks/program.py``), the point kernel beside it.  The card
only.

    python -m multigrid_prj_tpu_torch.benchmarks.prolong_tile_rows [rows ...]

Prints one line per variant: equal to the twin and the point kernel, and
device microseconds per call by fine shape.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from multigrid_prj_tpu_torch.benchmarks.rbgs_tile_rows import device_us
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

VARIANTS = ("2", "4", "8", "16")
# coarse shapes: the 8193^2 / pad 256 levels (fine 8448 .. 66) and one of
# pc_c % 4 != 0 with an odd row count
CHECK_SHAPES = [(4224, 4224), (2112, 2112), (1056, 1056), (528, 528),
                (264, 264), (132, 132), (66, 66), (33, 33), (65, 190)]
TIME_SHAPES = [(4224, 4224), (4096, 4096)]
_ANCHOR = "constexpr int kPaStrip = 2;"


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal((2 * shape[0], 2 * shape[1])).astype(np.float32)
    return torch.from_numpy(e).cuda(), torch.from_numpy(u).cuda()


def _equal(inputs):
    ok = True
    for e, u in inputs:
        got = cs.prolong_add_padded_fast(e, u)
        ok &= torch.equal(got, cs.prolong_add_padded_fast_plain(e, u))
        ok &= torch.equal(got, cs._prolong_add_point(e, u))
    return bool(ok)


def run(variants):
    source = _build.SOURCES[0].read_text()
    if _ANCHOR not in source:
        raise RuntimeError(f"{_build.SOURCES[0]} no longer declares "
                           f"'{_ANCHOR}'")
    saved = _build.SOURCES, _build.LIBRARY, cs.prolong_tile
    out_dir = _build.BUILD_DIR / "prolong_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    checks = [_inputs(s, seed=i) for i, s in enumerate(CHECK_SHAPES)]
    timed = [_inputs(s, seed=50 + i) for i, s in enumerate(TIME_SHAPES)]
    rows = []
    try:
        for var in variants:
            strip = int(var)
            src = out_dir / f"stencil2d_{strip}.cu"
            src.write_text(source.replace(
                _ANCHOR, f"constexpr int kPaStrip = {strip};"))
            _build.SOURCES = (src,) + tuple(saved[0][1:])
            _build.LIBRARY = out_dir / f"libmg_stencil_{strip}.so"
            _build.library.cache_clear()
            _build.build(force=True)
            cs.prolong_tile = lambda strip=strip: (strip, saved[2]()[1])
            ok = _equal(checks)
            times = {}
            for (e, u), shape in zip(timed, TIME_SHAPES):
                fine = f"{2 * shape[0]}^2"
                times[fine] = device_us(
                    lambda e=e, u=u: cs.prolong_add_padded_fast(e, u))
                times[f"{fine} point"] = device_us(
                    lambda e=e, u=u: cs._prolong_add_point(e, u))
            rows.append((var, ok, times))
            print(f"[prolong strip rows {strip}] equal to the twin and the "
                  f"point kernel: {ok}; device us per call "
                  f"{({k: round(v, 1) for k, v in times.items()})}",
                  flush=True)
    finally:
        _build.SOURCES, _build.LIBRARY, cs.prolong_tile = saved
        _build.library.cache_clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="coarse rows a warp walks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prolong_tile_rows: needs a CUDA device", file=sys.stderr)
        return 1
    rows = run(args.variants)
    return 0 if all(ok for _, ok, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
