"""Tile-height probe of the apply chain's row-walking tile of
``csrc/stencil2d.cu`` (``apply_chain_kernel<A>``).

The kernel is compiled for tiles of ``kApRows`` = 64 rows.  For each
variant (a row count) this builds the kernel library from a copy of the
source with that many tile rows (under
``multigrid_prj_tpu_torch/build/apply_rows/``), holds the chain at 1-11
applies to its twin at 8192^2, the 1025^2 path's finest level and an odd
unpadded shape, and times 1, 2, 4 and 8 applies at 8192^2 (bench.py's chain
size, c = 1) from CUDA-graph replays (``benchmarks/program.py``).  The card
only.

    python -m multigrid_prj_tpu_torch.benchmarks.apply_tile_rows [rows ...]

Prints one line per variant: equal to the twin, and device microseconds per
call by apply count.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from multigrid_prj_tpu_torch.benchmarks.rbgs_tile_rows import device_us
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

VARIANTS = ("64", "96", "128")
SHAPES = [((8192, 8192), None), ((1280, 1280), (1025, 1025)),
          ((385, 385), None)]
LADDER = (1, 2, 4, 8)
_ANCHOR = "constexpr int kApRows = 64;"


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return u.cuda(), 10.0 / (shape[0] - 1)


def _equal_to_twin(inputs):
    ok = True
    for (_shape, logical), (u, h) in inputs:
        for s in range(1, 12):  # alpha = h^2: c = 1 keeps 11 applies finite
            ok &= torch.equal(
                cs.poisson_apply_chain(u, h * h, h, s, logical),
                cs.poisson_apply_chain_plain(u, h * h, h, s, logical))
    return ok


def run(variants):
    source = _build.SOURCES[0].read_text()
    if _ANCHOR not in source:
        raise RuntimeError(f"{_build.SOURCES[0]} no longer declares "
                           f"'{_ANCHOR}'")
    saved = _build.SOURCES, _build.LIBRARY, cs.apply_tile
    out_dir = _build.BUILD_DIR / "apply_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    inputs = [(sl, _inputs(sl[0], seed=i)) for i, sl in enumerate(SHAPES)]
    (shape, logical), (u, h) = inputs[0]
    rows = []
    try:
        for var in variants:
            n_rows = int(var)
            src = out_dir / f"stencil2d_{n_rows}.cu"
            src.write_text(source.replace(
                _ANCHOR, f"constexpr int kApRows = {n_rows};"))
            _build.SOURCES = (src,) + tuple(saved[0][1:])
            _build.LIBRARY = out_dir / f"libmg_stencil_{n_rows}.so"
            _build.library.cache_clear()
            _build.build(force=True)

            def tile(applies, n_rows=n_rows):
                hr, hc, _, cols = saved[2](applies)
                return hr, hc, n_rows, cols

            cs.apply_tile = tile
            ok = _equal_to_twin(inputs)
            ladder = {s: device_us(lambda s=s: cs.poisson_apply_chain(
                u, h * h, h, s, logical)) for s in LADDER}
            rows.append((var, ok, ladder))
            print(f"[apply tile rows {n_rows}] equal to the twin: {ok}; "
                  f"{shape[0]}x{shape[1]} device us per call by applies "
                  f"{({k: round(v, 1) for k, v in ladder.items()})}",
                  flush=True)
    finally:
        _build.SOURCES, _build.LIBRARY, cs.apply_tile = saved
        _build.library.cache_clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="tile rows")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("apply_tile_rows: needs a CUDA device", file=sys.stderr)
        return 1
    rows = run(args.variants)
    return 0 if all(ok for _, ok, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
