"""Ablation harness for the ELL SpMV kernel on the card (``ops/cuda_spmv``).

Counterpart of ``benchmarks/spmv_ablation.py`` (the TPU's Pallas probes):
times kernel variants to split the SpMV's time between streaming the ELL
slots and gathering x, over a sweep of rows per CUDA block (the TPU
probes' ``block_rows``, rows per grid step).  ``orig`` is the port's SpMV
kernel (``CudaELL.spmv``, ``ell_spmv_kernel``: one thread per row, 256 per
block, whatever the block size); the ``probe_`` variants are the kernels
of ``csrc/ablation.cu`` on the port's slot-major ELL, and intentionally
compute WRONG products (they skip or fake part of the work to isolate its
cost), so only ``orig`` is checked against itself across block sizes:

* ``probe_stream``: ``sum_k vals[k, i] * float(cols[k, i])`` -- the slots
  streamed, no gather (the TPU probe's formula);
* ``probe_staticwin``: ``sum_k vals[k, i] * x[cols[k, i] & 1023]`` -- the
  gather from one fixed 1024-entry window (the TPU probe's static base-0
  window of 8 x 128), which stays in L1;
* ``probe_noshuffle``: ``sum_k vals[k, i] * x[(cols[k, i] & ~127) | (i &
  127)]`` -- the column's 128-entry block read at the row's own lane (the
  TPU probe's window row without the lane shuffle): coalesced.

The TPU probes ran on its windowed layout (int16 relative ids, ``base2``
windows), which the port does not have (one layout of absolute int32 ids
serves every matrix), so staticwin and noshuffle isolate the same costs on
absolute ids.  x is padded with zeros to a multiple of 128.  On the CPU each
probe runs its plain twin (slot order, each step a separate torch op).

    python -m multigrid_prj_tpu_torch.benchmarks.spmv_ablation [n_rows] [iters] [-device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from multigrid_prj_tpu_torch.benchmarks.program import Program
from multigrid_prj_tpu_torch.models.poisson import banded_csr
from multigrid_prj_tpu_torch.ops.cuda_spmv import (
    CudaELL,
    _check_cuda_ell,
    ell_local_spmv,
)
from multigrid_prj_tpu_torch.ops.cuda_stencil import (
    LAUNCHES,
    _lib,
    _ptr,
    _raise_on,
    _stream,
)

BLOCK_ROWS = (1024, 8192, 32768)  # rows one CUDA block covers
_LANE = 128
_WINDOW = 1024  # 8 x 128 entries: the TPU probe's static window
# modes of csrc/ablation.cu's mg_probe_spmv
_MODES = {"probe_stream": 0, "probe_staticwin": 1, "probe_noshuffle": 2}


def pad_x(x, n_pad=None):
    """``x`` with zeros to a multiple of 128 entries (or to ``n_pad``)."""
    m = x.shape[0]
    n_pad = n_pad or -(-m // _LANE) * _LANE
    if n_pad == m:
        return x
    return torch.cat([x, x.new_zeros(n_pad - m)])


# -- plain twins ----------------------------------------------------------------


def _slot_sum(valsT, gathered):
    """``acc = 0``, then per slot ``acc = acc + valsT[k] * gathered(k)``."""
    acc = torch.zeros(valsT.shape[1], dtype=valsT.dtype, device=valsT.device)
    for k in range(valsT.shape[0]):
        acc = acc + valsT[k] * gathered(k)
    return acc


def probe_stream_plain(colsT, valsT, x):
    return _slot_sum(valsT, lambda k: colsT[k].to(valsT.dtype))


def probe_staticwin_plain(colsT, valsT, x):
    return _slot_sum(valsT, lambda k: x[colsT[k] & (_WINDOW - 1)])


def probe_noshuffle_plain(colsT, valsT, x):
    lane = torch.arange(colsT.shape[1], device=colsT.device,
                        dtype=colsT.dtype) & (_LANE - 1)
    return _slot_sum(valsT, lambda k: x[(colsT[k] & ~(_LANE - 1)) | lane])


_PLAIN = {"probe_stream": probe_stream_plain,
          "probe_staticwin": probe_staticwin_plain,
          "probe_noshuffle": probe_noshuffle_plain}


# -- kernels --------------------------------------------------------------------


def _probe(tag):
    def run(colsT, valsT, x, block_rows):
        if _check_cuda_ell(tag, colsT, (valsT,), (x,)):
            return _PLAIN[tag](colsT, valsT, x)
        K, n = colsT.shape
        if block_rows <= 0 or x.shape[0] % _LANE:
            raise ValueError(f"{tag}: x must be padded to a multiple of "
                             f"{_LANE} (pad_x), block_rows > 0")
        y = torch.empty(n, dtype=torch.float32, device=x.device)
        _raise_on(_lib().mg_probe_spmv(_ptr(colsT), _ptr(valsT), _ptr(x),
                                       _ptr(y), n, K, block_rows,
                                       _MODES[tag], _stream()), tag)
        LAUNCHES[tag] += 1
        return y

    run.__name__ = f"_kernel_{tag}"
    return run


def _orig(colsT, valsT, x, block_rows):
    """The port's SpMV kernel (``ell_local_spmv``); it has one block size,
    so ``block_rows`` is not read."""
    return ell_local_spmv(colsT, valsT, x)


_kernel_probe_noshuffle = _probe("probe_noshuffle")
_kernel_probe_staticwin = _probe("probe_staticwin")
_kernel_probe_stream = _probe("probe_stream")


def spmv_variant(E: CudaELL, x, kernel_fn, block_rows: int):
    """One product of the variant ``kernel_fn`` on ``E`` and the padded
    ``x``."""
    return kernel_fn(E.colsT, E.valsT, x, block_rows)


def time_fn(fn, x, iters, tag, slots):
    """``iters`` chained products (x's first n entries <- y, as the JAX
    harness's ``dynamic_update_slice``), best of 3 after one warm chain;
    on the card the chain is one CUDA graph (``Program``), with
    ``torch.cuda.synchronize()`` fences around the host timers."""
    def chain(x):
        for _ in range(iters):
            y = fn(x)
            x = y if y.shape == x.shape else torch.cat([y, x[y.shape[0]:]])
        return x

    run = Program(chain, x)
    run()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    out = {"variant": tag, "nnz_per_s": slots * iters / best,
           "gb_s": slots * iters / best * 8e-9,
           "us_per_spmv": best * 1e6 / iters}
    print(json.dumps(out))
    return out


VARIANTS = (
    ("orig", _orig, True),
    ("probe_noshuffle", _kernel_probe_noshuffle, False),
    ("probe_staticwin", _kernel_probe_staticwin, False),
    ("probe_stream", _kernel_probe_stream, False),
)


def main(argv=None):
    """Time every variant at every block size on ``banded_csr(n_rows)``;
    returns the JSON records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=1 << 20)
    ap.add_argument("iters", nargs="?", type=int, default=50)
    ap.add_argument("-device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("spmv_ablation: no CUDA device (use -device cpu for the plain "
              "twins)", file=sys.stderr)
        raise SystemExit(1)
    n, iters = args.n_rows, args.iters
    A = banded_csr(n)
    rng = np.random.default_rng(0)
    x = pad_x(torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                           device=args.device))
    E = CudaELL.build(A, dtype=torch.float32, device=args.device)

    y_ref = None
    out = []
    for br in BLOCK_ROWS:
        for tag, kern, check in VARIANTS:
            y = spmv_variant(E, x, kern, br)
            if check:
                if y_ref is None:
                    y_ref = y
                else:
                    err = float((y - y_ref).abs().max())
                    assert err < 1e-5, (tag, br, err)
            out.append(time_fn(
                lambda x, k=kern, b=br: spmv_variant(E, x, k, b), x, iters,
                f"{tag}_br{br}", E.nnz_dense))
    return out


if __name__ == "__main__":
    main()
