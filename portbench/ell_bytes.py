"""The least bytes of the AMG solve's ELL kernels (``csrc/spmv.cu``: the
SpMV, its fused forms in the cycle, the float-float residual), and their
shares of the roofline in a profiled slice (``kernel_split.KernelSplit``).

Each launch is priced by the operator it applies, on the rows, columns and
stored entries of that operator (the solver family's ``level_shapes``):
every value and column id read once, every input read once, every output
written once, and no padding slot, so a kernel that streams its ELL
layout's padding shows it as a lower share.  Both kernels are bound by
bytes: 2 (SpMV) and ~24 (float-float residual) float32 operations per
stored entry, and a few a row, are far below 67 TFLOP/s at these bytes.
"""

from __future__ import annotations

import re

from portbench import kernel_split
from portbench.roofline import HBM_BYTES_PER_S

FF_RESIDUAL = "ell_ff_residual_kernel"
# a cycle stage's span, and the operator its kernels apply
_STAGE = re.compile(
    r"mg\.L(\d+)\.(pre_smooth|post_smooth|residual|restrict|prolong_add)")
OPERATOR = {"pre_smooth": "A", "post_smooth": "A", "residual": "A",
            "restrict": "Pt", "prolong_add": "P"}


def spmv_bytes(rows: int, cols: int, nnz: int) -> int:
    """``ell_spmv_kernel``: per stored entry a float32 value and an int32
    column id (8 B); ``x`` read once (4 B a column), ``y`` written once (4 B
    a row)."""
    return 8 * nnz + 4 * rows + 4 * cols


def cycle_kernel_bytes(kernel: str, rows: int, cols: int,
                       nnz: int) -> int | None:
    """The least bytes of one launch of a cycle kernel of ``csrc/spmv.cu``
    on an operator of ``rows``, ``cols`` and ``nnz``; ``None`` for another
    kernel.  Besides :func:`spmv_bytes`' matrix and ``x``:

    * ``ell_spmv_axpy_kernel`` (``z -/+ A x``): ``z`` read, ``y`` written;
    * ``ell_cheb_first_kernel``: ``b`` and the diagonal read, ``p`` and
      ``x_out`` written (``x``'s own row is among its gathered columns);
    * ``ell_cheb_step_kernel``: ``p`` read as well;
    * ``ell_cheb_zero_kernel`` (the first step from ``x = 0``): no matrix
      and no ``x``, only ``b``, the diagonal, ``p`` and ``x_out``.
    """
    matrix = 8 * nnz + 4 * cols
    return {"ell_spmv_kernel": matrix + 4 * rows,
            "ell_spmv_axpy_kernel": matrix + 8 * rows,
            "ell_cheb_first_kernel": matrix + 16 * rows,
            "ell_cheb_step_kernel": matrix + 20 * rows,
            "ell_cheb_zero_kernel": 16 * rows}.get(kernel)


def ff_residual_bytes(rows: int, nnz: int) -> int:
    """``ell_ff_residual_kernel`` on a square operator: per stored entry an
    int32 column id and the value's float32 pair ``vhT``, ``vlT`` (12 B);
    the pair ``xh``, ``xl`` read once (8 B a column), the pair ``bh``,
    ``bl`` read once (8 B a row) and ``r`` written once (4 B a row)."""
    return 12 * nnz + (8 + 8 + 4) * rows


def _share(least_s: float, spent_s: float) -> float | None:
    return 100.0 * least_s / spent_s if spent_s > 0 else None


def spmv_share(split, levels: list) -> float | None:
    """The least time of every cycle kernel (:func:`cycle_kernel_bytes`)
    launched under a level's cycle stage, each priced on the operator that
    stage applies (``A_k`` under the smooths and the residual, ``Pt_k``
    under ``restrict``, ``P_k`` under ``prolong_add``), over their device
    time, in percent."""
    least = spent = 0.0
    for (path, kernel), (seconds, launches) in split.kernels.items():
        stage = _STAGE.fullmatch(path.rsplit("/", 1)[-1])
        if stage is None:
            continue
        nbytes = cycle_kernel_bytes(
            kernel, *levels[int(stage[1])][OPERATOR[stage[2]]])
        if nbytes is None:
            continue
        least += launches * nbytes / HBM_BYTES_PER_S
        spent += seconds
    return _share(least, spent)


def ff_residual_share(split, levels: list) -> float | None:
    """The least time of every ``ell_ff_residual_kernel`` launched under
    ``mg.outer.ff_residual``, priced on ``A_0``, over their device time, in
    percent."""
    rows, _, nnz = levels[0]["A"]
    least = spent = 0.0
    for (path, kernel), (seconds, launches) in split.kernels.items():
        if kernel == FF_RESIDUAL and \
                path.rsplit("/", 1)[-1] == "mg.outer.ff_residual":
            least += launches * ff_residual_bytes(rows, nnz) / HBM_BYTES_PER_S
            spent += seconds
    return _share(least, spent)


def share_of_run(run, share) -> float | None:
    """``share(split, levels)`` of the slice that ``kernel_split`` profiles
    after ``run``, on the levels the ``amg`` family built; ``None`` where
    there is no slice or the family records no operators."""
    levels_of = getattr(run.family, "level_shapes", None)
    split = kernel_split.of_run(run)
    levels = levels_of(run.cell["config"]) if split is not None else None
    if not levels or not isinstance(levels[0], dict):
        return None
    return share(split, levels)
