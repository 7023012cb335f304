"""The Krylov operator apply's share of its roofline, in percent: every
``apply_kernel`` launch whose innermost span is ``mg.cg.apply``, each
priced at ``krylov_cost.APPLY_BYTES`` (``STENCIL_COST["apply"]``'s 8 B a
point) on the finest logical grid, over 3.35 TB/s, over their device
time, in the slice that ``portbench/kernel_split.py`` profiles after the
run and holds to CUDA events.  ``None`` where no such launch ran."""

import math

from portbench import kernel_split, krylov_cost, roofline

UNIT = "%"


def read(run):
    split = kernel_split.of_run(run)
    if split is None:
        return None
    points = math.prod(run.family.level_shapes(run.cell["config"])[0])
    launches = spent = 0
    for (path, kernel), (seconds, count) in split.kernels.items():
        if kernel == "apply_kernel" and path.endswith("/mg.cg.apply"):
            launches += count
            spent += seconds
    if spent <= 0:
        return None
    least = launches * krylov_cost.APPLY_BYTES * points \
        / roofline.HBM_BYTES_PER_S
    return 100.0 * least / spent
