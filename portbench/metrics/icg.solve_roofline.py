"""The MG-preconditioned CG solves' share of the card's roofline, in
percent: the least time of the family's stage schedule at each solve's
iteration count, priced by ``portbench/krylov_cost.py`` (the cycle's and
the outer loop's stages by ``roofline.stage_cost``), over the summed
device time of everything the solves launched, in the slice that
``portbench/kernel_split.py`` profiles after the run and holds to CUDA
events."""

from portbench import kernel_split, krylov_cost

UNIT = "%"


def read(run):
    split = kernel_split.of_run(run)
    if split is None or split.device_s <= 0:
        return None
    config, entry = run.cell["config"], run.cell["entry"]
    least = 0.0
    for iterations in split.iterations:
        sched = run.family.schedule(config, entry, iterations)
        if sched is None:
            return None
        least += krylov_cost.least_seconds(sched)
    return 100.0 * least / split.device_s
