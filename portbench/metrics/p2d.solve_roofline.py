"""The solves' share of the card's roofline, in percent, as
``solve_roofline`` counts it (the least time of the family's stage
schedule at each solve's iteration count, over the summed device time of
everything the solves launched), on the slice that
``portbench/kernel_split.py`` profiles after the run and holds to CUDA
events."""

from portbench import kernel_split, roofline

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
        least += roofline.least_seconds(sched)
    return 100.0 * least / split.device_s
