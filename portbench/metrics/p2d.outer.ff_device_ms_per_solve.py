"""Device time per solve of the outer loop's float-float arithmetic, on the
spans ``outer.ff_device_ms_per_solve`` picks (``mg.outer.split``,
``mg.outer.ff_residual``, ``mg.fetch``, ``mg.outer.pair_update``,
``mg.outer.combine``, outside the cycle), in the slice that
``portbench/kernel_split.py`` profiles after the run."""

from portbench import kernel_split, registry

UNIT = "ms"


def read(run):
    split = kernel_split.of_run(run)
    if split is None:
        return None
    return split.spans.busy_ms_per_solve(registry.load_module(
        "metrics", "outer.ff_device_ms_per_solve")._outer_stage)
