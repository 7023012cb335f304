"""The 2D float-float residual kernel's share of its roofline, in percent:
every ``ff_residual_kernel`` launch whose innermost span is
``mg.outer.ff_residual``, each priced as the stage ``ff_residual`` on the
finest logical grid, over their device time
(``portbench/kernel_split.py``)."""

from portbench import kernel_split

UNIT = "%"
PICKS = {"ff_residual_kernel": (r"mg\.outer\.ff_residual", "ff_residual")}


def read(run):
    return kernel_split.roofline_share(run, PICKS)
