"""The 2D residual kernel's share of its roofline, in percent: every
``residual_kernel`` launch whose innermost span is a level's
``mg.L<k>.residual``, each priced as the stage ``residual`` on level k's
logical grid, over their device time (``portbench/kernel_split.py``)."""

from portbench import kernel_split

UNIT = "%"
PICKS = {"residual_kernel": (r"mg\.L\d+\.residual", "residual")}


def read(run):
    return kernel_split.roofline_share(run, PICKS)
