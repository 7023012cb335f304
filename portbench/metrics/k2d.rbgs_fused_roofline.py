"""The 2D red-black Gauss-Seidel kernel's share of its roofline, in
percent: every ``rbgs_fused_kernel`` launch whose innermost span is a
level's ``mg.L<k>.pre_smooth`` or ``mg.L<k>.post_smooth``, each priced as
the stage ``smoother`` on level k's logical grid (u and b read, u written
once a call), over their device time (``portbench/kernel_split.py``)."""

from portbench import kernel_split

UNIT = "%"
PICKS = {"rbgs_fused_kernel": (r"mg\.L\d+\.(pre|post)_smooth", "smoother")}


def read(run):
    return kernel_split.roofline_share(run, PICKS)
