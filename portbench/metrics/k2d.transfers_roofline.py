"""The 2D grid-transfer kernels' share of their roofline, in percent:
every ``restrict_fw_kernel`` launch under a level's ``mg.L<k>.restrict``
(the stage ``restriction``) and every ``prolong_add_stream_kernel`` launch
under ``mg.L<k>.prolong_add`` (the stage ``prolong_add``), each priced per
point of level k's logical grid, the fine level of the transfer, over their
device time (``portbench/kernel_split.py``)."""

from portbench import kernel_split

UNIT = "%"
PICKS = {"restrict_fw_kernel": (r"mg\.L\d+\.restrict", "restriction"),
         "prolong_add_stream_kernel": (r"mg\.L\d+\.prolong_add",
                                       "prolong_add")}


def read(run):
    return kernel_split.roofline_share(run, PICKS)
