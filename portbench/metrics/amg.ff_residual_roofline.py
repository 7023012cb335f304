"""The AMG outer loop's float-float residual kernel's share of its
roofline, in percent: every ``ell_ff_residual_kernel`` launch under
``mg.outer.ff_residual``, priced on ``A_0``.  From ``csrc/spmv.cu``: each
thread reads its row's K slots of ``colsT`` (int32), ``vhT`` and ``vlT``
(float32), gathers ``xh[c]`` and ``xl[c]``, reads ``bh`` and ``bl`` and
writes ``r``; counting each stored entry once (no padding slot) and each
vector once, ``12 nnz + 8 cols + 8 rows + 4 rows`` bytes, over 3.35 TB/s,
over their device time (``portbench/ell_bytes.py``, on the slice that
``portbench/kernel_split.py`` profiles after the run)."""

from portbench import ell_bytes

UNIT = "%"


def read(run):
    return ell_bytes.share_of_run(run, ell_bytes.ff_residual_share)
