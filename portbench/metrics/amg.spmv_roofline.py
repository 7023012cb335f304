"""The AMG cycle's ELL kernels' share of their roofline, in percent: every
launch of ``ell_spmv_kernel`` and of its fused forms (``ell_spmv_axpy``,
the Chebyshev steps ``ell_cheb_zero`` / ``_first`` / ``_step``) under a
level's ``mg.L<k>.<stage>``, priced on the operator the stage applies
(``A_k`` under the smooths and the residual, ``Pt_k`` under ``restrict``,
``P_k`` under ``prolong_add``) at the bytes of
``ell_bytes.cycle_kernel_bytes`` (``8 nnz + 4 cols`` for the matrix and
``x``, plus the vectors each reads and writes) over 3.35 TB/s, over their
device time (on the slice that ``portbench/kernel_split.py`` profiles
after the run)."""

from portbench import ell_bytes

UNIT = "%"


def read(run):
    return ell_bytes.share_of_run(run, ell_bytes.spmv_share)
