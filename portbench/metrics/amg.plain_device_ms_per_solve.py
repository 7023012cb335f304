"""Device time per solve that is not one of the port's ``csrc/*.cu``
kernels, launched inside a solve's root span (``mg.solve_refined``,
``mg.solve``) or any span beneath it: in an AMG solve, Chebyshev's vector
operations, the dense bottom matvec and the float-float pair arithmetic
(on the slice that ``portbench/kernel_split.py`` profiles after the
run)."""

from portbench import kernel_split, spans
from portbench import trace as tracing

UNIT = "ms"


def read(run):
    split = kernel_split.of_run(run)
    if split is None:
        return None
    port = tracing.port_kernel_names()
    seconds = sum(s for (path, kernel), (s, _) in split.kernels.items()
                  if path.split("/", 1)[0] in spans.ROOTS
                  and kernel not in port)
    return seconds / split.spans.solves * 1e3
