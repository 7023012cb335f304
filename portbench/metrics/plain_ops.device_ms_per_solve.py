"""Device time per traced solve of every device operation that is not one
of the port's ``csrc/*.cu`` kernels: the plain-torch cycle and float-float
pair arithmetic, norms, the dense bottom matvec, copies."""

UNIT = "ms"


def read(run):
    if run.trace is None or not run.trace.solves or run.trace.busy_s <= 0:
        return None
    return run.trace.plain_s / run.trace.solves * 1e3
