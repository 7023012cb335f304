"""Host seconds of the AMG hierarchy's set-up: the sum of the solver's
``setup_times`` (reordering, coarsening, interpolation with the lmax
estimates, Galerkin products, the upload to the device and the bottom
inverse), read from the solver the ``amg`` family built for the cell.
``None`` for a family or a program that keeps no such timers."""

UNIT = "s"


def read(run):
    times_of = getattr(run.family, "setup_times", None)
    times = times_of(run.cell["config"]) if times_of is not None else None
    if not times:
        return None
    return sum(times.values())
