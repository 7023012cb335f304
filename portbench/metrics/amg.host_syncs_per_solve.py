"""Host syncs per solve: the change of the program's
``COUNTERS["host_syncs"]`` (one per ``metrics.fetch``: the outer loop's
stop tests, ``iterations + 1`` a converged solve) over the slice that
``portbench/spans.py`` profiles after the run, per solve in it: the reader
of ``outer.host_syncs_per_solve``.  ``None`` where the program has no
counter."""

from portbench import registry

UNIT = "syncs"
read = registry.load_module("metrics", "outer.host_syncs_per_solve").read
