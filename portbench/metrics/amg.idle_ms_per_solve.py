"""Idle device time per solve: every gap between device events whose
midpoint fell inside a solve's root span (``mg.solve_refined``,
``mg.solve``) or any span beneath it, in the slice that
``portbench/kernel_split.py`` profiles after the run: the reader of
``p2d.idle_ms_per_solve``."""

from portbench import registry

UNIT = "ms"
read = registry.load_module("metrics", "p2d.idle_ms_per_solve").read
