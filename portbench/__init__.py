"""The benchmark of ``multigrid_prj_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Everything a
cell needs is found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``traffic/<traffic>.json``,
``problems/<problem>.py``, ``reference/<reference>.py``,
``solvers/<family>.py`` and one ``metrics/<metric>.py`` per metric.  Nothing
here imports the JAX package or JAX.
"""
