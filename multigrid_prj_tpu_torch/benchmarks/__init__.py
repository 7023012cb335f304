"""Design-probe harnesses of the port: the counterparts of the stencil and
SpMV ablations in ``benchmarks/``, with their probe kernels in
``csrc/ablation.cu``.  Run each with ``python -m
multigrid_prj_tpu_torch.benchmarks.<name>`` (on the card; ``-device cpu``
runs the plain twins)."""
