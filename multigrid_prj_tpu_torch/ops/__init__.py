"""Compute ops of the port: plain torch stencil, smoother, transfer,
residual and float-float ops (the JAX package's XLA-order versions), and
``cuda_stencil`` with the hand-written CUDA kernels and their twins."""
