"""Build and load the CUDA kernels of ``csrc/`` (see ``_build.py``)."""
