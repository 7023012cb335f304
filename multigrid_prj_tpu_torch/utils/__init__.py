"""Configuration, I/O and guard utilities."""

from multigrid_prj_tpu_torch.utils.io import (
    load_matrix_coo,
    load_matrix_market,
    load_vector,
    save_history,
    save_matrix_coo,
    save_matrix_market,
    save_vector,
)

__all__ = [
    "load_matrix_coo",
    "load_matrix_market",
    "load_vector",
    "save_history",
    "save_matrix_coo",
    "save_matrix_market",
    "save_vector",
]
