"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test holds."""

from __future__ import annotations

import copy

import torch

from portbench import registry

torch.set_num_threads(2)

# 2D: 65^2 padded to 128, 4 levels down to 9^2 (dense bottom); 3D: 17^3,
# 3 levels down to 5^3 (dense bottom)
SMALL = {2: dict(shape=[65, 65], num_levels=4, pad_align=128),
         3: dict(shape=[17, 17, 17], num_levels=3)}
CELLS = ("p2d-1025-ff32", "p3d-257-ff32")


def small_cell(name: str) -> dict:
    cell = copy.deepcopy(registry.cell(name))
    kw = cell["config"]["solver"]
    kw.update(SMALL[len(kw["shape"])])
    cell["config"]["bottom"] = {"stage": "dense_inverse"}
    return cell
