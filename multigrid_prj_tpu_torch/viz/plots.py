"""Matplotlib visualization: solution fields, convergence history, and the
multigrid-cycle animation (port of ``multigrid_prj_tpu/viz/plots.py``).

* :func:`plot_solution`, :func:`plot_convergence`: 2D imshow + 3D surface
  of a solution, semilog residual history (the reference notebook's cells
  4-6);
* :func:`plot_fem_solution`: 2D tri-colormap + warped 3D render of a FEM
  solution (``AMG/start.py``);
* :func:`record_cycle_stages`, :func:`write_stage_files`,
  :func:`make_gif`: per-stage frames of the evolving solution through the
  sawtooth cycle, dumped as vector files and animated (the ``CREATE_GIF``
  build and ``gifMaker.py``).

matplotlib is imported inside the drawing functions, so the module, and
:func:`record_cycle_stages` / :func:`write_stage_files`, work where
matplotlib is absent (the card's machine).  The drawings take numpy
arrays; the stages run on the solver's device.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend (files only, no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_solution(u: np.ndarray, length: float, path: str, title: str = "u"):
    """2D heatmap + 3D surface side by side (notebook cells 4-5 parity)."""
    plt = _pyplot()
    u = np.asarray(u)
    n, m = u.shape
    fig = plt.figure(figsize=(11, 4.5))
    ax = fig.add_subplot(1, 2, 1)
    im = ax.imshow(u, extent=[0, length, 0, length], origin="upper",
                   cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_title(f"{title} (2D)")
    ax3 = fig.add_subplot(1, 2, 2, projection="3d")
    X = np.linspace(0, length, m)
    Y = np.linspace(length, 0, n)
    XX, YY = np.meshgrid(X, Y)
    ax3.plot_surface(XX, YY, u, cmap="viridis", linewidth=0)
    ax3.set_title(f"{title} (3D)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_convergence(history: Sequence[float], path: str):
    """Semilog residual history (notebook cell 6 / web chart parity)."""
    plt = _pyplot()
    h = np.asarray(history)
    fig, ax = plt.subplots(figsize=(6.5, 4))
    ax.semilogy(np.arange(len(h)), np.maximum(h, 1e-300), "o-")
    ax.set_xlabel("outer iteration")
    ax.set_ylabel("relative residual")
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_fem_solution(nodes: np.ndarray, triangles: np.ndarray, u: np.ndarray,
                      path: str):
    """2D tri-colormap + warped 3D trisurf (AMG/start.py parity)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(11, 4.5))
    ax = fig.add_subplot(1, 2, 1)
    t = ax.tripcolor(nodes[:, 0], nodes[:, 1], triangles, u, shading="gouraud",
                     cmap="viridis")
    fig.colorbar(t, ax=ax)
    ax.set_aspect("equal")
    ax.set_title("u (2D)")
    ax3 = fig.add_subplot(1, 2, 2, projection="3d")
    ax3.plot_trisurf(nodes[:, 0], nodes[:, 1], u, triangles=triangles,
                     cmap="viridis", linewidth=0)
    ax3.set_title("u (3D, warped)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# Cycle-stage recording + gif (CREATE_GIF / gifMaker.py parity)
# ---------------------------------------------------------------------------


def record_cycle_stages(solver, b, u=None, iterations: int = 3):
    """Run outer sawtooth iterations, snapshotting the evolving fine-grid
    approximation after every cycle stage.

    Mirrors the ``CREATE_GIF`` build, which dumps the full-length vector
    after pre-smooths, the coarse solve, and each up-leg smoothing.
    Coarse-level errors are prolongated to the fine grid for display.  The
    smoothing is ``solver.smoother`` (on the card in f32, the RB-GS or
    Jacobi kernel); the residual, transfers and coarse solve are the plain
    ops, so each ``"corrected"`` frame equals ``solver.step`` applied as
    many times.  ``b`` (and ``u``) are tensors on the solver's device, of
    the solver's (unpadded) finest shape.  Returns ``[(label, array),
    ...]`` with numpy arrays.
    """
    from multigrid_prj_tpu_torch.gmg import stationary_solve
    from multigrid_prj_tpu_torch.ops.stencil import poisson_residual
    from multigrid_prj_tpu_torch.ops.transfer import (
        prolong,
        restrict_full_weighting,
    )

    levels, alpha, sm = solver.levels, solver.alpha, solver.smoother
    if u is None:
        u = torch.zeros_like(b)

    def host(x):
        return x.cpu().numpy()

    frames = [("initial", host(u))]

    def to_fine(e, level):
        for j in range(level - 1, -1, -1):
            e = prolong(e, levels[j].shape)
        return e

    for it in range(iterations):
        u = sm(u, b, alpha, levels[0].h, solver.pre_sweeps)
        frames.append((f"it{it}: pre-smooth", host(u)))
        r = poisson_residual(u, b, alpha, levels[0].h)
        rs = [r]
        for _lev in levels[1:]:
            rs.append(restrict_full_weighting(rs[-1]))
        e = torch.zeros_like(rs[-1])
        e, _, _ = stationary_solve(e, rs[-1], alpha, levels[-1].h, sm,
                                   solver.coarse_tol, solver.coarse_maxit)
        frames.append((f"it{it}: coarse solve",
                       host(u + to_fine(e, len(levels) - 1))))
        for j in range(len(levels) - 2, -1, -1):
            e = prolong(e, levels[j].shape)
            e = sm(e, rs[j], alpha, levels[j].h, solver.nu)
            frames.append((f"it{it}: level {j} smooth",
                           host(u + to_fine(e, j))))
        u = u + e
        frames.append((f"it{it}: corrected", host(u)))
    return frames


def write_stage_files(frames, outdir: str):
    """Dump frames as ``<k>.mtx`` vector files -- the ``CREATE_GIF`` artifact
    format consumed by the reference's gifMaker.py."""
    from multigrid_prj_tpu_torch.utils.io import save_vector

    os.makedirs(outdir, exist_ok=True)
    for k, (_label, arr) in enumerate(frames):
        save_vector(os.path.join(outdir, f"{k}.mtx"), arr.reshape(-1))
    return outdir


def make_gif(frames, path: str, length: float = 10.0, fps: int = 2,
             three_d: bool = False):
    """Animate the recorded stages (gifMaker.py parity; 2D or 3D)."""
    plt = _pyplot()
    from matplotlib import animation

    vmin = min(f.min() for _, f in frames)
    vmax = max(f.max() for _, f in frames)
    fig = plt.figure(figsize=(6, 5))
    if three_d:
        ax = fig.add_subplot(projection="3d")
    else:
        ax = fig.add_subplot()

    def draw(k):
        ax.clear()
        label, arr = frames[k]
        if three_d:
            n, m = arr.shape
            X, Y = np.meshgrid(np.linspace(0, length, m),
                               np.linspace(length, 0, n))
            ax.plot_surface(X, Y, arr, cmap="viridis", linewidth=0)
            ax.set_zlim(vmin, vmax)
        else:
            ax.imshow(arr, extent=[0, length, 0, length], origin="upper",
                      cmap="viridis", vmin=vmin, vmax=vmax)
        ax.set_title(label)

    anim = animation.FuncAnimation(fig, draw, frames=len(frames))
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path
