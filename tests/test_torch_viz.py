"""The port's visualization layer (``multigrid_prj_tpu_torch/viz/plots.py``,
``cli/viz_main.py``) against the JAX package's, on the CPU.

* ``record_cycle_stages`` at 33^2, 3 levels, test 1, 2 iterations, in two
  setups: f64 with the plain ops on both sides (frames to 1e-9 of their
  maximum; measured 3.3e-19), and f32 with ``use_pallas=True`` on both,
  the JAX side in Pallas interpret mode, the port on its kernel twins
  (frames to 1e-6 of their maximum; measured 4.4e-8, a few ulp from XLA's
  contracted multiply-adds).  The labels are the same, and the port's
  ``"corrected"`` frames equal its own ``solver.step`` iterated, bit for
  bit.
* ``plot_solution``, ``plot_convergence``, ``plot_fem_solution`` and
  ``make_gif`` (2D and 3D) given the same numpy arrays write images that
  decode to the same pixels as the JAX functions' (exactly).
* ``viz_main`` writes the same file set with the same exit codes and
  messages as the JAX CLI (``--solution``, ``--history``, ``--vtu``,
  ``--gif``, nothing to do, a non-square vector), and refuses ``--gif``
  without a card unless ``-device cpu``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multigrid_prj_tpu import gmg as jgmg
from multigrid_prj_tpu.cli import viz_main as jviz_main
from multigrid_prj_tpu.models import poisson as jpoisson
from multigrid_prj_tpu.viz import plots as jplots
from multigrid_prj_tpu_torch import gmg as tgmg
from multigrid_prj_tpu_torch.cli import viz_main as tviz_main
from multigrid_prj_tpu_torch.models import fem as tfem
from multigrid_prj_tpu_torch.utils import io as tio
from multigrid_prj_tpu_torch.viz import plots as tplots

torch.set_num_threads(1)


@pytest.mark.parametrize("pallas,jdtype,rel", [(False, jnp.float64, 1e-9),
                                               (True, jnp.float32, 1e-6)])
def test_record_cycle_stages_matches_jax(pallas, jdtype, rel):
    kw = dict(shape=(33, 33), num_levels=3, use_pallas=pallas)
    js = jgmg.GMGSolver(**kw)
    ts = tgmg.GMGSolver(device="cpu", **kw)
    jb = jpoisson.assemble_rhs(js.levels[0], 10.0, test=1, dtype=jdtype)
    tb = torch.from_numpy(np.array(jb))
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            want = jplots.record_cycle_stages(js, jb, iterations=2)
    else:
        want = jplots.record_cycle_stages(js, jb, iterations=2)
    got = tplots.record_cycle_stages(ts, tb, iterations=2)
    assert [lab for lab, _ in got] == [lab for lab, _ in want]
    assert len(got) == 1 + 2 * (2 + 3)
    for (lab, g), (_, w) in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(np.asarray(w)).max(),
                                   err_msg=lab)
    u = torch.zeros_like(tb)
    corrected = [f for lab, f in got if lab.endswith("corrected")]
    for frame in corrected:
        u = ts.step(u, tb)
        assert np.array_equal(u.numpy(), frame)


def test_write_stage_files_reads_back(tmp_path):
    frames = [("a", np.arange(6.0).reshape(2, 3)),
              ("b", np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3))]
    d = tplots.write_stage_files(frames, str(tmp_path / "stages"))
    assert sorted(os.listdir(d)) == ["0.mtx", "1.mtx"]
    for k, (_, arr) in enumerate(frames):
        np.testing.assert_array_equal(tio.load_vector(os.path.join(
            d, f"{k}.mtx")), arr.reshape(-1).astype(np.float64))


def _pixels(path):
    """Every frame of an image file as one uint8 array."""
    with Image.open(path) as im:
        frames = []
        for k in range(getattr(im, "n_frames", 1)):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGBA")))
    return np.stack(frames)


def _same_pixels(tmp_path, name, draw_t, draw_j):
    pt, pj = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    assert draw_t(pt) == pt and draw_j(pj) == pj
    a, b = _pixels(pt), _pixels(pj)
    assert a.shape == b.shape and a.shape[1] > 100
    assert np.array_equal(a, b)


def test_plots_draw_the_same_pixels_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    u = np.cumsum(rng.standard_normal((17, 17)), axis=0)
    hist = 10.0 ** -np.arange(8.0) * (1 + 0.1 * rng.random(8))
    _same_pixels(tmp_path, "sol.png",
                 lambda p: tplots.plot_solution(u, 10.0, p),
                 lambda p: jplots.plot_solution(u, 10.0, p))
    _same_pixels(tmp_path, "conv.png",
                 lambda p: tplots.plot_convergence(hist, p),
                 lambda p: jplots.plot_convergence(hist, p))
    mesh = tfem.structured_unit_square_mesh(9)
    f = np.sin(3 * mesh.nodes[:, 0]) * mesh.nodes[:, 1]
    _same_pixels(tmp_path, "fem.png",
                 lambda p: tplots.plot_fem_solution(mesh.nodes,
                                                    mesh.triangles, f, p),
                 lambda p: jplots.plot_fem_solution(mesh.nodes,
                                                    mesh.triangles, f, p))


@pytest.mark.parametrize("three_d", [False, True])
def test_make_gif_same_pixels_as_jax(tmp_path, three_d):
    rng = np.random.default_rng(4)
    frames = [(f"stage {k}", rng.standard_normal((9, 9)).cumsum(axis=1))
              for k in range(3)]
    _same_pixels(tmp_path, "cycle.gif",
                 lambda p: tplots.make_gif(frames, p, three_d=three_d),
                 lambda p: jplots.make_gif(frames, p, three_d=three_d))


def _cli(main, argv, cwd, capsys):
    rc = main(argv + ["--out", str(cwd)])
    out = capsys.readouterr().out.replace(str(cwd), "<out>")
    return rc, out, sorted(os.listdir(cwd)) if cwd.exists() else None


def test_viz_main_matches_jax_cli(tmp_path, capsys):
    u = np.outer(np.linspace(0, 1, 17), np.linspace(1, 2, 17))
    tio.save_vector(tmp_path / "x.mtx", u.reshape(-1))
    tio.save_vector(tmp_path / "bad.mtx", np.arange(10.0))
    tio.save_history(tmp_path / "MGGS4.txt", 10.0 ** -np.arange(6.0))
    mesh = tfem.structured_unit_square_mesh(7)
    tfem.export_vtu(str(tmp_path / "output.vtu"), mesh,
                    np.linspace(0, 1, int((~mesh.on_boundary).sum())))
    cases = {
        "files": ["--solution", str(tmp_path / "x.mtx"), "--history",
                  str(tmp_path / "MGGS4.txt"), "--vtu",
                  str(tmp_path / "output.vtu")],
        "gif": ["--gif", "-n", "17", "-ml", "3", "-test", "1"],
        "nothing": [],
        "not square": ["--solution", str(tmp_path / "bad.mtx")],
    }
    got = {}
    for name, argv in cases.items():
        want = _cli(jviz_main.main, argv, tmp_path / f"j_{name}", capsys)
        got[name] = _cli(tviz_main.main, argv + ["-device", "cpu"],
                         tmp_path / f"t_{name}", capsys)
        assert got[name] == want, name
    assert got["files"][0] == got["gif"][0] == 0
    assert got["files"][2] == ["convergence.png", "fem_solution.png",
                               "solution.png"]
    assert got["gif"][2] == ["cycle.gif", "cycle3d.gif"]
    assert got["nothing"][0] == got["not square"][0] == 1


def test_viz_main_gif_without_a_card_asks_for_device_cpu(tmp_path, capsys,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    assert tviz_main.main(["--gif", "--out", str(out)]) == 1
    assert "-device cpu" in capsys.readouterr().out
    assert not out.exists()
