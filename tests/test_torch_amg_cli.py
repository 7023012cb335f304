"""The port's AMG CLI (``multigrid_prj_tpu_torch/cli/amg_main.py``) vs the
JAX package's on the CPU (f64 on both sides): the residual history and the
written solution agree to 1e-10 relative.  The history's late entries sit
near the f64 round-off floor of the residual (both sides sum in other
orders: entries of 2e-11 differed by 5e-17), so each entry also gets
1e-14 absolute, i.e. 1e-14 of ``|b|``.  The system files are written with
the port's MatrixMarket writer and read by both CLIs."""

import numpy as np
import pytest
import torch

from multigrid_prj_tpu.cli import amg_main as jcli
from multigrid_prj_tpu_torch.cli import amg_main as tcli
from multigrid_prj_tpu_torch.models import fem as tfem
from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
from multigrid_prj_tpu_torch.utils import io as tio
from torch_msh import write_msh
from torch_native_parity import native_parity  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("native_parity")
HIST_ATOL = 1e-14
CPU = ["-device", "cpu"]  # the port's CLI runs on the card unless asked


@pytest.fixture
def system(tmp_path):
    """FD 20^2 as MatrixMarket (general and symmetric) and a random rhs."""
    A = poisson_fd_csr(20)
    rows, cols, vals = A.to_coo()
    tio.save_matrix_market(tmp_path / "fd20.mtx", rows, cols, vals, A.shape)
    tio.save_matrix_market(tmp_path / "fd20s.mtx", rows, cols, vals, A.shape,
                           symmetric=True)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    tio.save_vector(tmp_path / "b.mtx", b)
    return tmp_path, A, b


def _run(main, argv, cwd, monkeypatch):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    assert main(argv) == 0
    return cwd


@pytest.mark.parametrize("argv", [
    ["-matrix", "{d}/fd20.mtx", "-precision", "f64"],
    ["-matrix", "{d}/fd20s.mtx", "-rhs", "{d}/b.mtx", "-accel", "pcg",
     "-levels", "3"],
    ["-matrix", "{d}/fd20.mtx", "-rhs", "{d}/b.mtx", "-smoother",
     "chebyshev", "-coarsening", "greedy", "-tol", "1e-9"],
])
def test_amg_cli_matrix_f64_matches_jax(system, monkeypatch, argv):
    d, A, _ = system
    argv = [a.format(d=d) for a in argv]
    jd = _run(jcli.main, argv + ["-metrics", "m.json"], d / "jax",
              monkeypatch)
    td = _run(tcli.main, argv + ["-metrics", "m.json"] + CPU, d / "torch",
              monkeypatch)
    jh, th = (tio.load_vector(p / "amg_history.txt") for p in (jd, td))
    jx, tx = (tio.load_vector(p / "x.mtx") for p in (jd, td))
    assert len(th) == len(jh) > 2 and th[0] == 1.0
    np.testing.assert_allclose(th, jh, rtol=1e-10, atol=HIST_ATOL)
    assert tx.size == A.shape[0]
    np.testing.assert_allclose(tx, jx, rtol=1e-10,
                               atol=1e-10 * np.abs(jx).max())
    assert (td / "m.json").read_text().count('"iterations"') == 1


def test_amg_cli_mesh_and_reference_pass_match_jax(tmp_path, monkeypatch):
    msh = tmp_path / "square.msh"
    write_msh(str(msh), tfem.structured_unit_square_mesh(17))
    argv = ["-mesh", str(msh), "-levels", "4"]
    jd = _run(jcli.main, argv, tmp_path / "jax", monkeypatch)
    td = _run(tcli.main, argv + CPU, tmp_path / "torch", monkeypatch)
    np.testing.assert_allclose(tio.load_vector(td / "amg_history.txt"),
                               tio.load_vector(jd / "amg_history.txt"),
                               rtol=1e-10, atol=HIST_ATOL)
    vt, vj = ((p / "output.vtu").read_text().splitlines() for p in (td, jd))
    assert len(vt) == len(vj) and vt[:5] == vj[:5]
    # one sawtooth pass of the reference scheme writes no history
    argv = ["-matrix", str(tmp_path / "fd.mtx"), "--reference-pass",
            "-levels", "3", "-hist", "none"]
    A = poisson_fd_csr(12)
    tio.save_matrix_market(tmp_path / "fd.mtx", *A.to_coo(), A.shape)
    jd = _run(jcli.main, argv, tmp_path / "jax_ref", monkeypatch)
    td = _run(tcli.main, argv + CPU, tmp_path / "torch_ref", monkeypatch)
    jx, tx = (tio.load_vector(p / "x.mtx") for p in (jd, td))
    np.testing.assert_allclose(tx, jx, rtol=1e-10,
                               atol=1e-10 * np.abs(jx).max())
    assert not (td / "amg_history.txt").exists()


def test_amg_cli_ff32_and_errors(system, monkeypatch, capsys):
    """``-precision ff32`` on the CPU: f32 cycles, float-float residuals
    (the gather form), to 1e-8; and the CLI's input errors."""
    d, A, _ = system
    td = _run(tcli.main, ["-matrix", str(d / "fd20.mtx"), "-precision",
                          "ff32", "-tol", "1e-8", *CPU], d / "ff32",
              monkeypatch)
    out = capsys.readouterr().out
    assert "ff32-refined V-cycle iterations" in out and "not conv" not in out
    h = tio.load_vector(td / "amg_history.txt")
    assert h[-1] <= 1e-8
    x = tio.load_vector(td / "x.mtx")
    r = A.spmv(np.ones(A.shape[0])) - A.spmv(x)
    assert np.linalg.norm(r) <= 2e-8 * np.linalg.norm(A.spmv(np.ones(400)))
    assert tcli.main(["-matrix", str(d / "missing.mtx"), *CPU]) == 1
    A2 = poisson_fd_csr(3)
    rows, cols, vals = A2.to_coo()
    tio.save_matrix_market(d / "rect.mtx", rows, cols, vals, (9, 10))
    assert tcli.main(["-matrix", str(d / "rect.mtx"), *CPU]) == 1
    assert tcli.main(["-matrix", str(d / "fd20.mtx"), "-rhs",
                      str(d / "missing.mtx"), *CPU]) == 1
