"""The port's AMG debug harness (``multigrid_prj_tpu_torch/cli/amg_debug.py``)
against the JAX CLI on the same generated gmsh files (17 x 17 and 33 x 33
structured P1 meshes; the reference's mesh1 is not in the repository),
``-sweeps 30``, the port with ``-device cpu`` (f64, as the JAX CLI on the
CPU).

The two print the same lines in the same order: every count exactly, every
float to 1e-6 relative (printed with 7 significant digits; measured: the
same text), the composition check's max diff to 1e-12 absolute.  The VTU
files hold the same points and cells exactly and the same solution to
1e-9 of its maximum (measured: 3.3e-16 at most; the JAX sweep is jitted,
where XLA may contract a multiply-add).
"""

import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from multigrid_prj_tpu.cli import amg_debug as jdbg
from multigrid_prj_tpu_torch.cli import amg_debug as tdbg
from multigrid_prj_tpu_torch.models.fem import structured_unit_square_mesh
from torch_msh import write_msh
from torch_native_parity import native_parity  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("native_parity")

NUM = re.compile(r"[-+]?\d+(?:\.\d*)?(?:e[-+]?\d+)?")


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.strip().splitlines()


def _vtu(path):
    root = ET.parse(path).getroot()

    def arr(xpath, dtype=float):
        return np.array(root.find(xpath).text.split(), dtype=dtype)

    return (arr(".//Points/DataArray"),
            arr(".//Cells/DataArray[@Name='connectivity']", int),
            arr(".//PointData/DataArray"))


@pytest.mark.parametrize("n,levels", [(17, 2), (33, 2), (33, 3)])
def test_amg_debug_matches_jax_cli(tmp_path, capsys, n, levels):
    mesh = str(tmp_path / "square.msh")
    write_msh(mesh, structured_unit_square_mesh(n))
    argv = ["-mesh", mesh, "-levels", str(levels), "-sweeps", "30"]
    jv, tv = str(tmp_path / "jax.vtu"), str(tmp_path / "port.vtu")
    want = _run(jdbg.main, argv + ["-o", jv], capsys)
    got = _run(tdbg.main, argv + ["-o", tv, "-device", "cpu"], capsys)
    assert len(got) == len(want) == 6 + 2 * (levels - 1)
    assert got[0] == f"Mesh imported! {n * n} nodes, {2 * (n - 1) ** 2} elements"
    for g, w in zip(got[:-1], want[:-1]):
        assert NUM.sub("#", g) == NUM.sub("#", w)  # the same words
        gn, wn = NUM.findall(g), NUM.findall(w)
        for a, b in zip(gn, wn):
            if re.fullmatch(r"[-+]?\d+", b):
                assert a == b, (g, w)  # counts and shapes exactly
            elif g.startswith("cross-level"):
                assert abs(float(a) - float(b)) <= 1e-12
            else:
                assert float(a) == pytest.approx(float(b), rel=1e-6), (g, w)
    assert "PASSED" in got[-4]
    r0 = float(NUM.findall(got[-3])[0])
    r1 = float(NUM.findall(got[-2])[1])  # after "after 30"
    assert r1 < r0
    assert got[-1] == f"Debug solution saved in {tv}"
    (pj, cj, uj), (pt, ct, ut) = _vtu(jv), _vtu(tv)
    assert np.array_equal(pt, pj) and np.array_equal(ct, cj)
    assert pt.size == 3 * n * n
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-9 * np.abs(uj).max())


def test_amg_debug_without_a_card_asks_for_device_cpu(tmp_path, capsys,
                                                     monkeypatch):
    mesh = str(tmp_path / "square.msh")
    write_msh(mesh, structured_unit_square_mesh(9))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert tdbg.main(["-mesh", mesh]) == 1
    assert "-device cpu" in capsys.readouterr().out
    assert not (tmp_path / "debug_output.vtu").exists()
    with pytest.raises(SystemExit):
        tdbg.main(["-mesh", mesh, "-device", "tpu"])


def test_coarse_smooth_is_mc_gs_sweeps():
    """The harness's coarse smoothing is ``sweeps`` calls of
    ``mc_gs_sweep`` on the one-level solver's colour blocks."""
    from multigrid_prj_tpu_torch.amg import AMGSolver, mc_gs_sweep
    from multigrid_prj_tpu_torch.models.fem import assemble_p1

    A, rhs = assemble_p1(structured_unit_square_mesh(9))
    s = AMGSolver(A, num_levels=1, smoother="mcgs", use_pallas=False,
                  reorder="none", device="cpu")
    lvl = s.levels[0]
    assert len(lvl.color_blocks) > 1
    b = torch.from_numpy(rhs)
    x = tdbg.coarse_smooth(lvl, torch.zeros_like(b), b, 3)
    want = torch.zeros_like(b)
    for _ in range(3):
        want = mc_gs_sweep(lvl, want, b)
    assert torch.equal(x, want)
    assert s.residual_norm(x, rhs) < s.residual_norm(np.zeros_like(rhs), rhs)
    assert s._coarse_dense_dev is None  # no cycle ran: no bottom inverse
