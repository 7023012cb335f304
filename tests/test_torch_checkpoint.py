"""Checkpoint / resume (``multigrid_prj_tpu_torch/utils/checkpoint.py``)
across the two packages, on the 33^2, 3-level f64 sawtooth problem of
``tests/test_aux.py``: the JAX writer's ``.npz`` loads and resumes in the
port, the port's loads and resumes in JAX, the files hold the same keys,
dtypes and config bytes, and every resume agrees with the JAX
``resume_solve`` of the same file.

Tolerances (f64, the same iterations on both sides): histories to
``rtol=1e-8, atol=1e-12`` (measured: 6.5e-16 relative at most, 8
iterations each; the late entries near 1e-11 are ratios of round-off-level
residuals, which other BLAS or compilers move by more), ``u`` to ``1e-9``
of its maximum (measured: equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_prj_tpu import gmg as jgmg
from multigrid_prj_tpu.models import poisson as jpoisson
from multigrid_prj_tpu.utils import checkpoint as jck
from multigrid_prj_tpu_torch import gmg as tgmg
from multigrid_prj_tpu_torch.models import poisson as tpoisson
from multigrid_prj_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

KW = dict(shape=(33, 33), num_levels=3, tol=1e-11)
CONFIG = {"n": 33, "levels": 3, "cycle": "sawtooth"}


def _jax(maxit):
    s = jgmg.GMGSolver(maxit=maxit, **KW)
    return s, jpoisson.assemble_rhs(s.levels[0], 10.0, test=0,
                                    dtype=jnp.float64)


def _port(maxit):
    s = tgmg.GMGSolver(maxit=maxit, device="cpu", **KW)
    return s, tpoisson.assemble_rhs(s.levels[0], 10.0, test=0,
                                    dtype=torch.float64, device="cpu")


def _close(got, want):
    assert got.iterations == want.iterations and got.converged == want.converged
    np.testing.assert_allclose(got.history, np.asarray(want.history),
                               rtol=1e-8, atol=1e-12)
    gu, wu = got.u.numpy(), np.asarray(want.u)
    np.testing.assert_allclose(gu, wu, rtol=0, atol=1e-9 * np.abs(wu).max())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """Write after 3 iterations with one package, resume with both."""
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        s, b = _jax(3)
        part = s.solve(b)
        jck.save_checkpoint(path, part.u, b, part.history, config=CONFIG,
                            level_shapes=np.array([33, 17, 9]))
    else:
        s, b = _port(3)
        part = s.solve(b)
        tck.save_checkpoint(path, part.u, b, part.history, config=CONFIG,
                            level_shapes=torch.tensor([33, 17, 9]))
    assert part.iterations == 3
    for load in (jck.load_checkpoint, tck.load_checkpoint):
        state = load(path)
        assert state["config"] == CONFIG
        assert state["u"].dtype == state["b"].dtype == np.float64
        assert state["u"].shape == (33, 33) and state["history"].shape == (4,)
        np.testing.assert_array_equal(state["level_shapes"], [33, 17, 9])
    with np.load(path) as z:
        assert sorted(z.files) == ["b", "config", "history", "level_shapes",
                                   "u"]
        assert z["config"].dtype == np.uint8
    want = jck.resume_solve(_jax(1000)[0], path)
    got = tck.resume_solve(_port(1000)[0], path)
    assert isinstance(got.history, np.ndarray) and len(got.history) == (
        3 + got.iterations + 1)
    assert got.u.device.type == "cpu" and got.u.dtype == torch.float64
    _close(got, want)
    assert want.converged


def test_checkpoint_files_match_byte_layout(tmp_path):
    """The same state written by both writers: equal arrays under equal
    keys, equal config bytes."""
    s, b = _port(3)
    part = s.solve(b)
    tck.save_checkpoint(str(tmp_path / "t.npz"), part.u, b, part.history,
                        config=CONFIG)
    jck.save_checkpoint(str(tmp_path / "j.npz"), part.u.numpy(), b.numpy(),
                        part.history, config=CONFIG)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert t.files == j.files
        for k in t.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_resume_equals_uninterrupted_solve(tmp_path):
    """Resumed from 3 iterations with maxit 5: the merged history and u
    equal an uninterrupted maxit 8 solve bit for bit (one device, one
    order of operations)."""
    s, b = _port(3)
    part = s.solve(b)
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, part.u, b, part.history)
    got = tck.resume_solve(_port(5)[0], path)
    want = _port(8)[0].solve(b)
    assert len(got.history) == 9 and want.iterations == 8
    np.testing.assert_array_equal(got.history, want.history)
    assert torch.equal(got.u, want.u)
