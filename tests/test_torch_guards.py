"""The port's numerical guards (``multigrid_prj_tpu_torch/utils/guards.py``)
against the JAX package's on the same numpy inputs: ``count_nonfinite``
counts exactly alike (and stays a tensor on the input's device),
``check_finite`` and ``guard_solve_io`` raise the same messages word for
word, and a guarded port solve refuses a poisoned right-hand side before
any kernel call."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_prj_tpu.utils import guards as jguards
from multigrid_prj_tpu_torch.gmg import GMGSolver
from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.utils import guards as tguards

torch.set_num_threads(1)


def _inputs():
    """Seeded numpy arrays with 0, 1 and many non-finite entries."""
    rng = np.random.default_rng(0)
    out = []
    for dtype in (np.float32, np.float64):
        a = rng.standard_normal((7, 9)).astype(dtype)
        b = a.copy()
        b[3, 4] = np.nan
        c = a.copy().reshape(-1)
        idx = rng.choice(c.size, 17, replace=False)
        c[idx[:6]] = np.nan
        c[idx[6:12]] = np.inf
        c[idx[12:]] = -np.inf
        out += [a, b, c]
    return out


@pytest.mark.parametrize("k", range(6))
def test_count_nonfinite_matches_jax(k):
    x = _inputs()[k]
    got = tguards.count_nonfinite(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dim() == 0
    assert int(got) == int(jguards.count_nonfinite(jnp.asarray(x)))
    # numpy in, as the JAX function takes it
    assert int(tguards.count_nonfinite(x)) == int(got)


def _message(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("k", [1, 2, 4, 5])
def test_check_finite_messages_match_jax(k):
    x = _inputs()[k]
    want = _message(jguards.check_finite, x, "rhs b")
    assert _message(tguards.check_finite, x, "rhs b") == want
    assert _message(tguards.check_finite, torch.from_numpy(x), "rhs b") == want
    assert _message(tguards.check_finite, x) == _message(jguards.check_finite, x)
    tguards.check_finite(_inputs()[0], "ok")  # no raise
    tguards.check_finite(torch.from_numpy(_inputs()[3]), "ok")


def fake_solve(b, u0=None, out=None):
    """A solve entry point returning ``out`` as its ``u``."""
    return types.SimpleNamespace(u=b if out is None else out, x=None)


@pytest.mark.parametrize("case", ["positional", "keyword", "result", "clean"])
def test_guard_solve_io_matches_jax(case):
    clean, poisoned = _inputs()[3], _inputs()[5]
    args, kwargs = {
        "positional": ((poisoned,), {}),
        "keyword": ((clean,), {"u0": poisoned}),
        "result": ((clean,), {"out": poisoned}),
        "clean": ((clean,), {"u0": clean}),
    }[case]
    jfn, tfn = jguards.guard_solve_io(fake_solve), tguards.guard_solve_io(
        fake_solve)
    assert tfn.__name__ == jfn.__name__ == "fake_solve"
    if case == "clean":
        assert tfn(*args, **kwargs).u is clean
        return
    want = _message(lambda: jfn(*args, **kwargs))
    assert _message(lambda: tfn(*args, **kwargs)) == want
    targs = tuple(torch.from_numpy(a) for a in args)
    tkw = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    assert _message(lambda: tfn(*targs, **tkw)) == want


def test_guarded_port_solve_refuses_nan_rhs_before_any_kernel():
    s = GMGSolver(shape=(33, 33), num_levels=3, maxit=2, use_pallas=True,
                  device="cpu")
    b = assemble_rhs(s.levels[0], 10.0, test=0, dtype=torch.float32,
                     device="cpu")
    solve = tguards.guard_solve_io(s.solve)
    assert solve(b).iterations == 2
    bad = b.clone()
    bad[5, 5] = float("nan")
    cs.reset_launch_counts()
    with pytest.raises(ValueError, match="argument 0 of GMGSolver.solve"):
        solve(bad)
    assert not any(cs.LAUNCHES.values())
