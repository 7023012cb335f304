"""The ``native_parity`` fixture of the port-vs-JAX tests whose results
depend on the ``native/`` library (``test_torch_sparse.py``,
``test_torch_amg.py``, ``test_torch_fem.py``, ``test_torch_amg_cli.py``).
Each imports it and names it in ``pytestmark = pytest.mark.usefixtures(
"native_parity")``, so a module that drops the import fails with "fixture
not found" instead of running unprotected."""

import os
import time

import pytest

from multigrid_prj_tpu import native as jnative
from multigrid_prj_tpu_torch import native as tnative


@pytest.fixture(scope="module")
def native_parity():
    """Both packages on the ``native/`` library, or both on the fallback.

    On a fresh checkout several pytest workers load ``native/`` at once and
    its Makefile links straight onto the library, so a loader may meet a
    half-written file and fall back for the life of its process (the build
    race).  Build to completion under the port's lock, reload whichever
    package came out without the library while a whole file is in place (a
    JAX-side build still writing it gets half a second per retry to
    finish), and require both alike: hierarchy parity depends on which
    path runs."""
    tnative.ensure_built()
    for _ in range(20):
        for mod in (jnative, tnative):
            if mod._lib is None and tnative._complete(mod._SO):
                mod._tried = False
        if not os.path.exists(tnative._SO) or (jnative.available()
                                               and tnative.available()):
            break
        time.sleep(0.5)
    assert jnative.available() == tnative.available(), (
        f"native/ build race: JAX loader {jnative.available()}, port loader "
        f"{tnative.available()} on {tnative._SO}")
