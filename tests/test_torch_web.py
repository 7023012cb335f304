"""The port's web server (``multigrid_prj_tpu_torch/web/server.py``, on the
CPU) and the JAX package's, side by side on port 0: the same form fields
and option values, the chart script, the same JSON answer for the
``tests/test_aux.py`` request (n 9, 3 levels, test 1, sawtooth GS) and for
``smt`` 1 (Jacobi), ``smt`` 2 (BiCGSTAB preconditioned by one multigrid
step) and ``cycle=v`` at 33^2, the same downloads, the same range error.

Both solve in f64 to 1e-11 (the JAX server under x64 on the CPU, the port
on the CPU).  The iteration counts (11, 607, 4, 7) and ``converged`` are
equal; the histories are held to ``rtol=1e-8, atol=1e-12`` (measured:
7.9e-15 absolute at most, in the Jacobi request's 607 iterations, where the
entries above 1e-8 differ by up to 3.9e-7 relative), and ``x.mtx`` to 1e-9
of its maximum (measured 7.9e-15).
"""

import http.client
import json
import re
import threading
import urllib.parse
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from multigrid_prj_tpu.web import server as jserver
from multigrid_prj_tpu_torch.web import server as tserver

torch.set_num_threads(1)

REQUESTS = {
    "aux": {"n": 9, "a": 10.0, "w": 10.0, "ml": 3, "test": 1, "smt": 0,
            "cycle": "sawtooth"},
    "jacobi": {"n": 9, "ml": 3, "test": 1, "smt": 1},
    "bicgstab": {"n": 9, "ml": 3, "test": 2, "smt": 2},
    "v": {"n": 9, "ml": 3, "test": 0, "smt": 0, "cycle": "v"},
}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX and the port server, each in a thread with its own workdir."""
    saved = (jserver.Handler.workdir, tserver.Handler.workdir,
             tserver.Handler.device)
    jserver.Handler.workdir = str(tmp_path_factory.mktemp("jax"))
    tserver.Handler.workdir = str(tmp_path_factory.mktemp("port"))
    tserver.Handler.device = "cpu"
    out, threads = {}, []
    for name, mod in (("jax", jserver), ("port", tserver)):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), mod.Handler)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        out[name] = srv
        threads.append(th)
    yield {k: v.server_address for k, v in out.items()}
    for srv in out.values():
        srv.shutdown()
        srv.server_close()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    (jserver.Handler.workdir, tserver.Handler.workdir,
     tserver.Handler.device) = saved


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _post(addr, form):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request("POST", "/run", body=urllib.parse.urlencode(form),
                     headers={"Content-Type":
                              "application/x-www-form-urlencoded"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _form_surface(page: str):
    """Field names, option values per select, and the script's functions."""
    names = re.findall(r'name="(\w+)"', page)
    selects = {m[0]: re.findall(r'<option(?: value="(\d+)")?>([^<]*)</option>',
                                m[1])
               for m in re.findall(r'<select name="(\w+)">(.*?)</select>',
                                   page, re.S)}
    values = {k: [v or text for v, text in opts] for k, opts in selects.items()}
    script = page[page.index("<script>"):]
    return names, values, script


def test_form_page_matches_jax(servers):
    (sj, pj), (st, pt) = (_get(servers[k], "/") for k in ("jax", "port"))
    assert sj == st == 200
    nj, vj, scj = _form_surface(pj.decode())
    nt, vt, sct = _form_surface(pt.decode())
    assert nt == nj == ["n", "a", "w", "ml", "test", "smt", "cycle"]
    assert vt == vj
    assert vt["test"] == ["0", "1", "2"] and vt["smt"] == ["0", "1", "2"]
    assert vt["cycle"] == ["sawtooth", "v", "w"]
    assert sct == scj and "drawChart" in sct
    assert _get(servers["port"], "/nothing")[0] == 404


@pytest.mark.parametrize("name", list(REQUESTS))
def test_run_matches_jax(servers, name):
    (sj, want), (st, got) = (_post(servers[k], REQUESTS[name])
                             for k in ("jax", "port"))
    assert sj == st == 200
    assert "error" not in got and "error" not in want, (got, want)
    assert sorted(got) == sorted(want)
    assert got["iterations"] == want["iterations"]
    assert got["converged"] == want["converged"]
    assert len(got["history"]) == got["iterations"] + 1
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-8,
                               atol=1e-12)
    assert got["final_residual"] == got["history"][-1]
    assert got["solve_time"] > 0
    if name == "aux":
        assert got["converged"] and got["final_residual"] < 1e-10
    files = {}
    for k in ("jax", "port"):
        for path in ("/MGGS4.txt", "/x.mtx"):
            code, body = _get(servers[k], path)
            assert code == 200
            v = np.array(body.split(), dtype=float)
            assert v[0] == v.size - 1
            files[k, path] = v[1:]
    # each server's history file is its answer's history
    np.testing.assert_array_equal(files["port", "/MGGS4.txt"], got["history"])
    np.testing.assert_array_equal(files["jax", "/MGGS4.txt"], want["history"])
    xt, xj = files["port", "/x.mtx"], files["jax", "/x.mtx"]
    assert xt.size == xj.size == 33 * 33
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9 * np.abs(xj).max())


def test_range_error_matches_jax(servers):
    for form in ({"n": 999999, "ml": 3}, {"n": 1, "ml": 1}):
        (_, want), (_, got) = (_post(servers[k], form)
                               for k in ("jax", "port"))
        assert got == want and "range" in got["error"]


def test_run_solver_on_the_card_without_one_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-device cpu"):
        tserver.run_solver({"n": 9, "ml": 2}, str(tmp_path))
    assert not any(tmp_path.iterdir())


def test_main_without_a_card_fails_at_start(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tserver.main(["--port", "0"]) == 1
    assert "--device cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserver.main(["--device", "tpu"])
