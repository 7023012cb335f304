"""The lane-quad / row-strip walk of the prolong-add stream of
``csrc/stencil2d.cu`` (``prolong_add_stream_kernel``), emulated in plain
torch on the CPU and held to the kernel's twin
``prolong_add_padded_fast_plain`` (``u + transfer.prolong_padded(e)``).

The emulation reads its geometry from ``ops/cuda_stencil.prolong_tile``,
the values the CUDA wrapper hands the kernel.  A lane owns a coarse column
quad q .. q+3 (fine columns 2q .. 2q+7; lanes past the last column load 0);
a warp walks a strip of coarse rows, loading e's row k + 1 (0 past the last
row) and carrying it as the next step's row k; the row value at q + 4 comes
from the next lane by a shuffle, except on the warp's last lane, which
reads its own (0 past the last column).  Equal to the twin bit for bit on
padded levels and on shapes whose coarse column count is no multiple of 4
and whose row count is odd; without the last lane's own read, or without
the zero past the last row, it is not.  The card holds the kernel to the
same twin and to the one-thread-per-point kernel in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(1)

WARP = 32
# coarse shapes (e); the fine ones (u) are twice: padded levels of the
# 1025^2 and 8193^2 hierarchies (fine 160 .. 40 and 264 .. 66), and shapes
# with pc_c % 4 != 0 and pc_r odd, two warps across (pc_c > 128) or one
SHAPES = [(80, 80), (40, 40), (20, 20), (128, 192), (132, 132), (66, 66),
          (33, 33), (65, 190), (17, 150), (9, 6), (1, 130)]


def _inputs(pc, seed):
    rng = np.random.default_rng(seed)
    e = torch.from_numpy(rng.standard_normal(pc).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(
        (2 * pc[0], 2 * pc[1])).astype(np.float32))
    return e, u


def _half(a, b):
    return 0.5 * (a + b)


def emulate_stream(e, u, own_read=True, zero_past_last_row=True):
    """The kernel's walk, every lane at once: ``(lanes, 4)`` quads; the
    warps of a strip are independent, each lane's quad q = 4 * lane."""
    strip, quads = cs.prolong_tile()
    pc_r, pc_c = e.shape
    nq = -(-pc_c // 4)
    lanes = -(-nq // quads) * quads  # whole blocks across
    cols = 4 * lanes + 4  # one more quad: the last lane's read of q + 4
    ez = torch.zeros((pc_r, cols))
    ez[:, :pc_c] = e
    last = (torch.arange(lanes) % WARP) == WARP - 1

    def row(k):
        """e's row k as the lanes load it: their quads and, on the warp's
        last lanes, the value at q + 4."""
        if k >= pc_r:  # past the last row
            return torch.zeros((lanes, 4)), torch.zeros(lanes)
        q = ez[k, :4 * lanes].reshape(lanes, 4)
        return q, ez[k, 4::4][:lanes] * last

    def shuffle_down(v):
        """``__shfl_down_sync(v, 1)`` within each warp: the last lane gets
        its own value."""
        w = v.reshape(-1, WARP)
        return torch.cat([w[:, 1:], w[:, -1:]], dim=1).reshape(-1)

    def fine(rv, r4):
        f = [rv[:, 0], _half(rv[:, 0], rv[:, 1]), rv[:, 1],
             _half(rv[:, 1], rv[:, 2]), rv[:, 2], _half(rv[:, 2], rv[:, 3]),
             rv[:, 3], _half(rv[:, 3], r4)]
        return torch.stack(f, dim=1).reshape(-1)[:2 * pc_c]

    out = torch.empty_like(u)
    for k0 in range(0, pc_r, strip):
        cur, cur4 = row(k0)
        for k in range(k0, min(k0 + strip, pc_r)):
            nxt, nxt4 = row(k + 1) if (k + 1 < pc_r or zero_past_last_row) \
                else row(0)
            r4 = shuffle_down(cur[:, 0])
            if own_read:
                r4 = torch.where(last, cur4, r4)
            out[2 * k] = u[2 * k] + fine(cur, r4)
            mid = _half(cur, nxt)
            r4 = shuffle_down(mid[:, 0])
            if own_read:
                r4 = torch.where(last, _half(cur4, nxt4), r4)
            out[2 * k + 1] = u[2 * k + 1] + fine(mid, r4)
            cur, cur4 = nxt, nxt4
    return out


@pytest.mark.parametrize("pc", SHAPES)
def test_stream_equals_twin(pc):
    e, u = _inputs(pc, seed=pc[0] * 1000 + pc[1])
    want = cs.prolong_add_padded_fast_plain(e, u)
    assert torch.equal(emulate_stream(e, u), want)


def test_without_the_last_lanes_read_it_differs():
    """The warp's last lane must read its own value at q + 4: the shuffle
    gives it its own quad's first value instead."""
    e, u = _inputs((65, 190), seed=1)
    want = cs.prolong_add_padded_fast_plain(e, u)
    assert not torch.equal(emulate_stream(e, u, own_read=False), want)


def test_without_the_zero_past_the_last_row_it_differs():
    e, u = _inputs((33, 66), seed=2)
    want = cs.prolong_add_padded_fast_plain(e, u)
    assert not torch.equal(
        emulate_stream(e, u, zero_past_last_row=False), want)


def test_geometry_and_the_c_source_agree():
    """The geometry the wrapper passes is the one the CUDA source compiles
    (the C entry point refuses others): strips of 2 coarse rows, a warp of
    quads per block across, 8 strips down."""
    strip, quads = cs.prolong_tile()
    assert (strip, quads) == (2, 32)
    src = _build.SOURCES[0].read_text()
    assert f"constexpr int kPaStrip = {strip};" in src
    assert f"constexpr int kPaQuads = {quads};" in src
    assert "constexpr int kPaThreads = 256;" in src


def test_cpu_wrapper_runs_the_twin_and_launches_nothing():
    """On the CPU the prolong-add runs its twin and counts no launch; the
    point kernel (the stream's oracle) launches CUDA kernels only."""
    e, u = _inputs((33, 66), seed=3)
    u0 = u.clone()
    cs.reset_launch_counts()
    got = cs.prolong_add_padded_fast(e, u)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert torch.equal(u, u0)
    assert torch.equal(got, cs.prolong_add_padded_fast_plain(e, u))
    with pytest.raises(ValueError, match="CUDA kernels only"):
        cs._prolong_add_point(e, u)


def test_strip_probe_needs_the_card(monkeypatch, capsys):
    """The strip-height probe (``benchmarks/prolong_tile_rows.py``) builds
    and times CUDA kernels only: without a card it exits non-zero, builds
    nothing and names the reason."""
    from multigrid_prj_tpu_torch.benchmarks import prolong_tile_rows as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["8"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert probe._ANCHOR in probe._build.SOURCES[0].read_text()
