// 2D Poisson stencil and grid-transfer kernels for Hopper (sm_90a): every
// kernel of the padded GMG V-cycle, its ff32 refinement and fused down-leg,
// the inner_cg apply, the Jacobi smoother, the apply chain, the single
// colour sweep and the sharded solver's smoother, in this one source file.
//
// Ports of the Pallas TPU kernels in multigrid_prj_tpu/ops/pallas_stencil.py:
//   rbgs_fused  <- red_black_gauss_seidel (_rbgs_fused_kernel /
//                  _rbgs_fused2d_kernel, shared body _fused_rbgs_passes):
//                  up to 4 sweeps per launch, as the TPU's contract
//   rbgs_color  <- the same, one colour per launch: the per-colour oracle
//                  that the fused tiles are held to (no solver path)
//   residual    <- poisson_residual (_residual_kernel)
//   ff_residual <- ff_poisson_residual (_ff_residual_kernel)
//   ff_update_residual <- the same, fused with the refined solve's pair
//                  update (ff_accumulate, an XLA op on the TPU)
//   apply       <- poisson_apply (_apply_kernel / _apply_carry_kernel)
//   jacobi_fused <- jacobi (_jacobi_fused_kernel / _jacobi_fused2d_kernel,
//                  shared body _fused_jacobi_passes): up to 8 sweeps per
//                  launch, as the TPU's contract
//   jacobi      <- the same, one sweep per launch: the per-sweep oracle that
//                  the fused tile is held to (no solver path)
//   restrict_fw <- restrict_fw_padded_fast (_fw_filter2d_kernel plus the
//                  wrapper's decimation and edge fix-up)
//   prolong_add_stream <- prolong_add_padded_fast (_prolong_add_kernel): a
//                  lane per coarse column quad walking a strip of rows
//   prolong_add <- the same, one thread per fine point: the oracle of the
//                  stream (no solver path)
//   rbgs_resfilter   <- rbgs_residual_restrict (_rbgs_resfilter_kernel plus
//                       the wrapper's decimation fw_decimate_padded)
//   apply_chain      <- poisson_apply_chain (_apply_fused_kernel /
//                       _apply_fused2d_kernel, shared body
//                       _fused_apply_passes): up to 8 applies per launch
//   rbgs_color_sweep <- rbgs_color_sweep (_rbgs_color_kernel)
//   rbgs_fused_ext   <- rbgs_fused_extended (_rbgs_fused_offset_kernel,
//                       shared body _fused_rbgs_passes)
//
// Layout: one thread per output point of a row-major f32 array, on a 2D grid
// of blocks, with 64-bit offsets.  For the stencils (nl, ml) are the logical
// extents: a point is boundary if it is on row 0 or column 0 or at/beyond
// nl-1 / ml-1, which pins the padded dead zone.  Boundary points never read
// neighbours and every array-edge point is a boundary point, so no read
// leaves the array and no halo or clamping is needed.  Any 2D shape is
// accepted (the TPU's (8, 128) alignment is not needed).
//
// Arithmetic: every add and multiply is an explicit round-to-nearest
// intrinsic (__fadd_rn / __fmul_rn), which nvcc never contracts into an FMA
// (the file is also built with -fmad=false).  The op order matches the
// torch twins in ops/cuda_stencil.py, so each kernel is bit-equal to its
// twin.
//
// The single-pass kernels are simple first versions with no shared-memory
// tiling: each streams its operands from HBM once per launch and is bound by
// memory bandwidth (bytes per point are noted at each kernel); the
// prolong-add streams float4 rows (prolong_add_stream_kernel).  The
// temporally fused kernels keep a halo tile in shared memory: the red-black
// smoother, the down-leg and the sharded smoother on the colour-split tile
// described above rbgs_fused_kernel, the apply chain and the Jacobi smoother
// on the row-walking tile described above apply_chain_kernel and
// jacobi_fused_kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ bool is_boundary(int i, int j, int nl, int ml) {
  return i == 0 || j == 0 || i >= nl - 1 || j >= ml - 1;
}

// One colour half-sweep of red-black Gauss-Seidel, in place on u: the
// per-colour oracle of the fused tiles below (ops/cuda_stencil.
// _rbgs_per_colour), on no solver path.
// 12 B/point: read b and the other colour's neighbours, write this colour.
//
// A launch writes ONLY points of its own colour: boundary points of the
// colour are pinned to b, interior points get
//   (b*inv_c + N + S + E + W) * 0.25   (summed left to right).
// Interior points read only the other colour, so no point is both read and
// written in one launch.  The TPU pass pins boundary points of both colours
// in colour 0, but computes colour 0 from the values before that pin, and
// the other colour's boundary points are next read after colour 1 has pinned
// them here; so after each full sweep the result is bit-identical.
__global__ void rbgs_color_kernel(float* __restrict__ u,
                                  const float* __restrict__ b, int n, int m,
                                  int nl, int ml, float inv_c, int color) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m || ((i + j) & 1) != color) return;
  const long long p = (long long)i * m + j;
  if (is_boundary(i, j, nl, ml)) {
    u[p] = b[p];
    return;
  }
  float s = __fmul_rn(b[p], inv_c);
  s = __fadd_rn(s, u[p - m]);  // north
  s = __fadd_rn(s, u[p + m]);  // south
  s = __fadd_rn(s, u[p + 1]);  // east
  s = __fadd_rn(s, u[p - 1]);  // west
  u[p] = __fmul_rn(s, 0.25f);
}

// r = b - (boundary ? u : c*((((4u - N) - S) - E) - W)).
// 12 B/point: read u and b, write r (neighbour reads hit L1/L2).
__global__ void residual_kernel(const float* __restrict__ u,
                                const float* __restrict__ b,
                                float* __restrict__ r, int n, int m, int nl,
                                int ml, float c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m) return;
  const long long p = (long long)i * m + j;
  const float uc = u[p];
  float a;
  if (is_boundary(i, j, nl, ml)) {
    a = uc;
  } else {
    float t = __fmul_rn(4.0f, uc);
    t = __fsub_rn(t, u[p - m]);  // north
    t = __fsub_rn(t, u[p + m]);  // south
    t = __fsub_rn(t, u[p + 1]);  // east
    t = __fsub_rn(t, u[p - 1]);  // west
    a = __fmul_rn(c, t);
  }
  r[p] = __fsub_rn(b[p], a);
}

// Knuth two-sum, then the fast-two-sum normalisation of ops/extended.ff_add.
__device__ __forceinline__ void ff_add(float xh, float xl, float yh, float yl,
                                       float* oh, float* ol) {
  const float s = __fadd_rn(xh, yh);
  const float bb = __fsub_rn(s, xh);
  float e = __fadd_rn(__fsub_rn(xh, __fsub_rn(s, bb)), __fsub_rn(yh, bb));
  e = __fadd_rn(e, __fadd_rn(xl, yl));
  const float s2 = __fadd_rn(s, e);
  *oh = s2;
  *ol = __fsub_rn(e, __fsub_rn(s2, s));
}

// Float-float residual with u = (uh, ul) and d = b/c = (dh, dl) as pairs:
// acc = 4u; acc += -nb for nb in (S, N, E, W); t = d - acc;
// interior r = c*t_hi + c*t_lo, boundary r = (b - uh) - ul.
// 24 B/point: read uh, ul, dh, dl, b, write r.
__global__ void ff_residual_kernel(const float* __restrict__ uh,
                                   const float* __restrict__ ul,
                                   const float* __restrict__ dh,
                                   const float* __restrict__ dl,
                                   const float* __restrict__ b,
                                   float* __restrict__ r, int n, int m, int nl,
                                   int ml, float c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m) return;
  const long long p = (long long)i * m + j;
  if (is_boundary(i, j, nl, ml)) {
    r[p] = __fsub_rn(__fsub_rn(b[p], uh[p]), ul[p]);
    return;
  }
  float ah = __fmul_rn(4.0f, uh[p]);
  float al = __fmul_rn(4.0f, ul[p]);
  const long long nb[4] = {p + m, p - m, p + 1, p - 1};  // S, N, E, W
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ff_add(ah, al, -uh[nb[k]], -ul[nb[k]], &ah, &al);
  }
  float th, tl;
  ff_add(dh[p], dl[p], -ah, -al, &th, &tl);
  r[p] = __fadd_rn(__fmul_rn(c, th), __fmul_rn(c, tl));
}

// Pair + float, ops/extended.ff_add_f: two-sum of xh and y, + xl, then the
// fast-two-sum normalisation.
__device__ __forceinline__ void ff_add_f(float xh, float xl, float y,
                                         float* oh, float* ol) {
  const float s = __fadd_rn(xh, y);
  const float bb = __fsub_rn(s, xh);
  float e = __fadd_rn(__fsub_rn(xh, __fsub_rn(s, bb)), __fsub_rn(y, bb));
  e = __fadd_rn(e, xl);
  const float s2 = __fadd_rn(s, e);
  *oh = s2;
  *ol = __fsub_rn(e, __fsub_rn(s2, s));
}

// The refined solve's pair update and the float-float residual of the
// updated pair in one pass: (uh2, ul2) = ff_add_f(uh, ul, e) at every point
// (boundary and dead zone too, as ops/extended.ff_accumulate), then
// ff_residual_kernel's chain on (uh2, ul2).  A thread updates the pair at
// its point and at its 4 neighbours (5 updates of ~10 operations, recomputed
// where ff_residual_kernel reads a neighbour), so the output pair is out of
// place: uh2 and ul2 must not alias uh, ul or e.
// 36 B/point: read uh, ul, e, dh, dl, b, write uh2, ul2, r (28 B at
// boundary points, which read no d).
__global__ void ff_update_residual_kernel(
    const float* __restrict__ uh, const float* __restrict__ ul,
    const float* __restrict__ e, const float* __restrict__ dh,
    const float* __restrict__ dl, const float* __restrict__ b,
    float* __restrict__ uh2, float* __restrict__ ul2, float* __restrict__ r,
    int n, int m, int nl, int ml, float c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m) return;
  const long long p = (long long)i * m + j;
  float ch, cl;
  ff_add_f(uh[p], ul[p], e[p], &ch, &cl);
  uh2[p] = ch;
  ul2[p] = cl;
  if (is_boundary(i, j, nl, ml)) {
    r[p] = __fsub_rn(__fsub_rn(b[p], ch), cl);
    return;
  }
  float ah = __fmul_rn(4.0f, ch);
  float al = __fmul_rn(4.0f, cl);
  const long long nb[4] = {p + m, p - m, p + 1, p - 1};  // S, N, E, W
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float vh, vl;
    ff_add_f(uh[nb[k]], ul[nb[k]], e[nb[k]], &vh, &vl);
    ff_add(ah, al, -vh, -vl, &ah, &al);
  }
  float th, tl;
  ff_add(dh[p], dl[p], -ah, -al, &th, &tl);
  r[p] = __fadd_rn(__fmul_rn(c, th), __fmul_rn(c, tl));
}

// y = boundary ? u : c*((((4u - N) - S) - E) - W)  (_apply_kernel :283,
// _apply_carry_kernel :306).  8 B/point: read u, write y.
__global__ void apply_kernel(const float* __restrict__ u,
                             float* __restrict__ y, int n, int m, int nl,
                             int ml, float c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m) return;
  const long long p = (long long)i * m + j;
  const float uc = u[p];
  if (is_boundary(i, j, nl, ml)) {
    y[p] = uc;
    return;
  }
  float t = __fmul_rn(4.0f, uc);
  t = __fsub_rn(t, u[p - m]);  // north
  t = __fsub_rn(t, u[p + m]);  // south
  t = __fsub_rn(t, u[p + 1]);  // east
  t = __fsub_rn(t, u[p - 1]);  // west
  y[p] = __fmul_rn(c, t);
}

// One damped-Jacobi sweep, out of place (x -> y):
//   boundary: b;  interior: jac = (b*inv_c + N + S + E + W) * 0.25 (left to
//   right), then, if damped, (1-omega)*x + omega*jac
// with (1-omega) and omega rounded to f32 on the host (_fused_jacobi_passes).
// The per-sweep oracle of jacobi_fused_kernel<S> (ops/cuda_stencil.
// _jacobi_per_sweep), on no solver path.
// 12 B/point: read x and b, write y.
__global__ void jacobi_kernel(const float* __restrict__ x,
                              const float* __restrict__ b,
                              float* __restrict__ y, int n, int m, int nl,
                              int ml, float inv_c, int damped,
                              float one_minus_omega, float omega) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m) return;
  const long long p = (long long)i * m + j;
  if (is_boundary(i, j, nl, ml)) {
    y[p] = b[p];
    return;
  }
  float s = __fmul_rn(b[p], inv_c);
  s = __fadd_rn(s, x[p - m]);  // north
  s = __fadd_rn(s, x[p + m]);  // south
  s = __fadd_rn(s, x[p + 1]);  // east
  s = __fadd_rn(s, x[p - 1]);  // west
  float jac = __fmul_rn(s, 0.25f);
  if (damped) {
    jac = __fadd_rn(__fmul_rn(one_minus_omega, x[p]), __fmul_rn(omega, jac));
  }
  y[p] = jac;
}

// Axis-0 pass of restrict_fw_padded at coarse row k, fine column j:
// injected at the edge rows, [1/4, 1/2, 1/4] inside (rows k >= nc_r are
// never asked for).
__device__ __forceinline__ float fw_rows(const float* __restrict__ r,
                                         int k, int j, int m, int nc_r) {
  const long long p = (long long)(2 * k) * m + j;
  if (k == 0 || k == nc_r - 1) return r[p];
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, r[p - m]), __fmul_rn(0.5f, r[p])),
                   __fmul_rn(0.25f, r[p + m]));
}

// Full-weighting restriction of the padded layout, fine (n, m) -> coarse
// (n/2, m/2), exactly ops/transfer.restrict_fw_padded: axis 0 first, then
// axis 1 on the axis-0 result; edge coarse rows/columns (k == 0, nc-1) are
// injected and the dead zone (k >= nc) is zero, nc = (logical + 1) / 2.
// One thread per coarse point; its 3x3 fine reads overlap its neighbours'
// in L1/L2, so about 5 B per fine point: read the fine grid once, write a
// quarter.
__global__ void restrict_fw_kernel(const float* __restrict__ r,
                                   float* __restrict__ out, int n, int m,
                                   int nc_r, int nc_c) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y * blockDim.y + threadIdx.y;
  const int mc = m / 2;
  if (k >= n / 2 || q >= mc) return;
  const long long o = (long long)k * mc + q;
  if (k >= nc_r || q >= nc_c) {
    out[o] = 0.0f;
    return;
  }
  if (q == 0 || q == nc_c - 1) {
    out[o] = fw_rows(r, k, 2 * q, m, nc_r);
    return;
  }
  const float w = fw_rows(r, k, 2 * q - 1, m, nc_r);
  const float c = fw_rows(r, k, 2 * q, m, nc_r);
  const float e = fw_rows(r, k, 2 * q + 1, m, nc_r);
  out[o] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, w), __fmul_rn(0.5f, c)),
                     __fmul_rn(0.25f, e));
}

// Row pass of prolong_padded at fine row i, coarse column q (q < pc_c):
// e[k, q] on even rows, 0.5*(e[k, q] + e[k+1, q]) on odd rows, with a zero
// shifted in past the last coarse row.
__device__ __forceinline__ float prolong_rows(const float* __restrict__ e,
                                              int i, int q, int pc_r,
                                              int pc_c) {
  const int k = i >> 1;
  const float a = e[(long long)k * pc_c + q];
  if ((i & 1) == 0) return a;
  const float nxt = (k + 1 < pc_r) ? e[(long long)(k + 1) * pc_c + q] : 0.0f;
  return __fmul_rn(0.5f, __fadd_rn(a, nxt));
}

// out = u + prolong_padded(e), coarse (pc_r, pc_c) -> fine (2 pc_r, 2 pc_c):
// rows first, then columns (R(pc_c) = 0), as ops/transfer.prolong_padded.
// One thread per fine point: the oracle of prolong_add_stream_kernel below
// (ops/cuda_stencil._prolong_add_point), on no solver path.  About 9 B per
// fine point: read u, write out, read e (a quarter of the points).
__global__ void prolong_add_kernel(const float* __restrict__ e,
                                   const float* __restrict__ u,
                                   float* __restrict__ out, int pc_r,
                                   int pc_c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int m = 2 * pc_c;
  if (i >= 2 * pc_r || j >= m) return;
  const int q = j >> 1;
  float v = prolong_rows(e, i, q, pc_r, pc_c);
  if (j & 1) {
    const float nxt = (q + 1 < pc_c) ? prolong_rows(e, i, q + 1, pc_r, pc_c)
                                     : 0.0f;
    v = __fmul_rn(0.5f, __fadd_rn(v, nxt));
  }
  const long long p = (long long)i * m + j;
  out[p] = __fadd_rn(u[p], v);
}

// One colour of Gauss-Seidel, out of place (u -> out), as _rbgs_color_kernel:
// every boundary point (of either colour) gets b, interior points of this
// colour (b / c + N + S + E + W) * 0.25 -- a true division, where the fused
// smoothers multiply by 1/c -- and the other colour keeps u.  Out of place
// because the pin of the other colour's boundary points would race with
// this colour's neighbour reads in place.  12 B/point: read u and b, write
// out.
__global__ void rbgs_color_sweep_kernel(const float* __restrict__ u,
                                        const float* __restrict__ b,
                                        float* __restrict__ out, int n, int m,
                                        int nl, int ml, float c, int color) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= m) return;
  const long long p = (long long)i * m + j;
  if (is_boundary(i, j, nl, ml)) {
    out[p] = b[p];
    return;
  }
  if (((i + j) & 1) != color) {
    out[p] = u[p];
    return;
  }
  float s = __fdiv_rn(b[p], c);
  s = __fadd_rn(s, u[p - m]);  // north
  s = __fadd_rn(s, u[p + m]);  // south
  s = __fadd_rn(s, u[p + 1]);  // east
  s = __fadd_rn(s, u[p - 1]);  // west
  out[p] = __fmul_rn(s, 0.25f);
}

// ---------------------------------------------------------------------------
// The ring argument of pallas_stencil.py (_rbgs_resfilter_kernel, :507-509;
// _apply_fused_kernel, :875-882), on which the temporally fused kernels
// below rest: a pass that updates a cell from its four neighbours cannot
// update the tile's outermost ring (its neighbours are not loaded), so each
// dependent pass leaves one more ring stale, counted from the tile's edge.
// After p passes rings 0 .. p-1 may be wrong and every cell at distance >= p
// from the edge holds exactly what p separate launches give.  Cells outside
// the array are loaded as 0 and never updated; only boundary points (which
// read no neighbour) sit next to them, so no interior point ever reads one.
// Every op is the separate kernels' op in the same order, so the core is
// bit-equal to them.
//
// The sharded smoother's extended slab carries kHalo halo rows above and
// below (ops/cuda_stencil._EXT_HALO): room for 2 x 4 dependent passes.
constexpr int kHalo = 8;

// ---------------------------------------------------------------------------
// The colour-split red-black tile: rbgs_fused_kernel<SWEEPS> (the smoother,
// up to 4 sweeps per launch: _rbgs_fused_kernel's contract, replacing 2 x
// SWEEPS rbgs_color launches and the clone of u),
// rbgs_resfilter_kernel<SWEEPS> (the down-leg, up to 3 sweeps, the residual
// and the restriction) and rbgs_fused_ext_kernel<SWEEPS> (the sharded
// smoother: the smoother on an extended slab at a global row offset).
//
// Bound: memory.  A 2-sweep smoother call must move 12 B per point (read u
// and b, write the result); the composition it replaces moved 4 x 12 B plus
// the clone's 8 B.  What held the 48 x 48 tile at 7-9x its bound, and what
// this tile does instead:
// * Halo sized to the work.  The tile loses one ring per dependent pass
//   (the ring argument above), so P = 2 x SWEEPS passes (+ 2 for the
//   down-leg's residual and filter) need a row halo of P cells; the column
//   halo is P rounded up to 4, so that tile origins and the core start on
//   16-byte boundaries.  SWEEPS is a template argument: the geometry and the
//   pass loops are compile-time constants.  Pass k updates only rows k ..
//   EH-1-k, the rows that can still be exact.
// * Large rectangular tiles: 128 columns by 64 rows, so a 2-sweep smoother
//   tile (core 56 x 120) computes and loads 1.22x its core, and a 2-sweep
//   down-leg tile (core 52 x 112) 1.41x, against 2.25x on the 48 x 48 tile.
//   (On the H100, 48 and 96 rows ran slower at every pass count: 96 rows fit
//   two blocks per SM, 64 rows three.)
// * No idle lanes, no per-cell div/mod.  Shared memory holds the tile split
//   by column parity: plane 0 the even local columns, plane 1 the odd ones
//   ([plane][row][pair], 64 pairs a row).  Tile origins are even, so local
//   parity is global parity, and on row i colour c lives in plane (i + c) & 1
//   alone: 64 contiguous words, one cell for each of a row's 64 lanes, no
//   bank conflict.  A thread keeps one pair index for the whole launch, so
//   its column tests are made once, and walks a quarter of the rows in
//   order, carrying the neighbours it shares with the next row in registers
//   (rb_row): three shared loads per cell update instead of five.
// * Asynchronous loads: each element is one 4-byte cp.async with zero fill
//   (src-size 0 outside the array), straight into its plane; a warp's 32
//   copies hit 32 banks since the planes sit 16 words apart.  Nothing is
//   staged in registers, so three 64 KB tiles stay resident per SM and one
//   block's loads overlap another's passes.
// * The core is stored as float4 where the output is 16-byte aligned and m
//   is a multiple of 4 (every 2^k-padded level), else one float at a time;
//   both are plain copies, so bit-equal.
// * One barrier per pass (4 for two sweeps) on 256 threads.
//
// Cells outside the array load as 0 and count as boundary cells (they fail
// the same tests as the edge: row <= 0 or >= nl - 1, col <= 0 or >= ml - 1),
// so they are pinned to their zero b and never read by an interior cell.
// Every op is rbgs_color_kernel's (and residual_kernel's and
// restrict_fw_kernel's) in the same order, so the core is bit-equal to the
// per-colour launches.
//
// The geometry is mirrored by ops/cuda_stencil.rbgs_tile, which passes it to
// the C entry points; a mismatch is refused there.
constexpr int kRbCols = 128;             // tile width (local columns)
constexpr int kRbPairs = kRbCols / 2;    // column pairs per row: one per lane
constexpr int kRbThreads = 256;
// thread groups of 64 lanes, a quarter of a pass's rows each
constexpr int kRbGroups = kRbThreads / kRbPairs;
constexpr int kRbPlanePad = 16;          // words between consecutive planes

template <int P>  // P: dependent passes the halo must cover
struct RbTile {
  static constexpr int H = P;                 // row halo
  static constexpr int HC = (P + 3) & ~3;     // column halo
  static constexpr int EH = 64;               // tile rows
  static constexpr int CH = EH - 2 * H;       // core rows (even)
  static constexpr int CW = kRbCols - 2 * HC; // core columns (multiple of 4)
  static constexpr int PLANE = EH * kRbPairs + kRbPlanePad;  // words
  static constexpr int SMEM = 4 * PLANE * (int)sizeof(float);  // u and b
  static_assert(CH > 0 && CW > 0 && CH % 2 == 0 && CW % 4 == 0, "tile");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copy the (EH, kRbCols) tile of x whose cell (0, 0) is array point (i0, j0)
// into the two planes at s; cells outside the array get 0.  A thread keeps
// one column (256 threads = 2 rows of 128) and walks the rows.
template <class T>
__device__ __forceinline__ void rb_load(float* s, const float* __restrict__ x,
                                        int i0, int j0, int n, int m) {
  const int col = threadIdx.x & (kRbCols - 1);
  const int j = j0 + col;
  const bool jin = j >= 0 && j < m;
  float* dst = s + (col & 1) * T::PLANE + (col >> 1);
#pragma unroll 4
  for (int r = threadIdx.x / kRbCols; r < T::EH; r += kRbThreads / kRbCols) {
    const int i = i0 + r;
    const bool in = jin && i >= 0 && i < n;
    cp_async4(dst + r * kRbPairs, in ? x + (long long)i * m + j : x, in);
  }
}

// The rows of a pass a thread walks: thread group g = threadIdx.x / 64 (a
// warp pair, so no warp diverges) takes the g-th quarter of rows k ..
// EH-1-k, its lane p the column pair p.
template <class T>
__device__ __forceinline__ bool rb_rows(int k, int* rs, int* re) {
  const int len = (T::EH - 2 * k + kRbGroups - 1) / kRbGroups;
  *rs = k + static_cast<int>(threadIdx.x / kRbPairs) * len;
  *re = min(*rs + len, T::EH - k);
  return *rs < *re;
}

// Row r of a colour pass at pair p, active plane A: rbgs_color_kernel's
// update.  A thread walks its rows in order, carrying two values from one
// row to the next (no cell it reads is written in the pass: a colour reads
// only the other colour): n, the active plane's cell above (row r - 1),
// and x, the other plane's pair p on row r, one of the W / E neighbours;
// the next row's n is this row's x and its x this row's S.  So each row
// loads S, the other W / E neighbour and b.  At the tile's edge columns
// (pair 0 of plane 0, pair 63 of plane 1) that neighbour is a cell of the
// row before or after: the edge ring is stale after the first pass anyway.
template <class T, int A>
__device__ __forceinline__ void rb_row(float* su, const float* sb, int r,
                                       int p, float& n, float& x, bool bcol,
                                       int rlo, int rhi, float inv_c) {
  const int q = r * kRbPairs + p;
  float* cell = su + A * T::PLANE + q;
  const float* other = su + (A ^ 1) * T::PLANE + q;
  const float south = cell[kRbPairs];
  const float y = other[A ? 1 : -1];
  const float bv = sb[A * T::PLANE + q];
  float t = __fmul_rn(bv, inv_c);
  t = __fadd_rn(t, n);          // north
  t = __fadd_rn(t, south);      // south
  t = __fadd_rn(t, A ? y : x);  // east
  t = __fadd_rn(t, A ? x : y);  // west
  const bool bnd = bcol || r < rlo || r > rhi;
  *cell = bnd ? bv : __fmul_rn(t, 0.25f);
  n = x;
  x = south;
}

template <class T, int A0>
__device__ __forceinline__ void rb_walk(float* su, const float* sb, int rs,
                                        int re, int p, bool bcol0, bool bcol1,
                                        int rlo, int rhi, float inv_c) {
  float n = su[A0 * T::PLANE + (rs - 1) * kRbPairs + p];
  float x = su[(A0 ^ 1) * T::PLANE + rs * kRbPairs + p];
  int r = rs;
  for (; r + 1 < re; r += 2) {
    rb_row<T, A0>(su, sb, r, p, n, x, A0 ? bcol1 : bcol0, rlo, rhi, inv_c);
    rb_row<T, A0 ^ 1>(su, sb, r + 1, p, n, x, A0 ? bcol0 : bcol1, rlo, rhi,
                      inv_c);
  }
  if (r < re) {
    rb_row<T, A0>(su, sb, r, p, n, x, A0 ? bcol1 : bcol0, rlo, rhi, inv_c);
  }
}

// Colour pass k (1-based) of the tile: colour (k - 1) & 1 on rows k ..
// EH-1-k, in place.  (bcol0, bcol1): whether the pair's even / odd column
// is a boundary column; rows rlo .. rhi are the interior rows.
template <class T>
__device__ __forceinline__ void rb_color_pass(float* su, const float* sb,
                                              int k, int i0, bool bcol0,
                                              bool bcol1, int rlo, int rhi,
                                              float inv_c) {
  int rs, re;
  if (!rb_rows<T>(k, &rs, &re)) return;
  const int p = threadIdx.x & (kRbPairs - 1);
  // the active plane of row rs: (i + colour) & 1
  if (((i0 + rs + k - 1) & 1) == 0) {
    rb_walk<T, 0>(su, sb, rs, re, p, bcol0, bcol1, rlo, rhi, inv_c);
  } else {
    rb_walk<T, 1>(su, sb, rs, re, p, bcol0, bcol1, rlo, rhi, inv_c);
  }
}

// Write the tile's core (local rows H .., columns HC ..) to y: array row i
// < n goes to row i - skip of y (skip: rows of the array before y's first).
template <class T>
__device__ __forceinline__ void rb_store_core(float* __restrict__ y,
                                              const float* su, int i0, int j0,
                                              int n, int m, bool vec,
                                              int skip = 0) {
  if (vec) {
    constexpr int Q = T::CW / 4;  // float4 per core row
    for (int t = threadIdx.x; t < T::CH * Q; t += kRbThreads) {
      const int r = T::H + t / Q;
      const int lc = T::HC + 4 * (t % Q);
      const int i = i0 + r, j = j0 + lc;
      if (i >= n || j >= m) continue;
      const int q = r * kRbPairs + lc / 2;
      const float2 e = *reinterpret_cast<const float2*>(su + q);
      const float2 o = *reinterpret_cast<const float2*>(su + T::PLANE + q);
      *reinterpret_cast<float4*>(y + (long long)(i - skip) * m + j) =
          make_float4(e.x, o.x, e.y, o.y);
    }
    return;
  }
  for (int t = threadIdx.x; t < T::CH * T::CW; t += kRbThreads) {
    const int r = T::H + t / T::CW;
    const int lc = T::HC + t % T::CW;
    const int i = i0 + r, j = j0 + lc;
    if (i < n && j < m) {
      y[(long long)(i - skip) * m + j] =
          su[(lc & 1) * T::PLANE + r * kRbPairs + (lc >> 1)];
    }
  }
}

// `SWEEPS` red-black sweeps, out of place (u -> out): the 2 x SWEEPS colour
// passes of rbgs_color_kernel on one tile, then its core.
template <int SWEEPS>
__global__ void __launch_bounds__(kRbThreads)
    rbgs_fused_kernel(const float* __restrict__ u, const float* __restrict__ b,
                      float* __restrict__ out, int n, int m, int nl, int ml,
                      float inv_c, int vec) {
  using T = RbTile<2 * SWEEPS>;
  extern __shared__ __align__(16) float rb_smem[];
  float* su = rb_smem;
  float* sb = rb_smem + 2 * T::PLANE;
  const int i0 = blockIdx.y * T::CH - T::H;
  const int j0 = blockIdx.x * T::CW - T::HC;
  rb_load<T>(su, u, i0, j0, n, m);
  rb_load<T>(sb, b, i0, j0, n, m);
  const int j = j0 + 2 * static_cast<int>(threadIdx.x & (kRbPairs - 1));
  const bool bcol0 = j <= 0 || j >= ml - 1;
  const bool bcol1 = j + 1 <= 0 || j + 1 >= ml - 1;
  const int rlo = 1 - i0, rhi = nl - 2 - i0;  // the interior rows
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int k = 1; k <= 2 * SWEEPS; ++k) {
    rb_color_pass<T>(su, sb, k, i0, bcol0, bcol1, rlo, rhi, inv_c);
    __syncthreads();
  }
  rb_store_core<T>(out, su, i0, j0, n, m, vec != 0);
}

// `SWEEPS` red-black sweeps on a shard's rows extended by kHalo halo rows
// above and below (replaces _rbgs_fused_offset_kernel, through
// _fused_rbgs_passes, for parallel/sharded_gmg.rbgs_local_pallas):
// rbgs_fused_kernel<SWEEPS> on the slab with a runtime global row offset.
// The extended slab (ne, m) starts at global row row0 (row0 < 0 on the first
// shard), so the colour and the Dirichlet pinning are taken in global
// coordinates: the active plane of a tile row from its global row (`&`, not
// `%`: row0 is -8 on the first shard), boundary row <= 0 | row >= nl - 1 |
// col <= 0 | col >= ml - 1 (`<=` and `>=`: the halo rows outside the domain
// hold the zeros of the edge exchange and stay pinned to be).  The tiles'
// cores cover the output rows, slab rows kHalo .. ne - kHalo - 1, written as
// out rows 0 .. ne - 2 kHalo - 1; a tile's row halo of 2 x SWEEPS <= kHalo
// starts at slab row kHalo - 2 x SWEEPS >= 0, so no tile reads above the
// slab.  Rows past the slab's end load as 0; the stale ring that starts
// there, and at the slab's first row, reaches at most 2 x SWEEPS <= kHalo
// rows in, as in the TPU block, whose edge rows see themselves as
// neighbours: neither reaches an output row.
//
// 12 B per extended point: read ue and be, write the core (the 48 x 48
// tile it replaces re-read 2.25x its core whatever the sweep count).
template <int SWEEPS>
__global__ void __launch_bounds__(kRbThreads)
    rbgs_fused_ext_kernel(const float* __restrict__ ue,
                          const float* __restrict__ be,
                          float* __restrict__ out, int ne, int m, int row0,
                          int nl, int ml, float inv_c, int vec) {
  using T = RbTile<2 * SWEEPS>;
  extern __shared__ __align__(16) float rb_smem[];
  float* su = rb_smem;
  float* sb = rb_smem + 2 * T::PLANE;
  const int i0 = kHalo + blockIdx.y * T::CH - T::H;  // slab row of tile row 0
  const int j0 = blockIdx.x * T::CW - T::HC;
  rb_load<T>(su, ue, i0, j0, ne, m);
  rb_load<T>(sb, be, i0, j0, ne, m);
  const int j = j0 + 2 * static_cast<int>(threadIdx.x & (kRbPairs - 1));
  const bool bcol0 = j <= 0 || j >= ml - 1;
  const bool bcol1 = j + 1 <= 0 || j + 1 >= ml - 1;
  const int g0 = row0 + i0;  // global row of tile row 0
  const int rlo = 1 - g0, rhi = nl - 2 - g0;  // the interior rows
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int k = 1; k <= 2 * SWEEPS; ++k) {
    rb_color_pass<T>(su, sb, k, g0, bcol0, bcol1, rlo, rhi, inv_c);
    __syncthreads();
  }
  rb_store_core<T>(out, su, i0, j0, ne - kHalo, m, vec != 0, kHalo);
}

// residual_kernel on rows k .. EH-1-k of both planes, over b in place (each
// cell reads only its own b): a thread walks its rows at pair p, carrying
// both planes' cells of the row above and of its own row, so each row loads
// the two cells below, the two outer W / E neighbours and the two b.
template <class T>
__device__ __forceinline__ void rb_residual(const float* su, float* sb, int k,
                                            bool bcol0, bool bcol1, int rlo,
                                            int rhi, float c) {
  int rs, re;
  if (!rb_rows<T>(k, &rs, &re)) return;
  const int p = threadIdx.x & (kRbPairs - 1);
  const float* u0 = su + p;             // even columns: pair p is 2p
  const float* u1 = su + T::PLANE + p;  // odd columns: 2p + 1
  float* b0 = sb + p;
  float* b1 = sb + T::PLANE + p;
  float n0 = u0[(rs - 1) * kRbPairs], n1 = u1[(rs - 1) * kRbPairs];
  float c0 = u0[rs * kRbPairs], c1 = u1[rs * kRbPairs];
  for (int r = rs; r < re; ++r) {
    const int q = r * kRbPairs;
    const float s0 = u0[q + kRbPairs], s1 = u1[q + kRbPairs];
    const float w0 = u1[q - 1];  // column 2p - 1
    const float e1 = u0[q + 1];  // column 2p + 2
    const bool brow = r < rlo || r > rhi;
    float a0 = c0, a1 = c1;
    if (!(brow || bcol0)) {
      float t = __fmul_rn(4.0f, c0);
      t = __fsub_rn(t, n0);  // north
      t = __fsub_rn(t, s0);  // south
      t = __fsub_rn(t, c1);  // east
      t = __fsub_rn(t, w0);  // west
      a0 = __fmul_rn(c, t);
    }
    if (!(brow || bcol1)) {
      float t = __fmul_rn(4.0f, c1);
      t = __fsub_rn(t, n1);  // north
      t = __fsub_rn(t, s1);  // south
      t = __fsub_rn(t, e1);  // east
      t = __fsub_rn(t, c0);  // west
      a1 = __fmul_rn(c, t);
    }
    b0[q] = __fsub_rn(b0[q], a0);
    b1[q] = __fsub_rn(b1[q], a1);
    n0 = c0;
    n1 = c1;
    c0 = s0;
    c1 = s1;
  }
}

// Axis-0 pass of the restriction at a fine cell of one residual plane
// (row lr, pair index pi), for coarse row k: fw_rows on the split tile.
__device__ __forceinline__ float fw_rows_split(const float* plane, int lr,
                                               int pi, int k, int nc_r) {
  const float* x = plane + lr * kRbPairs + pi;
  if (k == 0 || k == nc_r - 1) return *x;
  return __fadd_rn(
      __fadd_rn(__fmul_rn(0.25f, x[-kRbPairs]), __fmul_rn(0.5f, *x)),
      __fmul_rn(0.25f, x[kRbPairs]));
}

// V-cycle down-leg in one pass (replaces _rbgs_resfilter_kernel and the
// decimation fw_decimate_padded): `SWEEPS` (<= 3) red-black sweeps, the
// residual of the result, and the full-weighting restriction, for a fine
// (n, m) array (n, m even) with logical extents (nl, ml).  Writes the core
// of the smoothed u2 and the coarse points (k, q) whose fine point (2k, 2q)
// lies in the core (core rows and columns start even); no fine-size
// intermediate leaves the SM.
//
// Rings: 2 per sweep, 1 for the residual, 1 for the filter.  The colour
// passes are rbgs_fused_kernel's; the residual is residual_kernel's, on
// rows 2 SWEEPS + 1 .., written over b (each cell reads only its own b);
// the restriction is restrict_fw_kernel's per coarse point (rows first,
// edges injected, dead zone 0), so the result equals smoother + residual +
// restriction for every logical shape.  (The TPU kernel filtered every fine
// point and zeroed the coarse edges in XLA, which equals this when the
// smoothed residual is 0 on the logical boundary, as it is for the odd
// logical extents of the 2^k+1 hierarchies.)
//
// 13 B per fine point: read u and b, write u2 and a quarter-size rc (the
// composition it replaces moves 12 B for the smoother, 12 B for the
// residual and ~5 B for the restriction).
template <int SWEEPS>
__global__ void __launch_bounds__(kRbThreads)
    rbgs_resfilter_kernel(const float* __restrict__ u,
                          const float* __restrict__ b, float* __restrict__ u2,
                          float* __restrict__ rc, int n, int m, int nl, int ml,
                          float inv_c, float c, int vec) {
  using T = RbTile<2 * SWEEPS + 2>;
  extern __shared__ __align__(16) float rb_smem[];
  float* su = rb_smem;
  float* sb = rb_smem + 2 * T::PLANE;  // b, then the residual
  const int i0 = blockIdx.y * T::CH - T::H;
  const int j0 = blockIdx.x * T::CW - T::HC;
  rb_load<T>(su, u, i0, j0, n, m);
  rb_load<T>(sb, b, i0, j0, n, m);
  const int j = j0 + 2 * static_cast<int>(threadIdx.x & (kRbPairs - 1));
  const bool bcol0 = j <= 0 || j >= ml - 1;
  const bool bcol1 = j + 1 <= 0 || j + 1 >= ml - 1;
  const int rlo = 1 - i0, rhi = nl - 2 - i0;  // the interior rows
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int k = 1; k <= 2 * SWEEPS; ++k) {
    rb_color_pass<T>(su, sb, k, i0, bcol0, bcol1, rlo, rhi, inv_c);
    __syncthreads();
  }
  rb_residual<T>(su, sb, 2 * SWEEPS + 1, bcol0, bcol1, rlo, rhi, c);
  __syncthreads();
  rb_store_core<T>(u2, su, i0, j0, n, m, vec != 0);
  // the coarse points whose fine point lies in the core: a coarse row per
  // 64 lanes, CW / 2 of them active
  constexpr int kCr = T::CH / 2, kCc = T::CW / 2;
  const int mc = m / 2, ncr = n / 2;
  const int nc_r = (nl + 1) / 2, nc_c = (ml + 1) / 2;
  const float* r0 = sb;             // residual plane 0: even local columns
  const float* r1 = sb + T::PLANE;  // plane 1: odd
  for (int t = threadIdx.x; t < kCr * kRbPairs; t += kRbThreads) {
    const int kk = t / kRbPairs, qq = t & (kRbPairs - 1);
    if (qq >= kCc) continue;
    const int k = blockIdx.y * kCr + kk;
    const int qc = blockIdx.x * kCc + qq;
    if (k >= ncr || qc >= mc) continue;
    const long long o = (long long)k * mc + qc;
    if (k >= nc_r || qc >= nc_c) {
      rc[o] = 0.0f;
      continue;
    }
    // fine (2k, 2qc) is local (H + 2kk, HC + 2qq): plane 0, pair HC/2 + qq
    const int lr = T::H + 2 * kk, pi = T::HC / 2 + qq;
    const float ce = fw_rows_split(r0, lr, pi, k, nc_r);
    if (qc == 0 || qc == nc_c - 1) {
      rc[o] = ce;
      continue;
    }
    const float w = fw_rows_split(r1, lr, pi - 1, k, nc_r);
    const float e = fw_rows_split(r1, lr, pi, k, nc_r);
    rc[o] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, w), __fmul_rn(0.5f, ce)),
                      __fmul_rn(0.25f, e));
  }
}

// The geometry check of the C entry points: the caller's tile (row halo,
// column halo, rows, columns) must be the one compiled for its pass count.
template <class T>
bool rb_geometry_ok(const int* geom) {
  return geom[0] == T::H && geom[1] == T::HC && geom[2] == T::EH &&
         geom[3] == kRbCols;
}

// Launch `kernel` on the tiles of an (n, m) array; the dynamic shared
// memory above 48 KB is allowed once per kernel.
template <class T, class K, class... Args>
int rb_launch(K kernel, bool& smem_set, int n, int m, cudaStream_t stream,
              Args... args) {
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((m + T::CW - 1) / T::CW, (n + T::CH - 1) / T::CH);
  kernel<<<grid, kRbThreads, T::SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int S>
int rbgs_fused_launch(const float* u, const float* b, float* out, int n,
                      int m, int nl, int ml, float inv_c, const int* geom,
                      int vec, cudaStream_t stream) {
  using T = RbTile<2 * S>;
  static bool smem_set = false;
  if (!rb_geometry_ok<T>(geom)) return (int)cudaErrorInvalidValue;
  return rb_launch<T>(rbgs_fused_kernel<S>, smem_set, n, m, stream, u, b, out,
                      n, m, nl, ml, inv_c, vec);
}

template <int S>
int rbgs_fused_ext_launch(const float* ue, const float* be, float* out,
                          int ne, int m, int row0, int nl, int ml,
                          float inv_c, const int* geom, int vec,
                          cudaStream_t stream) {
  using T = RbTile<2 * S>;
  static bool smem_set = false;
  if (!rb_geometry_ok<T>(geom)) return (int)cudaErrorInvalidValue;
  // the tiles cover the ne - 2 kHalo output rows
  return rb_launch<T>(rbgs_fused_ext_kernel<S>, smem_set, ne - 2 * kHalo, m,
                      stream, ue, be, out, ne, m, row0, nl, ml, inv_c, vec);
}

template <int S>
int rbgs_resfilter_launch(const float* u, const float* b, float* u2,
                          float* rc, int n, int m, int nl, int ml, float inv_c,
                          float c, const int* geom, int vec,
                          cudaStream_t stream) {
  using T = RbTile<2 * S + 2>;
  static bool smem_set = false;
  if (!rb_geometry_ok<T>(geom)) return (int)cudaErrorInvalidValue;
  return rb_launch<T>(rbgs_resfilter_kernel<S>, smem_set, n, m, stream, u, b,
                      u2, rc, n, m, nl, ml, inv_c, c, vec);
}

// float4 stores need m % 4 == 0 and a 16-byte aligned output
int rb_vec(int m, const void* out) {
  return m % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
}

// ---------------------------------------------------------------------------
// The apply chain, apply_chain_kernel<A>: y = A^A u in one launch (A <= 8,
// _apply_fused_kernel's contract; longer chains in groups that ping-pong two
// scratch arrays), replacing _apply_fused_kernel / _apply_fused2d_kernel
// (shared body _fused_apply_passes).  Each apply is apply_kernel's
// expression in its op order, c * ((((4u - N) - S) - E) - W), with the
// Dirichlet boundary and dead-zone cells (and the cells outside the array,
// loaded as 0) replayed as identity, so the core is bit-equal to A
// apply_kernel launches and to the twin.
//
// Bound: memory, 8 B per point per call (read u, write y; separate launches
// move 8 B per point per apply).  What held the 48 x 48 tile at 12.8x its
// bound, and what this tile does instead:
// * Halo sized to the work: A rows and A rounded up to 4 columns (the ring
//   argument above: one ring per apply), so that tile origins and core
//   columns stay 16-byte aligned.  A is a template argument: the geometry
//   and the pass loops are compile-time constants.
// * Large rectangular tiles of kApRows x 128: at 8 applies a 64-row tile
//   loads 1.52x its core (48 x 112), against 2.25x on the 48 x 48 tile.
// * Loads: 16-byte cp.async with zero fill where every row is 16-byte
//   aligned (m % 4 == 0: a column quad then lies wholly inside or outside
//   the array), else 4-byte copies; nothing is staged in registers, so one
//   block's loads overlap another block's passes.
// * A warp owns a strip of whole tile rows, a lane a column quad: the lane
//   walks its rows carrying the quad's N and C rows in registers and reads
//   only S from shared memory (one float4); E and W beyond its quad come
//   from the neighbouring lanes' C by shuffle (at the tile's edge columns
//   the shuffle returns the lane's own value: that ring is stale after the
//   first apply anyway).  No div/mod per cell.
// * Applies out of place: an apply reads every neighbour's old value, so
//   the passes ping-pong two shared buffers (2 x 32 KB for a 64-row tile,
//   three blocks per SM).  Pass k computes rows k .. EH-1-k only, the rows
//   that can still be exact (all lanes compute all columns: a lane's quad
//   costs the same whether or not its columns are still exact).  The last
//   pass covers exactly the core rows and stores the core's quads straight
//   to y (float4 where aligned), so A applies take A - 1 barriers.
//
// The geometry is mirrored by ops/cuda_stencil.apply_tile, which passes it
// to the C entry point; a mismatch is refused there.
constexpr int kApRows = 64;                // tile rows
constexpr int kApCols = 128;               // tile columns: a warp's 32 quads
constexpr int kApQuads = kApCols / 4;      // column quads per row
constexpr int kApThreads = 256;
constexpr int kApWarps = kApThreads / 32;  // a strip of rows each

template <int A>  // applies: dependent passes the halo must cover
struct ApTile {
  static constexpr int H = A;                 // row halo
  static constexpr int HC = (A + 3) & ~3;     // column halo
  static constexpr int EH = kApRows;          // tile rows
  static constexpr int CH = EH - 2 * H;       // core rows
  static constexpr int CW = kApCols - 2 * HC; // core columns (multiple of 4)
  static constexpr int BUF = EH * kApCols;    // words per buffer
  static constexpr int SMEM = 2 * BUF * (int)sizeof(float);
  // rows a warp walks in pass 1, the longest
  static constexpr int RMAX = (EH - 2 + kApWarps - 1) / kApWarps;
  static_assert(CH > 0 && CW > 0 && CW % 4 == 0, "tile");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};
static_assert(kApThreads == kRbThreads, "rb_launch's block size");

// Issue one 16-byte copy of global src to shared dst; in == false fills the
// 16 bytes with zero (src must still be a valid, aligned address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Copy the (EH, kApCols) tile of x whose cell (0, 0) is array point (i0, j0)
// into s, row-major; cells outside the array get 0.  Warp w copies rows w,
// w + 8, ...: a quad per lane (vec: j0 and m multiples of 4, x 16-byte
// aligned), else four columns 32 apart per lane.
template <class T>
__device__ __forceinline__ void ap_load(float* s, const float* __restrict__ x,
                                        int i0, int j0, int n, int m,
                                        bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (vec) {
    const int j = j0 + 4 * lane;
    const bool jin = j >= 0 && j < m;
#pragma unroll 4
    for (int r = warp; r < T::EH; r += kApWarps) {
      const int i = i0 + r;
      const bool in = jin && i >= 0 && i < n;
      cp_async16(s + r * kApCols + 4 * lane,
                 in ? x + (long long)i * m + j : x, in);
    }
    return;
  }
#pragma unroll 2
  for (int r = warp; r < T::EH; r += kApWarps) {
    const int i = i0 + r;
    const bool iin = i >= 0 && i < n;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = lane + 32 * q;
      const int j = j0 + col;
      const bool in = iin && j >= 0 && j < m;
      cp_async4(s + r * kApCols + col, in ? x + (long long)i * m + j : x, in);
    }
  }
}

// apply_kernel's update of one cell: c * ((((4x - N) - S) - E) - W) inside,
// x itself on the boundary.
__device__ __forceinline__ float ap_cell(float x, float nv, float sv,
                                         float ev, float wv, float c,
                                         bool inside) {
  float t = __fmul_rn(4.0f, x);
  t = __fsub_rn(t, nv);  // north
  t = __fsub_rn(t, sv);  // south
  t = __fsub_rn(t, ev);  // east
  t = __fsub_rn(t, wv);  // west
  return inside ? __fmul_rn(c, t) : x;
}

// `A` applies u -> y on one tile (see above).
template <int A>
__global__ void __launch_bounds__(kApThreads)
    apply_chain_kernel(const float* __restrict__ u, float* __restrict__ y,
                       int n, int m, int nl, int ml, float c, int vec) {
  using T = ApTile<A>;
  extern __shared__ __align__(16) float ap_smem[];
  const int i0 = blockIdx.y * T::CH - T::H;
  const int j0 = blockIdx.x * T::CW - T::HC;
  ap_load<T>(ap_smem, u, i0, j0, n, m, vec != 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jq = j0 + 4 * lane;  // the lane's first column
  unsigned icol = 0;             // bit q: column jq + q is interior
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    icol |= static_cast<unsigned>(jq + q > 0 && jq + q < ml - 1) << q;
  }
  // the lane's quad lies in the core columns (HC is a multiple of 4)
  const bool qcore = 4 * lane >= T::HC && 4 * lane < kApCols - T::HC;
  const int rlo = 1 - i0, rhi = nl - 2 - i0;  // the interior rows
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int k = 1; k <= A; ++k) {
    const float4* x =
        reinterpret_cast<const float4*>(ap_smem + ((k - 1) & 1) * T::BUF) +
        lane;
    float4* z = reinterpret_cast<float4*>(ap_smem + (k & 1) * T::BUF) + lane;
    // warp w walks the w-th eighth of rows k .. EH-1-k
    const int len = (T::EH - 2 * k + kApWarps - 1) / kApWarps;
    const int rs = k + warp * len;
    const int re = min(rs + len, T::EH - k);
    if (rs < re) {  // warp-uniform: every lane shuffles
      float4 nq = x[(rs - 1) * kApQuads];
      float4 cq = x[rs * kApQuads];
#pragma unroll
      for (int t = 0; t < T::RMAX; ++t) {
        const int r = rs + t;
        if (r >= re) break;
        const float4 sq = x[(r + 1) * kApQuads];
        const float w = __shfl_up_sync(0xffffffffu, cq.w, 1);
        const float e = __shfl_down_sync(0xffffffffu, cq.x, 1);
        const bool irow = r >= rlo && r <= rhi;
        float4 o;
        o.x = ap_cell(cq.x, nq.x, sq.x, cq.y, w, c, irow && (icol & 1u));
        o.y = ap_cell(cq.y, nq.y, sq.y, cq.z, cq.x, c, irow && (icol & 2u));
        o.z = ap_cell(cq.z, nq.z, sq.z, cq.w, cq.y, c, irow && (icol & 4u));
        o.w = ap_cell(cq.w, nq.w, sq.w, e, cq.z, c, irow && (icol & 8u));
        if (k < A) {
          z[r * kApQuads] = o;
        } else if (qcore && i0 + r < n) {  // the last pass: rows = the core
          float* dst = y + (long long)(i0 + r) * m + jq;
          if (vec) {
            if (jq < m) *reinterpret_cast<float4*>(dst) = o;
          } else {
            if (jq < m) dst[0] = o.x;
            if (jq + 1 < m) dst[1] = o.y;
            if (jq + 2 < m) dst[2] = o.z;
            if (jq + 3 < m) dst[3] = o.w;
          }
        }
        nq = cq;
        cq = sq;
      }
    }
    if (k < A) __syncthreads();
  }
}

template <int A>
int apply_chain_launch(const float* u, float* y, int n, int m, int nl, int ml,
                       float c, const int* geom, cudaStream_t stream) {
  using T = ApTile<A>;
  static bool smem_set = false;
  if (geom[0] != T::H || geom[1] != T::HC || geom[2] != T::EH ||
      geom[3] != kApCols) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = rb_vec(m, u) && rb_vec(m, y);
  return rb_launch<T>(apply_chain_kernel<A>, smem_set, n, m, stream, u, y, n,
                      m, nl, ml, c, vec);
}

// ---------------------------------------------------------------------------
// The Jacobi smoother, jacobi_fused_kernel<S>: S damped-Jacobi sweeps in one
// launch (S <= 8, _jacobi_fused_kernel's contract, _MAX_FUSED_JACOBI; longer
// runs in groups that ping-pong two scratch arrays), replacing
// _jacobi_fused_kernel / _jacobi_fused2d_kernel (shared body
// _fused_jacobi_passes) and S launches of jacobi_kernel.  Each sweep is
// jacobi_kernel's expression in its op order, with the Dirichlet boundary
// and dead-zone cells (and the cells outside the array, loaded as 0) set to
// b, so the core is bit-equal to S jacobi_kernel launches and to the twin.
//
// Bound: memory, 12 B per point per call (read u and b, write y; separate
// launches move 12 B per point per sweep).  The design is the apply chain's
// row-walking tile (above): a sweep, like an apply, reads every neighbour's
// old value, so it cannot run in place and its stale ring grows one cell per
// sweep; the halo is S rows and S rounded up to 4 columns, the tile 64 x
// 128, two shared buffers ping-pong, pass k covers rows k .. 63 - k, a lane
// carries its quad's N and C rows in registers, E / W come by shuffle, and
// the last pass stores the core from registers.  What is new is b:
// * b is read from HBM once, by 16-byte cp.async, into the buffer that pass
//   1 writes: a lane reads its quad of b on a row just before it writes that
//   quad's result there, and no other lane reads it.
// * b * (1/c) is formed once per cell, in pass 1, and kept in registers for
//   the later passes: a warp owns a fixed strip of kJacStrip rows in every
//   pass (a float4 per row and lane), so the tile stays at two 32 KB buffers
//   and three blocks per SM.  (A third shared buffer of b * (1/c), 96 KB and
//   two blocks per SM, measured 14-17 % slower from 4 sweeps on; PERF.md.)
// * A boundary cell takes b in pass 1 and keeps its value after that (it
//   already holds b: pass k's rows were all computed in pass 1).
//
// The tile is ApTile<S>, mirrored by ops/cuda_stencil.jacobi_tile (which
// returns apply_tile's geometry) and passed to the C entry point; a mismatch
// is refused there.
constexpr int kJacStrip = kApRows / kApWarps;  // rows a warp owns

// jacobi_kernel's update of one cell from bc = b * (1/c): (bc + N + S + E +
// W) * 0.25, then (1 - omega) * x + omega * jac if damped; bv (b) on the
// boundary.
__device__ __forceinline__ float jac_cell(float x, float nv, float sv,
                                          float ev, float wv, float bc,
                                          float bv, bool inside, bool damped,
                                          float omw, float om) {
  float s = __fadd_rn(bc, nv);  // north
  s = __fadd_rn(s, sv);         // south
  s = __fadd_rn(s, ev);         // east
  s = __fadd_rn(s, wv);         // west
  float jac = __fmul_rn(s, 0.25f);
  if (damped) jac = __fadd_rn(__fmul_rn(omw, x), __fmul_rn(om, jac));
  return inside ? jac : bv;
}

// `S` sweeps u -> y on one tile (see above).
template <int S>
__global__ void __launch_bounds__(kApThreads)
    jacobi_fused_kernel(const float* __restrict__ u,
                        const float* __restrict__ b, float* __restrict__ y,
                        int n, int m, int nl, int ml, float inv_c, int damped,
                        float omw, float om, int vec) {
  using T = ApTile<S>;
  extern __shared__ __align__(16) float jac_smem[];
  const int i0 = blockIdx.y * T::CH - T::H;
  const int j0 = blockIdx.x * T::CW - T::HC;
  ap_load<T>(jac_smem, u, i0, j0, n, m, vec != 0);
  ap_load<T>(jac_smem + T::BUF, b, i0, j0, n, m, vec != 0);  // pass 1's z
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jq = j0 + 4 * lane;  // the lane's first column
  unsigned icol = 0;             // bit q: column jq + q is interior
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    icol |= static_cast<unsigned>(jq + q > 0 && jq + q < ml - 1) << q;
  }
  // the lane's quad lies in the core columns (HC is a multiple of 4)
  const bool qcore = 4 * lane >= T::HC && 4 * lane < kApCols - T::HC;
  const int rlo = 1 - i0, rhi = nl - 2 - i0;  // the interior rows
  const int r0 = warp * kJacStrip;            // the warp's rows
  const bool dmp = damped != 0;
  float4 bcr[kJacStrip];  // b * (1/c) of the lane's quad on the warp's rows
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int k = 1; k <= S; ++k) {
    const float4* x =
        reinterpret_cast<const float4*>(jac_smem + ((k - 1) & 1) * T::BUF) +
        lane;
    float4* z = reinterpret_cast<float4*>(jac_smem + (k & 1) * T::BUF) + lane;
    // the warp's rows among rows k .. EH-1-k (warp-uniform: every lane
    // shuffles)
    const int rs = max(r0, k), re = min(r0 + kJacStrip, T::EH - k);
    if (rs < re) {
      float4 nq = x[(rs - 1) * kApQuads];
      float4 cq = x[rs * kApQuads];
#pragma unroll
      for (int t = 0; t < kJacStrip; ++t) {
        const int r = r0 + t;
        if (r < rs) continue;
        if (r >= re) break;
        const float4 sq = x[(r + 1) * kApQuads];
        float4 bv, bc;  // the boundary value and b * (1/c)
        if (k == 1) {
          bv = z[r * kApQuads];  // b, until this lane overwrites it below
          bc = make_float4(__fmul_rn(bv.x, inv_c), __fmul_rn(bv.y, inv_c),
                           __fmul_rn(bv.z, inv_c), __fmul_rn(bv.w, inv_c));
          bcr[t] = bc;
        } else {
          bv = cq;  // b since pass 1
          bc = bcr[t];
        }
        const float w = __shfl_up_sync(0xffffffffu, cq.w, 1);
        const float e = __shfl_down_sync(0xffffffffu, cq.x, 1);
        const bool irow = r >= rlo && r <= rhi;
        float4 o;
        o.x = jac_cell(cq.x, nq.x, sq.x, cq.y, w, bc.x, bv.x,
                       irow && (icol & 1u), dmp, omw, om);
        o.y = jac_cell(cq.y, nq.y, sq.y, cq.z, cq.x, bc.y, bv.y,
                       irow && (icol & 2u), dmp, omw, om);
        o.z = jac_cell(cq.z, nq.z, sq.z, cq.w, cq.y, bc.z, bv.z,
                       irow && (icol & 4u), dmp, omw, om);
        o.w = jac_cell(cq.w, nq.w, sq.w, e, cq.z, bc.w, bv.w,
                       irow && (icol & 8u), dmp, omw, om);
        if (k < S) {
          z[r * kApQuads] = o;
        } else if (qcore && i0 + r < n) {  // the last pass: rows = the core
          float* dst = y + (long long)(i0 + r) * m + jq;
          if (vec) {
            if (jq < m) *reinterpret_cast<float4*>(dst) = o;
          } else {
            if (jq < m) dst[0] = o.x;
            if (jq + 1 < m) dst[1] = o.y;
            if (jq + 2 < m) dst[2] = o.z;
            if (jq + 3 < m) dst[3] = o.w;
          }
        }
        nq = cq;
        cq = sq;
      }
    }
    if (k < S) __syncthreads();
  }
}

template <int S>
int jacobi_fused_launch(const float* u, const float* b, float* y, int n,
                        int m, int nl, int ml, float inv_c, int damped,
                        float omw, float om, const int* geom,
                        cudaStream_t stream) {
  using T = ApTile<S>;
  static bool smem_set = false;
  if (geom[0] != T::H || geom[1] != T::HC || geom[2] != T::EH ||
      geom[3] != kApCols) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = rb_vec(m, u) && rb_vec(m, b) && rb_vec(m, y);
  return rb_launch<T>(jacobi_fused_kernel<S>, smem_set, n, m, stream, u, b,
                      y, n, m, nl, ml, inv_c, damped, omw, om, vec);
}

// ---------------------------------------------------------------------------
// The prolong-add, prolong_add_stream_kernel: out = u + prolong_padded(e)
// (replaces _prolong_add_kernel), prolong_add_kernel's values in its op
// order (rows first: e[k] on even fine rows, 0.5 (e[k] + e[k+1]) on odd ones,
// 0 past the last coarse row; then columns: the row value at q on even fine
// columns, 0.5 (R(q) + R(q+1)) on odd ones, R(pc_c) = 0; then u + that), so
// bit-equal to it and to the twin.
//
// Bound: memory, 9 B per fine point (read u, write out, read e once).  What
// held the one-thread-per-point kernel at 2.1x its bound: 4-byte accesses,
// one to four re-reads of e per fine point through L1, and even and odd
// lanes taking different branches.  Here:
// * A lane owns a coarse column quad q .. q+3, so fine columns 2q .. 2q+7:
//   per fine row it reads u and writes out as two float4 (a warp's row is
//   1 KB contiguous), and e as one float4.  Its row values at q+4 come from
//   the next lane by shuffle; the warp's last lane reads its own.
// * A warp walks a strip of kPaStrip coarse rows (2 kPaStrip fine rows),
//   carrying e's row k + 1 in registers as the next step's row k, so a
//   strip loads each e value once; the row two strips share is loaded by
//   both, and the strips of a block run side by side, so the second load
//   finds it in L2.  No shared memory, no barrier: the warps of a block
//   (kPaQuads lanes across, kPaThreads / kPaQuads strips down) are
//   independent.  (On the H100, benchmarks/prolong_tile_rows.py timed
//   strips of 2 rows fastest, then 4, 8 and 16: shorter strips put more
//   warps' loads in flight.)
// * Where pc_c % 4 != 0 or a pointer is not 16-byte aligned (vec == 0), the
//   same walk loads and stores one float at a time, masked at the last
//   column.
//
// The geometry (strip height, quads per block) is mirrored by
// ops/cuda_stencil.prolong_tile, which passes it to the C entry point; a
// mismatch is refused there.
constexpr int kPaStrip = 2;     // coarse rows a warp walks
constexpr int kPaQuads = 32;    // coarse column quads per block: a warp
constexpr int kPaThreads = 256;
constexpr int kPaWarps = kPaThreads / kPaQuads;  // strips per block
static_assert(kPaQuads % 32 == 0, "a strip is walked by whole warps");

__device__ __forceinline__ float half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// e[k, q .. q+3], 0 past the last column.
__device__ __forceinline__ float4 pa_load_quad(const float* __restrict__ e,
                                               int k, int q, int pc_c,
                                               bool vec) {
  const float* src = e + (long long)k * pc_c + q;
  if (vec) {
    return q < pc_c ? *reinterpret_cast<const float4*>(src)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(q < pc_c ? src[0] : 0.0f, q + 1 < pc_c ? src[1] : 0.0f,
                     q + 2 < pc_c ? src[2] : 0.0f,
                     q + 3 < pc_c ? src[3] : 0.0f);
}

// Fine row i at columns 2q .. 2q+7 from the row values rv (coarse columns q
// .. q+3) and r4 (q + 4): out = u + (rv.x, (rv.x + rv.y) / 2, rv.y, ...).
__device__ __forceinline__ void pa_row(const float* __restrict__ u,
                                       float* __restrict__ out, int i, int q,
                                       int m, bool vec, float4 rv, float r4) {
  const float f[8] = {rv.x, half_sum(rv.x, rv.y), rv.y, half_sum(rv.y, rv.z),
                      rv.z, half_sum(rv.z, rv.w), rv.w, half_sum(rv.w, r4)};
  const int j = 2 * q;
  if (j >= m) return;
  const long long p = (long long)i * m + j;
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(u + p);
    const float4 c = *reinterpret_cast<const float4*>(u + p + 4);
    *reinterpret_cast<float4*>(out + p) =
        make_float4(__fadd_rn(a.x, f[0]), __fadd_rn(a.y, f[1]),
                    __fadd_rn(a.z, f[2]), __fadd_rn(a.w, f[3]));
    *reinterpret_cast<float4*>(out + p + 4) =
        make_float4(__fadd_rn(c.x, f[4]), __fadd_rn(c.y, f[5]),
                    __fadd_rn(c.z, f[6]), __fadd_rn(c.w, f[7]));
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (j + c < m) out[p + c] = __fadd_rn(u[p + c], f[c]);
  }
}

__global__ void __launch_bounds__(kPaThreads)
    prolong_add_stream_kernel(const float* __restrict__ e,
                              const float* __restrict__ u,
                              float* __restrict__ out, int pc_r, int pc_c,
                              int vec) {
  const int lane = threadIdx.x % kPaQuads;
  const int k0 = (blockIdx.y * kPaWarps + threadIdx.x / kPaQuads) * kPaStrip;
  if (k0 >= pc_r) return;  // warp-uniform
  const int q = 4 * (blockIdx.x * kPaQuads + lane);  // the lane's first
  const bool last = (threadIdx.x & 31) == 31;        // coarse column
  const bool v = vec != 0;
  const int m = 2 * pc_c;
  // row k of e at the lane's quad, and at q + 4 on the warp's last lane
  float4 cur = pa_load_quad(e, k0, q, pc_c, v);
  float cur4 = last && q + 4 < pc_c ? e[(long long)k0 * pc_c + q + 4] : 0.0f;
#pragma unroll
  for (int t = 0; t < kPaStrip; ++t) {
    const int k = k0 + t;
    if (k >= pc_r) break;  // warp-uniform
    float4 nxt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // 0 past the last row
    float nxt4 = 0.0f;
    if (k + 1 < pc_r) {
      nxt = pa_load_quad(e, k + 1, q, pc_c, v);
      if (last && q + 4 < pc_c) nxt4 = e[(long long)(k + 1) * pc_c + q + 4];
    }
    // fine row 2k: the row values are e's row k
    float r4 = __shfl_down_sync(0xffffffffu, cur.x, 1);
    pa_row(u, out, 2 * k, q, m, v, cur, last ? cur4 : r4);
    // fine row 2k + 1: 0.5 (e[k] + e[k+1])
    const float4 mid = make_float4(half_sum(cur.x, nxt.x),
                                   half_sum(cur.y, nxt.y),
                                   half_sum(cur.z, nxt.z),
                                   half_sum(cur.w, nxt.w));
    r4 = __shfl_down_sync(0xffffffffu, mid.x, 1);
    pa_row(u, out, 2 * k + 1, q, m, v, mid, last ? half_sum(cur4, nxt4) : r4);
    cur = nxt;
    cur4 = nxt4;
  }
}

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

dim3 grid_for(int n, int m) {
  return dim3((m + kBlockX - 1) / kBlockX, (n + kBlockY - 1) / kBlockY);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" {

int mg_rbgs_color(float* u, const float* b, int n, int m, int nl, int ml,
                  float inv_c, int color, void* stream) {
  rbgs_color_kernel<<<grid_for(n, m), dim3(kBlockX, kBlockY), 0,
                      (cudaStream_t)stream>>>(u, b, n, m, nl, ml, inv_c,
                                              color);
  return (int)cudaGetLastError();
}

int mg_residual(const float* u, const float* b, float* r, int n, int m, int nl,
                int ml, float c, void* stream) {
  residual_kernel<<<grid_for(n, m), dim3(kBlockX, kBlockY), 0,
                    (cudaStream_t)stream>>>(u, b, r, n, m, nl, ml, c);
  return (int)cudaGetLastError();
}

int mg_ff_residual(const float* uh, const float* ul, const float* dh,
                   const float* dl, const float* b, float* r, int n, int m,
                   int nl, int ml, float c, void* stream) {
  ff_residual_kernel<<<grid_for(n, m), dim3(kBlockX, kBlockY), 0,
                       (cudaStream_t)stream>>>(uh, ul, dh, dl, b, r, n, m, nl,
                                               ml, c);
  return (int)cudaGetLastError();
}

int mg_ff_update_residual(const float* uh, const float* ul, const float* e,
                          const float* dh, const float* dl, const float* b,
                          float* uh2, float* ul2, float* r, int n, int m,
                          int nl, int ml, float c, void* stream) {
  ff_update_residual_kernel<<<grid_for(n, m), dim3(kBlockX, kBlockY), 0,
                              (cudaStream_t)stream>>>(
      uh, ul, e, dh, dl, b, uh2, ul2, r, n, m, nl, ml, c);
  return (int)cudaGetLastError();
}

int mg_apply(const float* u, float* y, int n, int m, int nl, int ml, float c,
             void* stream) {
  apply_kernel<<<grid_for(n, m), dim3(kBlockX, kBlockY), 0,
                 (cudaStream_t)stream>>>(u, y, n, m, nl, ml, c);
  return (int)cudaGetLastError();
}

int mg_jacobi(const float* x, const float* b, float* y, int n, int m, int nl,
              int ml, float inv_c, int damped, float one_minus_omega,
              float omega, void* stream) {
  jacobi_kernel<<<grid_for(n, m), dim3(kBlockX, kBlockY), 0,
                  (cudaStream_t)stream>>>(x, b, y, n, m, nl, ml, inv_c, damped,
                                          one_minus_omega, omega);
  return (int)cudaGetLastError();
}

int mg_restrict_fw(const float* r, float* out, int n, int m, int nc_r,
                   int nc_c, void* stream) {
  restrict_fw_kernel<<<grid_for(n / 2, m / 2), dim3(kBlockX, kBlockY), 0,
                       (cudaStream_t)stream>>>(r, out, n, m, nc_r, nc_c);
  return (int)cudaGetLastError();
}

// `sweeps` (1 .. 8) damped-Jacobi sweeps u -> y on the row-walking tile;
// geom = (row halo, column halo, tile rows, tile columns) as the caller
// computed it, refused unless it is the compiled one.
int mg_jacobi_fused(const float* u, const float* b, float* y, int n, int m,
                    int nl, int ml, float inv_c, int sweeps, int damped,
                    float one_minus_omega, float omega, const int* geom,
                    void* stream) {
  static const decltype(&jacobi_fused_launch<1>) kLaunch[] = {
      jacobi_fused_launch<1>, jacobi_fused_launch<2>, jacobi_fused_launch<3>,
      jacobi_fused_launch<4>, jacobi_fused_launch<5>, jacobi_fused_launch<6>,
      jacobi_fused_launch<7>, jacobi_fused_launch<8>};
  if (sweeps < 1 || sweeps > 8) return (int)cudaErrorInvalidValue;
  return kLaunch[sweeps - 1](u, b, y, n, m, nl, ml, inv_c, damped,
                             one_minus_omega, omega, geom,
                             (cudaStream_t)stream);
}

// The one-thread-per-point prolong-add (the stream's oracle only).
int mg_prolong_add_point(const float* e, const float* u, float* out, int pc_r,
                         int pc_c, void* stream) {
  prolong_add_kernel<<<grid_for(2 * pc_r, 2 * pc_c), dim3(kBlockX, kBlockY), 0,
                       (cudaStream_t)stream>>>(e, u, out, pc_r, pc_c);
  return (int)cudaGetLastError();
}

// out = u + prolong_padded(e) on the row-strip stream; geom = (strip rows,
// quads per block) as the caller computed it, refused unless it is the
// compiled one.
int mg_prolong_add(const float* e, const float* u, float* out, int pc_r,
                   int pc_c, const int* geom, void* stream) {
  if (geom[0] != kPaStrip || geom[1] != kPaQuads || pc_r < 1 || pc_c < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = pc_c % 4 == 0 && rb_vec(4, e) && rb_vec(4, u) &&
                  rb_vec(4, out);
  const int quads = (pc_c + 3) / 4;
  const dim3 grid((quads + kPaQuads - 1) / kPaQuads,
                  (pc_r + kPaWarps * kPaStrip - 1) / (kPaWarps * kPaStrip));
  prolong_add_stream_kernel<<<grid, kPaThreads, 0, (cudaStream_t)stream>>>(
      e, u, out, pc_r, pc_c, vec);
  return (int)cudaGetLastError();
}

int mg_rbgs_color_sweep(const float* u, const float* b, float* out, int n,
                        int m, int nl, int ml, float c, int color,
                        void* stream) {
  rbgs_color_sweep_kernel<<<grid_for(n, m), dim3(kBlockX, kBlockY), 0,
                            (cudaStream_t)stream>>>(u, b, out, n, m, nl, ml, c,
                                                    color);
  return (int)cudaGetLastError();
}

// `sweeps` (1 .. 4) red-black sweeps u -> out on the colour-split tile;
// geom = (row halo, column halo, tile rows, tile columns) as the caller
// computed it, refused unless it is the compiled one.
int mg_rbgs_fused(const float* u, const float* b, float* out, int n, int m,
                  int nl, int ml, float inv_c, int sweeps, const int* geom,
                  void* stream) {
  static const decltype(&rbgs_fused_launch<1>) kLaunch[] = {
      rbgs_fused_launch<1>, rbgs_fused_launch<2>, rbgs_fused_launch<3>,
      rbgs_fused_launch<4>};
  if (sweeps < 1 || sweeps > 4) return (int)cudaErrorInvalidValue;
  return kLaunch[sweeps - 1](u, b, out, n, m, nl, ml, inv_c, geom,
                             rb_vec(m, out), (cudaStream_t)stream);
}

// The down-leg with `sweeps` (0 .. 3) sweeps on the colour-split tile; geom
// as for mg_rbgs_fused.
int mg_rbgs_resfilter(const float* u, const float* b, float* u2, float* rc,
                      int n, int m, int nl, int ml, float inv_c, float c,
                      int sweeps, const int* geom, void* stream) {
  static const decltype(&rbgs_resfilter_launch<0>) kLaunch[] = {
      rbgs_resfilter_launch<0>, rbgs_resfilter_launch<1>,
      rbgs_resfilter_launch<2>, rbgs_resfilter_launch<3>};
  if (n % 2 || m % 2 || sweeps < 0 || sweeps > 3) {
    return (int)cudaErrorInvalidValue;
  }
  return kLaunch[sweeps](u, b, u2, rc, n, m, nl, ml, inv_c, c, geom,
                         rb_vec(m, u2), (cudaStream_t)stream);
}

// `applies` (1 .. 8) applies u -> y on the row-walking tile; geom = (row
// halo, column halo, tile rows, tile columns) as the caller computed it,
// refused unless it is the compiled one.
int mg_apply_chain(const float* u, float* y, int n, int m, int nl, int ml,
                   float c, int applies, const int* geom, void* stream) {
  static const decltype(&apply_chain_launch<1>) kLaunch[] = {
      apply_chain_launch<1>, apply_chain_launch<2>, apply_chain_launch<3>,
      apply_chain_launch<4>, apply_chain_launch<5>, apply_chain_launch<6>,
      apply_chain_launch<7>, apply_chain_launch<8>};
  if (applies < 1 || applies > 8) return (int)cudaErrorInvalidValue;
  return kLaunch[applies - 1](u, y, n, m, nl, ml, c, geom,
                              (cudaStream_t)stream);
}

// `sweeps` (1 .. 4) red-black sweeps on an extended slab of ne > 2 kHalo
// rows on the colour-split tile; geom as for mg_rbgs_fused.
int mg_rbgs_fused_ext(const float* ue, const float* be, float* out, int ne,
                      int m, int row0, int nl, int ml, float inv_c, int sweeps,
                      const int* geom, void* stream) {
  static const decltype(&rbgs_fused_ext_launch<1>) kLaunch[] = {
      rbgs_fused_ext_launch<1>, rbgs_fused_ext_launch<2>,
      rbgs_fused_ext_launch<3>, rbgs_fused_ext_launch<4>};
  if (sweeps < 1 || sweeps > 4 || ne <= 2 * kHalo) {
    return (int)cudaErrorInvalidValue;
  }
  return kLaunch[sweeps - 1](ue, be, out, ne, m, row0, nl, ml, inv_c, geom,
                             rb_vec(m, out), (cudaStream_t)stream);
}

}  // extern "C"
