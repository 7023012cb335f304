// 3D 7-point Poisson stencil kernels for Hopper (sm_90a): the smoothers,
// residual and operator apply of the 3D GMG V-cycle.
//
// Ports of the Pallas TPU kernels in
// multigrid_prj_tpu/ops/pallas_stencil_3d.py:
//   apply3d      <- poisson_apply_3d (_apply3d_kernel)
//   residual3d   <- poisson_residual_3d (_residual3d_kernel): a z-chunked
//                   march (below); residual3d_point, one thread per point,
//                   is the first port, on no path
//   rbgs3d_fused <- red_black_gauss_seidel_3d (_rbgs3d_color_kernel, one
//                   pass per colour there): the smoother, up to 4 sweeps
//                   per launch on a z-marching tile, or every sweep of a
//                   small array in one launch (below)
//   rbgs3d_color <- the same, one colour per launch: the per-colour oracle
//                   that rbgs3d_fused is held to (no solver path)
//   jacobi3d     <- jacobi_3d (_jacobi3d_kernel)
//
// Layout: a contiguous f32 array of shape (nz, ny, nx), one thread per point
// on a 3D grid of blocks (x fastest), with 64-bit offsets (nz*ny*nx passes
// 2^31 at about 1291^3).  (nzl, nyl, nxl) are the logical extents: a point
// is boundary if any index is 0 or at/beyond its logical extent - 1, which
// pins the padded dead zone.  Boundary points never read neighbours and
// every array-edge point is a boundary point, so no read leaves the array.
// Any 3D shape is accepted: the TPU kernels needed nx % 128 == 0 and
// ny % 8 == 0 (flattened (nz*ny, nx) row blocks that divide ny), Hopper
// needs no alignment.
//
// Arithmetic: every operation is an explicit round-to-nearest intrinsic
// (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn), which nvcc never
// contracts into an FMA (the file is also built with -fmad=false).  The
// neighbour sum is ((((N + S) + E) + W) + Zn) + Zs, left to right, as
// _neighbors3d forms it, and b / c is a true division, as in the Pallas
// bodies (the 2D kernels multiply by 1/c instead).  The op order matches
// the torch twins in ops/cuda_stencil_3d.py, so each kernel is bit-equal to
// its twin.
//
// apply3d, residual3d_point, rbgs3d_color and jacobi3d are simple first
// versions: one thread per point, neighbours read through L1/L2 (no
// shared-memory tiling), one launch per colour half-sweep or Jacobi sweep.
// Each streams its operands from HBM once per launch and is bound by memory
// bandwidth (bytes per point are noted at each kernel).  The smoother's two
// launch shapes are described above rbgs3d_zmarch_kernel, the residual's
// march above residual3d_march_kernel.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool is_boundary3d(int z, int y, int x, int nzl,
                                              int nyl, int nxl) {
  return z == 0 || y == 0 || x == 0 || z >= nzl - 1 || y >= nyl - 1 ||
         x >= nxl - 1;
}

// ((((N + S) + E) + W) + Zn) + Zs with N/S = y -/+ 1, E/W = x +/- 1,
// Zn/Zs = z -/+ 1 (_neighbors3d); p is an interior point.
__device__ __forceinline__ float neighbor_sum(const float* __restrict__ u,
                                              long long p, long long nx,
                                              long long plane) {
  float s = __fadd_rn(u[p - nx], u[p + nx]);  // north + south
  s = __fadd_rn(s, u[p + 1]);                 // east
  s = __fadd_rn(s, u[p - 1]);                 // west
  s = __fadd_rn(s, u[p - plane]);             // z - 1
  return __fadd_rn(s, u[p + plane]);          // z + 1
}

// The thread's point: (z, y, x) and its linear offset; false past the array.
struct Point {
  int z, y, x;
  long long p;
};

__device__ __forceinline__ bool this_point(int nz, int ny, int nx, Point* pt) {
  pt->x = blockIdx.x * blockDim.x + threadIdx.x;
  pt->y = blockIdx.y * blockDim.y + threadIdx.y;
  pt->z = blockIdx.z;
  if (pt->x >= nx || pt->y >= ny || pt->z >= nz) return false;
  pt->p = ((long long)pt->z * ny + pt->y) * nx + pt->x;
  return true;
}

// y = boundary ? u : c*(6u - nb)  (_apply3d_kernel :107).
// 8 B/point: read u, write y (neighbour reads hit L1/L2).
__global__ void apply3d_kernel(const float* __restrict__ u,
                               float* __restrict__ y, int nz, int ny, int nx,
                               int nzl, int nyl, int nxl, float c) {
  Point pt;
  if (!this_point(nz, ny, nx, &pt)) return;
  const float uc = u[pt.p];
  if (is_boundary3d(pt.z, pt.y, pt.x, nzl, nyl, nxl)) {
    y[pt.p] = uc;
    return;
  }
  const float nb = neighbor_sum(u, pt.p, nx, (long long)ny * nx);
  y[pt.p] = __fmul_rn(c, __fsub_rn(__fmul_rn(6.0f, uc), nb));
}

// r = b - (boundary ? u : c*(6u - nb)), one thread per point: the first
// port of _residual3d_kernel (:117), kept only so that chip_smoke.py can
// hold the z-chunked march (residual3d_march_kernel below, which replaces it
// on every path) to it and time the two in one run.  12 B/point: read u and
// b, write r; each plane of u is fetched three times through L2.
__global__ void residual3d_point_kernel(const float* __restrict__ u,
                                        const float* __restrict__ b,
                                        float* __restrict__ r, int nz,
                                        int ny, int nx, int nzl, int nyl,
                                        int nxl, float c) {
  Point pt;
  if (!this_point(nz, ny, nx, &pt)) return;
  const float uc = u[pt.p];
  float a = uc;
  if (!is_boundary3d(pt.z, pt.y, pt.x, nzl, nyl, nxl)) {
    const float nb = neighbor_sum(u, pt.p, nx, (long long)ny * nx);
    a = __fmul_rn(c, __fsub_rn(__fmul_rn(6.0f, uc), nb));
  }
  r[pt.p] = __fsub_rn(b[pt.p], a);
}

// One colour half-sweep of red-black Gauss-Seidel, in place on u
// (_rbgs3d_color_kernel :128): the per-colour oracle of the fused smoother
// below (ops/cuda_stencil_3d._rbgs3d_per_colour), on no solver path.
// 12 B/point over the launch: read b and the other colour's neighbours,
// write this colour.
//
// A launch writes ONLY points of its own colour ((z+y+x) % 2 == color):
// boundary points of the colour are pinned to b, interior points get
//   (b / c + nb) * inv6.
// Interior points read only the other colour, so no point is both read and
// written in one launch.  The TPU pass is out of place and pins the
// boundary points of both colours in colour 0, but computes colour 0 from
// the values before that pin, and the other colour's boundary points are
// next read after colour 1 has pinned them here; so after each full sweep
// the result is bit-identical.
__global__ void rbgs3d_color_kernel(float* __restrict__ u,
                                    const float* __restrict__ b, int nz,
                                    int ny, int nx, int nzl, int nyl, int nxl,
                                    float c, float inv6, int color) {
  Point pt;
  if (!this_point(nz, ny, nx, &pt) || ((pt.z + pt.y + pt.x) & 1) != color) {
    return;
  }
  if (is_boundary3d(pt.z, pt.y, pt.x, nzl, nyl, nxl)) {
    u[pt.p] = b[pt.p];
    return;
  }
  const float nb = neighbor_sum(u, pt.p, nx, (long long)ny * nx);
  u[pt.p] = __fmul_rn(__fadd_rn(__fdiv_rn(b[pt.p], c), nb), inv6);
}

// One damped-Jacobi sweep, out of place (x -> y)  (_jacobi3d_kernel :141):
//   boundary: b;  interior: jac = (b / c + nb) * inv6, then, if damped,
//   (1-omega)*x + omega*jac, with (1-omega) and omega rounded to f32 on the
//   host.  12 B/point: read x and b, write y.
__global__ void jacobi3d_kernel(const float* __restrict__ x,
                                const float* __restrict__ b,
                                float* __restrict__ y, int nz, int ny, int nx,
                                int nzl, int nyl, int nxl, float c, float inv6,
                                int damped, float one_minus_omega,
                                float omega) {
  Point pt;
  if (!this_point(nz, ny, nx, &pt)) return;
  if (is_boundary3d(pt.z, pt.y, pt.x, nzl, nyl, nxl)) {
    y[pt.p] = b[pt.p];
    return;
  }
  const float nb = neighbor_sum(x, pt.p, nx, (long long)ny * nx);
  float jac = __fmul_rn(__fadd_rn(__fdiv_rn(b[pt.p], c), nb), inv6);
  if (damped) {
    jac = __fadd_rn(__fmul_rn(one_minus_omega, x[pt.p]),
                    __fmul_rn(omega, jac));
  }
  y[pt.p] = jac;
}

// ---------------------------------------------------------------------------
// The smoother, rbgs3d_fused: `sweeps` red-black sweeps, out of place (u is
// only read, never cloned), colour 0 first, parity (z + y + x) & 1.  Every
// op is rbgs3d_color_kernel's in the same order (boundary and dead-zone
// points pinned to b, interior (b / c + ((((N + S) + E) + W) + Zn) + Zs) *
// inv6), so the result is bit-equal to 2 x sweeps per-colour launches and to
// the twin.  Two launch shapes, chosen by the wrapper from the array's size
// (ops/cuda_stencil_3d.red_black_gauss_seidel_3d):
//
// The z-marching tile, rbgs3d_zmarch_kernel<SWEEPS>, up to 4 sweeps per
// launch (longer runs in groups that ping-pong two scratch arrays).  Bound:
// memory.  A 2-sweep call must move 12 B per point (read u and b, write the
// result); the per-colour launches it replaces moved 4 x 12 B and an 8 B
// clone, and half the lanes of each of their warps idled.
// * One block per x-y tile (Zm<P>::TY rows by kZmCols columns with a halo of
//   P = 2 x SWEEPS cells on each side: one ring per dependent pass, the ring
//   argument of stencil2d.cu) walks z from 0 to nz - 1.  z needs no halo:
//   the march covers every plane, and planes 0 and >= nzl - 1 are boundary
//   planes, which read no neighbour.
// * The 2 x SWEEPS colour passes run as a wavefront in z, kZmLag = 2 planes
//   apart, all in the same step with one barrier per step: at step t the
//   block runs pass k on plane t - 1 - 2 (k - 1), in place.  This is exact
//   because a colour reads only the other colour.  Pass k on plane z reads
//   planes z - 1 .. z + 1 of the colour that passes k - 1 and k + 1 write:
//   pass k - 1 finished z + 1 a step earlier, pass k + 1 reaches z - 1 a step
//   later, and the passes running beside it write planes an even number of
//   planes away, none of which it reads.  With a lag of one plane, pass k + 1
//   would rewrite z - 1 in the same step as pass k reads it.
// * Latency: a block walks its planes one after another, so a step's work
//   is spread as thin as it goes: a thread per (row, column pair) for each
//   colour (2 x TY x 16 threads), each with one copy of u and of b, one
//   division and one update per pass of its colour in a step, and one
//   barrier per step; b / c is divided once per cell when its plane lands
//   (boundary cells keep b), not in every pass; planes are loaded kZmAhead
//   steps ahead; each thread's offsets, addresses and boundary tests are
//   worked out once per launch, ring slots advanced by one a step.
// * Rings of shared-memory planes: u holds the planes the passes read (2 (P
//   - 1) + 3, the lowest also being stored) and those in flight; b the
//   passes' planes, the one that landed and those in flight.
// * The planes are split by column parity, as the 2D tile: on row y of
//   plane z colour c lies in parity plane (z + y + c) & 1 alone, so a lane
//   per column pair has no idle lane, and the two rows a warp covers sit in
//   opposite halves of the banks.
// * Loads: one 4-byte cp.async with zero fill per cell (cells outside the
//   array arrive as 0 and count as boundary cells: they fail the same tests
//   as the edge and are pinned to their zero b).
// * The core of a finished plane is stored a step after pass P leaves it.
//
// The grid-resident kernel, rbgs3d_resident_kernel: an array of at most
// kResidentMaxPoints points (the 17^3 bottom of a 3D V-cycle has 4913)
// lives in one block's shared memory, u and b / c, for all 2 x sweeps
// passes, with a barrier between passes: coarse_sweeps = 100 is one launch
// instead of 200.  Bound there: the passes' latency, not bytes.
//
// The geometry is mirrored by ops/cuda_stencil_3d.rbgs3d_tile and the cap by
// RESIDENT_MAX_POINTS; the C entry points refuse anything else.
constexpr int kZmCols = 32;            // tile columns
constexpr int kZmPairs = kZmCols / 2;  // column pairs: one per lane
constexpr int kZmLag = 2;              // planes between passes
constexpr int kZmAhead = 3;            // planes loaded ahead

template <int P>  // P: dependent passes the halo must cover
struct Zm {
  static constexpr int H = P;                  // row halo
  static constexpr int HC = P;                 // column halo
  static constexpr int TY = P <= 4 ? 32 : 32;  // tile rows
  static constexpr int CH = TY - 2 * H;        // core rows
  static constexpr int CW = kZmCols - 2 * HC;  // core columns
  static constexpr int SPAN = kZmLag * (P - 1);  // planes from pass 1 to P
  static constexpr int RU = SPAN + 3 + kZmAhead;  // u planes in the ring
  static constexpr int RB = SPAN + 2 + kZmAhead;  // b planes in the ring
  static constexpr int CP = TY * kZmPairs;     // words per parity plane
  static constexpr int SLICE = 2 * CP;         // words per z-plane
  static constexpr int SMEM = (RU + RB) * SLICE * (int)sizeof(float);
  // a thread per (row, pair) for each colour's passes: one copy of u and b
  // and one update per pass per thread and step
  static constexpr int THREADS = 2 * CP;
  static_assert(CH > 0 && CW > 0 && TY % 2 == 0 && THREADS <= 1024, "tile");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// Issue one 4-byte copy of global src to shared byte address dst; nbytes 0
// fills the cell with zero (src must still be a valid address).
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          unsigned nbytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ring slot of plane z + d for the plane z in slot s (0 <= s < R, |d| < R).
template <int R>
__device__ __forceinline__ int zm_slot(int s, int d) {
  int v = s + d;
  if (d < 0 && v < 0) v += R;
  if (d > 0 && v >= R) v -= R;
  return v;
}

// `SWEEPS` red-black sweeps u -> out on the z-marching tile (see above).
// What a thread does at every step is worked out once here.  Warp w copies
// row w, a lane per column, so each copy instruction reads one whole
// 128-byte line (its shared-memory writes meet in pairs on 16 banks); the
// global addresses start in plane 0 and advance a plane per step (a cell
// outside the array copies 0 bytes from a clamped address inside it).
// Thread tid updates row (tid / 16) mod TY at pair tid mod 16 in the passes
// of colour g = tid / 16 div TY.  The core cells are stored by threads in
// order.
template <int SWEEPS>
__global__ void __launch_bounds__(Zm<2 * SWEEPS>::THREADS)
    rbgs3d_zmarch_kernel(const float* __restrict__ u,
                         const float* __restrict__ b, float* __restrict__ out,
                         int nz, int ny, int nx, int nzl, int nyl, int nxl,
                         float c, float inv6) {
  constexpr int P = 2 * SWEEPS;
  using T = Zm<P>;
  extern __shared__ __align__(16) float zm_smem[];  // u ring, then b ring
  constexpr int BRING = T::RU * T::SLICE;           // word of the b ring
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(zm_smem));
  // tile cell (0, 0) is (i0, j0); j0 is even, so local parity is global
  const int i0 = blockIdx.y * T::CH - T::H;
  const int j0 = blockIdx.x * T::CW - T::HC;
  const long long plane = (long long)ny * nx;
  const int tid = threadIdx.x, p = tid & (kZmPairs - 1);
  const int x0 = j0 + 2 * p;
  // whether the pair's even / odd column is an interior column
  const bool col0 = x0 > 0 && x0 < nxl - 1;
  const bool col1 = x0 + 1 > 0 && x0 + 1 < nxl - 1;
  // the copy
  int ldw;                 // its word in a z-plane
  unsigned lbytes;         // 4 inside the array, 0 outside
  bool lint;               // an interior (y, x) cell
  const float* gu;         // its address in plane 0 of u (clamped)
  const float* gb;         // and of b
  {
    const int rr = tid >> 5, lc = tid & 31;  // row, column of the tile
    const int y = i0 + rr, x = j0 + lc;
    ldw = (lc & 1) * T::CP + rr * kZmPairs + (lc >> 1);
    lbytes = (x >= 0 && x < nx && y >= 0 && y < ny) ? 4u : 0u;
    lint = y > 0 && y < nyl - 1 && x > 0 && x < nxl - 1;
    const long long g = (long long)min(max(y, 0), ny - 1) * nx +
                        min(max(x, 0), nx - 1);
    gu = u + g;
    gb = b + g;
  }
  // the store: at most one core cell per thread
  int sdw = 0;
  float* go = nullptr;     // its address in plane 0 of out, if it has one
  {
    const int t = tid;
    const int sr = T::H + t / T::CW, lc = T::HC + t % T::CW;
    const int y = i0 + sr, x = j0 + lc;
    sdw = (lc & 1) * T::CP + sr * kZmPairs + (lc >> 1);
    if (t < T::CH * T::CW && y < ny && x < nx) {
      go = out + (long long)y * nx + x;
    }
  }
  static_assert(T::CH * T::CW <= T::THREADS, "one core cell per thread");
  // the update: row r, its pair's word in plane 0, its colour g, the passes
  // of that colour whose rows k .. TY-1-k hold r, parity and interior cells
  const int r = (tid / kZmPairs) % T::TY;
  const int g = (tid / kZmPairs) / T::TY;
  const int q0 = r * kZmPairs + p;
  unsigned rk = 0;  // bit k: pass k updates row r
#pragma unroll
  for (int k = 1; k <= P; ++k) {
    rk |= static_cast<unsigned>(((k - 1) & 1) == g && r >= k &&
                                r <= T::TY - 1 - k) << k;
  }
  const int yr = i0 + r;
  const unsigned rpar = yr & 1;
  const bool yin = yr > 0 && yr < nyl - 1;
  const unsigned intm = static_cast<unsigned>(yin && col0) |
                        (static_cast<unsigned>(yin && col1) << 1);

  // one commit group per plane, empty past the last: group t is plane t
#pragma unroll
  for (int z = 0; z < kZmAhead; ++z) {
    if (z < nz) {
      cp_async4(sbase + 4u * (z * T::SLICE + ldw), gu, lbytes);
      cp_async4(sbase + 4u * (BRING + z * T::SLICE + ldw), gb, lbytes);
    }
    cp_async_commit();
    gu += plane;
    gb += plane;
  }
  int su = 0, sb = 0;  // ring slots of plane t
  for (int t = 0; t <= nz + 1 + T::SPAN; ++t) {
    cp_async_wait<kZmAhead - 1>();  // plane t has landed
    __syncthreads();  // plane t is visible; step t - 1 is done with its slots
    if (t + kZmAhead < nz) {
      const int lu = zm_slot<T::RU>(su, kZmAhead);
      const int lb = zm_slot<T::RB>(sb, kZmAhead);
      cp_async4(sbase + 4u * (lu * T::SLICE + ldw), gu, lbytes);
      cp_async4(sbase + 4u * (BRING + lb * T::SLICE + ldw), gb, lbytes);
      gu += plane;
      gb += plane;
    }
    cp_async_commit();
    // b / c of plane t, first read in step t + 1: off this step's path
    if (t < nz && lint && t > 0 && t < nzl - 1) {
      float* cell = zm_smem + BRING + sb * T::SLICE + ldw;
      *cell = __fdiv_rn(*cell, c);
    }
    const int zs = t - 2 - T::SPAN;  // finished by pass P in step t - 1
    if (zs >= 0 && zs < nz && go != nullptr) {
      go[zs * plane] =
          zm_smem[zm_slot<T::RU>(su, -2 - T::SPAN) * T::SLICE + sdw];
    }
    // the thread's passes: k = g + 1, g + 3, ... on plane t - 1 - 2 (k - 1)
#pragma unroll
    for (int k = 1; k <= P; ++k) {
      const int z = t - 1 - kZmLag * (k - 1);
      if (!((rk >> k) & 1u) || z < 0 || z >= nz) continue;
      const int s0 = zm_slot<T::RU>(su, -1 - kZmLag * (k - 1)) * T::SLICE;
      const unsigned a = ((z + k - 1) & 1) ^ rpar;  // the active plane
      const int q = q0 + (a ? T::CP : 0);
      const int e = a ? q0 + 1 : q0 + T::CP;  // east; west is e - 1
      const int bq = BRING + zm_slot<T::RB>(sb, -1 - kZmLag * (k - 1)) *
                                 T::SLICE + q;
      float v = zm_smem[bq];  // b / c inside, b on the boundary
      if (z > 0 && z < nzl - 1 && ((intm >> a) & 1u)) {
        const int sn = zm_slot<T::RU>(su, -2 - kZmLag * (k - 1)) * T::SLICE;
        const int ss = zm_slot<T::RU>(su, -kZmLag * (k - 1)) * T::SLICE;
        float nb = __fadd_rn(zm_smem[s0 + q - kZmPairs],
                             zm_smem[s0 + q + kZmPairs]);  // N + S
        nb = __fadd_rn(nb, zm_smem[s0 + e]);               // east
        nb = __fadd_rn(nb, zm_smem[s0 + e - 1]);           // west
        nb = __fadd_rn(nb, zm_smem[sn + q]);               // z - 1
        nb = __fadd_rn(nb, zm_smem[ss + q]);               // z + 1
        v = __fmul_rn(__fadd_rn(v, nb), inv6);
      }
      zm_smem[s0 + q] = v;
    }
    su = zm_slot<T::RU>(su, 1);
    sb = zm_slot<T::RB>(sb, 1);
  }
}

// ---------------------------------------------------------------------------
// The residual, residual3d_march_kernel: r = b - (boundary ? u : c * (6u -
// ((((N + S) + E) + W) + Zn) + Zs)), residual3d_point_kernel's ops in its
// order, so bit-equal to it and to the twin, on a z-chunked march.
//
// Bound: memory, 12 B per point (read u and b, write r).  The one-thread-
// per-point kernel fetches each plane of u three times through L2 (as z - 1,
// z and z + 1 of its neighbours) and, at the exact-layout levels (nx = 513,
// 257, ...), leaves the last x-block of every row nearly empty.  Here:
// * One block per kR3X x kR3Y x-y tile and z-chunk of `zc` planes; a thread
//   per (y, x) column walks the chunk's planes, keeping u at z - 1 and z in
//   registers, so each plane of u is copied once per chunk (a chunk re-reads
//   the planes just outside it: 2 / zc of the array).
// * N, S, E and W come from a shared copy of plane z with a one-cell ring,
//   Zs from the copy of plane z + 1; b lands beside each plane.  Copies are
//   4-byte cp.async with zero fill (any alignment: the rows of nx = 513 are
//   not 16-byte aligned), kR3Ahead planes ahead of the one computed, in a
//   ring of kR3Ahead + 2 slots: one barrier per plane.
// * r is stored once per point, two warps per tile row: coalesced.
// * The chunk keeps every SM busy: zc = ceil(nz * tiles / kR3TargetBlocks),
//   clamped to 1 .. kR3MaxChunk, so every level that has the planes
//   launches about kR3TargetBlocks blocks or more (513^3: zc 32, 9945
//   blocks; 257^3: 32, 1485; 129^3: 13, 510; 65^3: 3, 396; 33^3: 1, 165).
// * Tiles of 64 x 8 and 4 planes in flight: on the H100, 64-column tiles
//   (two warps a row, longer runs of each row) beat 32 and 128 columns at
//   513^3, and 2 to 8 planes in flight differ by a few per cent
//   (benchmarks/residual3d_march_probe.py).
// * Planes 0 and >= nzl - 1, rows and columns at the array's edge are
//   boundary points, which read no neighbour, so no copy leaves the array
//   and the zeros of the ring are never read.
// The march needs only u's 7-point neighbourhood: apply3d and jacobi3d
// could take the same body.
//
// The geometry is mirrored by ops/cuda_stencil_3d.residual3d_tile; the C
// entry point refuses another.
constexpr int kR3X = 64;                    // tile columns: two warps a row
constexpr int kR3Y = 8;                     // tile rows
constexpr int kR3Threads = kR3X * kR3Y;     // a thread per (y, x) column
constexpr int kR3PX = kR3X + 2;             // plane copy, one-cell ring
constexpr int kR3Plane = kR3PX * (kR3Y + 2);  // words per plane copy
constexpr int kR3Ahead = 4;                 // planes in flight
constexpr int kR3Slots = kR3Ahead + 2;      // ring slots
constexpr int kR3MaxChunk = 32;             // planes per chunk at most
constexpr int kR3TargetBlocks = 528;        // 4 per SM of an H100's 132
// copies of a plane copy per thread
constexpr int kR3Copies = (kR3Plane + kR3Threads - 1) / kR3Threads;
static_assert(kR3Slots * (kR3Plane + kR3Threads) * 4 <= 48 * 1024, "smem");

// The chunk length for an (nz, ny, nx) array (the rule above).
int residual3d_chunk(int nz, int ny, int nx) {
  const long long tiles =
      (long long)((nx + kR3X - 1) / kR3X) * ((ny + kR3Y - 1) / kR3Y);
  const long long zc = (nz * tiles + kR3TargetBlocks - 1) / kR3TargetBlocks;
  return (int)(zc < 1 ? 1 : zc > kR3MaxChunk ? kR3MaxChunk : zc);
}

__global__ void __launch_bounds__(kR3Threads)
    residual3d_march_kernel(const float* __restrict__ u,
                            const float* __restrict__ b,
                            float* __restrict__ r, int nz, int ny, int nx,
                            int nzl, int nyl, int nxl, float c, int zc) {
  __shared__ __align__(16) float su[kR3Slots][kR3Plane];
  __shared__ __align__(16) float sb[kR3Slots][kR3Threads];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kR3X, y0 = blockIdx.y * kR3Y;
  const int z0 = blockIdx.z * zc, z1 = min(z0 + zc, nz);
  const long long plane = (long long)ny * nx;
  // the copies: word q of a plane copy is local (q / kR3PX, q % kR3PX), the
  // array's (y0 - 1 + row, x0 - 1 + col); offsets in plane 0 (clamped
  // inside the array: a cell outside copies 0 bytes)
  int cw[kR3Copies];
  unsigned cb[kR3Copies];
  long long co[kR3Copies];
#pragma unroll
  for (int k = 0; k < kR3Copies; ++k) {
    const int q = tid + k * kR3Threads;
    const int y = y0 - 1 + q / kR3PX, x = x0 - 1 + q % kR3PX;
    const bool in = q < kR3Plane && y >= 0 && y < ny && x >= 0 && x < nx;
    cw[k] = q < kR3Plane ? q : -1;
    cb[k] = in ? 4u : 0u;
    co[k] = in ? (long long)y * nx + x : 0;
  }
  // the thread's point (y, x) and its word in a plane copy
  const int ty = tid / kR3X, tx = tid % kR3X;
  const int y = y0 + ty, x = x0 + tx;
  const bool own = y < ny && x < nx;
  const long long go = own ? (long long)y * nx + x : 0;
  const int cq = (ty + 1) * kR3PX + tx + 1;
  const bool yx_in = y > 0 && y < nyl - 1 && x > 0 && x < nxl - 1;
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(su));
  const unsigned bbase = static_cast<unsigned>(__cvta_generic_to_shared(sb));

  // one commit group per plane p of z0 .. z1 (z1: for the last Zs), empty
  // past them: the group of plane p is committed before step p - kR3Ahead
  auto issue = [&](int p, int slot) {
    if (p <= z1 && p < nz) {
      const long long off = (long long)p * plane;
#pragma unroll
      for (int k = 0; k < kR3Copies; ++k) {
        if (cw[k] >= 0) {
          cp_async4(sbase + 4u * (slot * kR3Plane + cw[k]), u + off + co[k],
                    cb[k]);
        }
      }
      cp_async4(bbase + 4u * (slot * kR3Threads + tid), b + off + go,
                own ? 4u : 0u);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p <= kR3Ahead; ++p) issue(z0 + p, p);
  // u at z - 1 and z of the thread's column
  float zn = (z0 > 0 && own) ? u[(long long)(z0 - 1) * plane + go] : 0.0f;
  float uc = 0.0f;
  int s = 0;  // the slot of plane z
  for (int z = z0; z < z1; ++z) {
    cp_async_wait<kR3Ahead - 1>();  // planes z and z + 1 have landed
    __syncthreads();  // visible to all; step z - 1 is done with its slot
    const int s1 = s + 1 == kR3Slots ? 0 : s + 1;
    const int sl = s == 0 ? kR3Slots - 1 : s - 1;  // plane z - 1's slot
    issue(z + kR3Ahead + 1, sl);
    const float* p = su[s];
    if (z == z0) uc = p[cq];
    const float zs = z + 1 < nz ? su[s1][cq] : 0.0f;
    float a = uc;
    if (yx_in && z > 0 && z < nzl - 1) {
      float nb = __fadd_rn(p[cq - kR3PX], p[cq + kR3PX]);  // N + S
      nb = __fadd_rn(nb, p[cq + 1]);                       // east
      nb = __fadd_rn(nb, p[cq - 1]);                       // west
      nb = __fadd_rn(nb, zn);                              // z - 1
      nb = __fadd_rn(nb, zs);                              // z + 1
      a = __fmul_rn(c, __fsub_rn(__fmul_rn(6.0f, uc), nb));
    }
    if (own) r[(long long)z * plane + go] = __fsub_rn(sb[s][tid], a);
    zn = uc;
    uc = zs;
    s = s1;
  }
}

constexpr int kResidentMaxPoints = 16384;  // u and b / c: 128 KB
constexpr int kResThreads = 1024;
// sites (z, y, column pair) per thread: nz * ny * ceil(nx / 2) is at most
// 2/3 of the points (nx >= 2)
constexpr int kResSites =
    (2 * kResidentMaxPoints / 3 + kResThreads - 1) / kResThreads;

// `sweeps` red-black sweeps u -> out with the whole array in shared memory
// (see above), b divided by c once at the interior points.  A thread keeps
// its sites for every pass: site s is (z, y, pair p), and colour c's cell
// there is column 2p + ((z + y + c) & 1), so every lane has a cell of each
// colour (the last pair of an odd row has one).
__global__ void __launch_bounds__(kResThreads)
    rbgs3d_resident_kernel(const float* __restrict__ u,
                           const float* __restrict__ b,
                           float* __restrict__ out, int nz, int ny, int nx,
                           int nzl, int nyl, int nxl, float c, float inv6,
                           int sweeps) {
  extern __shared__ __align__(16) float rs_smem[];
  const int n = nz * ny * nx, plane = ny * nx;
  float* su = rs_smem;
  float* sb = rs_smem + n;
  for (int i = threadIdx.x; i < n; i += kResThreads) {
    const int x = i % nx, y = (i / nx) % ny, z = i / plane;
    su[i] = u[i];
    sb[i] = (z == 0 || y == 0 || x == 0 || z >= nzl - 1 || y >= nyl - 1 ||
             x >= nxl - 1)
                ? b[i]
                : __fdiv_rn(b[i], c);
  }
  const int npair = (nx + 1) / 2;
  const int nsites = nz * ny * npair;
  int off[kResSites];      // the site's even column, as an offset
  int x0[kResSites];       // and as a column
  unsigned zyp = 0;        // bit k: (z + y) & 1 of site k
  unsigned zyb = 0;        // bit k: site k's (z, y) row is a boundary row
#pragma unroll
  for (int k = 0; k < kResSites; ++k) {
    const int s = threadIdx.x + k * kResThreads;
    const int p = s % npair, zy = s / npair;
    const int y = zy % ny, z = zy / ny;
    off[k] = zy * nx + 2 * p;
    x0[k] = 2 * p;
    zyp |= static_cast<unsigned>((z + y) & 1) << k;
    zyb |= static_cast<unsigned>(z == 0 || y == 0 || z >= nzl - 1 ||
                                 y >= nyl - 1) << k;
  }
  __syncthreads();
  for (int pass = 0; pass < 2 * sweeps; ++pass) {
    const unsigned colour = pass & 1;
#pragma unroll
    for (int k = 0; k < kResSites; ++k) {
      const int a = static_cast<int>(((zyp >> k) & 1u) ^ colour);
      const int x = x0[k] + a;
      if (threadIdx.x + k * kResThreads >= nsites || x >= nx) continue;
      const int i = off[k] + a;
      float v = sb[i];  // b / c inside, b on the boundary
      if (!(((zyb >> k) & 1u) || x == 0 || x >= nxl - 1)) {
        float nb = __fadd_rn(su[i - nx], su[i + nx]);  // N + S
        nb = __fadd_rn(nb, su[i + 1]);                 // east
        nb = __fadd_rn(nb, su[i - 1]);                 // west
        nb = __fadd_rn(nb, su[i - plane]);             // z - 1
        nb = __fadd_rn(nb, su[i + plane]);             // z + 1
        v = __fmul_rn(__fadd_rn(v, nb), inv6);
      }
      su[i] = v;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += kResThreads) out[i] = su[i];
}

template <int S>
int rbgs3d_zmarch_launch(const float* u, const float* b, float* out, int nz,
                         int ny, int nx, int nzl, int nyl, int nxl, float c,
                         float inv6, const int* geom, cudaStream_t stream) {
  using T = Zm<2 * S>;
  static bool smem_set = false;
  if (geom[0] != T::H || geom[1] != T::HC || geom[2] != T::TY ||
      geom[3] != kZmCols || geom[4] != T::RU || geom[5] != T::RB) {
    return (int)cudaErrorInvalidValue;
  }
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rbgs3d_zmarch_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((nx + T::CW - 1) / T::CW, (ny + T::CH - 1) / T::CH);
  rbgs3d_zmarch_kernel<S><<<grid, T::THREADS, T::SMEM, stream>>>(
      u, b, out, nz, ny, nx, nzl, nyl, nxl, c, inv6);
  return (int)cudaGetLastError();
}

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

dim3 grid3d_for(int nz, int ny, int nx) {
  return dim3((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY, nz);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" {

int mg_apply3d(const float* u, float* y, int nz, int ny, int nx, int nzl,
               int nyl, int nxl, float c, void* stream) {
  apply3d_kernel<<<grid3d_for(nz, ny, nx), dim3(kBlockX, kBlockY), 0,
                   (cudaStream_t)stream>>>(u, y, nz, ny, nx, nzl, nyl, nxl, c);
  return (int)cudaGetLastError();
}

// The residual on the z-chunked march; geom = (tile columns, tile rows,
// planes per chunk, planes in flight) as the caller computed them, refused
// unless they are the compiled ones and the chunk rule's for this shape.
int mg_residual3d(const float* u, const float* b, float* r, int nz, int ny,
                  int nx, int nzl, int nyl, int nxl, float c, const int* geom,
                  void* stream) {
  const int zc = residual3d_chunk(nz, ny, nx);
  if (geom[0] != kR3X || geom[1] != kR3Y || geom[2] != zc ||
      geom[3] != kR3Ahead) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nx + kR3X - 1) / kR3X, (ny + kR3Y - 1) / kR3Y,
                  (nz + zc - 1) / zc);
  residual3d_march_kernel<<<grid, kR3Threads, 0, (cudaStream_t)stream>>>(
      u, b, r, nz, ny, nx, nzl, nyl, nxl, c, zc);
  return (int)cudaGetLastError();
}

// The one-thread-per-point residual (chip_smoke.py's reference only).
int mg_residual3d_point(const float* u, const float* b, float* r, int nz,
                        int ny, int nx, int nzl, int nyl, int nxl, float c,
                        void* stream) {
  residual3d_point_kernel<<<grid3d_for(nz, ny, nx), dim3(kBlockX, kBlockY), 0,
                            (cudaStream_t)stream>>>(u, b, r, nz, ny, nx, nzl,
                                                    nyl, nxl, c);
  return (int)cudaGetLastError();
}

int mg_rbgs3d_color(float* u, const float* b, int nz, int ny, int nx, int nzl,
                    int nyl, int nxl, float c, float inv6, int color,
                    void* stream) {
  rbgs3d_color_kernel<<<grid3d_for(nz, ny, nx), dim3(kBlockX, kBlockY), 0,
                        (cudaStream_t)stream>>>(u, b, nz, ny, nx, nzl, nyl,
                                                nxl, c, inv6, color);
  return (int)cudaGetLastError();
}

// `sweeps` (1 .. 4) red-black sweeps u -> out on the z-marching tile; geom
// = (row halo, column halo, tile rows, tile columns, u ring planes, b ring
// planes) as the caller computed it, refused unless it is the compiled one.
int mg_rbgs3d_fused(const float* u, const float* b, float* out, int nz,
                    int ny, int nx, int nzl, int nyl, int nxl, float c,
                    float inv6, int sweeps, const int* geom, void* stream) {
  static const decltype(&rbgs3d_zmarch_launch<1>) kLaunch[] = {
      rbgs3d_zmarch_launch<1>, rbgs3d_zmarch_launch<2>,
      rbgs3d_zmarch_launch<3>, rbgs3d_zmarch_launch<4>};
  if (sweeps < 1 || sweeps > 4) return (int)cudaErrorInvalidValue;
  return kLaunch[sweeps - 1](u, b, out, nz, ny, nx, nzl, nyl, nxl, c, inv6,
                             geom, (cudaStream_t)stream);
}

// `sweeps` (>= 1) red-black sweeps u -> out with the whole array in one
// block's shared memory; refused above kResidentMaxPoints points, or when
// the caller's cap (max_points) is not that constant.
int mg_rbgs3d_resident(const float* u, const float* b, float* out, int nz,
                       int ny, int nx, int nzl, int nyl, int nxl, float c,
                       float inv6, int sweeps, int max_points, void* stream) {
  static bool smem_set = false;
  const long long n = (long long)nz * ny * nx;
  if (max_points != kResidentMaxPoints || n > kResidentMaxPoints ||
      nx < 2 || sweeps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = 2 * kResidentMaxPoints * (int)sizeof(float);
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rbgs3d_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  rbgs3d_resident_kernel<<<1, kResThreads, 2 * (int)n * (int)sizeof(float),
                           (cudaStream_t)stream>>>(
      u, b, out, nz, ny, nx, nzl, nyl, nxl, c, inv6, sweeps);
  return (int)cudaGetLastError();
}

int mg_jacobi3d(const float* x, const float* b, float* y, int nz, int ny,
                int nx, int nzl, int nyl, int nxl, float c, float inv6,
                int damped, float one_minus_omega, float omega,
                void* stream) {
  jacobi3d_kernel<<<grid3d_for(nz, ny, nx), dim3(kBlockX, kBlockY), 0,
                    (cudaStream_t)stream>>>(x, b, y, nz, ny, nx, nzl, nyl,
                                            nxl, c, inv6, damped,
                                            one_minus_omega, omega);
  return (int)cudaGetLastError();
}

}  // extern "C"
