// 3D 7-point Poisson stencil kernels for Hopper (sm_90a): the smoothers,
// residual and operator apply of the 3D GMG V-cycle.
//
// Ports of the Pallas TPU kernels in
// multigrid_prj_tpu/ops/pallas_stencil_3d.py:
//   apply3d      <- poisson_apply_3d (_apply3d_kernel): the residual's
//                   z-chunked march without b (below); apply3d_point, one
//                   thread per point, is the first port, on no path
//   residual3d   <- poisson_residual_3d (_residual3d_kernel): a z-chunked
//                   march (below)
//   rbgs3d_fused <- red_black_gauss_seidel_3d (_rbgs3d_color_kernel, one
//                   pass per colour there): the smoother, up to 4 sweeps
//                   per launch on a z-marching tile, or every sweep of a
//                   small array in one launch (below)
//   rbgs3d_color <- the same, one colour per launch: the per-colour oracle
//                   that rbgs3d_fused is held to (no solver path)
//   jacobi3d     <- jacobi_3d (_jacobi3d_kernel, one pass per sweep there):
//                   up to 4 sweeps per launch on a z-chunked march, or every
//                   sweep of a small array in one launch (below)
//   jacobi3d_sweep <- the same, one sweep per launch: the per-sweep oracle
//                   that jacobi3d is held to (no solver path)
// and four kernels that port no TPU kernel:
//   ff_residual3d <- ops/extended.ff_poisson_residual on a 3-D array (XLA
//                   fused it on the TPU): the float-float residual of the
//                   refined solve, on the residual's z-chunked march (below)
//   ff_update_residual3d <- the same, fused with the refined solve's pair
//                   update (ops/extended.ff_accumulate), on the same march
//   restrict_fw3d <- ops/transfer.restrict_full_weighting on a 3-D array
//                   (XLA fused it on the TPU): the V-cycle's restriction at
//                   exact-layout levels, a march over coarse planes (below)
//   prolong_add3d <- u + ops/transfer.prolong(e, u.shape) on a 3-D array
//                   (the same): the V-cycle's prolong-add there, a march
//                   over coarse planes emitting two fine planes a step
//
// Layout: a contiguous f32 array of shape (nz, ny, nx), with 64-bit
// offsets (nz*ny*nx passes 2^31 at about 1291^3).  (nzl, nyl, nxl) are the
// logical extents: a point is boundary if any index is 0 or at/beyond its
// logical extent - 1, which pins the padded dead zone.  Boundary points
// never read neighbours and every array-edge point is a boundary point, so
// no read leaves the array.  Any 3D shape is accepted: the TPU kernels
// needed nx % 128 == 0 and ny % 8 == 0 (flattened (nz*ny, nx) row blocks
// that divide ny), Hopper needs no alignment.
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
// apply3d_point, rbgs3d_color and jacobi3d_sweep are the simple first
// versions, kept as oracles: one thread per point on a 3D grid of 32 x 8
// blocks (x fastest), neighbours read through L1/L2 (no
// shared-memory tiling), one launch per colour half-sweep or Jacobi sweep.
// Each streams its operands from HBM once per launch and is bound by memory
// bandwidth (bytes per point are noted at each kernel).  The smoothers'
// launch shapes are described above rbgs3d_zmarch_kernel and
// jacobi3d_march_kernel, the residual's and the apply's march above
// stencil3d_march_kernel, the float-float residual's above
// ff_residual3d_march_kernel and ff_update_residual3d_march_kernel, the
// transfers' above restrict_fw3d_kernel.

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

// y = boundary ? u : c*(6u - nb), one thread per point: the first port of
// _apply3d_kernel (:107), kept only as the oracle of the march
// (stencil3d_march_kernel<false> below, which replaces it on every path).
// 8 B/point: read u, write y (neighbour reads hit L1/L2).
__global__ void apply3d_point_kernel(const float* __restrict__ u,
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
//   host.  12 B/point: read x and b, write y.  The per-sweep oracle of the
//   fused smoother below (ops/cuda_stencil_3d._jacobi3d_per_sweep), on no
//   solver path.
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
//   argument of stencil2d.cu) and chunk of zc output planes z0 .. z1 - 1
//   loads planes z0 - P .. z1 + P - 1, clamped to the array: the ring
//   argument in z.  The passes run as in a march over every plane, also on
//   the planes the chunk does not load, whose ring slots hold whatever they
//   held: each pass reads one plane further than the last, so pass k leaves
//   planes z0 - P + k .. z1 + P - 1 - k right and pass P the chunk, which
//   alone is stored; the planes around it are computed again by the blocks
//   beside it, as the x-y halo is.  Planes 0 and >= nzl - 1 are boundary
//   planes, which read no neighbour, so the chunks at the array's ends need
//   no planes beyond it.  A chunk of nz planes is one march over every
//   plane.
// * The chunk fills the SMs that one block per tile would leave idle: zc =
//   ceil(nz / max(kZmTargetBlocks / tiles, 1)), at least kZmMinChunk, cuts
//   each tile's march into as many chunks as one wave of one block per SM
//   holds (257^3: one chunk of 257 planes, 121 blocks; 129^3: 43, 108;
//   65^3: 5, 117; 33^3: 1, 132).  A chunk costs 3 P steps more than its
//   planes, and a block's steps are bound by its SM's issue and shared-
//   memory throughput, not by their latency: on the H100 two blocks of 32
//   registers on one SM took as long as one block after the other, and
//   waves of more blocks were slower (benchmarks/rbgs3d_chunk_probe.py).
// * Registers: at most kZmRegisters = 48 a thread (__maxnreg__; one block
//   of 1024 threads an SM, as the rings of 3 and 4 sweeps allow anyway).
//   On the H100, left to itself ptxas chose 32 at 1 and 2 sweeps and the
//   2-sweep call took 363 us at 257^3; __launch_bounds__(1024, 1) gave 48
//   registers and 349 us; __maxnreg__ of 40 to 64 gave 38 to 48 and 275 to
//   280 us.  The attribute stands before __global__, where
//   portbench/trace.py's reader of the port's kernel names finds the name.
// * The 2 x SWEEPS colour passes run as a wavefront in z, kZmLag = 2 planes
//   apart, all in the same step with one barrier per step: at step t the
//   block runs pass k on plane t - 1 - 2 (k - 1), in place.  This is exact
//   because a colour reads only the other colour.  Pass k on plane z reads
//   planes z - 1 .. z + 1 of the colour that passes k - 1 and k + 1 write:
//   pass k - 1 finished z + 1 a step earlier, pass k + 1 reaches z - 1 a step
//   later, and the passes running beside it write planes an even number of
//   planes away, none of which it reads.  With a lag of one plane, pass k + 1
//   would rewrite z - 1 in the same step as pass k reads it.
// * A block walks its planes one after another, so a step's work is
//   spread as thin as it goes: a thread per (row, column pair) for each
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
constexpr int kZmTargetBlocks = 132;   // blocks of one wave: 1 per SM
constexpr int kZmMinChunk = 1;         // planes per chunk at least
constexpr int kZmRegisters = 48;       // per thread at most (__maxnreg__)

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

// The chunk length of P passes on an (nz, ny, nx) array (the rule above).
template <int P>
int rbgs3d_chunk(int nz, int ny, int nx) {
  using T = Zm<P>;
  const long long tiles =
      (long long)((nx + T::CW - 1) / T::CW) * ((ny + T::CH - 1) / T::CH);
  const long long chunks = tiles < kZmTargetBlocks ? kZmTargetBlocks / tiles
                                                   : 1;
  const int zc = (int)((nz + chunks - 1) / chunks);
  return zc < kZmMinChunk ? kZmMinChunk : zc;
}

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
// global addresses start in the chunk's first input plane and advance a
// plane per step (a cell outside the array copies 0 bytes from a clamped
// address inside it).
// Thread tid updates row (tid / 16) mod TY at pair tid mod 16 in the passes
// of colour g = tid / 16 div TY.  The core cells are stored by threads in
// order.
template <int SWEEPS>
__maxnreg__(kZmRegisters) __global__ void
    rbgs3d_zmarch_kernel(const float* __restrict__ u,
                         const float* __restrict__ b, float* __restrict__ out,
                         int nz, int ny, int nx, int nzl, int nyl, int nxl,
                         float c, float inv6, int zc) {
  constexpr int P = 2 * SWEEPS;
  using T = Zm<P>;
  extern __shared__ __align__(16) float zm_smem[];  // u ring, then b ring
  constexpr int BRING = T::RU * T::SLICE;           // word of the b ring
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(zm_smem));
  // tile cell (0, 0) is (i0, j0); j0 is even, so local parity is global
  const int i0 = blockIdx.y * T::CH - T::H;
  const int j0 = blockIdx.x * T::CW - T::HC;
  // the chunk's output planes z0 .. z1 - 1, its input planes p0 .. pe
  const int z0 = blockIdx.z * zc, z1 = min(z0 + zc, nz);
  const int p0 = max(z0 - P, 0), pe = min(z1 + P, nz) - 1;
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
    const long long g = (long long)p0 * plane +
                        (long long)min(max(y, 0), ny - 1) * nx +
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

  // one commit group per plane, empty past pe: group t - p0 is plane t
#pragma unroll
  for (int z = 0; z < kZmAhead; ++z) {
    if (p0 + z <= pe) {
      cp_async4(sbase + 4u * (z * T::SLICE + ldw), gu, lbytes);
      cp_async4(sbase + 4u * (BRING + z * T::SLICE + ldw), gb, lbytes);
    }
    cp_async_commit();
    gu += plane;
    gb += plane;
  }
  int su = 0, sb = 0;  // ring slots of plane t
  for (int t = p0; t <= z1 + 1 + T::SPAN; ++t) {
    cp_async_wait<kZmAhead - 1>();  // plane t has landed
    __syncthreads();  // plane t is visible; step t - 1 is done with its slots
    if (t + kZmAhead <= pe) {
      const int lu = zm_slot<T::RU>(su, kZmAhead);
      const int lb = zm_slot<T::RB>(sb, kZmAhead);
      cp_async4(sbase + 4u * (lu * T::SLICE + ldw), gu, lbytes);
      cp_async4(sbase + 4u * (BRING + lb * T::SLICE + ldw), gb, lbytes);
      gu += plane;
      gb += plane;
    }
    cp_async_commit();
    // b / c of plane t, first read in step t + 1: off this step's path
    if (t <= pe && lint && t > 0 && t < nzl - 1) {
      float* cell = zm_smem + BRING + sb * T::SLICE + ldw;
      *cell = __fdiv_rn(*cell, c);
    }
    const int zs = t - 2 - T::SPAN;  // finished by pass P in step t - 1
    if (zs >= z0 && zs < z1 && go != nullptr) {
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
// The residual and the apply, stencil3d_march_kernel<kResidual>: r = b -
// (boundary ? u : c * (6u - ((((N + S) + E) + W) + Zn) + Zs)) with
// kResidual, y = (boundary ? u : c * (...)) without (no b is copied),
// apply3d_point_kernel's ops in their order, so bit-equal to it and to the
// twins, on a z-chunked march.
//
// Bound: memory, 12 B per point for the residual (read u and b, write r),
// 8 B for the apply (read u, write y).  The one-thread-
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
// The apply takes the same geometry and chunk rule as the residual.
//
// The geometry is mirrored by ops/cuda_stencil_3d.residual3d_tile; the C
// entry points refuse another.
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

template <bool kResidual>
__global__ void __launch_bounds__(kR3Threads)
    stencil3d_march_kernel(const float* __restrict__ u,
                           const float* __restrict__ b,
                           float* __restrict__ r, int nz, int ny, int nx,
                           int nzl, int nyl, int nxl, float c, int zc) {
  __shared__ __align__(16) float su[kR3Slots][kR3Plane];
  __shared__ __align__(16) float sb[kResidual ? kR3Slots : 1][kR3Threads];
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
      if constexpr (kResidual) {
        cp_async4(bbase + 4u * (slot * kR3Threads + tid), b + off + go,
                  own ? 4u : 0u);
      }
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
    if constexpr (kResidual) {
      if (own) r[(long long)z * plane + go] = __fsub_rn(sb[s][tid], a);
    } else {
      if (own) r[(long long)z * plane + go] = a;
    }
    zn = uc;
    uc = zs;
    s = s1;
  }
}

// ---------------------------------------------------------------------------
// The float-float residual, ff_residual3d_march_kernel: with u = (uh, ul)
// and d = b / c = (dh, dl) carried as pairs, ops/extended.ff_poisson_residual
// op for op on a 3-D array:
//   acc = ff_add(4 uh, 4 ul, 2 uh, 2 ul);
//   acc = ff_add(acc, -nb) for nb at z + 1, z - 1, y + 1, y - 1, x + 1, x - 1;
//   t = ff_add(d, -acc);  interior r = c t_hi + c t_lo;
//   boundary and dead-zone r = (b - uh) - ul;
// every operation an explicit __f*_rn, so bit-equal to that function.  It
// replaces no TPU kernel: XLA fused the twin's elementwise chain on the TPU,
// and torch on the card runs it as ~120 separate passes over the arrays.
//
// Bound: memory, 24 B per point (read uh, ul, dh, dl and b, write r; 16 B
// at boundary points, which need no d).  The arithmetic (8 float-float
// additions, ~95 flops a point) is about a fifth of that time at the card's
// f32 rate.  The design is the residual's march (stencil3d_march_kernel
// above) with the pair in two rings:
// * One block per x-y tile and z-chunk of the residual's march (its tile,
//   residual3d_chunk); a thread per (y, x) column walks the chunk's planes,
//   keeping the pair at z - 1 and z in registers, so each plane of uh and
//   ul is copied once per chunk (plus the two planes just outside it).
// * N, S, E and W come from shared copies of plane z of uh and ul with a
//   one-cell ring, the z + 1 pair from the copies of the next plane; dh, dl
//   and b land beside each plane without a ring, one word per thread
//   (coalesced, read once).  All copies are 4-byte cp.async with zero fill,
//   kF3Ahead planes ahead of the one computed, in a ring of kF3Ahead + 2
//   slots of 2 * 660 + 3 * 512 words: one barrier per plane.  On the H100,
//   2 planes in flight beat 1, 3 and 4 (3 and 4 fit fewer blocks per SM).
// * r is stored once per point, two warps per tile row: coalesced.
// The geometry is mirrored by ops/cuda_stencil_3d.ff_residual3d_tile; the C
// entry point refuses another.
constexpr int kF3Ahead = 2;             // planes in flight
constexpr int kF3Slots = kF3Ahead + 2;  // ring slots
// words of a slot: the copies of uh and ul, then dh, dl and b
constexpr int kF3Slot = 2 * kR3Plane + 3 * kR3Threads;
constexpr int kF3Smem = kF3Slots * kF3Slot * (int)sizeof(float);
static_assert(kR3Plane % 4 == 0 && kR3Threads % 4 == 0, "16-byte slots");
static_assert(kF3Smem <= 227 * 1024, "shared memory");

// Knuth two-sum, then the fast-two-sum normalisation of ops/extended.ff_add
// (as stencil2d.cu's ff_add).
__device__ __forceinline__ void ff_add3(float xh, float xl, float yh,
                                        float yl, float* oh, float* ol) {
  const float s = __fadd_rn(xh, yh);
  const float bb = __fsub_rn(s, xh);
  float e = __fadd_rn(__fsub_rn(xh, __fsub_rn(s, bb)), __fsub_rn(yh, bb));
  e = __fadd_rn(e, __fadd_rn(xl, yl));
  const float s2 = __fadd_rn(s, e);
  *oh = s2;
  *ol = __fsub_rn(e, __fsub_rn(s2, s));
}

__global__ void __launch_bounds__(kR3Threads)
    ff_residual3d_march_kernel(const float* __restrict__ uh,
                               const float* __restrict__ ul,
                               const float* __restrict__ dh,
                               const float* __restrict__ dl,
                               const float* __restrict__ b,
                               float* __restrict__ r, int nz, int ny, int nx,
                               int nzl, int nyl, int nxl, float c, int zc) {
  extern __shared__ __align__(16) float f3_smem[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kR3X, y0 = blockIdx.y * kR3Y;
  const int z0 = blockIdx.z * zc, z1 = min(z0 + zc, nz);
  const long long plane = (long long)ny * nx;
  // the ring copies, as stencil3d_march_kernel's
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
  const int ty = tid / kR3X, tx = tid % kR3X;
  const int y = y0 + ty, x = x0 + tx;
  const bool own = y < ny && x < nx;
  const long long go = own ? (long long)y * nx + x : 0;
  const int cq = (ty + 1) * kR3PX + tx + 1;
  const bool yx_in = y > 0 && y < nyl - 1 && x > 0 && x < nxl - 1;
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(f3_smem));

  // one commit group per plane p of z0 .. z1 (z1: only for the last z + 1
  // pair, so no d or b), empty past them
  auto issue = [&](int p, int slot) {
    if (p <= z1 && p < nz) {
      const long long off = (long long)p * plane;
      const unsigned s0 = base + 4u * (unsigned)(slot * kF3Slot);
#pragma unroll
      for (int k = 0; k < kR3Copies; ++k) {
        if (cw[k] >= 0) {
          cp_async4(s0 + 4u * cw[k], uh + off + co[k], cb[k]);
          cp_async4(s0 + 4u * (kR3Plane + cw[k]), ul + off + co[k], cb[k]);
        }
      }
      if (p < z1) {
        const unsigned nb = own ? 4u : 0u;
        const unsigned sd = s0 + 4u * (2 * kR3Plane + tid);
        cp_async4(sd, dh + off + go, nb);
        cp_async4(sd + 4u * kR3Threads, dl + off + go, nb);
        cp_async4(sd + 8u * kR3Threads, b + off + go, nb);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p <= kF3Ahead; ++p) issue(z0 + p, p);
  // the pair at z - 1 and z of the thread's column
  const long long zo = (long long)(z0 - 1) * plane + go;
  float znh = (z0 > 0 && own) ? uh[zo] : 0.0f;
  float znl = (z0 > 0 && own) ? ul[zo] : 0.0f;
  float uch = 0.0f, ucl = 0.0f;
  int s = 0;  // the slot of plane z
  for (int z = z0; z < z1; ++z) {
    cp_async_wait<kF3Ahead - 1>();  // planes z and z + 1 have landed
    __syncthreads();  // visible to all; step z - 1 is done with its slot
    const int s1 = s + 1 == kF3Slots ? 0 : s + 1;
    const int sl = s == 0 ? kF3Slots - 1 : s - 1;  // plane z - 1's slot
    issue(z + kF3Ahead + 1, sl);
    const float* ph = f3_smem + s * kF3Slot;  // plane z: uh, ul, dh, dl, b
    const float* pl = ph + kR3Plane;
    const float* pd = ph + 2 * kR3Plane + tid;
    if (z == z0) {
      uch = ph[cq];
      ucl = pl[cq];
    }
    const float* nh = f3_smem + s1 * kF3Slot;  // plane z + 1
    const float zsh = z + 1 < nz ? nh[cq] : 0.0f;
    const float zsl = z + 1 < nz ? nh[kR3Plane + cq] : 0.0f;
    float out;
    if (yx_in && z > 0 && z < nzl - 1) {
      float ah, al;
      ff_add3(__fmul_rn(4.0f, uch), __fmul_rn(4.0f, ucl),
              __fmul_rn(2.0f, uch), __fmul_rn(2.0f, ucl), &ah, &al);
      ff_add3(ah, al, -zsh, -zsl, &ah, &al);                      // z + 1
      ff_add3(ah, al, -znh, -znl, &ah, &al);                      // z - 1
      ff_add3(ah, al, -ph[cq + kR3PX], -pl[cq + kR3PX], &ah, &al);  // y + 1
      ff_add3(ah, al, -ph[cq - kR3PX], -pl[cq - kR3PX], &ah, &al);  // y - 1
      ff_add3(ah, al, -ph[cq + 1], -pl[cq + 1], &ah, &al);          // x + 1
      ff_add3(ah, al, -ph[cq - 1], -pl[cq - 1], &ah, &al);          // x - 1
      float th, tl;
      ff_add3(pd[0], pd[kR3Threads], -ah, -al, &th, &tl);
      out = __fadd_rn(__fmul_rn(c, th), __fmul_rn(c, tl));
    } else {
      out = __fsub_rn(__fsub_rn(pd[2 * kR3Threads], uch), ucl);
    }
    if (own) r[(long long)z * plane + go] = out;
    znh = uch;
    znl = ucl;
    uch = zsh;
    ucl = zsl;
    s = s1;
  }
}

// ---------------------------------------------------------------------------
// The refined solve's pair update fused into the float-float residual,
// ff_update_residual3d_march_kernel: (uh2, ul2) = ff_add_f(uh, ul, e) at
// every point (ops/extended.ff_accumulate, boundary and dead zone too), then
// ff_residual3d_march_kernel's chain on (uh2, ul2), op for op.  The update
// is ops/extended.ff_add_f: two-sum of uh and e, + ul, fast-two-sum.
//
// Bound: memory, 36 B per point (read uh, ul, e, dh, dl and b, write uh2,
// ul2 and r; 28 B at boundary points, which need no d), where the plain
// update (20 B) and the residual (24 B) took two passes.  The design is
// ff_residual3d_march_kernel's with e in a third ring beside uh and ul:
// * Each slot holds plane copies of uh, ul and e with the one-cell ring,
//   then dh, dl and b, one word per thread: 3 * 660 + 3 * 512 words, 4
//   slots (2 planes in flight) in 56256 B.
// * A thread updates, in place, the ring cells it copied itself, once its
//   copies of the plane have landed and before the step's barrier (a
//   thread sees its own cp.async writes after its wait): plane z + 1 at
//   step z, and plane z0 too at a chunk's first step.  After the barrier
//   every cell of planes z and z + 1 holds the updated pair, so the chain
//   reads the pair exactly as ff_residual3d_march_kernel reads its input:
//   ~1.3 updates a point (a plane copy's 660 cells over 512 points), none
//   recomputed per neighbour.  The column's pair at z0 - 1 is read from
//   global memory and updated in registers.
// * The updated pair at the thread's own point is stored with r, each
//   coalesced, out of place: the neighbouring blocks read the old pair, so
//   uh2 and ul2 must not alias uh, ul or e.
// The geometry is ff_residual3d_march_kernel's (its tile, chunk rule and
// depth), mirrored by ops/cuda_stencil_3d.ff_update_residual3d_tile; the C
// entry point refuses another.
constexpr int kU3Slot = 3 * kR3Plane + 3 * kR3Threads;
constexpr int kU3Smem = kF3Slots * kU3Slot * (int)sizeof(float);
static_assert(kU3Slot % 4 == 0, "16-byte slots");
static_assert(kU3Smem <= 227 * 1024, "shared memory");

// Pair + float (ops/extended.ff_add_f).
__device__ __forceinline__ void ff_add_f3(float xh, float xl, float y,
                                          float* oh, float* ol) {
  const float s = __fadd_rn(xh, y);
  const float bb = __fsub_rn(s, xh);
  float e = __fadd_rn(__fsub_rn(xh, __fsub_rn(s, bb)), __fsub_rn(y, bb));
  e = __fadd_rn(e, xl);
  const float s2 = __fadd_rn(s, e);
  *oh = s2;
  *ol = __fsub_rn(e, __fsub_rn(s2, s));
}

__global__ void __launch_bounds__(kR3Threads)
    ff_update_residual3d_march_kernel(
        const float* __restrict__ uh, const float* __restrict__ ul,
        const float* __restrict__ e, const float* __restrict__ dh,
        const float* __restrict__ dl, const float* __restrict__ b,
        float* __restrict__ uh2, float* __restrict__ ul2,
        float* __restrict__ r, int nz, int ny, int nx, int nzl, int nyl,
        int nxl, float c, int zc) {
  extern __shared__ __align__(16) float u3_smem[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kR3X, y0 = blockIdx.y * kR3Y;
  const int z0 = blockIdx.z * zc, z1 = min(z0 + zc, nz);
  const long long plane = (long long)ny * nx;
  // the ring copies, as stencil3d_march_kernel's
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
  const int ty = tid / kR3X, tx = tid % kR3X;
  const int y = y0 + ty, x = x0 + tx;
  const bool own = y < ny && x < nx;
  const long long go = own ? (long long)y * nx + x : 0;
  const int cq = (ty + 1) * kR3PX + tx + 1;
  const bool yx_in = y > 0 && y < nyl - 1 && x > 0 && x < nxl - 1;
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(u3_smem));

  // one commit group per plane p of z0 .. z1 (z1: only for the last z + 1
  // pair, so no d or b), empty past them
  auto issue = [&](int p, int slot) {
    if (p <= z1 && p < nz) {
      const long long off = (long long)p * plane;
      const unsigned s0 = base + 4u * (unsigned)(slot * kU3Slot);
#pragma unroll
      for (int k = 0; k < kR3Copies; ++k) {
        if (cw[k] >= 0) {
          cp_async4(s0 + 4u * cw[k], uh + off + co[k], cb[k]);
          cp_async4(s0 + 4u * (kR3Plane + cw[k]), ul + off + co[k], cb[k]);
          cp_async4(s0 + 4u * (2 * kR3Plane + cw[k]), e + off + co[k],
                    cb[k]);
        }
      }
      if (p < z1) {
        const unsigned nb = own ? 4u : 0u;
        const unsigned sd = s0 + 4u * (3 * kR3Plane + tid);
        cp_async4(sd, dh + off + go, nb);
        cp_async4(sd + 4u * kR3Threads, dl + off + go, nb);
        cp_async4(sd + 8u * kR3Threads, b + off + go, nb);
      }
    }
    cp_async_commit();
  };
  // the pair of a slot's cells this thread copied, updated in place
  auto update = [&](int slot) {
    float* w = u3_smem + slot * kU3Slot;
#pragma unroll
    for (int k = 0; k < kR3Copies; ++k) {
      if (cw[k] >= 0) {
        ff_add_f3(w[cw[k]], w[kR3Plane + cw[k]], w[2 * kR3Plane + cw[k]],
                  &w[cw[k]], &w[kR3Plane + cw[k]]);
      }
    }
  };
#pragma unroll
  for (int p = 0; p <= kF3Ahead; ++p) issue(z0 + p, p);
  // the updated pair at z - 1 and z of the thread's column
  const long long zo = (long long)(z0 - 1) * plane + go;
  float znh = 0.0f, znl = 0.0f;
  if (z0 > 0 && own) ff_add_f3(uh[zo], ul[zo], e[zo], &znh, &znl);
  float uch = 0.0f, ucl = 0.0f;
  int s = 0;  // the slot of plane z
  for (int z = z0; z < z1; ++z) {
    cp_async_wait<kF3Ahead - 1>();  // planes z and z + 1 have landed
    const int s1 = s + 1 == kF3Slots ? 0 : s + 1;
    if (z == z0) update(s);
    if (z + 1 < nz) update(s1);
    __syncthreads();  // visible to all; step z - 1 is done with its slot
    const int sl = s == 0 ? kF3Slots - 1 : s - 1;  // plane z - 1's slot
    issue(z + kF3Ahead + 1, sl);
    const float* ph = u3_smem + s * kU3Slot;  // plane z: uh, ul, e, d, b
    const float* pl = ph + kR3Plane;
    const float* pd = ph + 3 * kR3Plane + tid;
    if (z == z0) {
      uch = ph[cq];
      ucl = pl[cq];
    }
    const float* nh = u3_smem + s1 * kU3Slot;  // plane z + 1
    const float zsh = z + 1 < nz ? nh[cq] : 0.0f;
    const float zsl = z + 1 < nz ? nh[kR3Plane + cq] : 0.0f;
    float out;
    if (yx_in && z > 0 && z < nzl - 1) {
      float ah, al;
      ff_add3(__fmul_rn(4.0f, uch), __fmul_rn(4.0f, ucl),
              __fmul_rn(2.0f, uch), __fmul_rn(2.0f, ucl), &ah, &al);
      ff_add3(ah, al, -zsh, -zsl, &ah, &al);                      // z + 1
      ff_add3(ah, al, -znh, -znl, &ah, &al);                      // z - 1
      ff_add3(ah, al, -ph[cq + kR3PX], -pl[cq + kR3PX], &ah, &al);  // y + 1
      ff_add3(ah, al, -ph[cq - kR3PX], -pl[cq - kR3PX], &ah, &al);  // y - 1
      ff_add3(ah, al, -ph[cq + 1], -pl[cq + 1], &ah, &al);          // x + 1
      ff_add3(ah, al, -ph[cq - 1], -pl[cq - 1], &ah, &al);          // x - 1
      float th, tl;
      ff_add3(pd[0], pd[kR3Threads], -ah, -al, &th, &tl);
      out = __fadd_rn(__fmul_rn(c, th), __fmul_rn(c, tl));
    } else {
      out = __fsub_rn(__fsub_rn(pd[2 * kR3Threads], uch), ucl);
    }
    if (own) {
      const long long o = (long long)z * plane + go;
      uh2[o] = uch;
      ul2[o] = ucl;
      r[o] = out;
    }
    znh = uch;
    znl = ucl;
    uch = zsh;
    ucl = zsl;
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

// ---------------------------------------------------------------------------
// The Jacobi smoother, jacobi3d: `sweeps` damped-Jacobi sweeps u -> out, out
// of place (u is only read, never cloned).  Every op is jacobi3d_kernel's in
// the same order (boundary and dead-zone points pinned to b, interior jac =
// (b / c + ((((N + S) + E) + W) + Zn) + Zs) * inv6, then, if damped, (1 -
// omega) * x + omega * jac), so the result is bit-equal to `sweeps`
// per-sweep launches and to the twin.  Two launch shapes, chosen by the
// wrapper from the array's size (ops/cuda_stencil_3d.jacobi3d_route):
//
// The z-chunked multi-sweep march, jacobi3d_march_kernel<S>, S = 1 .. 4
// sweeps per launch (longer runs in groups that ping-pong two scratch
// arrays).  Bound: memory.  A 2-sweep call must move 12 B per point (read u
// and b, write the result); the per-sweep launches it replaces moved 24 B,
// fetched each plane about three times through L1/L2, and divided b / c at
// every point in every sweep.
// * One block per kJ3W x kJ3H x-y tile (a halo of S cells on each side: one
//   ring per sweep, core (kJ3W - 2S) x (kJ3H - 2S)) and chunk of zc output
//   planes, which reads S planes beyond each end of the chunk (recomputed by
//   both neighbouring chunks).  zc follows the residual's rule, clamped to
//   kJ3MinChunk .. kJ3MaxChunk, so that 257^3 launches about 4 blocks per SM.
// * Stage 0 is u; stage k (sweep k) runs one plane behind stage k - 1 in the
//   same step: at step t it computes plane t - k on the cells at least k
//   from the tile's edge, from stage k - 1's planes t - k - 1 .. t - k + 1.
// * A thread owns the same kJ3Cells cells (y, x) of every plane and stage
//   (a lane per column, rows ty + kJ3R j), so a cell's Zn, centre and Zs
//   of stage k - 1 are the thread's own values: three registers per stage,
//   shifted a plane per step.  N, S, E and W come from shared memory: the
//   u plane from the ring of copies, an intermediate stage's plane from its
//   two-plane ring (plane parity), which stage k + 1 reads a step after
//   stage k wrote it: one barrier per step.  The last stage writes the core
//   straight to `out`.
// * b / c is divided once per cell when its plane lands (b kept at boundary
//   cells) and carried in registers through the S stages.
// * Loads: 4-byte cp.async with zero fill (the exact-layout levels' rows,
//   nx = 257, 129, ..., are not 16-byte aligned), kJ3Ahead planes ahead, the
//   copy of cell (y, x) by its owner.  Cells outside the array arrive as 0
//   and count as boundary cells (they fail the same tests as the edge), so
//   they are pinned to their zero b.
// * Tiles of 64 x 24, 3 planes in flight, registers capped for 2 blocks per
//   SM: on the H100, at 2 sweeps 64 x 24 beat 64 x 16, 32 x 32 and 128 x 16
//   at 257^3 and 513^3 and 64 x 32 at 257^3 (64 x 32 was ~3 % faster at
//   513^3, but spills at 4 sweeps); 2 and 4 planes in flight differ by ~1 %;
//   the cap took 4 sweeps from 380 to 318 us at 257^3 (89 -> 64 registers)
//   and left 1 and 2 sweeps within 2 % (benchmarks/jacobi3d_tile_probe.py).
//
// The grid-resident kernel, jacobi3d_resident_kernel: an array of at most
// kResidentMaxPoints points (the 17^3 bottom of a 3D V-cycle has 4913)
// lives in one block's shared memory, two ping-pong copies of u and b / c,
// for all sweeps, with a barrier between sweeps: coarse_sweeps = 100 is one
// launch instead of 100.  Bound there: the sweeps' latency, not bytes.
//
// The geometry is mirrored by ops/cuda_stencil_3d.jacobi3d_tile and the cap
// by RESIDENT_MAX_POINTS; the C entry points refuse anything else.
constexpr int kJ3W = 64;                  // tile columns: a lane per column
constexpr int kJ3H = 24;                  // tile rows
constexpr int kJ3Threads = 512;
constexpr int kJ3R = kJ3Threads / kJ3W;   // thread rows
constexpr int kJ3Cells = kJ3H / kJ3R;     // cells per thread
constexpr int kJ3Plane = kJ3W * kJ3H;     // words per plane
constexpr int kJ3Ahead = 3;               // planes in flight
constexpr int kJ3RingU = kJ3Ahead + 2;    // u: planes t - 1, t, in flight
constexpr int kJ3RingB = kJ3Ahead + 1;    // b: plane t, in flight
constexpr int kJ3MinChunk = 4;            // planes per chunk at least
constexpr int kJ3MaxChunk = 32;           // and at most
constexpr int kJ3TargetBlocks = 528;      // 4 per SM of an H100's 132
constexpr int kJ3MaxSweeps = 4;           // sweeps per launch
constexpr int kJ3MinBlocks = 2;           // blocks per SM the registers allow
static_assert(kJ3H % kJ3R == 0 && kJ3W % 32 == 0, "tile");

template <int S>
struct J3 {
  static constexpr int CW = kJ3W - 2 * S;  // core columns
  static constexpr int CH = kJ3H - 2 * S;  // core rows
  // the u and b rings, two planes for each intermediate stage
  static constexpr int SMEM =
      (kJ3RingU + kJ3RingB + 2 * (S - 1)) * kJ3Plane * (int)sizeof(float);
  static_assert(CW > 0 && CH > 0 && SMEM <= 227 * 1024, "tile");
};

// The chunk length for S sweeps on an (nz, ny, nx) array (the rule above).
int jacobi3d_chunk(int nz, int ny, int nx, int s) {
  const int cw = kJ3W - 2 * s, ch = kJ3H - 2 * s;
  const long long tiles =
      (long long)((nx + cw - 1) / cw) * ((ny + ch - 1) / ch);
  const long long zc = (nz * tiles + kJ3TargetBlocks - 1) / kJ3TargetBlocks;
  return (int)(zc < kJ3MinChunk ? kJ3MinChunk
               : zc > kJ3MaxChunk ? kJ3MaxChunk : zc);
}

// S damped-Jacobi sweeps u -> out on the z-chunked march (see above).
template <int S>
__global__ void __launch_bounds__(kJ3Threads, kJ3MinBlocks)
    jacobi3d_march_kernel(const float* __restrict__ u,
                          const float* __restrict__ b,
                          float* __restrict__ out, int nz, int ny, int nx,
                          int nzl, int nyl, int nxl, float c, float inv6,
                          int damped, float w1, float w, int zc) {
  using T = J3<S>;
  extern __shared__ __align__(16) float j3_smem[];  // u ring, b ring, stages
  float* const sbc = j3_smem + kJ3RingU * kJ3Plane;
  float* const sst = sbc + kJ3RingB * kJ3Plane;
  const unsigned ubase =
      static_cast<unsigned>(__cvta_generic_to_shared(j3_smem));
  const unsigned bbase = static_cast<unsigned>(__cvta_generic_to_shared(sbc));
  const int tid = threadIdx.x, tx = tid % kJ3W, ty = tid / kJ3W;
  // tile cell (0, 0) is (y0, x0); the chunk's output planes z0 .. z1 - 1,
  // its input planes p0 .. pe
  const int x0 = blockIdx.x * T::CW - S, y0 = blockIdx.y * T::CH - S;
  const int z0 = blockIdx.z * zc, z1 = min(z0 + zc, nz);
  const int p0 = max(z0 - S, 0), pe = min(z1 - 1 + S, nz - 1);
  const long long plane = (long long)ny * nx;
  const int x = x0 + tx;
  // the thread's cells: word in a plane, offset in plane 0 of the array
  // (0 outside it), bytes to copy, distance from the tile's edge, and
  // whether (y, x) is an interior column
  int lw[kJ3Cells], go[kJ3Cells], dist[kJ3Cells];
  unsigned cb[kJ3Cells];
  unsigned yxin = 0;  // bit j: cell j's (y, x) is interior
#pragma unroll
  for (int j = 0; j < kJ3Cells; ++j) {
    const int rr = ty + kJ3R * j, y = y0 + rr;
    const bool in = x >= 0 && x < nx && y >= 0 && y < ny;
    lw[j] = rr * kJ3W + tx;
    go[j] = in ? y * nx + x : 0;
    cb[j] = in ? 4u : 0u;
    dist[j] = min(min(tx, kJ3W - 1 - tx), min(rr, kJ3H - 1 - rr));
    yxin |= static_cast<unsigned>(y > 0 && y < nyl - 1 && x > 0 &&
                                  x < nxl - 1) << j;
  }
  // one commit group per input plane, empty past pe: the group of plane p
  // is committed kJ3Ahead steps before step p
  auto issue = [&](int p, int slot_u, int slot_b) {
    if (p <= pe) {
      const long long off = (long long)p * plane;
#pragma unroll
      for (int j = 0; j < kJ3Cells; ++j) {
        cp_async4(ubase + 4u * (slot_u * kJ3Plane + lw[j]), u + off + go[j],
                  cb[j]);
        cp_async4(bbase + 4u * (slot_b * kJ3Plane + lw[j]), b + off + go[j],
                  cb[j]);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kJ3Ahead; ++i) issue(p0 + i, i, i);
  // win[k][j]: stage k's values at cell j on its planes (latest - 2,
  // latest - 1, latest); bq[k][j]: b / c (b at boundary cells) of plane
  // t - k, read by stage k in step t
  float win[S][kJ3Cells][3];
  float bq[S + 1][kJ3Cells];
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int j = 0; j < kJ3Cells; ++j) {
      win[k][j][0] = win[k][j][1] = win[k][j][2] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k <= S; ++k) {
#pragma unroll
    for (int j = 0; j < kJ3Cells; ++j) bq[k][j] = 0.0f;
  }
  int su = 0, sb = 0;  // ring slots of plane t
  for (int t = p0; t <= z1 - 1 + S; ++t) {
    cp_async_wait<kJ3Ahead - 1>();  // plane t has landed
    __syncthreads();  // visible; step t - 1 is done with what it read
    // plane t + kJ3Ahead into the slots of planes t - 2 (u) and t - 1 (b)
    issue(t + kJ3Ahead, zm_slot<kJ3RingU>(su, kJ3Ahead),
          zm_slot<kJ3RingB>(sb, kJ3Ahead));
    // stage 0: the thread's cells of plane t, and their b / c
    const bool tin = t <= pe, tz = t > 0 && t < nzl - 1;
#pragma unroll
    for (int j = 0; j < kJ3Cells; ++j) {
      float uv = 0.0f, bv = 0.0f;
      if (tin) {
        uv = j3_smem[su * kJ3Plane + lw[j]];
        bv = sbc[sb * kJ3Plane + lw[j]];
        if (tz && ((yxin >> j) & 1u)) bv = __fdiv_rn(bv, c);
      }
      win[0][j][0] = win[0][j][1];
      win[0][j][1] = win[0][j][2];
      win[0][j][2] = uv;
      bq[0][j] = bv;
    }
    // stages 1 .. S on planes t - 1 .. t - S
#pragma unroll
    for (int k = 1; k <= S; ++k) {
      const int z = t - k;
      const bool run = z >= max(z0 - S + k, 0) &&
                       z <= min(z1 - 1 + S - k, nz - 1);
      const bool zin = z > 0 && z < nzl - 1;
      // stage k - 1's plane z: N, S, E and W
      const float* src =
          k == 1 ? j3_smem + zm_slot<kJ3RingU>(su, -1) * kJ3Plane
                 : sst + (2 * (k - 2) + (z & 1)) * kJ3Plane;
#pragma unroll
      for (int j = 0; j < kJ3Cells; ++j) {
        const bool act = run && dist[j] >= k;
        float v = 0.0f;
        if (act) {
          v = bq[k][j];  // b / c inside, b on the boundary
          if (zin && ((yxin >> j) & 1u)) {
            const int q = lw[j];
            float nb = __fadd_rn(src[q - kJ3W], src[q + kJ3W]);  // N + S
            nb = __fadd_rn(nb, src[q + 1]);                      // east
            nb = __fadd_rn(nb, src[q - 1]);                      // west
            nb = __fadd_rn(nb, win[k - 1][j][0]);                // z - 1
            nb = __fadd_rn(nb, win[k - 1][j][2]);                // z + 1
            v = __fmul_rn(__fadd_rn(v, nb), inv6);
            if (damped) {
              v = __fadd_rn(__fmul_rn(w1, win[k - 1][j][1]),
                            __fmul_rn(w, v));
            }
          }
        }
        if (k < S) {
          win[k][j][0] = win[k][j][1];
          win[k][j][1] = win[k][j][2];
          win[k][j][2] = v;
          if (act) sst[(2 * (k - 1) + (z & 1)) * kJ3Plane + lw[j]] = v;
        } else if (act && cb[j]) {
          out[(long long)z * plane + go[j]] = v;
        }
      }
    }
    // b / c of plane t - k + 1 is read by stage k in the next step
#pragma unroll
    for (int k = S; k >= 1; --k) {
#pragma unroll
      for (int j = 0; j < kJ3Cells; ++j) bq[k][j] = bq[k - 1][j];
    }
    su = zm_slot<kJ3RingU>(su, 1);
    sb = zm_slot<kJ3RingB>(sb, 1);
  }
}

// `sweeps` damped-Jacobi sweeps u -> out with the whole array in shared
// memory (see above): two copies of u ping-ponged and b / c (b at the
// boundary), 3 x 64 KB at the cap.  Thread tid keeps the points tid + k *
// kResThreads; bit k of `inner` says whether point k is interior.
constexpr int kJ3ResSites =
    (kResidentMaxPoints + kResThreads - 1) / kResThreads;

__global__ void __launch_bounds__(kResThreads)
    jacobi3d_resident_kernel(const float* __restrict__ u,
                             const float* __restrict__ b,
                             float* __restrict__ out, int nz, int ny, int nx,
                             int nzl, int nyl, int nxl, float c, float inv6,
                             int damped, float w1, float w, int sweeps) {
  extern __shared__ __align__(16) float jr_smem[];
  const int n = nz * ny * nx, plane = ny * nx;
  float* const s0 = jr_smem;
  float* const s1 = jr_smem + n;
  float* const sbc = jr_smem + 2 * n;
  unsigned inner = 0;
#pragma unroll
  for (int k = 0; k < kJ3ResSites; ++k) {
    const int i = threadIdx.x + k * kResThreads;
    if (i >= n) continue;
    const int x = i % nx, y = (i / nx) % ny, z = i / plane;
    const bool in = z > 0 && y > 0 && x > 0 && z < nzl - 1 && y < nyl - 1 &&
                    x < nxl - 1;
    s0[i] = u[i];
    sbc[i] = in ? __fdiv_rn(b[i], c) : b[i];
    inner |= static_cast<unsigned>(in) << k;
  }
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) {
    const float* src = (s & 1) ? s1 : s0;
    float* dst = (s & 1) ? s0 : s1;
#pragma unroll
    for (int k = 0; k < kJ3ResSites; ++k) {
      const int i = threadIdx.x + k * kResThreads;
      if (i >= n) continue;
      float v = sbc[i];  // b / c inside, b on the boundary
      if ((inner >> k) & 1u) {
        float nb = __fadd_rn(src[i - nx], src[i + nx]);  // N + S
        nb = __fadd_rn(nb, src[i + 1]);                  // east
        nb = __fadd_rn(nb, src[i - 1]);                  // west
        nb = __fadd_rn(nb, src[i - plane]);              // z - 1
        nb = __fadd_rn(nb, src[i + plane]);              // z + 1
        v = __fmul_rn(__fadd_rn(v, nb), inv6);
        if (damped) v = __fadd_rn(__fmul_rn(w1, src[i]), __fmul_rn(w, v));
      }
      dst[i] = v;
    }
    __syncthreads();
  }
  const float* res = (sweeps & 1) ? s1 : s0;
  for (int i = threadIdx.x; i < n; i += kResThreads) out[i] = res[i];
}

// ---------------------------------------------------------------------------
// The grid transfers of the exact layout: restrict_fw3d_kernel is
// ops/transfer.restrict_full_weighting and prolong_add3d_kernel is
// u + ops/transfer.prolong(e, u.shape), op for op, on a 3-D array.  They
// replace no TPU kernel: the JAX package leaves these transfers to XLA,
// which fuses each into one pass on the TPU; torch on the card runs them as
// ~32 launches of strided slices, products, sums, stacks and concatenations
// per level and V-cycle.
//
// Arithmetic, as the plain functions order it: the restriction filters z,
// then y, then x, each coarse point k of an axis of n fine points
//   k == 0: fine 0 (injected);  k == nc - 1: fine n - 1 (n odd) or 0 (n
//   even: the fake high edge);  otherwise (0.25 f[2k-1] + 0.5 f[2k]) +
//   0.25 f[2k+1];
// the prolongation refines z, then y, then x, fine point j of an axis of
// nc coarse points
//   j = 2i: c[i];  j = 2i + 1: 0.5 (c[i] + c[i + 1]) if i + 1 < nc, else
//   c[nc - 1] (the repeated last node of a 2 nc target);
// then adds u.  Every operation is an explicit __f*_rn, so both are
// bit-equal to the plain functions.
//
// Bound: memory.  The restriction must read the fine grid and write the
// coarse one (4.5 B per fine point), the prolong-add read u and the coarse
// e and write u (8.5 B per fine point); either does ~5 flops a fine point.
//
// restrict_fw3d_kernel marches over coarse planes.  A block owns a tile of
// kT3CY x kT3CX coarse (y, x) points and a chunk of coarse planes; coarse
// plane K needs fine planes 2K - 1, 2K and 2K + 1.
// * Each thread owns up to kT3Cols fine (y, x) columns of the tile's fine
//   window (2 kT3CY + 1 rows by 2 kT3CX + 1 columns, the neighbours of the
//   tile's edge points included; window cells in thread order, so a warp
//   reads runs of a row: coalesced).  It filters z in registers, carrying
//   fine plane 2K + 1 into the next step as 2K' - 1, so every fine plane
//   of the chunk is read once (and the one before it), and loads the next
//   step's two planes before it works on this one.
// * The z-filtered window goes to shared memory (two buffers: one barrier
//   a step); a thread per coarse (y, x) point filters y at the three fine
//   columns it needs, then x, and stores the coarse point: a warp a coarse
//   row, coalesced.
// * Chunks keep the card busy: zc = ceil(ncz * tiles / kX3TargetBlocks),
//   clamped to 1 .. kX3MaxChunk coarse planes (257^3: 8 planes, 1445
//   blocks; 129^3: 4, 459; 65^3: 1, 330; 33^3: 1, 51).  A chunk re-reads
//   one fine plane of 2 zc + 1, the window one fine row and column of
//   2 kT3CY + 1 and 2 kT3CX + 1.  On the H100 at 257^3 (L2 flushed) chunks
//   of 4 to 19 planes all take 35-36 us, 1 plane 46 us, 43 planes 44 us;
//   at 129^3 2 to 4 planes are fastest (PERF.md, rows 23 and 24).
//
// prolong_add3d_kernel is the mirror: a block owns a tile of kP3Y x kP3X
// fine (y, x) columns and a chunk of coarse planes, and emits fine planes
// 2I and 2I + 1 at coarse plane I.
// * The tile's coarse window (kP3Y / 2 + 1 rows by kP3X / 2 + 1 columns)
//   of e planes I and I + 1 sits in a ring of shared-memory slots beside u
//   at fine planes 2I and 2I + 1 (a word per thread, read once), all as
//   4-byte cp.async with zero fill (rows are not 16-byte aligned at odd
//   widths), kP3Ahead coarse planes ahead of the one computed: one barrier
//   per coarse plane.  Each e plane of the chunk is copied once (and the
//   one after it).
// * A thread per fine (y, x) column refines its (up to 4) coarse corners
//   in z, then y, then x from the two e planes, adds u, and stores each
//   fine plane once: two warps a fine row, coalesced.
// * Chunks: the restriction's rule over the prolong-add's tiles (257^3:
//   8 planes, 2805 blocks; 129^3: 7, 510; 65^3: 2, 306; 33^3: 1, 85).  At
//   257^3 chunks of 8 to 16 planes take 65-66 us, 43 planes 72 us.
//
// The geometry is mirrored by ops/cuda_stencil_3d.restrict3d_tile and
// prolong3d_tile; the C entry points refuse another.
constexpr int kT3CX = 32;                  // coarse tile columns: a warp a row
constexpr int kT3CY = 8;                   // coarse tile rows
constexpr int kT3Threads = kT3CX * kT3CY;  // a thread per coarse (y, x)
constexpr int kT3FX = 2 * kT3CX + 1;       // fine window columns
constexpr int kT3FY = 2 * kT3CY + 1;       // fine window rows
constexpr int kT3Cells = kT3FX * kT3FY;
constexpr int kT3Cols = (kT3Cells + kT3Threads - 1) / kT3Threads;

constexpr int kP3X = 64;                   // fine tile columns: two warps a row
constexpr int kP3Y = 8;                    // fine tile rows
constexpr int kP3Threads = kP3X * kP3Y;    // a thread per fine (y, x)
constexpr int kP3EX = kP3X / 2 + 1;        // coarse window columns
constexpr int kP3EY = kP3Y / 2 + 1;        // coarse window rows
constexpr int kP3EPlane = kP3EX * kP3EY;   // words of an e window
constexpr int kP3Ahead = 3;                // coarse planes in flight
constexpr int kP3Slots = kP3Ahead + 2;     // ring slots
constexpr int kP3Slot = kP3EPlane + 2 * kP3Threads;  // e window, u at 2I, 2I+1
static_assert(kP3EPlane <= kP3Threads, "a thread per e window cell");
static_assert(kP3Slots * kP3Slot * 4 <= 48 * 1024, "static shared memory");

constexpr int kX3MaxChunk = 8;          // coarse planes per chunk at most
constexpr int kX3TargetBlocks = 528;    // 4 per SM of an H100's 132

// The chunk rule (above) for ncz coarse planes over `tiles` x-y tiles.
int transfer3d_chunk(int ncz, long long tiles) {
  const long long zc = (ncz * tiles + kX3TargetBlocks - 1) / kX3TargetBlocks;
  return (int)(zc < 1 ? 1 : zc > kX3MaxChunk ? kX3MaxChunk : zc);
}

int restrict3d_chunk(int nz, int ny, int nx) {
  const int ncz = (nz + 1) / 2, ncy = (ny + 1) / 2, ncx = (nx + 1) / 2;
  const long long tiles =
      (long long)((ncx + kT3CX - 1) / kT3CX) * ((ncy + kT3CY - 1) / kT3CY);
  return transfer3d_chunk(ncz, tiles);
}

int prolong3d_chunk(int ncz, int ny, int nx) {
  const long long tiles =
      (long long)((nx + kP3X - 1) / kP3X) * ((ny + kP3Y - 1) / kP3Y);
  return transfer3d_chunk(ncz, tiles);
}

// (0.25 lo + 0.5 mid) + 0.25 hi: one full-weighting filter
__device__ __forceinline__ float fw3(float lo, float mid, float hi) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, lo), __fmul_rn(0.5f, mid)),
                   __fmul_rn(0.25f, hi));
}

// 0.5 (a + b): one refinement midpoint
__device__ __forceinline__ float mid3(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

__global__ void __launch_bounds__(kT3Threads)
    restrict_fw3d_kernel(const float* __restrict__ r, float* __restrict__ rc,
                         int nz, int ny, int nx, int zc) {
  __shared__ float zf[2][kT3Cells];
  const int ncz = (nz + 1) / 2, ncy = (ny + 1) / 2, ncx = (nx + 1) / 2;
  const int tid = threadIdx.x;
  const int cx0 = blockIdx.x * kT3CX, cy0 = blockIdx.y * kT3CY;
  const int k0 = blockIdx.z * zc, k1 = min(k0 + zc, ncz);
  const long long plane = (long long)ny * nx;
  // window cell q = tid + k kT3Threads is the window's (q / kT3FX,
  // q % kT3FX), the array's (2 cy0 - 1 + row, 2 cx0 - 1 + col); its offset
  // in a plane, -1 outside the array (read as 0, never used)
  int off[kT3Cols];
#pragma unroll
  for (int k = 0; k < kT3Cols; ++k) {
    const int q = tid + k * kT3Threads;
    const int y = 2 * cy0 - 1 + q / kT3FX, x = 2 * cx0 - 1 + q % kT3FX;
    off[k] = (q < kT3Cells && y >= 0 && y < ny && x >= 0 && x < nx)
                 ? y * nx + x
                 : -1;
  }
  auto load = [&](int p, int k) -> float {
    return (off[k] >= 0 && p < nz) ? r[(long long)p * plane + off[k]] : 0.0f;
  };
  // fine planes 2K - 1 (carried), 2K and 2K + 1 at each cell
  float lo[kT3Cols], a[kT3Cols], c[kT3Cols];
#pragma unroll
  for (int k = 0; k < kT3Cols; ++k) {
    lo[k] = k0 > 0 ? load(2 * k0 - 1, k) : 0.0f;
    a[k] = load(2 * k0, k);
    c[k] = load(2 * k0 + 1, k);
  }
  // the thread's coarse point; w: its fine (2 cy, 2 cx) in the window
  const int ty = tid / kT3CX, tx = tid % kT3CX;
  const int cy = cy0 + ty, cx = cx0 + tx;
  const bool own = cy < ncy && cx < ncx;
  const int w = (2 * ty + 1) * kT3FX + 2 * tx + 1;
  for (int K = k0; K < k1; ++K) {
    float na[kT3Cols], nc[kT3Cols];  // the next step's planes, in flight
#pragma unroll
    for (int k = 0; k < kT3Cols; ++k) {
      const bool next = K + 1 < k1;
      na[k] = next ? load(2 * K + 2, k) : 0.0f;
      nc[k] = next ? load(2 * K + 3, k) : 0.0f;
    }
    float* buf = zf[K & 1];
#pragma unroll
    for (int k = 0; k < kT3Cols; ++k) {
      const int q = tid + k * kT3Threads;
      if (q < kT3Cells) {
        buf[q] = K == 0         ? a[k]
                 : K == ncz - 1 ? ((nz & 1) ? a[k] : 0.0f)
                                : fw3(lo[k], a[k], c[k]);
      }
      lo[k] = c[k];
      a[k] = na[k];
      c[k] = nc[k];
    }
    __syncthreads();  // the window is written; the other buffer is free
    if (own) {
      // y filtered at fine column 2 cx + d, then x
      auto yf = [&](int d) -> float {
        const float* p = buf + w + d;
        return cy == 0           ? p[0]
               : cy == ncy - 1   ? ((ny & 1) ? p[0] : 0.0f)
                                 : fw3(p[-kT3FX], p[0], p[kT3FX]);
      };
      const float v = cx == 0         ? yf(0)
                      : cx == ncx - 1 ? ((nx & 1) ? yf(0) : 0.0f)
                                      : fw3(yf(-1), yf(0), yf(1));
      rc[((long long)K * ncy + cy) * ncx + cx] = v;
    }
  }
}

__global__ void __launch_bounds__(kP3Threads)
    prolong_add3d_kernel(const float* __restrict__ e,
                         const float* __restrict__ u, float* __restrict__ out,
                         int ncz, int ncy, int ncx, int nz, int ny, int nx,
                         int zc) {
  __shared__ __align__(16) float sm[kP3Slots][kP3Slot];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kP3X, y0 = blockIdx.y * kP3Y;
  const int cx0 = x0 / 2, cy0 = y0 / 2;
  const int i0 = blockIdx.z * zc, i1 = min(i0 + zc, ncz);
  const long long cplane = (long long)ncy * ncx, fplane = (long long)ny * nx;
  // the e window cell this thread copies (threads < kP3EPlane), 0 bytes
  // from a clamped address outside the array
  const bool ecopy = tid < kP3EPlane;
  const int ey = cy0 + tid / kP3EX, ex = cx0 + tid % kP3EX;
  const bool ein = ecopy && ey < ncy && ex < ncx;
  const long long eo = ein ? (long long)ey * ncx + ex : 0;
  // the thread's fine column
  const int ty = tid / kP3X, tx = tid % kP3X;
  const int y = y0 + ty, x = x0 + tx;
  const bool own = y < ny && x < nx;
  const long long uo = own ? (long long)y * nx + x : 0;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  // one commit group per coarse plane p of i0 .. i1 (the e window; u at
  // fine 2p and 2p + 1 for p < i1), empty past them
  auto issue = [&](int p, int slot) {
    if (p <= i1 && p < ncz) {
      const unsigned s = base + 4u * (unsigned)(slot * kP3Slot);
      if (ecopy) {
        cp_async4(s + 4u * tid, e + p * cplane + eo, ein ? 4u : 0u);
      }
      if (p < i1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int fz = 2 * p + h;
          const bool in = own && fz < nz;
          cp_async4(s + 4u * (kP3EPlane + h * kP3Threads + tid),
                    u + (in ? fz * fplane + uo : 0), in ? 4u : 0u);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p <= kP3Ahead; ++p) issue(i0 + p, p);
  // the thread's coarse corner in the window, and whether its odd fine y
  // and x average two coarse nodes (the last node of a 2 nc target repeats)
  const int w = (ty >> 1) * kP3EX + (tx >> 1);
  const bool ypair = (ty & 1) && cy0 + (ty >> 1) + 1 < ncy;
  const bool xpair = (tx & 1) && cx0 + (tx >> 1) + 1 < ncx;
  int s = 0;  // the slot of coarse plane i
  for (int i = i0; i < i1; ++i) {
    cp_async_wait<kP3Ahead - 1>();  // planes i and i + 1 have landed
    __syncthreads();  // visible to all; step i - 1 is done with its slot
    const int s1 = s + 1 == kP3Slots ? 0 : s + 1;
    const int sl = s == 0 ? kP3Slots - 1 : s - 1;  // plane i - 1's slot
    issue(i + kP3Ahead + 1, sl);
    if (own) {
      const float* e0 = sm[s];
      const float* e1 = sm[s1];
      const bool zpair = i + 1 < ncz;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fz = 2 * i + h;
        if (fz < nz) {
          // z, at the corners (dy, dx) the thread needs
          auto zr = [&](int d) -> float {
            return (h && zpair) ? mid3(e0[w + d], e1[w + d]) : e0[w + d];
          };
          const float z00 = zr(0);
          const float y0v = ypair ? mid3(z00, zr(kP3EX)) : z00;
          float v = y0v;
          if (xpair) {
            const float z01 = zr(1);
            const float y1v = ypair ? mid3(z01, zr(kP3EX + 1)) : z01;
            v = mid3(y0v, y1v);
          }
          out[fz * fplane + uo] =
              __fadd_rn(sm[s][kP3EPlane + h * kP3Threads + tid], v);
        }
      }
    }
    s = s1;
  }
}

template <int S>
int jacobi3d_march_launch(const float* u, const float* b, float* out, int nz,
                          int ny, int nx, int nzl, int nyl, int nxl, float c,
                          float inv6, int damped, float w1, float w,
                          const int* geom, cudaStream_t stream) {
  using T = J3<S>;
  static bool smem_set = false;
  const int zc = jacobi3d_chunk(nz, ny, nx, S);
  if (geom[0] != kJ3W || geom[1] != kJ3H || geom[2] != S || geom[3] != zc ||
      geom[4] != kJ3Ahead) {
    return (int)cudaErrorInvalidValue;
  }
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi3d_march_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((nx + T::CW - 1) / T::CW, (ny + T::CH - 1) / T::CH,
                  (nz + zc - 1) / zc);
  jacobi3d_march_kernel<S><<<grid, kJ3Threads, T::SMEM, stream>>>(
      u, b, out, nz, ny, nx, nzl, nyl, nxl, c, inv6, damped, w1, w, zc);
  return (int)cudaGetLastError();
}

template <int S>
int rbgs3d_zmarch_launch(const float* u, const float* b, float* out, int nz,
                         int ny, int nx, int nzl, int nyl, int nxl, float c,
                         float inv6, const int* geom, cudaStream_t stream) {
  using T = Zm<2 * S>;
  static bool smem_set = false;
  const int zc = rbgs3d_chunk<2 * S>(nz, ny, nx);
  if (geom[0] != T::H || geom[1] != T::HC || geom[2] != T::TY ||
      geom[3] != kZmCols || geom[4] != T::RU || geom[5] != T::RB ||
      geom[6] != zc) {
    return (int)cudaErrorInvalidValue;
  }
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rbgs3d_zmarch_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((nx + T::CW - 1) / T::CW, (ny + T::CH - 1) / T::CH,
                  (nz + zc - 1) / zc);
  rbgs3d_zmarch_kernel<S><<<grid, T::THREADS, T::SMEM, stream>>>(
      u, b, out, nz, ny, nx, nzl, nyl, nxl, c, inv6, zc);
  return (int)cudaGetLastError();
}

template <bool kResidual>
int march3d_launch(const float* u, const float* b, float* r, int nz, int ny,
                   int nx, int nzl, int nyl, int nxl, float c,
                   const int* geom, cudaStream_t stream) {
  const int zc = residual3d_chunk(nz, ny, nx);
  if (geom[0] != kR3X || geom[1] != kR3Y || geom[2] != zc ||
      geom[3] != kR3Ahead) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nx + kR3X - 1) / kR3X, (ny + kR3Y - 1) / kR3Y,
                  (nz + zc - 1) / zc);
  stencil3d_march_kernel<kResidual><<<grid, kR3Threads, 0, stream>>>(
      u, b, r, nz, ny, nx, nzl, nyl, nxl, c, zc);
  return (int)cudaGetLastError();
}

int ff_residual3d_launch(const float* uh, const float* ul, const float* dh,
                         const float* dl, const float* b, float* r, int nz,
                         int ny, int nx, int nzl, int nyl, int nxl, float c,
                         const int* geom, cudaStream_t stream) {
  static bool smem_set = false;
  const int zc = residual3d_chunk(nz, ny, nx);
  if (geom[0] != kR3X || geom[1] != kR3Y || geom[2] != zc ||
      geom[3] != kF3Ahead) {
    return (int)cudaErrorInvalidValue;
  }
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ff_residual3d_march_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kF3Smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((nx + kR3X - 1) / kR3X, (ny + kR3Y - 1) / kR3Y,
                  (nz + zc - 1) / zc);
  ff_residual3d_march_kernel<<<grid, kR3Threads, kF3Smem, stream>>>(
      uh, ul, dh, dl, b, r, nz, ny, nx, nzl, nyl, nxl, c, zc);
  return (int)cudaGetLastError();
}

int ff_update_residual3d_launch(const float* uh, const float* ul,
                                const float* e, const float* dh,
                                const float* dl, const float* b, float* uh2,
                                float* ul2, float* r, int nz, int ny, int nx,
                                int nzl, int nyl, int nxl, float c,
                                const int* geom, cudaStream_t stream) {
  static bool smem_set = false;
  const int zc = residual3d_chunk(nz, ny, nx);
  if (geom[0] != kR3X || geom[1] != kR3Y || geom[2] != zc ||
      geom[3] != kF3Ahead) {
    return (int)cudaErrorInvalidValue;
  }
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ff_update_residual3d_march_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kU3Smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((nx + kR3X - 1) / kR3X, (ny + kR3Y - 1) / kR3Y,
                  (nz + zc - 1) / zc);
  ff_update_residual3d_march_kernel<<<grid, kR3Threads, kU3Smem, stream>>>(
      uh, ul, e, dh, dl, b, uh2, ul2, r, nz, ny, nx, nzl, nyl, nxl, c, zc);
  return (int)cudaGetLastError();
}

int restrict_fw3d_launch(const float* r, float* rc, int nz, int ny, int nx,
                         const int* geom, cudaStream_t stream) {
  if (nz < 3 || ny < 3 || nx < 3) return (int)cudaErrorInvalidValue;
  const int zc = restrict3d_chunk(nz, ny, nx);
  if (geom[0] != kT3CX || geom[1] != kT3CY || geom[2] != zc) {
    return (int)cudaErrorInvalidValue;
  }
  const int ncz = (nz + 1) / 2, ncy = (ny + 1) / 2, ncx = (nx + 1) / 2;
  const dim3 grid((ncx + kT3CX - 1) / kT3CX, (ncy + kT3CY - 1) / kT3CY,
                  (ncz + zc - 1) / zc);
  restrict_fw3d_kernel<<<grid, kT3Threads, 0, stream>>>(r, rc, nz, ny, nx,
                                                         zc);
  return (int)cudaGetLastError();
}

// An axis of nc coarse points refines to 2 nc - 1 or 2 nc fine ones.
bool refines(int nc, int n) {
  return nc >= 2 && (n == 2 * nc - 1 || n == 2 * nc);
}

int prolong_add3d_launch(const float* e, const float* u, float* out, int ncz,
                         int ncy, int ncx, int nz, int ny, int nx,
                         const int* geom, cudaStream_t stream) {
  if (!refines(ncz, nz) || !refines(ncy, ny) || !refines(ncx, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  const int zc = prolong3d_chunk(ncz, ny, nx);
  if (geom[0] != kP3X || geom[1] != kP3Y || geom[2] != zc ||
      geom[3] != kP3Ahead) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nx + kP3X - 1) / kP3X, (ny + kP3Y - 1) / kP3Y,
                  (ncz + zc - 1) / zc);
  prolong_add3d_kernel<<<grid, kP3Threads, 0, stream>>>(
      e, u, out, ncz, ncy, ncx, nz, ny, nx, zc);
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

// The apply on the residual's z-chunked march; geom as mg_residual3d's,
// refused unless it is the compiled tile and the chunk rule's.
int mg_apply3d(const float* u, float* y, int nz, int ny, int nx, int nzl,
               int nyl, int nxl, float c, const int* geom, void* stream) {
  return march3d_launch<false>(u, nullptr, y, nz, ny, nx, nzl, nyl, nxl, c,
                               geom, (cudaStream_t)stream);
}

// The one-thread-per-point apply (the march's oracle only).
int mg_apply3d_point(const float* u, float* y, int nz, int ny, int nx,
                     int nzl, int nyl, int nxl, float c, void* stream) {
  apply3d_point_kernel<<<grid3d_for(nz, ny, nx), dim3(kBlockX, kBlockY), 0,
                         (cudaStream_t)stream>>>(u, y, nz, ny, nx, nzl, nyl,
                                                 nxl, c);
  return (int)cudaGetLastError();
}

// The residual on the z-chunked march; geom = (tile columns, tile rows,
// planes per chunk, planes in flight) as the caller computed them, refused
// unless they are the compiled ones and the chunk rule's for this shape.
int mg_residual3d(const float* u, const float* b, float* r, int nz, int ny,
                  int nx, int nzl, int nyl, int nxl, float c, const int* geom,
                  void* stream) {
  return march3d_launch<true>(u, b, r, nz, ny, nx, nzl, nyl, nxl, c, geom,
                              (cudaStream_t)stream);
}

// The float-float residual on its z-chunked march; geom = (tile columns,
// tile rows, planes per chunk, planes in flight) as the caller computed
// them, refused unless they are the compiled ones and the chunk rule's.
int mg_ff_residual3d(const float* uh, const float* ul, const float* dh,
                     const float* dl, const float* b, float* r, int nz, int ny,
                     int nx, int nzl, int nyl, int nxl, float c,
                     const int* geom, void* stream) {
  return ff_residual3d_launch(uh, ul, dh, dl, b, r, nz, ny, nx, nzl, nyl, nxl,
                              c, geom, (cudaStream_t)stream);
}

// The pair update fused into the float-float residual, on the same march;
// geom as mg_ff_residual3d's.  uh2 and ul2 must not alias uh, ul or e.
int mg_ff_update_residual3d(const float* uh, const float* ul, const float* e,
                            const float* dh, const float* dl, const float* b,
                            float* uh2, float* ul2, float* r, int nz, int ny,
                            int nx, int nzl, int nyl, int nxl, float c,
                            const int* geom, void* stream) {
  return ff_update_residual3d_launch(uh, ul, e, dh, dl, b, uh2, ul2, r, nz,
                                     ny, nx, nzl, nyl, nxl, c, geom,
                                     (cudaStream_t)stream);
}

// Full-weighting restriction of the exact layout, fine (nz, ny, nx) ->
// coarse ((nz + 1) / 2, (ny + 1) / 2, (nx + 1) / 2), every axis >= 3; geom
// = (coarse tile columns, coarse tile rows, coarse planes per chunk) as the
// caller computed them, refused unless they are the compiled ones and the
// chunk rule's.
int mg_restrict_fw3d(const float* r, float* rc, int nz, int ny, int nx,
                     const int* geom, void* stream) {
  return restrict_fw3d_launch(r, rc, nz, ny, nx, geom, (cudaStream_t)stream);
}

// out = u + prolong(e) of the exact layout: e (ncz, ncy, ncx), u and out
// (nz, ny, nx) with each fine extent 2 nc - 1 or 2 nc; geom = (fine tile
// columns, fine tile rows, coarse planes per chunk, coarse planes in
// flight), refused unless they are the compiled ones and the chunk rule's.
// out must not alias u or e.
int mg_prolong_add3d(const float* e, const float* u, float* out, int ncz,
                     int ncy, int ncx, int nz, int ny, int nx,
                     const int* geom, void* stream) {
  return prolong_add3d_launch(e, u, out, ncz, ncy, ncx, nz, ny, nx, geom,
                              (cudaStream_t)stream);
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
// planes, planes per chunk) as the caller computed it, refused unless it is
// the compiled one and the chunk rule's for this shape.
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

// One damped-Jacobi sweep per launch (the fused smoother's oracle only).
int mg_jacobi3d_sweep(const float* x, const float* b, float* y, int nz,
                      int ny, int nx, int nzl, int nyl, int nxl, float c,
                      float inv6, int damped, float one_minus_omega,
                      float omega, void* stream) {
  jacobi3d_kernel<<<grid3d_for(nz, ny, nx), dim3(kBlockX, kBlockY), 0,
                    (cudaStream_t)stream>>>(x, b, y, nz, ny, nx, nzl, nyl,
                                            nxl, c, inv6, damped,
                                            one_minus_omega, omega);
  return (int)cudaGetLastError();
}

// `sweeps` (1 .. 4) damped-Jacobi sweeps x -> y on the z-chunked march;
// geom = (tile columns, tile rows, halo, planes per chunk, planes in
// flight) as the caller computed them, refused unless they are the compiled
// ones, the halo is `sweeps` and the chunk is the rule's for this shape.
int mg_jacobi3d(const float* x, const float* b, float* y, int nz, int ny,
                int nx, int nzl, int nyl, int nxl, float c, float inv6,
                int damped, float one_minus_omega, float omega, int sweeps,
                const int* geom, void* stream) {
  static const decltype(&jacobi3d_march_launch<1>) kLaunch[] = {
      jacobi3d_march_launch<1>, jacobi3d_march_launch<2>,
      jacobi3d_march_launch<3>, jacobi3d_march_launch<4>};
  static_assert(kJ3MaxSweeps == 4, "one launcher per sweep count");
  if (sweeps < 1 || sweeps > kJ3MaxSweeps) return (int)cudaErrorInvalidValue;
  return kLaunch[sweeps - 1](x, b, y, nz, ny, nx, nzl, nyl, nxl, c, inv6,
                             damped, one_minus_omega, omega, geom,
                             (cudaStream_t)stream);
}

// `sweeps` (>= 1) damped-Jacobi sweeps x -> y with the whole array in one
// block's shared memory; refused above kResidentMaxPoints points, or when
// the caller's cap (max_points) is not that constant.
int mg_jacobi3d_resident(const float* x, const float* b, float* y, int nz,
                         int ny, int nx, int nzl, int nyl, int nxl, float c,
                         float inv6, int damped, float one_minus_omega,
                         float omega, int sweeps, int max_points,
                         void* stream) {
  static bool smem_set = false;
  const long long n = (long long)nz * ny * nx;
  if (max_points != kResidentMaxPoints || n > kResidentMaxPoints ||
      sweeps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi3d_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        3 * kResidentMaxPoints * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  jacobi3d_resident_kernel<<<1, kResThreads, 3 * (int)n * (int)sizeof(float),
                             (cudaStream_t)stream>>>(
      x, b, y, nz, ny, nx, nzl, nyl, nxl, c, inv6, damped, one_minus_omega,
      omega, sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
