// 3D 7-point Poisson stencil kernels for Hopper (sm_90a): the smoothers,
// residual and operator apply of the 3D GMG V-cycle.
//
// Ports of the Pallas TPU kernels in
// multigrid_prj_tpu/ops/pallas_stencil_3d.py:
//   apply3d      <- poisson_apply_3d (_apply3d_kernel)
//   residual3d   <- poisson_residual_3d (_residual3d_kernel)
//   rbgs3d_color <- red_black_gauss_seidel_3d (_rbgs3d_color_kernel)
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
// These are simple first versions: one thread per point, neighbours read
// through L1/L2 (no shared-memory tiling, no z-marching), one launch per
// colour half-sweep or Jacobi sweep.  Each kernel streams its operands from
// HBM once per launch and is bound by memory bandwidth (bytes per point are
// noted at each kernel).

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

// r = b - (boundary ? u : c*(6u - nb))  (_residual3d_kernel :117).
// 12 B/point: read u and b, write r.
__global__ void residual3d_kernel(const float* __restrict__ u,
                                  const float* __restrict__ b,
                                  float* __restrict__ r, int nz, int ny,
                                  int nx, int nzl, int nyl, int nxl,
                                  float c) {
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
// (_rbgs3d_color_kernel :128).  12 B/point over the launch: read b and the
// other colour's neighbours, write this colour.
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

int mg_residual3d(const float* u, const float* b, float* r, int nz, int ny,
                  int nx, int nzl, int nyl, int nxl, float c, void* stream) {
  residual3d_kernel<<<grid3d_for(nz, ny, nx), dim3(kBlockX, kBlockY), 0,
                      (cudaStream_t)stream>>>(u, b, r, nz, ny, nx, nzl, nyl,
                                              nxl, c);
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
