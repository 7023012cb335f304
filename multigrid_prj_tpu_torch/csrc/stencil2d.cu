// 2D Poisson stencil kernels for Hopper (sm_90a): the smoother, residual and
// float-float residual of the padded GMG V-cycle.
//
// Ports of the Pallas TPU kernels in multigrid_prj_tpu/ops/pallas_stencil.py:
//   rbgs_color  <- red_black_gauss_seidel (_rbgs_fused_kernel /
//                  _rbgs_fused2d_kernel, shared body _fused_rbgs_passes)
//   residual    <- poisson_residual (_residual_kernel)
//   ff_residual <- ff_poisson_residual (_ff_residual_kernel)
//
// Layout: one thread per point of the full physical (n, m) row-major f32
// array, on a 2D grid of blocks.  (nl, ml) are the logical extents: a point
// is boundary if it is on row 0 or column 0 or at/beyond nl-1 / ml-1, which
// pins the padded dead zone.  Boundary points never read neighbours and every
// array-edge point is a boundary point, so no read leaves the array and no
// halo or clamping is needed.  Any 2D shape is accepted.
//
// Arithmetic: every add and multiply is an explicit round-to-nearest
// intrinsic (__fadd_rn / __fmul_rn), which nvcc never contracts into an FMA
// (the file is also built with -fmad=false).  The op order matches the
// Pallas kernels and the torch twins in ops/cuda_stencil.py, so each kernel
// is bit-equal to its twin.
//
// This is the simple first version: one launch per colour half-sweep (the
// TPU fuses up to 4 sweeps per memory pass) and no shared-memory tiling.
// Each kernel streams its operands from HBM once per launch and is bound by
// memory bandwidth (bytes per point are noted at each kernel).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool is_boundary(int i, int j, int nl, int ml) {
  return i == 0 || j == 0 || i >= nl - 1 || j >= ml - 1;
}

// One colour half-sweep of red-black Gauss-Seidel, in place on u.
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

}  // extern "C"
