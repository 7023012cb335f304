// 2D Poisson stencil and grid-transfer kernels for Hopper (sm_90a): every
// kernel of the padded GMG V-cycle, its ff32 refinement, the inner_cg apply
// and the Jacobi smoother, in this one source file.
//
// Ports of the Pallas TPU kernels in multigrid_prj_tpu/ops/pallas_stencil.py:
//   rbgs_color  <- red_black_gauss_seidel (_rbgs_fused_kernel /
//                  _rbgs_fused2d_kernel, shared body _fused_rbgs_passes)
//   residual    <- poisson_residual (_residual_kernel)
//   ff_residual <- ff_poisson_residual (_ff_residual_kernel)
//   apply       <- poisson_apply (_apply_kernel / _apply_carry_kernel)
//   jacobi      <- jacobi (_jacobi_fused_kernel / _jacobi_fused2d_kernel,
//                  shared body _fused_jacobi_passes)
//   restrict_fw <- restrict_fw_padded_fast (_fw_filter2d_kernel plus the
//                  wrapper's decimation and edge fix-up)
//   prolong_add <- prolong_add_padded_fast (_prolong_add_kernel)
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
// These are simple first versions: one launch per colour half-sweep or
// Jacobi sweep (the TPU fuses up to 4 / 8 sweeps per memory pass) and no
// shared-memory tiling.  Each kernel streams its operands from HBM once per
// launch and is bound by memory bandwidth (bytes per point are noted at each
// kernel).

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
// One thread per fine point.  About 9 B per fine point: read u, write out,
// read e (a quarter of the points).
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

int mg_prolong_add(const float* e, const float* u, float* out, int pc_r,
                   int pc_c, void* stream) {
  prolong_add_kernel<<<grid_for(2 * pc_r, 2 * pc_c), dim3(kBlockX, kBlockY), 0,
                       (cudaStream_t)stream>>>(e, u, out, pc_r, pc_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
