// ELL sparse matrix-vector kernels for Hopper (sm_90a): the SpMV and the
// float-float residual of the AMG solve, and the block product A X.
//
// Ports of the Pallas TPU kernels in multigrid_prj_tpu/ops/pallas_spmv.py:
//   ell_spmv         <- PallasELL.spmv2d (_spmv_kernel, _spmv_compact_kernel,
//                       _spmv_windowed_kernel) and ell_local_spmv2d
//                       (_spmv_kernel)
//   ell_ff_residual  <- PallasELL.residual_ff (_ffres_kernel,
//                       _ffres_compact_kernel)
//   ell_spmm         <- PallasELL.spmm / spmm2d (_spmm_kernel)
// and, replacing no TPU kernel (the JAX package runs these as XLA ops
// around the SpMV), the SpMV with the add or subtraction after it
// (ell_spmv_axpy: the cycle's residual and prolong-add) and the Chebyshev
// smoother's steps (ell_cheb_zero, ell_cheb_first, ell_cheb_step).
//
// Layout: one slot-major ELL serves every matrix (square A, rectangular P
// and P^T; RCM-ordered or not).  colsT (K, n) int32 holds absolute column
// ids, valsT (K, n) f32 the values (and valsT_lo the low words in pair
// mode); K is the longest row, and a padding slot has value 0 and its row's
// first column.  Thread `row` reads slot k at offset k*n + row (64-bit), so
// a warp's loads of one slot are coalesced across 32 consecutive rows.  x is
// gathered through the read-only cache (__ldg).  The TPU kernels needed the
// matrix banded (RCM) to turn the gather into window selects, and refused
// wide bands; a direct gather has no such limit, so none of the window
// bookkeeping (t_win, u_max, tiles2, int16 relative ids) exists here.
//
// Arithmetic: every operation is an explicit round-to-nearest intrinsic,
// which nvcc never contracts into an FMA (the file is also built with
// -fmad=false).  Slots are summed in order k = 0 .. K-1, as the torch twins
// in ops/cuda_spmv.py do, so each kernel is bit-equal to its twin.  (The
// Pallas SpMV sums its slots with a vector reduction, so kernel and TPU
// agree to a tolerance, not bit for bit.)
//
// Bound: memory.  The SpMV streams 8 B per slot (value and column id) plus
// the x gather (L2-resident for the banded matrices of the AMG path) and
// 4 B per row written; 2 flops per slot.  The ff residual streams 12 B per
// slot plus two gathers, ~30 flops per slot.  The SpMM streams the 8 B per
// slot once for all its vectors.  These are simple first
// versions: one thread per row, no shared-memory x tiles, no warp-per-row
// for long coarse rows, no vector loads.

#include <cuda_runtime.h>

namespace {

// y[row] = sum_k valsT[k, row] * x[colsT[k, row]], in slot order.
__global__ void ell_spmv_kernel(const int* __restrict__ colsT,
                                const float* __restrict__ valsT,
                                const float* __restrict__ x,
                                float* __restrict__ y, int n, int K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long p = (long long)k * n + row;
    acc = __fadd_rn(acc, __fmul_rn(valsT[p], __ldg(&x[colsT[p]])));
  }
  y[row] = acc;
}

// y = z - A x (subtract != 0) or y = z + A x: ell_spmv_kernel's sum, then
// one rounded add, so y is bit-equal to the SpMV followed by torch's
// subtraction (the residual b - A x) or addition (x + P e, the
// prolongation and add).  8 B per slot, the x gather, z read, y written.
__global__ void ell_spmv_axpy_kernel(const int* __restrict__ colsT,
                                     const float* __restrict__ valsT,
                                     const float* __restrict__ x,
                                     const float* __restrict__ z,
                                     float* __restrict__ y, int n, int K,
                                     int subtract) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long p = (long long)k * n + row;
    acc = __fadd_rn(acc, __fmul_rn(valsT[p], __ldg(&x[colsT[p]])));
  }
  y[row] = subtract ? __fsub_rn(z[row], acc) : __fadd_rn(z[row], acc);
}

// One step of the Chebyshev smoother of amg.chebyshev_smooth, in its
// operation order: r = b - A x, t = r / d, then p = t / theta on the first
// step or p = c1 p + c2 t on a later one, and x_out = x + p.  x_out is
// written out of place (other rows gather x); p in place (only its own
// row reads it).  The first step from x = 0 (each level's start in a
// cycle) reads no matrix: r = b - 0 and x_out = 0 + p, as the SpMV of
// zeros (whose sum is +0) gives.  Three kernels, so that a trace prices
// each by what it moves.
__device__ __forceinline__ float ell_row_sum(const int* __restrict__ colsT,
                                             const float* __restrict__ valsT,
                                             const float* __restrict__ x,
                                             int row, int n, int K) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long p = (long long)k * n + row;
    acc = __fadd_rn(acc, __fmul_rn(valsT[p], __ldg(&x[colsT[p]])));
  }
  return acc;
}

__global__ void ell_cheb_zero_kernel(const float* __restrict__ b,
                                     const float* __restrict__ d,
                                     float* __restrict__ p,
                                     float* __restrict__ x_out, int n,
                                     float theta) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float r = __fsub_rn(b[row], 0.0f);
  const float pn = __fdiv_rn(__fdiv_rn(r, d[row]), theta);
  p[row] = pn;
  x_out[row] = __fadd_rn(0.0f, pn);
}

__global__ void ell_cheb_first_kernel(const int* __restrict__ colsT,
                                      const float* __restrict__ valsT,
                                      const float* __restrict__ x,
                                      const float* __restrict__ b,
                                      const float* __restrict__ d,
                                      float* __restrict__ p,
                                      float* __restrict__ x_out, int n,
                                      int K, float theta) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float r = __fsub_rn(b[row], ell_row_sum(colsT, valsT, x, row, n, K));
  const float pn = __fdiv_rn(__fdiv_rn(r, d[row]), theta);
  p[row] = pn;
  x_out[row] = __fadd_rn(x[row], pn);
}

__global__ void ell_cheb_step_kernel(const int* __restrict__ colsT,
                                     const float* __restrict__ valsT,
                                     const float* __restrict__ x,
                                     const float* __restrict__ b,
                                     const float* __restrict__ d,
                                     float* __restrict__ p,
                                     float* __restrict__ x_out, int n, int K,
                                     float c1, float c2) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float r = __fsub_rn(b[row], ell_row_sum(colsT, valsT, x, row, n, K));
  const float t = __fdiv_rn(r, d[row]);
  const float pn = __fadd_rn(__fmul_rn(c1, p[row]), __fmul_rn(c2, t));
  p[row] = pn;
  x_out[row] = __fadd_rn(x[row], pn);
}

// r = b - A x with A = (vh + vl), x = (xh + xl), b = (bh + bl) as f32
// pairs, in _ffres_kernel's operation order (pallas_spmv.py:316-339):
//   p = vh*gh; Dekker two_prod error e from the Veltkamp (4097) splits of
//   vh and gh; e += vh*gl + vl*gh; from acc = (bh, bl) a cascaded two_sum
//   of -p per slot, renormalised with fast_two_sum; output acc_h + acc_l.
// The two_sum chains are exact only if no add is contracted: hence the
// intrinsics throughout.
__global__ void ell_ff_residual_kernel(
    const int* __restrict__ colsT, const float* __restrict__ vhT,
    const float* __restrict__ vlT, const float* __restrict__ xh,
    const float* __restrict__ xl, const float* __restrict__ bh,
    const float* __restrict__ bl, float* __restrict__ r, int n, int K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float acc_h = bh[row];
  float acc_l = bl[row];
  for (int k = 0; k < K; ++k) {
    const long long q = (long long)k * n + row;
    const int c = colsT[q];
    const float vh = vhT[q];
    const float vl = vlT[q];
    const float gh = __ldg(&xh[c]);
    const float gl = __ldg(&xl[c]);
    const float p = __fmul_rn(vh, gh);
    const float c1 = __fmul_rn(4097.0f, vh);
    const float ah = __fsub_rn(c1, __fsub_rn(c1, vh));
    const float al = __fsub_rn(vh, ah);
    const float c2 = __fmul_rn(4097.0f, gh);
    const float bh2 = __fsub_rn(c2, __fsub_rn(c2, gh));
    const float bl2 = __fsub_rn(gh, bh2);
    // ((ah*bh - p) + ah*bl + al*bh) + al*bl, left to right
    float e = __fsub_rn(__fmul_rn(ah, bh2), p);
    e = __fadd_rn(e, __fmul_rn(ah, bl2));
    e = __fadd_rn(e, __fmul_rn(al, bh2));
    e = __fadd_rn(e, __fmul_rn(al, bl2));
    // e + vh*gl + vl*gh, left to right
    e = __fadd_rn(e, __fmul_rn(vh, gl));
    e = __fadd_rn(e, __fmul_rn(vl, gh));
    // two_sum(acc_h, -p), then the low words, then fast_two_sum
    const float s = __fsub_rn(acc_h, p);
    const float bb = __fsub_rn(s, acc_h);
    float err = __fadd_rn(__fsub_rn(acc_h, __fsub_rn(s, bb)),
                          __fsub_rn(-p, bb));
    err = __fadd_rn(err, __fsub_rn(acc_l, e));
    acc_h = __fadd_rn(s, err);
    acc_l = __fsub_rn(err, __fsub_rn(acc_h, s));
  }
  r[row] = __fadd_rn(acc_h, acc_l);
}

// Y = A X for a row-major (m, NV) block X, NV <= 8 (replaces _spmm_kernel):
// one thread per row as ell_spmv_kernel, NV accumulators in registers, and
// per slot one gather of the contiguous row X[col, 0:NV] (16 B at NV = 4).
// Each column is ell_spmv_kernel's sum in the same order, so the result is
// bit-equal to NV SpMVs.  Bytes: A once (8 B per slot) plus the gathered X
// rows and Y, against NV x (A + x + y) for NV SpMVs.
template <int NV>
__global__ void ell_spmm_kernel(const int* __restrict__ colsT,
                                const float* __restrict__ valsT,
                                const float* __restrict__ X,
                                float* __restrict__ Y, int n, int K) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long p = (long long)k * n + row;
    const float a = valsT[p];
    const float* __restrict__ xr = X + (long long)colsT[p] * NV;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      acc[v] = __fadd_rn(acc[v], __fmul_rn(a, __ldg(&xr[v])));
    }
  }
  float* __restrict__ yr = Y + (long long)row * NV;
#pragma unroll
  for (int v = 0; v < NV; ++v) yr[v] = acc[v];
}

constexpr int kBlock = 256;

int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

template <int NV>
int launch_spmm(const int* colsT, const float* valsT, const float* X,
                float* Y, int n, int K, cudaStream_t stream) {
  ell_spmm_kernel<NV><<<blocks_for(n), kBlock, 0, stream>>>(colsT, valsT, X,
                                                            Y, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" {

int mg_ell_spmv(const int* colsT, const float* valsT, const float* x,
                float* y, int n, int K, void* stream) {
  if (n <= 0) return 0;
  ell_spmv_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      colsT, valsT, x, y, n, K);
  return (int)cudaGetLastError();
}

int mg_ell_spmv_axpy(const int* colsT, const float* valsT, const float* x,
                     const float* z, float* y, int n, int K, int subtract,
                     void* stream) {
  if (n <= 0) return 0;
  ell_spmv_axpy_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      colsT, valsT, x, z, y, n, K, subtract);
  return (int)cudaGetLastError();
}

int mg_ell_cheb_step(const int* colsT, const float* valsT, const float* x,
                     const float* b, const float* d, float* p, float* x_out,
                     int n, int K, float c1, float c2, int first,
                     void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (first && x == nullptr) {
    ell_cheb_zero_kernel<<<blocks_for(n), kBlock, 0, s>>>(b, d, p, x_out, n,
                                                          c2);
  } else if (first) {
    ell_cheb_first_kernel<<<blocks_for(n), kBlock, 0, s>>>(
        colsT, valsT, x, b, d, p, x_out, n, K, c2);
  } else if (x == nullptr) {
    return (int)cudaErrorInvalidValue;  // only the first step starts at 0
  } else {
    ell_cheb_step_kernel<<<blocks_for(n), kBlock, 0, s>>>(
        colsT, valsT, x, b, d, p, x_out, n, K, c1, c2);
  }
  return (int)cudaGetLastError();
}

int mg_ell_ff_residual(const int* colsT, const float* vhT, const float* vlT,
                       const float* xh, const float* xl, const float* bh,
                       const float* bl, float* r, int n, int K,
                       void* stream) {
  if (n <= 0) return 0;
  ell_ff_residual_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      colsT, vhT, vlT, xh, xl, bh, bl, r, n, K);
  return (int)cudaGetLastError();
}

int mg_ell_spmm(const int* colsT, const float* valsT, const float* X,
                float* Y, int n, int K, int nvec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nvec) {
    case 1: return launch_spmm<1>(colsT, valsT, X, Y, n, K, s);
    case 2: return launch_spmm<2>(colsT, valsT, X, Y, n, K, s);
    case 3: return launch_spmm<3>(colsT, valsT, X, Y, n, K, s);
    case 4: return launch_spmm<4>(colsT, valsT, X, Y, n, K, s);
    case 5: return launch_spmm<5>(colsT, valsT, X, Y, n, K, s);
    case 6: return launch_spmm<6>(colsT, valsT, X, Y, n, K, s);
    case 7: return launch_spmm<7>(colsT, valsT, X, Y, n, K, s);
    case 8: return launch_spmm<8>(colsT, valsT, X, Y, n, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
