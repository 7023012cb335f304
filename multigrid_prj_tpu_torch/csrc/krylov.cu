// Vector updates of the conjugate-gradient step for Hopper (sm_90a): the
// kernels that ops/krylov.cg_arrays takes on the kernel route
// (ops/cuda_krylov.py), so an inner_cg refined solve's CG runs each update
// as one pass.
//
// These replace no TPU kernel: the JAX package leaves CG's vector
// arithmetic to XLA (multigrid_prj_tpu/ops/krylov.py cg_arrays), and torch
// runs each update as a multiply kernel and an add kernel, five passes over
// the vectors where the step needs two:
//   cg_xr_update  x' = x + alpha p and r' = r - alpha Ap, with r'.r' summed
//                 on the way: per thread, per warp by shuffles, per block
//                 into partials[blockIdx.x]; cg_rr_sum then sums the
//                 partials in a fixed order (one block), so the norm is the
//                 same from run to run (no atomics).  x' goes to x_out,
//                 which may be x itself (in place); r' is written in place.
//   cg_p_update   p' = z + (rz1 / rz) p, in place.
// alpha, rz1 and rz are 0-dim device scalars read through pointers: the
// host never fetches them.
//
// Bound: bytes, 24 B a point for cg_xr_update (x, p, r, Ap read; x, r
// written) and 12 B for cg_p_update (z, p read; p written).  Design: a
// grid-stride loop over 16-byte vectors, a scalar tail for the last n % 4
// points (or every point when an operand is not 16-byte aligned), 256
// threads a block and 8 blocks an SM, one resident wave (the wrapper sizes
// the grid); any contiguous f32 vector, 2D padded, 3D or 1D.
//
// Arithmetic: each update is a rounded product and then a rounded sum or
// difference (__fmul_rn, __fadd_rn / __fsub_rn, never contracted; the file
// is also built with -fmad=false), and beta = __fdiv_rn(rz1, rz): torch's
// two kernels and its 0-dim division round the same way, so x', r' and p'
// are bit-equal to the plain twins.  The norm sums the rounded squares in
// another order than torch.vdot, so it agrees with it to f32 round-off.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;  // 2048 threads: at most 32 registers each

// The block's sum of v in a fixed order (a shuffle tree in each warp, then
// one over the warps' sums), in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    }
  }
  return v;
}

__device__ __forceinline__ float xr_point(float xi, float pi, float ri,
                                          float api, float a, float& xo) {
  xo = __fadd_rn(xi, __fmul_rn(a, pi));
  return __fsub_rn(ri, __fmul_rn(a, api));
}

// x and x_out may be one array (each point is read and written by the same
// thread), so neither is __restrict__; p and Ap alias nothing written.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
cg_xr_update_kernel(const float* x, float* x_out, float* r,
                    const float* __restrict__ p, const float* __restrict__ ap,
                    const float* __restrict__ alpha,
                    float* __restrict__ partials, long long n, int vec) {
  __shared__ float warp_sums[kWarps];
  const float a = *alpha;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  // one partial sum per vector lane, combined once at the end
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (long long v = first; v < n4; v += stride) {
    const float4 xv = reinterpret_cast<const float4*>(x)[v];
    const float4 rv = reinterpret_cast<const float4*>(r)[v];
    const float4 pv = __ldg(reinterpret_cast<const float4*>(p) + v);
    const float4 av = __ldg(reinterpret_cast<const float4*>(ap) + v);
    float4 xo, ro;
    ro.x = xr_point(xv.x, pv.x, rv.x, av.x, a, xo.x);
    ro.y = xr_point(xv.y, pv.y, rv.y, av.y, a, xo.y);
    ro.z = xr_point(xv.z, pv.z, rv.z, av.z, a, xo.z);
    ro.w = xr_point(xv.w, pv.w, rv.w, av.w, a, xo.w);
    reinterpret_cast<float4*>(x_out)[v] = xo;
    reinterpret_cast<float4*>(r)[v] = ro;
    s0 = __fadd_rn(s0, __fmul_rn(ro.x, ro.x));
    s1 = __fadd_rn(s1, __fmul_rn(ro.y, ro.y));
    s2 = __fadd_rn(s2, __fmul_rn(ro.z, ro.z));
    s3 = __fadd_rn(s3, __fmul_rn(ro.w, ro.w));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float xo;
    const float ro = xr_point(x[i], p[i], r[i], ap[i], a, xo);
    x_out[i] = xo;
    r[i] = ro;
    s0 = __fadd_rn(s0, __fmul_rn(ro, ro));
  }
  const float s = block_sum(__fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3)),
                            warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// The partials of cg_xr_update_kernel, summed by one block in a fixed
// order: thread t the partials t, t + 256, ..., then block_sum.
__global__ void __launch_bounds__(kThreads)
cg_rr_sum_kernel(const float* __restrict__ partials, int count,
                 float* __restrict__ rr) {
  __shared__ float warp_sums[kWarps];
  float s = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    s = __fadd_rn(s, partials[i]);
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) *rr = s;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
cg_p_update_kernel(const float* __restrict__ z, float* __restrict__ p,
                   const float* __restrict__ rz1,
                   const float* __restrict__ rz, long long n, int vec) {
  const float beta = __fdiv_rn(*rz1, *rz);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long v = first; v < n4; v += stride) {
    const float4 zv = __ldg(reinterpret_cast<const float4*>(z) + v);
    float4 pv = reinterpret_cast<const float4*>(p)[v];
    pv.x = __fadd_rn(zv.x, __fmul_rn(beta, pv.x));
    pv.y = __fadd_rn(zv.y, __fmul_rn(beta, pv.y));
    pv.z = __fadd_rn(zv.z, __fmul_rn(beta, pv.z));
    pv.w = __fadd_rn(zv.w, __fmul_rn(beta, pv.w));
    reinterpret_cast<float4*>(p)[v] = pv;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    p[i] = __fadd_rn(z[i], __fmul_rn(beta, p[i]));
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().  ``blocks``
// is the grid (the wrapper's); ``partials`` holds ``blocks`` floats; ``vec``
// is 0 when an operand is not 16-byte aligned.
extern "C" {

int mg_cg_xr_update(const float* x, float* x_out, float* r, const float* p,
                    const float* ap, const float* alpha, float* partials,
                    float* rr, long long n, int blocks, int vec,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cg_xr_update_kernel<<<blocks, kThreads, 0, s>>>(x, x_out, r, p, ap, alpha,
                                                  partials, n, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_rr_sum_kernel<<<1, kThreads, 0, s>>>(partials, blocks, rr);
  return (int)cudaGetLastError();
}

int mg_cg_p_update(const float* z, float* p, const float* rz1,
                   const float* rz, long long n, int blocks, int vec,
                   void* stream) {
  cg_p_update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      z, p, rz1, rz, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
