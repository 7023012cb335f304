// Design probes for Hopper (sm_90a): the stencil and SpMV ablation kernels
// that locate where the 2D stencil and ELL SpMV kernels lose time.
//
// Ports of the Pallas TPU probes in benchmarks/ (each isolates one cost):
//   probe_copy      <- stencil_ablation.v_copy     u + 1 (the streaming floor)
//   probe_rolls     <- stencil_ablation.v_rolls    (4u - east) - west, columns
//                                                  periodic (pltpu.roll)
//   probe_shifts    <- stencil_ablation.v_shifts   as rolls, columns clamped
//   probe_halo      <- stencil_ablation.v_halo     (4u - north) - south, the
//                                                  TPU's clamped 8-row halo
//                                                  blocks: row 0's north is
//                                                  u[7], row n-1's south u[n-8]
//   probe_full      <- stencil_ablation.v_full     0.1 ((((4u - n) - s) - e)
//                                                  - w) inside, u on the
//                                                  boundary rows and columns
//   probe_carry     <- stencil_ablation.v_carry    v_full's values, u read once
//                                                  by marching down the rows
//   probe_stream    <- spmv_ablation._kernel_probe_stream
//   probe_staticwin <- spmv_ablation._kernel_probe_staticwin
//   probe_noshuffle <- spmv_ablation._kernel_probe_noshuffle
//
// Stencil probes: a row-major f32 (n, m) array; a block of 32 x 8 threads
// covers 32 columns by r rows (r is the TPU probe's block height, swept by
// the harness), each thread r/8 points of its column, 8 rows apart, so a
// warp reads one 128 B row segment.  Neighbours come through L1/L2; every
// probe moves 8 B per point from HBM (u read once, y written once) and does
// 1-6 flops, so each is bound by bytes and the ladder of their times shows
// what the neighbour reads, the clamping and the boundary mask cost on top
// of the copy.  probe_copy moves float4s.  probe_carry is the GPU form of
// the TPU's scratch carry: a block marches r rows of a 256-column strip,
// keeping the north, centre and south rows in registers (prefetched one row
// ahead) and the centre row with its two halo columns in shared memory, so
// u is read once plus two halo rows per segment.
//
// SpMV probes: the port's slot-major ELL (colsT, valsT: (K, n), absolute
// int32 column ids), one thread per row as ell_spmv_kernel (csrc/spmv.cu),
// 1024 threads per block; a block covers block_rows rows (the TPU probe's
// rows per grid step: 1024, 8192 or 32768), each thread block_rows / 1024 of
// them, 1024 apart.  The TPU probes worked on its windowed layout (int16
// relative ids, base2 windows of 8 x 128 entries of x), which the port does
// not have; here each isolates the same cost on absolute ids:
//   stream:    sum_k vals[k, i] * float(cols[k, i]) -- the slots streamed,
//              no gather (exactly the TPU probe's formula);
//   staticwin: x[col & 1023] -- the gather from one fixed 1024-entry window
//              that stays in L1: the gather without its misses;
//   noshuffle: x[(col & ~127) | (row & 127)] -- the column's 128-entry block
//              read at the row's own lane: coalesced, no scattered lanes
//              (x padded to a multiple of 128).
//
// Arithmetic: explicit round-to-nearest intrinsics, built with -fmad=false,
// in the twins' order (ops in the order of the formulas above, slots summed
// k = 0 .. K-1), so each kernel is bit-equal to its torch twin in
// multigrid_prj_tpu_torch/benchmarks/.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kStrip = 256;
constexpr int kSpmvThreads = 1024;

enum NeighbourProbe { kRolls = 0, kShifts = 1, kHalo = 2, kFull = 3 };
enum SpmvProbe { kStream = 0, kStaticWin = 1, kNoShuffle = 2 };

// out = u + 1, four columns per thread (m4 = m / 4 float4s per row).
__global__ void probe_copy_kernel(const float4* __restrict__ u,
                                  float4* __restrict__ out, int n, int m4,
                                  int r) {
  const int c = blockIdx.x * kTx + threadIdx.x;
  if (c >= m4) return;
  const int r1 = min((int)blockIdx.y * r + r, n);
  for (int i = blockIdx.y * r + threadIdx.y; i < r1; i += kTy) {
    const long long p = (long long)i * m4 + c;
    float4 v = u[p];
    v.x = __fadd_rn(v.x, 1.0f);
    v.y = __fadd_rn(v.y, 1.0f);
    v.z = __fadd_rn(v.z, 1.0f);
    v.w = __fadd_rn(v.w, 1.0f);
    out[p] = v;
  }
}

// The four neighbour probes: KIND selects which neighbours are read and
// how the edges are treated (see the table at the top).
template <int KIND>
__global__ void probe_neighbour_kernel(const float* __restrict__ u,
                                       float* __restrict__ out, int n, int m,
                                       int r) {
  const int j = blockIdx.x * kTx + threadIdx.x;
  if (j >= m) return;
  const int r1 = min((int)blockIdx.y * r + r, n);
  for (int i = blockIdx.y * r + threadIdx.y; i < r1; i += kTy) {
    const long long row = (long long)i * m;
    const float c = u[row + j];
    float y;
    if (KIND == kRolls || KIND == kShifts) {
      int jw = j - 1, je = j + 1;
      if (KIND == kRolls) {
        jw = (j == 0) ? m - 1 : jw;
        je = (j == m - 1) ? 0 : je;
      } else {
        jw = max(jw, 0);
        je = min(je, m - 1);
      }
      y = __fsub_rn(__fsub_rn(__fmul_rn(4.0f, c), u[row + je]), u[row + jw]);
    } else if (KIND == kHalo) {
      const int in = (i == 0) ? 7 : i - 1;
      const int is = (i == n - 1) ? n - 8 : i + 1;
      y = __fsub_rn(__fsub_rn(__fmul_rn(4.0f, c), u[(long long)in * m + j]),
                    u[(long long)is * m + j]);
    } else {  // kFull
      y = c;
      if (i > 0 && i < n - 1 && j > 0 && j < m - 1) {
        float s = __fsub_rn(__fmul_rn(4.0f, c), u[row - m + j]);
        s = __fsub_rn(s, u[row + m + j]);
        s = __fsub_rn(s, u[row + j + 1]);
        s = __fsub_rn(s, u[row + j - 1]);
        y = __fmul_rn(0.1f, s);
      }
    }
    out[row + j] = y;
  }
}

// probe_full's values, each block marching rows r0 .. r0+r-1 of a kStrip-
// column strip.  Registers: north (row i-1), centre (i), south (i+1) and the
// prefetched row i+2; thread 0 and thread kStrip-1 also carry the strip's
// west / east halo column.  The centre row goes to shared memory (double
// buffered: one barrier per row) so each thread reads its east and west.
__global__ void __launch_bounds__(kStrip)
probe_carry_kernel(const float* __restrict__ u, float* __restrict__ out,
                   int n, int m, int r) {
  __shared__ float rows[2][kStrip + 2];
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kStrip;
  const int j = j0 + t;
  const bool active = j < m;
  const bool west_halo = (t == 0) && j0 > 0;
  const bool east_halo = (t == kStrip - 1) && j0 + kStrip < m;
  const int r0 = blockIdx.y * r;
  const int r1 = min(r0 + r, n);
  auto at = [&](int i, int col) { return u[(long long)i * m + col]; };
  float north = (active && r0 > 0) ? at(r0 - 1, j) : 0.0f;
  float centre = active ? at(r0, j) : 0.0f;
  float south = (active && r0 + 1 < n) ? at(r0 + 1, j) : 0.0f;
  float hw = west_halo ? at(r0, j0 - 1) : 0.0f;
  float he = east_halo ? at(r0, j0 + kStrip) : 0.0f;
  for (int i = r0; i < r1; ++i) {
    // prefetch row i+2 and the halo columns of row i+1
    const float ahead = (active && i + 2 < n) ? at(i + 2, j) : 0.0f;
    const float hw_next = (west_halo && i + 1 < n) ? at(i + 1, j0 - 1) : 0.0f;
    const float he_next =
        (east_halo && i + 1 < n) ? at(i + 1, j0 + kStrip) : 0.0f;
    float* row = rows[i & 1];
    row[t + 1] = centre;
    if (t == 0) row[0] = hw;
    if (t == kStrip - 1) row[kStrip + 1] = he;
    __syncthreads();
    if (active) {
      float y = centre;
      if (i > 0 && i < n - 1 && j > 0 && j < m - 1) {
        float s = __fsub_rn(__fmul_rn(4.0f, centre), north);
        s = __fsub_rn(s, south);
        s = __fsub_rn(s, row[t + 2]);
        s = __fsub_rn(s, row[t]);
        y = __fmul_rn(0.1f, s);
      }
      out[(long long)i * m + j] = y;
    }
    north = centre;
    centre = south;
    south = ahead;
    hw = hw_next;
    he = he_next;
  }
}

// y[i] = sum_k valsT[k, i] * g(k, i) in slot order; g per MODE (see the top).
template <int MODE>
__global__ void __launch_bounds__(kSpmvThreads)
probe_spmv_kernel(const int* __restrict__ colsT,
                  const float* __restrict__ valsT,
                  const float* __restrict__ x, float* __restrict__ y, int n,
                  int K, int block_rows) {
  const int r0 = blockIdx.x * block_rows;
  const int r1 = min(r0 + block_rows, n);
  for (int row = r0 + threadIdx.x; row < r1; row += kSpmvThreads) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const long long p = (long long)k * n + row;
      const int c = colsT[p];
      float g;
      if (MODE == kStream) {
        g = __int2float_rn(c);
      } else if (MODE == kStaticWin) {
        g = __ldg(&x[c & 1023]);
      } else {
        g = __ldg(&x[(c & ~127) | (row & 127)]);
      }
      acc = __fadd_rn(acc, __fmul_rn(valsT[p], g));
    }
    y[row] = acc;
  }
}

dim3 tile_grid(int n, int m_threads, int r) {
  return dim3((m_threads + kTx - 1) / kTx, (n + r - 1) / r);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" {

int mg_probe_copy(const float* u, float* out, int n, int m, int r,
                  void* stream) {
  if (n <= 0 || m <= 0) return 0;
  probe_copy_kernel<<<tile_grid(n, m / 4, r), dim3(kTx, kTy), 0,
                      (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(u), reinterpret_cast<float4*>(out), n,
      m / 4, r);
  return (int)cudaGetLastError();
}

int mg_probe_neighbour(const float* u, float* out, int n, int m, int r,
                       int kind, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid = tile_grid(n, m, r), block(kTx, kTy);
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kRolls:
      probe_neighbour_kernel<kRolls><<<grid, block, 0, s>>>(u, out, n, m, r);
      break;
    case kShifts:
      probe_neighbour_kernel<kShifts><<<grid, block, 0, s>>>(u, out, n, m, r);
      break;
    case kHalo:
      probe_neighbour_kernel<kHalo><<<grid, block, 0, s>>>(u, out, n, m, r);
      break;
    case kFull:
      probe_neighbour_kernel<kFull><<<grid, block, 0, s>>>(u, out, n, m, r);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int mg_probe_carry(const float* u, float* out, int n, int m, int r,
                   void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kStrip - 1) / kStrip, (n + r - 1) / r);
  probe_carry_kernel<<<grid, kStrip, 0, (cudaStream_t)stream>>>(u, out, n, m,
                                                                r);
  return (int)cudaGetLastError();
}

int mg_probe_spmv(const int* colsT, const float* valsT, const float* x,
                  float* y, int n, int K, int block_rows, int mode,
                  void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + block_rows - 1) / block_rows;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kStream:
      probe_spmv_kernel<kStream><<<grid, kSpmvThreads, 0, s>>>(
          colsT, valsT, x, y, n, K, block_rows);
      break;
    case kStaticWin:
      probe_spmv_kernel<kStaticWin><<<grid, kSpmvThreads, 0, s>>>(
          colsT, valsT, x, y, n, K, block_rows);
      break;
    case kNoShuffle:
      probe_spmv_kernel<kNoShuffle><<<grid, kSpmvThreads, 0, s>>>(
          colsT, valsT, x, y, n, K, block_rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
