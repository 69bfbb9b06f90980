// Symmetric second moment C = a^T a / scale of a row-major (N, D) f32 matrix,
// and the same product blended into a running factor,
// out = beta * F + coeff * a^T a.
//
// Replaces the TPU kernels _sym_cov_kernel (kfac_tpu/ops/pallas_cov.py:40,
// called at :88 by sym_cov) and _sym_cov_ema_kernel
// (kfac_tpu/ops/pallas_cov_ema.py:47, called at :110 by _fused). Like them,
// only tiles on or above the diagonal are computed and each result is
// written to both (i, j) and (j, i), so the output is exactly symmetric.
//
// Bound on an H100: N*D*(D+1) f32 FLOPs against N*D*4 + D*D*4 bytes. At the
// flagship's (8192, 2049) that is 3.4e10 FLOP (0.51 ms at the 67 TFLOP/s
// f32 peak) against 84 MB (0.025 ms at 3.35 TB/s): bound by operations.
// Design: one CTA per upper tile pair (i <= j), a 1-D grid over
// nblk*(nblk+1)/2, so the lower triangle costs nothing. The TPU's
// sequential k grid axis becomes a loop over N inside the CTA, staging a
// kBK-row slab of column blocks i and j in shared memory; each of the 256
// threads keeps TM x TM f32 accumulators in registers. Ragged N and D edges
// are masked on load instead of padded. No tensor cores: f32 products stay
// f32 (TF32 would keep ~3 decimal digits). wgmma/TMA pipelining is later
// work.
//
// The blend (EMA) is sym_cov_ema_kernel: the same main loop (tile_product,
// inlined into both kernels) with another epilogue, in which each thread
// reads F[gi, gj] of its upper element once and writes beta * F + coeff * acc
// to both halves, so the covariance never reaches device memory. It adds one
// read of F's upper triangle to the bound (8.4 MB at D = 2049: 0.003 ms at
// 3.35 TB/s). F is mirrored element by element, where the TPU mirrors whole
// tiles; the two agree because F is symmetric, which is the function's
// contract.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kBK = 16;        // rows of `a` staged per step

// Tile pair (bi, bj), bi <= bj, of this CTA: blockIdx.x row-major over the
// upper triangle of the nblk x nblk grid of tiles.
__device__ __forceinline__ void upper_tile_pair(int nblk, int& bi, int& bj) {
  int t = blockIdx.x;
  bi = 0;
  while (t >= nblk - bi) {
    t -= nblk - bi;
    ++bi;
  }
  bj = bi + t;
}

// The main loop of both kernels: acc[r][q] = sum over the N rows of
// a[k, i0 + ty + 16 r] * a[k, j0 + tx + 16 q].
template <int TM>
__device__ __forceinline__ void tile_product(const float* __restrict__ a,
                                             int n, int d, int i0, int j0,
                                             float (&acc)[TM][TM]) {
  constexpr int W = 16 * TM;  // tile edge
  __shared__ float si[kBK][W];
  __shared__ float sj[kBK][W];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[r][q] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    // kBK * W == kThreads * TM: each thread stages TM elements of each slab,
    // consecutive threads on consecutive columns (coalesced rows of `a`)
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int kk = e / W;
      const int col = e % W;
      const int row = k0 + kk;
      const bool in_rows = row < n;
      const size_t base = static_cast<size_t>(row) * d;
      si[kk][col] = (in_rows && i0 + col < d) ? a[base + i0 + col] : 0.f;
      sj[kk][col] = (in_rows && j0 + col < d) ? a[base + j0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float x[TM], y[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) x[r] = si[kk][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < TM; ++q) y[q] = sj[kk][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < TM; ++q) acc[r][q] = fmaf(x[r], y[q], acc[r][q]);
    }
    __syncthreads();
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
sym_cov_kernel(const float* __restrict__ a, float* __restrict__ c, int n,
               int d, float scale, int nblk) {
  int bi, bj;
  upper_tile_pair(nblk, bi, bj);
  const int i0 = bi * 16 * TM;
  const int j0 = bj * 16 * TM;
  float acc[TM][TM];
  tile_product<TM>(a, n, d, i0, j0, acc);

  // Epilogue: scale and write each upper element to both halves. On a
  // diagonal tile only gi <= gj is written, so every pair (i, j), (j, i)
  // comes from one accumulator: exact symmetry.
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int gi = i0 + ty + 16 * r;
      const int gj = j0 + tx + 16 * q;
      if (gi < d && gj < d && (bi < bj || gi <= gj)) {
        const float v = acc[r][q] / scale;
        c[static_cast<size_t>(gi) * d + gj] = v;
        c[static_cast<size_t>(gj) * d + gi] = v;
      }
    }
  }
}

// sym_cov_kernel with the blend epilogue: c = beta * f + coeff * a^T a.
template <int TM>
__global__ void __launch_bounds__(kThreads)
sym_cov_ema_kernel(const float* __restrict__ a, const float* __restrict__ f,
                   float* __restrict__ c, int n, int d, float beta,
                   float coeff, int nblk) {
  int bi, bj;
  upper_tile_pair(nblk, bi, bj);
  const int i0 = bi * 16 * TM;
  const int j0 = bj * 16 * TM;
  float acc[TM][TM];
  tile_product<TM>(a, n, d, i0, j0, acc);

  // Epilogue: blend and write each upper element to both halves, as in
  // sym_cov_kernel.
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int gi = i0 + ty + 16 * r;
      const int gj = j0 + tx + 16 * q;
      if (gi < d && gj < d && (bi < bj || gi <= gj)) {
        const size_t ij = static_cast<size_t>(gi) * d + gj;
        const float v = beta * f[ij] + coeff * acc[r][q];
        c[ij] = v;
        c[static_cast<size_t>(gj) * d + gi] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// c = a^T a / scale. Launch on `stream`; `tile` is 32 or 64 (the output
// tile edge). Returns cudaGetLastError() after the launch.
int sym_cov_f32(const float* a, float* c, int n, int d, float scale,
                int tile, cudaStream_t stream) {
  const int nblk = (d + tile - 1) / tile;
  const int grid = nblk * (nblk + 1) / 2;
  if (tile == 64) {
    sym_cov_kernel<4><<<grid, kThreads, 0, stream>>>(a, c, n, d, scale, nblk);
  } else if (tile == 32) {
    sym_cov_kernel<2><<<grid, kThreads, 0, stream>>>(a, c, n, d, scale, nblk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// c = beta * f + coeff * a^T a for a symmetric (D, D) f; c must not alias f.
// Same launch rules and return value as sym_cov_f32.
int sym_cov_ema_f32(const float* a, const float* f, float* c, int n, int d,
                    float beta, float coeff, int tile, cudaStream_t stream) {
  const int nblk = (d + tile - 1) / tile;
  const int grid = nblk * (nblk + 1) / 2;
  if (tile == 64) {
    sym_cov_ema_kernel<4><<<grid, kThreads, 0, stream>>>(a, f, c, n, d, beta,
                                                         coeff, nblk);
  } else if (tile == 32) {
    sym_cov_ema_kernel<2><<<grid, kThreads, 0, stream>>>(a, f, c, n, d, beta,
                                                         coeff, nblk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
