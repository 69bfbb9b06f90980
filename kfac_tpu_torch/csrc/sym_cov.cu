// Symmetric second moment C = a^T a / scale of a row-major (N, D) f32 matrix.
//
// Replaces the TPU kernel _sym_cov_kernel (kfac_tpu/ops/pallas_cov.py:40,
// called at :88 by sym_cov). Like it, only tiles on or above the diagonal
// are computed and each result is written to both (i, j) and (j, i), so C
// is exactly symmetric.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kBK = 16;        // rows of `a` staged per step

template <int TM>
__global__ void __launch_bounds__(kThreads)
sym_cov_kernel(const float* __restrict__ a, float* __restrict__ c, int n,
               int d, float scale, int nblk) {
  constexpr int W = 16 * TM;  // tile edge
  __shared__ float si[kBK][W];
  __shared__ float sj[kBK][W];

  // blockIdx.x -> (bi, bj) with bi <= bj, row-major over the upper triangle
  int t = blockIdx.x;
  int bi = 0;
  while (t >= nblk - bi) {
    t -= nblk - bi;
    ++bi;
  }
  const int bj = bi + t;
  const int i0 = bi * W;
  const int j0 = bj * W;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[TM][TM];
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

  // Epilogue: scale and write each upper element to both halves. On a
  // diagonal tile only gi <= gj is written, so every pair (i, j), (j, i)
  // comes from one accumulator: exact symmetry.
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

}  // namespace

extern "C" {

// Launch on `stream`; `tile` is 32 or 64 (the output tile edge). Returns
// cudaGetLastError() after the launch.
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

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
