// One Newton-Schulz iteration of the damped inverse, for a (d, d) f32 M:
//
//   x_new  = x (2I - mx)
//   mx_new = M x_new
//   resid  = ||I - mx_new||_F / sqrt(d)
//
// Replaces the TPU kernels _ns_xupdate_kernel (kfac_tpu/ops/pallas_ns.py:63,
// called at :127) and _ns_mx_resid_kernel (:81, called at :139), the pair
// behind fused_ns_step (:110). As there, no identity and no 2I - mx ever
// reach device memory: the x-update kernel writes 2[r == c] - mx[r, c] while
// it stages its B tile in shared memory, and the M x_new kernel sums
// (delta_rc - C_rc)^2 over its finished tile in the epilogue.
//
// Bound on an H100: 4 d^3 f32 FLOPs (two d^3 products) against 5 d^2 * 4
// bytes (m, x, mx read, x_new, mx_new written). At d = 2048 that is 3.4e10
// FLOP (0.51 ms at the 67 TFLOP/s f32 peak) against 84 MB (0.025 ms at
// 3.35 TB/s), and at d = 512 0.008 ms against 0.0016 ms: bound by
// operations at every flagship size.
//
// Design: both products are one tiled f32 FMA kernel, one CTA per output
// tile on a 2-D grid. The TPU's sequential k grid axis becomes a loop over
// d inside the CTA, staging a kBK-deep slab of A (transposed, padded
// against bank conflicts) and of B in shared memory; each of the 256
// threads keeps TM x TM accumulators in registers. Ragged d (513, 2049) is
// masked on load and on store: outside d both operands read 0, so padding
// adds nothing to a product, and the residual counts only r < d && c < d.
// The TPU accumulates the residual across its sequential grid; here CTAs
// run in no order, so each CTA writes its partial sum (a fixed-order tree
// over its threads) to partials[cta], and a single-CTA pass sums the
// partials in a fixed order and writes sqrt(sum) / sqrt(d). No float
// atomics: the residual repeats bit for bit from run to run. No tensor
// cores: products stay f32 (TF32 would keep ~3 decimal digits).
// wgmma/TMA pipelining is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kBK = 16;        // depth of the staged k slab

// C = A op(B) for row-major (d, d) A, B, C, where op(B) = 2I - B when
// kTwoIMinusB, else B. With kResid, also writes this CTA's sum of
// (delta_rc - C_rc)^2 over its in-range elements to partials[cta].
template <int TM, bool kTwoIMinusB, bool kResid>
__global__ void __launch_bounds__(kThreads)
ns_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, float* __restrict__ partials, int d) {
  constexpr int W = 16 * TM;  // tile edge
  __shared__ float sa[kBK][W + 1];
  __shared__ float sb[kBK][W];
  __shared__ float red[kThreads];

  const int i0 = blockIdx.y * W;
  const int j0 = blockIdx.x * W;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[r][q] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // kBK * W == kThreads * TM: each thread stages TM elements of each slab
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int e = threadIdx.x + u * kThreads;
      {
        // A rows i0.., columns k0..: consecutive threads on consecutive k
        const int kk = e % kBK;
        const int row = e / kBK;
        const int gr = i0 + row;
        const int gk = k0 + kk;
        sa[kk][row] = (gr < d && gk < d)
                          ? a[static_cast<size_t>(gr) * d + gk]
                          : 0.f;
      }
      {
        // B rows k0.., columns j0..: consecutive threads on consecutive
        // columns (coalesced rows of B)
        const int kk = e / W;
        const int col = e % W;
        const int gk = k0 + kk;
        const int gc = j0 + col;
        float v = 0.f;
        if (gk < d && gc < d) {
          v = b[static_cast<size_t>(gk) * d + gc];
          if (kTwoIMinusB) v = (gk == gc ? 2.f : 0.f) - v;
        }
        sb[kk][col] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float x[TM], y[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) x[r] = sa[kk][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < TM; ++q) y[q] = sb[kk][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < TM; ++q) acc[r][q] = fmaf(x[r], y[q], acc[r][q]);
    }
    __syncthreads();
  }

  float local = 0.f;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int gi = i0 + ty + 16 * r;
      const int gj = j0 + tx + 16 * q;
      if (gi < d && gj < d) {
        const float v = acc[r][q];
        c[static_cast<size_t>(gi) * d + gj] = v;
        if (kResid) {
          const float delta = (gi == gj ? 1.f : 0.f) - v;
          local = fmaf(delta, delta, local);
        }
      }
    }
  }
  if (kResid) {
    // fixed-order tree over the CTA's threads
    red[threadIdx.x] = local;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
  }
}

// resid = sqrt(sum of partials) / sqrt(d), summed in a fixed order by one CTA.
__global__ void __launch_bounds__(kThreads)
ns_resid_final_kernel(const float* __restrict__ partials, int n,
                      float* __restrict__ resid, int d) {
  __shared__ float red[kThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partials[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) resid[0] = sqrtf(red[0]) / sqrtf(static_cast<float>(d));
}

template <int TM>
int launch(const float* m, const float* x, const float* mx, float* x_new,
           float* mx_new, float* partials, float* resid, int d,
           cudaStream_t stream) {
  constexpr int W = 16 * TM;
  const int nblk = (d + W - 1) / W;
  const dim3 grid(nblk, nblk);
  ns_matmul_kernel<TM, true, false>
      <<<grid, kThreads, 0, stream>>>(x, mx, x_new, nullptr, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_matmul_kernel<TM, false, true>
      <<<grid, kThreads, 0, stream>>>(m, x_new, mx_new, partials, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_resid_final_kernel<<<1, kThreads, 0, stream>>>(partials, nblk * nblk,
                                                    resid, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One iteration on `stream`: x_new, mx_new (d, d), resid (one float), with
// `partials` scratch of ceil(d / tile)^2 floats. `tile` is 32 or 64 (the
// output tile edge). Returns the first nonzero cudaGetLastError() of the
// three launches, else 0.
int ns_step_f32(const float* m, const float* x, const float* mx, float* x_new,
                float* mx_new, float* partials, float* resid, int d, int tile,
                cudaStream_t stream) {
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 64)
    return launch<4>(m, x, mx, x_new, mx_new, partials, resid, d, stream);
  if (tile == 32)
    return launch<2>(m, x, mx, x_new, mx_new, partials, resid, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
