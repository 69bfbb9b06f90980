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
//
// sym_cov (sym_cov_tc_kernel) runs on the tensor cores at f32 accuracy by
// 3xTF32 splitting: each staged value x becomes hi = tf32(x) and
// lo = tf32(x - hi), and mma.sync m16n8k8 TF32 sums lo*hi + hi*lo + hi*hi
// (the dropped lo*lo is ~2^-20 of a product) over a 32-row slab; each
// slab's partial joins the f32 accumulator in plain f32 adds, since the
// tensor cores' own f32 sums drift over long chains.
// That is 3 TF32 products per f32 product: a bound of 3*N*D*(D+1) / 495
// TFLOP/s (0.21 ms at (8192, 2049)), under the f32 one above.
// - One CTA per upper tile pair (bi <= bj) and row slice: a 2-D grid, x over
//   nblk*(nblk+1)/2 pairs, y over S slices of N. Tiles are 64 wide, 4 warps
//   of 32 x 32 (119 registers a thread and 55 KB of shared memory, so an SM
//   holds 4 CTAs). 128-wide tiles of 8 warps of 64 x 32 (217 registers, one
//   CTA an SM) were not faster at every one of the flagship's four shapes,
//   so one tile width is built.
// - Rows are staged 32 at a time (a slab: the slab of column block bi and
//   that of bj, one buffer on a diagonal pair) in a ring of 3 stages in
//   dynamic shared memory, filled by 16-byte cp.async copies, so the next
//   slabs load while this one is multiplied. Where D % 4 != 0 a row of `a`
//   starts off a 16-byte boundary; its slab row then starts at the boundary
//   before it, and the fragment reads skip the row's shift. Rows past N and
//   bytes past the end of `a` are zero-filled by the copies' source size,
//   not padded in device memory.
// - Both mma operands are column blocks of `a`, so A is a transposed read of
//   the slab. ldmatrix moves 16-bit elements only, so fragments come from
//   32-bit shared loads; a slab row is padded to tile + 8 floats, which puts
//   the (t, g) lanes of a fragment read on 32 distinct banks.
// - S > 1 where the pair grid cannot fill the card (D ~ 512: 36-45 pairs):
//   each CTA writes its partial tile to scratch the wrapper allocates, and
//   sym_cov_reduce_kernel adds the S partials in slice order, divides by
//   `scale` and mirrors. S = 1 writes C directly. Either way no float
//   atomics: the result is the same bit for bit on every run.
// S comes from ops/sym_cov.py's plan().
//
// bf16 and f16 (sym_cov_wgmma_kernel<T, kBlend>): the TPU kernel takes `a`
// in any dtype, accumulates a^T a in f32, divides by `scale` in f32 and
// rounds once to a.dtype (pallas_cov.py:66-105); these forms compute that
// function (and with kBlend sym_cov_ema's: f32 F and output). The product
// of two bf16 or f16 values is exact in f32, so wgmma takes the values as
// they are, f32 accumulate. Bound at the flagship's (8192, 2048): 3.4e10
// FLOP at the 989 TFLOP/s bf16/f16 peak, 0.035 ms, against 42 MB of input
// and output (0.013 ms at 3.35 TB/s): bound by operations. Design:
// - Both operands of a^T a are column blocks of `a` with N as the depth,
//   so both are MN-major in shared memory: a TMA box of 64 columns x 64
//   rows, 128-byte swizzled, is wgmma's canonical MN-major layout, read
//   through its transpose bits. The f32 form cannot do this (a 32-bit
//   wgmma operand must be K-major; newton_schulz.cu builds its own).
// - Tiles of 128 x 128; one CTA an SM (a ring of 5 stages of 32 KB and
//   the epilogue's tile of C's values, 33 KB in 16 bits, 66 KB for the
//   blend's f32), 288 threads: one
//   producer warp issues the TMA loads into the mbarrier ring, two
//   consumer warpgroups of 64 rows each run wgmma m64n128k16.
// - TMA reads rows that start on 16 bytes: ld % 8 == 0 and `a` on a
//   16-byte boundary. The A builders of ops/cov.py write the bias-augmented
//   rows (d = 513, 2049) into a buffer whose rows are rounded up to 64
//   values (128 bytes, so that a box row lies in one L2 line); the wrapper
//   copies any layout TMA cannot read into such a buffer.
// - Wave quantisation: D = 2048 has 136 pairs, two waves on 132 SMs for
//   1.03 waves of work. ops/sym_cov.py's plan16 gives every SM the same
//   number of whole pairs and cuts only the rest into row slices; the
//   CTAs are persistent and walk the items (Walk, below), so one CTA's
//   epilogue overlaps its next item's loads. A second pass adds the
//   slices' partial tiles in slice order. No float atomics: every run
//   gives the same bits.
// - The sum chains in the tensor cores over an item's rows. Their f32
//   adds may truncate; over 8192 rows that stays far below one rounding
//   of a 16-bit output. The blend's output is f32 and held to 1e-5, so
//   there each slab's product starts from 0 and joins the sum in f32 adds.
// The epilogue divides by `scale` in f32 and rounds to T to nearest
// (__float2bfloat16_rn, __float2half_rn), once.
//
// sym_cov_ema runs the same kernels with the blend as a compile-time flag
// (kBlend), so sym_cov's instantiation is the code it was without it. The
// epilogue that writes an upper element (the main kernel's where S = 1,
// the reduce pass's after adding the S partials in order where S > 1)
// reads F[gi, gj] once and writes beta * F + coeff * sum to both halves, so
// the covariance never reaches device memory. That adds one read of F's
// upper triangle to the bound (8.4 MB at D = 2049: 0.003 ms at 3.35 TB/s).
// F is mirrored element by element, where the TPU mirrors whole tiles; the
// two agree because F is symmetric, which is the function's contract.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <chrono>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

// Tile pair (bi, bj), bi <= bj, of upper-triangle index t, row-major over
// the nblk x nblk grid of tiles; a CTA's t is its blockIdx.x.
__device__ __forceinline__ void pair_of(int t, int nblk, int& bi, int& bj) {
  bi = 0;
  while (t >= nblk - bi) {
    t -= nblk - bi;
    ++bi;
  }
  bj = bi + t;
}

// ------------------------------------------------- sym_cov: 3xTF32 mma.sync

constexpr int kSlab = 32;   // rows of `a` per stage (SLAB_ROWS in sym_cov.py)
constexpr int kStages = 3;  // slabs in flight

// Output tile kTile x kTile, 2 x 2 warps of kWarp x kWarp; a slab row holds
// kTile + 8 floats.
constexpr int kTile = 64;  // TILE in ops/sym_cov.py
constexpr int kWarp = 32;
constexpr int kWarpsN = kTile / kWarp;
constexpr int kTcThreads = 32 * kWarpsN * kWarpsN;
constexpr int kLd = kTile + 8;
constexpr int kStageFloats = 2 * kSlab * kLd;
constexpr int kSmemBytes = kStages * kStageFloats * 4;
constexpr int kMt = kWarp / 16;  // m16 fragments per warp
constexpr int kNt = kWarp / 8;   // n8 fragments per warp
constexpr int kMaxDevices = 64;

// The blend of sym_cov_ema: out = beta * f + coeff * sum (unused by sym_cov).
struct Blend {
  const float* f;
  float beta;
  float coeff;
};

// The value written at upper element (gi, gj) from its sum over the rows:
// sum / scale, or with kBlend the blend, F read once.
template <bool kBlend>
__device__ __forceinline__ float epilogue(float sum, float scale,
                                          const Blend& blend, size_t ij) {
  if (kBlend) return blend.beta * blend.f[ij] + blend.coeff * sum;
  return sum / scale;
}

// An f32 result in the output's type, rounded to nearest.
template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes from global to shared; the `valid` floats after src are copied
// and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(4 * valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo exactly: hi is x with its low 13 mantissa bits cleared (a
// TF32 value), lo = x - hi (an f32 subtraction without rounding). The mma
// reads a TF32 operand from the upper 19 bits of its register, so lo enters
// cut to TF32: x is carried to ~2^-21 of itself. One logic op and one add
// a value; rounding both halves to nearest by integer ops, or by
// cvt.rna.tf32.f32, made the kernel slower on an H100 at no gain that the
// tolerance can see (PERF.md, Findings).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Partial or whole C tile of pair blockIdx.x over the rows of slice
// blockIdx.y: [y * rows_per_split, min(n, (y + 1) * rows_per_split)).
// direct: C = acc / scale (with kBlend, beta * F + coeff * acc), upper
// elements mirrored; else the tile's raw sums go to
// part[(y * pairs + x) * kTile * kTile + m * kTile + n].
//
// Rows of `a` start at any 4-byte boundary when D % 4 != 0, and cp.async
// moves 16 aligned bytes. So the slab row of `row` holds the kTile + 4 floats
// from the 16-byte boundary at or before a[row, i0]: column i0 + c sits at
// slot c + shift(row), shift(row) = (flat index of a[row, 0] + a's offset
// from a 16-byte boundary) % 4 in floats (i0 is a multiple of 4). Slots
// outside the tile's columns, or columns >= D, hold neighbouring elements of
// `a`; they only reach outputs that are not written. Rows >= the slice's
// end are zero-filled, and so are bytes past the end of `a`.
template <bool kBlend>
__global__ void __launch_bounds__(kTcThreads)
sym_cov_tc_kernel(const float* __restrict__ a, float* __restrict__ out, int n,
                  int d, float scale, int nblk, int rows_per_split,
                  int direct, Blend blend) {
  extern __shared__ __align__(16) float smem[];
  int bi, bj;
  pair_of(blockIdx.x, nblk, bi, bj);
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;
  const bool diag = bi == bj;  // one slab serves both operands
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int nslab = (r_end - r_begin + kSlab - 1) / kSlab;
  const int s0 = static_cast<int>(reinterpret_cast<uintptr_t>(a) % 16) / 4;
  const float* a16 = a - s0;  // 16-byte aligned
  const long long total = static_cast<long long>(n) * d;
  auto shift = [&](int row) { return ((row & 3) * (d & 3) + s0) & 3; };
  // floats of a 4-float copy from flat index f that lie inside `a`
  auto inside = [&](long long f) {
    return static_cast<int>(max(0LL, min(4LL, total - f)));
  };

  auto load = [&](int slab, int stage) {
    float* si = smem + stage * kStageFloats;
    float* sj = si + kSlab * kLd;
    const int row0 = r_begin + slab * kSlab;
    constexpr int kPerRow = kTile / 4 + 1;  // 16-byte copies a slab row
#pragma unroll
    for (int e = threadIdx.x; e < kSlab * kPerRow; e += kTcThreads) {
      const int kk = e / kPerRow;
      const int c = 4 * (e % kPerRow);
      const int row = row0 + kk;
      const long long f = static_cast<long long>(row) * d - shift(row) + c;
      const bool in_row = row < r_end;
      const int vi = in_row ? inside(f + i0) : 0;
      cp_async16(si + kk * kLd + c, vi ? a + f + i0 : a16, vi);
      if (!diag) {
        const int vj = in_row ? inside(f + j0) : 0;
        cp_async16(sj + kk * kLd + c, vj ? a + f + j0 : a16, vj);
      }
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / kWarpsN) * kWarp;
  const int wn = (warp % kWarpsN) * kWarp;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  float acc[kMt][kNt][4];
#pragma unroll
  for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNt; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int slab = 0; slab < nslab; ++slab) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab is in; every warp is done with slab - 1's stage
    const int next = slab + kStages - 1;
    if (next < nslab) load(next, next % kStages);
    cp_async_commit();
    const float* si = smem + (slab % kStages) * kStageFloats;
    const float* sj = diag ? si : si + kSlab * kLd;
    const int row0 = r_begin + slab * kSlab;
    // The tensor cores do not round their f32 sums to nearest: a chain of
    // mma accumulations over all N rows drifted past the 1e-5 x max|C|
    // tolerance at N = 8192. So each slab's products start from 0 and join
    // the running sum in f32 adds.
    float slab_sum[kMt][kNt][4];
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNt; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) slab_sum[mi][ni][r] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < kSlab; k8 += 8) {
      // A[m][k] = si[k][m]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4); B[k][n] = sj[k][n]: b0 (t, g), b1 (t + 4, g).
      // Row k of the slab starts at slot shift(row0 + k).
      const int o0 = (k8 + t) * kLd + shift(row0 + k8 + t);
      const int o4 = (k8 + t + 4) * kLd + shift(row0 + k8 + t + 4);
      uint32_t ah[kMt][4], al[kMt][4];
#pragma unroll
      for (int mi = 0; mi < kMt; ++mi) {
        const int m = wm + mi * 16 + g;
        split_tf32(si[o0 + m], ah[mi][0], al[mi][0]);
        split_tf32(si[o0 + m + 8], ah[mi][1], al[mi][1]);
        split_tf32(si[o4 + m], ah[mi][2], al[mi][2]);
        split_tf32(si[o4 + m + 8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNt; ++ni) {
        const int c = wn + ni * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(sj[o0 + c], bh0, bl0);
        split_tf32(sj[o4 + c], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < kMt; ++mi) {
          mma_tf32(slab_sum[mi][ni], al[mi], bh0, bh1);
          mma_tf32(slab_sum[mi][ni], ah[mi], bl0, bl1);
          mma_tf32(slab_sum[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNt; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += slab_sum[mi][ni][r];
  }
  cp_async_wait<0>();

  // c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
  float* part = out + static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) *
                          (kTile * kTile);
#pragma unroll
  for (int mi = 0; mi < kMt; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNt; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = wm + mi * 16 + g + 8 * (r / 2);
        const int c = wn + ni * 8 + 2 * t + r % 2;
        if (!direct) {
          part[m * kTile + c] = acc[mi][ni][r];
          continue;
        }
        // On a diagonal tile only gi <= gj is written, so every pair
        // (i, j), (j, i) comes from one accumulator: exact symmetry.
        const int gi = i0 + m;
        const int gj = j0 + c;
        if (gi < d && gj < d && (!diag || gi <= gj)) {
          const size_t ij = static_cast<size_t>(gi) * d + gj;
          const float v = epilogue<kBlend>(acc[mi][ni][r], scale, blend, ij);
          out[ij] = v;
          out[static_cast<size_t>(gj) * d + gi] = v;
        }
      }
    }
  }
}

// C from the S partial tiles of sym_cov_tc_kernel: for each upper element,
// the sum over slices in slice order, / scale (with kBlend, blended into
// F), written to both halves. Grid: x over pairs, y over kTile * kTile / 256
// elements of a tile.
template <bool kBlend>
__global__ void __launch_bounds__(256)
sym_cov_reduce_kernel(const float* __restrict__ part, float* __restrict__ c,
                      int d, float scale, int nblk, int splits, Blend blend) {
  int bi, bj;
  pair_of(blockIdx.x, nblk, bi, bj);
  const int e = blockIdx.y * 256 + threadIdx.x;
  const int gi = bi * kTile + e / kTile;
  const int gj = bj * kTile + e % kTile;
  if (gi >= d || gj >= d || (bi == bj && gi > gj)) return;
  const size_t stride = static_cast<size_t>(gridDim.x) * (kTile * kTile);
  const float* p =
      part + static_cast<size_t>(blockIdx.x) * (kTile * kTile) + e;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += p[s * stride];
  const size_t ij = static_cast<size_t>(gi) * d + gj;
  const float v = epilogue<kBlend>(sum, scale, blend, ij);
  c[ij] = v;
  c[static_cast<size_t>(gj) * d + gi] = v;
}

// Both passes of sym_cov (kBlend false) or sym_cov_ema (true); see the
// exported functions.
template <bool kBlend>
int launch(const float* a, float* c, float* part, int n, int d, float scale,
           Blend blend, int splits, int rows_per_split, cudaStream_t stream) {
  if (splits < 1 || rows_per_split % kSlab != 0 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // shared memory above 48 KB is allowed once per device
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(sym_cov_tc_kernel<kBlend>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev] = true;
  }
  const int nblk = (d + kTile - 1) / kTile;
  const int pairs = nblk * (nblk + 1) / 2;
  const bool direct = splits == 1;
  sym_cov_tc_kernel<kBlend>
      <<<dim3(pairs, splits), kTcThreads, kSmemBytes, stream>>>(
          a, direct ? c : part, n, d, scale, nblk, rows_per_split, direct,
          blend);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  sym_cov_reduce_kernel<kBlend>
      <<<dim3(pairs, kTile * kTile / 256), 256, 0, stream>>>(
          part, c, d, scale, nblk, splits, blend);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ sym_cov, bf16 and f16: wgmma

constexpr int kTile16 = 128;  // TILE16 in ops/sym_cov.py
constexpr int kSlab16 = 64;   // SLAB16_ROWS: rows of `a` a stage
constexpr int kBoxCols = 64;  // a TMA box: 64 columns (128 bytes) x kSlab16 rows
constexpr int kBoxBytes = kBoxCols * kSlab16 * 2;
constexpr int kK16Bytes = 16 * kBoxCols * 2;  // one wgmma's 16 rows of a box
constexpr int kStageBytes16 = 4 * kBoxBytes;  // two boxes of block bi, two of bj
constexpr int kConsumerThreads = 256;         // two warpgroups, 64 rows of C each
constexpr int kThreads16 = kConsumerThreads + 32;  // and one producer warp

template <typename T, bool kBlend>
using Out16 = std::conditional_t<kBlend, float, T>;

// Shared memory of a form: a ring of 5 stages (on an H100 4 took 6 % longer
// at (8192, 2048), 6 as long there and 10 % longer at 2049: `python -m
// kfac_tpu_torch.half_probe`),
// the epilogue's tile of C's values in the output type (rows of an odd
// count of 32-bit words, so that reading a column hits distinct banks),
// then the barriers.
template <typename Out>
struct Smem16 {
  static constexpr int kLdEpi = sizeof(Out) == 4 ? kTile16 + 1 : kTile16 + 2;
  static constexpr int kEpiBytes = kTile16 * kLdEpi * static_cast<int>(sizeof(Out));
  static constexpr int kStages = 5;
  static constexpr int kBytes = 1024 + kStages * kStageBytes16 + kEpiBytes + 2 * kStages * 8;
  static_assert(kBytes <= 232448, "one CTA an SM");
};

// The work of one 16-bit product (ops/sym_cov.py's plan16): items
// [0, whole) are tile pairs taken over all n rows and written to C; items
// [whole, whole + split * slices) cut each of the last `split` pairs into
// `slices` slices of rows_per_slice rows (slice-major), each summed into
// its own scratch tile, which sym_cov16_reduce_kernel adds in slice order.
// CTA c takes items c, c + gridDim.x, ...
struct Walk {
  int n, d, nblk, whole, split, slices, rows_per_slice;
};

struct Item {
  int pair, r_begin, r_end, slot;  // slot: the scratch tile, -1 for C
};

__device__ __forceinline__ Item item_of(int item, const Walk& w) {
  if (item < w.whole) return {item, 0, w.n, -1};
  const int idx = item - w.whole;
  const int r0 = (idx / w.split) * w.rows_per_slice;
  return {w.whole + idx % w.split, r0, min(w.n, r0 + w.rows_per_slice), idx};
}

// An off-diagonal tile of C's values staged in `epi` to C by 16-byte
// stores, where d is a multiple of the values in 16 bytes: the tile a row
// at a time, then its mirror a row of C at a time. Called by the consumer
// threads together.
template <typename Out>
__device__ __forceinline__ void write_tile_vec(const Out* epi, Out* out, int d,
                                               int i0, int j0) {
  constexpr int kVec = 16 / sizeof(Out);
  constexpr int kPerRow = kTile16 / kVec;
  constexpr int kLd = Smem16<Out>::kLdEpi;
  for (int e = threadIdx.x; e < kTile16 * kPerRow; e += kConsumerThreads) {
    const int m = e / kPerRow;
    const int n = (e % kPerRow) * kVec;
    if (i0 + m >= d || j0 + n >= d) continue;
    __align__(16) Out v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = epi[m * kLd + n + k];
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(i0 + m) * d + j0 + n) =
        *reinterpret_cast<const uint4*>(v);
  }
  for (int e = threadIdx.x; e < kTile16 * kPerRow; e += kConsumerThreads) {
    const int n = e / kPerRow;
    const int m = (e % kPerRow) * kVec;
    if (j0 + n >= d || i0 + m >= d) continue;
    __align__(16) Out v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = epi[(m + k) * kLd + n];
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(j0 + n) * d + i0 + m) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The items of CTA blockIdx.x: a producer warp keeps Smem16::kStages slabs of
// kSlab16 rows in flight by TMA (the two 64-column boxes of block bi and
// the two of bj, 128-byte swizzled; one pair on a diagonal tile), and two
// consumer warpgroups run wgmma m64n128k16 on them: warpgroup g takes
// rows 64g.. of the tile, A = box g of bi (MN-major: C's rows run along
// the box's columns), B = both boxes of bj (MN-major). Without kBlend the
// sum chains in the tensor cores over the item's rows; with kBlend each
// slab's product starts from 0 and joins an f32 accumulator in f32 adds.
// The epilogue stages the tile in shared memory and writes its upper
// elements row by row, then the mirror column by column, both coalesced;
// a slice's raw sums go to part[slot] instead.
template <typename T, bool kBlend>
__global__ void __launch_bounds__(kThreads16, 1)
sym_cov_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                     Out16<T, kBlend>* __restrict__ out,
                     float* __restrict__ part, Walk w, float scale,
                     Blend blend) {
  using hopper::smem_u32;
  using Out = Out16<T, kBlend>;
  using S = Smem16<Out>;
  constexpr int kStages = S::kStages;
  constexpr int kLd = S::kLdEpi;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared address
  unsigned char* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  Out* epi = reinterpret_cast<Out*>(ring + kStages * kStageBytes16);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes16 + S::kEpiBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerThreads / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int items = w.whole + w.split * w.slices;

  if (threadIdx.x >= kConsumerThreads) {  // the producer warp
    if (threadIdx.x == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item c = item_of(it, w);
        int bi, bj;
        pair_of(c.pair, w.nblk, bi, bj);
        const bool diag = bi == bj;
        for (int row = c.r_begin; row < c.r_end; row += kSlab16) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* buf = ring + stage * kStageBytes16;
          hopper::mbar_expect_tx(&full[stage], (diag ? 2 : 4) * kBoxBytes);
          hopper::tma_load_2d(buf, &map, &full[stage], bi * kTile16, row);
          hopper::tma_load_2d(buf + kBoxBytes, &map, &full[stage],
                              bi * kTile16 + kBoxCols, row);
          if (!diag) {
            hopper::tma_load_2d(buf + 2 * kBoxBytes, &map, &full[stage],
                                bj * kTile16, row);
            hopper::tma_load_2d(buf + 3 * kBoxBytes, &map, &full[stage],
                                bj * kTile16 + kBoxCols, row);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  constexpr int kVec = 16 / sizeof(Out);
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // this thread's fragment rows of the tile: m0 (registers 4j, 4j + 1) and
  // m0 + 8 (4j + 2, 4j + 3), at columns 8j + 2t and 8j + 2t + 1
  const int m0 = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int t2 = 2 * (lane % 4);
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  };
  int stage = 0;
  uint32_t phase = 0;
  float acc[64];
  float slab[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) slab[i] = 0.f;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item c = item_of(it, w);
    int bi, bj;
    pair_of(c.pair, w.nblk, bi, bj);
    const bool diag = bi == bj;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;  // a stage whose wgmma group may still be reading it
    for (int row = c.r_begin; row < c.r_end; row += kSlab16) {
      hopper::mbar_wait(&full[stage], phase);
      const uint32_t buf = smem_u32(ring + stage * kStageBytes16);
      const uint32_t a_at = buf + wg * kBoxBytes;
      const uint32_t b_at = diag ? buf : buf + 2 * kBoxBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kSlab16 / 16; ++k) {
        const uint64_t da = hopper::make_desc(a_at + k * kK16Bytes, kBoxBytes,
                                              1024, hopper::kSwizzle128);
        const uint64_t db = hopper::make_desc(b_at + k * kK16Bytes, kBoxBytes,
                                              1024, hopper::kSwizzle128);
        if constexpr (kBlend) {
          hopper::Wgmma<T>::ss_n128_tt(slab, da, db, k);
        } else {
          hopper::Wgmma<T>::ss_n128_tt(acc, da, db, 1);
        }
      }
      hopper::wgmma_commit();
      if constexpr (kBlend) {
        hopper::wgmma_wait<0>();
        hopper::fence_operands(slab);
        release(stage);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += slab[i];
      } else {
        hopper::wgmma_wait<1>();  // the previous slab's products are done
        if (prev >= 0) release(prev);
        prev = stage;
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (!kBlend) {
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      if (prev >= 0) release(prev);
    }

    if (c.slot >= 0) {  // a slice: raw sums of C's elements to its scratch tile
      float* dst = part + static_cast<size_t>(c.slot) * (kTile16 * kTile16);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (bi * kTile16 + m0 + 8 * h < w.d && bj * kTile16 + 8 * j + t2 < w.d)
            *reinterpret_cast<float2*>(dst + (m0 + 8 * h) * kTile16 + 8 * j + t2) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      continue;
    }
    // C's values (the epilogue: / scale, or the blend with F read once) in
    // the output type, staged in shared memory
    const int i0 = bi * kTile16;
    const int j0 = bj * kTile16;
    hopper::bar_sync(1, kConsumerThreads);  // the last tile's readers are done
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int m = m0 + 8 * h;
          const int n = 8 * j + t2 + k;
          const size_t ij = static_cast<size_t>(i0 + m) * w.d + j0 + n;
          const bool inside = i0 + m < w.d && j0 + n < w.d;  // F is read there only
          epi[m * kLd + n] = to_out<Out>(
              epilogue<kBlend>(acc[4 * j + 2 * h + k], scale, blend, inside ? ij : 0));
        }
    hopper::bar_sync(1, kConsumerThreads);
    if (!diag && w.d % kVec == 0) {  // rows of C on 16 bytes: 16-byte stores
      write_tile_vec(epi, out, w.d, i0, j0);
      continue;
    }
    // upper elements, a row of the tile at a time, then the mirror, a
    // column of the tile (a row of C) at a time; on a diagonal tile only
    // gi <= gj, so (i, j) and (j, i) come from one sum: exact symmetry
    for (int e = threadIdx.x; e < kTile16 * kTile16; e += kConsumerThreads) {
      const int m = e / kTile16;
      const int n = e % kTile16;
      const int gi = i0 + m;
      const int gj = j0 + n;
      if (gi < w.d && gj < w.d && (!diag || gi <= gj))
        out[static_cast<size_t>(gi) * w.d + gj] = epi[m * kLd + n];
    }
    for (int e = threadIdx.x; e < kTile16 * kTile16; e += kConsumerThreads) {
      const int n = e / kTile16;
      const int m = e % kTile16;
      const int gi = i0 + m;
      const int gj = j0 + n;
      if (gi < w.d && gj < w.d && (!diag || gi < gj))
        out[static_cast<size_t>(gj) * w.d + gi] = epi[m * kLd + n];
    }
  }
}

// C from the slices of the split pairs: pair whole + blockIdx.x, its
// 32 x 32 block blockIdx.y of the 128 x 128 tile. Each upper element is
// the sum of its slices in slice order, then the epilogue; the upper
// block is written row by row and the mirror column by column.
template <typename Out, bool kBlend>
__global__ void __launch_bounds__(256)
sym_cov16_reduce_kernel(const float* __restrict__ part, Out* __restrict__ out,
                        Walk w, float scale, Blend blend) {
  __shared__ float tile[32][33];
  int bi, bj;
  pair_of(w.whole + blockIdx.x, w.nblk, bi, bj);
  const bool diag = bi == bj;
  const int m0 = (blockIdx.y / 4) * 32;
  const int n0 = (blockIdx.y % 4) * 32;
  if (diag && m0 > n0) return;  // below the diagonal of a diagonal tile
  const size_t slice_stride = static_cast<size_t>(w.split) * kTile16 * kTile16;
  const float* p = part + static_cast<size_t>(blockIdx.x) * kTile16 * kTile16;
  for (int e = threadIdx.x; e < 32 * 32; e += 256) {
    const int r = e / 32;
    const int c = e % 32;
    const int gi = bi * kTile16 + m0 + r;
    const int gj = bj * kTile16 + n0 + c;
    float v = 0.f;
    if (gi < w.d && gj < w.d && (!diag || gi <= gj)) {
      float sum = 0.f;
      for (int s = 0; s < w.slices; ++s)
        sum += p[s * slice_stride + (m0 + r) * kTile16 + n0 + c];
      const size_t ij = static_cast<size_t>(gi) * w.d + gj;
      v = epilogue<kBlend>(sum, scale, blend, ij);
      out[ij] = to_out<Out>(v);
    }
    tile[r][c] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * 32; e += 256) {
    const int c = e / 32;
    const int r = e % 32;
    const int gi = bi * kTile16 + m0 + r;
    const int gj = bj * kTile16 + n0 + c;
    if (gi < w.d && gj < w.d && (!diag || gi < gj))
      out[static_cast<size_t>(gj) * w.d + gi] = to_out<Out>(tile[r][c]);
  }
}

// The TMA map of `a`: (n, d) values of T, rows ld values apart, read in
// boxes of kBoxCols columns x kSlab16 rows, 128-byte swizzled.
template <typename T>
cudaError_t encode_rows(CUtensorMap* map, const void* a, long long ld, int n,
                        int d) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {kBoxCols, kSlab16};
  return hopper::encode_map(map, hopper::TmaType<T>::value, 2, a, dims, strides,
                            box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Both passes of the 16-bit sym_cov (kBlend false) or sym_cov_ema (true).
template <typename T, bool kBlend>
int launch16(const void* a, long long ld, Out16<T, kBlend>* c, float* part,
             int n, int d, int whole, int split, int slices,
             int rows_per_slice, int ctas, float scale, Blend blend,
             cudaStream_t stream) {
  const Walk w{n, d, (d + kTile16 - 1) / kTile16, whole, split, slices,
               rows_per_slice};
  if (ctas < 1 || rows_per_slice % kSlab16 != 0 || split < 0 ||
      (split > 0 && (part == nullptr || slices < 1)) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || (ld * 2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  cudaError_t err = cudaSuccess;
  if (n > 0) {  // with no rows no slab is loaded
    err = encode_rows<T>(&map, a, ld, n, d);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(sym_cov_wgmma_kernel<T, kBlend>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem16<Out16<T, kBlend>>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev] = true;
  }
  sym_cov_wgmma_kernel<T, kBlend>
      <<<ctas, kThreads16, Smem16<Out16<T, kBlend>>::kBytes, stream>>>(
          map, c, part, w, scale, blend);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 0) return static_cast<int>(err);
  sym_cov16_reduce_kernel<Out16<T, kBlend>, kBlend>
      <<<dim3(split, 16), 256, 0, stream>>>(part, c, w, scale, blend);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// c = a^T a / scale on the tensor cores (3xTF32), in 64-wide tiles. Launch
// on `stream`; `splits` row slices of `rows_per_split` rows (a multiple of
// 32) cover N; with splits > 1, `part` is scratch of splits * pairs * 64 *
// 64 floats, pairs = nblk * (nblk + 1) / 2. Returns
// cudaGetLastError() after the launches.
int sym_cov_f32(const float* a, float* c, float* part, int n, int d,
                float scale, int splits, int rows_per_split,
                cudaStream_t stream) {
  return launch<false>(a, c, part, n, d, scale, Blend{nullptr, 0.f, 0.f},
                       splits, rows_per_split, stream);
}

// c = beta * f + coeff * a^T a for a symmetric (D, D) f; c must not alias f.
// The same kernels, splits and scratch as sym_cov_f32. Returns
// cudaGetLastError() after the launches.
int sym_cov_ema_f32(const float* a, const float* f, float* c, float* part,
                    int n, int d, float beta, float coeff, int splits,
                    int rows_per_split, cudaStream_t stream) {
  return launch<true>(a, c, part, n, d, 1.f, Blend{f, beta, coeff}, splits,
                      rows_per_split, stream);
}

// c = a^T a / scale of a bf16 (n, d) `a` whose rows are `ld` values apart
// (ld % 8 == 0, `a` on a 16-byte boundary: TMA's alignment) into a
// contiguous bf16 (d, d) `c`: the f32 sum divided in f32 and rounded once.
// whole, split, slices, rows_per_slice and ctas are ops/sym_cov.py's
// plan16; with split > 0, `part` is f32 scratch of split * slices * 128 *
// 128. Returns cudaGetLastError() after the launches.
int sym_cov_bf16(const void* a, long long ld, void* c, float* part, int n,
                 int d, float scale, int whole, int split, int slices,
                 int rows_per_slice, int ctas, cudaStream_t stream) {
  return launch16<__nv_bfloat16, false>(
      a, ld, static_cast<__nv_bfloat16*>(c), part, n, d, whole, split, slices,
      rows_per_slice, ctas, scale, Blend{nullptr, 0.f, 0.f}, stream);
}

// The same for f16.
int sym_cov_f16(const void* a, long long ld, void* c, float* part, int n,
                int d, float scale, int whole, int split, int slices,
                int rows_per_slice, int ctas, cudaStream_t stream) {
  return launch16<__half, false>(a, ld, static_cast<__half*>(c), part, n, d,
                                 whole, split, slices, rows_per_slice, ctas,
                                 scale, Blend{nullptr, 0.f, 0.f}, stream);
}

// c = beta * f + coeff * a^T a in f32 for a bf16 `a` (as sym_cov_bf16) and
// a symmetric f32 (d, d) f; c must not alias f.
int sym_cov_ema_bf16(const void* a, long long ld, const float* f, float* c,
                     float* part, int n, int d, float beta, float coeff,
                     int whole, int split, int slices, int rows_per_slice,
                     int ctas, cudaStream_t stream) {
  return launch16<__nv_bfloat16, true>(a, ld, c, part, n, d, whole, split,
                                       slices, rows_per_slice, ctas, 1.f,
                                       Blend{f, beta, coeff}, stream);
}

// The same for f16.
int sym_cov_ema_f16(const void* a, long long ld, const float* f, float* c,
                    float* part, int n, int d, float beta, float coeff,
                    int whole, int split, int slices, int rows_per_slice,
                    int ctas, cudaStream_t stream) {
  return launch16<__half, true>(a, ld, c, part, n, d, whole, split, slices,
                                rows_per_slice, ctas, 1.f,
                                Blend{f, beta, coeff}, stream);
}

// The host's cost of one launch's TMA map: the mean ns of `reps`
// encodings of a bf16 (n, d) `a` with rows ld values apart; -1 if one
// fails.
long long sym_cov_tma_encode_ns(const void* a, long long ld, int n, int d,
                                int reps) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    if (encode_rows<__nv_bfloat16>(&map, a, ld, n, d) != cudaSuccess) return -1;
  }
  const auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  return ns / (reps > 0 ? reps : 1);
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
