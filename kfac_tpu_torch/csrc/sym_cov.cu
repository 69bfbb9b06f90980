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
// bf16 and f16 (sym_cov_mma16_kernel<T>): the TPU kernel takes `a` in any
// dtype, accumulates a^T a in f32, divides by `scale` in f32 and rounds
// once to a.dtype (pallas_cov.py:66-105); these forms compute that
// function. The product of two bf16 or f16 values is exact in f32, so the
// tensor cores take the values as they are (mma.sync m16n8k16, f32
// accumulate): one product per element where f32 takes three, and half the
// bytes. Bound at the flagship's (8192, 2049): 3.4e10 FLOP at the 989
// TFLOP/s bf16/f16 peak, 0.035 ms, against 42 MB of input and 8.4 MB of
// output (0.015 ms at 3.35 TB/s): bound by operations. Tiles, slabs,
// stages, split and the two passes are the f32 form's; a slab row holds
// the 16-byte copies from the boundary at or before a[row, i0] (8 values
// of 16 bits each), padded to 88 values so that the fragment reads of a
// warp (rows 2t and 2t + 1, column g) hit distinct banks. Fragments pack
// two 16-bit shared loads into one register (A is a transposed read of
// the slab). Each slab's products start from 0 and join the f32
// accumulator in f32 adds, as in the f32 form. The epilogue divides by
// `scale` in f32 and rounds to T to nearest (__float2bfloat16_rn,
// __float2half_rn), once.
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

#include <cstdint>

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

// The same copy of 16-bit values: `bytes` of the 16 are copied.
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src,
                                                 int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
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
template <bool kBlend, typename T>
__global__ void __launch_bounds__(256)
sym_cov_reduce_kernel(const float* __restrict__ part, T* __restrict__ c,
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
  const T v = to_out<T>(epilogue<kBlend>(sum, scale, blend, ij));
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
  sym_cov_reduce_kernel<kBlend, float>
      <<<dim3(pairs, kTile * kTile / 256), 256, 0, stream>>>(
          part, c, d, scale, nblk, splits, blend);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------- sym_cov, bf16 and f16: mma.sync

constexpr int kVec16 = 8;                // 16-bit values a 16-byte copy
constexpr int kLd16 = kTile + 24;        // slab row: 72 copied values + pad
constexpr int kStage16 = 2 * kSlab * kLd16;
constexpr int kSmemBytes16 = kStages * kStage16 * 2;

template <typename T>
struct Mma16;
template <>
struct Mma16<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <>
struct Mma16<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Two 16-bit values as one mma register, the first in the low half.
__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// sym_cov_tc_kernel's tile of a bf16 or f16 `a` (T): the same grid, slabs,
// ring and outputs (direct: C = acc / scale rounded to T; else raw f32
// sums to `part`). A slab row of `row` holds the kTile + 8 values from the
// 16-byte boundary at or before a[row, i0]: column i0 + c sits at slot
// c + shift(row), shift(row) = (flat index of a[row, 0] + a's offset from a
// 16-byte boundary, in values) % 8.
template <typename T>
__global__ void __launch_bounds__(kTcThreads)
sym_cov_mma16_kernel(const T* __restrict__ a, T* __restrict__ out,
                     float* __restrict__ part_out, int n, int d, float scale,
                     int nblk, int rows_per_split, int direct) {
  extern __shared__ __align__(16) uint16_t smem16[];
  int bi, bj;
  pair_of(blockIdx.x, nblk, bi, bj);
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;
  const bool diag = bi == bj;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int nslab = (r_end - r_begin + kSlab - 1) / kSlab;
  const int s0 = static_cast<int>(reinterpret_cast<uintptr_t>(a) % 16) / 2;
  const T* a16 = a - s0;  // 16-byte aligned
  const long long total = static_cast<long long>(n) * d;
  auto shift = [&](int row) { return ((row & 7) * (d & 7) + s0) & 7; };
  auto inside = [&](long long f) {
    return static_cast<int>(max(0LL, min(8LL, total - f)));
  };

  auto load = [&](int slab, int stage) {
    uint16_t* si = smem16 + stage * kStage16;
    uint16_t* sj = si + kSlab * kLd16;
    const int row0 = r_begin + slab * kSlab;
    constexpr int kPerRow = kTile / kVec16 + 1;
#pragma unroll
    for (int e = threadIdx.x; e < kSlab * kPerRow; e += kTcThreads) {
      const int kk = e / kPerRow;
      const int c = kVec16 * (e % kPerRow);
      const int row = row0 + kk;
      const long long f = static_cast<long long>(row) * d - shift(row) + c;
      const bool in_row = row < r_end;
      const int vi = in_row ? inside(f + i0) : 0;
      cp_async16_bytes(si + kk * kLd16 + c, vi ? a + f + i0 : a16, 2 * vi);
      if (!diag) {
        const int vj = in_row ? inside(f + j0) : 0;
        cp_async16_bytes(sj + kk * kLd16 + c, vj ? a + f + j0 : a16, 2 * vj);
      }
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / kWarpsN) * kWarp;
  const int wn = (warp % kWarpsN) * kWarp;
  const int g = lane >> 2;
  const int t = lane & 3;
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
    __syncthreads();
    const int next = slab + kStages - 1;
    if (next < nslab) load(next, next % kStages);
    cp_async_commit();
    const uint16_t* si = smem16 + (slab % kStages) * kStage16;
    const uint16_t* sj = diag ? si : si + kSlab * kLd16;
    const int row0 = r_begin + slab * kSlab;
    float slab_sum[kMt][kNt][4];
#pragma unroll
    for (int mi = 0; mi < kMt; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNt; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) slab_sum[mi][ni][r] = 0.f;
#pragma unroll
    for (int k16 = 0; k16 < kSlab; k16 += 16) {
      // A[m][k] = si[k][m], B[k][n] = sj[k][n]; a lane reads k = 2t, 2t + 1
      // (o[0], o[1]) and 2t + 8, 2t + 9 (o[2], o[3]) of the step.
      int o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k16 + 2 * t + (q & 1) + 8 * (q >> 1);
        o[q] = k * kLd16 + shift(row0 + k);
      }
      uint32_t af[kMt][4];
#pragma unroll
      for (int mi = 0; mi < kMt; ++mi) {
        const int m = wm + mi * 16 + g;
        af[mi][0] = pack16(si[o[0] + m], si[o[1] + m]);
        af[mi][1] = pack16(si[o[0] + m + 8], si[o[1] + m + 8]);
        af[mi][2] = pack16(si[o[2] + m], si[o[3] + m]);
        af[mi][3] = pack16(si[o[2] + m + 8], si[o[3] + m + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < kNt; ++ni) {
        const int c = wn + ni * 8 + g;
        const uint32_t b0 = pack16(sj[o[0] + c], sj[o[1] + c]);
        const uint32_t b1 = pack16(sj[o[2] + c], sj[o[3] + c]);
#pragma unroll
        for (int mi = 0; mi < kMt; ++mi)
          Mma16<T>::run(slab_sum[mi][ni], af[mi], b0, b1);
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

  float* part = part_out + static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) *
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
        const int gi = i0 + m;
        const int gj = j0 + c;
        if (gi < d && gj < d && (!diag || gi <= gj)) {
          const T v = to_out<T>(acc[mi][ni][r] / scale);
          out[static_cast<size_t>(gi) * d + gj] = v;
          out[static_cast<size_t>(gj) * d + gi] = v;
        }
      }
    }
  }
}

// Both passes of the 16-bit sym_cov; `part` holds the f32 partials.
template <typename T>
int launch16(const T* a, T* c, float* part, int n, int d, float scale,
             int splits, int rows_per_split, cudaStream_t stream) {
  if (splits < 1 || rows_per_split % kSlab != 0 ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nblk = (d + kTile - 1) / kTile;
  const int pairs = nblk * (nblk + 1) / 2;
  const bool direct = splits == 1;
  sym_cov_mma16_kernel<T>
      <<<dim3(pairs, splits), kTcThreads, kSmemBytes16, stream>>>(
          a, c, part, n, d, scale, nblk, rows_per_split, direct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  sym_cov_reduce_kernel<false, T>
      <<<dim3(pairs, kTile * kTile / 256), 256, 0, stream>>>(
          part, c, d, scale, nblk, splits, Blend{nullptr, 0.f, 0.f});
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

// c = a^T a / scale of a bf16 (N, D) `a` into bf16 `c`: the f32 sum
// divided in f32 and rounded once. Splits and scratch (f32) as
// sym_cov_f32. Returns cudaGetLastError() after the launches.
int sym_cov_bf16(const __nv_bfloat16* a, __nv_bfloat16* c, float* part, int n,
                 int d, float scale, int splits, int rows_per_split,
                 cudaStream_t stream) {
  return launch16(a, c, part, n, d, scale, splits, rows_per_split, stream);
}

// The same for f16.
int sym_cov_f16(const __half* a, __half* c, float* part, int n, int d,
                float scale, int splits, int rows_per_split,
                cudaStream_t stream) {
  return launch16(a, c, part, n, d, scale, splits, rows_per_split, stream);
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
