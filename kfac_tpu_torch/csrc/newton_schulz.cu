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
// it splits its staged B slab, and the M x_new kernel sums
// (delta_rc - C_rc)^2 over its finished tile in the epilogue.
//
// Bound on an H100: 4 d^3 f32 FLOPs (two d^3 products) against 5 d^2 * 4
// bytes (m, x, mx read, x_new, mx_new written). At d = 2048 that is 3.4e10
// FLOP (0.51 ms at the 67 TFLOP/s f32 peak) against 84 MB (0.025 ms at
// 3.35 TB/s): bound by operations at every flagship size.
//
// Design: both products are one kernel on the tensor cores, at f32
// accuracy by 3xTF32: each operand value x becomes hi = x with its low 13
// mantissa bits cleared (a TF32 value) and lo = x - hi (exact), and
// lo*hi + hi*lo + hi*hi is summed (the dropped lo*lo is ~2^-20 of a
// product): 3 TF32 products per f32 product, a bound of 12 d^3 / 495
// TFLOP/s (0.208 ms at d = 2048), under the f32 one.
// - One CTA per output tile on a 2-D grid, the tile from
//   ops/newton_schulz.py's plan(): 128 x 128 or 128 x 144 (two warpgroups
//   of 64 rows) where such a grid gives every SM a CTA, whichever takes
//   fewer waves of tile area (d = 2048: 256 CTAs of 128 x 128; d = 2049:
//   255 of 128 x 144 where 128 x 128 needs 289, a third wave), else
//   64 x 32 (one warpgroup; 128 CTAs at d = 512). The TPU's sequential k
//   grid axis becomes a loop over d inside the CTA.
// - Raw f32 slabs of 32 k (A: the tile's rows x 32 columns; B: 32 rows x
//   the tile's columns) move in a 3-stage ring of 16-byte cp.async copies.
//   TMA would need a 16-byte row stride, which d = 513 and 2049 lack. A row
//   that starts off a 16-byte boundary (d % 4 != 0) is copied from the
//   boundary before it and read at its shift; rows past d and bytes past
//   the end are zero-filled by the copies' source size.
// - Each staged element is split once. B (2I - mx, or x_new) goes through
//   shared memory: wgmma takes a 32-bit B operand only K-major, and B is
//   row-major (N-major), so one pass of all threads transposes each slab
//   into hi and lo planes of 8-row x 16-byte core matrices (no swizzle),
//   writing 2[r == c] - v for the x-update and 0 at every k or column
//   outside d. A (x, or m) is row-major, already K-major: each thread
//   splits its own fragments into registers, and wgmma reads A from there
//   (a variant that split A into shared-memory planes too was slower at
//   d = 2048 on an H100, and so was one with a producer warpgroup that
//   staged and split for two consumer warpgroups).
// - Each warpgroup issues wgmma.mma_async m64nNk8 .tf32 (N = 144, 128 or
//   32), three per k8 step. The planes are double-buffered: the next slab
//   is staged and split while this slab's products run.
// - The tensor cores' f32 sums drift over a long chain (sym_cov.cu): one
//   chain over d = 2049 came close to the 3e-5 tolerance on an H100. So
//   each slab's products start from 0 and join the accumulator in f32 adds.
// - The residual: CTAs run in no order, so each writes its partial sum (a
//   fixed-order tree over its threads) to partials[cta], and a single-CTA
//   pass sums the partials in a fixed order and writes sqrt(sum) / sqrt(d).
//   No float atomics: every output repeats bit for bit from run to run.
// - A stack of L matrices (the distributed engine's slot stores) is one
//   launch of each kernel: the slot is blockIdx.z, and each slot's
//   partials and residual are its own. An optional active[L] mask on the
//   device lets a frozen slot's CTAs return at once (a slot whose own
//   stopping rule has fired, while the others iterate on); their outputs
//   are then left unwritten. The stacked instantiation (kStacked) differs
//   from the 2-D one only in the slot's index offset, so a slot of a
//   stack is bit for bit the 2-D result at the same tile. The 2-D launch
//   keeps its own instantiation, the code of the 2-D kernel before the
//   slot axis (if constexpr): on an H100 its time at d = 2048 and 2049
//   moved with any change to its indexing (same outputs), and this form
//   is level with it (python -m kfac_tpu_torch.ns_ab).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 32;             // k depth of a staged slab
constexpr int kChunks = kBK / 4;    // 16-byte K chunks (core matrices) a row
constexpr int kStages = 3;          // raw slabs in flight
constexpr int kFinalThreads = 256;  // ns_resid_final_kernel
constexpr int kMaxDevices = 64;
// wgmma descriptor strides of the planes: K-adjacent core matrices 128
// bytes apart, 8-row groups kChunks * 128 bytes apart
constexpr int kLBO = 128;
constexpr int kSBO = kChunks * 128;

// Shared memory of a (64 kWG) x kBN output tile, in floats.
template <int kWG, int kBN>
struct Tile {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kLdA = kBK + 4;  // a raw A row: 32 floats and a shift
  static constexpr int kLdB = kBN + 4;
  static constexpr int kRawA = kBM * kLdA;
  static constexpr int kStage = kRawA + kBK * kLdB;
  static constexpr int kPlaneB = kBN * kBK;
  // two buffers of B's hi and lo planes, then the raw ring
  static constexpr int kSmemBytes = 4 * (4 * kPlaneB + kStages * kStage);
};

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

// hi = x with its low 13 mantissa bits cleared, lo = x - hi; the tensor
// cores read lo's top 19 bits (as in sym_cov.cu).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  lo = x - hi;
}

// Plane offset, in floats, of (r, k): r a row of A or a column of B, k in
// the slab; the 8 x 4 core matrix (r / 8, k / 4) is 128 contiguous bytes.
__device__ __forceinline__ int plane_at(int r, int k) {
  return ((r >> 3) * kChunks + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// wgmma matrix descriptor of a no-swizzle K-major plane starting at p.
__device__ __forceinline__ uint64_t plane_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int S>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[s][q])::"memory");
}

// D (+)= A B for a 64 x N tile and k = 8 (N = 128 or 32, by the size of d:
// N / 2 floats a thread), A and B K-major TF32 planes in shared memory
// (descriptors da, db); D is overwritten where scale_d == 0.
__device__ __forceinline__ void wgmma(float (&d)[72], const uint32_t (&a)[4],
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// C = A op(B) for row-major (d, d) A, B, C, where op(B) = 2I - B when
// kTwoIMinusB, else B, over a (64 kWG) x kBN tile of C per CTA; with
// kStacked, for slot blockIdx.z of (L, d, d) stacks (skipped where
// active[z] == 0). With kResid, also writes the CTA's sum of
// (delta_rc - C_rc)^2 over its in-range elements to partials[z][cta].
template <int kWG, int kBN, bool kTwoIMinusB, bool kResid, bool kStacked>
__global__ void __launch_bounds__(128 * kWG)
ns_wgmma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, float* __restrict__ partials,
                const unsigned char* __restrict__ active, int d) {
  using T = Tile<kWG, kBN>;
  extern __shared__ __align__(128) float smem[];
  // the slot's first element in the stacks: an index offset (moving a, b
  // and c by the slot took more registers and was slower at d = 2049 on
  // an H100)
  int slot = 0;
  long long base = 0;
  if constexpr (kStacked) {
    slot = blockIdx.z;
    if (active != nullptr && active[slot] == 0) return;  // uniform per CTA
    base = static_cast<long long>(slot) * d * d;
  }
  float* planes = smem;  // buffer u: hi at 2u * kPlaneB, lo after it
  float* ring = smem + 4 * T::kPlaneB;

  const int i0 = blockIdx.y * T::kBM;
  const int j0 = blockIdx.x * kBN;
  const int nslab = (d + kBK - 1) / kBK;
  int sa = static_cast<int>(reinterpret_cast<uintptr_t>(a) % 16) / 4;
  int sb = static_cast<int>(reinterpret_cast<uintptr_t>(b) % 16) / 4;
  if constexpr (kStacked) {
    sa = static_cast<int>((reinterpret_cast<uintptr_t>(a) / 4 + base) & 3);
    sb = static_cast<int>((reinterpret_cast<uintptr_t>(b) / 4 + base) & 3);
  }
  const long long total = static_cast<long long>(d) * d;
  // floats from the 16-byte boundary at or before row `row`'s start
  auto shift_a = [&](int row) { return ((row & 3) * (d & 3) + sa) & 3; };
  auto shift_b = [&](int row) { return ((row & 3) * (d & 3) + sb) & 3; };
  // floats of a 4-float copy from flat index f that lie inside the matrix
  auto inside = [&](long long f) {
    return static_cast<int>(max(0LL, min(4LL, total - f)));
  };

  // slab `slab` of A (rows i0.., k0..) and of B (rows k0.., columns j0..)
  auto load = [&](int slab) {
    float* ra = ring + (slab % kStages) * T::kStage;
    float* rb = ra + T::kRawA;
    const int k0 = slab * kBK;
    constexpr int kPerRowA = kBK / 4 + 1;
    for (int e = threadIdx.x; e < T::kBM * kPerRowA; e += T::kThreads) {
      const int r = e / kPerRowA;
      const int c4 = 4 * (e % kPerRowA);
      const int row = i0 + r;
      const long long f =
          static_cast<long long>(row) * d - shift_a(row) + k0 + c4;
      const int v = row < d ? inside(f) : 0;
      if constexpr (kStacked) {
        cp_async16(ra + r * T::kLdA + c4, v ? a + base + f : a + base - sa, v);
      } else {
        cp_async16(ra + r * T::kLdA + c4, v ? a + f : a - sa, v);
      }
    }
    constexpr int kPerRowB = kBN / 4 + 1;
    for (int e = threadIdx.x; e < kBK * kPerRowB; e += T::kThreads) {
      const int kk = e / kPerRowB;
      const int c4 = 4 * (e % kPerRowB);
      const int row = k0 + kk;
      const long long f =
          static_cast<long long>(row) * d - shift_b(row) + j0 + c4;
      const int v = row < d ? inside(f) : 0;
      if constexpr (kStacked) {
        cp_async16(rb + kk * T::kLdB + c4, v ? b + base + f : b + base - sb, v);
      } else {
        cp_async16(rb + kk * T::kLdB + c4, v ? b + f : b - sb, v);
      }
    }
  };

  // the staged B slab into the hi and lo planes of buffer slab % 2, 4 k of
  // one column a step, written as one 16-byte store to each plane; the
  // x-update's 2[r == c] - v here, and 0 outside d
  auto split_b = [&](int slab) {
    const float* rb = ring + (slab % kStages) * T::kStage + T::kRawA;
    float* hi = planes + (slab % 2) * 2 * T::kPlaneB;
    float* lo = hi + T::kPlaneB;
    const int k0 = slab * kBK;
#pragma unroll
    for (int e = threadIdx.x; e < kBN * kChunks; e += T::kThreads) {
      // column fastest, so a warp reads consecutive floats of a row
      const int n = e % kBN;
      const int kc = e / kBN;
      const int gc = j0 + n;
      float h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = 4 * kc + q;
        const int gk = k0 + kk;
        float v = 0.f;
        if (gk < d && gc < d) {
          v = rb[kk * T::kLdB + shift_b(gk) + n];
          if (kTwoIMinusB) v = (gk == gc ? 2.f : 0.f) - v;
        }
        split_tf32(v, h[q], l[q]);
      }
      const int o = plane_at(n, 4 * kc);
      *reinterpret_cast<float4*>(hi + o) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(lo + o) = make_float4(l[0], l[1], l[2], l[3]);
    }
  };

  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;  // of the warpgroup
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  // A fragment of k8 step s: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
  // a3 (g + 8, t + 4) of the warp's 16 rows, split into hi and lo
  const int r0 = wg * 64 + warp * 16 + g;
  uint32_t a_hi[kChunks / 2][4], a_lo[kChunks / 2][4];
  auto load_a = [&](int slab) {
    const float* ra = ring + (slab % kStages) * T::kStage;
    const int k0 = slab * kBK;
    const float* row0 = ra + r0 * T::kLdA + shift_a(i0 + r0);
    const float* row8 = ra + (r0 + 8) * T::kLdA + shift_a(i0 + r0 + 8);
#pragma unroll
    for (int s = 0; s < kChunks / 2; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 8 * s + t + 4 * (q / 2);
        const float* row = q % 2 ? row8 : row0;
        const float v = k0 + k < d ? row[k] : 0.f;
        float h, l;
        split_tf32(v, h, l);
        a_hi[s][q] = __float_as_uint(h);
        a_lo[s][q] = __float_as_uint(l);
      }
    }
  };

  float acc[kBN / 2];
  float part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nslab) load(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();  // slab 0 is in
  split_b(0);
  // the planes are written by plain stores; wgmma reads them through the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int slab = 0; slab < nslab; ++slab) {
    // this slab's products, issued without waiting...
    load_a(slab);
    const uint64_t d_hi = plane_desc(planes + (slab % 2) * 2 * T::kPlaneB);
    const uint64_t d_lo = plane_desc(planes + (slab % 2) * 2 * T::kPlaneB + T::kPlaneB);
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kChunks / 2; ++s) {
      // a k8 step is 2 core matrices, 256 bytes: 16 in the address field
      wgmma(part, a_hi[s], d_lo + 16 * s, s);
      wgmma(part, a_lo[s], d_hi + 16 * s, 1);
      wgmma(part, a_hi[s], d_hi + 16 * s, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // ...while the next slab is staged and split into the other planes,
    // whose last reader, slab - 1's wgmma, every warpgroup has waited for
    if (slab + 1 < nslab) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slab + 1 is in; slab's raw stage is read
      if (slab + kStages < nslab) load(slab + kStages);
      cp_async_commit();
      split_b(slab + 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(part);
    fence_operands(a_hi);
    fence_operands(a_lo);
    // the tensor cores' f32 sums drift over a long chain (sym_cov.cu): each
    // slab's products start from 0 and join the accumulator in f32 adds
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
    __syncthreads();  // the next planes are written
  }
  cp_async_wait<0>();

  // accumulator of warp w of the warpgroup, lane (g, t): element 4j + r at
  // row 16w + g + 8(r / 2), column 8j + 2t + r % 2 of the 64 x kBN tile
  float local = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int gi = i0 + wg * 64 + warp * 16 + g + 8 * ((i % 4) / 2);
    const int gj = j0 + (i / 4) * 8 + 2 * t + i % 2;
    if (gi < d && gj < d) {
      if constexpr (kStacked) {
        c[base + static_cast<long long>(gi) * d + gj] = acc[i];
      } else {
        c[static_cast<size_t>(gi) * d + gj] = acc[i];
      }
      if (kResid) {
        const float delta = (gi == gj ? 1.f : 0.f) - acc[i];
        local = fmaf(delta, delta, local);
      }
    }
  }
  if (kResid) {
    // fixed-order tree: within each warp, then over the warps in order, in
    // the planes' memory once every warpgroup is done with them
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) local += __shfl_down_sync(0xffffffffu, local, o);
    __syncthreads();
    if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = local;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < T::kThreads / 32; ++w) s += smem[w];
      if constexpr (kStacked) {
        partials[(static_cast<size_t>(slot) * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x] = s;
      } else {
        partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
      }
    }
  }
}

// resid[z] = sqrt(sum of slot z's n partials) / sqrt(d), summed in a fixed
// order by one CTA a slot (blockIdx.x).
__global__ void __launch_bounds__(kFinalThreads)
ns_resid_final_kernel(const float* __restrict__ partials, int n,
                      float* __restrict__ resid,
                      const unsigned char* __restrict__ active, int d) {
  __shared__ float red[kFinalThreads];
  const int slot = blockIdx.x;
  if (active != nullptr && active[slot] == 0) return;
  partials += static_cast<size_t>(slot) * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kFinalThreads) s += partials[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kFinalThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) resid[slot] = sqrtf(red[0]) / sqrtf(static_cast<float>(d));
}

template <int kWG, int kBN, bool kStacked>
int launch(const float* m, const float* x, const float* mx, float* x_new,
           float* mx_new, float* partials, float* resid,
           const unsigned char* active, int slots, int d, cudaStream_t stream) {
  using T = Tile<kWG, kBN>;
  auto* xupdate = ns_wgmma_kernel<kWG, kBN, true, false, kStacked>;
  auto* product = ns_wgmma_kernel<kWG, kBN, false, true, kStacked>;
  // shared memory above 48 KB is allowed once per device and instantiation
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(xupdate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(product, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev] = true;
  }
  const dim3 grid((d + kBN - 1) / kBN, (d + T::kBM - 1) / T::kBM, slots);
  xupdate<<<grid, T::kThreads, T::kSmemBytes, stream>>>(x, mx, x_new, nullptr, active, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  product<<<grid, T::kThreads, T::kSmemBytes, stream>>>(m, x_new, mx_new, partials, active, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_resid_final_kernel<<<slots, kFinalThreads, 0, stream>>>(
      partials, grid.x * grid.y, resid, active, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One iteration on `stream` for each of `slots` (L) stacked matrices:
// x_new, mx_new (L, d, d), resid (L floats), with `partials` scratch of
// L * ceil(d / tile_m) * ceil(d / tile_n) floats. Slot z is skipped, its
// outputs unwritten, where `active` (L bytes on the device, or null for
// every slot) holds 0. The output tile (tile_m, tile_n) is (128, 128),
// (128, 144) or (64, 32). Returns the first nonzero cudaGetLastError() of
// the three launches, else 0.
int ns_step_stacked_f32(const float* m, const float* x, const float* mx,
                        float* x_new, float* mx_new, float* partials,
                        float* resid, const unsigned char* active, int slots,
                        int d, int tile_m, int tile_n, cudaStream_t stream) {
  if (d <= 0 || slots <= 0 || slots > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // a stack of one with every slot active is the 2-D launch
  const bool stacked = slots > 1 || active != nullptr;
#define NS_LAUNCH(WG, BN)                                                              \
  return stacked ? launch<WG, BN, true>(m, x, mx, x_new, mx_new, partials, resid, active, \
                                        slots, d, stream)                                \
                 : launch<WG, BN, false>(m, x, mx, x_new, mx_new, partials, resid,        \
                                         nullptr, 1, d, stream)
  if (tile_m == 128 && tile_n == 144) NS_LAUNCH(2, 144);
  if (tile_m == 128 && tile_n == 128) NS_LAUNCH(2, 128);
  if (tile_m == 64 && tile_n == 32) NS_LAUNCH(1, 32);
#undef NS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
