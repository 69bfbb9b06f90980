// Causal blockwise-softmax attention partials (acc, m, l) for one
// (Q-chunk, K-chunk) pair, f32, in the (B, S, H, D) layout.
//
// Replaces the TPU kernel _flash_kernel (kfac_tpu/ops/pallas_attention.py:42,
// called at :257 by flash_attention_partials). It computes, per query row,
//   m = max_k logit, l = sum_k exp(logit - m), acc = sum_k exp(logit - m) v_k
// with logit = (q * D^-0.5) . k masked to -1e30 where the global query
// position is before the global key position. Fully masked rows keep
// m = -1e30, l = 0, acc = 0: the guards of the TPU kernel (p and alpha are
// zeroed where their operand is <= -1e30 / 2) are reproduced exactly.
//
// Bound on an H100: the causal work is 4 * D f32 FLOPs for each of the
// B*H*S*(S+1)/2 visible (query, key) pairs. Both products run on the tensor
// cores at f32 accuracy by 3xTF32 splitting (as in sym_cov.cu): 3 TF32
// products per f32 product. At the flagship's q, k, v (16, 512, 4, 128)
// that is 4.3e9 f32 FLOP (0.064 ms at the 67 TFLOP/s f32 peak; 3x at 495
// TFLOP/s TF32: 0.026 ms) against 67 MB of inputs and outputs (0.020 ms at
// 3.35 TB/s): bound by operations. At the `large` LM's (8, 1024, 4, 256):
// 1.7e10 FLOP, 0.257 ms f32 and 0.104 ms 3xTF32. At the tiny LM's
// (4, 128, 4, 32): 1.7e7 FLOP against 1.1 MB, 0.0003 ms either way, so
// launch cost sets its time.
//
// Design:
// - One CTA per (batch * head, kBQ-row Q tile), kBQ = 16 rows a warp. The
//   grid's y index walks the Q tiles from the last (the longest causal rows)
//   to the first, so the longest CTAs start in the first wave. A CTA loops
//   over kBK-row K/V tiles only up to the causal bound q_offset + its last
//   row - k_offset: tiles above the diagonal are never loaded (the TPU
//   kernel's block sparsity), and only tiles that cross the diagonal or the
//   end of the K chunk are masked.
// - Q (pre-scaling happens at the fragment read: the same f32 product as
//   q * scale), and K/V tiles in a double-buffered ring, are staged in
//   shared memory by 16-byte cp.async copies, so tile kt + 1 loads while
//   tile kt is multiplied. Rows past the chunk are zero-filled.
// - S = Q K^T and O += P V run as mma.sync.m16n8k8 TF32 with each operand
//   split into hi + lo (3 products, lo*lo dropped). Scores stay in registers
//   as mma accumulators: a warp owns 16 query rows; row max and row sum
//   reduce over the 4 lanes that share a row. The online update (alpha, m,
//   l) is the TPU kernel's. Each K tile's P V starts from zeroed registers
//   and joins O as O * alpha + pv in f32 adds (the tensor cores' own f32
//   sums drift over long chains; see sym_cov.cu).
// - The k index of both products is permuted so that no value moves
//   between lanes: logical k = t and t + 4 of an m16n8k8 step stand for
//   elements 2t and 2t + 1 of its 8. For Q K^T that makes a lane's Q and K
//   fragment elements adjacent (one 8-byte shared load each); for P V it
//   makes the S accumulator layout the A fragment layout, with V read at
//   rows 2t and 2t + 1.
// - Shared rows are padded so that fragment reads hit 32 banks: Q and K
//   rows hold D + 8 floats (8-byte reads of rows g, columns 2t), V rows D +
//   4 (4-byte reads of rows 2t, columns g).
// - Tile sizes per head dim (Tiles<D>) were chosen from timings on an H100
//   (`python -m kfac_tpu_torch.flash_tiles`; PERF.md, Findings): 4 warps
//   and 64-row K/V tiles at D = 32, 4 warps and 32-row tiles at D = 128
//   (103 KB, two CTAs an SM), 8 warps and 16-row tiles at D = 256 (202
//   KB, one CTA an SM; with 128 output floats a thread, ptxas gives it
//   254 registers and spills 8 bytes).
// The offsets are kernel arguments, so ring steps can reuse the kernel. m
// and l are written as (B, H, S_q): the TPU's 128-lane broadcast of them
// was a Mosaic layout constraint.
//
// bf16 and f16 inputs (flash_mma16_kernel<T>): the TPU kernel upcasts q and
// k, takes f32 logits and softmax, and rounds p to v's dtype before P V,
// which accumulates in f32 (pallas_attention.py:56-99); acc, m and l stay
// f32. These forms compute that function with logit = (q . k) * D^-0.5:
// q . k of the 16-bit values on the tensor cores (each product exact in
// f32, f32 accumulate), then one f32 multiply (__fmul_rn, so it is never
// contracted into the subtraction that follows). The TPU kernel's
// (q * scale) . k differs from it by f32 rounding only; neither rounds
// q * scale to 16 bits, as the einsum form off the TPU does. p = expf(logit
// - m) is summed into l unrounded and rounded to T to nearest for P V, both
// products mma.sync m16n8k16 (f32 accumulate). Tiles per head dim, the
// causal bound, the ring of K/V tiles, the masking, the online update and
// the per-tile P V joining O in f32 adds are the f32 form's; shared rows of
// Q, K and V hold D + 8 values of 16 bits. Bound at the flagship's (16,
// 512, 4, 128): 4.3e9 FLOP at the 989 TFLOP/s bf16/f16 peak, 0.0044 ms,
// against 12.6 MB of 16-bit inputs and 33.6 MB of f32 output (0.014 ms
// at 3.35 TB/s): bound by bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// Warps a CTA (16 query rows each) and K/V tile rows, per head dim.
template <int D>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int kWarps = 4;
  static constexpr int kBK = 64;
};
template <>
struct Tiles<128> {
  static constexpr int kWarps = 4;
  static constexpr int kBK = 32;
};
template <>
struct Tiles<256> {
  static constexpr int kWarps = 8;
  static constexpr int kBK = 16;
};

template <int D, int kWarps, int kBK>
struct Flash {
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLdK = D + 8;  // Q and K rows
  static constexpr int kLdV = D + 4;  // V rows
  static constexpr int kQFloats = kBQ * kLdK;
  static constexpr int kStageFloats = kBK * (kLdK + kLdV);
  static constexpr int kSmemBytes = (kQFloats + 2 * kStageFloats) * 4;
  static constexpr int kNf = kBK / 8;  // n8 fragments of S (k8 steps of P V)
  static constexpr int kDf = D / 8;    // k8 steps of Q K^T (n8 fragments of O)
  static_assert(D % 8 == 0 && kBK % 8 == 0, "tiles are whole mma steps");
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

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi, which the mma reads cut to TF32 (sym_cov.cu).
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

// c += a b at f32 accuracy: lo*hi + hi*lo + hi*hi, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Rows [row0, row0 + R) of one head of a (B, S, H, D) tensor into shared
// rows of LD floats; `src` is that head's row 0, rows >= s are zero-filled.
template <int R, int D, int LD, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t row_stride, int row0,
                                          int s) {
  constexpr int kPerRow = D / 4;  // 16-byte copies a row
#pragma unroll
  for (int e = threadIdx.x; e < R * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = 4 * (e % kPerRow);
    const int row = row0 + r;
    const bool in = row < s;
    cp_async16(dst + r * LD + c, in ? src + row * row_stride + c : src,
               in ? 4 : 0);
  }
}

template <int D, int kWarps, int kBK>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int h,
                 int s_q, int s_k, int q_off, int k_off, int causal,
                 float scale) {
  using F = Flash<D, kWarps, kBK>;
  constexpr int kLdK = F::kLdK;
  constexpr int kLdV = F::kLdV;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // kBQ x kLdK, unscaled q

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::kBQ;  // last tile first
  const size_t row_stride = static_cast<size_t>(h) * D;
  const float* qb = q + (static_cast<size_t>(b) * s_q * h + hh) * D;
  const float* kb = k + (static_cast<size_t>(b) * s_k * h + hh) * D;
  const float* vb = v + (static_cast<size_t>(b) * s_k * h + hh) * D;

  const int n_k = (s_k + kBK - 1) / kBK;
  int hi = n_k;
  if (causal) {
    // one past this tile's last query position, in key-chunk coordinates
    const int q_end = min(q0 + F::kBQ, s_q);
    const int num = q_off + q_end - k_off;
    hi = num <= 0 ? 0 : min((num + kBK - 1) / kBK, n_k);
  }

  auto stage_k = [&](int kt) {
    return smem + F::kQFloats + (kt & 1) * F::kStageFloats;
  };
  auto load_kv = [&](int kt) {
    float* ks = stage_k(kt);
    load_rows<kBK, D, kLdK, F::kThreads>(ks, kb, row_stride, kt * kBK, s_k);
    load_rows<kBK, D, kLdV, F::kThreads>(ks + kBK * kLdK, vb, row_stride,
                                         kt * kBK, s_k);
  };

  load_rows<F::kBQ, D, kLdK, F::kThreads>(qs, qb, row_stride, q0, s_q);
  if (hi > 0) load_kv(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const float* qw = qs + (warp * 16 + g) * kLdK + 2 * t;  // row g, col 2t
  // this lane's rows g and g + 8 of the warp, as global query positions
  const int qpos0 = q_off + q0 + warp * 16 + g;

  float o[F::kDf][4];
#pragma unroll
  for (int df = 0; df < F::kDf; ++df)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[df][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < hi; ++kt) {
    if (kt + 1 < hi) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) are in
    __syncthreads();
    const float* ks = stage_k(kt);
    const float* vs = ks + kBK * kLdK;

    // S = (q * scale) k^T. c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
    // c3 (g + 8, 2t + 1); logical k t / t + 4 = head dims kd + 2t / + 1.
    float sc[F::kNf][4];
#pragma unroll
    for (int nf = 0; nf < F::kNf; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nf][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D; kd += 8) {
      const float2 qa = *reinterpret_cast<const float2*>(qw + kd);
      const float2 qa8 = *reinterpret_cast<const float2*>(qw + 8 * kLdK + kd);
      uint32_t ah[4], al[4];
      split_tf32(qa.x * scale, ah[0], al[0]);
      split_tf32(qa8.x * scale, ah[1], al[1]);
      split_tf32(qa.y * scale, ah[2], al[2]);
      split_tf32(qa8.y * scale, ah[3], al[3]);
#pragma unroll
      for (int nf = 0; nf < F::kNf; ++nf) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (nf * 8 + g) * kLdK + kd + 2 * t);
        mma_3xtf32(sc[nf], ah, al, kv.x, kv.y);
      }
    }

    // mask only a tile that crosses the diagonal or the chunk's end
    const int key0 = kt * kBK;
    const bool masked =
        key0 + kBK > s_k ||
        (causal && k_off + key0 + kBK - 1 > q_off + q0);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      if (masked) {
#pragma unroll
        for (int nf = 0; nf < F::kNf; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = key0 + nf * 8 + 2 * t + e;
            const bool visible = kc < s_k && (!causal || qpos >= k_off + kc);
            if (!visible) sc[nf][2 * r + e] = kNegInf;
          }
      }
      float bm = kNegInf;
#pragma unroll
      for (int nf = 0; nf < F::kNf; ++nf)
        bm = fmaxf(bm, fmaxf(sc[nf][2 * r], sc[nf][2 * r + 1]));
      // the 4 lanes of a row group hold the row
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
      const float new_m = fmaxf(m[r], bm);
      float rs = 0.f;
#pragma unroll
      for (int nf = 0; nf < F::kNf; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[nf][2 * r + e];
          s = s <= kNegInf / 2 ? 0.f : expf(s - new_m);
          rs += s;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      alpha[r] = m[r] <= kNegInf / 2 ? 0.f : expf(m[r] - new_m);
      l[r] = l[r] * alpha[r] + rs;
      m[r] = new_m;
    }

    // P as A fragments, by the permuted k: a0 = (g, 2t) = c0,
    // a1 = (g + 8, 2t) = c2, a2 = (g, 2t + 1) = c1, a3 = (g + 8, 2t + 1) = c3
    uint32_t ph[F::kNf][4], pl[F::kNf][4];
#pragma unroll
    for (int nf = 0; nf < F::kNf; ++nf) {
      split_tf32(sc[nf][0], ph[nf][0], pl[nf][0]);
      split_tf32(sc[nf][2], ph[nf][1], pl[nf][1]);
      split_tf32(sc[nf][1], ph[nf][2], pl[nf][2]);
      split_tf32(sc[nf][3], ph[nf][3], pl[nf][3]);
    }
    // O = O * alpha + P V, this tile's P V from zeroed registers;
    // B = V rows 2t and 2t + 1 of each k8 step, column g
    const float* vt = vs + 2 * t * kLdV + g;
#pragma unroll
    for (int df = 0; df < F::kDf; ++df) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < F::kNf; ++j) {
        const float* vj = vt + j * 8 * kLdV + df * 8;
        mma_3xtf32(pv, ph[j], pl[j], vj[0], vj[kLdV]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[df][i] = o[df][i] * alpha[i / 2] + pv[i];
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + warp * 16 + g + 8 * r;
    if (s >= s_q) continue;
    float* orow =
        acc_out + (static_cast<size_t>(b) * s_q + s) * row_stride + hh * D;
#pragma unroll
    for (int df = 0; df < F::kDf; ++df)
      *reinterpret_cast<float2*>(orow + df * 8 + 2 * t) =
          make_float2(o[df][2 * r], o[df][2 * r + 1]);
    if (t == 0) {
      m_out[static_cast<size_t>(bh) * s_q + s] = m[r];
      l_out[static_cast<size_t>(bh) * s_q + s] = l[r];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* acc,
           float* m, float* l, int b, int h, int s_q, int s_k, int q_off,
           int k_off, int causal, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  using F = Flash<D, T::kWarps, T::kBK>;
  // shared memory above 48 KB is allowed once per device
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D, T::kWarps, T::kBK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev] = true;
  }
  const dim3 grid(b * h, (s_q + F::kBQ - 1) / F::kBQ);
  flash_fwd_kernel<D, T::kWarps, T::kBK>
      <<<grid, F::kThreads, F::kSmemBytes, stream>>>(
          q, k, v, acc, m, l, h, s_q, s_k, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16 and f16: m16n8k16

template <int D, int kWarps, int kBK>
struct Flash16 {
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = D + 8;  // Q, K and V rows, in 16-bit values
  static constexpr int kQVals = kBQ * kLd;
  static constexpr int kStageVals = 2 * kBK * kLd;
  static constexpr int kSmemBytes = (kQVals + 2 * kStageVals) * 2;
  static constexpr int kNf = kBK / 8;  // n8 fragments of S
  static_assert(D % 16 == 0 && kBK % 16 == 0, "tiles are whole mma steps");
};

template <typename T>
struct Half16;
template <>
struct Half16<__nv_bfloat16> {
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
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
struct Half16<__half> {
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Rows [row0, row0 + R) of one head of a (B, S, H, D) 16-bit tensor into
// shared rows of LD values; rows >= s are zero-filled.
template <int R, int D, int LD, int kThreads>
__device__ __forceinline__ void load_rows16(uint16_t* dst, const uint16_t* src,
                                            size_t row_stride, int row0,
                                            int s) {
  constexpr int kPerRow = D / 8;  // 16-byte copies a row
#pragma unroll
  for (int e = threadIdx.x; e < R * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = 8 * (e % kPerRow);
    const int row = row0 + r;
    const bool in = row < s;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * LD + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(in ? src + row * row_stride + c : src), "r"(in ? 16 : 0));
  }
}

template <typename T, int D, int kWarps, int kBK>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_mma16_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int h,
                   int s_q, int s_k, int q_off, int k_off, int causal,
                   float scale) {
  using F = Flash16<D, kWarps, kBK>;
  constexpr int kLd = F::kLd;
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* qs = smem16;

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::kBQ;  // last tile first
  const size_t row_stride = static_cast<size_t>(h) * D;
  const uint16_t* qb = q + (static_cast<size_t>(b) * s_q * h + hh) * D;
  const uint16_t* kb = k + (static_cast<size_t>(b) * s_k * h + hh) * D;
  const uint16_t* vb = v + (static_cast<size_t>(b) * s_k * h + hh) * D;

  const int n_k = (s_k + kBK - 1) / kBK;
  int hi = n_k;
  if (causal) {
    const int q_end = min(q0 + F::kBQ, s_q);
    const int num = q_off + q_end - k_off;
    hi = num <= 0 ? 0 : min((num + kBK - 1) / kBK, n_k);
  }

  auto stage_k = [&](int kt) {
    return smem16 + F::kQVals + (kt & 1) * F::kStageVals;
  };
  auto load_kv = [&](int kt) {
    uint16_t* ks = stage_k(kt);
    load_rows16<kBK, D, kLd, F::kThreads>(ks, kb, row_stride, kt * kBK, s_k);
    load_rows16<kBK, D, kLd, F::kThreads>(ks + kBK * kLd, vb, row_stride,
                                          kt * kBK, s_k);
  };

  load_rows16<F::kBQ, D, kLd, F::kThreads>(qs, qb, row_stride, q0, s_q);
  if (hi > 0) load_kv(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // this lane's Q row g, column 2t (and rows g + 8, columns 2t + 8)
  const uint16_t* qw = qs + (warp * 16 + g) * kLd + 2 * t;
  const int qpos0 = q_off + q0 + warp * 16 + g;

  float o[D / 8][4];
#pragma unroll
  for (int df = 0; df < D / 8; ++df)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[df][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < hi; ++kt) {
    if (kt + 1 < hi) load_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* ks = stage_k(kt);
    const uint16_t* vs = ks + kBK * kLd;

    // S = q k^T: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
    // 2t + 1) of each n8 fragment of keys
    float sc[F::kNf][4];
#pragma unroll
    for (int nf = 0; nf < F::kNf; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nf][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D; kd += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qw + kd);
      a[1] = *reinterpret_cast<const uint32_t*>(qw + 8 * kLd + kd);
      a[2] = *reinterpret_cast<const uint32_t*>(qw + kd + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qw + 8 * kLd + kd + 8);
#pragma unroll
      for (int nf = 0; nf < F::kNf; ++nf) {
        const uint16_t* kr = ks + (nf * 8 + g) * kLd + kd + 2 * t;
        Half16<T>::mma(sc[nf], a, *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    const int key0 = kt * kBK;
    const bool masked =
        key0 + kBK > s_k ||
        (causal && k_off + key0 + kBK - 1 > q_off + q0);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
#pragma unroll
      for (int nf = 0; nf < F::kNf; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[nf][2 * r + e];
          s = __fmul_rn(s, scale);
          if (masked) {
            const int kc = key0 + nf * 8 + 2 * t + e;
            const bool visible = kc < s_k && (!causal || qpos >= k_off + kc);
            if (!visible) s = kNegInf;
          }
        }
      float bm = kNegInf;
#pragma unroll
      for (int nf = 0; nf < F::kNf; ++nf)
        bm = fmaxf(bm, fmaxf(sc[nf][2 * r], sc[nf][2 * r + 1]));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
      const float new_m = fmaxf(m[r], bm);
      float rs = 0.f;
#pragma unroll
      for (int nf = 0; nf < F::kNf; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[nf][2 * r + e];
          s = s <= kNegInf / 2 ? 0.f : expf(s - new_m);
          rs += s;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      alpha[r] = m[r] <= kNegInf / 2 ? 0.f : expf(m[r] - new_m);
      l[r] = l[r] * alpha[r] + rs;
      m[r] = new_m;
    }

    // P rounded to T as the A fragments of each k16 step j (keys 16 j ..
    // 16 j + 15 are S fragments 2 j and 2 j + 1): the accumulator layout
    // is the A layout.
    uint32_t pa[F::kNf / 2][4];
#pragma unroll
    for (int j = 0; j < F::kNf / 2; ++j) {
      pa[j][0] = pack16(Half16<T>::bits(sc[2 * j][0]), Half16<T>::bits(sc[2 * j][1]));
      pa[j][1] = pack16(Half16<T>::bits(sc[2 * j][2]), Half16<T>::bits(sc[2 * j][3]));
      pa[j][2] = pack16(Half16<T>::bits(sc[2 * j + 1][0]), Half16<T>::bits(sc[2 * j + 1][1]));
      pa[j][3] = pack16(Half16<T>::bits(sc[2 * j + 1][2]), Half16<T>::bits(sc[2 * j + 1][3]));
    }
    // O = O * alpha + P V; B = V rows 16 j + 2t, + 1 (b0) and + 8, + 9
    // (b1), column g of each n8 fragment of the head dim
    const uint16_t* vt = vs + 2 * t * kLd + g;
#pragma unroll
    for (int df = 0; df < D / 8; ++df) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < F::kNf / 2; ++j) {
        const uint16_t* vj = vt + j * 16 * kLd + df * 8;
        const uint32_t b0 = pack16(vj[0], vj[kLd]);
        const uint32_t b1 = pack16(vj[8 * kLd], vj[9 * kLd]);
        Half16<T>::mma(pv, pa[j], b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[df][i] = o[df][i] * alpha[i / 2] + pv[i];
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + warp * 16 + g + 8 * r;
    if (s >= s_q) continue;
    float* orow =
        acc_out + (static_cast<size_t>(b) * s_q + s) * row_stride + hh * D;
#pragma unroll
    for (int df = 0; df < D / 8; ++df)
      *reinterpret_cast<float2*>(orow + df * 8 + 2 * t) =
          make_float2(o[df][2 * r], o[df][2 * r + 1]);
    if (t == 0) {
      m_out[static_cast<size_t>(bh) * s_q + s] = m[r];
      l_out[static_cast<size_t>(bh) * s_q + s] = l[r];
    }
  }
}

template <typename T, int D>
int launch16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
             float* acc, float* m, float* l, int b, int h, int s_q, int s_k,
             int q_off, int k_off, int causal, float scale,
             cudaStream_t stream) {
  using Tl = Tiles<D>;
  using F = Flash16<D, Tl::kWarps, Tl::kBK>;
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(flash_mma16_kernel<T, D, Tl::kWarps, Tl::kBK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev] = true;
  }
  const dim3 grid(b * h, (s_q + F::kBQ - 1) / F::kBQ);
  flash_mma16_kernel<T, D, Tl::kWarps, Tl::kBK>
      <<<grid, F::kThreads, F::kSmemBytes, stream>>>(
          q, k, v, acc, m, l, h, s_q, s_k, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int partials16(const void* q, const void* k, const void* v, float* acc,
               float* m, float* l, int b, int h, int s_q, int s_k, int d,
               int q_off, int k_off, int causal, float scale,
               cudaStream_t stream) {
  const auto* q16 = static_cast<const uint16_t*>(q);
  const auto* k16 = static_cast<const uint16_t*>(k);
  const auto* v16 = static_cast<const uint16_t*>(v);
  switch (d) {
    case 32:
      return launch16<T, 32>(q16, k16, v16, acc, m, l, b, h, s_q, s_k, q_off,
                             k_off, causal, scale, stream);
    case 128:
      return launch16<T, 128>(q16, k16, v16, acc, m, l, b, h, s_q, s_k, q_off,
                              k_off, causal, scale, stream);
    case 256:
      return launch16<T, 256>(q16, k16, v16, acc, m, l, b, h, s_q, s_k, q_off,
                              k_off, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Head dims 32 (the bench's tiny LM), 128 (the flagship) and 256 (the
// bench's `large` LM) are instantiated; any other returns
// cudaErrorInvalidValue. q, k, v, acc start on 16-byte boundaries. Returns
// cudaGetLastError() after the launch.
int flash_attn_partials_f32(const float* q, const float* k, const float* v,
                            float* acc, float* m, float* l, int b, int h,
                            int s_q, int s_k, int d, int q_off, int k_off,
                            int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                        causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                         causal, scale, stream);
    case 256:
      return launch<256>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                         causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 form: q, k, v bf16 (B, S, H, D) on 16-byte boundaries; acc, m,
// l f32. Head dims as flash_attn_partials_f32. Returns cudaGetLastError()
// after the launch.
int flash_attn_partials_bf16(const void* q, const void* k, const void* v,
                             float* acc, float* m, float* l, int b, int h,
                             int s_q, int s_k, int d, int q_off, int k_off,
                             int causal, float scale, cudaStream_t stream) {
  return partials16<__nv_bfloat16>(q, k, v, acc, m, l, b, h, s_q, s_k, d,
                                   q_off, k_off, causal, scale, stream);
}

// The f16 form, as flash_attn_partials_bf16.
int flash_attn_partials_f16(const void* q, const void* k, const void* v,
                            float* acc, float* m, float* l, int b, int h,
                            int s_q, int s_k, int d, int q_off, int k_off,
                            int causal, float scale, cudaStream_t stream) {
  return partials16<__half>(q, k, v, acc, m, l, b, h, s_q, s_k, d, q_off,
                            k_off, causal, scale, stream);
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
