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
// bf16 and f16 inputs (flash_wgmma_kernel<T, D>): the TPU kernel upcasts q
// and k, takes f32 logits and softmax, and rounds p to v's dtype before
// P V, which accumulates in f32 (pallas_attention.py:56-99); acc, m and l
// stay f32. These forms compute that function with logit = (q . k) *
// D^-0.5: q . k of the 16-bit values on the tensor cores (each product
// exact in f32, f32 accumulate), then one f32 multiply (__fmul_rn, so it
// is never contracted into the subtraction that follows). The TPU kernel's
// (q * scale) . k differs from it by f32 rounding only; neither rounds
// q * scale to 16 bits, as the einsum form off the TPU does. p = exp(logit
// - m) is summed into l unrounded and rounded to T to nearest for P V. m
// is the f32 form's, bit for bit (the largest dot, scaled: the rounding is
// monotone); p is 2^(dot * scale * log2 e - m * log2 e), one FMA and the
// SFU's ex2.approx, within a few f32 ulps of expf(logit - m) (with expf
// the kernel took 0.0337 ms on an H100 against 0.0233 at (16, 512, 4,
// 128): `python -m kfac_tpu_torch.half_probe`).
// Bound at the flagship's (16, 512, 4, 128): 4.3e9 FLOP at the 989 TFLOP/s
// bf16/f16 peak, 0.0044 ms, against 25.2 MB of 16-bit q, k and v and 16.8
// MB of f32 acc (m and l 0.26 MB), 0.0126 ms at 3.35 TB/s: bound by bytes.
// Design:
// - One CTA per (batch * head, 64-row Q tile), Q tiles last first, the
//   causal bound as in the f32 form (K tiles above the diagonal are never
//   loaded). A producer warp loads Q once and 64-key K/V tiles into a
//   two-stage ring of mbarriers by TMA over the 4-D (B, S, H, D) tensors,
//   a box of one head: 64 head-dim values (128 bytes, 128-byte swizzle;
//   32 values and the 64-byte swizzle at D = 32) x the tile's rows. Rows
//   past the chunk read as zeros.
// - One consumer warpgroup owns the 64 query rows. S = Q K^T is wgmma
//   m64n64k16 with Q and K from shared memory, both K-major. P V is wgmma
//   m64nDk16 with P from registers: the S accumulator of each 16 keys,
//   rounded to T, packs into the A fragment; V comes from shared memory,
//   MN-major, through the transpose bit. O is scaled by alpha in registers
//   and P V accumulates onto it in the tensor cores.
// - Two CTAs share an SM at D = 32 and 128 (80 KB of shared memory each at
//   D = 128), so one's loads, softmax and epilogue overlap the other's
//   products. At D = 256 one CTA an SM (160 KB) gets 255 registers a
//   thread for its 128 f32 of O, 32 of S and 16 packed P registers. (Two
//   consumer warpgroups of 64 rows sharing 128-row K/V tiles, with
//   setmaxnreg raising them to 232, took 0.0245 ms against 0.0233 at (16,
//   512, 4, 128) on an H100 (`half_probe`), and at D = 256 ptxas still
//   held the kernel to 168 registers and spilled 580 bytes.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

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

// --------------------------------------------------- bf16 and f16: wgmma

// Tiles of the 16-bit form at head dim D: one consumer warpgroup of 64
// query rows and a producer warp, K/V tiles of 64 keys in a ring of
// kStages; TMA boxes of kBox head-dim values (one swizzle row: 128 bytes,
// or 64 at D = 32). kCtas CTAs share an SM (shared memory and registers).
template <int D>
struct Flash16 {
  static constexpr int kBQ = 64;
  static constexpr int kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kCtas = D == 256 ? 1 : 2;
  static constexpr int kBox = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBox;
  static constexpr int kRow = kBox * 2;  // bytes of a box row: the swizzle span
  static constexpr uint32_t kLayout =
      kRow == 128 ? hopper::kSwizzle128 : hopper::kSwizzle64;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;  // a K or a V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kThreads = 160;  // a consumer warpgroup, a producer warp
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
  static_assert(D % kBox == 0 && kBox % 16 == 0, "whole boxes of k16 steps");
};

// p rounded to T (to nearest), as the bits of a 16-bit value.
template <typename T>
__device__ __forceinline__ uint16_t bits16(float x);
template <>
__device__ __forceinline__ uint16_t bits16<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ uint16_t bits16<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx: within 2 ulp of f32; subnormal results kept).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One CTA per (batch * head, 64-row Q tile), the Q tiles last first.
// Threads 128..159 are the producer warp: its first thread loads Q once
// and K/V tiles up to the causal bound into the ring (TMA over the
// (B, S, H, D) tensors, a box of one head). Warpgroup 0 owns the query
// rows: S = Q K^T by wgmma m64n64k16 (Q and K from shared memory, both
// K-major), the online softmax in registers, then O = O * alpha + P V by
// wgmma m64nDk16 with P from registers (the accumulator of S, rounded to
// T, is the A fragment) and V from shared memory (MN-major, through the
// transpose bit).
template <typename T, int D>
__global__ void __launch_bounds__(160, Flash16<D>::kCtas)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int h, int s_q, int s_k,
                   int q_off, int k_off, int causal, float scale) {
  using F = Flash16<D>;
  using hopper::smem_u32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* ring = qs + F::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + F::kStages * F::kStageBytes);
  uint64_t* empty = full + F::kStages;
  uint64_t* q_full = empty + F::kStages;

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::kBQ;  // last tile first
  const int n_k = (s_k + F::kBK - 1) / F::kBK;
  // K tiles [0, bound(rows)) hold every key that query rows [q0, q0 + rows)
  // can see: one past the last row's position, in key-chunk coordinates
  auto bound = [&](int first, int rows) {
    if (!causal) return n_k;
    const int num = q_off + min(first + rows, s_q) - k_off;
    return num <= 0 ? 0 : min((num + F::kBK - 1) / F::kBK, n_k);
  };
  const int hi = bound(q0, F::kBQ);

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // the consumer warps
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128 && hi > 0) {
      hopper::mbar_expect_tx(q_full, F::kQBytes);
#pragma unroll
      for (int c = 0; c < F::kBoxes; ++c)
        hopper::tma_load_4d(qs + c * F::kBQ * F::kRow, &q_map, q_full,
                            c * F::kBox, hh, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < hi; ++kt) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* ks = ring + stage * F::kStageBytes;
        unsigned char* vs = ks + F::kTileBytes;
        hopper::mbar_expect_tx(&full[stage], F::kStageBytes);
#pragma unroll
        for (int c = 0; c < F::kBoxes; ++c) {
          hopper::tma_load_4d(ks + c * F::kBK * F::kRow, &k_map, &full[stage],
                              c * F::kBox, hh, kt * F::kBK, b);
          hopper::tma_load_4d(vs + c * F::kBK * F::kRow, &v_map, &full[stage],
                              c * F::kBox, hh, kt * F::kBK, b);
        }
        if (++stage == F::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // the consumer warpgroup
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // this lane's rows g and g + 8 of its warp, as global query positions
    const int qpos0 = q_off + q0 + 16 * warp + g;

    // p = exp(logit - m) = 2^(q.k * scale * log2(e) - m * log2(e)): one
    // FMA of the dot and ex2
    const float scale_log2e = scale * kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    if (hi > 0) hopper::mbar_wait(q_full, 0);
    const uint32_t q_at = smem_u32(qs);

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < hi; ++kt) {
      hopper::mbar_wait(&full[stage], phase);
      {
        const uint32_t k_at = smem_u32(ring + stage * F::kStageBytes);
        const uint32_t v_at = k_at + F::kTileBytes;
        // S = q k^T: s[4j + r] at row g + 8 (r / 2), key 8j + 2t + r % 2
        float s[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < F::kBoxes; ++c)
#pragma unroll
          for (int kk = 0; kk < F::kBox / 16; ++kk) {
            const uint64_t dq = hopper::make_desc(
                q_at + c * F::kBQ * F::kRow + 32 * kk, 16, 8 * F::kRow, F::kLayout);
            const uint64_t dk = hopper::make_desc(
                k_at + c * F::kBK * F::kRow + 32 * kk, 16, 8 * F::kRow, F::kLayout);
            hopper::Wgmma<T>::ss_n64_nn(s, dq, dk, c + kk > 0);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(s);

        const int key0 = kt * F::kBK;
        const bool masked = key0 + F::kBK > s_k ||
                            (causal && k_off + key0 + F::kBK - 1 > q_off + q0);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qpos = qpos0 + 8 * r;
          if (masked) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kc = key0 + 8 * j + 2 * t + e;
                const bool visible = kc < s_k && (!causal || qpos >= k_off + kc);
                if (!visible) s[4 * j + 2 * r + e] = kNegInf;
              }
          }
          float bm = kNegInf;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bm = fmaxf(bm, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
          // the 4 lanes of a row group hold the row
          bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
          bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
          // the largest logit: rounding q.k * scale is monotone, so it is
          // the largest dot's logit
          if (bm > kNegInf / 2) bm = __fmul_rn(bm, scale);
          const float new_m = fmaxf(m[r], bm);
          const float base = new_m * kLog2e;
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * r + e];
              x = x <= kNegInf / 2 ? 0.f : exp2_approx(fmaf(x, scale_log2e, -base));
              rs += x;
            }
          rs += __shfl_xor_sync(0xffffffffu, rs, 1);
          rs += __shfl_xor_sync(0xffffffffu, rs, 2);
          alpha[r] = m[r] <= kNegInf / 2 ? 0.f : exp2_approx((m[r] - new_m) * kLog2e);
          l[r] = l[r] * alpha[r] + rs;
          m[r] = new_m;
        }
        // P rounded to T as the A fragment of each k16 step kk (keys 16 kk
        // .. 16 kk + 15 are S blocks 2 kk and 2 kk + 1)
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* x = s + 4 * (2 * kk + q / 2) + 2 * (q % 2);
            pa[kk][q] = pack16(bits16<T>(x[0]), bits16<T>(x[1]));
          }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
        // O += P V; V rows 16 kk.. of the tile, MN-major: its boxes are
        // kBK rows apart (lbo), 8-row groups 8 rows apart (sbo)
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = hopper::make_desc(v_at + 16 * kk * F::kRow,
                                                F::kBK * F::kRow, 8 * F::kRow,
                                                F::kLayout);
          hopper::Wgmma<T>::rs_t(o, pa[kk], dv, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(o);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == F::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const size_t row_stride = static_cast<size_t>(h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sq = q0 + 16 * warp + g + 8 * r;
      if (sq >= s_q) continue;
      float* orow = acc_out + (static_cast<size_t>(b) * s_q + sq) * row_stride + hh * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)  // streaming: acc is read by a later kernel
        __stcs(reinterpret_cast<float2*>(orow + 8 * j + 2 * t),
               make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]));
      if (t == 0) {
        m_out[static_cast<size_t>(bh) * s_q + sq] = m[r];
        l_out[static_cast<size_t>(bh) * s_q + sq] = l[r];
      }
    }
  }
}

// The TMA map of one (B, S, H, D) tensor of T, read a box of one head:
// kBox values of the head dim x `rows` positions.
template <typename T, int D>
cudaError_t encode_heads(CUtensorMap* map, const void* x, int b, int s, int h,
                         int rows) {
  using F = Flash16<D>;
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(h) * D * 2,
                                 static_cast<cuuint64_t>(s) * h * D * 2};
  const cuuint32_t box[4] = {F::kBox, 1, static_cast<cuuint32_t>(rows), 1};
  return hopper::encode_map(
      map, hopper::TmaType<T>::value, 4, x, dims, strides, box,
      F::kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <typename T, int D>
int launch16(const void* q, const void* k, const void* v, float* acc,
             float* m, float* l, int b, int h, int s_q, int s_k, int q_off,
             int k_off, int causal, float scale, cudaStream_t stream) {
  using F = Flash16<D>;
  if (b * h == 0 || s_q == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap q_map, k_map, v_map;
  std::memset(&k_map, 0, sizeof(k_map));
  std::memset(&v_map, 0, sizeof(v_map));
  cudaError_t err = encode_heads<T, D>(&q_map, q, b, s_q, h, F::kBQ);
  if (err == cudaSuccess && s_k > 0) {  // with no keys no tile is loaded
    err = encode_heads<T, D>(&k_map, k, b, s_k, h, F::kBK);
    if (err == cudaSuccess) err = encode_heads<T, D>(&v_map, v, b, s_k, h, F::kBK);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[dev] = true;
  }
  const dim3 grid(b * h, (s_q + F::kBQ - 1) / F::kBQ);
  flash_wgmma_kernel<T, D><<<grid, F::kThreads, F::kSmemBytes, stream>>>(
      q_map, k_map, v_map, acc, m, l, h, s_q, s_k, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int partials16(const void* q, const void* k, const void* v, float* acc,
               float* m, float* l, int b, int h, int s_q, int s_k, int d,
               int q_off, int k_off, int causal, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch16<T, 32>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                             causal, scale, stream);
    case 128:
      return launch16<T, 128>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                              causal, scale, stream);
    case 256:
      return launch16<T, 256>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                              causal, scale, stream);
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
