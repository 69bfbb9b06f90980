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
// Bound on an H100: at the flagship's q, k, v (16, 512, 4, 128) the causal
// work is 4 * D FLOPs for each of the B*H*S*(S+1)/2 visible pairs, 4.3e9
// FLOP (0.064 ms at the 67 TFLOP/s f32 peak), against 67 MB of inputs and
// outputs (0.020 ms at 3.35 TB/s): bound by operations. At the tiny LM's
// (4, 128, 4, 32) it is 1.7e7 FLOP against 1.1 MB: 0.0003 ms either way,
// so launch cost sets its time. Design: one CTA per
// (batch * head, 64-row Q tile); it loops over 64-row K/V tiles only up to
// the causal bound q_offset + (j+1)*64 - k_offset, so tiles above the
// diagonal are never loaded (the TPU kernel's block sparsity). Scores stay
// in shared memory; the running max and sum are f32 registers, updated
// online. The offsets are kernel arguments, so ring steps can reuse the
// kernel. Shared memory is 115 KB at D = 128 and 41 KB at D = 32; the
// tiles stay 64 rows at both. m and l are written as (B, H, S_q): the TPU's 128-lane broadcast
// of them was a Mosaic layout constraint. No tensor cores (f32 exact);
// wgmma and a pipelined K/V ring are later work.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // key rows per K/V tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns rows ty + 16i

template <int D>
constexpr size_t smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int h,
                 int s_q, int s_k, int q_off, int k_off, int causal,
                 float scale) {
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // kBQ x (D + 1), pre-scaled q
  float* ks = qs + kBQ * (D + 1);   // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);   // kBK x D
  float* ps = vs + kBK * D;         // kBQ x (kBK + 1), probabilities

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int qt = blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t row_stride = static_cast<size_t>(h) * D;
  const float* qb = q + (static_cast<size_t>(b) * s_q * h + hh) * D;
  const float* kb = k + (static_cast<size_t>(b) * s_k * h + hh) * D;
  const float* vb = v + (static_cast<size_t>(b) * s_k * h + hh) * D;

  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int s = qt * kBQ + r;
    qs[r * (D + 1) + c] = s < s_q ? qb[s * row_stride + c] * scale : 0.f;
  }

  const int n_k = (s_k + kBK - 1) / kBK;
  int hi = n_k;
  if (causal) {
    // one past this tile's last query position, in key-chunk coordinates
    const int q_end = min((qt + 1) * kBQ, s_q);
    const int num = q_off + q_end - k_off;
    hi = num <= 0 ? 0 : min((num + kBK - 1) / kBK, n_k);
  }

  float m[4], l[4], o[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[i][c] = 0.f;
  }

  for (int kt = 0; kt < hi; ++kt) {
    __syncthreads();  // previous tile's readers are done with ks, vs, ps
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int s = kt * kBK + r;
      const bool in = s < s_k;
      ks[r * (D + 1) + c] = in ? kb[s * row_stride + c] : 0.f;
      vs[r * D + c] = in ? vb[s * row_stride + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = qs[(ty + 16 * i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = ks[(tx + 16 * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(x[i], y[j], sc[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_off + qt * kBQ + ty + 16 * i;
      float bm = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = kt * kBK + tx + 16 * j;
        const bool visible = kc < s_k && (!causal || qpos >= k_off + kc);
        sc[i][j] = visible ? sc[i][j] : kNegInf;
        bm = fmaxf(bm, sc[i][j]);
      }
      // row max over the 16 threads sharing the row (lanes of one half-warp)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
      const float new_m = fmaxf(m[i], bm);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] <= kNegInf / 2 ? 0.f : expf(sc[i][j] - new_m);
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      alpha[i] = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - new_m);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = new_m;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float pv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) pv[c] = 0.f;
      const float* prow = ps + (ty + 16 * i) * (kBK + 1);
      for (int j = 0; j < kBK; ++j) {
        const float p = prow[j];
#pragma unroll
        for (int c = 0; c < CD; ++c) pv[c] = fmaf(p, vs[j * D + tx + 16 * c], pv[c]);
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) o[i][c] = o[i][c] * alpha[i] + pv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = qt * kBQ + ty + 16 * i;
    if (s >= s_q) continue;
    float* orow = acc_out + (static_cast<size_t>(b) * s_q + s) * row_stride + hh * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tx + 16 * c] = o[i][c];
    if (tx == 0) {
      m_out[static_cast<size_t>(bh) * s_q + s] = m[i];
      l_out[static_cast<size_t>(bh) * s_q + s] = l[i];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* acc,
           float* m, float* l, int b, int h, int s_q, int s_k, int q_off,
           int k_off, int causal, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (s_q + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, acc, m, l, h, s_q, s_k, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Head dims 128 (the flagship's) and 32 (the bench's tiny LM) are
// instantiated; any other returns cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch.
int flash_attn_partials_f32(const float* q, const float* k, const float* v,
                            float* acc, float* m, float* l, int b, int h,
                            int s_q, int s_k, int d, int q_off, int k_off,
                            int causal, float scale, cudaStream_t stream) {
  if (d == 128)
    return launch<128>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                       causal, scale, stream);
  if (d == 32)
    return launch<32>(q, k, v, acc, m, l, b, h, s_q, s_k, q_off, k_off,
                      causal, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
