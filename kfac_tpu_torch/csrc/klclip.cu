// The kl-clip kernels over every layer at once:
// - the dot: dot_t = sum(p_t * g_t) for T pairs of f32 tensors, with the
//   engine's reduction over the layers fused in: term_t = dot_t * lr^2,
//   vg = term_0 + term_1 + ... (left to right) and the scale
//   min(1, sqrt(kl_clip / |vg|)), 1 where vg == 0;
// - the scale: dst_t = src_t * s for T f32 tensors, with s read from a
//   one-element device tensor (no host sync).
//
// Replace the TPU kernels _klclip_dot_kernel (kfac_tpu/ops/pallas_ns.py:188,
// called at :219 by fused_klclip_dot) and _klclip_scale_kernel (:203,
// called at :244 by fused_klclip_scale), which the JAX engine runs once
// per layer; here one launch of each covers the layers of a step.
//
// Bound on an H100: both are bytes. The flagship's 36 tensors hold
// 18,902,016 elements: the dot reads two of each (151.2 MB, 0.045 ms at
// 3.35 TB/s, 2 FLOPs per 8 bytes; 6 with the norms, the same bytes); the
// scale reads and writes one (the same 151.2 MB).
// Design: the tensor table (pointers, element count, first block) is a
// kernel parameter, passed by value, so a launch needs no table in device
// memory; more than kMaxTensors tensors take a few launches. Each block of
// 256 threads covers 4096 elements of one tensor and finds it by a binary
// search over the first blocks (an empty tensor owns no block). The bulk
// moves as 16-byte float4 loads: elements are indexed from the 16-byte
// boundary at or before the tensor's start, so an unaligned start and a
// ragged tail are masked element by element.
// - The scale: source and destination share their offset from a 16-byte
//   boundary (the launcher refuses a table where they do not). A thread
//   loads its four vectors before it stores any, so a destination may
//   alias its source (the engine scales in place).
// - The dot: p and g come from separate allocations (g may be a view at
//   any offset), so a pair whose offsets differ reads g by 4-byte loads,
//   still coalesced. Each block writes one partial sum (a fixed-order tree
//   over its threads); then one CTA (klclip_dot_final_kernel) adds each
//   tensor's partials in order, a warp a tensor, forms the terms, folds
//   them in table order and writes the scale. A table past kMaxTensors
//   takes more launches of both kernels: the fold carries on from the last
//   launch's sum, so it runs in one order across them. No float atomics:
//   every output repeats bit for bit.
// - The dot's norm epilogue (template flag kNorms, the engine's per-layer
//   grad_norm and precond_grad_norm telemetry, which the JAX engine takes
//   next to the kl-clip reduction's read of p): each block also sums g*g
//   and p*p of its span, its three partials side by side; the final CTA
//   folds each tensor's Σ g² and Σ p² in the same fixed order as its dot.
//   The dot's own arithmetic is the same code in both instantiations, so
//   its terms, sum and scale are bitwise those of the variant without
//   norms, which keeps its parameter list (a parameter list once moved
//   ptxas's register choice in sym_cov.cu).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                           // float4 per thread
constexpr int kBlockElems = kThreads * kVecs * 4;  // elements per block
constexpr int kMaxTensors = 96;  // TABLE_CAPACITY in ops/klclip.py

struct Entry {
  const float* src;
  float* dst;
  long long numel;
  int first_block;
  int shift;  // elements from the 16-byte boundary to src and to dst
};

struct Table {  // 3,080 bytes: inside the 4 KB of kernel parameters
  Entry e[kMaxTensors];
  int count;
};

__global__ void __launch_bounds__(kThreads)
klclip_scale_multi_kernel(const Table table, const float* __restrict__ scale) {
  const int b = blockIdx.x;
  int lo = 0;
  int hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.e[mid].first_block <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const float* src = table.e[lo].src;
  float* dst = table.e[lo].dst;
  const long long n = table.e[lo].numel;
  const int shift = table.e[lo].shift;
  const float s = *scale;
  const long long j0 = static_cast<long long>(b - table.e[lo].first_block) *
                       kBlockElems;

  // element k of the tensor is element k + shift of the aligned view
  const float4* src4 = reinterpret_cast<const float4*>(src - shift);
  float4* dst4 = reinterpret_cast<float4*>(dst - shift);
  float4 v[kVecs];
  bool full[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const long long q = j0 / 4 + threadIdx.x + u * kThreads;
    full[u] = 4 * q >= shift && 4 * q + 4 <= shift + n;
    if (full[u]) v[u] = src4[q];
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const long long q = j0 / 4 + threadIdx.x + u * kThreads;
    if (full[u]) {
      v[u].x *= s;
      v[u].y *= s;
      v[u].z *= s;
      v[u].w *= s;
      dst4[q] = v[u];
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long k = 4 * q + c - shift;
      if (k >= 0 && k < n) dst[k] = src[k] * s;
    }
  }
}


// ------------------------------------------------------------------- dot

constexpr int kFinalThreads = 1024;  // 32 warps: a warp per tensor

struct DotEntry {
  const float* p;
  const float* g;
  long long numel;
  int first_block;
  int shift;    // elements from the 16-byte boundary to p
  int g_shift;  // and to g
};

struct DotTable {  // 3,848 bytes: inside the 4 KB of kernel parameters
  DotEntry e[kMaxTensors];
  int count;
};

struct DotSpans {  // tensor t owns partials [first_block[t], first_block[t + 1])
  int first_block[kMaxTensors + 1];
  int count;
};

// Fixed-order sum of v over the block's threads, in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  }
  return s;
}

// Fixed-order sums of the three values over the block's threads, in
// thread 0: each the tree of block_sum.
__device__ __forceinline__ float3 block_sum3(float3 v) {
  __shared__ float3 warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
    v.z += __shfl_down_sync(0xffffffffu, v.z, o);
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float3 s = make_float3(0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      s.x += warp_sums[w].x;
      s.y += warp_sums[w].y;
      s.z += warp_sums[w].z;
    }
  }
  return s;
}

// partials[b] = sum of p * g over block b's 4096 elements of its tensor;
// with kNorms, partials[3b .. 3b + 2] = that sum, sum of g * g, sum of p * p.
template <bool kNorms>
__global__ void __launch_bounds__(kThreads)
klclip_dot_multi_kernel(const DotTable table, float* __restrict__ partials) {
  const int b = blockIdx.x;
  int lo = 0;
  int hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.e[mid].first_block <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const float* p = table.e[lo].p;
  const float* g = table.e[lo].g;
  const long long n = table.e[lo].numel;
  const int shift = table.e[lo].shift;
  const bool g_aligned = table.e[lo].g_shift == shift;
  const long long j0 = static_cast<long long>(b - table.e[lo].first_block) *
                       kBlockElems;

  // element k of the tensor is element k + shift of p's aligned view
  const float4* p4 = reinterpret_cast<const float4*>(p - shift);
  const float4* g4 = reinterpret_cast<const float4*>(g - shift);
  float acc = 0.f;
  float gg = 0.f;  // kNorms only
  float pp = 0.f;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const long long q = j0 / 4 + threadIdx.x + u * kThreads;
    if (4 * q >= shift && 4 * q + 4 <= shift + n) {
      const float4 x = p4[q];
      float4 y;
      if (g_aligned) {
        y = g4[q];
      } else {
        const float* gq = g + (4 * q - shift);
        y = make_float4(gq[0], gq[1], gq[2], gq[3]);
      }
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
      if constexpr (kNorms) {
        gg = fmaf(y.x, y.x, gg);
        gg = fmaf(y.y, y.y, gg);
        gg = fmaf(y.z, y.z, gg);
        gg = fmaf(y.w, y.w, gg);
        pp = fmaf(x.x, x.x, pp);
        pp = fmaf(x.y, x.y, pp);
        pp = fmaf(x.z, x.z, pp);
        pp = fmaf(x.w, x.w, pp);
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long k = 4 * q + c - shift;
      if (k >= 0 && k < n) {
        const float pk = p[k];
        const float gk = g[k];
        acc = fmaf(pk, gk, acc);
        if constexpr (kNorms) {
          gg = fmaf(gk, gk, gg);
          pp = fmaf(pk, pk, pp);
        }
      }
    }
  }
  if constexpr (kNorms) {
    const float3 s = block_sum3(make_float3(acc, gg, pp));
    if (threadIdx.x == 0) {
      partials[3 * b] = s.x;
      partials[3 * b + 1] = s.y;
      partials[3 * b + 2] = s.z;
    }
  } else {
    const float s = block_sum(acc);
    if (threadIdx.x == 0) partials[b] = s;
  }
}

// For each tensor of the launch: dot = its partials added in order (a warp
// a tensor), terms[t] = dot * lr2. vg_scale[0] = the terms folded left to
// right onto 0, or with `carry` onto the vg_scale[0] of the launch before;
// with `last`, vg_scale[1] = min(1, sqrt(kl_clip / |vg|)), 1 where vg == 0,
// NaN where vg is NaN (IEEE division and sqrtf, the plain version's ops).
// With kNorms, gsq[t] and psq[t] = the tensor's Σ g² and Σ p² partials added
// in the dot's order (null pointers without).
template <bool kNorms>
__global__ void __launch_bounds__(kFinalThreads)
klclip_dot_final_kernel(const DotSpans spans, const float* __restrict__ partials,
                        float* __restrict__ terms, float* __restrict__ vg_scale,
                        float lr2, float kl_clip, int carry, int last,
                        float* __restrict__ gsq, float* __restrict__ psq) {
  __shared__ float dots[kMaxTensors];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kStride = kNorms ? 3 : 1;
  for (int t = warp; t < spans.count; t += kFinalThreads / 32) {
    float s = 0.f;
    float sg = 0.f;
    float sp = 0.f;
    for (int i = spans.first_block[t] + lane; i < spans.first_block[t + 1];
         i += 32) {
      s += partials[kStride * i];
      if constexpr (kNorms) {
        sg += partials[kStride * i + 1];
        sp += partials[kStride * i + 2];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      if constexpr (kNorms) {
        sg += __shfl_down_sync(0xffffffffu, sg, o);
        sp += __shfl_down_sync(0xffffffffu, sp, o);
      }
    }
    if (lane == 0) {
      dots[t] = s;
      if constexpr (kNorms) {
        gsq[t] = sg;
        psq[t] = sp;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float vg = carry ? vg_scale[0] : 0.f;
  for (int t = 0; t < spans.count; ++t) {
    const float term = dots[t] * lr2;
    terms[t] = term;
    vg += term;
  }
  vg_scale[0] = vg;
  if (!last) return;
  const float a = fabsf(vg);
  float s = 1.f;
  if (a != 0.f) {
    s = sqrtf((1.f / a) * kl_clip);
    s = s > 1.f ? 1.f : s;  // keeps a NaN, as torch.clamp does
  }
  vg_scale[1] = s;
}

}  // namespace

extern "C" {

// dst_t = src_t * scale[0] for the `count` rows (src, dst, numel) of
// `table`, 64-bit each; empty tensors are skipped. src and dst of a row lie
// at one offset from a 16-byte boundary, else nothing is launched and
// cudaErrorInvalidValue returned. One launch per kMaxTensors non-empty
// tensors, on `stream`. Returns cudaGetLastError() after the last launch
// (or the first that failed), cudaSuccess where nothing was launched.
int klclip_scale_multi_f32(const long long* table, int count,
                           const float* scale, cudaStream_t stream) {
  for (int i = 0; i < count; ++i) {
    if (table[3 * i] % 16 != table[3 * i + 1] % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Table t;
  t.count = 0;
  int blocks = 0;
  auto flush = [&] {
    klclip_scale_multi_kernel<<<blocks, kThreads, 0, stream>>>(t, scale);
    t.count = 0;
    blocks = 0;
    return cudaGetLastError();
  };
  for (int i = 0; i < count; ++i) {
    const long long n = table[3 * i + 2];
    if (n == 0) continue;
    const auto src = static_cast<uintptr_t>(table[3 * i]);
    const auto dst = static_cast<uintptr_t>(table[3 * i + 1]);
    const int shift = static_cast<int>(src % 16) / 4;
    Entry& e = t.e[t.count++];
    e.src = reinterpret_cast<const float*>(src);
    e.dst = reinterpret_cast<float*>(dst);
    e.numel = n;
    e.first_block = blocks;
    e.shift = shift;
    blocks += static_cast<int>((n + shift + kBlockElems - 1) / kBlockElems);
    if (t.count == kMaxTensors) {
      const cudaError_t err = flush();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(t.count > 0 ? flush() : cudaSuccess);
}

// The kl-clip dot of `count` pairs, rows (p, g, numel) of `table`, 64-bit
// each (numel 0 allowed): out[t] = sum(p_t * g_t) * lr2, out[count] = the
// terms folded left to right, out[count + 1] = the scale (see
// klclip_dot_final_kernel); with `norms`, also out[count + 2 + t] =
// sum(g_t * g_t) and out[2 * count + 2 + t] = sum(p_t * p_t). `partials` is
// scratch of `capacity` floats, at least the sum over the pairs of
// ceil(numel / 4096) + 1, three times that with `norms`. Two launches per
// kMaxTensors pairs, on `stream`. Returns cudaErrorInvalidValue, launching
// nothing, where count < 1 or the scratch is short; else the first nonzero
// cudaGetLastError() after a launch, or cudaSuccess.
int klclip_dot_multi_f32(const long long* table, int count, float* partials,
                         long long capacity, float* out, float lr2,
                         float kl_clip, int norms, cudaStream_t stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long need = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = table[3 * i + 2];
    need += n > 0 ? (n + kBlockElems - 1) / kBlockElems + 1 : 0;
  }
  if ((norms ? 3 : 1) * need > capacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DotTable t;
  DotSpans spans;
  t.count = 0;
  int blocks = 0;
  int start = 0;  // first pair of the launch
  for (int i = 0; i < count; ++i) {
    const long long n = table[3 * i + 2];
    const auto p = static_cast<uintptr_t>(table[3 * i]);
    const auto g = static_cast<uintptr_t>(table[3 * i + 1]);
    DotEntry& e = t.e[t.count];
    e.p = reinterpret_cast<const float*>(p);
    e.g = reinterpret_cast<const float*>(g);
    e.numel = n;
    e.first_block = blocks;
    e.shift = static_cast<int>(p % 16) / 4;
    e.g_shift = static_cast<int>(g % 16) / 4;
    spans.first_block[t.count] = blocks;
    ++t.count;
    if (n > 0) {
      blocks += static_cast<int>((n + e.shift + kBlockElems - 1) / kBlockElems);
    }
    if (t.count < kMaxTensors && i + 1 < count) continue;
    spans.first_block[t.count] = blocks;
    spans.count = t.count;
    if (blocks > 0) {
      if (norms) {
        klclip_dot_multi_kernel<true><<<blocks, kThreads, 0, stream>>>(t, partials);
      } else {
        klclip_dot_multi_kernel<false><<<blocks, kThreads, 0, stream>>>(t, partials);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (norms) {
      klclip_dot_final_kernel<true><<<1, kFinalThreads, 0, stream>>>(
          spans, partials, out + start, out + count, lr2, kl_clip, start > 0,
          i + 1 == count, out + count + 2 + start, out + 2 * count + 2 + start);
    } else {
      klclip_dot_final_kernel<false><<<1, kFinalThreads, 0, stream>>>(
          spans, partials, out + start, out + count, lr2, kl_clip, start > 0,
          i + 1 == count, nullptr, nullptr);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    start = i + 1;
    t.count = 0;
    blocks = 0;
  }
  return static_cast<int>(cudaSuccess);
}

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
