// The kl-clip scale over every layer at once: dst_t = src_t * s for T f32
// tensors, with s read from a one-element device tensor (no host sync).
//
// Replaces the TPU kernel _klclip_scale_kernel (kfac_tpu/ops/pallas_ns.py:203,
// called at :244 by fused_klclip_scale), which the JAX engine runs once per
// layer; here one launch covers the layers of a step.
//
// Bound on an H100: each element read once and written once, one multiply:
// bytes. The flagship's 36 tensors hold 18,902,016 elements, 151.2 MB moved,
// 0.045 ms at 3.35 TB/s.
// Design: the tensor table (source, destination, element count, first
// block) is a kernel parameter, passed by value, so a launch needs no table
// in device memory; more than kMaxTensors tensors take a few launches. Each
// block of 256 threads covers 4096 elements of one tensor and finds it by a
// binary search over the first blocks. The bulk moves as 16-byte float4
// loads and stores: elements are indexed from the 16-byte boundary at or
// before the tensor's start, so an unaligned start and a ragged tail are
// masked element by element. Source and destination share their offset
// from a 16-byte boundary (the launcher refuses a table where they do not).
// A thread loads its four vectors before it stores any, so a destination may
// alias its source (the engine scales in place).

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

const char* kfac_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
