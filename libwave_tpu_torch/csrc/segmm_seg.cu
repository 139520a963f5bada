// Segment reduce and segment broadcast for Hopper (sm_90a).
//
// Replace the Pallas kernels libwave_tpu/ops/segmm.py:_reduce_kernel
// (wrappers _seg_reduce, seg_reduce_onehot) and :_broadcast_kernel
// (_seg_broadcast, seg_broadcast_onehot): the landmark-side crossings of the
// Schur system.
//
//   reduce:    out[c, m] = sum of vals[c, k] over the slots k with id k == m
//   broadcast: out[c, k] = y[c, idx[k]] if 0 <= idx[k] < M, else 0
//
// Design. The Pallas kernels build a one-hot tile in VMEM and run the index
// operation as a K x M matmul on the MXU; that is K*M compares, 6e8 per
// reduce at the headline shape. Here both are index operations again.
//
// The reduce runs over a landmark-sorted order that the caller already
// holds: sigma (K,) lists the slots by landmark and the CSR offsets (M+1,)
// bound each landmark's run in that list. One thread owns one (c, m) output;
// it takes its run kBatch = 8 slots at a time, loading the batch's sigma
// entries and then its vals[c, sigma[p]] gathers before adding any, so that
// 8 independent gathers are in flight per thread, and adds them in slot
// order from zero: no atomics, the result does not depend on scheduling,
// and the plain version in ops/segmm.py, which adds in the same order
// (+0.0 past a run's end, as here), matches bit for bit. A block owns 256
// consecutive landmarks of one channel: where neighbouring landmarks are
// seen by the same poses its gathers share L1 sectors. sigma is read once
// per channel, sequentially within a run, a small share of the traffic
// next to the gathers. Accumulation is in the input type (f32 or f64).
//
// The broadcast is one thread per (c, k): coalesced writes, ids read once
// per channel, the gathered y values come from L2 (y is 120 KB at the
// headline).
//
// Bound. Both are memory bound. The reduce must read vals (C*K values), sigma
// (K ids) and offsets (M+1) and write C*M values: at the headline (C = 3,
// K = 60,000, M = 10,000, f32) about 1.0 MB, 0.3 us at 3.35 TB/s. It cannot
// get there: each gather vals[c, sigma[p]] pulls its own 32-byte sector
// (the slots of one landmark lie in different poses), C*K sectors from L2;
// and at the headline one launch plus the dependent offsets -> sigma -> vals
// round trips take longer than the bytes. A lane group per landmark (8 lanes
// over the run's slots, all channels, a shuffle fold in slot order) and one
// thread per landmark for all channels measured no faster at the headline
// and slower at long runs (bench_seg_designs.py holds them). The broadcast
// reads y and idx and writes C*K values.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // slots of a run whose gathers fly together

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_reduce_sorted_kernel(const T* __restrict__ vals,
                             const int* __restrict__ sigma,
                             const int* __restrict__ offsets,
                             T* __restrict__ out, int K, int M) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (m >= M) return;
  const T* v = vals + static_cast<long long>(c) * K;
  const int begin = offsets[m];
  const int end = offsets[m + 1];
  T acc = T(0);
  for (int p = begin; p < end; p += kBatch) {
    int k[kBatch];
    T x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) k[u] = p + u < end ? sigma[p + u] : -1;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) x[u] = k[u] >= 0 ? v[k[u]] : T(0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += x[u];
  }
  out[static_cast<long long>(c) * M + m] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_broadcast_kernel(const T* __restrict__ y, const int* __restrict__ idx,
                         T* __restrict__ out, int K, int M) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (k >= K) return;
  const int i = idx[k];
  out[static_cast<long long>(c) * K + k] =
      (i >= 0 && i < M) ? y[static_cast<long long>(c) * M + i] : T(0);
}

template <typename T>
int launch_reduce(const void* vals, const void* sigma, const void* offsets,
                  void* out, int C, int K, int M, void* stream) {
  if (C <= 0 || M <= 0) return 0;
  if (C > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((M + kThreads - 1) / kThreads, C);
  seg_reduce_sorted_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(vals), static_cast<const int*>(sigma),
          static_cast<const int*>(offsets), static_cast<T*>(out), K, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_broadcast(const void* y, const void* idx, void* out, int C, int K,
                     int M, void* stream) {
  if (C <= 0 || K <= 0) return 0;
  if (C > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((K + kThreads - 1) / kThreads, C);
  seg_broadcast_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(y), static_cast<const int*>(idx),
          static_cast<T*>(out), K, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes. All arrays contiguous on one device:
// vals (C, K), sigma (K,) int32, offsets (M+1,) int32 non-decreasing with
// offsets[M] <= K, out (C, M); y (C, M), idx (K,) int32, out (C, K).
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int seg_reduce_sorted_f32(const void* vals, const void* sigma,
                                     const void* offsets, void* out, int C,
                                     int K, int M, void* stream) {
  return launch_reduce<float>(vals, sigma, offsets, out, C, K, M, stream);
}

extern "C" int seg_reduce_sorted_f64(const void* vals, const void* sigma,
                                     const void* offsets, void* out, int C,
                                     int K, int M, void* stream) {
  return launch_reduce<double>(vals, sigma, offsets, out, C, K, M, stream);
}

extern "C" int seg_broadcast_f32(const void* y, const void* idx, void* out,
                                 int C, int K, int M, void* stream) {
  return launch_broadcast<float>(y, idx, out, C, K, M, stream);
}

extern "C" int seg_broadcast_f64(const void* y, const void* idx, void* out,
                                 int C, int K, int M, void* stream) {
  return launch_broadcast<double>(y, idx, out, C, K, M, stream);
}
