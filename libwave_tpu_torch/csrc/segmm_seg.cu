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
// The broadcast gives each thread kBcastSlots = 4 consecutive slots and
// every channel, the threads striding over the slots in a grid of at most
// one resident wave (broadcast_wave() blocks of 256): it reads the 4 ids once (one
// 16-byte load), loads the next 4 ids before it gathers, puts all C*4
// gathers of y in flight (y is 120-240 KB at the headline and stays in L1
// and L2) before it stores, and stores each channel's 4 values with one
// 16-byte evict-first store (two for f64), so that the (C, K) output
// streaming through L2 does not push y and the ids out. The channels are
// unrolled for the callers' C = 3 (CG steps, schur_rhs) and C = 6 (the
// preconditioner's Hll^-1 blocks), a loop for any other C. Where K % 4 != 0
// (a row c * K then starts off a 16-byte boundary; VIO's K = 2,538 is one)
// or idx is not 16-byte aligned (a view with a storage offset), the same
// launch takes 4-byte id loads and scalar stores, bounds-checked. Where y
// is larger than kBcastAllChannelBytes the gathers of all channels at once
// lose L1 hits, and the first version's thread per (channel, slot), which
// walks one channel at a time, is faster; the launch takes it there. On
// ba_large's problem (ids ordered by bearing: a pose's ids span ~31% of the
// landmarks) the two cross between 30,000 and 40,000 landmarks at C = 3
// (y 360-480 KB); at its 100,000 landmarks (1.2 MB) the first version
// takes 0.92x the striding kernel's time at C = 3 and 0.89x at C = 6
// (PERF_APPENDIX.md has the other designs' times).
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
// and slower at long runs (PERF_APPENDIX.md). The broadcast
// must read y (C*M values) and idx (K ids) and write C*K values: at the
// headline 1.1 MB, 0.32 us at 3.35 TB/s. There about half of its time is
// the launch floor of a replayed graph; at large K its gathers, one 32-byte
// sector per value where y misses L1, bound it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // slots of a run whose gathers fly together
constexpr int kBcastThreads = 256;  // broadcast: threads per block
constexpr int kBcastSlots = 4;      // broadcast: consecutive slots per thread
// broadcast: the largest y (bytes) for the all-channel kernel, the
// crossover measured on ba_large's problem (see above)
constexpr long long kBcastAllChannelBytes = 384 * 1024;

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

// V ids from 4V-byte aligned memory in one load.
template <int V>
__device__ __forceinline__ void load_ids(int (&id)[V], const int* p) {
  if constexpr (V == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    id[0] = v.x;
    id[1] = v.y;
    id[2] = v.z;
    id[3] = v.w;
  } else if constexpr (V == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    id[0] = v.x;
    id[1] = v.y;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) id[v] = __ldg(p + v);
  }
}

// The ids of the kBcastSlots slots from k0, -1 past K: one 16-byte load on
// the vector path (K % 4 == 0, idx 16-byte aligned), else 4-byte loads.
template <bool kVec>
__device__ __forceinline__ void slot_ids(int (&id)[kBcastSlots],
                                         const int* __restrict__ idx,
                                         long long k0, int K) {
  if (kVec && k0 < K) {
    load_ids<kBcastSlots>(id, idx + k0);
  } else {
#pragma unroll
    for (int v = 0; v < kBcastSlots; ++v)
      id[v] = k0 + v < K ? __ldg(idx + k0 + v) : -1;
  }
}

// The kBcastSlots values of one output row from k0, with evict-first
// (streaming) stores: one 16-byte store for f32 and two for f64 on the
// vector path, bounds-checked scalar stores otherwise.
template <typename T, bool kVec>
__device__ __forceinline__ void store_slots(T* p, const T (&x)[kBcastSlots],
                                            long long k0, int K) {
  static_assert(kBcastSlots == 4, "one float4 or two double2 per row");
  if constexpr (kVec && std::is_same_v<T, float>) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else if constexpr (kVec) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(x[0], x[1]));
    __stcs(reinterpret_cast<double2*>(p + 2), make_double2(x[2], x[3]));
  } else {
#pragma unroll
    for (int v = 0; v < kBcastSlots; ++v)
      if (k0 + v < K) __stcs(p + v, x[v]);
  }
}

// Every channel of kBcastSlots consecutive slots per thread, the threads
// striding over the slots (a grid of at most broadcast_wave() blocks): the next
// slots' ids are loaded before the current slots' C*4 gathers of y. C > 0
// unrolls the channels; C == 0 loops over `channels`.
template <typename T, int C, bool kVec>
__global__ void __launch_bounds__(kBcastThreads)
    seg_broadcast_kernel(const T* __restrict__ y, const int* __restrict__ idx,
                         T* __restrict__ out, int channels, int K, int M) {
  constexpr int V = kBcastSlots;
  const long long stride =
      static_cast<long long>(gridDim.x) * kBcastThreads * V;
  long long k0 =
      (static_cast<long long>(blockIdx.x) * kBcastThreads + threadIdx.x) * V;
  int id[V];
  slot_ids<kVec>(id, idx, k0, K);
  for (; k0 < K; k0 += stride) {
    int next[V];
    slot_ids<kVec>(next, idx, k0 + stride, K);
    auto gather = [&](int c, int v) {
      return id[v] >= 0 && id[v] < M
                 ? __ldg(y + static_cast<long long>(c) * M + id[v])
                 : T(0);
    };
    if constexpr (C > 0) {
      T x[C][V];
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v) x[c][v] = gather(c, v);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        store_slots<T, kVec>(out + static_cast<long long>(c) * K + k0, x[c],
                             k0, K);
    } else {
      for (int c = 0; c < channels; ++c) {
        T x[V];
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = gather(c, v);
        store_slots<T, kVec>(out + static_cast<long long>(c) * K + k0, x, k0,
                             K);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) id[v] = next[v];
  }
}

// The first version's broadcast, one thread per (channel, slot), the
// channel from blockIdx.y: the faster one where y is larger than
// kBcastAllChannelBytes.
template <typename T>
__global__ void __launch_bounds__(kBcastThreads)
    seg_broadcast_per_channel_kernel(const T* __restrict__ y,
                                     const int* __restrict__ idx,
                                     T* __restrict__ out, int K, int M) {
  const long long k =
      static_cast<long long>(blockIdx.x) * kBcastThreads + threadIdx.x;
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

// Blocks of kBcastThreads in one resident wave of the device that is
// current at the first call (its SM count and threads per SM read once).
long long broadcast_wave() {
  static const long long blocks = [] {
    int dev = 0, sms = 0, threads = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
    const long long wave = static_cast<long long>(sms) *
                           (threads / kBcastThreads);
    return wave > 0 ? wave : 1LL;
  }();
  return blocks;
}

long long broadcast_blocks(int K) {
  const long long per_block =
      static_cast<long long>(kBcastThreads) * kBcastSlots;
  const long long need = (K + per_block - 1) / per_block;
  return need < broadcast_wave() ? need : broadcast_wave();
}

// One launch of the all-channel broadcast: the vector path where K and the
// pointers allow it.
template <typename T, int C>
int run_broadcast(const void* y, const void* idx, void* out, int channels,
                  int K, int M, cudaStream_t s) {
  const bool vec = K % kBcastSlots == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>(broadcast_blocks(K));
  const T* yt = static_cast<const T*>(y);
  const int* it = static_cast<const int*>(idx);
  T* ot = static_cast<T*>(out);
  if (vec)
    seg_broadcast_kernel<T, C, true>
        <<<blocks, kBcastThreads, 0, s>>>(yt, it, ot, channels, K, M);
  else
    seg_broadcast_kernel<T, C, false>
        <<<blocks, kBcastThreads, 0, s>>>(yt, it, ot, channels, K, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_broadcast(const void* y, const void* idx, void* out, int C, int K,
                     int M, void* stream) {
  if (C <= 0 || K <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(C) * M * sizeof(T) > kBcastAllChannelBytes) {
    if (C > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(
        static_cast<unsigned>((K + kBcastThreads - 1LL) / kBcastThreads), C);
    seg_broadcast_per_channel_kernel<T><<<grid, kBcastThreads, 0, s>>>(
        static_cast<const T*>(y), static_cast<const int*>(idx),
        static_cast<T*>(out), K, M);
    return static_cast<int>(cudaGetLastError());
  }
  switch (C) {
    case 3: return run_broadcast<T, 3>(y, idx, out, C, K, M, s);
    case 6: return run_broadcast<T, 6>(y, idx, out, C, K, M, s);
    default: return run_broadcast<T, 0>(y, idx, out, C, K, M, s);
  }
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
