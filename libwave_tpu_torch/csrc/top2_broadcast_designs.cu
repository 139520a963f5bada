// Other designs of the Hamming top-2 and the segment broadcast, kept to be
// timed against the ones csrc/hamming.cu and csrc/segmm_seg.cu ship
// (bench_designs.py). Both shipped sources are included, so that the split
// top-2 runs here at any lane count, rows per thread and block size from
// the code that ships, and the broadcast designs share its id loads and
// stores. Each design computes its kernel's contract exactly.
//
// top2_design_w16 (W = 16 words, the BRISK descriptor):
//   0  the first version: one thread per query row, 128 rows per block,
//      the bank streamed through shared memory in 256-row tiles, every
//      thread of a warp reading the same shared word
//   1  the shipped split kernel at 1 row per thread and `lanes` lanes a row
//      (64 lanes: blocks of 256 threads, 128: blocks of 512)
//   2  the shipped split kernel at 4 rows per thread and `lanes` lanes a row
//   3  an empty kernel over the shipped launch's grid: the floor of one
//      launch in a replayed CUDA graph
//   4  the split kernel with the reference rows read through L1 instead of
//      staged in shared memory, 1 row per thread, `lanes` lanes a row
//   5  the same at 4 rows per thread
// broadcast_design_f32 (f32, C = 3 or 6, K % 4 == 0 and 16-byte aligned ids,
// as at every timed shape; V slots per thread, blocks of B threads):
//   0  the first version, one thread per (channel, slot), blocks of 256,
//      the ids read once per channel (the shipped launch's path for a y
//      larger than 384 KB)
//   1  every channel of V = 4 slots per thread, B = 64: the planned
//      redesign, one thread per 4 slots and no striding
//   2  the same at B = 256      3  the same at V = 1, B = 256
//   4  one channel of V = 2 slots per thread, the channel from blockIdx.y
//      (the first version's channel-major order), B = 256
//   5  the shipped all-channel kernel (V = 4, B = 256, a grid of one
//      resident wave striding over the slots, the next ids loaded ahead)
//      with plain stores instead of evict-first ones
//   6  the same with evict-first stores and the gathers of y cached in L2
//      only
//   7  an empty kernel over the shipped kernel's grid
//   8  the first version with the ids loaded evict-first; 9  the shipped
//      striding kernel with the ids loaded evict-first
//   10 the shipped all-channel striding kernel at any size of y (the
//      shipped launch takes design 0 for a y larger than 384 KB)

#include "hamming.cu"
#include "segmm_seg.cu"

namespace {

constexpr int kFirstRows = 128;  // first top-2: query rows per block
constexpr int kFirstTile = 256;  // first top-2: reference rows per tile

template <int W>
__global__ void __launch_bounds__(kFirstRows)
    top2_row_per_thread(const uint32_t* __restrict__ d1,
                        const uint32_t* __restrict__ d2,
                        const unsigned char* __restrict__ mask2,
                        int* __restrict__ best, int* __restrict__ second,
                        int* __restrict__ index, int n1, int n2) {
  __shared__ __align__(16) uint32_t s_ref[kFirstTile][W];
  __shared__ unsigned char s_live[kFirstTile];

  const int row = blockIdx.x * kFirstRows + threadIdx.x;
  uint32_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w)
    q[w] = row < n1 ? d1[static_cast<long long>(row) * W + w] : 0u;

  int b1 = kBig, b2 = kBig, i1 = 0;
  for (int j0 = 0; j0 < n2; j0 += kFirstTile) {
    const int nt = min(kFirstTile, n2 - j0);
    __syncthreads();  // previous tile fully consumed
    const uint32_t* src = d2 + static_cast<long long>(j0) * W;
    for (int i = threadIdx.x; i < nt * W; i += kFirstRows)
      s_ref[i / W][i % W] = src[i];
    for (int i = threadIdx.x; i < nt; i += kFirstRows)
      s_live[i] = mask2 == nullptr ? 1 : mask2[j0 + i];
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d += __popc(q[w] ^ s_ref[j][w]);
      if (!s_live[j]) d = kBig;
      if (d < b1) {
        b2 = b1;
        b1 = d;
        i1 = j0 + j;
      } else if (d < b2) {
        b2 = d;
      }
    }
  }
  if (row < n1) {
    best[row] = b1;
    second[row] = b2;
    index[row] = i1;
  }
}

// The split kernel's first form: the shipped lanes, rows per thread and
// merge, the reference rows read straight through L1 with the next
// column's words in flight instead of staged in shared memory.
template <int W, int R>
__global__ void __launch_bounds__(kTop2Threads)
    top2_l1_loads(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
                const unsigned char* __restrict__ mask2, int* __restrict__ best,
                int* __restrict__ second, int* __restrict__ index, int n1,
                int n2, int lanes, bool vec) {
  const int lane = threadIdx.x & (lanes - 1);
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (kTop2Threads / lanes) +
       threadIdx.x / lanes) * R;
  uint32_t q[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r < n1) {
      load_row<W>(q[r], d1 + (row0 + r) * W, vec);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) q[r][w] = 0u;
    }
  }
  int b1[R], b2[R], i1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    b1[r] = kBig;
    b2[r] = kBig;
    i1[r] = 0;
  }

  // every thread walks its columns (rows past n1 too): the whole warp
  // reaches the shuffles below
  uint32_t cur[W], nxt[W] = {};
  bool live = false, live_nxt = false;
  int j = lane;
  if (j < n2) {
    load_row<W>(cur, d2 + static_cast<long long>(j) * W, vec);
    live = mask2 == nullptr || mask2[j] != 0;
  }
  for (; j < n2; j += lanes) {
    const int jn = j + lanes;
    if (jn < n2) {
      load_row<W>(nxt, d2 + static_cast<long long>(jn) * W, vec);
      live_nxt = mask2 == nullptr || mask2[jn] != 0;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d += __popc(q[r][w] ^ cur[w]);
      if (!live) d = kBig;
      if (d < b1[r]) {
        b2[r] = b1[r];
        b1[r] = d;
        i1[r] = j;
      } else if (d < b2[r]) {
        b2[r] = d;
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) cur[w] = nxt[w];
    live = live_nxt;
  }

  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ob1 = __shfl_xor_sync(kFullMask, b1[r], o);
      const int ob2 = __shfl_xor_sync(kFullMask, b2[r], o);
      const int oi1 = __shfl_xor_sync(kFullMask, i1[r], o);
      b2[r] = min(min(b2[r], ob2), max(b1[r], ob1));
      if (ob1 < b1[r] || (ob1 == b1[r] && oi1 < i1[r])) i1[r] = oi1;
      b1[r] = min(b1[r], ob1);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == r % lanes && row0 + r < n1) {
      best[row0 + r] = b1[r];
      second[row0 + r] = b2[r];
      index[row0 + r] = i1[r];
    }
  }
}

// V values of one output row with plain (not evict-first) stores.
template <int V>
__device__ __forceinline__ void store_plain(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// Every channel of V consecutive slots per thread, one pass (no striding).
template <int C, int V, int B>
__global__ void __launch_bounds__(B)
    broadcast_all_channels(const float* __restrict__ y,
                           const int* __restrict__ idx,
                           float* __restrict__ out, int K, int M) {
  const long long k0 =
      (static_cast<long long>(blockIdx.x) * B + threadIdx.x) * V;
  if (k0 >= K) return;
  int id[V];
  load_ids<V>(id, idx + k0);
  float x[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      x[c][v] = id[v] >= 0 && id[v] < M
                    ? __ldg(y + static_cast<long long>(c) * M + id[v])
                    : 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    store_plain<V>(out + static_cast<long long>(c) * K + k0, x[c]);
}

// V consecutive slots of one channel per thread, the channel from
// blockIdx.y.
template <int V, int B>
__global__ void __launch_bounds__(B)
    broadcast_channel_major(const float* __restrict__ y,
                            const int* __restrict__ idx,
                            float* __restrict__ out, int K, int M) {
  const long long k0 =
      (static_cast<long long>(blockIdx.x) * B + threadIdx.x) * V;
  if (k0 >= K) return;
  const int c = blockIdx.y;
  int id[V];
  load_ids<V>(id, idx + k0);
  float x[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    x[v] = id[v] >= 0 && id[v] < M
               ? __ldg(y + static_cast<long long>(c) * M + id[v])
               : 0.f;
  store_plain<V>(out + static_cast<long long>(c) * K + k0, x);
}

// The shipped all-channel kernel's striding (V = 4) with plain stores
// (kL2Only false), or with evict-first stores and y read through L2 only.
template <int C, bool kL2Only>
__global__ void __launch_bounds__(kBcastThreads)
    broadcast_striding(const float* __restrict__ y, const int* __restrict__ idx,
                       float* __restrict__ out, int K, int M) {
  constexpr int V = kBcastSlots;
  const long long stride =
      static_cast<long long>(gridDim.x) * kBcastThreads * V;
  long long k0 =
      (static_cast<long long>(blockIdx.x) * kBcastThreads + threadIdx.x) * V;
  int id[V];
  slot_ids<true>(id, idx, k0, K);
  for (; k0 < K; k0 += stride) {
    int next[V];
    slot_ids<true>(next, idx, k0 + stride, K);
    float x[C][V];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float* g = y + static_cast<long long>(c) * M + id[v];
        x[c][v] = !(id[v] >= 0 && id[v] < M) ? 0.f
                  : kL2Only                  ? __ldcg(g)
                                             : __ldg(g);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* o = out + static_cast<long long>(c) * K + k0;
      if constexpr (kL2Only)
        store_slots<float, true>(o, x[c], k0, K);
      else
        store_plain<V>(o, x[c]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) id[v] = next[v];
  }
}

// The first version's kernel (kStriding false) or the shipped striding
// kernel with the ids loaded evict-first, so that they do not push y out of
// L1.
template <int C, bool kStriding>
__global__ void __launch_bounds__(kBcastThreads)
    broadcast_streamed_ids(const float* __restrict__ y,
                           const int* __restrict__ idx,
                           float* __restrict__ out, int K, int M) {
  if constexpr (!kStriding) {
    const long long k =
        static_cast<long long>(blockIdx.x) * kBcastThreads + threadIdx.x;
    const int c = blockIdx.y;
    if (k >= K) return;
    const int i = __ldcs(idx + k);
    out[static_cast<long long>(c) * K + k] =
        (i >= 0 && i < M) ? y[static_cast<long long>(c) * M + i] : 0.f;
  } else {
    constexpr int V = kBcastSlots;
    const long long stride =
        static_cast<long long>(gridDim.x) * kBcastThreads * V;
    long long k0 =
        (static_cast<long long>(blockIdx.x) * kBcastThreads + threadIdx.x) * V;
    auto ids = [&](int (&id)[V], long long k) {
      if (k < K) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(idx + k));
        id[0] = v.x;
        id[1] = v.y;
        id[2] = v.z;
        id[3] = v.w;
      }
    };
    int id[V];
    ids(id, k0);
    for (; k0 < K; k0 += stride) {
      int next[V];
      ids(next, k0 + stride);
      float x[C][V];
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          x[c][v] = id[v] >= 0 && id[v] < M
                        ? __ldg(y + static_cast<long long>(c) * M + id[v])
                        : 0.f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        store_slots<float, true>(out + static_cast<long long>(c) * K + k0,
                                 x[c], k0, K);
#pragma unroll
      for (int v = 0; v < V; ++v) id[v] = next[v];
    }
  }
}

__global__ void empty_kernel(int* out) {
  if (threadIdx.x > 1024) out[0] = 0;  // never: keeps the parameter live
}

template <int C>
int broadcast_design(int design, const float* y, const int* idx, float* out,
                     int K, int M, cudaStream_t s) {
  const unsigned wave = static_cast<unsigned>(broadcast_blocks(K));
  const unsigned blocks256 = static_cast<unsigned>((K + 255LL) / 256);
  switch (design) {
    case 0:
      seg_broadcast_per_channel_kernel<float>
          <<<dim3(blocks256, C), kBcastThreads, 0, s>>>(y, idx, out, K, M);
      break;
    case 1:
      broadcast_all_channels<C, 4, 64>
          <<<static_cast<unsigned>((K / 4 + 63LL) / 64), 64, 0, s>>>(
              y, idx, out, K, M);
      break;
    case 2:
      broadcast_all_channels<C, 4, 256>
          <<<static_cast<unsigned>((K / 4 + 255LL) / 256), 256, 0, s>>>(
              y, idx, out, K, M);
      break;
    case 3:
      broadcast_all_channels<C, 1, 256><<<blocks256, 256, 0, s>>>(y, idx, out,
                                                                  K, M);
      break;
    case 4:
      broadcast_channel_major<2, 256>
          <<<dim3(static_cast<unsigned>((K / 2 + 255LL) / 256), C), 256, 0,
              s>>>(y, idx, out, K, M);
      break;
    case 5:
      broadcast_striding<C, false><<<wave, kBcastThreads, 0, s>>>(y, idx, out,
                                                                  K, M);
      break;
    case 6:
      broadcast_striding<C, true><<<wave, kBcastThreads, 0, s>>>(y, idx, out,
                                                                 K, M);
      break;
    case 8:
      broadcast_streamed_ids<C, false>
          <<<dim3(blocks256, C), kBcastThreads, 0, s>>>(y, idx, out, K, M);
      break;
    case 9:
      broadcast_streamed_ids<C, true><<<wave, kBcastThreads, 0, s>>>(
          y, idx, out, K, M);
      break;
    case 10:
      return run_broadcast<float, C>(y, idx, out, C, K, M, s);
    default:
      empty_kernel<<<wave, kBcastThreads, 0, s>>>(reinterpret_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes: the designs listed above, on the
// shipped kernels' arguments. Each returns cudaGetLastError() (0 on
// success).
extern "C" int top2_design_w16(int design, int lanes, const void* d1,
                               const void* d2, const void* mask2, void* best,
                               void* second, void* index, int n1, int n2,
                               void* stream) {
  if (n1 <= 0 || design < 0 || design > 5 || lanes < 1 ||
      lanes > (design == 1 ? 128 : 32) ||
      (lanes & (lanes - 1)) != 0 || n2 > 0x7fffffff - 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(d1);
  const uint32_t* b = static_cast<const uint32_t*>(d2);
  const unsigned char* m = static_cast<const unsigned char*>(mask2);
  int* o1 = static_cast<int*>(best);
  int* o2 = static_cast<int*>(second);
  int* oi = static_cast<int*>(index);
  const bool vec = reinterpret_cast<uintptr_t>(d1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d2) % 16 == 0;
  switch (design) {
    case 0:
      top2_row_per_thread<16><<<(n1 + kFirstRows - 1) / kFirstRows, kFirstRows, 0,
                                s>>>(a, b, m, o1, o2, oi, n1, n2);
      break;
    case 1:
      if (lanes == 64)
        return run_top2<16, 1, 256>(d1, d2, mask2, best, second, index, n1,
                                    n2, lanes, s);
      if (lanes == 128)
        return run_top2<16, 1, 512>(d1, d2, mask2, best, second, index, n1,
                                    n2, lanes, s);
      return run_top2<16, 1, kTop2Threads>(d1, d2, mask2, best, second, index,
                                           n1, n2, lanes, s);
    case 2:
      return run_top2<16, 4, kTop2Threads>(d1, d2, mask2, best, second, index,
                                           n1, n2, lanes, s);
    case 3: {
      const Top2Plan p = top2_plan<16>(n1);
      empty_kernel<<<static_cast<unsigned>(top2_blocks(n1, p)), p.threads, 0,
                     s>>>(o1);
      break;
    }
    case 4:
      top2_l1_loads<16, 1><<<static_cast<unsigned>(
                                 top2_blocks(n1, Top2Plan{1, lanes, kTop2Threads})),
                             kTop2Threads, 0, s>>>(a, b, m, o1, o2, oi, n1,
                                                   n2, lanes, vec);
      break;
    default:
      top2_l1_loads<16, 4><<<static_cast<unsigned>(
                                 top2_blocks(n1, Top2Plan{4, lanes, kTop2Threads})),
                             kTop2Threads, 0, s>>>(a, b, m, o1, o2, oi, n1,
                                                   n2, lanes, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int broadcast_design_f32(int design, const void* y,
                                    const void* idx, void* out, int C, int K,
                                    int M, void* stream) {
  if ((C != 3 && C != 6) || K <= 0 || K % 4 != 0 || M <= 0 || design < 0 ||
      design > 10 || reinterpret_cast<uintptr_t>(idx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yt = static_cast<const float*>(y);
  const int* it = static_cast<const int*>(idx);
  float* ot = static_cast<float*>(out);
  return C == 3 ? broadcast_design<3>(design, yt, it, ot, K, M, s)
                : broadcast_design<6>(design, yt, it, ot, K, M, s);
}
