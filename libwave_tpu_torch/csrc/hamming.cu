// Hamming-distance kernels over packed binary descriptors, for Hopper (sm_90a).
//
// Descriptors are rows of W 32-bit words (the port stores the uint32 bit
// patterns in int32 tensors; the kernels read them as uint32). Both kernels
// share one inner loop: XOR a query word with a reference word and count the
// set bits with __popc, W times per (query, reference) pair.
//
// hamming_top2: replaces the Pallas kernel libwave_tpu/ops/hamming.py
// _top2_kernel (wrappers _run_top2, hamming_top2). For every query row it
// returns the smallest distance, the second smallest and the index of the
// first column that reaches the smallest, without writing the (N1, N2)
// table. Columns whose mask2 byte is 0 read 1 << 24. A walk over columns in
// ascending order keeps
//   d < d1: d2 = d1, d1 = d, i1 = j;   else d < d2: d2 = d
// from d1 = d2 = 1 << 24, i1 = 0, which is the Pallas kernel's init and
// tile merge: on a tie the first occurrence is kept and the second-best
// equals the best; a row whose columns are all masked gives (1<<24, 1<<24,
// 0). No atomics: the result does not depend on scheduling.
//
// Design. Each query row's columns are split over a group of L lanes (L a
// power of two, groups aligned to warps): lane l walks the columns l,
// l + L, l + 2L, ... in ascending order with the rule above, from (1<<24,
// 1<<24, 0), and the group folds its lanes' results with warp shuffles (a
// butterfly over xor distances min(L, 32)/2 .. 1), then, for L > 32, its
// warps' results through shared memory, by the Pallas kernel's tile merge:
//   d1 = min(d1a, d1b); i1 from the smaller d1, on equal d1 the smaller
//   column index; d2 = min(d2a, d2b, max(d1a, d1b)),
// which is exact and does not depend on the order of the folds. Each thread
// holds R query rows in registers and uses every reference word it reads
// for all R of them. The bank goes through shared memory in tiles of 256
// rows (128 at W = 32), copied with cp.async (16-byte copies where the bank
// is 16-byte aligned and W % 4 == 0) while the previous tile is walked;
// rows are padded (kStageStride) so that the lanes' 16-byte reads of
// different rows do not collide in a bank. The launch picks one of two
// shapes from N1 (top2_plan): where N1 fills two blocks of 128 threads per
// SM of the device (top2_min_blocks) with 4 rows per thread (2 at W = 32, for registers) and 32
// lanes, that (a 16,384-row bank: 1,024 blocks); else 4 rows of 128 lanes
// in blocks of 512, one row per thread, so that each SM still stages the
// bank once and runs 4 warps per scheduler (a frame's 512 queries: 128
// blocks, 4 columns a lane; 2,048 queries: 512 blocks). bench_designs.py
// times the alternatives: the first version's one thread per row (4 busy
// SMs at 512 queries), the bank read through L1 instead of staged, other
// lane counts and rows per thread.
//
// Bound. N1 * N2 * W XOR+popcount word operations. __popc issues at 16 per
// SM per clock, so the H100 SXM's 132 SMs at their 1.98 GHz maximum clock
// count 4.2e12 words a second: 1.0 us for one 512 x 512 x 16 frame match and
// 1.03 ms for a 16,384 x 16,384 x 16 bank. Reading both banks once takes
// far less (64 KB and 2 MB).
//
// hamming_table: replaces the Pallas kernel libwave_tpu/ops/hamming.py
// _kernel (wrappers _run, hamming_distance_pallas): the full (N1, N2) int32
// table. One block per 32 x 32 output tile, 32 x 8 threads, each thread one
// column and four rows; both operand tiles in shared memory (the reference
// tile padded to W + 1 words a row, so the column reads do not collide in
// one bank), ragged edges masked, and consecutive threads store consecutive
// columns. Bound: the int32 write, 4 * N1 * N2 bytes (67 MB, 20 us at
// 3.35 TB/s for 4,096 x 4,096), next to the same popcount floor (64 us for
// 4,096 x 4,096 x 16; 1.0 us against 0.3 us of bytes for a frame), so at
// W = 16 the popcounts bound it, not the write.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 24;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTop2Threads = 128;        // top-2: threads per block
constexpr int kTop2WideThreads = 512;    // top-2: block of 4 rows x 128 lanes
constexpr int kT = 32;                   // table: output tile edge
constexpr int kTY = 8;                   // table: thread rows per block

// One descriptor row of W words into registers, through the read-only
// cache: 16-byte loads when `vec` (W % 4 == 0 and a 16-byte aligned bank),
// else 4-byte loads.
template <int W>
__device__ __forceinline__ void load_row(uint32_t (&r)[W],
                                         const uint32_t* __restrict__ p,
                                         bool vec) {
  if constexpr (W % 4 == 0) {
    if (vec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const uint4 v = __ldg(p4 + k);
        r[4 * k] = v.x;
        r[4 * k + 1] = v.y;
        r[4 * k + 2] = v.z;
        r[4 * k + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) r[w] = __ldg(p + w);
}

// Shared-memory layout of a staged tile of reference rows: a row stride of
// W + 4 words for W >= 4 (the 16-byte reads of 8 lanes on 8 rows fall in 8
// distinct groups of 4 banks), 3 for W = 2 (odd: 32 lanes, 32 banks), 1 for
// W = 1; 256 rows a tile (128 at W = 32), two tiles (41 KB at W = 16).
template <int W>
constexpr int kStageStride = W >= 4 ? W + 4 : W == 2 ? 3 : 1;
template <int W>
constexpr int kStageRows = W >= 32 ? 128 : 256;

// The Pallas tile merge of two partial top-2s: (b1, b2, i1) takes in
// (o1, o2, oi), the smaller column index on equal bests.
__device__ __forceinline__ void merge_top2(int& b1, int& b2, int& i1, int o1,
                                           int o2, int oi) {
  b2 = min(min(b2, o2), max(b1, o1));
  if (o1 < b1 || (o1 == b1 && oi < i1)) i1 = oi;
  b1 = min(b1, o1);
}

// R query rows per thread, `lanes` lanes per row group (a power of two that
// divides the block of BT threads; a group of more than 32 lanes spans
// whole warps). The reference bank goes through shared memory a tile at a
// time, the next tile's cp.async copies in flight while the current one is
// walked.
template <int W, int R, int BT>
__global__ void __launch_bounds__(BT)
    top2_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
                const unsigned char* __restrict__ mask2, int* __restrict__ best,
                int* __restrict__ second, int* __restrict__ index, int n1,
                int n2, int lanes, bool vec) {
  constexpr int S = kStageStride<W>;
  constexpr int TN = kStageRows<W>;
  __shared__ __align__(16) uint32_t s_ref[2][TN * S];
  __shared__ unsigned char s_live[2][TN];
  __shared__ int s_part[BT / 32][R][3];

  // copy tile t of the bank and its mask into buffer b: one commit group
  auto stage = [&](int t, int b) {
    const int j0 = t * TN;
    const int nt = min(TN, n2 - j0);
    const uint32_t* src = d2 + static_cast<long long>(j0) * W;
    if constexpr (W % 4 == 0) {
      if (vec) {
        for (int i = threadIdx.x; i < nt * (W / 4); i += BT) {
          const int r = i / (W / 4), c = i % (W / 4);
          __pipeline_memcpy_async(&s_ref[b][r * S + 4 * c], src + 4 * i, 16);
        }
      }
    }
    if (W % 4 != 0 || !vec) {
      for (int i = threadIdx.x; i < nt * W; i += BT)
        __pipeline_memcpy_async(&s_ref[b][(i / W) * S + i % W], src + i, 4);
    }
    for (int i = threadIdx.x; i < nt; i += BT)
      s_live[b][i] = mask2 == nullptr ? 1 : mask2[j0 + i];
    __pipeline_commit();
  };

  const int tiles = (n2 + TN - 1) / TN;
  if (tiles > 0) stage(0, 0);

  const int lane = threadIdx.x & (lanes - 1);
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (BT / lanes) +
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
  for (int t = 0; t < tiles; ++t) {
    const int b = t & 1;
    if (t + 1 < tiles) {
      stage(t + 1, b ^ 1);  // its buffer was released after tile t - 1
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // tile t is in shared memory for every thread
    const int j0 = t * TN;
    const int nt = min(TN, n2 - j0);
    for (int jt = lane; jt < nt; jt += lanes) {
      uint32_t c[W];
      if constexpr (W % 4 == 0) {
        const uint4* p = reinterpret_cast<const uint4*>(&s_ref[b][jt * S]);
#pragma unroll
        for (int k = 0; k < W / 4; ++k) {
          const uint4 v = p[k];
          c[4 * k] = v.x;
          c[4 * k + 1] = v.y;
          c[4 * k + 2] = v.z;
          c[4 * k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) c[w] = s_ref[b][jt * S + w];
      }
      const bool live = s_live[b][jt] != 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) d += __popc(q[r][w] ^ c[w]);
        if (!live) d = kBig;
        if (d < b1[r]) {
          b2[r] = b1[r];
          b1[r] = d;
          i1[r] = j0 + jt;
        } else if (d < b2[r]) {
          b2[r] = d;
        }
      }
    }
    __syncthreads();  // tile t consumed: its buffer may be staged again
  }

  for (int o = min(lanes, 32) >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o1 = __shfl_xor_sync(kFullMask, b1[r], o);
      const int o2 = __shfl_xor_sync(kFullMask, b2[r], o);
      const int oi = __shfl_xor_sync(kFullMask, i1[r], o);
      merge_top2(b1[r], b2[r], i1[r], o1, o2, oi);
    }
  }
  if (lanes > 32) {  // the group's warps fold through shared memory
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s_part[warp][r][0] = b1[r];
        s_part[warp][r][1] = b2[r];
        s_part[warp][r][2] = i1[r];
      }
    }
    __syncthreads();
    if (lane < 32) {  // the group's first warp
      for (int v = warp + 1; v < warp + lanes / 32; ++v) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          merge_top2(b1[r], b2[r], i1[r], s_part[v][r][0], s_part[v][r][1],
                     s_part[v][r][2]);
      }
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

struct Top2Plan {
  int rows;     // query rows per thread
  int lanes;    // lanes per row group
  int threads;  // threads per block
};

long long top2_blocks(int n1, Top2Plan p) {
  const int rows_per_block = p.threads / p.lanes * p.rows;
  return (static_cast<long long>(n1) + rows_per_block - 1) / rows_per_block;
}

// Two blocks per SM of the device that is current at the first call (the
// SM count read once).
long long top2_min_blocks() {
  static const long long blocks = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return 2LL * sms;
  }();
  return blocks;
}

// Rows per thread, lanes per row and block size for N1 query rows of W
// words (see the design note at the top of the file).
template <int W>
Top2Plan top2_plan(int n1) {
  const Top2Plan rows{W >= 32 ? 2 : 4, 32, kTop2Threads};
  if (top2_blocks(n1, rows) >= top2_min_blocks()) return rows;
  return Top2Plan{1, kTop2WideThreads / 4, kTop2WideThreads};
}

template <int W, int R, int BT>
int run_top2(const void* d1, const void* d2, const void* mask2, void* best,
             void* second, void* index, int n1, int n2, int lanes,
             cudaStream_t s) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(d1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d2) % 16 == 0;
  const long long blocks = top2_blocks(n1, Top2Plan{R, lanes, BT});
  top2_kernel<W, R, BT><<<static_cast<unsigned>(blocks), BT, 0, s>>>(
      static_cast<const uint32_t*>(d1), static_cast<const uint32_t*>(d2),
      static_cast<const unsigned char*>(mask2), static_cast<int*>(best),
      static_cast<int*>(second), static_cast<int*>(index), n1, n2, lanes, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_top2(const void* d1, const void* d2, const void* mask2, void* best,
                void* second, void* index, int n1, int n2, cudaStream_t s) {
  const Top2Plan p = top2_plan<W>(n1);
  if (p.threads == kTop2WideThreads)
    return run_top2<W, 1, kTop2WideThreads>(d1, d2, mask2, best, second,
                                            index, n1, n2, p.lanes, s);
  return run_top2<W, (W >= 32 ? 2 : 4), kTop2Threads>(
      d1, d2, mask2, best, second, index, n1, n2, p.lanes, s);
}

template <int W>
__global__ void __launch_bounds__(kT * kTY)
    table_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
                 int* __restrict__ out, int n1, int n2) {
  __shared__ uint32_t s_a[kT][W];
  __shared__ uint32_t s_b[kT][W + 1];

  const int r0 = blockIdx.y * kT;
  const int c0 = blockIdx.x * kT;
  const int tid = threadIdx.y * kT + threadIdx.x;
  for (int i = tid; i < kT * W; i += kT * kTY) {
    const int r = i / W, w = i % W;
    s_a[r][w] = r0 + r < n1 ? d1[static_cast<long long>(r0 + r) * W + w] : 0u;
    s_b[r][w] = c0 + r < n2 ? d2[static_cast<long long>(c0 + r) * W + w] : 0u;
  }
  __syncthreads();

  uint32_t b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) b[w] = s_b[threadIdx.x][w];
  const int col = c0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kT / kTY; ++k) {
    const int r = threadIdx.y + k * kTY;
    int d = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) d += __popc(s_a[r][w] ^ b[w]);
    if (r0 + r < n1 && col < n2)
      out[static_cast<long long>(r0 + r) * n2 + col] = d;
  }
}

template <int W>
int launch_table(const void* d1, const void* d2, void* out, int n1, int n2,
                 cudaStream_t s) {
  const dim3 grid((n2 + kT - 1) / kT, (n1 + kT - 1) / kT);
  table_kernel<W><<<grid, dim3(kT, kTY), 0, s>>>(
      static_cast<const uint32_t*>(d1), static_cast<const uint32_t*>(d2),
      static_cast<int*>(out), n1, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes. d1 (n1, w) and d2 (n2, w) 32-bit words,
// mask2 (n2,) bytes or null (every column live), outputs int32; all
// contiguous on one device. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); w must be 1, 2, 4, 8, 16 or 32.

extern "C" int hamming_top2_i32(const void* d1, const void* d2,
                                const void* mask2, void* best, void* second,
                                void* index, int n1, int n2, int w,
                                void* stream) {
  if (n1 <= 0) return 0;
  // the end of the last 256-row tile must not overflow
  if (n2 > 0x7fffffff - 256) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: return launch_top2<1>(d1, d2, mask2, best, second, index, n1, n2, s);
    case 2: return launch_top2<2>(d1, d2, mask2, best, second, index, n1, n2, s);
    case 4: return launch_top2<4>(d1, d2, mask2, best, second, index, n1, n2, s);
    case 8: return launch_top2<8>(d1, d2, mask2, best, second, index, n1, n2, s);
    case 16: return launch_top2<16>(d1, d2, mask2, best, second, index, n1, n2, s);
    case 32: return launch_top2<32>(d1, d2, mask2, best, second, index, n1, n2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int hamming_table_i32(const void* d1, const void* d2, void* out,
                                 int n1, int n2, int w, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  if ((n1 + kT - 1) / kT > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: return launch_table<1>(d1, d2, out, n1, n2, s);
    case 2: return launch_table<2>(d1, d2, out, n1, n2, s);
    case 4: return launch_table<4>(d1, d2, out, n1, n2, s);
    case 8: return launch_table<8>(d1, d2, out, n1, n2, s);
    case 16: return launch_table<16>(d1, d2, out, n1, n2, s);
    case 32: return launch_table<32>(d1, d2, out, n1, n2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
