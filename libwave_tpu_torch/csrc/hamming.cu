// Hamming-distance kernels over packed binary descriptors, for Hopper (sm_90a).
//
// Descriptors are rows of W 32-bit words (the port stores the uint32 bit
// patterns in int32 tensors; the kernels read them as uint32). The top-2
// XORs a query word with a reference word and counts the set bits with
// __popc, W times per (query, reference) pair, on the CUDA cores; the table
// counts the bits of a AND b on the tensor cores.
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
// SM of the device (two_blocks_per_sm) with 4 rows per thread (2 at W = 32,
// for registers) and 32 lanes, that (a 16,384-row bank: 1,024 blocks);
// else 4 rows of 128 lanes
// in blocks of 512, one row per thread, so that each SM still stages the
// bank once and runs 4 warps per scheduler (a frame's 512 queries: 128
// blocks, 4 columns a lane; 2,048 queries: 512 blocks). The alternatives
// timed against it (PERF_APPENDIX.md): the first version's one thread per
// row (4 busy SMs at 512 queries), the bank read through L1 instead of
// staged, other lane counts and rows per thread.
//
// Bound. N1 * N2 * W XOR+popcount word operations. __popc issues at 16 per
// SM per clock, so the H100 SXM's 132 SMs at their 1.98 GHz maximum clock
// count 4.2e12 words a second: 1.0 us for one 512 x 512 x 16 frame match and
// 1.03 ms for a 16,384 x 16,384 x 16 bank. Reading both banks once takes
// far less (64 KB and 2 MB).
//
// hamming_table: replaces the Pallas kernel libwave_tpu/ops/hamming.py
// _kernel (wrappers _run, hamming_distance_pallas): the full (N1, N2) int32
// table, as a 1-bit matrix product on the tensor cores. With
//   popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b),
// the sum over a descriptor's words of popc(a & b) is a single-bit matrix
// product: mma.sync m16n8k256 .b1 with .and.popc accumulates it in s32
// fragments, 256 bits of k per instruction. Each block of 4 warps takes one
// 64 x 64 output tile (each warp 32 x 32), stages its A and B rows in
// shared memory with cp.async (rows padded to W + 4 words, so that the
// fragment loads of 8 rows x 4 words hit 32 distinct banks), counts the
// rows' bits there, runs the products and writes pa[i] + pb[j] - 2 acc
// with 16-byte streaming stores (where N2 % 4 == 0; the fragment pairs of
// two lanes are swapped so that each lane holds 4 consecutive columns of
// one row). W < 8 pads k with zero words, which
// change neither the AND counts nor pa and pb. Integer arithmetic
// throughout: the table equals the plain version exactly.
//
// Bound. The write of 4 N1 N2 bytes: 67 MB, 20 us at 3.35 TB/s for 4,096 x
// 4,096 (the two banks are 0.5 MB). The tensor cores' rate on .b1 is not
// in the H100 data sheet; it was measured at 1.03e16 operations a second
// on an H100 SXM at 700 W (an AND and an add per bit pair;
// PERF_APPENDIX.md), so the products take 1.7 us there: the write bounds
// the table. The first version (one block per 32 x 32 tile, XOR + POPC on
// the CUDA cores) could at best reach the popcount issue rate above: 64 us
// at 4,096 x 4,096 x 16. One tile shape ships: the matcher's tables are at
// most a frame's 512 x 512, where 64-tiles fill the SMs; 128 x 128 tiles
// of 8 warps wrote large tables (4,096^2 and up) about 8% faster.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 24;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kTop2Threads = 128;        // top-2: threads per block
constexpr int kTop2WideThreads = 512;    // top-2: block of 4 rows x 128 lanes
constexpr int kTableTile = 64;           // table: output tile edge

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
long long two_blocks_per_sm() {
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
  if (top2_blocks(n1, rows) >= two_blocks_per_sm()) return rows;
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

// Table: k padded to whole 256-bit steps, and the shared row stride.
template <int W>
constexpr int kTableWords = W < 8 ? 8 : W;
template <int W>
constexpr int kTableStride = kTableWords<W> + 4;

// D += popc(A & B) over 256 bits of k: A 16 x 256 (row), B 256 x 8 (col),
// D 16 x 8 s32. Lane (g = lane / 4, t = lane % 4) holds A words (rows g,
// g + 8; words t, t + 4 of the step), B words (column g; words t, t + 4)
// and D (rows g, g + 8; columns 2t, 2t + 1).
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [r0, r0 + R) of a bank of W-word rows into shared memory at the
// table's row stride, by cp.async; rows past n are zero. One commit group
// is left to the caller.
template <int W, int R, int T>
__device__ __forceinline__ void stage_rows(uint32_t* s,
                                           const uint32_t* __restrict__ d,
                                           int r0, int n, bool vec) {
  constexpr int S = kTableStride<W>;
  if constexpr (W % 4 == 0) {
    if (vec) {
      for (int i = threadIdx.x; i < R * (W / 4); i += T) {
        const int r = i / (W / 4), c = 4 * (i % (W / 4));
        uint32_t* dst = s + r * S + c;
        if (r0 + r < n)
          __pipeline_memcpy_async(
              dst, d + static_cast<long long>(r0 + r) * W + c, 16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < R * W; i += T) {
    const int r = i / W, c = i % W;
    if (r0 + r < n)
      __pipeline_memcpy_async(s + r * S + c,
                              d + static_cast<long long>(r0 + r) * W + c, 4);
    else
      s[r * S + c] = 0u;
  }
}

// One BM x BN output tile per block, WM x WN warps (see the design note at
// the top of the file). The grid is one-dimensional: tile (blockIdx.x /
// tiles_n, blockIdx.x % tiles_n).
template <int W, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
    table_kernel(const uint32_t* __restrict__ d1,
                 const uint32_t* __restrict__ d2, int* __restrict__ out,
                 int n1, int n2, int tiles_n, bool vec_in, bool vec_out) {
  constexpr int KW = kTableWords<W>;
  constexpr int S = kTableStride<W>;
  constexpr int T = WM * WN * 32;
  constexpr int MT = BM / WM / 16;  // m16 tiles per warp
  constexpr int NT = BN / WN / 8;   // n8 tiles per warp
  __shared__ __align__(16) uint32_t s_a[BM * S];
  __shared__ __align__(16) uint32_t s_b[BN * S];
  __shared__ int s_pa[BM];
  __shared__ int s_pb[BN];

  const int r0 = (blockIdx.x / tiles_n) * BM;
  const int c0 = (blockIdx.x % tiles_n) * BN;
  stage_rows<W, BM, T>(s_a, d1, r0, n1, vec_in);
  stage_rows<W, BN, T>(s_b, d2, c0, n2, vec_in);
  __pipeline_commit();
  if constexpr (KW > W) {  // the k padding: zero words
    for (int i = threadIdx.x; i < (BM + BN) * (KW - W); i += T) {
      const int r = i / (KW - W), c = W + i % (KW - W);
      (r < BM ? s_a + r * S : s_b + (r - BM) * S)[c] = 0u;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int i = threadIdx.x; i < BM + BN; i += T) {
    const uint32_t* row = i < BM ? s_a + i * S : s_b + (i - BM) * S;
    int p = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) p += __popc(row[w]);
    (i < BM ? s_pa[i] : s_pb[i - BM]) = p;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WN) * (BM / WM);  // the warp's first tile row
  const int wc = (warp % WN) * (BN / WN);  // and column
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
#pragma unroll
  for (int k0 = 0; k0 < KW; k0 += 8) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t* p = s_a + (wr + 16 * i + g) * S + k0 + t;
      a[i][0] = p[0];
      a[i][1] = p[8 * S];
      a[i][2] = p[4];
      a[i][3] = p[8 * S + 4];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t* p = s_b + (wc + 8 * j + g) * S + k0 + t;
      b[j][0] = p[0];
      b[j][1] = p[4];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_and_popc(acc[i][j], a[i], b[j]);
  }

  // lanes 2u and 2u + 1 swap halves: the even lane then holds row g,
  // columns 4 (t / 2) .. + 3; the odd lane row g + 8, the same columns
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int* c = acc[i][j];
      const int x0 = __shfl_xor_sync(kFullMask, odd ? c[0] : c[2], 1);
      const int x1 = __shfl_xor_sync(kFullMask, odd ? c[1] : c[3], 1);
      const int v[4] = {odd ? x0 : c[0], odd ? x1 : c[1],
                        odd ? c[2] : x0, odd ? c[3] : x1};
      const int lr = wr + 16 * i + g + (odd ? 8 : 0);
      const int lc = wc + 8 * j + 2 * (t & 2);
      const int row = r0 + lr, col = c0 + lc;
      if (row >= n1) continue;
      const int pa = s_pa[lr];
      int o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = pa + s_pb[lc + k] - 2 * v[k];
      int* dst = out + static_cast<long long>(row) * n2 + col;
      if (vec_out && col + 3 < n2) {
        __stcs(reinterpret_cast<int4*>(dst), make_int4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + k < n2) __stcs(dst + k, o[k]);
      }
    }
  }
}

// The table_kernel of tile shape BM x BN over WM x WN warps on an n1 x n2
// table: 16-byte loads and stores where the pointers and W, N2 allow.
template <int W, int BM, int BN, int WM, int WN>
int run_table(const void* d1, const void* d2, void* out, int n1, int n2,
              cudaStream_t s) {
  const long long blocks =
      static_cast<long long>((n1 + BM - 1) / BM) * ((n2 + BN - 1) / BN);
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_in = W % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(d1) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(d2) % 16 == 0;
  const bool vec_out = n2 % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  table_kernel<W, BM, BN, WM, WN>
      <<<static_cast<unsigned>(blocks), WM * WN * 32, 0, s>>>(
          static_cast<const uint32_t*>(d1), static_cast<const uint32_t*>(d2),
          static_cast<int*>(out), n1, n2, (n2 + BN - 1) / BN, vec_in,
          vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_table(const void* d1, const void* d2, void* out, int n1, int n2,
                 cudaStream_t s) {
  return run_table<W, kTableTile, kTableTile, 2, 2>(d1, d2, out, n1, n2, s);
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
