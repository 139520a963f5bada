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
// table. Columns whose mask2 byte is 0 read 1 << 24. Each thread walks the
// columns in ascending order and keeps
//   d < d1: d2 = d1, d1 = d, i1 = j;   else d < d2: d2 = d
// from d1 = d2 = 1 << 24, i1 = 0, which is the Pallas kernel's init and
// tile merge: on a tie the first occurrence is kept and the second-best
// equals the best; a row whose columns are all masked gives (1<<24, 1<<24,
// 0). No atomics: the result does not depend on scheduling.
//
// Design. One thread per query row, 128 rows per block; the thread holds its
// row's W words in registers (W is a template parameter). The reference bank
// and its mask stream through shared memory in tiles of 256 rows (16 KB at
// W = 16), loaded with coalesced reads; every thread of a warp reads the
// same shared word, a broadcast. The Pallas kernel instead keeps the whole
// bank resident in VMEM and merges 512-column tiles with an iota-min trick;
// nothing of that carries over.
//
// Bound. N1 * N2 * W XOR+popcount word operations. __popc issues at 16 per
// SM per cycle on this architecture, so with 132 SMs at ~1.7 GHz the floor is
// about 3.6e12 word operations per second: 1.2 us for one 512 x 512 x 16
// frame match and 1.2 ms for a 16,384 x 16,384 x 16 bank. A 512-row query
// bank fills only 4 blocks (4 of 132 SMs), so the frame match is bound by
// one thread's serial walk over the 512 columns and by launch latency, not
// by the card; splitting the columns across threads with a merge is the
// next step, left to a later change.
//
// hamming_table: replaces the Pallas kernel libwave_tpu/ops/hamming.py
// _kernel (wrappers _run, hamming_distance_pallas): the full (N1, N2) int32
// table. One block per 32 x 32 output tile, 32 x 8 threads, each thread one
// column and four rows; both operand tiles in shared memory (the reference
// tile padded to W + 1 words a row, so the column reads do not collide in
// one bank), ragged edges masked, and consecutive threads store consecutive
// columns. Bound: the int32 write, 4 * N1 * N2 bytes (67 MB, 20 us at
// 3.35 TB/s for 4,096 x 4,096), next to the same popcount floor (75 us for
// 4,096 x 4,096 x 16), so at W = 16 the popcounts bound it, not the write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 24;
constexpr int kRows = 128;  // top-2: query rows per block, one per thread
constexpr int kTile = 256;  // top-2: reference rows per shared-memory tile
constexpr int kT = 32;      // table: output tile edge
constexpr int kTY = 8;      // table: thread rows per block

template <int W>
__global__ void __launch_bounds__(kRows)
    top2_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
                const unsigned char* __restrict__ mask2, int* __restrict__ best,
                int* __restrict__ second, int* __restrict__ index, int n1,
                int n2) {
  __shared__ __align__(16) uint32_t s_ref[kTile][W];
  __shared__ unsigned char s_live[kTile];

  const int row = blockIdx.x * kRows + threadIdx.x;
  uint32_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w)
    q[w] = row < n1 ? d1[static_cast<long long>(row) * W + w] : 0u;

  int b1 = kBig, b2 = kBig, i1 = 0;
  for (int j0 = 0; j0 < n2; j0 += kTile) {
    const int nt = min(kTile, n2 - j0);
    __syncthreads();  // previous tile fully consumed
    const uint32_t* src = d2 + static_cast<long long>(j0) * W;
    for (int i = threadIdx.x; i < nt * W; i += kRows) s_ref[i / W][i % W] = src[i];
    for (int i = threadIdx.x; i < nt; i += kRows)
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
int launch_top2(const void* d1, const void* d2, const void* mask2, void* best,
                void* second, void* index, int n1, int n2, cudaStream_t s) {
  const dim3 grid((n1 + kRows - 1) / kRows);
  top2_kernel<W><<<grid, kRows, 0, s>>>(
      static_cast<const uint32_t*>(d1), static_cast<const uint32_t*>(d2),
      static_cast<const unsigned char*>(mask2), static_cast<int*>(best),
      static_cast<int*>(second), static_cast<int*>(index), n1, n2);
  return static_cast<int>(cudaGetLastError());
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
