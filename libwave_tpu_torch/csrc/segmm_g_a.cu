// Dense-Schur G/A build for Hopper (sm_90a).
//
// Replaces the Pallas kernel libwave_tpu/ops/segmm.py:_g_a_kernel (wrappers
// _dense_g_a and dense_g_a_onehot). For every pose row n and landmark column
// m of one build call it computes
//
//   G[n, c, m] = sum_p W[c, n, p] * [lm_slot[n, p] == m]      c < C = Dj*3
//   A[n, 3d+l, m] = sum_j G[n, 3d+j, m] * Hinv_m[j, l]
//
// with Hinv_m the symmetric 3x3 inverse landmark block given as 6 components
// [00, 01, 02, 11, 12, 22] in hinv (6, M). Duplicate ids sum; ids outside
// [0, M) (chunk and band offsets, the pose-padding id -1) contribute nothing.
// Accumulation is f32, in slot order, without atomics: the result does not
// depend on scheduling, and where a column takes one nonzero slot it equals
// the plain PyTorch version (ops/segmm.py) bit for bit.
//
// Design. One block per (tile of TM columns, pose). The block streams the
// pose's slot ids and its C x Pmax W values through shared memory in chunks
// of PT slots (C*PT floats + PT ids = 19.5 KB at C = 18, PT = 256, so any
// Pmax fits without opt-in shared memory). Each thread owns one column, scans
// the chunk's ids in order and adds the W column of every slot that names
// its column. A chunk whose ids miss the tile entirely is skipped by the
// whole block (__syncthreads_or), the analog of the Pallas kernel's per-tile
// pl.when skip. The epilogue applies the column's 3x3 Hinv to the thread's
// 18 accumulators and writes 18 G and 18 A values, coalesced along m.
//
// Bound. The floor is writing G and A: 2 * N * C * M * 4 bytes. On the
// headline problem (200 poses, 10,000 landmarks, 13 banded calls per LM
// iteration covering 775,120 pose x column cells) that is about 112 MB per
// LM iteration, about 33 us at the H100's 3.35 TB/s. The id scan costs
// Pmax compare-and-branch steps per cell (about 2.3e8 per LM iteration,
// mostly skipped where the tile misses) on the ALUs; W re-reads come from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 256;  // landmark columns per block (one per thread)
constexpr int kPT = 256;  // slots per shared-memory chunk

// Symmetric-3x3 component index of (j, l), both triangles.
__device__ __forceinline__ int sym3_at(int j, int l) {
  const int at[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
  return at[j][l];
}

template <int C>
__global__ void __launch_bounds__(kTM)
    g_a_kernel(const float* __restrict__ W, const int* __restrict__ lm_slot,
               const float* __restrict__ hinv, float* __restrict__ G,
               float* __restrict__ A, int N, int P, int M) {
  static_assert(C % 3 == 0, "rows come in (dj, j) triples");
  __shared__ int s_id[kPT];
  __shared__ float s_w[C][kPT];

  const int n = blockIdx.y;
  const int tile0 = blockIdx.x * kTM;
  const int m = tile0 + threadIdx.x;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  const int* ids = lm_slot + static_cast<long long>(n) * P;
  for (int p0 = 0; p0 < P; p0 += kPT) {
    const int np = min(kPT, P - p0);
    __syncthreads();  // previous chunk fully consumed
    int hit = 0;
    for (int i = threadIdx.x; i < np; i += kTM) {
      const int id = ids[p0 + i];
      s_id[i] = id;
      hit |= (id >= tile0) & (id < tile0 + kTM);
    }
    if (!__syncthreads_or(hit)) continue;  // uniform across the block
    for (int i = threadIdx.x; i < C * np; i += kTM) {
      const int c = i / np;
      const int p = i - c * np;
      s_w[c][p] = W[(static_cast<long long>(c) * N + n) * P + p0 + p];
    }
    __syncthreads();
    for (int p = 0; p < np; ++p) {
      if (s_id[p] == m) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += s_w[c][p];
      }
    }
  }
  if (m >= M) return;

  float h[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) h[k] = hinv[static_cast<long long>(k) * M + m];

  float* g_out = G + static_cast<long long>(n) * C * M + m;
  float* a_out = A + static_cast<long long>(n) * C * M + m;
#pragma unroll
  for (int d = 0; d < C / 3; ++d) {
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const int row = 3 * d + l;
      g_out[static_cast<long long>(row) * M] = acc[row];
      // separately rounded products and sums in j order, never fused into
      // FMAs: A is then bit-identical to the plain version's
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        a = __fadd_rn(a, __fmul_rn(acc[3 * d + j], h[sym3_at(j, l)]));
      a_out[static_cast<long long>(row) * M] = a;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. W (C, N, P) f32, lm_slot (N, P) i32,
// hinv (6, M) f32, G and A (N, C, M) f32, all contiguous on one device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int segmm_g_a_f32(const void* W, const void* lm_slot,
                             const void* hinv, void* G, void* A, int N, int P,
                             int M, int C, void* stream) {
  if (C != 18) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || M <= 0) return 0;
  if (N > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((M + kTM - 1) / kTM, N);
  g_a_kernel<18><<<grid, kTM, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const int*>(lm_slot),
      static_cast<const float*>(hinv), static_cast<float*>(G),
      static_cast<float*>(A), N, P, M);
  return static_cast<int>(cudaGetLastError());
}
