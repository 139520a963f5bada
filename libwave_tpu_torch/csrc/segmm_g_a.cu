// Dense-Schur G/A build for Hopper (sm_90a).
//
// Replaces the Pallas kernel libwave_tpu/ops/segmm.py:_g_a_kernel (wrappers
// _dense_g_a and dense_g_a_onehot). For the pose rows n in [plo, phi) and the
// landmark columns m in [c0, c1) of one build call (a band, a chunk or the
// whole system) it computes
//
//   G[n, c, m] = sum_p W[c, n, p] * [slot (n, p) lies in landmark m's run]
//   A[n, 3d+l, m] = sum_j G[n, 3d+j, m] * Hinv_m[j, l]
//
// for c < C = Dj*3 = 18, with Hinv_m the symmetric 3x3 inverse landmark
// block given as 6 components [00, 01, 02, 11, 12, 22] in hinv (6, M).
// Outputs are (phi - plo, C, c1 - c0), rows ordered (dj, j), every cell
// written (zeros where a pose does not see a column).
//
// The slots come from the landmark-sorted layout the caller already holds:
// sigma (N*Pmax,) lists the slots by landmark and the CSR offsets (M+1,)
// bound each landmark's run; within a run the slots ascend, so the slots of
// one (pose, landmark) pair are one contiguous sub-run. A slot the layout
// leaves out of every run contributes nothing: the layouts built by the
// package leave out only slots of zero weight, whose W is exactly zero.
// Sums are f32, in slot order, from zero, without atomics: the result does
// not depend on scheduling, and where a cell takes one nonzero slot it
// equals the plain PyTorch version (ops/segmm.py) bit for bit.
//
// Design. The work is driven by the runs, not by a scan of every pose's
// slots: one block per tile of kTP poses x kTC columns, one thread per
// (column, row triple d). The thread finds the first slot of its column's
// run at or after the tile's first pose (a binary search over the run),
// then walks the run until the tile's last pose, kBatch slots at a time so
// that their id and W loads are in flight together, and adds each slot's
// three W values into its own cells of a shared-memory G tile. It then
// forms its three A values per pose from its G cells and Hinv (products and
// sums separately rounded, in j order: the plain version's order) into a
// shared A tile. Cells of poses that do not see the column keep the zero
// the thread wrote first. After one barrier the block stores both tiles
// with 16-byte coalesced stores (4-byte stores where c1 - c0 is not a
// multiple of 4, so rows are not 16-byte aligned). Work per call is
// O(slots in the window + output), not O(cells x Pmax) as a per-cell scan
// of the pose's ids would be.
//
// Bound. The floor is writing G and A: 2 * C * cells * 4 bytes. On the
// headline problem (200 poses, 10,000 landmarks, 13 banded calls per LM
// iteration covering 775,120 pose x column cells) that is about 112 MB per
// LM iteration, about 33 us at the H100's 3.35 TB/s; the slots read are
// about 4% of it. Tiles of 4 poses x 32 columns give a band call of ~58
// poses x 1,024 columns 480 blocks of 192 threads, several per SM, so one
// block's stores overlap other blocks' walks; the two tiles take 18 KB of
// shared memory, no opt-in. Tiles of 8 poses measured slower on the card:
// half the blocks, each walking and storing twice as long.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 18;                 // rows per pose: Dj*3 with Dj = 6
constexpr int kTP = 4;                 // poses per tile
constexpr int kTC = 32;                // landmark columns per tile
constexpr int kThreads = kTC * kC / 3;  // one thread per (column, triple)
constexpr int kBatch = 4;              // slots whose loads fly together
constexpr int kTile = kTP * kC * kTC;  // floats in one output's tile

// Symmetric-3x3 component index of (j, l), both triangles.
__device__ __forceinline__ int sym3_at(int j, int l) {
  const int at[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
  return at[j][l];
}

__global__ void __launch_bounds__(kThreads)
    g_a_window_kernel(const float* __restrict__ W,
                      const int* __restrict__ sigma,
                      const int* __restrict__ offsets,
                      const float* __restrict__ hinv, float* __restrict__ G,
                      float* __restrict__ A, int N, int P, int M, int c0,
                      int c1, int plo, int phi) {
  __shared__ __align__(16) float s_g[kTile];  // [pose][row][column]
  __shared__ __align__(16) float s_a[kTile];

  const int mc = c1 - c0;
  const int col0 = blockIdx.x * kTC;  // window-relative
  const int pose0 = blockIdx.y * kTP;
  const int nc = min(kTC, mc - col0);
  const int np = min(kTP, (phi - plo) - pose0);
  const int tc = threadIdx.x % kTC;
  const int d = threadIdx.x / kTC;  // rows 3d, 3d+1, 3d+2

  if (tc < nc) {
    const int m = c0 + col0 + tc;
    float h[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) h[k] = hinv[static_cast<long long>(k) * M + m];

    // this thread's cells: (pose nl, row 3d+j) at cell[(nl*kC + j)*kTC]
    float* g_cell = s_g + 3 * d * kTC + tc;
    float* a_cell = s_a + 3 * d * kTC + tc;
    for (int nl = 0; nl < np; ++nl) {
#pragma unroll
      for (int j = 0; j < 3; ++j) g_cell[(nl * kC + j) * kTC] = 0.f;
    }

    const int first = plo + pose0;  // the tile's first pose
    const int slot_lo = first * P;
    const int slot_hi = slot_lo + np * P;
    const int end = offsets[m + 1];
    int lo = offsets[m];
    int hi = end;
    while (lo < hi) {  // first slot of the run at or after slot_lo
      const int mid = (lo + hi) >> 1;
      if (sigma[mid] < slot_lo) lo = mid + 1; else hi = mid;
    }
    const long long np_all = static_cast<long long>(N) * P;
    const float* w = W + 3 * d * np_all;
    for (int p = lo; p < end; p += kBatch) {
      int s[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        s[u] = p + u < end ? sigma[p + u] : slot_hi;
      float v[kBatch][3];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          v[u][j] = s[u] < slot_hi ? w[j * np_all + s[u]] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s[u] < slot_hi) {
          const int nl = s[u] / P - first;
#pragma unroll
          for (int j = 0; j < 3; ++j) g_cell[(nl * kC + j) * kTC] += v[u][j];
        }
      }
      if (s[kBatch - 1] >= slot_hi) break;
    }

    for (int nl = 0; nl < np; ++nl) {
      float g[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = g_cell[(nl * kC + j) * kTC];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        // separately rounded products and sums in j order, never fused into
        // FMAs: A is then bit-identical to the plain version's
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          a = __fadd_rn(a, __fmul_rn(g[j], h[sym3_at(j, l)]));
        a_cell[(nl * kC + l) * kTC] = a;
      }
    }
  }
  __syncthreads();

  // the tile's rows (pose nl, row c) are rows pose0*kC + nl*kC + c of the
  // (phi - plo) * kC rows of G and A, each mc floats long
  const long long base = static_cast<long long>(pose0) * kC * mc + col0;
  float* g_out = G + base;
  float* a_out = A + base;
  const int rows = np * kC;
  if ((mc & 3) == 0) {  // rows 16-byte aligned, nc a multiple of 4
    constexpr int kQuads = kTC / 4;
    for (int i = threadIdx.x; i < rows * kQuads; i += kThreads) {
      const int row = i / kQuads;
      const int q = i % kQuads;
      if (4 * q < nc) {
        const long long at = static_cast<long long>(row) * mc + 4 * q;
        *reinterpret_cast<float4*>(g_out + at) =
            *reinterpret_cast<const float4*>(s_g + row * kTC + 4 * q);
        *reinterpret_cast<float4*>(a_out + at) =
            *reinterpret_cast<const float4*>(s_a + row * kTC + 4 * q);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * kTC; i += kThreads) {
      const int row = i / kTC;
      const int c = i % kTC;
      if (c < nc) {
        const long long at = static_cast<long long>(row) * mc + c;
        g_out[at] = s_g[row * kTC + c];
        a_out[at] = s_a[row * kTC + c];
      }
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. W (C, N, P) f32, sigma (N*P,) i32 and
// offsets (M+1,) i32 (the landmark-sorted layout, runs ascending, offsets
// non-decreasing with offsets[M] <= N*P), hinv (6, M) f32, G and A
// (phi-plo, C, c1-c0) f32, all contiguous on one device; 0 <= plo <= phi <=
// N, 0 <= c0 <= c1 <= M, N*P < 2^31. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int segmm_g_a_window_f32(const void* W, const void* sigma,
                                    const void* offsets, const void* hinv,
                                    void* G, void* A, int N, int P, int M,
                                    int C, int c0, int c1, int plo, int phi,
                                    void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  if (plo < 0 || phi < plo || phi > N || c0 < 0 || c1 < c0 || c1 > M)
    return static_cast<int>(cudaErrorInvalidValue);
  if (phi == plo || c1 == c0) return 0;
  const dim3 grid((c1 - c0 + kTC - 1) / kTC, (phi - plo + kTP - 1) / kTP);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  g_a_window_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const int*>(sigma),
      static_cast<const int*>(offsets), static_cast<const float*>(hinv),
      static_cast<float*>(G), static_cast<float*>(A), N, P, M, c0, c1, plo,
      phi);
  return static_cast<int>(cudaGetLastError());
}
