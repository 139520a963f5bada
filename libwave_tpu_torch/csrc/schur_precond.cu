// The SCHUR_JACOBI preconditioner's self-blocks on pose-ELL blocks for
// Hopper (sm_90a), in one launch:
//
//   out[n] = sum_p B_s Hinv[lm[s]] B_s^T,   s = n*P + p            (N, 6, 6)
//
// B_s is the slot's 6x3 block of W (row i: W[3i..3i+2, s]), Hinv[m] the
// landmark's inverted symmetric 3x3 block, from its six components
// [00, 01, 02, 11, 12, 22]. optim/schur.py's schur_jacobi_preconditioner
// subtracts out from Hpp and inverts each pose's block.
//
// It replaces no Pallas kernel: the JAX package leaves the sweep
// (libwave_tpu/optim/schur.py:_schur_self_blocks) to one XLA fusion. In
// eager PyTorch it ran as ~240 launches, each a full pass over the
// (N, P) slot planes: the gather of Hinv to 6 slot planes, the 18 planes of
// T = B Hinv, the 21 planes of T B^T, their stack and the pose sums, some
// 92 GB of traffic at BAL Final's 31.5M slots.
//
// Layout, as schur_matvec.cu's: W (18, N, P) f32, component-major, each
// plane contiguous over (N, P) and `plane` floats apart (a batched window's
// view of the union's W is read in place); lm (N*P,) int32; hinv (6, M) f32
// contiguous; out (N, 6, 6) f32 contiguous, both triangles written.
//
// Rounding. Each slot's terms are rounded as the plain version
// (ops/segmm.py's self_terms) rounds them, with __fmul_rn/__fadd_rn so that
// nvcc contracts nothing into an FMA: T[i][l] = (B[i][0] h(0,l) + B[i][1]
// h(1,l)) + B[i][2] h(2,l), then t(i, i2) = (T[i][0] B[i2][0] + T[i][1]
// B[i2][1]) + T[i][2] B[i2][2] for the 21 pairs i <= i2. (The plain
// version's Python sums start from 0: 0 + a is a but for a = -0, which
// moves no nonzero sum.) A pose's 21 sums then add its slots in one fixed
// order: per thread in slot order, a shuffle fold, the warps in order.
// torch.sum adds in another, so the two agree to f32 rounding of those
// sums. No atomics: the same inputs give the same bits run to run. A slot
// whose id lies outside [0, M) adds nothing and its W is not read (the
// plain version gathers zeros there, so its terms are 0 times W).
//
// Bound. Memory: every slot's id (4 bytes), a listed slot's W (72 bytes,
// streamed with evict-first loads) and each landmark's Hinv once (24 bytes;
// its ~6.5 poses a landmark of a sequential capture read it by id, from L2
// after the first): 2.32 GB at final-13682-mf's 31,495,964 slots (0.69 ms
// at 3.35 TB/s), 0.40 GB at venice-mf's 5,357,114 (0.12 ms). Counted per
// slot, the gathers make 100 bytes a slot (0.94 and 0.16 ms). The
// arithmetic, 216 rounded operations a listed slot, is 0.2 ms at Final at
// the card's 33.5e12 f32 operations a second without FMA. A block owns a
// pose, so its sums need no second pass. Each thread walks its slots two at
// a time: the pair's 36 loads of W and 12 gathers go out together after its
// ids, and the next pair's ids are in flight during the pair's arithmetic.
// The 21 sums and the pair's W stay in registers (~100 a thread). Blocks of
// 256 threads above Pmax = 512, 128 at or below it: on random W, sequential
// ids, Final's shape took 0.842 ms at 256 threads, 0.881 at 512 (fewer,
// longer trips, 2.25 for 2,302 slots), 0.943 at 128 and 1.62 at 1,024 (64
// registers: spills); 128 threads beat 256 by 1-9% at Pmax 40-300.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDj = 6;                     // pose coordinates the W rows touch
constexpr int kRows = kDj * 3;             // rows of W
constexpr int kTri = kDj * (kDj + 1) / 2;  // upper-triangle pairs (i <= i2)
constexpr int kWide = 512;                 // wider blocks above this P

// the symmetric 3x3 component of (j, l)
__device__ constexpr int sym3(int j, int l) {
  return j <= l ? j * (5 - j) / 2 + l : l * (5 - l) / 2 + j;
}

// the upper-triangle index of (i, i2), i <= i2, row by row
__device__ constexpr int tri(int i, int i2) {
  return i * (2 * kDj - 1 - i) / 2 + i2;
}

// A slot's W and its landmark's Hinv, read only where its id is listed.
__device__ __forceinline__ void load_slot(const float* __restrict__ W,
                                          long long plane, long long s,
                                          bool ok,
                                          const float* __restrict__ hinv,
                                          int M, int id, float (&w)[kRows],
                                          float (&h)[6]) {
  if (!ok) return;
#pragma unroll
  for (int c = 0; c < kRows; ++c) w[c] = __ldcs(W + c * plane + s);
#pragma unroll
  for (int c = 0; c < 6; ++c)
    h[c] = __ldg(hinv + c * static_cast<long long>(M) + id);
}

// acc[tri(i, i2)] += t(i, i2) of one slot, rounded as the plain version.
__device__ __forceinline__ void add_slot(const float (&w)[kRows],
                                         const float (&h)[6],
                                         float (&acc)[kTri]) {
#pragma unroll
  for (int i = 0; i < kDj; ++i) {
    float t[3];
#pragma unroll
    for (int l = 0; l < 3; ++l)
      t[l] = __fadd_rn(__fadd_rn(__fmul_rn(w[3 * i], h[sym3(0, l)]),
                                 __fmul_rn(w[3 * i + 1], h[sym3(1, l)])),
                       __fmul_rn(w[3 * i + 2], h[sym3(2, l)]));
#pragma unroll
    for (int i2 = i; i2 < kDj; ++i2)
      acc[tri(i, i2)] = __fadd_rn(
          acc[tri(i, i2)],
          __fadd_rn(__fadd_rn(__fmul_rn(t[0], w[3 * i2]),
                              __fmul_rn(t[1], w[3 * i2 + 1])),
                    __fmul_rn(t[2], w[3 * i2 + 2])));
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    schur_self_blocks_kernel(const float* __restrict__ W, long long plane,
                             const int* __restrict__ lm,
                             const float* __restrict__ hinv, int M,
                             float* __restrict__ out, int P) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float part[kWarps][kTri];
  __shared__ float total[kTri];
  const long long base = static_cast<long long>(blockIdx.x) * P;
  float acc[kTri];
#pragma unroll
  for (int c = 0; c < kTri; ++c) acc[c] = 0.0f;
  // trip by trip the slots p and p + kThreads, p = threadIdx.x + 2 kThreads k
  int p = threadIdx.x;
  int id0 = p < P ? __ldcs(lm + base + p) : -1;
  int id1 = p + kThreads < P ? __ldcs(lm + base + p + kThreads) : -1;
  for (; p < P; p += 2 * kThreads) {
    const int q = p + 2 * kThreads;
    const int next0 = q < P ? __ldcs(lm + base + q) : -1;
    const int next1 = q + kThreads < P ? __ldcs(lm + base + q + kThreads) : -1;
    const bool ok0 = id0 >= 0 && id0 < M;
    const bool ok1 = id1 >= 0 && id1 < M;
    float w0[kRows], w1[kRows], h0[6], h1[6];
    load_slot(W, plane, base + p, ok0, hinv, M, id0, w0, h0);
    load_slot(W, plane, base + p + kThreads, ok1, hinv, M, id1, w1, h1);
    if (ok0) add_slot(w0, h0, acc);
    if (ok1) add_slot(w1, h1, acc);
    id0 = next0;
    id1 = next1;
  }
#pragma unroll
  for (int c = 0; c < kTri; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] = __fadd_rn(acc[c], __shfl_down_sync(0xffffffffu, acc[c], off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kTri; ++c) part[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < kTri) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum = __fadd_rn(sum, part[w][threadIdx.x]);
    total[threadIdx.x] = sum;
  }
  __syncthreads();
  if (threadIdx.x < kDj * kDj) {
    const int i = threadIdx.x / kDj, i2 = threadIdx.x % kDj;
    out[blockIdx.x * static_cast<long long>(kDj * kDj) + threadIdx.x] =
        total[i <= i2 ? tri(i, i2) : tri(i2, i)];
  }
}

template <int kThreads>
void launch(const void* W, long long plane, const void* lm, const void* hinv,
            int M, void* out, int N, int P, cudaStream_t s) {
  schur_self_blocks_kernel<kThreads><<<N, kThreads, 0, s>>>(
      static_cast<const float*>(W), plane, static_cast<const int*>(lm),
      static_cast<const float*>(hinv), M, static_cast<float*>(out), P);
}

}  // namespace

// C entry point, bound with ctypes. Arrays on one device, laid out as above;
// N > 0, P > 0, M >= 0. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int schur_self_blocks_f32(const void* W, long long plane,
                                     const void* lm, const void* hinv, int M,
                                     void* out, int N, int P, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > kWide)
    launch<256>(W, plane, lm, hinv, M, out, N, P, s);
  else
    launch<128>(W, plane, lm, hinv, M, out, N, P, s);
  return static_cast<int>(cudaGetLastError());
}
