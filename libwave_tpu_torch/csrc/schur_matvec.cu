// The matrix-free Schur matvec on pose-ELL blocks for Hopper (sm_90a):
// three of its four launches (the fourth is segmm_seg.cu's reduce).
//
//   S x = Hpp x̂ - W Hll^-1 W^T x̂,   x̂ = x ⊙ free_pose
//
//   wt_slots:      t[j, s] = sum_i W[3i+j, s] x̂[pose(s), i]        (3, N*P)
//   (reduce):      utx[j, m] = sum of t[j, s] over the slots of m   (3, M)
//   landmark_step: y[:, m] = Hll^-1[m] utx[:, m]                    (3, M)
//   pose_side:     out[n] = proj(Hpp[n] x̂[n] - pad(acc[n]))         (N, D)
//                  acc[n][i] = sum_p sum_j W[3i+j, n, p] y[j, lm[n, p]]
//
// They replace no Pallas kernel: the JAX package leaves the W products, the
// Hll^-1 step and the pose sums of libwave_tpu/optim/schur.py:schur_matvec
// to one XLA fusion. They were added because in PyTorch that chain ran as
// ~90 eager launches and ~16 full passes over the 5.36M-slot planes of a
// BAL-sized problem: 71% of an LM iteration's host time and 89% of its
// device time went to the matvec.
//
// Layout. W is (18, N, P) f32, component-major, each plane contiguous over
// (N, P), planes `plane` floats apart: a batched window's W[:, plo:phi]
// is a view whose plane stride is the union's N*P, read in place. Slots are
// pose-major, so a warp's loads of one plane are consecutive addresses.
// x is (N, D) f32, free_pose (N,) or (N, D) (free_cols 0 or D), Hpp (N, D,
// D), the landmark vectors (C, M), all contiguous. Dj = 6: the W rows touch
// the first 6 of the pose's D >= 6 tangent coordinates.
//
// Rounding. wt_slots and landmark_step round every product and sum, in the
// plain version's order (optim/schur.py's _w_t_apply and sym3_matvec, as
// ops/segmm.py's plain versions compose them), with __fmul_rn/__fadd_rn so
// that nvcc contracts nothing into an FMA: both equal their plain versions
// bit for bit. pose_side rounds each slot's W y as the plain version does,
// then adds a pose's slots in its own fixed order (per thread in slot
// order, then a shuffle fold and the warps in order) and forms Hpp x̂ with
// FMAs; torch.sum and the plain version's einsum add in other orders, so
// it agrees to f32 rounding of those sums. No atomics anywhere: the same
// inputs give the same bits run to run.
//
// Bound. All three are memory bound. wt_slots reads W once (72 bytes a
// slot) and writes t (12 bytes a slot); landmark_step reads Hll^-1 and utx
// and writes y (48 bytes a landmark); pose_side reads W once more, the ids
// (4 bytes a slot) and y, gathered by id. At venice-mf's shape (N = 1,778,
// P = 3,013, M = 993,923) that is 450, 48 and 419 MB: 0.134, 0.014 and
// 0.125 ms at 3.35 TB/s. W and the ids stream (evict-first loads) so that
// pose_side's gathers of y (12 MB at that shape) stay in the 50 MB L2.
// pose_side gives a block to a pose, so a pose's slot sum needs no second
// pass; 1,024 threads a block where P > 2,048 (7 waves of 264 blocks for
// that shape's 1,778 poses: the last wave is 73% full, against 37% for 512
// threads), 256 otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDj = 6;               // pose coordinates the W rows touch
constexpr int kRows = kDj * 3;       // rows of W
constexpr int kSlotThreads = 256;    // wt_slots: one slot a thread
constexpr int kLmThreads = 256;      // landmark_step: one landmark a thread
constexpr int kWidePose = 2048;      // pose_side: wide blocks above this P

// free_pose's entry for pose n, coordinate i: (N,) or (N, D) layouts.
__device__ __forceinline__ float free_at(const float* __restrict__ free,
                                         int free_cols, long long n, int i) {
  return __ldg(free + (free_cols ? n * free_cols + i : n));
}

__global__ void __launch_bounds__(kSlotThreads)
    matvec_wt_slots_kernel(const float* __restrict__ W, long long plane,
                           const float* __restrict__ x,
                           const float* __restrict__ free, int free_cols,
                           float* __restrict__ t, int P, int K, int D) {
  const long long s =
      static_cast<long long>(blockIdx.x) * kSlotThreads + threadIdx.x;
  if (s >= K) return;
  const long long n = static_cast<int>(s) / P;  // K < 2^31
  float w[kRows];
#pragma unroll
  for (int c = 0; c < kRows; ++c) w[c] = __ldcs(W + c * plane + s);
  float xh[kDj];
#pragma unroll
  for (int i = 0; i < kDj; ++i)
    xh[i] = __fmul_rn(__ldg(x + n * D + i), free_at(free, free_cols, n, i));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kDj; ++i)
      acc = __fadd_rn(acc, __fmul_rn(w[3 * i + j], xh[i]));
    t[j * static_cast<long long>(K) + s] = acc;
  }
}

__global__ void __launch_bounds__(kLmThreads)
    matvec_landmark_step_kernel(const float* __restrict__ hinv,
                                const float* __restrict__ u,
                                float* __restrict__ y, int M) {
  const long long m =
      static_cast<long long>(blockIdx.x) * kLmThreads + threadIdx.x;
  if (m >= M) return;
  float h[6], v[3];
#pragma unroll
  for (int c = 0; c < 6; ++c) h[c] = __ldg(hinv + c * static_cast<long long>(M) + m);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __ldg(u + c * static_cast<long long>(M) + m);
  // symmetric components [00, 01, 02, 11, 12, 22]
  const int row[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
  for (int j = 0; j < 3; ++j)
    y[j * static_cast<long long>(M) + m] = __fadd_rn(
        __fadd_rn(__fmul_rn(h[row[j][0]], v[0]), __fmul_rn(h[row[j][1]], v[1])),
        __fmul_rn(h[row[j][2]], v[2]));
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    matvec_pose_side_kernel(const float* __restrict__ W, long long plane,
                            const int* __restrict__ lm,
                            const float* __restrict__ y, int M,
                            const float* __restrict__ Hpp,
                            const float* __restrict__ x,
                            const float* __restrict__ free, int free_cols,
                            float* __restrict__ out, int P, int D) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float part[kWarps][kDj];
  __shared__ float total[kDj];
  const long long n = blockIdx.x;
  const long long base = n * P;
  float acc[kDj] = {};
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const long long s = base + p;
    float w[kRows];
#pragma unroll
    for (int c = 0; c < kRows; ++c) w[c] = __ldcs(W + c * plane + s);
    const int id = __ldcs(lm + s);
    const bool ok = id >= 0 && id < M;
    float yv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      yv[j] = ok ? __ldg(y + j * static_cast<long long>(M) + id) : 0.0f;
#pragma unroll
    for (int i = 0; i < kDj; ++i) {
      float u = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        u = __fadd_rn(u, __fmul_rn(w[3 * i + j], yv[j]));
      acc[i] = __fadd_rn(acc[i], u);
    }
  }
#pragma unroll
  for (int i = 0; i < kDj; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] = __fadd_rn(acc[i], __shfl_down_sync(0xffffffffu, acc[i], off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kDj; ++i) part[warp][i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < kDj) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum = __fadd_rn(sum, part[w][threadIdx.x]);
    total[threadIdx.x] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float* h = Hpp + (n * D + i) * D;
    float hx = 0.0f;
    for (int k = 0; k < D; ++k)
      hx = fmaf(__ldg(h + k),
                __fmul_rn(__ldg(x + n * D + k), free_at(free, free_cols, n, k)),
                hx);
    const float r = i < kDj ? __fsub_rn(hx, total[i]) : hx;
    out[n * D + i] = __fmul_rn(r, free_at(free, free_cols, n, i));
  }
}

}  // namespace

// C entry points, bound with ctypes. Arrays on one device, f32 values and
// int32 ids, laid out as above; N, P, M > 0 where a launch needs them. Each
// launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int matvec_wt_slots_f32(const void* W, long long plane,
                                   const void* x, const void* free,
                                   int free_cols, void* t, int N, int P,
                                   int D, void* stream) {
  const long long K = static_cast<long long>(N) * P;
  if (K <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((K + kSlotThreads - 1) / kSlotThreads);
  matvec_wt_slots_kernel<<<blocks, kSlotThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), plane, static_cast<const float*>(x),
      static_cast<const float*>(free), free_cols, static_cast<float*>(t), P,
      static_cast<int>(K), D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int matvec_landmark_step_f32(const void* hinv, const void* u,
                                        void* y, int M, void* stream) {
  if (M <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((M + kLmThreads - 1LL) / kLmThreads);
  matvec_landmark_step_kernel<<<blocks, kLmThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hinv), static_cast<const float*>(u),
      static_cast<float*>(y), M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int matvec_pose_side_f32(const void* W, long long plane,
                                    const void* lm, const void* y, int M,
                                    const void* Hpp, const void* x,
                                    const void* free, int free_cols,
                                    void* out, int N, int P, int D,
                                    void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Wf = static_cast<const float*>(W);
  const int* lmi = static_cast<const int*>(lm);
  const float* yf = static_cast<const float*>(y);
  const float* hf = static_cast<const float*>(Hpp);
  const float* xf = static_cast<const float*>(x);
  const float* ff = static_cast<const float*>(free);
  float* of = static_cast<float*>(out);
  if (P > kWidePose)
    matvec_pose_side_kernel<1024><<<N, 1024, 0, s>>>(
        Wf, plane, lmi, yf, M, hf, xf, ff, free_cols, of, P, D);
  else
    matvec_pose_side_kernel<256><<<N, 256, 0, s>>>(
        Wf, plane, lmi, yf, M, hf, xf, ff, free_cols, of, P, D);
  return static_cast<int>(cudaGetLastError());
}
