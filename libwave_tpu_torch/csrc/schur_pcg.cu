// One trip of the preconditioned CG loop of optim/schur.py's pcg for Hopper
// (sm_90a): everything after the trip's matvec Sp = S p, in three launches
// issued from one C call.
//
//   live   = rr > thresh_sq                          (rr of the trip's start)
//   alpha  = live ? rz / (denom == 0 ? 1 : denom) : 0,   denom = p . Sp
//   x     += alpha p,   r -= alpha Sp
//   z      = proj(P proj(r))                         (per pose, D x D blocks)
//   beta   = live ? (r . z) / (rz == 0 ? 1 : rz) : 0
//   p      = z + beta p
//   rz     = live ? r . z : rz,   rr = r . r,   it += live
//
// It replaces no Pallas kernel: the JAX package runs this loop body as one
// XLA fusion inside lax.scan (libwave_tpu/optim/schur.py, pcg's body). In
// eager PyTorch the same body was ~32 launches a trip on vectors of 10,668
// (venice-mf) to 82,092 (final-13682-mf) floats: the host's launch cost,
// ~14 us a launch, was the work, 44.8 ms of host an LM iteration against
// 10.7 ms of device.
//
// Design. The trip needs two grid-wide sums before it can go on: p . Sp
// before alpha, r . z before beta. Of the two designs that give them,
// (a) one cooperative launch with two grid syncs and (b) ordinary launches
// with the kernel boundary as the barrier, this is (b): three launches,
// each of which writes per-block partial sums to a scratch buffer that the
// next one sums. (b) needs no co-residency of the grid, no relocatable
// device code and no launch attribute, and a kernel boundary costs the
// device about what a grid sync does; its host cost, three launches from
// C, is a few microseconds, against ~450 us for the eager body.
//
//   pcg_dot:    partial sums of p . Sp, one per block               scratch
//   pcg_update: denom from the partials, alpha, x and r in place, z in
//               place, partial sums of r . z and r . r; block 0 keeps
//               live and the trip's starting rz for pcg_finish      scratch
//   pcg_finish: r . z and r . r from the partials, beta, p in place; block
//               0 writes rz, rr and it to the state buffer
//
// Every block sums a launch's partials itself, in the same fixed order, so
// all blocks see the same denom and beta. Nothing reads the state buffer
// while pcg_finish writes it: pcg_update reads it, and hands pcg_finish
// what it needs through scratch. The host reads nothing: the state lives on
// the device from one trip to the next.
//
// Rounding. The elementwise steps round every product and sum as the plain
// version (ops/segmm.py pcg_trip_reference, PyTorch's eager operations)
// does, with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so that nvcc contracts
// nothing into an FMA. The three dots add their rounded products in a fixed
// order (per thread in element order, a shuffle tree in each warp, the
// warps in order, the blocks in order), and P's row products chain FMAs;
// torch.sum and einsum take other orders, so the sums agree with the plain
// version's to f32 rounding of their order. No atomics: the same inputs
// give the same bits run to run.
//
// Layout. p, Sp, x, r, z are (N, D) f32, P is (N, D, D) f32, free_pose is
// (N,) or (N, D) f32 (free_cols 0 or D), all contiguous; D <= 15 (BA's 6,
// VIO's 15), a parameter of the kernels. state is 4 floats: rz, rr,
// thresh_sq and it, an int32 in the fourth float's bits.
//
// Bound. Memory: P and free_pose (N,) once (D*D + 1 floats a pose) and
// the eight vector passes the trip needs (read x, r, p and Sp; write x, r,
// z and p): 4.65 MB at N = 13,682, D = 6, 1.39 us at 3.35 TB/s, and
// 0.60 MB, 0.18 us, at N = 1,778. This design moves twelve (pcg_dot and
// pcg_update each read p and Sp, pcg_finish reads z back), but at these
// sizes three launches' latency is the floor, not the bytes. pcg_update
// gives a block 256 / D whole poses, one (pose, row) element a thread, so
// that a pose's projected r sits in shared memory for its D rows of P.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // every launch's block
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                // pcg_dot, pcg_finish
constexpr int kChunk = kThreads * kPerThread;  // elements a block of those
constexpr int kMaxD = 15;

// Scratch layout (floats): [0] live (1 or 0), [1] the trip's starting rz,
// then pcg_dot's partials (one a block), then pcg_update's (two a block:
// r . z, r . r).
constexpr int kTripFloats = 2;

__host__ __device__ inline int dot_blocks(int L) {
  return (L + kChunk - 1) / kChunk;
}
__host__ __device__ inline int update_blocks(int N, int D) {
  const int poses = kThreads / D;
  return (N + poses - 1) / poses;
}

__device__ __forceinline__ float free_at(const float* __restrict__ free,
                                         int free_cols, int n, int i) {
  return free[free_cols ? static_cast<long long>(n) * free_cols + i : n];
}

// The sum of v over the block in a fixed order (a shuffle tree in each warp,
// then the warps in order); every thread gets it. sh holds kWarps + 1
// floats and is free again on return.
__device__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, sh[w]);
    sh[kWarps] = s;
  }
  __syncthreads();
  const float total = sh[kWarps];
  __syncthreads();
  return total;
}

// The sum of the n partials parts[0], parts[stride], ... in a fixed order.
__device__ float sum_parts(const float* parts, int n, int stride, float* sh) {
  float v = 0.0f;
  for (int k = threadIdx.x; k < n; k += kThreads)
    v = __fadd_rn(v, parts[static_cast<long long>(k) * stride]);
  return block_sum(v, sh);
}

__global__ void __launch_bounds__(kThreads)
    pcg_dot_kernel(const float* __restrict__ p, const float* __restrict__ Sp,
                   float* __restrict__ part, int L) {
  __shared__ float sh[kWarps + 1];
  const long long base =
      static_cast<long long>(blockIdx.x) * kChunk + threadIdx.x;
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = base + k * kThreads;
    if (e < L) v = __fadd_rn(v, __fmul_rn(p[e], Sp[e]));
  }
  v = block_sum(v, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = v;
}

__global__ void __launch_bounds__(kThreads)
    pcg_update_kernel(const float* __restrict__ p,
                      const float* __restrict__ Sp, float* __restrict__ x,
                      float* __restrict__ r, float* __restrict__ z,
                      const float* __restrict__ P,
                      const float* __restrict__ free, int free_cols,
                      const float* __restrict__ state,
                      float* __restrict__ scratch, int N, int D) {
  __shared__ float sh[kWarps + 1];
  __shared__ float rhat[kThreads];
  const int L = N * D;
  float* trip = scratch;
  const float* dot_part = scratch + kTripFloats;
  float* part = scratch + kTripFloats + dot_blocks(L);

  const float denom = sum_parts(dot_part, dot_blocks(L), 1, sh);
  const float rz = state[0];
  const bool live = state[1] > state[2];
  const float alpha =
      live ? __fdiv_rn(rz, denom == 0.0f ? 1.0f : denom) : 0.0f;

  const int t = threadIdx.x;
  const int poses = kThreads / D;
  const int local = t / D;  // the block's pose of this thread
  const int i = t - local * D;
  const int n = blockIdx.x * poses + local;
  const bool mine = local < poses && n < N;
  const long long e = static_cast<long long>(n) * D + i;
  float rv = 0.0f;
  if (mine) {
    x[e] = __fadd_rn(x[e], __fmul_rn(alpha, p[e]));
    rv = __fsub_rn(r[e], __fmul_rn(alpha, Sp[e]));
    r[e] = rv;
    rhat[t] = __fmul_rn(rv, free_at(free, free_cols, n, i));
  }
  __syncthreads();
  float rz_part = 0.0f, rr_part = 0.0f;
  if (mine) {
    const float* row = P + e * D;  // P[n, i, :]
    const float* rh = rhat + (t - i);  // the pose's projected r
    float acc = 0.0f;
    for (int k = 0; k < D; ++k) acc = fmaf(row[k], rh[k], acc);
    const float zv = __fmul_rn(acc, free_at(free, free_cols, n, i));
    z[e] = zv;
    rz_part = __fmul_rn(rv, zv);
    rr_part = __fmul_rn(rv, rv);
  }
  rz_part = block_sum(rz_part, sh);
  rr_part = block_sum(rr_part, sh);
  if (t == 0) {
    part[2 * blockIdx.x] = rz_part;
    part[2 * blockIdx.x + 1] = rr_part;
    if (blockIdx.x == 0) {
      trip[0] = live ? 1.0f : 0.0f;
      trip[1] = rz;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pcg_finish_kernel(const float* __restrict__ z, float* __restrict__ p,
                      float* __restrict__ state,
                      const float* __restrict__ scratch, int N, int D) {
  __shared__ float sh[kWarps + 1];
  const int L = N * D;
  const float* part = scratch + kTripFloats + dot_blocks(L);
  const int parts = update_blocks(N, D);
  const float rz_new = sum_parts(part, parts, 2, sh);
  const float rr_new = sum_parts(part + 1, parts, 2, sh);
  const bool live = scratch[0] != 0.0f;
  const float rz = scratch[1];
  const float beta =
      live ? __fdiv_rn(rz_new, rz == 0.0f ? 1.0f : rz) : 0.0f;
  const long long base =
      static_cast<long long>(blockIdx.x) * kChunk + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long e = base + k * kThreads;
    if (e < L) p[e] = __fadd_rn(z[e], __fmul_rn(beta, p[e]));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[0] = live ? rz_new : rz;
    state[1] = rr_new;
    state[3] = __int_as_float(__float_as_int(state[3]) + (live ? 1 : 0));
  }
}

}  // namespace

// C entry points, bound with ctypes.

// Floats of scratch that pcg_trip_f32 needs for N poses of D coordinates.
extern "C" long long pcg_trip_scratch_floats(int N, int D) {
  if (N <= 0 || D <= 0 || D > kMaxD) return 0;
  return kTripFloats + dot_blocks(N * D) + 2LL * update_blocks(N, D);
}

// One CG trip, in place on x, r, z, p and state (layouts above); `scratch`
// holds pcg_trip_scratch_floats(N, D) floats. N * D < 2^31, 0 < D <= 15.
// Launches on `stream` of device `device` (made current for the launches,
// then restored) and returns the first launch error (0 on success).
extern "C" int pcg_trip_f32(void* p, const void* Sp, void* x, void* r,
                            void* z, const void* P, const void* free,
                            int free_cols, void* state, void* scratch, int N,
                            int D, int device, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = N * D;
  float* sc = static_cast<float*>(scratch);
  float* pf = static_cast<float*>(p);
  const float* spf = static_cast<const float*>(Sp);
  float* zf = static_cast<float*>(z);
  pcg_dot_kernel<<<dot_blocks(L), kThreads, 0, s>>>(
      pf, spf, sc + kTripFloats, L);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    pcg_update_kernel<<<update_blocks(N, D), kThreads, 0, s>>>(
        pf, spf, static_cast<float*>(x), static_cast<float*>(r), zf,
        static_cast<const float*>(P), static_cast<const float*>(free),
        free_cols, static_cast<const float*>(state), sc, N, D);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    pcg_finish_kernel<<<dot_blocks(L), kThreads, 0, s>>>(
        zf, pf, static_cast<float*>(state), sc, N, D);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
