// Other designs of the sorted segment reduce, kept to be timed against the
// one csrc/segmm_seg.cu ships (bench_seg_designs.py). Each computes
//
//   out[c, m] = sum of vals[c, sigma[p]] for p in [offsets[m], offsets[m+1])
//
// added from zero in slot order, so each equals the shipped kernel and the
// plain version bit for bit. f32, C = 3 or 6.
//
//   0  one thread per (channel, landmark), the loop unrolled by 4 (the
//      kernel of the port's first version)
//   1  a group of 8 lanes per landmark covering all channels: the lanes
//      load 8 consecutive slots of the run at once (two steps in flight)
//      and lane order is folded through __shfl_sync, channel by channel
//   2  one thread per landmark for all channels, 8 slots in flight, blocks
//      of 64 threads
//   3  the shipped kernel's thread per (channel, landmark), 8 slots in
//      flight, in blocks of 512 landmarks instead of 256
//   4  an empty kernel over the shipped kernel's grid: the floor of one
//      launch in a replayed CUDA graph

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(256)
    per_output_unroll4(const float* __restrict__ vals,
                       const int* __restrict__ sigma,
                       const int* __restrict__ offsets, float* __restrict__ out,
                       int K, int M) {
  const int m = blockIdx.x * 256 + threadIdx.x;
  const int c = blockIdx.y;
  if (m >= M) return;
  const float* v = vals + static_cast<long long>(c) * K;
  const int begin = offsets[m];
  const int end = offsets[m + 1];
  float acc = 0.f;
#pragma unroll 4
  for (int p = begin; p < end; ++p) acc += v[sigma[p]];
  out[static_cast<long long>(c) * M + m] = acc;
}

template <int C>
__global__ void __launch_bounds__(256)
    lane_group8(const float* __restrict__ vals, const int* __restrict__ sigma,
                const int* __restrict__ offsets, float* __restrict__ out, int K,
                int M) {
  constexpr int G = 8;
  static_assert(C <= G, "lane c writes channel c");
  const int lane = threadIdx.x % G;
  const int m = (blockIdx.x * 256 + threadIdx.x) / G;
  int begin = 0, end = 0;
  if (m < M) {
    begin = offsets[m];
    end = offsets[m + 1];
  }
  int steps = (end - begin + G - 1) / G;  // warp-uniform: every lane shuffles
  for (int o = G; o < 32; o <<= 1)
    steps = max(steps, __shfl_xor_sync(kFull, steps, o));
  float acc[C] = {};
  for (int st = 0; st < steps; st += 2) {
    float v[2][C];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = begin + (st + u) * G + lane;
      const int k = p < end ? sigma[p] : -1;
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[u][c] = k >= 0 ? vals[static_cast<long long>(c) * K + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (st + u < steps) {
#pragma unroll
        for (int i = 0; i < G; ++i) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[c] += __shfl_sync(kFull, v[u][c], i, G);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane == c && m < M)
      out[static_cast<long long>(c) * M + m] = acc[c];
}

template <int C>
__global__ void __launch_bounds__(64)
    per_landmark8(const float* __restrict__ vals, const int* __restrict__ sigma,
                  const int* __restrict__ offsets, float* __restrict__ out,
                  int K, int M) {
  const int m = blockIdx.x * 64 + threadIdx.x;
  if (m >= M) return;
  const int end = offsets[m + 1];
  float acc[C] = {};
  for (int p = offsets[m]; p < end; p += 8) {
    int k[8];
    float x[8][C];
#pragma unroll
    for (int u = 0; u < 8; ++u) k[u] = p + u < end ? sigma[p + u] : -1;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        x[u][c] = k[u] >= 0 ? vals[static_cast<long long>(c) * K + k[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += x[u][c];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[static_cast<long long>(c) * M + m] = acc[c];
}

template <int B>
__global__ void __launch_bounds__(B)
    per_output8(const float* __restrict__ vals, const int* __restrict__ sigma,
                const int* __restrict__ offsets, float* __restrict__ out,
                int K, int M) {
  const int m = blockIdx.x * B + threadIdx.x;
  const int c = blockIdx.y;
  if (m >= M) return;
  const float* v = vals + static_cast<long long>(c) * K;
  const int end = offsets[m + 1];
  float acc = 0.f;
  for (int p = offsets[m]; p < end; p += 8) {
    int k[8];
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) k[u] = p + u < end ? sigma[p + u] : -1;
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = k[u] >= 0 ? v[k[u]] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += x[u];
  }
  out[static_cast<long long>(c) * M + m] = acc;
}

__global__ void empty_kernel(float* out) {
  if (threadIdx.x > 1024) out[0] = 0.f;  // never: keeps the parameter live
}

template <int C>
void launch(int design, const float* v, const int* s, const int* o, float* out,
            int K, int M, cudaStream_t st) {
  const int per_output = (M + 255) / 256;
  switch (design) {
    case 0:
      per_output_unroll4<<<dim3(per_output, C), 256, 0, st>>>(v, s, o, out, K,
                                                               M);
      break;
    case 1:
      lane_group8<C><<<(M * 8 + 255) / 256, 256, 0, st>>>(v, s, o, out, K, M);
      break;
    case 2:
      per_landmark8<C><<<(M + 63) / 64, 64, 0, st>>>(v, s, o, out, K, M);
      break;
    case 3:
      per_output8<512><<<dim3((M + 511) / 512, C), 512, 0, st>>>(v, s, o, out,
                                                                 K, M);
      break;
    default:
      empty_kernel<<<dim3(per_output, C), 256, 0, st>>>(out);
  }
}

}  // namespace

// C entry point, bound with ctypes: design 0-4 as listed above, vals (C, K)
// f32, sigma (K,) and offsets (M+1,) int32, out (C, M) f32, all contiguous
// on one device, C = 3 or 6. Returns cudaGetLastError() (0 on success).
extern "C" int seg_reduce_design_f32(int design, const void* vals,
                                     const void* sigma, const void* offsets,
                                     void* out, int C, int K, int M,
                                     void* stream) {
  if (design < 0 || design > 4 || (C != 3 && C != 6) || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto args = [&](auto launcher) {
    launcher(design, static_cast<const float*>(vals),
             static_cast<const int*>(sigma), static_cast<const int*>(offsets),
             static_cast<float*>(out), K, M, static_cast<cudaStream_t>(stream));
  };
  if (C == 3) args(launch<3>); else args(launch<6>);
  return static_cast<int>(cudaGetLastError());
}
