// Other designs of the Hamming table, kept to be timed against the one
// csrc/hamming.cu ships (bench_designs.py), and a measurement of the tensor
// cores' rate on mma.sync with .b1 operands, which the H100 data sheet does
// not give (and on .s8, for comparison). The shipped source is included, so
// that its kernel runs here at another tile shape from the code that
// ships. Each table design computes the kernel's contract exactly.
//
// table_design_w16 (W = 16 words, the BRISK descriptor):
//   0  the first version: one block per 32 x 32 output tile, 32 x 8
//      threads, each one column and four rows, XOR + __popc on the CUDA
//      cores (the popcount issue rate bounds it)
//   1  register-tiled on the CUDA cores: 64 x 64 output tiles of 256
//      threads, each 4 x 4 outputs; both banks staged word-major in shared
//      memory, so that a word step is one 16-byte load of 4 rows, one of 4
//      columns, then 16 XOR + POPC + ADD; 16-byte streaming stores
//   2  the shipped tensor-core kernel at 128 x 128 tiles of 8 warps (each
//      warp 64 x 32): faster on tables of 4,096^2 and up, slower at 512^2
//   3  the shipped launch (64 x 64 tiles of 4 warps)
//   4  an empty kernel over the shipped grid: the floor of one launch
// mma_rate: `blocks` blocks of 8 warps, each warp `iters` steps of 8
// independent mma.sync products on operands held in registers; op 0 is
// m16n8k256 .b1 .and.popc (65,536 operations an instruction, counting the
// AND and the add of each bit pair), op 1 m16n8k32 .s8 (8,192).

#include "hamming.cu"

namespace {

constexpr int kFirstT = 32;   // first table: output tile edge
constexpr int kFirstTY = 8;   // first table: thread rows per block
constexpr int kRegTile = 64;  // register-tiled table: output tile edge
constexpr int kBigTile = 128; // design 2: output tile edge

// Output tiles of edge e for an n1 x n2 table.
long long table_tiles(int n1, int n2, int e) {
  return static_cast<long long>((n1 + e - 1) / e) * ((n2 + e - 1) / e);
}

template <int W>
__global__ void __launch_bounds__(kFirstT * kFirstTY)
    table_first(const uint32_t* __restrict__ d1,
                const uint32_t* __restrict__ d2, int* __restrict__ out,
                int n1, int n2) {
  __shared__ uint32_t s_a[kFirstT][W];
  __shared__ uint32_t s_b[kFirstT][W + 1];

  const int r0 = blockIdx.y * kFirstT;
  const int c0 = blockIdx.x * kFirstT;
  const int tid = threadIdx.y * kFirstT + threadIdx.x;
  for (int i = tid; i < kFirstT * W; i += kFirstT * kFirstTY) {
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
  for (int k = 0; k < kFirstT / kFirstTY; ++k) {
    const int r = threadIdx.y + k * kFirstTY;
    int d = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) d += __popc(s_a[r][w] ^ b[w]);
    if (r0 + r < n1 && col < n2)
      out[static_cast<long long>(r0 + r) * n2 + col] = d;
  }
}

template <int W>
__global__ void __launch_bounds__(256)
    table_register_tiled(const uint32_t* __restrict__ d1,
                         const uint32_t* __restrict__ d2,
                         int* __restrict__ out, int n1, int n2, int tiles_n,
                         bool vec_out) {
  constexpr int S = kRegTile + 4;  // word-major rows, 16-byte aligned
  __shared__ __align__(16) uint32_t s_a[W * S];
  __shared__ __align__(16) uint32_t s_b[W * S];
  const int r0 = (blockIdx.x / tiles_n) * kRegTile;
  const int c0 = (blockIdx.x % tiles_n) * kRegTile;
  for (int i = threadIdx.x; i < kRegTile * W; i += 256) {
    const int r = i / W, w = i % W;
    s_a[w * S + r] =
        r0 + r < n1 ? d1[static_cast<long long>(r0 + r) * W + w] : 0u;
    s_b[w * S + r] =
        c0 + r < n2 ? d2[static_cast<long long>(c0 + r) * W + w] : 0u;
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint4 a = *reinterpret_cast<const uint4*>(&s_a[w * S + 4 * ty]);
    const uint4 b = *reinterpret_cast<const uint4*>(&s_b[w * S + 4 * tx]);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __popc(av[i] ^ bv[j]);
  }
  const int col = c0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= n1) continue;
    int* dst = out + static_cast<long long>(row) * n2 + col;
    if (vec_out && col + 3 < n2) {
      __stcs(reinterpret_cast<int4*>(dst),
             make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n2) __stcs(dst + j, acc[i][j]);
    }
  }
}

__global__ void empty_table_kernel(int* out) {
  if (threadIdx.x == 1024) out[0] = 0;  // never true: keeps the launch
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int OP>
__global__ void __launch_bounds__(256) mma_rate_kernel(int iters, int* sink) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = threadIdx.x * 0x9e3779b9u + k;
  b[0] = ~a[0];
  b[1] = a[1] ^ 0x5555aaaau;
  int d[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[j][k] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (OP == 0)
        mma_and_popc(d[j], a, b);
      else
        mma_s8(d[j], a, b);
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) s += d[j][k];
  sink[blockIdx.x * 256 + threadIdx.x] = s;
}

}  // namespace

// C entry points, bound with ctypes. Each returns cudaGetLastError() (0 on
// success).
extern "C" int table_design_w16(int design, const void* d1, const void* d2,
                                void* out, int n1, int n2, void* stream) {
  if (n1 <= 0 || n2 <= 0 || design < 0 || design > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(d1);
  const uint32_t* b = static_cast<const uint32_t*>(d2);
  int* o = static_cast<int*>(out);
  switch (design) {
    case 0:
      table_first<16><<<dim3((n2 + kFirstT - 1) / kFirstT,
                             (n1 + kFirstT - 1) / kFirstT),
                        dim3(kFirstT, kFirstTY), 0, s>>>(a, b, o, n1, n2);
      break;
    case 1: {
      const int tiles_n = (n2 + kRegTile - 1) / kRegTile;
      const bool vec_out =
          n2 % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
      table_register_tiled<16><<<static_cast<unsigned>(
                                     table_tiles(n1, n2, kRegTile)),
                                 256, 0, s>>>(a, b, o, n1, n2, tiles_n,
                                              vec_out);
      break;
    }
    case 2:
      return run_table<16, kBigTile, kBigTile, 2, 4>(d1, d2, out, n1, n2, s);
    case 3:
      return launch_table<16>(d1, d2, out, n1, n2, s);
    default:
      empty_table_kernel<<<static_cast<unsigned>(
                               table_tiles(n1, n2, kTableTile)),
                           128, 0, s>>>(o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_rate(int op, int blocks, int iters, void* sink,
                        void* stream) {
  if (op < 0 || op > 1 || blocks <= 0 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(sink);
  if (op == 0)
    mma_rate_kernel<0><<<blocks, 256, 0, s>>>(iters, out);
  else
    mma_rate_kernel<1><<<blocks, 256, 0, s>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
