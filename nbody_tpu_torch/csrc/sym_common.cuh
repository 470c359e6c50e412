// Shared pieces of the each-pair-once kernels (symmetric_kernels.cu,
// symmetric_aj_kernels.cu): the block shape, the tile sizes, the
// triangle's worklist, the warps' reaction sum, the rsqrt of their walks
// and the fixed-order sum of the per-tile partials; the last two also serve
// the one-sided kernels (nbody_kernels.cu).
// Everything is in an unnamed namespace, so each source that includes this
// header has its own copy and the objects link without clashes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ROWS i-bodies a thread, for the square tiles T = 128 * ROWS; 0 for a tile
// the kernels do not take
int rows_of_tile(int64_t tile) {
  switch (tile) {
    case 128: return 1;
    case 256: return 2;
    case 512: return 4;
    case 1024: return 8;
    default: return 0;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// 1/sqrt(x) as the PTX rsqrt.approx.ftz.f32, one MUFU.RSQ: the bits of
// rsqrtf for every normal x (scripts/torch_aj_dispatch.py checks every
// positive normal float on the card) without rsqrtf's range fix-up for a
// subnormal x (a compare and two predicated FMULs), for which it gives inf
__device__ __forceinline__ float rsqrt_ftz(const float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// blockIdx.x -> (r, c), c >= r, in row-major order of the upper triangle of
// num_tiles x num_tiles tile pairs (the TPU's _pair_tables,
// symmetric_kernel.py:196-209)
__device__ __forceinline__ void triangle_tile(int64_t b, const int64_t num_tiles, int64_t& r,
                                              int64_t& c) {
  r = 0;
  int64_t len = num_tiles;
  while (b >= len) {
    b -= len;
    ++r;
    --len;
  }
  c = r + b;
}

// the warps' reaction sums of local column x, red[warp][comp][T] with NCOMP
// components, added in warp order
template <int T, int NCOMP>
__device__ __forceinline__ float warp_sum(const float* red, const int comp, const int x) {
  float s = red[comp * T + x];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[(w * NCOMP + comp) * T + x];
  return s;
}

// out[x * sx + comp * sc] = sum over t = 0, 1, ... of
// parts[(t * pstride + comp) * n + x], comp < 3; with zero_w,
// out[x * sx + 3 * sc] = 0 as well.
__global__ void __launch_bounds__(256)
    sum_partials_kernel(const float* __restrict__ parts, const int64_t nparts,
                        const int64_t pstride, const int64_t n, float* __restrict__ out,
                        const int64_t sx, const int64_t sc, const int zero_w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3 * n) return;
  const int64_t comp = idx / n;
  const int64_t x = idx - comp * n;
  float s = 0.f;
  for (int64_t t = 0; t < nparts; ++t) s += parts[(t * pstride + comp) * n + x];
  out[x * sx + comp * sc] = s;
  if (zero_w && comp == 0) out[x * sx + 3 * sc] = 0.f;
}

cudaError_t sum_partials(const float* parts, int64_t nparts, int64_t pstride, int64_t n,
                         float* out, int64_t sx, int64_t sc, int zero_w, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>(cdiv(3 * n, 256));
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(parts, nparts, pstride, n, out, sx, sc,
                                                   zero_w);
  return cudaGetLastError();
}

}  // namespace
