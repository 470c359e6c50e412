// The one-sided fp32 walk, shared by nbody_kernels.cu (the fused Euler step,
// its rollout, dual-bank and packed twins, and the force kernel) and
// ring_kernels.cu (the fused ring's hops): ROWS i-bodies a thread against
// one j-chunk, the j-bodies staged through shared memory kStepStage at a
// time. A kernel that walks the same chunk of the same j-bodies for the
// same i-body gets the same sums, bit for bit, whatever ROWS, its block or
// its grid, so the force is the sum the step applies and each hop of the
// fused ring is the force at (M, M).
// Everything is in an unnamed namespace, so each source that includes this
// header has its own copy and the objects link without clashes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace {

// The walk's constants: i-bodies a thread at blocks of up to 512 threads
// (1 above; rows_a_thread picks), j-bodies a shared-memory stage (4 KB),
// the j-split's unit (ops/cuda_kernel.py's STEP_STAGE), and the steps of a
// stage's walk unrolled.
constexpr int kStepRows = 4;
constexpr int kStepStage = 256;
constexpr int kStepUnroll = 4;

// The rows a thread at `block_size` threads: the one rule for every kernel
// of the walk, so that the <kStepRows, 512> instantiation runs up to 512
// threads and the <1, 1024> one above.
__host__ __device__ inline int rows_a_thread(const int64_t block_size) {
  return block_size <= 512 ? kStepRows : 1;
}

// The j-chunk length, in whole stages, of `splits` chunks of n j-bodies:
// chunk c is [c * chunk, min((c + 1) * chunk, n)).
__host__ __device__ inline int64_t step_chunk(const int64_t n, const int64_t splits) {
  return ((n + kStepStage - 1) / kStepStage + splits - 1) / splits * kStepStage;
}

// The thread's ROWS i-bodies of a tile: row u is i0 + u * blockDim.x, so
// each row's loads stay coalesced; body i is pos[STRIDE * i]. A row past m
// is zero: such a thread still stages j-bodies for the rest of the block.
template <int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows(const float4* __restrict__ pos, const int64_t i0,
                                          const int64_t m, float4 (&pi)[ROWS]) {
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    pi[u] = (i < m) ? pos[STRIDE * i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The walk: a_u = sum_j m_j d / (|d|^2 + eps2)^(3/2), d = p_j - p_u, over
// the chunk [j0, min(j0 + chunk, n)) (chunk a whole number of stages), each
// row's sums from 0 in j order:
//   * ROWS i-bodies a thread, each with its position and three sums in
//     registers, so one shared-memory broadcast of a j-body serves ROWS
//     pairs;
//   * the pair as 3 FADD, 3 FFMA, one MUFU.RSQ (rsqrt_ftz, sym_common.cuh:
//     rsqrtf's bits for every normal r2, without its subnormal fix-up), 3
//     FMUL and 3 FFMA into the sums, every operation written out (fmaf) so
//     that no instantiation contracts differently;
//   * the j-side staged kStepStage bodies at a time whatever the block
//     size, the walk over a stage unrolled kStepUnroll times; a j-slot past
//     n loads mass 0 (the zero-mass padding of pallas_kernel.py:29-30).
// Every thread of the block must call it; it ends on a barrier, so the
// block may call it again at once.
template <int ROWS, class JLoad>
__device__ __forceinline__ void walk_chunk(const float4 (&pi)[ROWS], const JLoad load_j,
                                           const int64_t j0, const int64_t chunk,
                                           const int64_t n, const float eps2, float (&ax)[ROWS],
                                           float (&ay)[ROWS], float (&az)[ROWS]) {
  __shared__ float4 sp[kStepStage];
  const int bs = blockDim.x;
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    ax[u] = 0.f;
    ay[u] = 0.f;
    az[u] = 0.f;
  }
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kStepStage) {
    for (int k = tid; k < kStepStage; k += bs) {
      const int64_t j = base + k;
      sp[k] = (j < n) ? load_j(j) : zero;
    }
    __syncthreads();
#pragma unroll(kStepUnroll)
    for (int k = 0; k < kStepStage; ++k) {
      const float4 pj = sp[k];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const float dx = pj.x - pi[u].x;
        const float dy = pj.y - pi[u].y;
        const float dz = pj.z - pi[u].z;
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
        const float inv = rsqrt_ftz(r2);
        const float s = pj.w * ((inv * inv) * inv);  // m_j / r^3
        ax[u] = fmaf(s, dx, ax[u]);
        ay[u] = fmaf(s, dy, ay[u]);
        az[u] = fmaf(s, dz, az[u]);
      }
    }
    __syncthreads();
  }
}

// The walk's sums of chunk c into the partials (splits, 3, m):
// parts[(c * 3 + comp) * m + i], rows past m skipped. A second pass adds a
// row's partials in chunk order from 0 (sum_partials, step_finish_kernel,
// ring_finish_kernel).
template <int ROWS>
__device__ __forceinline__ void store_chunk(float* __restrict__ parts, const int64_t c,
                                            const int64_t i0, const int64_t m,
                                            const float (&ax)[ROWS], const float (&ay)[ROWS],
                                            const float (&az)[ROWS]) {
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    if (i >= m) continue;
    parts[(c * 3 + 0) * m + i] = ax[u];
    parts[(c * 3 + 1) * m + i] = ay[u];
    parts[(c * 3 + 2) * m + i] = az[u];
  }
}

}  // namespace
