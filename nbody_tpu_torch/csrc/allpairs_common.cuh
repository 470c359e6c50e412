// The one-sided fp32 walk, shared by nbody_kernels.cu (the fused Euler step,
// its rollout, dual-bank and packed twins, and the force kernel) and
// ring_kernels.cu (the fused ring's hops): ROWS i-bodies a thread against
// one j-chunk, the j-bodies staged through shared memory kStepStage at a
// time; and beside it the potential kernel's walk on the same recipe
// (walk_potential). A kernel that walks the same chunk of the same j-bodies
// for the same i-body gets the same sums, bit for bit, whatever ROWS, its
// block or its grid, so the force is the sum the step applies and each hop
// of the fused ring is the force at (M, M).
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

// One pair of the potential's walk: `sum` + m_j / sqrt(|d|^2 + eps2), as 3
// FADD, 3 FFMA (eps2 folded into the first), rsqrt_ftz and one FFMA. Both of
// walk_potential's loops add a pair through it, so the two round alike.
__device__ __forceinline__ float potential_pair(const float4 pj, const float4 pi,
                                                const float eps2, const float sum) {
  const float dx = pj.x - pi.x;
  const float dy = pj.y - pi.y;
  const float dz = pj.z - pi.z;
  return fmaf(pj.w, rsqrt_ftz(fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)))), sum);
}

// The potential's walk, on walk_chunk's recipe: u_u = sum_j m_j / sqrt(|d|^2
// + eps2) over the chunk [j0, min(j0 + chunk, n)) of the set's own bodies,
// each row's sum from 0 in j order, the self pair dropped by its index:
//   * ROWS i-bodies a thread, rows u * blockDim.x apart, the j-side staged
//     kStepStage bodies at a time whatever the block size, the walk over a
//     stage unrolled 8 times at ROWS 4 and kStepUnroll (4) at ROWS 1 (on an
//     H100, scripts/torch_mxu_bench.py: 8 ran 7.5 % ahead of 4 at ROWS 4 and
//     9 % behind at ROWS 1, 2 within 2 % of 4);
//   * the pair (potential_pair) as 3 FADD, 3 FFMA, one MUFU.RSQ (rsqrt_ftz)
//     and one FFMA into the row's sum; m_i is left out of the
//     walk and multiplies the row's sum once (the caller's), which rounds
//     once where m_i m_j / r would round a pair;
//   * the self pair masked by its index (k == i - base, a select: at eps = 0
//     it is inf), and a j-slot past n not walked, only in a stage that holds
//     one of the block's own rows [own_lo, own_hi) or ends the set; every
//     other stage runs the walk without the compare. A row's self pair lies
//     in a stage that holds its row, so it is always masked, and the two
//     walks add every other pair with the same FFMA: the bits depend on the
//     chunk alone, not on ROWS or the block.
// Two distinct bodies at one position still count. Every thread of the
// block must call it; it ends on a barrier.
template <int ROWS>
__device__ __forceinline__ void walk_potential(const float4 (&pi)[ROWS],
                                               const float4* __restrict__ pos, const int64_t i0,
                                               const int64_t own_lo, const int64_t own_hi,
                                               const int64_t j0, const int64_t chunk,
                                               const int64_t n, const float eps2,
                                               float (&u)[ROWS]) {
  __shared__ float4 sp[kStepStage];
  const int bs = blockDim.x;
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) u[r] = 0.f;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kStepStage) {
    for (int k = tid; k < kStepStage; k += bs) {
      const int64_t j = base + k;
      sp[k] = (j < n) ? pos[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (base + kStepStage <= n && (base + kStepStage <= own_lo || base >= own_hi)) {
#pragma unroll(ROWS == 1 ? kStepUnroll : 2 * kStepUnroll)
      for (int k = 0; k < kStepStage; ++k) {
        const float4 pj = sp[k];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) u[r] = potential_pair(pj, pi[r], eps2, u[r]);
      }
    } else {
      const int valid = static_cast<int>(n - base < kStepStage ? n - base : kStepStage);
      int self[ROWS];  // the row's slot in this stage, -1 where it lies elsewhere
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int64_t k = i0 + static_cast<int64_t>(r) * bs - base;
        self[r] = (k >= 0 && k < kStepStage) ? static_cast<int>(k) : -1;
      }
      for (int k = 0; k < valid; ++k) {
        const float4 pj = sp[k];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float sum = potential_pair(pj, pi[r], eps2, u[r]);
          u[r] = (k == self[r]) ? u[r] : sum;
        }
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
