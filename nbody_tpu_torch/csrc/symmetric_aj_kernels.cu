// Each-pair-once (Newton's third law) acceleration + jerk for Hopper
// (sm_90a): the Hermite scheme's force evaluation, triangle and
// cross-rectangle kernels of nbody_tpu_torch.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   nbody_aj_sym_f32   <- nbody_tpu/ops/symmetric_kernel.py::_aj_sym_kernel
//                         (compute_accel_jerk_symmetric): the strict upper
//                         triangle j > i of one set
//   nbody_aj_cross_f32 <- nbody_tpu/ops/symmetric_kernel.py::_aj_sym_cross_kernel
//                         (_aj_sym_cross): the mask-free rectangle of two sets
// For each pair (i, j), evaluated once (symmetric_kernel.py:820-864):
//   d = p_j - p_i;  dv = v_j - v_i (xyz lanes only: vel.w is not a velocity)
//   r2 = |d|^2 + eps2;  inv = rsqrtf(r2);  inv3 = inv^3
//   c3p = 3 (d . dv) inv^2 inv3;  q = inv3 dv - c3p d   (mass-free, odd in d)
//   a_i += m_j inv3 d    j_i += m_j q      (the action)
//   a_j -= m_i inv3 d    j_j -= m_i q      (the reaction)
// The triangle keeps j > i on the diagonal tiles as a select on inv3 and
// c3p, not a product: the masked self pair is inf at eps = 0.
//
// What bounds it on an H100: arithmetic. A pair is 60 flops by the JAX
// package's count for both sides (symmetric_kernel.py:703), about 38 fp32
// FMA-pipe instructions and one SFU rsqrtf; the inputs are 32 bytes a body.
//
// Design: that of symmetric_kernels.cu (see there), with a payload of 13
// values where the force has 7.
//   * Square tiles of T = 128 * ROWS, ROWS in {1, 2, 4, 8}; a block of 128
//     threads takes one tile pair from the flat worklist (triangle) or the
//     2-D grid (rectangle). Each thread keeps its ROWS i-bodies' position,
//     velocity, acceleration and jerk in registers: 13 floats a row.
//   * A warp walks the column tile 32 j-bodies at a time; each lane holds
//     one j-body (position, velocity) and its six reaction sums and passes
//     all 13 to the next lane after every step (__shfl_sync), so no
//     shared-memory read-modify-write and no atomics.
//   * The four warps' reaction sums meet in shared memory, added in warp
//     order: 4 * 6 * T floats, 96 KB at T = 1024 (dynamic shared memory,
//     the opt-in above 48 KB), 48 KB at 512.
//   * Each block writes its action and reaction partials into scratch rows
//     of 6 components; every (tile, component, body) slot is written once
//     and a second kernel adds each body's slots in tile order. So repeat
//     calls give the same bits. Scratch: ceil(N/T) * 6 * N floats, twice
//     the force's (201 MB at N = 65536 and the default T = 512).
//   * Registers (ptxas, no spills): 48 / 64 / 96 / 168 a thread at ROWS
//     1 / 2 / 4 / 8. The tile and the composition's cap are measured
//     (ops/cuda_kernel.py::aj_sym_default_dispatch, scripts/torch_aj_dispatch.py):
//     tile 512 (4 blocks an SM), cap 65536; the triangle at N = 65536 takes
//     4.15 ms on an H100 80GB HBM3 at 700 W, 46 % of the fp32 peak (PERF.md).
//
// Precision: fp32 only, rsqrtf as in nbody_kernels.cu; -O3 without
// --use_fast_math, and nvcc contracts a*b+c into FMAs.
//
// Edges: any N, Bi, Bj. A slot past the end loads mass 0 (and position and
// velocity 0) on both sides, so it exerts no action and no reaction, and
// nothing is written for it.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; pos, vel (N,4) AoS, 16-byte aligned. The
// caller allocates the scratch and the outputs, makes the arrays' device
// current and passes its stream; nothing here allocates or synchronises.
// Each entry point returns the first CUDA error of its launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace {

constexpr int kComps = 6;  // acceleration xyz, jerk xyz

// One T x T tile pair: rows [row0, row0 + T) of the i-set against columns
// [col0, col0 + T) of the j-set. Leaves each thread's action on its rows
// in act[comp][u] and the warps' reaction sums in red[warp][comp][T].
template <int ROWS, bool DIAG>
__device__ __forceinline__ void aj_tile_pair(const float4* __restrict__ pos_i,
                                             const float4* __restrict__ vel_i, const int64_t ni,
                                             const int64_t row0, const float4* __restrict__ pos_j,
                                             const float4* __restrict__ vel_j, const int64_t nj,
                                             const int64_t col0, const float eps2,
                                             float (&act)[kComps][ROWS], float* red) {
  constexpr int T = kThreads * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pi[ROWS];
  float vix[ROWS], viy[ROWS], viz[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t ig = row0 + threadIdx.x + u * kThreads;
    pi[u] = (ig < ni) ? pos_i[ig] : zero;
    const float4 v = (ig < ni) ? vel_i[ig] : zero;
    vix[u] = v.x;
    viy[u] = v.y;
    viz[u] = v.z;
#pragma unroll
    for (int comp = 0; comp < kComps; ++comp) act[comp][u] = 0.f;
  }
  const int src = (lane + 1) & 31;
  for (int q = 0; q < T / 32; ++q) {
    const int jl0 = q * 32;
    const int64_t jg = col0 + jl0 + lane;
    float4 pj = (jg < nj) ? pos_j[jg] : zero;
    const float4 vv = (jg < nj) ? vel_j[jg] : zero;
    float vjx = vv.x, vjy = vv.y, vjz = vv.z;
    float re[kComps] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    // step k: this lane holds the j-body that lane (lane + k) & 31 loaded
#pragma unroll 2
    for (int k = 0; k < 32; ++k) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const float dx = pj.x - pi[u].x;
        const float dy = pj.y - pi[u].y;
        const float dz = pj.z - pi[u].z;
        const float dvx = vjx - vix[u];
        const float dvy = vjy - viy[u];
        const float dvz = vjz - viz[u];
        const float r2 = dx * dx + dy * dy + dz * dz + eps2;
        const float inv = rsqrtf(r2);
        const float inv2 = inv * inv;
        float inv3 = inv2 * inv;
        float c3p = 3.f * (dx * dvx + dy * dvy + dz * dvz) * inv2 * inv3;
        if (DIAG) {
          // strict upper triangle by local index (row0 == col0)
          const bool keep =
              (jl0 + ((lane + k) & 31)) > static_cast<int>(threadIdx.x + u * kThreads);
          inv3 = keep ? inv3 : 0.f;
          c3p = keep ? c3p : 0.f;
        }
        const float qx = inv3 * dvx - c3p * dx;
        const float qy = inv3 * dvy - c3p * dy;
        const float qz = inv3 * dvz - c3p * dz;
        const float s = pj.w * inv3;     // action on i per unit of d
        const float t = pi[u].w * inv3;  // reaction on j per unit of d
        act[0][u] += s * dx;
        act[1][u] += s * dy;
        act[2][u] += s * dz;
        act[3][u] += pj.w * qx;
        act[4][u] += pj.w * qy;
        act[5][u] += pj.w * qz;
        re[0] -= t * dx;
        re[1] -= t * dy;
        re[2] -= t * dz;
        re[3] -= pi[u].w * qx;
        re[4] -= pi[u].w * qy;
        re[5] -= pi[u].w * qz;
      }
      pj.x = __shfl_sync(kFull, pj.x, src);
      pj.y = __shfl_sync(kFull, pj.y, src);
      pj.z = __shfl_sync(kFull, pj.z, src);
      pj.w = __shfl_sync(kFull, pj.w, src);
      vjx = __shfl_sync(kFull, vjx, src);
      vjy = __shfl_sync(kFull, vjy, src);
      vjz = __shfl_sync(kFull, vjz, src);
#pragma unroll
      for (int comp = 0; comp < kComps; ++comp) re[comp] = __shfl_sync(kFull, re[comp], src);
    }
    // after 32 passes the sums for j-body jl0 + lane are back in this lane
#pragma unroll
    for (int comp = 0; comp < kComps; ++comp) red[(warp * kComps + comp) * T + jl0 + lane] = re[comp];
  }
}

// Triangle of one set: scratch (R, 6, n), R = ceil(n / T).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    aj_sym_tri_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
                      const int64_t n, const int64_t num_tiles, const float eps2,
                      float* __restrict__ scratch) {
  constexpr int T = kThreads * ROWS;
  extern __shared__ float red[];  // kWarps * kComps * T
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float act[kComps][ROWS];
  if (r == c) {
    aj_tile_pair<ROWS, true>(pos, vel, n, row0, pos, vel, n, col0, eps2, act, red);
  } else {
    aj_tile_pair<ROWS, false>(pos, vel, n, row0, pos, vel, n, col0, eps2, act, red);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
#pragma unroll
    for (int comp = 0; comp < kComps; ++comp) {
      const float re = warp_sum<T, kComps>(red, comp, x);
      if (r == c) {
        if (row0 + x < n) scratch[(r * kComps + comp) * n + row0 + x] = act[comp][u] + re;
      } else {
        if (row0 + x < n) scratch[(c * kComps + comp) * n + row0 + x] = act[comp][u];
        if (col0 + x < n) scratch[(r * kComps + comp) * n + col0 + x] = re;
      }
    }
  }
}

// Rectangle of two sets: act (Cj, 6, bi), react (Ri, 6, bj).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    aj_sym_cross_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                        const int64_t bi, const float4* __restrict__ pos_j,
                        const float4* __restrict__ vel_j, const int64_t bj, const float eps2,
                        float* __restrict__ act_out, float* __restrict__ react_out) {
  constexpr int T = kThreads * ROWS;
  extern __shared__ float red[];  // kWarps * kComps * T
  const int64_t c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float act[kComps][ROWS];
  aj_tile_pair<ROWS, false>(pos_i, vel_i, bi, row0, pos_j, vel_j, bj, col0, eps2, act, red);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
#pragma unroll
    for (int comp = 0; comp < kComps; ++comp) {
      if (row0 + x < bi) act_out[(c * kComps + comp) * bi + row0 + x] = act[comp][u];
      if (col0 + x < bj) {
        react_out[(r * kComps + comp) * bj + col0 + x] = warp_sum<T, kComps>(red, comp, x);
      }
    }
  }
}

template <int ROWS>
constexpr size_t red_bytes() {
  return static_cast<size_t>(kWarps) * kComps * kThreads * ROWS * sizeof(float);
}

template <int ROWS>
cudaError_t launch_aj_tri(const float4* pos, const float4* vel, int64_t n, float eps2,
                          float* scratch, cudaStream_t stream) {
  const int64_t tiles = cdiv(n, kThreads * ROWS);
  const int64_t blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  // above 48 KB a block's dynamic shared memory needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(aj_sym_tri_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(red_bytes<ROWS>()));
  if (err != cudaSuccess) return err;
  aj_sym_tri_kernel<ROWS><<<static_cast<unsigned>(blocks), kThreads, red_bytes<ROWS>(), stream>>>(
      pos, vel, n, tiles, eps2, scratch);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_aj_cross(const float4* pos_i, const float4* vel_i, int64_t bi,
                            const float4* pos_j, const float4* vel_j, int64_t bj, float eps2,
                            float* act, float* react, cudaStream_t stream) {
  const int64_t ri = cdiv(bi, kThreads * ROWS);
  const int64_t cj = cdiv(bj, kThreads * ROWS);
  if (ri > 65535 || cj > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(aj_sym_cross_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(red_bytes<ROWS>()));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(cj), static_cast<unsigned>(ri));
  aj_sym_cross_kernel<ROWS><<<grid, kThreads, red_bytes<ROWS>(), stream>>>(
      pos_i, vel_i, bi, pos_j, vel_j, bj, eps2, act, react);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// acc (n, 3) and jerk (n, 3) of the set pos, vel (n, 4) on itself; scratch
// holds ceil(n / tile) * 6 * n floats.
int nbody_aj_sym_f32(const void* pos, const void* vel, int64_t n, float eps2, int64_t tile,
                     void* scratch, void* acc, void* jerk, void* stream) {
  const int rows = rows_of_tile(tile);
  if (rows == 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float4*>(pos);
  const auto v = static_cast<const float4*>(vel);
  auto sc = static_cast<float*>(scratch);
  cudaError_t err = rows == 1   ? launch_aj_tri<1>(p, v, n, eps2, sc, s)
                    : rows == 2 ? launch_aj_tri<2>(p, v, n, eps2, sc, s)
                    : rows == 4 ? launch_aj_tri<4>(p, v, n, eps2, sc, s)
                                : launch_aj_tri<8>(p, v, n, eps2, sc, s);
  if (err != cudaSuccess) return err;
  const int64_t parts = cdiv(n, tile);
  err = sum_partials(sc, parts, kComps, n, static_cast<float*>(acc), 3, 1, 0, s);
  if (err != cudaSuccess) return err;
  return sum_partials(sc + 3 * n, parts, kComps, n, static_cast<float*>(jerk), 3, 1, 0, s);
}

// acc_i, jerk_i (bi, 4) with w = 0 and react_acc, react_jerk (3, bj) of the
// rectangle pos_i, vel_i (bi, 4) x pos_j, vel_j (bj, 4); scratch_i holds
// ceil(bj / tile) * 6 * bi floats, scratch_j ceil(bi / tile) * 6 * bj.
int nbody_aj_cross_f32(const void* pos_i, const void* vel_i, int64_t bi, const void* pos_j,
                       const void* vel_j, int64_t bj, float eps2, int64_t tile, void* scratch_i,
                       void* scratch_j, void* acc_i, void* jerk_i, void* react_acc,
                       void* react_jerk, void* stream) {
  const int rows = rows_of_tile(tile);
  if (rows == 0 || bi < 0 || bj < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto si = static_cast<float*>(scratch_i);
  auto sj = static_cast<float*>(scratch_j);
  if (bi > 0 && bj > 0) {
    const auto pi = static_cast<const float4*>(pos_i);
    const auto vi = static_cast<const float4*>(vel_i);
    const auto pj = static_cast<const float4*>(pos_j);
    const auto vj = static_cast<const float4*>(vel_j);
    cudaError_t err =
        rows == 1   ? launch_aj_cross<1>(pi, vi, bi, pj, vj, bj, eps2, si, sj, s)
        : rows == 2 ? launch_aj_cross<2>(pi, vi, bi, pj, vj, bj, eps2, si, sj, s)
        : rows == 4 ? launch_aj_cross<4>(pi, vi, bi, pj, vj, bj, eps2, si, sj, s)
                    : launch_aj_cross<8>(pi, vi, bi, pj, vj, bj, eps2, si, sj, s);
    if (err != cudaSuccess) return err;
  }
  // with an empty other side there are no partials: the sums are 0
  const int64_t parts_i = bj > 0 ? cdiv(bj, tile) : 0;
  const int64_t parts_j = bi > 0 ? cdiv(bi, tile) : 0;
  cudaError_t err = sum_partials(si, parts_i, kComps, bi, static_cast<float*>(acc_i), 4, 1, 1, s);
  if (err != cudaSuccess) return err;
  err = sum_partials(si + 3 * bi, parts_i, kComps, bi, static_cast<float*>(jerk_i), 4, 1, 1, s);
  if (err != cudaSuccess) return err;
  err = sum_partials(sj, parts_j, kComps, bj, static_cast<float*>(react_acc), 1, bj, 0, s);
  if (err != cudaSuccess) return err;
  return sum_partials(sj + 3 * bj, parts_j, kComps, bj, static_cast<float*>(react_jerk), 1, bj, 0,
                      s);
}

}  // extern "C"
