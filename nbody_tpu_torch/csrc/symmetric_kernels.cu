// Each-pair-once (Newton's third law) Plummer gravity for Hopper (sm_90a):
// the triangle and the cross-rectangle kernels of nbody_tpu_torch.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   nbody_sym_accel_f32 <- nbody_tpu/ops/symmetric_kernel.py::_sym_kernel
//                          (compute_accel_symmetric): the strict upper
//                          triangle j > i of one set
//   nbody_sym_cross_f32 <- nbody_tpu/ops/symmetric_kernel.py::_sym_cross_kernel
//                          (_sym_cross): the mask-free rectangle of two sets
// For each pair (i, j), evaluated once:
//   d = p_j - p_i;  r2 = |d|^2 + eps2;  inv = rsqrtf(r2);  c = inv^3;
//   a_i += m_j * c * d   (the action)      a_j -= m_i * c * d   (the reaction)
// as symmetric_kernel.py:145-170. The triangle keeps j > i on the tiles of
// the diagonal, which also drops the self pair; every other tile is
// mask-free because row and column tiles have one size.
//
// What bounds it on an H100: arithmetic, not bytes. A pair is 28 flops by
// the JAX package's count (symmetric_kernel.py:285) for both sides, about
// 16 fp32 FMA-pipe instructions and one SFU rsqrtf (an eighth of the FMA
// rate), where the one-sided kernel spends about 12 and one rsqrtf per side.
// The inputs are 16 bytes a body.
//
// Design. The TPU kernel carries the reaction in VMEM scratch across a
// sequential grid. Here blocks run in no order, so nothing is carried and
// nothing is added with atomics: the result has the same bits on every run.
//   * Square tiles of T = 128 * ROWS bodies, ROWS in {1, 2, 4, 8}. A block of
//     128 threads takes one (row tile, column tile) pair; each thread owns
//     ROWS i-bodies and keeps their position and action in registers.
//   * The triangle's blocks are a flat worklist of the R(R+1)/2 tile pairs
//     c >= r (the TPU's _pair_tables, symmetric_kernel.py:196-209), one
//     block each, so every block does the same work and no SM waits on a
//     long row.
//   * The reaction stays in registers too. A warp walks the column tile in
//     chunks of 32 j-bodies; each lane loads one j-body and zeroes its
//     three reaction sums. For 32 steps every lane meets the j-body it
//     holds with its ROWS i-bodies, then passes the j-body and its sums to
//     the next lane down (__shfl_sync): 7 shuffles per ROWS pairs, no
//     shared-memory read-modify-write. After 32 steps each sum is home.
//   * The four warps' reaction sums meet in shared memory and are added in
//     warp order. A block writes its action partial of the row tile into
//     the scratch row of its column tile, and its reaction partial of the
//     column tile into the scratch row of its row tile (one partial per
//     tile pair on the diagonal: action + reaction). Every (tile, body)
//     slot of the scratch is written exactly once; a second kernel adds
//     each body's slots in tile order.
//   * Scratch: ceil(N/T) * 3 * N floats. At N = 65536 and the default
//     T = 1024 that is 64 * 3 * 65536 * 4 bytes = 50 MB (201 MB at T = 256).
//     The blocked composition (ops/cuda_kernel.py) caps a launch at 131072
//     bodies a side, so at most 201 MB for a triangle; the cross kernel
//     holds two scratches of that size.
//   * Shared memory: the warps' reaction sums, 4 * 3 * T floats, 48 KB at
//     T = 1024. Registers (ptxas, no spills): 32 a thread at T = 128, 127
//     at T = 1024, which with the 48 KB leaves 4 blocks (16 warps) an SM.
//   * The default tile is 1024 (ops/cuda_kernel.py::sym_default_dispatch,
//     measured): at N = 65536 the triangle takes 1.78 ms on an H100 80GB
//     HBM3 at 700 W, 50 % of the fp32 peak (PERF.md).
//
// Precision: fp32 only. rsqrtf is the hardware approximation (at most
// 2 ulp), as in nbody_kernels.cu. Built with -O3 and without
// --use_fast_math; nvcc contracts a*b+c into FMAs.
//
// Edges: any N, Bi, Bj. A slot past the end loads mass 0 on both sides, so
// it exerts no action (m_j = 0) and no reaction (m_i = 0), and nothing is
// written for it.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays; pos (N,4) AoS, 16-byte aligned. The caller
// allocates the scratch and the outputs, makes the arrays' device current,
// and passes its stream; nothing here allocates or synchronises. Each
// entry point returns the first CUDA error of its launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace {

// One T x T tile pair: rows [row0, row0 + T) of pos_i against columns
// [col0, col0 + T) of pos_j. Leaves each thread's action on its rows in
// (ax, ay, az) and the warps' reaction sums in red[warp][comp][T].
template <int ROWS, bool DIAG>
__device__ __forceinline__ void tile_pair(const float4* __restrict__ pos_i, const int64_t ni,
                                          const int64_t row0,
                                          const float4* __restrict__ pos_j, const int64_t nj,
                                          const int64_t col0, const float eps2, float (&ax)[ROWS],
                                          float (&ay)[ROWS], float (&az)[ROWS], float* red) {
  constexpr int T = kThreads * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4 pi[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t ig = row0 + threadIdx.x + u * kThreads;
    pi[u] = (ig < ni) ? pos_i[ig] : make_float4(0.f, 0.f, 0.f, 0.f);
    ax[u] = 0.f;
    ay[u] = 0.f;
    az[u] = 0.f;
  }
  const int src = (lane + 1) & 31;
  for (int q = 0; q < T / 32; ++q) {
    const int jl0 = q * 32;
    const int64_t jg = col0 + jl0 + lane;
    float4 pj = (jg < nj) ? pos_j[jg] : make_float4(0.f, 0.f, 0.f, 0.f);
    float rx = 0.f, ry = 0.f, rz = 0.f;
    // step k: this lane holds the j-body that lane (lane + k) & 31 loaded
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const float dx = pj.x - pi[u].x;
        const float dy = pj.y - pi[u].y;
        const float dz = pj.z - pi[u].z;
        const float r2 = dx * dx + dy * dy + dz * dz + eps2;
        const float inv = rsqrtf(r2);
        const float c = inv * inv * inv;
        float s = pj.w * c;     // action on i per unit of d
        float t = pi[u].w * c;  // reaction on j per unit of d
        if (DIAG) {
          // strict upper triangle by local index (row0 == col0): a select,
          // not a product, since the masked self pair is inf at eps = 0
          const bool keep = (jl0 + ((lane + k) & 31)) > static_cast<int>(threadIdx.x + u * kThreads);
          s = keep ? s : 0.f;
          t = keep ? t : 0.f;
        }
        ax[u] += s * dx;
        ay[u] += s * dy;
        az[u] += s * dz;
        rx -= t * dx;
        ry -= t * dy;
        rz -= t * dz;
      }
      pj.x = __shfl_sync(kFull, pj.x, src);
      pj.y = __shfl_sync(kFull, pj.y, src);
      pj.z = __shfl_sync(kFull, pj.z, src);
      pj.w = __shfl_sync(kFull, pj.w, src);
      rx = __shfl_sync(kFull, rx, src);
      ry = __shfl_sync(kFull, ry, src);
      rz = __shfl_sync(kFull, rz, src);
    }
    // after 32 passes the sums for j-body jl0 + lane are back in this lane
    red[(warp * 3 + 0) * T + jl0 + lane] = rx;
    red[(warp * 3 + 1) * T + jl0 + lane] = ry;
    red[(warp * 3 + 2) * T + jl0 + lane] = rz;
  }
}

// Triangle of one set: scratch (R, 3, n), R = ceil(n / T).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    sym_tri_kernel(const float4* __restrict__ pos, const int64_t n, const int64_t num_tiles,
                   const float eps2, float* __restrict__ scratch) {
  constexpr int T = kThreads * ROWS;
  __shared__ float red[kWarps * 3 * T];
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float ax[ROWS], ay[ROWS], az[ROWS];
  if (r == c) {
    tile_pair<ROWS, true>(pos, n, row0, pos, n, col0, eps2, ax, ay, az, red);
  } else {
    tile_pair<ROWS, false>(pos, n, row0, pos, n, col0, eps2, ax, ay, az, red);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
    const float a[3] = {ax[u], ay[u], az[u]};
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      const float re = warp_sum<T, 3>(red, comp, x);
      if (r == c) {
        if (row0 + x < n) scratch[(r * 3 + comp) * n + row0 + x] = a[comp] + re;
      } else {
        if (row0 + x < n) scratch[(c * 3 + comp) * n + row0 + x] = a[comp];
        if (col0 + x < n) scratch[(r * 3 + comp) * n + col0 + x] = re;
      }
    }
  }
}

// Rectangle of two sets: act (Cj, 3, bi), react (Ri, 3, bj).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    sym_cross_kernel(const float4* __restrict__ pos_i, const int64_t bi,
                     const float4* __restrict__ pos_j, const int64_t bj, const float eps2,
                     float* __restrict__ act, float* __restrict__ react) {
  constexpr int T = kThreads * ROWS;
  __shared__ float red[kWarps * 3 * T];
  const int64_t c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float ax[ROWS], ay[ROWS], az[ROWS];
  tile_pair<ROWS, false>(pos_i, bi, row0, pos_j, bj, col0, eps2, ax, ay, az, red);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
    const float a[3] = {ax[u], ay[u], az[u]};
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      if (row0 + x < bi) act[(c * 3 + comp) * bi + row0 + x] = a[comp];
      if (col0 + x < bj) react[(r * 3 + comp) * bj + col0 + x] = warp_sum<T, 3>(red, comp, x);
    }
  }
}

template <int ROWS>
cudaError_t launch_tri(const float4* pos, int64_t n, float eps2, float* scratch,
                       cudaStream_t stream) {
  const int64_t tiles = cdiv(n, kThreads * ROWS);
  const int64_t blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  sym_tri_kernel<ROWS><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(pos, n, tiles,
                                                                                eps2, scratch);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_cross(const float4* pos_i, int64_t bi, const float4* pos_j, int64_t bj,
                         float eps2, float* act, float* react, cudaStream_t stream) {
  const int64_t ri = cdiv(bi, kThreads * ROWS);
  const int64_t cj = cdiv(bj, kThreads * ROWS);
  if (ri > 65535 || cj > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(cj), static_cast<unsigned>(ri));
  sym_cross_kernel<ROWS><<<grid, kThreads, 0, stream>>>(pos_i, bi, pos_j, bj, eps2, act, react);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// acc (n, 3) of the set pos (n, 4) on itself; scratch holds
// ceil(n / tile) * 3 * n floats.
int nbody_sym_accel_f32(const void* pos, int64_t n, float eps2, int64_t tile, void* scratch,
                        void* acc, void* stream) {
  const int rows = rows_of_tile(tile);
  if (rows == 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float4*>(pos);
  auto sc = static_cast<float*>(scratch);
  cudaError_t err = rows == 1   ? launch_tri<1>(p, n, eps2, sc, s)
                    : rows == 2 ? launch_tri<2>(p, n, eps2, sc, s)
                    : rows == 4 ? launch_tri<4>(p, n, eps2, sc, s)
                                : launch_tri<8>(p, n, eps2, sc, s);
  if (err != cudaSuccess) return err;
  return sum_partials(sc, cdiv(n, tile), 3, n, static_cast<float*>(acc), 3, 1, 0, s);
}

// acc_i (bi, 4) with w = 0 and react_j (3, bj) of the rectangle
// pos_i (bi, 4) x pos_j (bj, 4); scratch_i holds ceil(bj / tile) * 3 * bi
// floats, scratch_j ceil(bi / tile) * 3 * bj.
int nbody_sym_cross_f32(const void* pos_i, int64_t bi, const void* pos_j, int64_t bj, float eps2,
                        int64_t tile, void* scratch_i, void* scratch_j, void* acc_i,
                        void* react_j, void* stream) {
  const int rows = rows_of_tile(tile);
  if (rows == 0 || bi < 0 || bj < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto si = static_cast<float*>(scratch_i);
  auto sj = static_cast<float*>(scratch_j);
  if (bi > 0 && bj > 0) {
    const auto pi = static_cast<const float4*>(pos_i);
    const auto pj = static_cast<const float4*>(pos_j);
    cudaError_t err = rows == 1   ? launch_cross<1>(pi, bi, pj, bj, eps2, si, sj, s)
                      : rows == 2 ? launch_cross<2>(pi, bi, pj, bj, eps2, si, sj, s)
                      : rows == 4 ? launch_cross<4>(pi, bi, pj, bj, eps2, si, sj, s)
                                  : launch_cross<8>(pi, bi, pj, bj, eps2, si, sj, s);
    if (err != cudaSuccess) return err;
  }
  // with an empty other side there are no partials: the sums are 0
  cudaError_t err = sum_partials(si, bj > 0 ? cdiv(bj, tile) : 0, 3, bi,
                                 static_cast<float*>(acc_i), 4, 1, 1, s);
  if (err != cudaSuccess) return err;
  return sum_partials(sj, bi > 0 ? cdiv(bi, tile) : 0, 3, bj, static_cast<float*>(react_j), 1,
                      bj, 0, s);
}

}  // extern "C"
