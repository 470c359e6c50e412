// Each-pair-once (Newton's third law) Plummer gravity for Hopper (sm_90a):
// the triangle and the cross-rectangle kernels of nbody_tpu_torch, and the
// triangle's reaction ablations.
//
// Replaces two Pallas TPU kernels of the JAX package and one of its
// experiment scripts:
//   nbody_sym_accel_f32 <- nbody_tpu/ops/symmetric_kernel.py::_sym_kernel
//                          (compute_accel_symmetric): the strict upper
//                          triangle j > i of one set
//   nbody_sym_cross_f32 <- nbody_tpu/ops/symmetric_kernel.py::_sym_cross_kernel
//                          (_sym_cross): the mask-free rectangle of two sets
//   nbody_sym_ablate_f32 <- scripts/tpu_r4_sym_budget.py::_ablate_kernel
//                          (def :58, pallas_call :177; ablated_accel): the
//                          triangle with its reaction tail full, none or
//                          tree_small, which prices the reaction
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
// The ablations (sym_ablate_kernel, a timing experiment): the triangle's
// walk with tile_pair's reaction tail R. kFull is the production tail; it
// keeps a diagonal block's action and reaction apart (the reaction into a
// (3, N) side array), so the partial sums give the action and the reaction
// separately, and also their total in the production order, which equals
// nbody_sym_accel_f32's bits. kNone drops the reaction: no t, no sums, no
// shuffles of them, but the same shuffle walk of the j-bodies, so its
// action has the production's bits. kTreeSmall keeps the reaction
// arithmetic and its shuffle carry, and drops the warps' shared-memory sum
// and the per-column scratch write: a lane adds its sums into 3 registers,
// and a block writes one slot of 3 floats, its reaction total (wrong
// physics by design). All three pin the contraction of |d|^2 (tile_pair's
// PIN), so their actions have the triangle's bits. The differences of
// their times price the reaction's arithmetic with its shuffles
// (tree_small - none), and its warp sum, scratch write and partial-sum
// pass (full - tree_small). On an H100 80GB HBM3 at 700 W and N = 65536,
// tile 1024 (PERF.md, chip_smoke.py 3e): full 1.775 ms as the triangle,
// none 1.602, tree_small 1.829; the reaction is 10 % of the triangle.
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

// The reaction tail of tile_pair: the production kernels' (kFull), and the
// two ablations of the budget experiment (sym_ablate_kernel): kNone drops
// the reaction (no t, no reaction sums, no reaction shuffles; the j-bodies
// still walk the warp), kTreeSmall keeps its arithmetic and its shuffle
// carry but adds each lane's sums into three registers (rsum) instead of
// the warps' shared-memory rows.
enum class Reaction { kFull, kNone, kTreeSmall };

// One T x T tile pair: rows [row0, row0 + T) of pos_i against columns
// [col0, col0 + T) of pos_j. Leaves each thread's action on its rows in
// (ax, ay, az) and, with kFull, the warps' reaction sums in
// red[warp][comp][T]; with kTreeSmall it adds this lane's reaction sums
// into rsum[3]. PIN writes |d|^2 + eps2 with rounded intrinsics, as the
// production kernels' contraction of it comes out of nvcc (measured on
// the card: the FMUL on dx at ROWS = 1, on dy above): left to nvcc, an
// ablation's tail can change which product it fuses, and with it the
// action's bits.
template <int ROWS, bool DIAG, Reaction R = Reaction::kFull, bool PIN = false>
__device__ __forceinline__ void tile_pair(const float4* __restrict__ pos_i, const int64_t ni,
                                          const int64_t row0,
                                          const float4* __restrict__ pos_j, const int64_t nj,
                                          const int64_t col0, const float eps2, float (&ax)[ROWS],
                                          float (&ay)[ROWS], float (&az)[ROWS], float* red,
                                          float* rsum = nullptr) {
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
        float r2;
        if constexpr (!PIN) {
          r2 = dx * dx + dy * dy + dz * dz + eps2;
        } else if constexpr (ROWS == 1) {
          r2 = __fadd_rn(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx))), eps2);
        } else {
          r2 = __fadd_rn(__fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy))), eps2);
        }
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
        if constexpr (R != Reaction::kNone) {
          rx -= t * dx;
          ry -= t * dy;
          rz -= t * dz;
        }
      }
      pj.x = __shfl_sync(kFull, pj.x, src);
      pj.y = __shfl_sync(kFull, pj.y, src);
      pj.z = __shfl_sync(kFull, pj.z, src);
      pj.w = __shfl_sync(kFull, pj.w, src);
      if constexpr (R != Reaction::kNone) {
        rx = __shfl_sync(kFull, rx, src);
        ry = __shfl_sync(kFull, ry, src);
        rz = __shfl_sync(kFull, rz, src);
      }
    }
    // after 32 passes the sums for j-body jl0 + lane are back in this lane
    if constexpr (R == Reaction::kFull) {
      red[(warp * 3 + 0) * T + jl0 + lane] = rx;
      red[(warp * 3 + 1) * T + jl0 + lane] = ry;
      red[(warp * 3 + 2) * T + jl0 + lane] = rz;
    } else if constexpr (R == Reaction::kTreeSmall) {
      if (jg < nj) {  // a slot past the end holds no body
        rsum[0] += rx;
        rsum[1] += ry;
        rsum[2] += rz;
      }
    }
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

// The budget experiment's triangle (scripts/tpu_r4_sym_budget.py): the
// triangle kernel with the reaction tail R. Scratch (R, 3, n) as the
// triangle's; each block writes its action partial of the row tile into the
// scratch row of its column tile, the diagonal's too (the action alone).
// kFull writes an off-diagonal block's reaction partial as sym_tri_kernel
// does and a diagonal block's into `side` (3, n); kTreeSmall writes the
// block's reaction total, its lanes' rsum added in a fixed order, into
// slots[blockIdx.x][3]; kNone writes no reaction.
template <int ROWS, Reaction R>
__global__ void __launch_bounds__(kThreads)
    sym_ablate_kernel(const float4* __restrict__ pos, const int64_t n, const int64_t num_tiles,
                      const float eps2, float* __restrict__ scratch, float* __restrict__ side,
                      float* __restrict__ slots) {
  constexpr int T = kThreads * ROWS;
  __shared__ float red[R == Reaction::kFull ? kWarps * 3 * T : kWarps * 3];
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float ax[ROWS], ay[ROWS], az[ROWS];
  float rsum[3] = {0.f, 0.f, 0.f};
  if (r == c) {
    tile_pair<ROWS, true, R, true>(pos, n, row0, pos, n, col0, eps2, ax, ay, az, red, rsum);
  } else {
    tile_pair<ROWS, false, R, true>(pos, n, row0, pos, n, col0, eps2, ax, ay, az, red, rsum);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
    const float a[3] = {ax[u], ay[u], az[u]};
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      if (row0 + x < n) scratch[(c * 3 + comp) * n + row0 + x] = a[comp];
      if constexpr (R == Reaction::kFull) {
        const float re = warp_sum<T, 3>(red, comp, x);
        if (col0 + x < n) {
          if (r == c) {
            side[comp * n + col0 + x] = re;
          } else {
            scratch[(r * 3 + comp) * n + col0 + x] = re;
          }
        }
      }
    }
  }
  if constexpr (R == Reaction::kTreeSmall) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      float v = rsum[comp];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if (lane == 0) red[warp * 3 + comp] = v;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float v = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w * 3 + threadIdx.x];
      slots[static_cast<int64_t>(blockIdx.x) * 3 + threadIdx.x] = v;
    }
  }
}

// The ablation's sums of the scratch, for body x of tile b = x / tile:
// acc[x][comp] = the action slots t >= b in order; with `react`,
// react[comp][x] = the reaction slots t < b in order, then side; with
// `total`, total[x][comp] = the slots t < b, then (slot b + side), then the
// slots t > b, which is sum_partials_kernel's order and the diagonal's
// (action + reaction) of sym_tri_kernel, so its bits are the triangle's.
__global__ void __launch_bounds__(256)
    ablate_sums_kernel(const float* __restrict__ parts, const float* __restrict__ side,
                       const int64_t n, const int64_t tile, const int64_t nparts,
                       float* __restrict__ acc, float* __restrict__ react,
                       float* __restrict__ total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3 * n) return;
  const int64_t comp = idx / n;
  const int64_t x = idx - comp * n;
  const int64_t b = x / tile;
  float below = 0.f;  // the reaction slots, full only
  if (react != nullptr || total != nullptr) {
    for (int64_t t = 0; t < b; ++t) below += parts[(t * 3 + comp) * n + x];
  }
  if (react != nullptr) react[comp * n + x] = below + side[comp * n + x];
  float a = 0.f;
  for (int64_t t = b; t < nparts; ++t) a += parts[(t * 3 + comp) * n + x];
  acc[x * 3 + comp] = a;
  if (total != nullptr) {
    float s = below + (parts[(b * 3 + comp) * n + x] + side[comp * n + x]);
    for (int64_t t = b + 1; t < nparts; ++t) s += parts[(t * 3 + comp) * n + x];
    total[x * 3 + comp] = s;
  }
}

template <int ROWS, Reaction R>
cudaError_t launch_ablate(const float4* pos, int64_t n, float eps2, float* scratch, float* side,
                          float* slots, cudaStream_t stream) {
  const int64_t tiles = cdiv(n, kThreads * ROWS);
  const int64_t blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  sym_ablate_kernel<ROWS, R><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      pos, n, tiles, eps2, scratch, side, slots);
  return cudaGetLastError();
}

template <Reaction R>
cudaError_t launch_ablate_rows(int rows, const float4* pos, int64_t n, float eps2,
                               float* scratch, float* side, float* slots, cudaStream_t s) {
  return rows == 1   ? launch_ablate<1, R>(pos, n, eps2, scratch, side, slots, s)
         : rows == 2 ? launch_ablate<2, R>(pos, n, eps2, scratch, side, slots, s)
         : rows == 4 ? launch_ablate<4, R>(pos, n, eps2, scratch, side, slots, s)
                     : launch_ablate<8, R>(pos, n, eps2, scratch, side, slots, s);
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

// The budget experiment's triangle with reaction tail `reaction` (0 full,
// 1 none, 2 tree_small): acc (n, 3) the action sums; with full, react
// (3, n) the reaction sums and, when `total` is not null, total (n, 3) in
// the triangle's order (nbody_sym_accel_f32's bits); with tree_small,
// slots (blocks, 3) the tile pairs' reaction totals. scratch holds
// ceil(n / tile) * 3 * n floats, side 3 * n (full only).
int nbody_sym_ablate_f32(const void* pos, int64_t n, float eps2, int64_t tile, int reaction,
                         void* scratch, void* side, void* slots, void* acc, void* react,
                         void* total, void* stream) {
  const int rows = rows_of_tile(tile);
  if (rows == 0 || n < 0 || reaction < 0 || reaction > 2) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float4*>(pos);
  auto sc = static_cast<float*>(scratch);
  auto sd = static_cast<float*>(side);
  auto sl = static_cast<float*>(slots);
  cudaError_t err =
      reaction == 0   ? launch_ablate_rows<Reaction::kFull>(rows, p, n, eps2, sc, sd, sl, s)
      : reaction == 1 ? launch_ablate_rows<Reaction::kNone>(rows, p, n, eps2, sc, sd, sl, s)
                      : launch_ablate_rows<Reaction::kTreeSmall>(rows, p, n, eps2, sc, sd, sl, s);
  if (err != cudaSuccess) return err;
  const bool full = reaction == 0;
  ablate_sums_kernel<<<static_cast<unsigned>(cdiv(3 * n, 256)), 256, 0, s>>>(
      sc, sd, n, tile, cdiv(n, tile), static_cast<float*>(acc),
      full ? static_cast<float*>(react) : nullptr,
      full ? static_cast<float*>(total) : nullptr);
  return cudaGetLastError();
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
