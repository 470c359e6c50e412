// Each-pair-once (Newton's third law) acceleration + jerk for Hopper
// (sm_90a): the Hermite scheme's force evaluation, triangle and
// cross-rectangle kernels of nbody_tpu_torch.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   nbody_aj_sym_f32   <- nbody_tpu/ops/symmetric_kernel.py::_aj_sym_kernel
//                         (compute_accel_jerk_symmetric, pallas_call :935):
//                         the strict upper triangle j > i of one set
//   nbody_aj_cross_f32 <- nbody_tpu/ops/symmetric_kernel.py::_aj_sym_cross_kernel
//                         (_aj_sym_cross, pallas_call :679): the mask-free
//                         rectangle of two sets
// For each pair (i, j), evaluated once (symmetric_kernel.py:820-864):
//   d = p_j - p_i;  dv = v_j - v_i (xyz lanes only: vel.w is not a velocity)
//   r2 = |d|^2 + eps2;  inv = rsqrt(r2);  inv3 = inv^3
//   a_i += m_j inv3 d    j_i += m_j q      (the action)
//   a_j -= m_i inv3 d    j_j -= m_i q      (the reaction)
// with the jerk bracket q = inv3 dv - 3 (d . dv) inv^5 d.
//
// Algebra. q is taken as inv3 e, e = dv - w d, w = 3 (d . dv) inv^2, so the
// jerk's action is s e and its reaction -t e with the s = m_j inv3 and
// t = m_i inv3 of the acceleration: 33 FP32-pipe instructions a pair (6
// FADD for d and dv, 3 FFMA for r2, 2 FMUL for inv^2 and inv^3, 3 for
// d . dv, 2 for w, 3 FFMA for e, 2 FMUL for s and t, 12 FFMA for the sums)
// and one MUFU. The JAX package forms q as inv3 dv - c3p d, c3p = 3 (d . dv)
// inv^2 inv3; the two round differently, within the 1e-4 * max + 1e-4
// that the tests and chip_smoke.py hold the kernels to. The triangle keeps
// j > i on the diagonal tiles as a select on s, t and w, never a product:
// at eps = 0 the self pair has inv = inf and w = NaN, and 0 * NaN is NaN.
//
// rsqrt: rsqrt_ftz (sym_common.cuh), the PTX rsqrt.approx.ftz.f32, one
// MUFU.RSQ. rsqrtf without -ftz=true adds a range fix-up for subnormal
// inputs (a compare and two predicated FMULs a pair). The two give the same
// bits for every normal r2 (scripts/torch_aj_dispatch.py checks every
// positive normal float on the card); they differ only for a subnormal r2,
// which needs eps = 0 and |d| < 1.1e-19, where this kernel returns inf (the
// self pair's value).
//
// What bounds it on an H100: issue of arithmetic. A pair is 60 flops by the
// JAX package's count for both sides (symmetric_kernel.py:703), i.e. 30
// FP32-pipe instructions; the walk issues 36.75 SASS instructions a pair at
// tile 512 (33 FP32-pipe, 1 MUFU, 1.5 SHFL, 0.5 LDS, loop), against 46.00
// in the kernels it replaced (40 FP32-pipe, 3.25 SHFL, a compare); the
// inputs are 32 bytes a body.
//
// Design (T = 128 * ROWS, ROWS in {1, 2, 4, 8}; a block of 128 threads takes
// one T x T tile pair from the flat worklist (triangle) or the 2-D grid
// (rectangle)):
//   * i-side in registers: ROWS rows a thread, position, velocity, and the
//     action's 6 sums.
//   * j-side in shared memory: the column tile is walked in sub-tiles of 128
//     bodies, each staged once (one body a thread) into shared memory, every
//     32-body chunk stored twice in a row, so that at step k a lane reads
//     body (lane + k) & 31 of the chunk at slot lane + k: two 16-byte LDS at
//     a constant offset from one register, conflict-free.
//   * Only the 6 reaction sums travel around the warp (__shfl_sync): a lane
//     carries the sums of the body it holds to the next lane after every
//     step, and after 32 steps they are back in the lane that stages them.
//   * Reactions flushed every sub-tile: the 4 warps' sums meet in shared
//     memory (4 * 6 * 128 floats), and after a __syncthreads() thread x adds
//     column x's four in warp order and writes the block's reaction slot
//     (on a diagonal tile it adds it to the action of its own row x, which
//     is the same body). Shared memory is 20 KB a block, static, at every
//     ROWS: registers alone set the blocks an SM.
//   * Registers: the ROWS 4 kernels (tile 512, the default) may take 128
//     registers, 4 blocks (16 warps) an SM (ptxas: 128 triangle, 121
//     rectangle, no spills), and the 32-step walk is unrolled twice
//     (kUnroll): measured faster than 5 blocks at 96 registers, or than
//     unrolling 4, 8 or 32 steps (the last overflows the instruction cache).
// Sum order, fixed: an action sums its columns in walk order (sub-tile,
// chunk, step); a reaction sums its rows in step order, the ROWS rows of a
// step in row order, then the warps in warp order; each block writes its
// action and reaction partials into scratch rows of 6 components, every
// (tile, component, body) slot written once, and a second kernel adds each
// body's slots in tile order. No atomics: a state gives the same bits on
// every call. Scratch: ceil(N/T) * 6 * N floats (201 MB at N = 65536 and
// T = 512).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_aj_dispatch.py,
// in turns with the kernels this design replaced): the triangle 3.14-3.19 ms
// at N = 65536 (4.11-4.15 before), 1.52-1.56 at 45056 (1.97-2.00), the
// rectangle (45056, 45056) 2.91-2.98 (3.82-3.85): 58-62 % of the 60-flop
// bound. The tile sweep: ops/cuda_kernel.py (AJ_SYM_TILE); PERF.md.
//
// Precision: fp32; -O3 without --use_fast_math; the sums are written as
// fmaf.
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

constexpr int kComps = 6;            // acceleration xyz, jerk xyz
constexpr int kSub = kThreads;       // columns a sub-tile, one staged a thread
constexpr int kChunks = kSub / 32;   // 32-column chunks a sub-tile
// Steps of the 32-step walk unrolled. On the H100, at tile 512: 2 beat 1, 4, 8
// and 32 (32 overflows the instruction cache; PERF.md, Findings).
constexpr int kUnroll = 2;

// The least blocks an SM that ptxas must fit. At ROWS 4 (the default tile),
// 4 blocks at up to 128 registers beat 5 at 96 on the H100 (PERF.md, Findings).
template <int ROWS>
constexpr int min_blocks() {
  return ROWS == 1 ? 8 : ROWS == 2 ? 6 : ROWS == 4 ? 4 : 3;
}

struct AjShared {
  float4 pos[kChunks][64];  // each chunk's 32 j-bodies, twice in a row
  float4 vel[kChunks][64];
  float red[kWarps][kComps][kSub];  // the warps' reaction sums of a sub-tile
};

// One T x T tile pair: rows [row0, row0 + T) of the i-set against columns
// [col0, col0 + T) of the j-set. Leaves each thread's action on its rows in
// act[comp][u] and writes the block's reaction on column body b to
// react[comp * react_stride + b]; on a diagonal tile (DIAG: row0 == col0,
// one set) the reaction goes into the action of the same body instead.
template <int ROWS, bool DIAG>
__device__ __forceinline__ void aj_tile_pair(
    const float4* __restrict__ pos_i, const float4* __restrict__ vel_i, const int64_t ni,
    const int64_t row0, const float4* __restrict__ pos_j, const float4* __restrict__ vel_j,
    const int64_t nj, const int64_t col0, const float eps2, float* __restrict__ react,
    const int64_t react_stride, float (&act)[kComps][ROWS], AjShared& sh) {
  constexpr int T = kThreads * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pi[ROWS];
  float vix[ROWS], viy[ROWS], viz[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t ig = row0 + tid + u * kThreads;
    pi[u] = (ig < ni) ? pos_i[ig] : zero;
    const float4 v = (ig < ni) ? vel_i[ig] : zero;
    vix[u] = v.x;
    viy[u] = v.y;
    viz[u] = v.z;
#pragma unroll
    for (int comp = 0; comp < kComps; ++comp) act[comp][u] = 0.f;
  }
  const int src = (lane + 1) & 31;
#pragma unroll 1
  for (int sub = 0; sub < T / kSub; ++sub) {
    const int js0 = sub * kSub;  // the sub-tile's first local column
    {
      const int64_t jg = col0 + js0 + tid;
      const float4 p = (jg < nj) ? pos_j[jg] : zero;
      const float4 v = (jg < nj) ? vel_j[jg] : zero;
      sh.pos[warp][lane] = p;
      sh.pos[warp][lane + 32] = p;
      sh.vel[warp][lane] = v;
      sh.vel[warp][lane + 32] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      const float4* jp = &sh.pos[c][lane];
      const float4* jv = &sh.vel[c][lane];
      float re[kComps] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      // step k: this lane holds chunk body (lane + k) & 31 and its sums
#pragma unroll(kUnroll)
      for (int k = 0; k < 32; ++k) {
        const float4 pj = jp[k];
        const float4 vj = jv[k];
        const int jl = js0 + c * 32 + ((lane + k) & 31);  // local column (DIAG)
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const float dx = pj.x - pi[u].x;
          const float dy = pj.y - pi[u].y;
          const float dz = pj.z - pi[u].z;
          const float dvx = vj.x - vix[u];
          const float dvy = vj.y - viy[u];
          const float dvz = vj.z - viz[u];
          const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
          const float inv = rsqrt_ftz(r2);
          const float inv2 = inv * inv;
          const float inv3 = inv2 * inv;
          float w = (3.f * inv2) * fmaf(dz, dvz, fmaf(dy, dvy, dx * dvx));
          float s = pj.w * inv3;     // action on i per unit of d and e
          float t = pi[u].w * inv3;  // reaction on j per unit of d and e
          if (DIAG) {
            // strict upper triangle by local index (row0 == col0)
            const bool keep = jl > tid + u * kThreads;
            s = keep ? s : 0.f;
            t = keep ? t : 0.f;
            w = keep ? w : 0.f;
          }
          const float ex = fmaf(-w, dx, dvx);
          const float ey = fmaf(-w, dy, dvy);
          const float ez = fmaf(-w, dz, dvz);
          act[0][u] = fmaf(s, dx, act[0][u]);
          act[1][u] = fmaf(s, dy, act[1][u]);
          act[2][u] = fmaf(s, dz, act[2][u]);
          act[3][u] = fmaf(s, ex, act[3][u]);
          act[4][u] = fmaf(s, ey, act[4][u]);
          act[5][u] = fmaf(s, ez, act[5][u]);
          re[0] = fmaf(-t, dx, re[0]);
          re[1] = fmaf(-t, dy, re[1]);
          re[2] = fmaf(-t, dz, re[2]);
          re[3] = fmaf(-t, ex, re[3]);
          re[4] = fmaf(-t, ey, re[4]);
          re[5] = fmaf(-t, ez, re[5]);
        }
#pragma unroll
        for (int comp = 0; comp < kComps; ++comp) re[comp] = __shfl_sync(kFull, re[comp], src);
      }
      // after 32 passes the sums of chunk body `lane` are back in this lane
#pragma unroll
      for (int comp = 0; comp < kComps; ++comp) sh.red[warp][comp][c * 32 + lane] = re[comp];
    }
    __syncthreads();
    // column js0 + tid: the four warps' sums in warp order
#pragma unroll
    for (int comp = 0; comp < kComps; ++comp) {
      const float r = warp_sum<kSub, kComps>(&sh.red[0][0][0], comp, tid);
      if (DIAG) {
        // the same body as row tid + sub * kThreads of this thread (kSub == kThreads)
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          if (u == sub) act[comp][u] += r;
        }
      } else if (col0 + js0 + tid < nj) {
        react[comp * react_stride + col0 + js0 + tid] = r;
      }
    }
    // the next sub-tile's staging and sums come after every thread has
    // passed the barrier above, so none of this sub-tile's reads is pending
  }
}

// Triangle of one set: scratch (R, 6, n), R = ceil(n / T); slot (t, comp, b)
// holds body b's sum over the tile pair of its tile and tile t.
template <int ROWS>
__global__ void __launch_bounds__(kThreads, min_blocks<ROWS>())
    aj_sym_tri_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
                      const int64_t n, const int64_t num_tiles, const float eps2,
                      float* __restrict__ scratch) {
  constexpr int T = kThreads * ROWS;
  __shared__ AjShared sh;
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float act[kComps][ROWS];
  if (r == c) {
    aj_tile_pair<ROWS, true>(pos, vel, n, row0, pos, vel, n, col0, eps2, nullptr, n, act, sh);
  } else {
    aj_tile_pair<ROWS, false>(pos, vel, n, row0, pos, vel, n, col0, eps2,
                              scratch + r * kComps * n, n, act, sh);
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t b = row0 + threadIdx.x + u * kThreads;
    if (b < n) {
#pragma unroll
      for (int comp = 0; comp < kComps; ++comp) scratch[(c * kComps + comp) * n + b] = act[comp][u];
    }
  }
}

// Rectangle of two sets: act (Cj, 6, bi), react (Ri, 6, bj).
template <int ROWS>
__global__ void __launch_bounds__(kThreads, min_blocks<ROWS>())
    aj_sym_cross_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                        const int64_t bi, const float4* __restrict__ pos_j,
                        const float4* __restrict__ vel_j, const int64_t bj, const float eps2,
                        float* __restrict__ act_out, float* __restrict__ react_out) {
  constexpr int T = kThreads * ROWS;
  __shared__ AjShared sh;
  const int64_t c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float act[kComps][ROWS];
  aj_tile_pair<ROWS, false>(pos_i, vel_i, bi, row0, pos_j, vel_j, bj, col0, eps2,
                            react_out + r * kComps * bj, bj, act, sh);
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t b = row0 + threadIdx.x + u * kThreads;
    if (b < bi) {
#pragma unroll
      for (int comp = 0; comp < kComps; ++comp) act_out[(c * kComps + comp) * bi + b] = act[comp][u];
    }
  }
}

template <int ROWS>
cudaError_t launch_aj_tri(const float4* pos, const float4* vel, int64_t n, float eps2,
                          float* scratch, cudaStream_t stream) {
  const int64_t tiles = cdiv(n, kThreads * ROWS);
  const int64_t blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  aj_sym_tri_kernel<ROWS><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
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
  const dim3 grid(static_cast<unsigned>(cj), static_cast<unsigned>(ri));
  aj_sym_cross_kernel<ROWS><<<grid, kThreads, 0, stream>>>(pos_i, vel_i, bi, pos_j, vel_j, bj,
                                                            eps2, act, react);
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
