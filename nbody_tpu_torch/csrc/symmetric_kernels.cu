// Each-pair-once (Newton's third law) Plummer gravity for Hopper (sm_90a):
// the triangle and the cross-rectangle kernels of nbody_tpu_torch, and the
// triangle's reaction ablations, all on one walk (sym_walk).
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
//   d = p_j - p_i;  r2 = |d|^2 + eps2;  inv = rsqrt(r2);  c = inv^3;
//   a_i += m_j * c * d   (the action)      a_j -= m_i * c * d   (the reaction)
// as symmetric_kernel.py:145-170. The triangle keeps j > i on the tiles of
// the diagonal, which also drops the self pair; every other tile is
// mask-free because row and column tiles have one size.
//
// Arithmetic, one pair: 3 FADD for d, r2 = fma(dz, dz, fma(dy, dy, fma(dx,
// dx, eps2))) (3 FFMA, eps2 folded into the first), one MUFU.RSQ, 2 FMUL for
// c, 2 FMUL for s = m_j c and t = m_i c, 3 FFMA for the action and 3 for the
// reaction: 16 FP32-pipe instructions. Every operation is written as a
// rounded intrinsic (__fsub_rn, __fmaf_rn, __fmul_rn), so that nvcc cannot
// contract one instantiation differently from another: the triangle, the
// rectangle and the three ablations have one action arithmetic by
// construction. The diagonal's mask is a select on s and t, never a product:
// at eps = 0 the self pair has inv = inf, and 0 * inf is NaN.
//
// rsqrt: rsqrt_ftz (sym_common.cuh), the PTX rsqrt.approx.ftz.f32, one
// MUFU.RSQ: the bits of rsqrtf for every normal r2 without its subnormal
// fix-up (a compare and two predicated FMULs a pair); a subnormal r2 needs
// eps = 0 and |d| < 1.1e-19, and gives inf (the self pair's value).
//
// What bounds it on an H100: issue of arithmetic. A pair is 28 flops by the
// JAX package's count (symmetric_kernel.py:285) for both sides, i.e. 14
// FP32-pipe instructions at two flops each; the walk adds the MUFU and, every
// step of ROWS pairs, one 16-byte LDS and 3 SHFL: 16 + 1 + 4 / ROWS a pair
// by the source (17.5 at ROWS 8). The inputs are 16 bytes a body.
//
// Design (T = 128 * ROWS, ROWS in {1, 2, 4, 8}; a block of 128 threads takes
// one T x T tile pair from the triangle's flat worklist of the R(R+1)/2 tile
// pairs c >= r (the TPU's _pair_tables, symmetric_kernel.py:196-209), or
// from the rectangle's 2-D grid; blocks run in no order, nothing is carried
// between them and nothing is added with atomics):
//   * i-side in registers: ROWS rows a thread, each with its position and
//     its 3 action sums.
//   * j-side in shared memory: the column tile is walked in sub-tiles of 128
//     bodies (kSub), each staged once (one body a thread), every 32-body
//     chunk stored twice in a row, so that at step k a lane reads chunk body
//     (lane + k) & 31 at slot lane + k: one 16-byte LDS at a constant offset,
//     conflict-free. No shuffle of the j-body.
//   * Only the 3 reaction sums travel around the warp (__shfl_sync): a lane
//     carries the sums of the body it holds to the next lane after every
//     step, and after 32 steps they are back in the lane that staged it.
//   * Reactions flushed every sub-tile: the 4 warps' sums meet in shared
//     memory (4 * 3 * 128 floats, 6 KB), and after a __syncthreads() thread
//     x adds column x's four in warp order and writes the block's reaction
//     slot. On a diagonal tile that slot is the one the action of the same
//     body goes to: the thread that flushes column x owns row x, reads the
//     slot back after its walk and writes action + reaction there.
//   * Shared memory: 10 KB a block at every ROWS (the staged chunks and the
//     warps' sums), so registers alone set the blocks an SM (min_blocks).
// Sum order, fixed: an action sums its columns in walk order (sub-tile,
// chunk, step); a reaction sums its rows in step order, the ROWS rows of a
// step in row order, then the warps in warp order. Each block writes its
// action partial of the row tile into the scratch row of its column tile,
// and its reaction partial of the column tile into the scratch row of its
// row tile (on the diagonal one partial: action + reaction); every (tile,
// component, body) slot is written once, and a second kernel adds each
// body's slots in tile order. A state gives the same bits on every call.
// Scratch: ceil(N/T) * 3 * N floats; 50 MB at N = 65536, T = 1024 (201 MB at
// T = 256). The blocked composition (ops/cuda_kernel.py) caps a launch at
// SYM_BLOCK_CAP bodies a side; the cross kernel holds two such scratches.
// The tile, the cap and the walk's unroll (kUnroll) were set on the card by
// scripts/torch_sym_dispatch.py (ops/cuda_kernel.py, sym_default_dispatch;
// PERF.md, Findings).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_sym_dispatch.py,
// in turns with the j-shuffle walk this design replaced, medians of six): the
// walk 17.94 SASS instructions a pair at ROWS 8 (22.09 before; 16 FP32-pipe,
// 1 MUFU, 0.12 LDS, 0.38 SHFL, 0.38 integer, 0.06 branch), 123 registers;
// the triangle 1.531 ms at N = 65536 (1.819), the rectangle (67584, 67584)
// 3.158 (3.659): 59-61 % of the 28-flop bound, 75-78 % of the issue bound.
//
// The ablations (sym_ablate_kernel, a timing experiment): the triangle's
// walk with the reaction tail R. kFull is the production tail; it keeps a
// diagonal block's action and reaction apart (the reaction into a (3, N)
// side array), so the partial sums give the action and the reaction
// separately, and also their total in the production order, which equals
// nbody_sym_accel_f32's bits. kNone drops the reaction: no t, no reaction
// sums and no reaction shuffles, on the same staged-j walk. kTreeSmall keeps
// the reaction's arithmetic and its shuffle carry, and drops the warps'
// shared-memory sum, the per-sub-tile flush and the per-column scratch
// write: a lane adds its sums into 3 registers, and a block writes one slot
// of 3 floats, its reaction total (wrong physics by design). The
// differences of their times price the reaction's arithmetic with its
// shuffles (tree_small - none), and its warp sum, scratch write and
// partial-sum pass (full - tree_small).
//
// Precision: fp32 only; built with -O3 and without --use_fast_math.
//
// Edges: any N, Bi, Bj. A slot past the end loads mass 0 (and position 0) on
// both sides, so it exerts no action (m_j = 0) and no reaction (m_i = 0),
// and nothing is written for it.
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

constexpr int kSub = kThreads;      // columns a sub-tile, one staged a thread
constexpr int kChunks = kSub / 32;  // 32-column chunks a sub-tile
// Steps of the 32-step walk unrolled. On the H100 at tile 1024, 2 beat 1, 4
// and 8 (scripts/torch_sym_dispatch.py; PERF.md, Findings).
constexpr int kUnroll = 2;

// The least blocks an SM that ptxas must fit (registers set them: shared
// memory is 10 KB a block). At ROWS 8, 4 blocks at 123 registers beat 5 at
// 96 by 4 % on the H100.
template <int ROWS>
constexpr int min_blocks() {
  return ROWS == 8 ? 4 : ROWS == 4 ? 5 : 8;
}

// The reaction tail of sym_walk: the production kernels' (kFull), and the
// two ablations of the budget experiment (sym_ablate_kernel): kNone drops
// the reaction (no t, no reaction sums, no reaction shuffles), kTreeSmall
// keeps its arithmetic and its shuffle carry but adds each lane's sums into
// three registers (rsum) instead of flushing the warps' sums.
enum class Reaction { kFull, kNone, kTreeSmall };

struct SymShared {
  float4 pos[kChunks][64];       // each chunk's 32 j-bodies, twice in a row
  float red[kWarps][3][kSub];    // the warps' reaction sums of a sub-tile
};

// One T x T tile pair: rows [row0, row0 + T) of the i-set against columns
// [col0, col0 + T) of the j-set (DIAG: row0 == col0, one set, j > i kept).
// Leaves each thread's action on its rows in act[comp][u]. With kFull it
// writes the block's reaction on column body b to react[comp * stride + b]
// once a sub-tile; with kTreeSmall it adds this lane's reaction sums of the
// bodies it staged into rsum[3].
template <int ROWS, bool DIAG, Reaction R>
__device__ __forceinline__ void sym_walk(const float4* __restrict__ pos_i, const int64_t ni,
                                         const int64_t row0, const float4* __restrict__ pos_j,
                                         const int64_t nj, const int64_t col0, const float eps2,
                                         float* react, const int64_t stride,
                                         float (&act)[3][ROWS], SymShared& sh,
                                         float (&rsum)[3]) {
  constexpr int T = kThreads * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pi[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t ig = row0 + tid + u * kThreads;
    pi[u] = (ig < ni) ? pos_i[ig] : zero;
    act[0][u] = 0.f;
    act[1][u] = 0.f;
    act[2][u] = 0.f;
  }
  const int src = (lane + 1) & 31;
#pragma unroll 1
  for (int sub = 0; sub < T / kSub; ++sub) {
    const int js0 = sub * kSub;  // the sub-tile's first local column
    {
      const int64_t jg = col0 + js0 + tid;
      const float4 p = (jg < nj) ? pos_j[jg] : zero;
      sh.pos[warp][lane] = p;
      sh.pos[warp][lane + 32] = p;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      const float4* jp = &sh.pos[c][lane];
      float rx = 0.f, ry = 0.f, rz = 0.f;
      // step k: this lane holds chunk body (lane + k) & 31 and its sums
#pragma unroll(kUnroll)
      for (int k = 0; k < 32; ++k) {
        const float4 pj = jp[k];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const float dx = __fsub_rn(pj.x, pi[u].x);
          const float dy = __fsub_rn(pj.y, pi[u].y);
          const float dz = __fsub_rn(pj.z, pi[u].z);
          const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)));
          const float inv = rsqrt_ftz(r2);
          const float c3 = __fmul_rn(__fmul_rn(inv, inv), inv);
          float s = __fmul_rn(pj.w, c3);  // action on i per unit of d
          float t = 0.f;                  // reaction on j per unit of d
          if constexpr (R != Reaction::kNone) t = __fmul_rn(pi[u].w, c3);
          if constexpr (DIAG) {
            // strict upper triangle by local index (row0 == col0): a select,
            // not a product, since the masked self pair is inf at eps = 0
            const bool keep = js0 + c * 32 + ((lane + k) & 31) > tid + u * kThreads;
            s = keep ? s : 0.f;
            t = keep ? t : 0.f;
          }
          act[0][u] = __fmaf_rn(s, dx, act[0][u]);
          act[1][u] = __fmaf_rn(s, dy, act[1][u]);
          act[2][u] = __fmaf_rn(s, dz, act[2][u]);
          if constexpr (R != Reaction::kNone) {
            rx = __fmaf_rn(-t, dx, rx);
            ry = __fmaf_rn(-t, dy, ry);
            rz = __fmaf_rn(-t, dz, rz);
          }
        }
        if constexpr (R != Reaction::kNone) {
          rx = __shfl_sync(kFull, rx, src);
          ry = __shfl_sync(kFull, ry, src);
          rz = __shfl_sync(kFull, rz, src);
        }
      }
      // after 32 passes the sums of chunk body `lane` are back in this lane
      if constexpr (R == Reaction::kFull) {
        sh.red[warp][0][c * 32 + lane] = rx;
        sh.red[warp][1][c * 32 + lane] = ry;
        sh.red[warp][2][c * 32 + lane] = rz;
      } else if constexpr (R == Reaction::kTreeSmall) {
        if (col0 + js0 + c * 32 + lane < nj) {  // a slot past the end holds no body
          rsum[0] += rx;
          rsum[1] += ry;
          rsum[2] += rz;
        }
      }
    }
    // every warp is past this sub-tile's reads of sh.pos (and, with kFull,
    // has written its sums) before the flush and the next staging
    __syncthreads();
    if constexpr (R == Reaction::kFull) {
      // column js0 + tid: the four warps' sums in warp order; the next
      // sub-tile writes sh.red only after the barrier that follows its
      // staging, so every read here comes first
      const int64_t jg = col0 + js0 + tid;
      if (jg < nj) {
#pragma unroll
        for (int comp = 0; comp < 3; ++comp) {
          react[comp * stride + jg] = warp_sum<kSub, 3>(&sh.red[0][0][0], comp, tid);
        }
      }
    }
  }
}

// Triangle of one set: scratch (R, 3, n), R = ceil(n / T); slot (t, comp, b)
// holds body b's sum over the tile pair of its tile and tile t.
template <int ROWS>
__global__ void __launch_bounds__(kThreads, min_blocks<ROWS>())
    sym_tri_kernel(const float4* __restrict__ pos, const int64_t n, const int64_t num_tiles,
                   const float eps2, float* __restrict__ scratch) {
  constexpr int T = kThreads * ROWS;
  __shared__ SymShared sh;
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float act[3][ROWS];
  float rsum[3];
  // the reaction goes to row r's slots; on the diagonal (r == c) those are
  // the slots of the same bodies' action, read back below
  float* react = scratch + r * 3 * n;
  if (r == c) {
    sym_walk<ROWS, true, Reaction::kFull>(pos, n, row0, pos, n, col0, eps2, react, n, act, sh,
                                          rsum);
  } else {
    sym_walk<ROWS, false, Reaction::kFull>(pos, n, row0, pos, n, col0, eps2, react, n, act, sh,
                                           rsum);
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t b = row0 + threadIdx.x + u * kThreads;
    if (b < n) {
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        float* slot = scratch + (c * 3 + comp) * n + b;
        // this thread flushed column b of the diagonal (kSub == kThreads)
        *slot = (r == c) ? __fadd_rn(act[comp][u], *slot) : act[comp][u];
      }
    }
  }
}

// Rectangle of two sets: act (Cj, 3, bi), react (Ri, 3, bj).
template <int ROWS>
__global__ void __launch_bounds__(kThreads, min_blocks<ROWS>())
    sym_cross_kernel(const float4* __restrict__ pos_i, const int64_t bi,
                     const float4* __restrict__ pos_j, const int64_t bj, const float eps2,
                     float* __restrict__ act_out, float* __restrict__ react_out) {
  constexpr int T = kThreads * ROWS;
  __shared__ SymShared sh;
  const int64_t c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float act[3][ROWS];
  float rsum[3];
  sym_walk<ROWS, false, Reaction::kFull>(pos_i, bi, row0, pos_j, bj, col0, eps2,
                                         react_out + r * 3 * bj, bj, act, sh, rsum);
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t b = row0 + threadIdx.x + u * kThreads;
    if (b < bi) {
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) act_out[(c * 3 + comp) * bi + b] = act[comp][u];
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
__global__ void __launch_bounds__(kThreads, min_blocks<ROWS>())
    sym_ablate_kernel(const float4* __restrict__ pos, const int64_t n, const int64_t num_tiles,
                      const float eps2, float* __restrict__ scratch, float* __restrict__ side,
                      float* __restrict__ slots) {
  constexpr int T = kThreads * ROWS;
  __shared__ SymShared sh;
  __shared__ float wsum[kWarps * 3];
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  float act[3][ROWS];
  float rsum[3] = {0.f, 0.f, 0.f};
  if (r == c) {
    sym_walk<ROWS, true, R>(pos, n, row0, pos, n, col0, eps2, side, n, act, sh, rsum);
  } else {
    sym_walk<ROWS, false, R>(pos, n, row0, pos, n, col0, eps2, scratch + r * 3 * n, n, act, sh,
                             rsum);
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t b = row0 + threadIdx.x + u * kThreads;
    if (b < n) {
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) scratch[(c * 3 + comp) * n + b] = act[comp][u];
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
      if (lane == 0) wsum[warp * 3 + comp] = v;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float v = wsum[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += wsum[w * 3 + threadIdx.x];
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
