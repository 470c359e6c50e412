// All-pairs Plummer gravity for Hopper (sm_90a), one-sided: the fused Euler
// step, its transposed-carry, dual-bank and packed-state twins, the
// force-only kernel, the accel + jerk kernel and the potential kernel of
// nbody_tpu_torch.
//
// Replaces seven Pallas TPU kernels, five of the JAX package and two of its
// experiment scripts:
//   nbody_step_f32       <- nbody_tpu/ops/pallas_kernel.py::_step_kernel
//                           (nbody_step_pallas_vs / nbody_step_pallas)
//   nbody_step_t_f32     <- nbody_tpu/ops/pallas_kernel.py::_step_kernel_t
//                           (def :202, pallas_call :557; nbody_rollout_pallas)
//   nbody_accel_f32      <- nbody_tpu/ops/pallas_kernel.py::_accel_kernel
//                           (def :272, pallas_call :462; compute_accel_pallas)
//   nbody_accel_jerk_f32 <- nbody_tpu/ops/pallas_kernel.py::_accel_jerk_kernel
//                           (compute_accel_jerk_pallas)
//   nbody_potential_f32  <- nbody_tpu/ops/pallas_kernel.py::_potential_kernel
//                           (potential_energy_pallas's per-row sums)
//   nbody_step_dual_f32  <- scripts/tpu_r3_dualbank.py::_dual_kernel
//                           (def :36, pallas_call :115; step_dual)
//   nbody_step_packed_f32 <- scripts/tpu_r3_packed.py::_packed_kernel
//                           (def :33, pallas_call :81; step_packed)
// The step and force kernels compute, for the i-set (M bodies) under the
// j-set (N bodies),
//   d = p_j - p_i;  r2 = |d|^2 + eps2;  inv = rsqrtf(r2);  s = m_j * inv^3;
//   a_i += s * d
// exactly as pallas_kernel.py:79-87. The self pair adds 0 only because d = 0,
// so softening = 0 gives NaN for it, as in the JAX package and the reference.
// The step kernel then applies v = (v + a*dt)*damping, p = p + v*dt and
// copies pos.w (mass) and vel.w through (pallas_kernel.py:106-122).
//
// Design. The step kernel, its three twins (step_t, step_dual,
// step_packed) and the force kernel (accel_kernel) run one walk, walk_chunk
// (allpairs_common.cuh), on the one-sided accel + jerk kernel's recipe
// (below); so do the fused ring's hops (ring_kernels.cu):
//   * ROWS i-bodies a thread (kStepRows = 4 at blocks of up to 512 threads,
//     1 above; 2 for step_dual_kernel), rows u * blockDim.x apart, each with
//     its position and three sums in registers, so one shared-memory
//     broadcast of a j-body serves ROWS pairs;
//   * the pair as 3 FADD, 3 FFMA, one MUFU.RSQ (rsqrt_ftz, sym_common.cuh:
//     rsqrtf's bits for every normal r2, without its subnormal fix-up), 3
//     FMUL and 3 FFMA into the sums, every operation written out (fmaf) so
//     that no instantiation contracts differently;
//   * the j-side staged kStepStage bodies at a time (4 KB) whatever the
//     block size, the walk over a stage unrolled kStepUnroll times;
//   * a j-split: the grid is (i-tiles, S), chunk c of the j-range
//     [c * L, min((c + 1) * L, N)), L a whole number of stages, S a pure
//     function of M and N (ops/cuda_kernel.py::step_splits, one rule for
//     the step, its twins and the force). With S = 1 a block applies the
//     update and writes its layout (the force: its sums into acc); with
//     S > 1 it writes its three sums into the partials (S, 3, M), and a
//     second kernel adds each row's partials in chunk order from 0
//     (step_finish_kernel, which then applies the same update, euler_update;
//     for the force sum_partials, sym_common.cuh). Each row sums its chunk
//     from 0 in j order, so the bits depend on (M, N) alone: not on ROWS,
//     the block, the card or the call. The four twins therefore give one
//     another's bits at every block, and the force's sums are the very
//     numbers the step kernel adds before its update. No atomics.
// The Pallas kernel's (TILE_I, 128) lane accumulators, their lane reduction
// and its VMEM scratch have no counterpart: a thread owns whole rows of its
// j-chunk.
//
// What bounds the step and the force on an H100: issue. A pair is ~20
// flops by the reference's count, 12 FP32-pipe instructions and one
// MUFU.RSQ (its unit runs at an eighth of the FP32 rate: 8 cycles a warp,
// under the 12), plus a quarter of an LDS.128 at ROWS 4 and the loop's
// share. Memory is no limit: 16 bytes a staged j-body for blockDim.x * ROWS
// pairs, and the partials' 12 bytes a row and chunk.
//
// Precision: fp32 only. rsqrtf (rsqrt_ftz in the step and force kernels,
// its bits for every normal input) is the hardware approximation (at most 2
// ulp), which is what the reference CUDA kernel uses; the QA bound
// (|dpos| <= 5e-4 after one dt=1e-3 step against the CPU oracle) and the
// kernel-vs-plain bound (1e-4 * max|a| + 1e-4 on the acceleration) cover
// it. Built with -O3 and without --use_fast_math, so plain divisions and
// square roots stay IEEE; nvcc does contract a*b+c into FMAs.
//
// Edges: any M and N. A j-slot past N loads mass 0 (the zero-mass padding
// of pallas_kernel.py:29-30), and a thread past M writes nothing.
//
// Accel + jerk (accel_jerk_kernel, the Hermite scheme's force evaluation,
// pallas_kernel.py:618-637), with dv = v_j - v_i over the xyz lanes only
// (vel.w is not a velocity):
//   r2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2)));  inv = rsqrt(r2)
//   inv2 = inv^2;  s = m_j inv2 inv;  w = 3 inv2 (d . dv)
//   a_i += s d;  j_i += s (dv - w d)
// 26 FP32-pipe instructions a pair (6 FADD for d and dv, 3 FFMA for r2, 3
// FMUL for inv2 and s, 5 for w, 3 FFMA for dv - w d, 6 FFMA for the sums)
// and one MUFU.RSQ: rsqrt_ftz (sym_common.cuh), the bits of rsqrtf for every
// normal r2 without its subnormal fix-up. The JAX package forms the jerk as
// s (dv - rv3 d), rv3 = 3 (d . dv) inv2, which rounds differently, within the
// 1e-4 * max + 1e-4 that the tests and chip_smoke.py hold the kernel to. The
// self pair adds 0 because d = dv = 0 (NaN at softening 0, as in the JAX
// package). A pair is 48 flops by the JAX package's count
// (pallas_kernel.py:697); the inputs are 32 bytes a body.
// Design, for the Hopper issue rate rather than the TPU's grid:
//   * ROWS i-bodies a thread (kAjRows; rows u * blockDim.x apart), each with
//     its position, velocity and six sums in registers, so one shared-memory
//     broadcast of a j-body (two LDS.128: position, velocity) serves ROWS
//     pairs. Blocks above 512 threads take one row a thread: 1024 threads
//     leave 64 registers a thread.
//   * The j-side is staged kAjStage bodies at a time (8 KB of shared memory,
//     whatever the block size), the walk over a stage unrolled kAjUnroll
//     times.
//   * A j-split: the grid is (i-tiles, S). Chunk c of the j-range is
//     [c * L, min((c + 1) * L, N)), L = ceil(ceil(N / kAjStage) / S) stages,
//     so each chunk is a whole number of stages. S is a pure function of M
//     and N (ops/cuda_kernel.py::aj_splits): at the i-shapes of a sharded
//     step (M = N / D) the i-tiles alone leave SMs idle. With S = 1 a block
//     writes acc and jerk; with S > 1 it writes its six sums into the
//     partials (S, 6, M), and sum_partials (sym_common.cuh) adds each row's
//     partials in chunk order. Each row sums its chunk's j-bodies in index
//     order from 0, so the result depends on (M, N) only: the same bits on
//     every card, every call and every block size. No atomics.
//
// What bounds it on an H100: issue. At ROWS 4 a pair is the 26 FP32-pipe
// instructions, the MUFU, half an LDS and the loop's share (28.12 SASS
// instructions); the memory traffic (32 bytes a j-body for blockDim.x * ROWS
// pairs a thread block, the partials' 24 bytes a row and chunk) is far below
// the card's rate. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/torch_aj_dispatch.py, in turns with the one-row kernel it
// replaced): 4.78 ms at (M, N) = (65536, 65536) (6.22 before), 75 % of the
// issue bound; 1.23 ms at (16384, 65536), a four-card hop (4.22 before).
//
// Potential (pallas_kernel.py:726-742): row i holds
//   sum_{j != i} m_i m_j rsqrtf(|d|^2 + eps2),
// the self pair dropped by its global index (a select, since it is inf at
// eps = 0), not by d = 0. 12 flops a pair by the JAX package's count.
// Only the self set is taken (M = N), as the JAX kernel takes it; the total
// -1/2 sum_i is left to the caller, as pallas_kernel.py:792 leaves it to XLA.
// Design (potential_kernel, walk_potential in allpairs_common.cuh), the
// step's recipe: ROWS rows a thread (rows_a_thread), j staged kStepStage
// bodies at a time, the pair as 3 FADD, 3 FFMA, rsqrt_ftz and one FFMA into
// the row's sum of m_j / r, m_i multiplied in once at the end (one rounding
// where a pair's m_i m_j / r rounds N - 1 times: within 2^-24 of the row,
// against the 1e-4 relative the kernel is held to); the self mask only in
// the stages that hold one of the block's own rows (or end the set); the
// j-split of the step (ops/cuda_kernel.py::step_splits at (N, N)), each
// chunk's sums into the partials (S, N), potential_finish_kernel adding them
// in chunk order from 0 and multiplying by m_i. The bits depend on N alone,
// not on the block (128, 256 or 1024 threads) or the call. What bounds it on
// an H100: the SFU. A pair is 7 FP32-pipe instructions and one MUFU.RSQ, 16
// a clock an SM: 1.03 ms at N=65536 on 132 SMs at 1.98 GHz, above the 12
// flops' 0.769 ms at 67 TFLOP/s.
//
// The transposed-carry step (step_t_kernel): the step kernel's arithmetic
// through the same template (fused_step), with the j-side read from the four
// (N,) planes x, y, z, m of the current positions instead of the (N,4)
// array, and the new positions written a second time into the planes of the
// next step (ping-ponged by the caller: a launch never writes the planes it
// reads). The j order and every operation are those of step_kernel, so k
// launches equal k step launches bit for bit. On the TPU the planes saved
// an XLA transpose a step (0.61 ms at N=65536) and still lost to the plain
// scan, a recorded negative result. On Hopper the bound is the step
// kernel's (arithmetic; a pair's j-body is one shared-memory broadcast
// either way): staging a tile from the planes is four coalesced 4-byte
// loads a body instead of one 16-byte load, and each step writes 16 more
// bytes a body, O(N) against O(N^2) pair work, so it can neither win nor
// lose by more than that. No path of the port calls it, as no path of the
// JAX package calls nbody_rollout_pallas.
//
// The dual-bank step (step_dual_kernel): the step kernel with two i-bodies a
// thread, rows u * blockDim.x apart, and two independent accumulator sets
// (fused_step<2, 1>). On the TPU the script split a 128-row i-tile into two
// 64-row banks to halve the per-tile boundary cost and keep two dependency
// chains. On Hopper the chains are the point: each staged j-body, one
// shared-memory broadcast, feeds two rows, so a pair costs half a broadcast
// and the FMA pipe has two independent chains to interleave. The bound is
// the step kernel's (20 flops a pair). Each row sums its j-chunks in the
// step kernel's order, so the two give the same bits at every block; they
// differ only in ROWS (times in PERF.md, row 21).
//
// The packed-state step (step_packed_kernel): the step with body i's state
// as one 32-byte row [pos | vel] of an (N, 8) array (fused_step<ROWS, 2>),
// read once and written once, and the j-side from the (4, N) planes, whose
// next copy it writes as step_t_kernel does. On the TPU packing halved the
// per-i-tile DMA count. On Hopper it changes only the O(N) i-side traffic,
// so it times what the planes and the row layout cost beside step_kernel
// and step_t_kernel, with which it agrees bit for bit (the same j order and
// operations; times in PERF.md, row 22).
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays: pos/vel (M,4) or (N,4) AoS, 16-byte aligned
// (float4 loads), acc (M,3); the `_split` entry points take S and a device
// scratch for the partials (S * 3 * M floats for the steps and the force,
// S * 6 * M for accel + jerk, S * N for the potential). The caller makes the
// arrays' device current; the kernel runs on the given stream of that
// device, allocates nothing and does not synchronise. Each entry point
// returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "allpairs_common.cuh"
#include "sym_common.cuh"

namespace {

// The one-sided accel + jerk kernel's constants. i-bodies a thread at blocks
// of up to 512 threads: on an H100 80GB HBM3, 4 rows (107 registers, 28.12
// SASS instructions a pair) ran 2.6-3.6 % ahead of 2 (64, 29.25) at every
// timed shape. j-bodies a shared-memory stage: the j-split's unit
// (ops/cuda_kernel.py's AJ_STAGE). Steps of a stage's walk unrolled: 2 ran
// 2.4 % ahead of 1 and within 3 % of 4 (PERF.md, Findings).
constexpr int kAjRows = 4;
constexpr int kAjStage = 256;
constexpr int kAjUnroll = 2;

// The step and force kernels' walk (walk_chunk, allpairs_common.cuh, with
// its constants kStepRows, kStepStage, kStepUnroll) is the accel + jerk
// walk's recipe without the jerk (12 FP32-pipe instructions a pair against
// 26, so the loop and the shared-memory read weigh more). step_dual_kernel
// keeps its 2 rows a thread at every block.
constexpr int kDualRows = 2;

// The j-side loaders: the (N,4) array of the step and force kernels and the
// (4, N) planes x, y, z, m that the rollout carries. Both give the same
// float4, so the staged j-body, and every bit after it, is the same.
struct AosJ {
  const float4* __restrict__ p;
  __device__ __forceinline__ float4 operator()(const int64_t j) const { return p[j]; }
};

struct PlanesJ {
  const float* __restrict__ t;  // (4, ld): x, y, z, m
  int64_t ld;
  __device__ __forceinline__ float4 operator()(const int64_t j) const {
    return make_float4(t[j], t[ld + j], t[2 * ld + j], t[3 * ld + j]);
  }
};

// The damped Euler update of row i from its summed acceleration: v = (v +
// a dt) damping, p = p + v dt, pos.w and vel.w carried; the new state at
// STRIDE (as fused_step reads it) and, with `new_post`, the new position in
// the (4, m) planes too. Shared by the one-chunk walk and the finish kernel,
// so a row's update is the same operations whichever applies it.
template <int STRIDE>
__device__ __forceinline__ void euler_update(const float4 pi, const float4 vi, const float ax,
                                             const float ay, const float az, const float dt,
                                             const float damping, const int64_t i,
                                             const int64_t m, float4* __restrict__ new_pos,
                                             float4* __restrict__ new_vel,
                                             float* __restrict__ new_post) {
  const float vx = fmaf(ax, dt, vi.x) * damping;
  const float vy = fmaf(ay, dt, vi.y) * damping;
  const float vz = fmaf(az, dt, vi.z) * damping;
  const float4 np = make_float4(fmaf(vx, dt, pi.x), fmaf(vy, dt, pi.y), fmaf(vz, dt, pi.z), pi.w);
  new_vel[STRIDE * i] = make_float4(vx, vy, vz, vi.w);
  new_pos[STRIDE * i] = np;
  if (new_post != nullptr) {
    new_post[i] = np.x;
    new_post[m + i] = np.y;
    new_post[2 * m + i] = np.z;
    new_post[3 * m + i] = np.w;
  }
}

// The fused Euler step of ROWS i-bodies a thread against j-chunk blockIdx.y,
// shared by step_kernel, step_t_kernel, step_dual_kernel and
// step_packed_kernel so that they give the same bits. A block covers ROWS *
// blockDim.x rows from blockIdx.x * ROWS * blockDim.x (load_rows). Body i's
// position and velocity are pos_i[STRIDE * i] and vel_i[STRIDE * i] (STRIDE
// 2: the packed [pos|vel] rows, vel_i = pos_i + 1). The chunk is [blockIdx.y
// * chunk, min((blockIdx.y + 1) * chunk, n)), `chunk` a multiple of
// kStepStage, walked by walk_chunk. parts == nullptr (one chunk): the update
// (euler_update) and its outputs; else the row's three sums into the
// partials (store_chunk).
template <int ROWS, int STRIDE, class JLoad>
__device__ __forceinline__ void fused_step(const float4* __restrict__ pos_i,
                                           const float4* __restrict__ vel_i,
                                           const JLoad load_j, float4* __restrict__ new_pos,
                                           float4* __restrict__ new_vel,
                                           float* __restrict__ new_post, const int64_t m,
                                           const int64_t n, const int64_t chunk, const float dt,
                                           const float eps2, const float damping,
                                           float* __restrict__ parts) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ROWS * blockDim.x + threadIdx.x;
  float4 pi[ROWS];
  float ax[ROWS], ay[ROWS], az[ROWS];
  load_rows<ROWS, STRIDE>(pos_i, i0, m, pi);
  walk_chunk<ROWS>(pi, load_j, static_cast<int64_t>(blockIdx.y) * chunk, chunk, n, eps2, ax, ay,
                   az);
  if (parts != nullptr) {
    store_chunk<ROWS>(parts, blockIdx.y, i0, m, ax, ay, az);
    return;
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    if (i >= m) continue;
    euler_update<STRIDE>(pi[u], vel_i[STRIDE * i], ax[u], ay[u], az[u], dt, damping, i, m,
                         new_pos, new_vel, new_post);
  }
}

// The split step's update, one thread a row: the row's `splits` partial
// sums (splits, 3, m) added in chunk order from 0, then euler_update
template <int STRIDE>
__global__ void __launch_bounds__(256)
    step_finish_kernel(const float* __restrict__ parts, const int64_t splits,
                       const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                       float4* __restrict__ new_pos, float4* __restrict__ new_vel,
                       float* __restrict__ new_post, const int64_t m, const float dt,
                       const float damping) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int64_t t = 0; t < splits; ++t) {
    ax += parts[(t * 3 + 0) * m + i];
    ay += parts[(t * 3 + 1) * m + i];
    az += parts[(t * 3 + 2) * m + i];
  }
  euler_update<STRIDE>(pos_i[STRIDE * i], vel_i[STRIDE * i], ax, ay, az, dt, damping, i, m,
                       new_pos, new_vel, new_post);
}

template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    step_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                const float4* __restrict__ pos_j, float4* __restrict__ new_pos,
                float4* __restrict__ new_vel, const int64_t m, const int64_t n,
                const int64_t chunk, const float dt, const float eps2, const float damping,
                float* __restrict__ parts) {
  fused_step<ROWS, 1>(pos_i, vel_i, AosJ{pos_j}, new_pos, new_vel, nullptr, m, n, chunk, dt, eps2,
                      damping, parts);
}

// The step of the dual-bank experiment (scripts/tpu_r3_dualbank.py): two
// i-bodies a thread, two independent accumulator chains, each staged j-body
// read once from shared memory for both; ceil(m / (2 * blockDim.x)) i-tiles.
__global__ void __launch_bounds__(1024)
    step_dual_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                     const float4* __restrict__ pos_j, float4* __restrict__ new_pos,
                     float4* __restrict__ new_vel, const int64_t m, const int64_t n,
                     const int64_t chunk, const float dt, const float eps2, const float damping,
                     float* __restrict__ parts) {
  fused_step<kDualRows, 1>(pos_i, vel_i, AosJ{pos_j}, new_pos, new_vel, nullptr, m, n, chunk, dt,
                           eps2, damping, parts);
}

// One step of the transposed-carry rollout (nbody_tpu's _step_kernel_t):
// the j-side from the planes `post` (4, n) of the current positions, the new
// positions written twice, as (n,4) and as the planes `new_post` (4, n) that
// the next step reads (by the finish kernel when the step is split). The
// i-set is the whole set; `new_post` must not be `post`, which other blocks
// are still reading.
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    step_t_kernel(const float4* __restrict__ pos, const float4* __restrict__ vel,
                  const float* __restrict__ post, float4* __restrict__ new_pos,
                  float4* __restrict__ new_vel, float* __restrict__ new_post, const int64_t n,
                  const int64_t chunk, const float dt, const float eps2, const float damping,
                  float* __restrict__ parts) {
  fused_step<ROWS, 1>(pos, vel, PlanesJ{post, n}, new_pos, new_vel, new_post, n, n, chunk, dt,
                      eps2, damping, parts);
}

// One step of the packed-state experiment (scripts/tpu_r3_packed.py): body
// i's row of `state` is 32 bytes, [pos | vel] as two float4, read once and
// written once into `new_state`; the j-side from the planes `post` (4, n),
// the new positions also written into the planes `new_post` (4, n), which
// must not be `post`.
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    step_packed_kernel(const float4* __restrict__ state, const float* __restrict__ post,
                       float4* __restrict__ new_state, float* __restrict__ new_post,
                       const int64_t n, const int64_t chunk, const float dt, const float eps2,
                       const float damping, float* __restrict__ parts) {
  fused_step<ROWS, 2>(state, state + 1, PlanesJ{post, n}, new_state, new_state + 1, new_post, n,
                      n, chunk, dt, eps2, damping, parts);
}

// The force of ROWS i-bodies a thread against j-chunk blockIdx.y: the step
// kernel's walk (fused_step without the update), so its sums are the ones
// the step applies. parts == nullptr (one chunk): the sums into acc (M, 3);
// else into the partials (store_chunk), which sum_partials adds.
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    accel_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ pos_j,
                 float* __restrict__ acc, const int64_t m, const int64_t n, const int64_t chunk,
                 const float eps2, float* __restrict__ parts) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ROWS * blockDim.x + threadIdx.x;
  float4 pi[ROWS];
  float ax[ROWS], ay[ROWS], az[ROWS];
  load_rows<ROWS, 1>(pos_i, i0, m, pi);
  walk_chunk<ROWS>(pi, AosJ{pos_j}, static_cast<int64_t>(blockIdx.y) * chunk, chunk, n, eps2, ax,
                   ay, az);
  if (parts != nullptr) {
    store_chunk<ROWS>(parts, blockIdx.y, i0, m, ax, ay, az);
    return;
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    if (i >= m) continue;
    acc[3 * i + 0] = ax[u];
    acc[3 * i + 1] = ay[u];
    acc[3 * i + 2] = az[u];
  }
}

// Rows [i0, i0 + blockDim.x * ROWS) of the i-set, row u of this thread at
// i0 + threadIdx.x + u * blockDim.x, against j-chunk blockIdx.y, `chunk`
// j-bodies long (a multiple of kAjStage). parts == nullptr: acc and jerk
// (M, 3); else the chunk's partials parts[(blockIdx.y * 6 + comp) * m + i].
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    accel_jerk_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                      const float4* __restrict__ pos_j, const float4* __restrict__ vel_j,
                      const int64_t m, const int64_t n, const int64_t chunk, const float eps2,
                      float* __restrict__ acc, float* __restrict__ jerk,
                      float* __restrict__ parts) {
  __shared__ float4 sp[kAjStage];
  __shared__ float4 sv[kAjStage];
  const int bs = blockDim.x;
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * bs * ROWS + tid;
  float px[ROWS], py[ROWS], pz[ROWS], vx[ROWS], vy[ROWS], vz[ROWS];
  float a[6][ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * bs;
    const float4 p = (i < m) ? pos_i[i] : zero;
    const float4 v = (i < m) ? vel_i[i] : zero;
    px[u] = p.x;
    py[u] = p.y;
    pz[u] = p.z;
    vx[u] = v.x;
    vy[u] = v.y;
    vz[u] = v.z;
#pragma unroll
    for (int c = 0; c < 6; ++c) a[c][u] = 0.f;
  }
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kAjStage) {
    for (int k = tid; k < kAjStage; k += bs) {
      const int64_t j = base + k;
      sp[k] = (j < n) ? pos_j[j] : zero;
      sv[k] = (j < n) ? vel_j[j] : zero;
    }
    __syncthreads();
#pragma unroll(kAjUnroll)
    for (int k = 0; k < kAjStage; ++k) {
      const float4 pj = sp[k];
      const float4 vj = sv[k];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const float dx = pj.x - px[u];
        const float dy = pj.y - py[u];
        const float dz = pj.z - pz[u];
        const float dvx = vj.x - vx[u];
        const float dvy = vj.y - vy[u];
        const float dvz = vj.z - vz[u];
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
        const float inv = rsqrt_ftz(r2);
        const float inv2 = inv * inv;
        const float s = pj.w * (inv2 * inv);  // m_j / r^3
        const float w = (3.f * inv2) * fmaf(dz, dvz, fmaf(dy, dvy, dx * dvx));
        a[0][u] = fmaf(s, dx, a[0][u]);
        a[1][u] = fmaf(s, dy, a[1][u]);
        a[2][u] = fmaf(s, dz, a[2][u]);
        a[3][u] = fmaf(s, fmaf(-w, dx, dvx), a[3][u]);
        a[4][u] = fmaf(s, fmaf(-w, dy, dvy), a[4][u]);
        a[5][u] = fmaf(s, fmaf(-w, dz, dvz), a[5][u]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * bs;
    if (i >= m) continue;
    if (parts == nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[3 * i + c] = a[c][u];
        jerk[3 * i + c] = a[3 + c][u];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 6; ++c) parts[(blockIdx.y * 6 + c) * m + i] = a[c][u];
    }
  }
}

// The potential of ROWS rows a thread against j-chunk blockIdx.y of the set
// itself (walk_potential). parts == nullptr (one chunk): per_row[i] = m_i *
// the row's sum; else the sum into the partials parts[blockIdx.y * n + i],
// which potential_finish_kernel adds. The launch bounds ask for 1024 /
// MAX_THREADS blocks an SM, up to 64 registers a thread: left to choose,
// ptxas gave the 1024-thread instantiation 32 and spilled.
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1024 / MAX_THREADS)
    potential_kernel(const float4* __restrict__ pos, float* __restrict__ per_row,
                     const int64_t n, const int64_t chunk, const float eps2,
                     float* __restrict__ parts) {
  const int64_t own_lo = static_cast<int64_t>(blockIdx.x) * ROWS * blockDim.x;
  const int64_t i0 = own_lo + threadIdx.x;
  float4 pi[ROWS];
  float u[ROWS];
  load_rows<ROWS, 1>(pos, i0, n, pi);
  walk_potential<ROWS>(pi, pos, i0, own_lo, own_lo + ROWS * blockDim.x,
                       static_cast<int64_t>(blockIdx.y) * chunk, chunk, n, eps2, u);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t i = i0 + static_cast<int64_t>(r) * blockDim.x;
    if (i >= n) continue;
    if (parts != nullptr) {
      parts[static_cast<int64_t>(blockIdx.y) * n + i] = u[r];
    } else {
      per_row[i] = pi[r].w * u[r];
    }
  }
}

// The split potential's rows, one thread a row: the row's `splits` partial
// sums (splits, n) added in chunk order from 0, times m_i
__global__ void __launch_bounds__(256)
    potential_finish_kernel(const float* __restrict__ parts, const int64_t splits,
                            const float4* __restrict__ pos, float* __restrict__ per_row,
                            const int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float u = 0.f;
  for (int64_t c = 0; c < splits; ++c) u += parts[c * n + i];
  per_row[i] = pos[i].w * u;
}

bool valid_block_size(int64_t bs) { return bs >= 32 && bs <= 1024 && bs % 32 == 0; }

unsigned int num_blocks(int64_t m, int64_t bs) {
  return static_cast<unsigned int>((m + bs - 1) / bs);
}

// The grid (i-tiles, splits) of accel_jerk_kernel, then with splits > 1 the
// chunk-ordered sum of the partials in `parts` (splits * 6 * m floats).
int launch_accel_jerk(const void* pos_i, const void* vel_i, const void* pos_j,
                      const void* vel_j, void* acc, void* jerk, int64_t m, int64_t n, float eps2,
                      int64_t block_size, int64_t splits, float* parts, cudaStream_t stream) {
  if (!valid_block_size(block_size) || m < 0 || n < 0 || splits > 65535) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const int64_t chunk = cdiv(cdiv(n, kAjStage), splits) * kAjStage;
  const auto pi = static_cast<const float4*>(pos_i);
  const auto vi = static_cast<const float4*>(vel_i);
  const auto pj = static_cast<const float4*>(pos_j);
  const auto vj = static_cast<const float4*>(vel_j);
  auto a = static_cast<float*>(acc);
  auto g = static_cast<float*>(jerk);
  float* out_parts = splits > 1 ? parts : nullptr;
  const auto bs = static_cast<unsigned int>(block_size);
  if (block_size <= 512) {
    const dim3 grid(num_blocks(m, block_size * kAjRows), static_cast<unsigned int>(splits));
    accel_jerk_kernel<kAjRows, 512><<<grid, bs, 0, stream>>>(pi, vi, pj, vj, m, n, chunk, eps2,
                                                             a, g, out_parts);
  } else {
    const dim3 grid(num_blocks(m, block_size), static_cast<unsigned int>(splits));
    accel_jerk_kernel<1, 1024><<<grid, bs, 0, stream>>>(pi, vi, pj, vj, m, n, chunk, eps2, a, g,
                                                        out_parts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  err = sum_partials(parts, splits, 6, m, a, 3, 1, 0, stream);
  if (err != cudaSuccess) return err;
  return sum_partials(parts + 3 * m, splits, 6, m, g, 3, 1, 0, stream);
}


bool valid_step(int64_t bs, int64_t m, int64_t n, int64_t splits, const void* parts) {
  return valid_block_size(bs) && m >= 0 && n >= 0 && splits >= 1 && splits <= 65535 &&
         (splits == 1 || parts != nullptr);
}

// A step on the grid (i-tiles of rows * block_size rows, splits):
// walk(grid, chunk, parts or nullptr) launches the step kernel, then with
// splits > 1 step_finish_kernel<STRIDE> adds the partials in `parts`
// (splits * 3 * m floats) and applies the update.
template <int STRIDE, class Walk>
int launch_split(const Walk walk, const int64_t rows, const float4* pos_i, const float4* vel_i,
                 float4* new_pos, float4* new_vel, float* new_post, int64_t m, int64_t n,
                 float dt, float damping, int64_t block_size, int64_t splits, float* parts,
                 cudaStream_t stream) {
  if (!valid_step(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const dim3 grid(num_blocks(m, rows * block_size), static_cast<unsigned int>(splits));
  walk(grid, step_chunk(n, splits), splits > 1 ? parts : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  step_finish_kernel<STRIDE><<<num_blocks(m, 256), 256, 0, stream>>>(
      parts, splits, pos_i, vel_i, new_pos, new_vel, new_post, m, dt, damping);
  return cudaGetLastError();
}

// launch_split of a step kernel that comes in two instantiations: `four`
// (<kStepRows, 512>) at blocks of up to 512 threads, `one` (<1, 1024>)
// above, as rows_a_thread picks; walk(kernel, grid, chunk, parts or nullptr)
// launches `kernel`.
template <int STRIDE, class Kernel, class Walk>
int launch_step(const Kernel four, const Kernel one, const Walk walk, const float4* pos_i,
                const float4* vel_i, float4* new_pos, float4* new_vel, float* new_post,
                int64_t m, int64_t n, float dt, float damping, int64_t block_size,
                int64_t splits, float* parts, cudaStream_t stream) {
  const int rows = rows_a_thread(block_size);
  const Kernel kernel = rows == kStepRows ? four : one;
  const auto launch = [&](const dim3 grid, const int64_t chunk, float* out) {
    walk(kernel, grid, chunk, out);
  };
  return launch_split<STRIDE>(launch, rows, pos_i, vel_i, new_pos, new_vel, new_post, m, n, dt,
                              damping, block_size, splits, parts, stream);
}

int launch_step_f32(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                    void* new_vel, int64_t m, int64_t n, float dt, float eps2, float damping,
                    int64_t block_size, int64_t splits, float* parts, cudaStream_t stream) {
  const auto pi = static_cast<const float4*>(pos_i);
  const auto vi = static_cast<const float4*>(vel_i);
  const auto pj = static_cast<const float4*>(pos_j);
  const auto np = static_cast<float4*>(new_pos);
  const auto nv = static_cast<float4*>(new_vel);
  const auto bs = static_cast<unsigned int>(block_size);
  const auto walk = [&](const auto kernel, const dim3 grid, const int64_t chunk, float* out) {
    kernel<<<grid, bs, 0, stream>>>(pi, vi, pj, np, nv, m, n, chunk, dt, eps2, damping, out);
  };
  return launch_step<1>(step_kernel<kStepRows, 512>, step_kernel<1, 1024>, walk, pi, vi, np, nv,
                        nullptr, m, n, dt, damping, block_size, splits, parts, stream);
}

int launch_step_t_f32(const void* pos, const void* vel, const void* post, void* new_pos,
                      void* new_vel, void* new_post, int64_t n, float dt, float eps2,
                      float damping, int64_t block_size, int64_t splits, float* parts,
                      cudaStream_t stream) {
  const auto p = static_cast<const float4*>(pos);
  const auto v = static_cast<const float4*>(vel);
  const auto pt = static_cast<const float*>(post);
  const auto np = static_cast<float4*>(new_pos);
  const auto nv = static_cast<float4*>(new_vel);
  const auto npt = static_cast<float*>(new_post);
  const auto bs = static_cast<unsigned int>(block_size);
  const auto walk = [&](const auto kernel, const dim3 grid, const int64_t chunk, float* out) {
    kernel<<<grid, bs, 0, stream>>>(p, v, pt, np, nv, npt, n, chunk, dt, eps2, damping, out);
  };
  return launch_step<1>(step_t_kernel<kStepRows, 512>, step_t_kernel<1, 1024>, walk, p, v, np,
                        nv, npt, n, n, dt, damping, block_size, splits, parts, stream);
}

int launch_step_dual_f32(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                         void* new_vel, int64_t m, int64_t n, float dt, float eps2,
                         float damping, int64_t block_size, int64_t splits, float* parts,
                         cudaStream_t stream) {
  const auto pi = static_cast<const float4*>(pos_i);
  const auto vi = static_cast<const float4*>(vel_i);
  const auto pj = static_cast<const float4*>(pos_j);
  const auto np = static_cast<float4*>(new_pos);
  const auto nv = static_cast<float4*>(new_vel);
  const auto bs = static_cast<unsigned int>(block_size);
  const auto walk = [&](const dim3 grid, const int64_t chunk, float* out) {
    step_dual_kernel<<<grid, bs, 0, stream>>>(pi, vi, pj, np, nv, m, n, chunk, dt, eps2, damping,
                                              out);
  };
  return launch_split<1>(walk, kDualRows, pi, vi, np, nv, nullptr, m, n, dt, damping,
                         block_size, splits, parts, stream);
}

int launch_step_packed_f32(const void* state, const void* post, void* new_state, void* new_post,
                           int64_t n, float dt, float eps2, float damping, int64_t block_size,
                           int64_t splits, float* parts, cudaStream_t stream) {
  const auto st = static_cast<const float4*>(state);
  const auto pt = static_cast<const float*>(post);
  const auto ns = static_cast<float4*>(new_state);
  const auto npt = static_cast<float*>(new_post);
  const auto bs = static_cast<unsigned int>(block_size);
  const auto walk = [&](const auto kernel, const dim3 grid, const int64_t chunk, float* out) {
    kernel<<<grid, bs, 0, stream>>>(st, pt, ns, npt, n, chunk, dt, eps2, damping, out);
  };
  return launch_step<2>(step_packed_kernel<kStepRows, 512>, step_packed_kernel<1, 1024>, walk,
                        st, st + 1, ns, ns + 1, npt, n, n, dt, damping, block_size, splits,
                        parts, stream);
}

// The force on the grid (i-tiles of rows_a_thread * block_size rows,
// splits), then with splits > 1 sum_partials adds the partials in `parts`
// (splits * 3 * m floats) in chunk order into acc.
int launch_accel_f32(const void* pos_i, const void* pos_j, void* acc, int64_t m, int64_t n,
                     float eps2, int64_t block_size, int64_t splits, float* parts,
                     cudaStream_t stream) {
  if (!valid_step(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const auto pi = static_cast<const float4*>(pos_i);
  const auto pj = static_cast<const float4*>(pos_j);
  const auto a = static_cast<float*>(acc);
  const int rows = rows_a_thread(block_size);
  const dim3 grid(num_blocks(m, rows * block_size), static_cast<unsigned int>(splits));
  const auto bs = static_cast<unsigned int>(block_size);
  const int64_t chunk = step_chunk(n, splits);
  float* out = splits > 1 ? parts : nullptr;
  if (rows == kStepRows) {
    accel_kernel<kStepRows, 512><<<grid, bs, 0, stream>>>(pi, pj, a, m, n, chunk, eps2, out);
  } else {
    accel_kernel<1, 1024><<<grid, bs, 0, stream>>>(pi, pj, a, m, n, chunk, eps2, out);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_partials(parts, splits, 3, m, a, 3, 1, 0, stream);
}

// The potential on the grid (i-tiles of rows_a_thread * block_size rows,
// splits), then with splits > 1 potential_finish_kernel adds the partials in
// `parts` (splits * n floats) in chunk order.
int launch_potential_f32(const void* pos, void* per_row, int64_t n, float eps2,
                         int64_t block_size, int64_t splits, float* parts,
                         cudaStream_t stream) {
  if (!valid_step(block_size, n, n, splits, parts)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto p = static_cast<const float4*>(pos);
  const auto out = static_cast<float*>(per_row);
  const int rows = rows_a_thread(block_size);
  const dim3 grid(num_blocks(n, rows * block_size), static_cast<unsigned int>(splits));
  const auto bs = static_cast<unsigned int>(block_size);
  const int64_t chunk = step_chunk(n, splits);
  float* part = splits > 1 ? parts : nullptr;
  if (rows == kStepRows) {
    potential_kernel<kStepRows, 512><<<grid, bs, 0, stream>>>(p, out, n, chunk, eps2, part);
  } else {
    potential_kernel<1, 1024><<<grid, bs, 0, stream>>>(p, out, n, chunk, eps2, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  potential_finish_kernel<<<num_blocks(n, 256), 256, 0, stream>>>(parts, splits, p, out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the new (m, 4) pos and vel of the i-set after one Euler step under the
// j-set (n, 4), one j-chunk (S = 1)
int nbody_step_f32(const void* pos_i, const void* vel_i, const void* pos_j,
                   void* new_pos, void* new_vel, int64_t m, int64_t n, float dt,
                   float eps2, float damping, int64_t block_size, void* stream) {
  return launch_step_f32(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping,
                         block_size, 1, nullptr, static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 3 * m floats, the
// chunks' partial sums, added in chunk order before the update
int nbody_step_split_f32(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                         void* new_vel, int64_t m, int64_t n, float dt, float eps2,
                         float damping, int64_t block_size, int64_t splits, void* scratch,
                         void* stream) {
  return launch_step_f32(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping,
                         block_size, splits, static_cast<float*>(scratch),
                         static_cast<cudaStream_t>(stream));
}

int nbody_step_t_f32(const void* pos, const void* vel, const void* post, void* new_pos,
                     void* new_vel, void* new_post, int64_t n, float dt, float eps2,
                     float damping, int64_t block_size, void* stream) {
  return launch_step_t_f32(pos, vel, post, new_pos, new_vel, new_post, n, dt, eps2, damping,
                           block_size, 1, nullptr, static_cast<cudaStream_t>(stream));
}

int nbody_step_t_split_f32(const void* pos, const void* vel, const void* post, void* new_pos,
                           void* new_vel, void* new_post, int64_t n, float dt, float eps2,
                           float damping, int64_t block_size, int64_t splits, void* scratch,
                           void* stream) {
  return launch_step_t_f32(pos, vel, post, new_pos, new_vel, new_post, n, dt, eps2, damping,
                           block_size, splits, static_cast<float*>(scratch),
                           static_cast<cudaStream_t>(stream));
}

int nbody_step_dual_f32(const void* pos_i, const void* vel_i, const void* pos_j,
                        void* new_pos, void* new_vel, int64_t m, int64_t n, float dt,
                        float eps2, float damping, int64_t block_size, void* stream) {
  return launch_step_dual_f32(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping,
                              block_size, 1, nullptr, static_cast<cudaStream_t>(stream));
}

int nbody_step_dual_split_f32(const void* pos_i, const void* vel_i, const void* pos_j,
                              void* new_pos, void* new_vel, int64_t m, int64_t n, float dt,
                              float eps2, float damping, int64_t block_size, int64_t splits,
                              void* scratch, void* stream) {
  return launch_step_dual_f32(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping,
                              block_size, splits, static_cast<float*>(scratch),
                              static_cast<cudaStream_t>(stream));
}

int nbody_step_packed_f32(const void* state, const void* post, void* new_state, void* new_post,
                          int64_t n, float dt, float eps2, float damping, int64_t block_size,
                          void* stream) {
  return launch_step_packed_f32(state, post, new_state, new_post, n, dt, eps2, damping,
                                block_size, 1, nullptr, static_cast<cudaStream_t>(stream));
}

int nbody_step_packed_split_f32(const void* state, const void* post, void* new_state,
                                void* new_post, int64_t n, float dt, float eps2, float damping,
                                int64_t block_size, int64_t splits, void* scratch,
                                void* stream) {
  return launch_step_packed_f32(state, post, new_state, new_post, n, dt, eps2, damping,
                                block_size, splits, static_cast<float*>(scratch),
                                static_cast<cudaStream_t>(stream));
}

// acc (m, 3) of the i-set under the j-set (n, 4), one j-chunk (S = 1)
int nbody_accel_f32(const void* pos_i, const void* pos_j, void* acc, int64_t m,
                    int64_t n, float eps2, int64_t block_size, void* stream) {
  return launch_accel_f32(pos_i, pos_j, acc, m, n, eps2, block_size, 1, nullptr,
                          static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 3 * m floats, the
// chunks' partial sums, added in chunk order into acc
int nbody_accel_split_f32(const void* pos_i, const void* pos_j, void* acc, int64_t m, int64_t n,
                          float eps2, int64_t block_size, int64_t splits, void* scratch,
                          void* stream) {
  return launch_accel_f32(pos_i, pos_j, acc, m, n, eps2, block_size, splits,
                          static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));
}

// acc (m, 3) and jerk (m, 3) of the i-set under the j-set, one j-chunk
// (S = 1): each block writes its rows' sums
int nbody_accel_jerk_f32(const void* pos_i, const void* vel_i, const void* pos_j,
                         const void* vel_j, void* acc, void* jerk, int64_t m, int64_t n,
                         float eps2, int64_t block_size, void* stream) {
  return launch_accel_jerk(pos_i, vel_i, pos_j, vel_j, acc, jerk, m, n, eps2, block_size, 1,
                           nullptr, static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 6 * m floats, the
// chunks' partials, added in chunk order into acc and jerk
int nbody_accel_jerk_split_f32(const void* pos_i, const void* vel_i, const void* pos_j,
                               const void* vel_j, void* acc, void* jerk, int64_t m, int64_t n,
                               float eps2, int64_t block_size, int64_t splits, void* scratch,
                               void* stream) {
  if (splits < 1 || scratch == nullptr) return cudaErrorInvalidValue;
  return launch_accel_jerk(pos_i, vel_i, pos_j, vel_j, acc, jerk, m, n, eps2, block_size,
                           splits, static_cast<float*>(scratch),
                           static_cast<cudaStream_t>(stream));
}

int nbody_potential_f32(const void* pos, void* per_row, int64_t n, float eps2,
                        int64_t block_size, void* stream) {
  return launch_potential_f32(pos, per_row, n, eps2, block_size, 1, nullptr,
                              static_cast<cudaStream_t>(stream));
}

int nbody_potential_split_f32(const void* pos, void* per_row, int64_t n, float eps2,
                              int64_t block_size, int64_t splits, void* scratch, void* stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return launch_potential_f32(pos, per_row, n, eps2, block_size, splits,
                              static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));
}

const char* nbody_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
