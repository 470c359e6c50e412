// Double-single (fp64-grade) all-pairs Plummer gravity for Hopper (sm_90a),
// one-sided: the fused ds Euler step, the fused ds drift-kick-drift
// (leapfrog) step and the ds acceleration alone of nbody_tpu_torch.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   nbody_ds_step     <- nbody_tpu/ops/ds_kernel.py::_ds_step_kernel
//                        (nbody_step_pallas_ds_vs / nbody_step_pallas_ds)
//   nbody_ds_leapfrog <- nbody_tpu/ops/ds_kernel.py::_ds_leapfrog_kernel
//                        (nbody_step_pallas_ds_leapfrog_vs)
//   nbody_ds_accel    <- nbody_tpu/ops/ds_kernel.py::_ds_accel_kernel
//                        (compute_accel_pallas_ds): the force of an i-set
//                        under one j-set, as the body-sharded ring step
//                        calls it once a hop (parallel/sharded.py)
// Every value is a pair hi + lo of floats, in the arithmetic of
// ds_common.cuh. For the i-set (M bodies) under the j-set (N bodies), per
// pair (ds_kernel.py:206-219):
//   d = p_j - p_i;  r2 = (dx^2 + dy^2) + (dz^2 + eps2);  inv = ds_rsqrt(r2)
//   inv3 = (inv * inv) * inv;  a_i += (m_j * inv3) * d
// with m_j's lo part (masses drawn in float64 do not fit in hi alone).
// The step then applies v' = (v + a dt) * damping and p' = p + v' dt in ds
// (ds_kernel.py:240-256); the leapfrog step half-drifts both sides first,
// p_half = p + v dt/2, takes the force at the half-step positions, and
// ends with v' = (v + a dt) * damping, p' = p_half + v' dt/2
// (ds_kernel.py:575-655). Mass and vel.w are carried through from both
// planes. The self pair adds 0 because d = 0 exactly in ds. The accel
// kernel stores the ds acceleration as (M, 4) hi and lo rows with w = 0,
// the JAX kernel's layout (ds_kernel.py:391-392); it runs the step
// kernel's j-loop (ds_chunk_force) in the same j-chunks, so its force
// followed by the ds Euler update (ds_integrate_kernel) gives the fused
// step's bits.
//
// State: four (N, 4) float planes pos_hi, pos_lo, vel_hi, vel_lo, AoS
// [x, y, z, m] / [vx, vy, vz, w]. dt, eps^2, damping and dt/2 come as hi/lo
// pairs in a (2, 4) block in device memory (ops/ds.py::scal_ds, or
// ds_scal_with_dt's, built on the device by an adaptive step), which every
// kernel reads at its start.
//
// Design. One thread an i-body keeps its position and three ds sums in
// registers; the block stages the j-bodies through shared memory, hi and
// lo as two float4 arrays (32 bytes a body), and every thread reads each
// staged body as a broadcast. The TPU kernel's (TILE_I, 128) lane
// accumulators and their pairwise lane reduction have no counterpart: a
// thread owns a row of its j-chunk.
// The three kernels split the j-range, as the ds accel + jerk kernel does
// (ds_aj_kernels.cu): one thread an i-body at block 128 gives M / 128
// blocks, 128 at the ds default N = 16384 and 32 at a four-card shard
// (M = 4096), for 132 SMs and a dependent ds chain ~225 FP32-pipe
// instructions a pair. So their grid is (i-blocks, S): chunk c of the
// j-range is [c * L, min((c + 1) * L, N)), L = ceil(ceil(N / kDsStage) /
// S) stages of kDsStage j-bodies whatever the block size, S a pure
// function of M and N (ops/cuda_kernel.py::ds_splits, one rule for all
// three). The walk is one function, ds_chunk_force; the leapfrog kernel's
// form half-drifts each j-body once as it is staged (DRIFT), and its i-body
// once before the walk. With S = 1 a block writes its outputs as the
// unsplit kernels did; with S > 1 it writes its three ds sums into the
// partials (S, 6, M), and a second kernel ds-adds each row's partials in
// chunk order (ds_slot_sum, ds_sym_common.cuh): ds_sum_partials for the
// force, ds_step_finish_kernel for the step, which then applies the same
// ds_kick_drift, ds_leapfrog_finish_kernel for the leapfrog step, which
// drifts the row's i-body again with the same ds_drift (the same bits) and
// applies the same kick and second drift. Each chunk is a ds sum in j order
// from 0, so the bits depend on (M, N) alone: not on the card, the call or
// the block size; no atomics. S = 1 gives the unsplit kernels' bits (the
// same j order and ds operations; a zero-mass padding slot adds exactly
// 0). The force followed by the ds Euler update (ds_integrate_kernel) gives
// the fused step's bits at every (M, N); a leapfrog step from zero
// velocity drifts no body, so its force is the force kernel's at every
// (M, N) too.
//
// What bounds it on an H100: the FP32 pipe. A pair is ~225 FP32-pipe
// instructions read from this source (3 ds_sub at 11, 3 squares and 2 inv3
// products as ds_mul at 9, 3 ds_add at 11 for r2, ds_rsqrt at 45 and one
// rsqrtf, m_j inv3 at 9, and 3 ds_mul + ds_add at 20 into the sums) against
// 12 and one rsqrtf for the fp32 kernel; the JAX package counts 400 flops
// a pair for the step, 450 for leapfrog and 380 for the force alone with
// Dekker's product (ds_kernel.py:354,745,451); cuobjdump counts 232 SASS
// instructions a pair in the walk, 222 on the FP32 pipe. Memory is no
// limit: 32 bytes a staged j-body for blockDim.x pairs, and 24 bytes of
// partials a row and chunk. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/torch_ds_dispatch.py, in turns with the unsplit kernels): the
// force 4.46 -> 2.10-2.13 ms at N = 16384, 85 % of the bound, and 4.46 ->
// 0.57-0.59 ms at (M, N) = (4096, 16384), a four-card shard.
//
// Edges: any M and N. A j-slot past N loads zeros in both planes, so mass 0
// and no force; a thread past M stages j-bodies and writes nothing.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous, 16-byte aligned float arrays; `scal` is a device pointer to
// the (2, 4) block; the `_split` entry points take S and a device scratch of
// S * 6 * M floats for the partials. The caller makes the arrays' device
// current; the kernels run on the given stream, allocate nothing and do not
// synchronise. Each entry point returns cudaGetLastError() after its
// launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "ds_common.cuh"
#include "ds_sym_common.cuh"

namespace {

// p + v * h per coordinate, in ds; the w lanes kept
__device__ __forceinline__ void ds_drift(float4& ph, float4& pl, const float4 vh, const float4 vl,
                                         const dsf h) {
  const dsf x = ds_add(make_ds(ph.x, pl.x), ds_mul(make_ds(vh.x, vl.x), h));
  const dsf y = ds_add(make_ds(ph.y, pl.y), ds_mul(make_ds(vh.y, vl.y), h));
  const dsf z = ds_add(make_ds(ph.z, pl.z), ds_mul(make_ds(vh.z, vl.z), h));
  ph = make_float4(x.hi, y.hi, z.hi, ph.w);
  pl = make_float4(x.lo, y.lo, z.lo, pl.w);
}

// j-bodies a shared-memory stage of the step, accel and leapfrog kernels
// (32 bytes a body: 4 KB), the j-split's unit (ops/cuda_kernel.py's
// DS_STAGE)
constexpr int kDsStage = 128;

// the ds force on the i-body at (ph, pl) from j-chunk blockIdx.y of the
// j-set, `chunk` j-bodies long (a multiple of kDsStage): the ds pair sum, in
// j order from the chunk's first body, over stages of kDsStage bodies
// whatever the block size; a slot past n holds zeros, mass 0. With DRIFT
// each j-body is half-drifted by its velocity (jvh, jvl; s.dt_half) as it is
// staged, the leapfrog kernel's half-step j-set; without, jvh and jvl are
// not read.
template <bool DRIFT>
__device__ __forceinline__ void ds_chunk_force(const float4 ph, const float4 pl,
                                               const float4* __restrict__ jph,
                                               const float4* __restrict__ jpl,
                                               const float4* __restrict__ jvh,
                                               const float4* __restrict__ jvl, const int64_t n,
                                               const int64_t chunk, const ds_scalars s, dsf& ax,
                                               dsf& ay, dsf& az) {
  __shared__ float4 th[kDsStage];
  __shared__ float4 tl[kDsStage];
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  const dsf xi = make_ds(ph.x, pl.x);
  const dsf yi = make_ds(ph.y, pl.y);
  const dsf zi = make_ds(ph.z, pl.z);
  ax = make_ds(0.f, 0.f);
  ay = ax;
  az = ax;
  for (int64_t base = j0; base < j1; base += kDsStage) {
    for (int k = threadIdx.x; k < kDsStage; k += blockDim.x) {
      const int64_t j = base + k;
      if constexpr (DRIFT) {
        float4 h = zero4();
        float4 l = zero4();
        if (j < n) {
          h = jph[j];
          l = jpl[j];
          ds_drift(h, l, jvh[j], jvl[j], s.dt_half);
        }
        th[k] = h;
        tl[k] = l;
      } else {
        th[k] = j < n ? jph[j] : zero4();
        tl[k] = j < n ? jpl[j] : zero4();
      }
    }
    __syncthreads();
    for (int k = 0; k < kDsStage; ++k) {
      const float4 qh = th[k];
      const float4 ql = tl[k];
      dsf dx, dy, dz, inv3;
      ds_pair(make_ds(qh.x, ql.x), make_ds(qh.y, ql.y), make_ds(qh.z, ql.z), xi, yi, zi, s.eps2,
              dx, dy, dz, inv3);
      const dsf sc = ds_mul(make_ds(qh.w, ql.w), inv3);  // m_j / r^3
      ax = ds_add(ax, ds_mul(sc, dx));
      ay = ds_add(ay, ds_mul(sc, dy));
      az = ds_add(az, ds_mul(sc, dz));
    }
    __syncthreads();
  }
}

// the chunk's three ds sums into its partial slots (ds_sym_common.cuh's
// layout: hi x y z, then lo x y z)
__device__ __forceinline__ void put_force(float* parts, const int64_t m, const int64_t i,
                                          const dsf ax, const dsf ay, const dsf az) {
  const int64_t t = blockIdx.y;
  ds_put<6>(parts, t, 0, m, i, ax);
  ds_put<6>(parts, t, 1, m, i, ay);
  ds_put<6>(parts, t, 2, m, i, az);
}

// Row blockIdx.x * blockDim.x + threadIdx.x of the i-set against j-chunk
// blockIdx.y. parts == nullptr (one chunk): the four new planes; else the
// chunk's partial force
__global__ void ds_step_kernel(const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
                               const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
                               const float4* __restrict__ jpos_hi,
                               const float4* __restrict__ jpos_lo, float4* __restrict__ new_pos_hi,
                               float4* __restrict__ new_pos_lo, float4* __restrict__ new_vel_hi,
                               float4* __restrict__ new_vel_lo, const int64_t m, const int64_t n,
                               const int64_t chunk, const float* __restrict__ scal,
                               float* __restrict__ parts) {
  const ds_scalars s = read_scalars(scal);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4 ph = (i < m) ? pos_hi[i] : zero4();
  const float4 pl = (i < m) ? pos_lo[i] : zero4();
  dsf ax, ay, az;
  ds_chunk_force<false>(ph, pl, jpos_hi, jpos_lo, nullptr, nullptr, n, chunk, s, ax, ay, az);
  if (i >= m) return;
  if (parts != nullptr) {
    put_force(parts, m, i, ax, ay, az);
    return;
  }
  ds_kick_drift(ph, pl, vel_hi[i], vel_lo[i], ax, ay, az, s.dt, s.damping, s.dt, new_pos_hi + i,
                new_pos_lo + i, new_vel_hi + i, new_vel_lo + i);
}

// The split step's update, one thread a row: the ds sum of the row's
// `splits` partial forces in chunk order, then the step's ds_kick_drift
__global__ void __launch_bounds__(128)
    ds_step_finish_kernel(const float* __restrict__ parts, const int64_t splits,
                          const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
                          const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
                          float4* __restrict__ new_pos_hi, float4* __restrict__ new_pos_lo,
                          float4* __restrict__ new_vel_hi, float4* __restrict__ new_vel_lo,
                          const int64_t m, const float* __restrict__ scal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const ds_scalars s = read_scalars(scal);
  dsf ax, ay, az;
  ds_slot_sum3(parts, splits, 6, m, i, ax, ay, az);
  ds_kick_drift(pos_hi[i], pos_lo[i], vel_hi[i], vel_lo[i], ax, ay, az, s.dt, s.damping, s.dt,
                new_pos_hi + i, new_pos_lo + i, new_vel_hi + i, new_vel_lo + i);
}

// Row i against j-chunk blockIdx.y of the half-drifted j-set: the i-body is
// drifted once to its half-step position, the chunk's j-bodies as they are
// staged. parts == nullptr (one chunk): the kick and second drift into the
// four new planes; else the chunk's partial force
__global__ void ds_leapfrog_kernel(
    const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
    const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
    const float4* __restrict__ jpos_hi, const float4* __restrict__ jpos_lo,
    const float4* __restrict__ jvel_hi, const float4* __restrict__ jvel_lo,
    float4* __restrict__ new_pos_hi, float4* __restrict__ new_pos_lo,
    float4* __restrict__ new_vel_hi, float4* __restrict__ new_vel_lo, const int64_t m,
    const int64_t n, const int64_t chunk, const float* __restrict__ scal,
    float* __restrict__ parts) {
  const ds_scalars s = read_scalars(scal);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4 ph = (i < m) ? pos_hi[i] : zero4();
  float4 pl = (i < m) ? pos_lo[i] : zero4();
  const float4 vh = (i < m) ? vel_hi[i] : zero4();
  const float4 vl = (i < m) ? vel_lo[i] : zero4();
  ds_drift(ph, pl, vh, vl, s.dt_half);  // the i-body's half-step position
  dsf ax, ay, az;
  ds_chunk_force<true>(ph, pl, jpos_hi, jpos_lo, jvel_hi, jvel_lo, n, chunk, s, ax, ay, az);
  if (i >= m) return;
  if (parts != nullptr) {
    put_force(parts, m, i, ax, ay, az);
    return;
  }
  ds_kick_drift(ph, pl, vh, vl, ax, ay, az, s.dt, s.damping, s.dt_half, new_pos_hi + i,
                new_pos_lo + i, new_vel_hi + i, new_vel_lo + i);
}

// The split leapfrog step's update, one thread a row: the ds sum of the
// row's `splits` partial forces in chunk order, the i-body drifted to its
// half-step position again (ds_drift, the same bits as in the walk), then
// the kick and second drift (ds_kick_drift)
__global__ void __launch_bounds__(128)
    ds_leapfrog_finish_kernel(const float* __restrict__ parts, const int64_t splits,
                              const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
                              const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
                              float4* __restrict__ new_pos_hi, float4* __restrict__ new_pos_lo,
                              float4* __restrict__ new_vel_hi, float4* __restrict__ new_vel_lo,
                              const int64_t m, const float* __restrict__ scal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const ds_scalars s = read_scalars(scal);
  dsf ax, ay, az;
  ds_slot_sum3(parts, splits, 6, m, i, ax, ay, az);
  float4 ph = pos_hi[i];
  float4 pl = pos_lo[i];
  const float4 vh = vel_hi[i];
  const float4 vl = vel_lo[i];
  ds_drift(ph, pl, vh, vl, s.dt_half);
  ds_kick_drift(ph, pl, vh, vl, ax, ay, az, s.dt, s.damping, s.dt_half, new_pos_hi + i,
                new_pos_lo + i, new_vel_hi + i, new_vel_lo + i);
}

// Row i against j-chunk blockIdx.y, as ds_step_kernel. parts == nullptr:
// the (m, 4) hi and lo rows with w = 0; else the chunk's partial force
__global__ void ds_accel_kernel(const float4* __restrict__ pos_hi,
                                const float4* __restrict__ pos_lo,
                                const float4* __restrict__ jpos_hi,
                                const float4* __restrict__ jpos_lo, float4* __restrict__ acc_hi,
                                float4* __restrict__ acc_lo, const int64_t m, const int64_t n,
                                const int64_t chunk, const float* __restrict__ scal,
                                float* __restrict__ parts) {
  const ds_scalars s = read_scalars(scal);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4 ph = (i < m) ? pos_hi[i] : zero4();
  const float4 pl = (i < m) ? pos_lo[i] : zero4();
  dsf ax, ay, az;
  ds_chunk_force<false>(ph, pl, jpos_hi, jpos_lo, nullptr, nullptr, n, chunk, s, ax, ay, az);
  if (i >= m) return;
  if (parts != nullptr) {
    put_force(parts, m, i, ax, ay, az);
    return;
  }
  acc_hi[i] = make_float4(ax.hi, ay.hi, az.hi, 0.f);
  acc_lo[i] = make_float4(ax.lo, ay.lo, az.lo, 0.f);
}

bool valid_block_size(int64_t bs) { return bs >= 32 && bs <= 1024 && bs % 32 == 0; }

unsigned int num_blocks(int64_t m, int64_t bs) {
  return static_cast<unsigned int>((m + bs - 1) / bs);
}

bool valid_split(int64_t bs, int64_t m, int64_t n, int64_t splits, const void* parts) {
  return valid_block_size(bs) && m >= 0 && n >= 0 && splits >= 1 && splits <= 65535 &&
         (splits == 1 || parts != nullptr);
}

// the j-chunk length, in whole stages, of `splits` chunks of n j-bodies
int64_t chunk_of(int64_t n, int64_t splits) { return cdiv(cdiv(n, kDsStage), splits) * kDsStage; }

// The grid (i-blocks, splits) of ds_step_kernel, then with splits > 1 the
// update from the partials in `parts` (splits * 6 * m floats)
int launch_ds_step(const void* pos_hi, const void* pos_lo, const void* vel_hi, const void* vel_lo,
                   const void* jpos_hi, const void* jpos_lo, void* new_pos_hi, void* new_pos_lo,
                   void* new_vel_hi, void* new_vel_lo, int64_t m, int64_t n, const float* scal,
                   int64_t block_size, int64_t splits, float* parts, cudaStream_t stream) {
  if (!valid_split(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const dim3 grid(num_blocks(m, block_size), static_cast<unsigned int>(splits));
  ds_step_kernel<<<grid, static_cast<unsigned int>(block_size), 0, stream>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float4*>(jpos_hi), static_cast<const float4*>(jpos_lo),
      static_cast<float4*>(new_pos_hi), static_cast<float4*>(new_pos_lo),
      static_cast<float4*>(new_vel_hi), static_cast<float4*>(new_vel_lo), m, n,
      chunk_of(n, splits), scal, splits > 1 ? parts : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  ds_step_finish_kernel<<<num_blocks(m, 128), 128, 0, stream>>>(
      parts, splits, static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<float4*>(new_pos_hi), static_cast<float4*>(new_pos_lo),
      static_cast<float4*>(new_vel_hi), static_cast<float4*>(new_vel_lo), m, scal);
  return cudaGetLastError();
}

// The grid (i-blocks, splits) of ds_leapfrog_kernel, then with splits > 1
// the update from the partials in `parts` (splits * 6 * m floats)
int launch_ds_leapfrog(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                       const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                       const void* jvel_hi, const void* jvel_lo, void* new_pos_hi,
                       void* new_pos_lo, void* new_vel_hi, void* new_vel_lo, int64_t m, int64_t n,
                       const float* scal, int64_t block_size, int64_t splits, float* parts,
                       cudaStream_t stream) {
  if (!valid_split(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const dim3 grid(num_blocks(m, block_size), static_cast<unsigned int>(splits));
  ds_leapfrog_kernel<<<grid, static_cast<unsigned int>(block_size), 0, stream>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float4*>(jpos_hi), static_cast<const float4*>(jpos_lo),
      static_cast<const float4*>(jvel_hi), static_cast<const float4*>(jvel_lo),
      static_cast<float4*>(new_pos_hi), static_cast<float4*>(new_pos_lo),
      static_cast<float4*>(new_vel_hi), static_cast<float4*>(new_vel_lo), m, n,
      chunk_of(n, splits), scal, splits > 1 ? parts : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  ds_leapfrog_finish_kernel<<<num_blocks(m, 128), 128, 0, stream>>>(
      parts, splits, static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<float4*>(new_pos_hi), static_cast<float4*>(new_pos_lo),
      static_cast<float4*>(new_vel_hi), static_cast<float4*>(new_vel_lo), m, scal);
  return cudaGetLastError();
}

// The grid (i-blocks, splits) of ds_accel_kernel, then with splits > 1 the
// chunk-ordered ds sum of the partials into the (m, 4) rows
int launch_ds_accel(const void* pos_hi, const void* pos_lo, const void* jpos_hi,
                    const void* jpos_lo, void* acc_hi, void* acc_lo, int64_t m, int64_t n,
                    const float* scal, int64_t block_size, int64_t splits, float* parts,
                    cudaStream_t stream) {
  if (!valid_split(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const dim3 grid(num_blocks(m, block_size), static_cast<unsigned int>(splits));
  ds_accel_kernel<<<grid, static_cast<unsigned int>(block_size), 0, stream>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(jpos_hi), static_cast<const float4*>(jpos_lo),
      static_cast<float4*>(acc_hi), static_cast<float4*>(acc_lo), m, n, chunk_of(n, splits),
      scal, splits > 1 ? parts : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return ds_sum_partials(parts, splits, 6, m, static_cast<float*>(acc_hi),
                         static_cast<float*>(acc_lo), 4, 1, 1, stream);
}

}  // namespace

extern "C" {

// the four new planes of the i-set (m, 4) after one ds Euler step under
// the j-set (n, 4), one j-chunk (S = 1)
int nbody_ds_step(const void* pos_hi, const void* pos_lo, const void* vel_hi, const void* vel_lo,
                  const void* jpos_hi, const void* jpos_lo, void* new_pos_hi, void* new_pos_lo,
                  void* new_vel_hi, void* new_vel_lo, int64_t m, int64_t n, const float* scal,
                  int64_t block_size, void* stream) {
  return launch_ds_step(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, new_pos_hi, new_pos_lo,
                        new_vel_hi, new_vel_lo, m, n, scal, block_size, 1, nullptr,
                        static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 6 * m floats, the
// chunks' ds partials, ds-added in chunk order before the update
int nbody_ds_step_split(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                        const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                        void* new_pos_hi, void* new_pos_lo, void* new_vel_hi, void* new_vel_lo,
                        int64_t m, int64_t n, const float* scal, int64_t block_size,
                        int64_t splits, void* scratch, void* stream) {
  return launch_ds_step(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, new_pos_hi, new_pos_lo,
                        new_vel_hi, new_vel_lo, m, n, scal, block_size, splits,
                        static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));
}

// the four new planes of the i-set (m, 4) after one fused ds DKD step under
// the j-set (n, 4), whose velocities drift it too, one j-chunk (S = 1)
int nbody_ds_leapfrog(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                      const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                      const void* jvel_hi, const void* jvel_lo, void* new_pos_hi,
                      void* new_pos_lo, void* new_vel_hi, void* new_vel_lo, int64_t m, int64_t n,
                      const float* scal, int64_t block_size, void* stream) {
  return launch_ds_leapfrog(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo,
                            new_pos_hi, new_pos_lo, new_vel_hi, new_vel_lo, m, n, scal,
                            block_size, 1, nullptr, static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 6 * m floats, the
// chunks' ds partials, ds-added in chunk order before the update
int nbody_ds_leapfrog_split(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                            const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                            const void* jvel_hi, const void* jvel_lo, void* new_pos_hi,
                            void* new_pos_lo, void* new_vel_hi, void* new_vel_lo, int64_t m,
                            int64_t n, const float* scal, int64_t block_size, int64_t splits,
                            void* scratch, void* stream) {
  return launch_ds_leapfrog(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo,
                            new_pos_hi, new_pos_lo, new_vel_hi, new_vel_lo, m, n, scal,
                            block_size, splits, static_cast<float*>(scratch),
                            static_cast<cudaStream_t>(stream));
}

// the ds acceleration of the i-set (m, 4) under the j-set (n, 4), as (m, 4)
// hi and lo rows with w = 0, one j-chunk (S = 1); `scal` needs only eps^2
// (column 1)
int nbody_ds_accel(const void* pos_hi, const void* pos_lo, const void* jpos_hi,
                   const void* jpos_lo, void* acc_hi, void* acc_lo, int64_t m, int64_t n,
                   const float* scal, int64_t block_size, void* stream) {
  return launch_ds_accel(pos_hi, pos_lo, jpos_hi, jpos_lo, acc_hi, acc_lo, m, n, scal,
                         block_size, 1, nullptr, static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 6 * m floats, the
// chunks' ds partials, ds-added in chunk order into the rows
int nbody_ds_accel_split(const void* pos_hi, const void* pos_lo, const void* jpos_hi,
                         const void* jpos_lo, void* acc_hi, void* acc_lo, int64_t m, int64_t n,
                         const float* scal, int64_t block_size, int64_t splits, void* scratch,
                         void* stream) {
  return launch_ds_accel(pos_hi, pos_lo, jpos_hi, jpos_lo, acc_hi, acc_lo, m, n, scal,
                         block_size, splits, static_cast<float*>(scratch),
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
