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
// kernel's j-loop (ds_accumulate), so its force followed by the ds Euler
// update (ds_integrate_kernel) gives the fused step's bits.
//
// State: four (N, 4) float planes pos_hi, pos_lo, vel_hi, vel_lo, AoS
// [x, y, z, m] / [vx, vy, vz, w]. dt, eps^2, damping and dt/2 come as hi/lo
// pairs in a (2, 4) host block (ops/ds.py::scal_ds).
//
// Design: the one-sided fp32 kernel's (nbody_kernels.cu). One thread per
// i-body keeps its position and three ds accumulators in registers; each
// block stages the j-bodies through shared memory as tiles of block_size
// bodies, hi and lo as two float4 arrays (32 bytes a body, 8 KB at block
// 256), and every thread reads each staged body as a broadcast. The
// leapfrog kernel half-drifts each j-body once as it is staged and its
// i-body once. The j-sum is a ds sum in index order, so repeat calls give
// the same bits. The TPU kernel's (TILE_I, 128) lane accumulators and their
// pairwise lane reduction have no counterpart: a thread owns a whole row.
//
// What bounds it on an H100: the FP32 pipe. A pair is ~225 FP32-pipe
// instructions read from this source (3 ds_sub at 11, 3 squares and 2 inv3
// products as ds_mul at 9, 3 ds_add at 11 for r2, ds_rsqrt at 45 and one
// rsqrtf, m_j inv3 at 9, and 3 ds_mul + ds_add at 20 into the sums) against
// 12 and one rsqrtf for the fp32 kernel; the JAX package counts 400 flops
// a pair for the step, 450 for leapfrog and 380 for the force alone with
// Dekker's product (ds_kernel.py:354,745,451). Memory is no limit: 32 bytes
// a staged j-body for block_size pairs a thread. One thread an i-body
// leaves few warps an SM when M is small (a ring hop's shard): splitting
// the j-range across blocks, with a fixed-order ds sum of the partials,
// is the known remedy (PERF.md, Open questions), not taken here.
//
// Edges: any M and N. A j-slot past N loads zeros in both planes, so mass 0
// and no force; a thread past M stages j-tiles and writes nothing.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous, 16-byte aligned float arrays; `scal` is a host pointer to the
// (2, 4) block. The caller makes the arrays' device current; the kernels run
// on the given stream, allocate nothing and do not synchronise. Each entry
// point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "ds_common.cuh"

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

// ds acceleration on the i-body at (ph, pl) from the whole j-set, staged in
// tiles of blockDim.x bodies through th / tl; with DRIFT each staged j-body
// is first half-drifted by its velocity (jvh, jvl)
template <bool DRIFT>
__device__ __forceinline__ void ds_accumulate(const float4 ph, const float4 pl,
                                              const float4* __restrict__ jph,
                                              const float4* __restrict__ jpl,
                                              const float4* __restrict__ jvh,
                                              const float4* __restrict__ jvl, const int64_t n,
                                              const ds_scalars s, float4* th, float4* tl,
                                              dsf& ax, dsf& ay, dsf& az) {
  const int bs = blockDim.x;
  const dsf xi = make_ds(ph.x, pl.x);
  const dsf yi = make_ds(ph.y, pl.y);
  const dsf zi = make_ds(ph.z, pl.z);
  for (int64_t base = 0; base < n; base += bs) {
    const int64_t j = base + threadIdx.x;
    float4 h = zero4();
    float4 l = zero4();
    if (j < n) {
      h = jph[j];
      l = jpl[j];
      if (DRIFT) ds_drift(h, l, jvh[j], jvl[j], s.dt_half);
    }
    th[threadIdx.x] = h;
    tl[threadIdx.x] = l;
    __syncthreads();
    for (int k = 0; k < bs; ++k) {
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

__global__ void ds_step_kernel(const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
                               const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
                               const float4* __restrict__ jpos_hi,
                               const float4* __restrict__ jpos_lo, float4* __restrict__ new_pos_hi,
                               float4* __restrict__ new_pos_lo, float4* __restrict__ new_vel_hi,
                               float4* __restrict__ new_vel_lo, const int64_t m, const int64_t n,
                               const ds_scalars s) {
  extern __shared__ float4 tile[];  // block_size hi bodies, then block_size lo bodies
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4 ph = (i < m) ? pos_hi[i] : zero4();
  const float4 pl = (i < m) ? pos_lo[i] : zero4();
  dsf ax = make_ds(0.f, 0.f), ay = ax, az = ax;
  ds_accumulate<false>(ph, pl, jpos_hi, jpos_lo, nullptr, nullptr, n, s, tile, tile + blockDim.x,
                       ax, ay, az);
  if (i >= m) return;
  ds_kick_drift(ph, pl, vel_hi[i], vel_lo[i], ax, ay, az, s.dt, s.damping, s.dt, new_pos_hi + i,
                new_pos_lo + i, new_vel_hi + i, new_vel_lo + i);
}

__global__ void ds_leapfrog_kernel(
    const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
    const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
    const float4* __restrict__ jpos_hi, const float4* __restrict__ jpos_lo,
    const float4* __restrict__ jvel_hi, const float4* __restrict__ jvel_lo,
    float4* __restrict__ new_pos_hi, float4* __restrict__ new_pos_lo,
    float4* __restrict__ new_vel_hi, float4* __restrict__ new_vel_lo, const int64_t m,
    const int64_t n, const ds_scalars s) {
  extern __shared__ float4 tile[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4 ph = (i < m) ? pos_hi[i] : zero4();
  float4 pl = (i < m) ? pos_lo[i] : zero4();
  const float4 vh = (i < m) ? vel_hi[i] : zero4();
  const float4 vl = (i < m) ? vel_lo[i] : zero4();
  ds_drift(ph, pl, vh, vl, s.dt_half);  // the i-body's half-step position
  dsf ax = make_ds(0.f, 0.f), ay = ax, az = ax;
  ds_accumulate<true>(ph, pl, jpos_hi, jpos_lo, jvel_hi, jvel_lo, n, s, tile, tile + blockDim.x,
                      ax, ay, az);
  if (i >= m) return;
  ds_kick_drift(ph, pl, vh, vl, ax, ay, az, s.dt, s.damping, s.dt_half, new_pos_hi + i,
                new_pos_lo + i, new_vel_hi + i, new_vel_lo + i);
}

__global__ void ds_accel_kernel(const float4* __restrict__ pos_hi,
                                const float4* __restrict__ pos_lo,
                                const float4* __restrict__ jpos_hi,
                                const float4* __restrict__ jpos_lo, float4* __restrict__ acc_hi,
                                float4* __restrict__ acc_lo, const int64_t m, const int64_t n,
                                const ds_scalars s) {
  extern __shared__ float4 tile[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4 ph = (i < m) ? pos_hi[i] : zero4();
  const float4 pl = (i < m) ? pos_lo[i] : zero4();
  dsf ax = make_ds(0.f, 0.f), ay = ax, az = ax;
  ds_accumulate<false>(ph, pl, jpos_hi, jpos_lo, nullptr, nullptr, n, s, tile, tile + blockDim.x,
                       ax, ay, az);
  if (i >= m) return;
  acc_hi[i] = make_float4(ax.hi, ay.hi, az.hi, 0.f);
  acc_lo[i] = make_float4(ax.lo, ay.lo, az.lo, 0.f);
}

bool valid_block_size(int64_t bs) { return bs >= 32 && bs <= 1024 && bs % 32 == 0; }

unsigned int num_blocks(int64_t m, int64_t bs) {
  return static_cast<unsigned int>((m + bs - 1) / bs);
}

}  // namespace

extern "C" {

// the four new planes of the i-set (m, 4) after one ds Euler step under
// the j-set (n, 4)
int nbody_ds_step(const void* pos_hi, const void* pos_lo, const void* vel_hi, const void* vel_lo,
                  const void* jpos_hi, const void* jpos_lo, void* new_pos_hi, void* new_pos_lo,
                  void* new_vel_hi, void* new_vel_lo, int64_t m, int64_t n, const float* scal,
                  int64_t block_size, void* stream) {
  if (!valid_block_size(block_size) || m < 0 || n < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(block_size) * sizeof(float4);
  ds_step_kernel<<<num_blocks(m, block_size), static_cast<unsigned int>(block_size), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float4*>(jpos_hi), static_cast<const float4*>(jpos_lo),
      static_cast<float4*>(new_pos_hi), static_cast<float4*>(new_pos_lo),
      static_cast<float4*>(new_vel_hi), static_cast<float4*>(new_vel_lo), m, n,
      read_scalars(scal));
  return cudaGetLastError();
}

// the four new planes of the i-set (m, 4) after one fused ds DKD step under
// the j-set (n, 4), whose velocities drift it too
int nbody_ds_leapfrog(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                      const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                      const void* jvel_hi, const void* jvel_lo, void* new_pos_hi,
                      void* new_pos_lo, void* new_vel_hi, void* new_vel_lo, int64_t m, int64_t n,
                      const float* scal, int64_t block_size, void* stream) {
  if (!valid_block_size(block_size) || m < 0 || n < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(block_size) * sizeof(float4);
  ds_leapfrog_kernel<<<num_blocks(m, block_size), static_cast<unsigned int>(block_size), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float4*>(jpos_hi), static_cast<const float4*>(jpos_lo),
      static_cast<const float4*>(jvel_hi), static_cast<const float4*>(jvel_lo),
      static_cast<float4*>(new_pos_hi), static_cast<float4*>(new_pos_lo),
      static_cast<float4*>(new_vel_hi), static_cast<float4*>(new_vel_lo), m, n,
      read_scalars(scal));
  return cudaGetLastError();
}

// the ds acceleration of the i-set (m, 4) under the j-set (n, 4), as (m, 4)
// hi and lo rows with w = 0; `scal` needs only eps^2 (column 1)
int nbody_ds_accel(const void* pos_hi, const void* pos_lo, const void* jpos_hi,
                   const void* jpos_lo, void* acc_hi, void* acc_lo, int64_t m, int64_t n,
                   const float* scal, int64_t block_size, void* stream) {
  if (!valid_block_size(block_size) || m < 0 || n < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(block_size) * sizeof(float4);
  ds_accel_kernel<<<num_blocks(m, block_size), static_cast<unsigned int>(block_size), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(jpos_hi), static_cast<const float4*>(jpos_lo),
      static_cast<float4*>(acc_hi), static_cast<float4*>(acc_lo), m, n, read_scalars(scal));
  return cudaGetLastError();
}

}  // extern "C"
