// Double-single (fp64-grade) acceleration + jerk for Hopper (sm_90a),
// one-sided: the force evaluation of the ds Hermite step of
// nbody_tpu_torch, and the step's predictor and corrector.
//
// Replaces one Pallas TPU kernel of the JAX package:
//   nbody_ds_accel_jerk <- nbody_tpu/ops/ds_kernel.py::_ds_accel_jerk_kernel
//                          (compute_accel_jerk_pallas_ds): the i-set under
//                          the j-set
// and runs the O(N) glue that the JAX package leaves to XLA
// (ds_kernel.py:951-975), one launch each where eager PyTorch would spend
// ~200 elementwise launches:
//   nbody_ds_hermite_predict: x_p = x + v dt + a0 dt^2/2 + j0 dt^3/6,
//                             v_p = v + a0 dt + j0 dt^2/2
//   nbody_ds_hermite_correct: v1 = (v + dt/2 (a0 + a1) + dt^2/12 (j0 - j1)) damping,
//                             x1 = x + dt/2 (v + v1) + dt^2/12 (a0 - a1)
// For each pair, in the arithmetic of ds_common.cuh (ds_kernel.py:795-823):
//   d = p_j - p_i;  dv = v_j - v_i (xyz only: vel.w is not a velocity)
//   r2 = (dx^2 + dy^2) + (dz^2 + eps2);  inv = ds_rsqrt(r2)
//   inv2 = inv * inv;  inv3 = inv2 * inv;  s = m_j inv3
//   c3 = 3 ((s (d . dv)) inv2)
//   a_i += s d;  j_i += s dv - c3 d
// with m_j's lo part. The self pair adds 0 because d = dv = 0 exactly.
//
// State: four (N, 4) float planes pos_hi, pos_lo, vel_hi, vel_lo, AoS
// [x, y, z, m] / [vx, vy, vz, w]. Outputs acc_hi, acc_lo, jerk_hi, jerk_lo
// are (M, 4) with w = 0, the JAX package's layout.
//
// Design: one thread an i-body keeps its position, velocity and six ds
// sums in registers; each block stages the j-bodies through shared memory
// kDsAjStage at a time, four float4 arrays (pos hi/lo, vel hi/lo: 64 bytes
// a body, 8 KB), every thread reading each staged body as a broadcast.
// The TPU kernel's (TILE_I, 128) lane accumulators and their pairwise lane
// reduction have no counterpart: a thread owns a row of its j-chunk.
// A j-split fills the card: one thread an i-body at block 128 gives
// M / 128 blocks, 128 at the ds default N = 16384 and 32 at a four-card
// hop (M = 4096), for 132 SMs and a dependent ds chain ~450 instructions
// long. So the grid is (i-blocks, S): chunk c of the j-range is
// [c * L, min((c + 1) * L, N)), L = ceil(ceil(N / kDsAjStage) / S) stages,
// S a pure function of M and N (ops/cuda_kernel.py::ds_aj_splits). With
// S = 1 a block writes the four outputs; with S > 1 it writes its six ds
// sums into the partials (S, 12, M), and ds_sum_partials
// (ds_sym_common.cuh) ds-adds each row's partials in chunk order. Each
// chunk is a ds sum in j order from 0: the same bits on every card, every
// call and every block size. No atomics.
//
// What bounds it on an H100: the FP32 pipe. A pair is ~452 FP32-pipe
// instructions read from this source (6 ds_sub at 11 for d and dv, r2 at
// 60, ds_rsqrt at 45, inv2 and inv3 at 9 each, s at 9, d . dv at 49, c3 at
// 25, 3 ds_mul + ds_add at 20 into the acceleration and 3 (2 ds_mul +
// ds_sub + ds_add) at 40 into the jerk), against the 225 of the ds force;
// the JAX package counts 800 flops a pair (ds_kernel.py:901). Memory is no
// limit: 64 bytes a staged j-body for blockDim.x pairs, and 48 bytes of
// partials a row and chunk. The block size is the ds step's
// (ops/cuda_kernel.py::ds_default_block_size). Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/torch_ds_aj_dispatch.py, in turns with the
// unsplit kernel): 4.33 ms at N = 16384 (7.27 before), 84 % of the bound;
// 1.14 ms at (M, N) = (4096, 16384), a four-card hop (7.27 before).
//
// The glue kernels are one thread a body, elementwise in ds, the mass and
// vel.w carried through from both planes; the acceleration and jerk arrays
// they read have `astride` floats a row (3 from the each-pair-once
// composition, 4 from the one-sided kernel).
//
// Edges: any M and N. A j-slot past N loads zeros in all four planes, so
// mass 0 and no force; a thread past M stages j-bodies and writes nothing.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float arrays, planes 16-byte aligned; `scal` is a device
// pointer to the (2, 4) block of ops/ds.py (eps^2 in column 1) for the
// force, and to the (2, 8) block of ops/ds.py::scal_ds_hermite (or
// ds_scal_with_dt's, built on the device) for the glue, which every kernel
// reads at its start (ds_common.cuh). The
// caller makes the arrays' device current; the kernels run on the given
// stream, allocate nothing and do not synchronise. Each entry point returns
// cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "ds_common.cuh"
#include "ds_sym_common.cuh"

namespace {

// j-bodies a shared-memory stage of the one-sided kernel (64 bytes a body:
// 8 KB), the j-split's unit (ops/cuda_kernel.py's DS_AJ_STAGE)
constexpr int kDsAjStage = 128;

// Row blockIdx.x * blockDim.x + threadIdx.x of the i-set against j-chunk
// blockIdx.y, `chunk` j-bodies long (a multiple of kDsAjStage). parts ==
// nullptr: the four (m, 4) output planes; else the chunk's twelve partial
// components parts[(blockIdx.y * 12 + comp) * m + i]: acc hi xyz, acc lo
// xyz, jerk hi xyz, jerk lo xyz (ds_sym_common.cuh's layout).
__global__ void ds_accel_jerk_kernel(
    const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
    const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
    const float4* __restrict__ jpos_hi, const float4* __restrict__ jpos_lo,
    const float4* __restrict__ jvel_hi, const float4* __restrict__ jvel_lo,
    float4* __restrict__ acc_hi, float4* __restrict__ acc_lo, float4* __restrict__ jerk_hi,
    float4* __restrict__ jerk_lo, const int64_t m, const int64_t n, const int64_t chunk,
    const float* __restrict__ scal, float* __restrict__ parts) {
  const dsf eps2 = read_scalars(scal).eps2;
  // a stage of j-bodies: pos hi, pos lo, vel hi, vel lo
  __shared__ float4 th[kDsAjStage];
  __shared__ float4 tl[kDsAjStage];
  __shared__ float4 tvh[kDsAjStage];
  __shared__ float4 tvl[kDsAjStage];
  const int bs = blockDim.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * bs + threadIdx.x;
  const float4 ph = (i < m) ? pos_hi[i] : zero4();
  const float4 pl = (i < m) ? pos_lo[i] : zero4();
  const float4 vh = (i < m) ? vel_hi[i] : zero4();
  const float4 vl = (i < m) ? vel_lo[i] : zero4();
  const dsf xi = make_ds(ph.x, pl.x), yi = make_ds(ph.y, pl.y), zi = make_ds(ph.z, pl.z);
  const dsf vxi = make_ds(vh.x, vl.x), vyi = make_ds(vh.y, vl.y), vzi = make_ds(vh.z, vl.z);
  dsf ax = make_ds(0.f, 0.f), ay = ax, az = ax, gx = ax, gy = ax, gz = ax;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kDsAjStage) {
    for (int k = threadIdx.x; k < kDsAjStage; k += bs) {
      const int64_t j = base + k;
      const bool in = j < n;
      th[k] = in ? jpos_hi[j] : zero4();
      tl[k] = in ? jpos_lo[j] : zero4();
      tvh[k] = in ? jvel_hi[j] : zero4();
      tvl[k] = in ? jvel_lo[j] : zero4();
    }
    __syncthreads();
    for (int k = 0; k < kDsAjStage; ++k) {
      const float4 qh = th[k], ql = tl[k], wh = tvh[k], wl = tvl[k];
      dsf dx, dy, dz, inv2, inv3;
      ds_pair2(make_ds(qh.x, ql.x), make_ds(qh.y, ql.y), make_ds(qh.z, ql.z), xi, yi, zi, eps2,
               dx, dy, dz, inv2, inv3);
      const dsf dvx = ds_sub(make_ds(wh.x, wl.x), vxi);
      const dsf dvy = ds_sub(make_ds(wh.y, wl.y), vyi);
      const dsf dvz = ds_sub(make_ds(wh.z, wl.z), vzi);
      const dsf s = ds_mul(make_ds(qh.w, ql.w), inv3);  // m_j / r^3
      // 3 m_j (d . dv) / r^5
      const dsf c3 = ds_mul_f32(ds_mul(ds_mul(s, ds_dot3(dx, dy, dz, dvx, dvy, dvz)), inv2), 3.f);
      ax = ds_add(ax, ds_mul(s, dx));
      ay = ds_add(ay, ds_mul(s, dy));
      az = ds_add(az, ds_mul(s, dz));
      gx = ds_add(gx, ds_sub(ds_mul(s, dvx), ds_mul(c3, dx)));
      gy = ds_add(gy, ds_sub(ds_mul(s, dvy), ds_mul(c3, dy)));
      gz = ds_add(gz, ds_sub(ds_mul(s, dvz), ds_mul(c3, dz)));
    }
    __syncthreads();
  }
  if (i >= m) return;
  if (parts == nullptr) {
    acc_hi[i] = make_float4(ax.hi, ay.hi, az.hi, 0.f);
    acc_lo[i] = make_float4(ax.lo, ay.lo, az.lo, 0.f);
    jerk_hi[i] = make_float4(gx.hi, gy.hi, gz.hi, 0.f);
    jerk_lo[i] = make_float4(gx.lo, gy.lo, gz.lo, 0.f);
    return;
  }
  const int64_t t = blockIdx.y;
  ds_put<12>(parts, t, 0, m, i, ax);
  ds_put<12>(parts, t, 1, m, i, ay);
  ds_put<12>(parts, t, 2, m, i, az);
  ds_put<12>(parts, t, 6, m, i, gx);
  ds_put<12>(parts, t, 7, m, i, gy);
  ds_put<12>(parts, t, 8, m, i, gz);
}

// component c (0..2) of a float4
__device__ __forceinline__ float lane_of(const float4 v, const int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : v.z);
}

// component c of body i of an (n, astride) ds field
__device__ __forceinline__ dsf field(const float* __restrict__ h, const float* __restrict__ l,
                                     const int64_t i, const int64_t astride, const int c) {
  return make_ds(h[i * astride + c], l[i * astride + c]);
}

// the four output planes of body i from its new positions x[3] and
// velocities v[3], the mass and vel.w carried from both input planes
__device__ __forceinline__ void store_state(const dsf (&x)[3], const dsf (&v)[3], const float4 ph,
                                            const float4 pl, const float4 vh, const float4 vl,
                                            float4* out_ph, float4* out_pl, float4* out_vh,
                                            float4* out_vl) {
  *out_ph = make_float4(x[0].hi, x[1].hi, x[2].hi, ph.w);
  *out_pl = make_float4(x[0].lo, x[1].lo, x[2].lo, pl.w);
  *out_vh = make_float4(v[0].hi, v[1].hi, v[2].hi, vh.w);
  *out_vl = make_float4(v[0].lo, v[1].lo, v[2].lo, vl.w);
}

// the predictor of ds_kernel.py:951-961, one thread a body
__global__ void __launch_bounds__(256) ds_hermite_predict_kernel(
    const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
    const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
    const float* __restrict__ acc_hi, const float* __restrict__ acc_lo,
    const float* __restrict__ jerk_hi, const float* __restrict__ jerk_lo, const int64_t astride,
    float4* __restrict__ out_ph, float4* __restrict__ out_pl, float4* __restrict__ out_vh,
    float4* __restrict__ out_vl, const int64_t n, const float* __restrict__ scal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ds_hermite_scalars s = read_hermite_scalars(scal);
  const dsf dt = s.dt, dt2_2 = s.dt2_2, dt3_6 = s.dt3_6;
  const float4 ph = pos_hi[i], pl = pos_lo[i], vh = vel_hi[i], vl = vel_lo[i];
  dsf xp[3], vp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const dsf x0 = make_ds(lane_of(ph, c), lane_of(pl, c));
    const dsf v0 = make_ds(lane_of(vh, c), lane_of(vl, c));
    const dsf a0 = field(acc_hi, acc_lo, i, astride, c);
    const dsf j0 = field(jerk_hi, jerk_lo, i, astride, c);
    xp[c] = ds_add(ds_add(x0, ds_mul(v0, dt)), ds_add(ds_mul(a0, dt2_2), ds_mul(j0, dt3_6)));
    vp[c] = ds_add(v0, ds_add(ds_mul(a0, dt), ds_mul(j0, dt2_2)));
  }
  store_state(xp, vp, ph, pl, vh, vl, out_ph + i, out_pl + i, out_vh + i, out_vl + i);
}

// the corrector of ds_kernel.py:964-975, one thread a body
__global__ void __launch_bounds__(256) ds_hermite_correct_kernel(
    const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
    const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
    const float* __restrict__ a0_hi, const float* __restrict__ a0_lo,
    const float* __restrict__ j0_hi, const float* __restrict__ j0_lo,
    const float* __restrict__ a1_hi, const float* __restrict__ a1_lo,
    const float* __restrict__ j1_hi, const float* __restrict__ j1_lo, const int64_t astride,
    float4* __restrict__ out_ph, float4* __restrict__ out_pl, float4* __restrict__ out_vh,
    float4* __restrict__ out_vl, const int64_t n, const float* __restrict__ scal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ds_hermite_scalars s = read_hermite_scalars(scal);
  const dsf damping = s.damping, dt_half = s.dt_half, dt2_12 = s.dt2_12;
  const float4 ph = pos_hi[i], pl = pos_lo[i], vh = vel_hi[i], vl = vel_lo[i];
  dsf x1[3], v1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const dsf x0 = make_ds(lane_of(ph, c), lane_of(pl, c));
    const dsf v0 = make_ds(lane_of(vh, c), lane_of(vl, c));
    const dsf a0 = field(a0_hi, a0_lo, i, astride, c);
    const dsf j0 = field(j0_hi, j0_lo, i, astride, c);
    const dsf a1 = field(a1_hi, a1_lo, i, astride, c);
    const dsf j1 = field(j1_hi, j1_lo, i, astride, c);
    v1[c] = ds_mul(ds_add(v0, ds_add(ds_mul(ds_add(a0, a1), dt_half),
                                     ds_mul(ds_sub(j0, j1), dt2_12))),
                   damping);
    x1[c] = ds_add(x0, ds_add(ds_mul(ds_add(v0, v1[c]), dt_half),
                              ds_mul(ds_sub(a0, a1), dt2_12)));
  }
  store_state(x1, v1, ph, pl, vh, vl, out_ph + i, out_pl + i, out_vh + i, out_vl + i);
}

bool valid_block_size(int64_t bs) { return bs >= 32 && bs <= 1024 && bs % 32 == 0; }

unsigned int num_blocks(int64_t m, int64_t bs) {
  return static_cast<unsigned int>((m + bs - 1) / bs);
}

// The grid (i-blocks, splits) of ds_accel_jerk_kernel, then with splits > 1
// the chunk-ordered ds sum of the partials in `parts` (splits * 12 * m
// floats) into the four outputs.
int launch_ds_accel_jerk(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                         const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                         const void* jvel_hi, const void* jvel_lo, void* acc_hi, void* acc_lo,
                         void* jerk_hi, void* jerk_lo, int64_t m, int64_t n, const float* scal,
                         int64_t block_size, int64_t splits, float* parts,
                         cudaStream_t stream) {
  if (!valid_block_size(block_size) || m < 0 || n < 0 || splits > 65535) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const int64_t chunk = cdiv(cdiv(n, kDsAjStage), splits) * kDsAjStage;
  const dim3 grid(num_blocks(m, block_size), static_cast<unsigned int>(splits));
  ds_accel_jerk_kernel<<<grid, static_cast<unsigned int>(block_size), 0, stream>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float4*>(jpos_hi), static_cast<const float4*>(jpos_lo),
      static_cast<const float4*>(jvel_hi), static_cast<const float4*>(jvel_lo),
      static_cast<float4*>(acc_hi), static_cast<float4*>(acc_lo), static_cast<float4*>(jerk_hi),
      static_cast<float4*>(jerk_lo), m, n, chunk, scal, splits > 1 ? parts : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  err = ds_sum_partials(parts, splits, 12, m, static_cast<float*>(acc_hi),
                        static_cast<float*>(acc_lo), 4, 1, 1, stream);
  if (err != cudaSuccess) return err;
  return ds_sum_partials(parts + 6 * m, splits, 12, m, static_cast<float*>(jerk_hi),
                         static_cast<float*>(jerk_lo), 4, 1, 1, stream);
}

}  // namespace

extern "C" {

// acc_hi, acc_lo, jerk_hi, jerk_lo (m, 4), w = 0, of the i-set (m, 4
// planes) under the j-set (n, 4 planes), one j-chunk (S = 1); `scal` a
// (2, 4) block, eps^2 in column 1
int nbody_ds_accel_jerk(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                        const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                        const void* jvel_hi, const void* jvel_lo, void* acc_hi, void* acc_lo,
                        void* jerk_hi, void* jerk_lo, int64_t m, int64_t n, const float* scal,
                        int64_t block_size, void* stream) {
  return launch_ds_accel_jerk(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo,
                              acc_hi, acc_lo, jerk_hi, jerk_lo, m, n, scal, block_size, 1,
                              nullptr, static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 12 * m floats, the
// chunks' ds partials, ds-added in chunk order into the four outputs
int nbody_ds_accel_jerk_split(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                              const void* vel_lo, const void* jpos_hi, const void* jpos_lo,
                              const void* jvel_hi, const void* jvel_lo, void* acc_hi,
                              void* acc_lo, void* jerk_hi, void* jerk_lo, int64_t m, int64_t n,
                              const float* scal, int64_t block_size, int64_t splits,
                              void* scratch, void* stream) {
  if (splits < 1 || scratch == nullptr) return cudaErrorInvalidValue;
  return launch_ds_accel_jerk(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo,
                              acc_hi, acc_lo, jerk_hi, jerk_lo, m, n, scal, block_size, splits,
                              static_cast<float*>(scratch),
                              static_cast<cudaStream_t>(stream));
}

// the four predicted planes (n, 4) of the state (n, 4 planes) from its
// acceleration and jerk (n, astride); `scal` the (2, 8) Hermite block
int nbody_ds_hermite_predict(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                             const void* vel_lo, const void* acc_hi, const void* acc_lo,
                             const void* jerk_hi, const void* jerk_lo, int64_t astride,
                             void* out_ph, void* out_pl, void* out_vh, void* out_vl, int64_t n,
                             const float* scal, void* stream) {
  if (n < 0 || astride < 3) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  ds_hermite_predict_kernel<<<num_blocks(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float*>(acc_hi), static_cast<const float*>(acc_lo),
      static_cast<const float*>(jerk_hi), static_cast<const float*>(jerk_lo), astride,
      static_cast<float4*>(out_ph), static_cast<float4*>(out_pl), static_cast<float4*>(out_vh),
      static_cast<float4*>(out_vl), n, scal);
  return cudaGetLastError();
}

// the four corrected planes (n, 4) from the start-of-step state (n, 4
// planes), its (a0, j0) and the predicted state's (a1, j1), all
// (n, astride); `scal` the (2, 8) Hermite block
int nbody_ds_hermite_correct(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                             const void* vel_lo, const void* a0_hi, const void* a0_lo,
                             const void* j0_hi, const void* j0_lo, const void* a1_hi,
                             const void* a1_lo, const void* j1_hi, const void* j1_lo,
                             int64_t astride, void* out_ph, void* out_pl, void* out_vh,
                             void* out_vl, int64_t n, const float* scal, void* stream) {
  if (n < 0 || astride < 3) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  ds_hermite_correct_kernel<<<num_blocks(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float*>(a0_hi), static_cast<const float*>(a0_lo),
      static_cast<const float*>(j0_hi), static_cast<const float*>(j0_lo),
      static_cast<const float*>(a1_hi), static_cast<const float*>(a1_lo),
      static_cast<const float*>(j1_hi), static_cast<const float*>(j1_lo), astride,
      static_cast<float4*>(out_ph), static_cast<float4*>(out_pl), static_cast<float4*>(out_vh),
      static_cast<float4*>(out_vl), n, scal);
  return cudaGetLastError();
}

}  // extern "C"
