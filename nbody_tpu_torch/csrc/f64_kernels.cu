// Native double-precision all-pairs kernels for Hopper (sm_90a): the fused
// damped-Euler step, the force, the accel + jerk (Hermite) and the
// potential of nbody_tpu_torch's fp64 mode (BodySystem(dtype=float64),
// Compute(precision="fp64"), nbody-torch --fp64).
//
// They replace no Pallas kernel: the JAX package's fp64 runs its plain XLA
// path (nbody_tpu/ops/reference.py: _accel_rows :43 and integrate :77 under
// nbody_step_xla, _accel_jerk_rows :131 under compute_accel_jerk_xla, and
// the pair potential of nbody_tpu/ops/energy.py). These kernels are the
// port's counterpart of that path, as BodySystemCUDA<double> is the CUDA
// sample's, and compute what it computes:
//   step:        d = p_j - p_i;  r2 = |d|^2 + eps2;  s = m_j r2^(-3/2);
//                a_i = sum_j s d;  v' = (v + a dt) damping;  p' = p + v' dt,
//                pos.w (mass) and vel.w carried through;
//   force:       a_i alone, (M, 3);
//   accel+jerk:  a_i and j_i = sum_j s (dv - 3 (d . dv) / r2 d), dv = v_j - v_i
//                over the xyz lanes only (vel.w is not a velocity);
//   potential:   row i = m_i sum_{j != i} m_j r2^(-1/2), the self pair dropped
//                by its index (a select: it is inf at eps = 0).
// Every operation is float64 and written out (__dsub_rn, __dmul_rn,
// __fma_rn), so that no instantiation contracts differently; the inverse
// root is CUDA's double rsqrt (MUFU.RSQ64H and its Newton steps in DFMA),
// never a float32 step. The self pair adds 0 only because d = 0, so at
// eps = 0 the force and the jerk are NaN, as in the fp32 kernels and the
// plain versions; a j-slot past N has mass 0 and adds exactly 0.
//
// Design (a simple kernel that is right first; the fp32 kernels of
// nbody_kernels.cu keep their own source, so their SASS, registers and
// bits do not move):
//   * ROWS i-bodies a thread (kF64Rows = 2 at blocks of up to 512 threads,
//     1 above), rows u * blockDim.x apart, each with its position and sums
//     in registers, so one shared-memory read of a j-body serves ROWS pairs;
//   * a body is 32 bytes, read as two 16-byte double2 loads ((x, y) and
//     (z, w)); the j-side staged kStepStage (256) bodies at a time, 8 KB
//     (16 KB with the velocities);
//   * a j-split: the grid is (i-tiles, S), chunk c of the j-range is
//     [c * L, min((c + 1) * L, N)), L a whole number of stages
//     (step_chunk), S a pure function of (M, N) (ops/cuda_kernel.py::
//     f64_splits). With S = 1 a block writes its outputs; with S > 1 it
//     writes its sums into the partials, and a second kernel adds each row's
//     partials in chunk order from 0. Each row sums its chunk from 0 in j
//     order, so the bits depend on (M, N) alone: not on ROWS, the block, the
//     card or the call. No atomics.
//
// What bounds them on an H100: the FP64 pipe, 64 lanes an SM (half the
// fp32 rate: 34 TFLOP/s on NVIDIA's H100 SXM data sheet). A force pair is
// 17 FP64 instructions in SASS: 3 DADD, 3 DFMA for r2, the double rsqrt
// (one MUFU.RSQ64H and its Newton steps in DFMA / DMUL), the cube and m_j
// in DMUL, 3 DFMA into the sums; beside them a call to rsqrt's special-case
// path that is branched around, the loop and the shared-memory read (31.62
// SASS instructions a pair at ROWS 2). The potential's pair is 12 FP64
// instructions, accel + jerk's 31. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (scripts/torch_fp64_bench.py): the step 0.381 ms at N=16384 and
// 5.845 at 65536, 72-75 % of that FP64 issue bound, 5.6-5.7x faster than
// the ds step. Memory is no limit: 32 bytes a staged j-body serve
// blockDim.x * ROWS pairs.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float64 arrays: pos/vel (M,4) or (N,4), 32-byte aligned (two
// double2 loads a body), acc and jerk (M,3), per_row (N,). The `_split`
// entry points take S and a device scratch of float64 partials (S * 3 * M
// for the step and the force, S * 6 * M for accel + jerk, S * N for the
// potential). The caller makes the arrays' device current; a kernel runs
// on the given stream, allocates nothing and does not synchronise. Each
// entry point returns cudaGetLastError() after its launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "allpairs_common.cuh"

namespace {

// i-bodies a thread at blocks of up to 512 threads (1 above, f64_rows) and
// the steps of a stage's walk unrolled: the force and potential walks, and
// the accel + jerk walk, whose pair holds twice the registers.
constexpr int kF64Rows = 2;
constexpr int kF64Unroll = 4;
constexpr int kF64AjUnroll = 2;

__host__ __device__ inline int f64_rows(const int64_t block_size) {
  return block_size <= 512 ? kF64Rows : 1;
}

// A body of a (., 4) float64 array: [x, y, z, w].
struct Body {
  double x, y, z, w;
};

// body i of `p`, the (., 4) array as double2 pairs: two 16-byte loads
__device__ __forceinline__ Body load_body(const double2* __restrict__ p, const int64_t i) {
  const double2 a = p[2 * i];
  const double2 b = p[2 * i + 1];
  return {a.x, a.y, b.x, b.y};
}

// The thread's ROWS i-bodies: row u is i0 + u * blockDim.x; a row past m is
// zero (such a thread still stages j-bodies for the block).
template <int ROWS>
__device__ __forceinline__ void load_rows_f64(const double2* __restrict__ p, const int64_t i0,
                                              const int64_t m, Body (&b)[ROWS]) {
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    b[u] = (i < m) ? load_body(p, i) : Body{0.0, 0.0, 0.0, 0.0};
  }
}

// Stage j-bodies [base, base + kStepStage) of `p` into (xy, zw) shared
// arrays; a slot past n is zero (mass 0).
__device__ __forceinline__ void stage_f64(const double2* __restrict__ p, const int64_t base,
                                          const int64_t n, double2* xy, double2* zw) {
  const double2 zero = make_double2(0.0, 0.0);
  for (int k = threadIdx.x; k < kStepStage; k += blockDim.x) {
    const int64_t j = base + k;
    xy[k] = (j < n) ? p[2 * j] : zero;
    zw[k] = (j < n) ? p[2 * j + 1] : zero;
  }
}

// One force pair into (ax, ay, az): s = m_j / r^3, a += s d.
__device__ __forceinline__ void accel_pair(const double2 jxy, const double2 jzw, const Body& p,
                                           const double eps2, double& ax, double& ay,
                                           double& az) {
  const double dx = __dsub_rn(jxy.x, p.x);
  const double dy = __dsub_rn(jxy.y, p.y);
  const double dz = __dsub_rn(jzw.x, p.z);
  const double r2 = __fma_rn(dz, dz, __fma_rn(dy, dy, __fma_rn(dx, dx, eps2)));
  const double inv = rsqrt(r2);
  const double s = __dmul_rn(jzw.y, __dmul_rn(__dmul_rn(inv, inv), inv));
  ax = __fma_rn(s, dx, ax);
  ay = __fma_rn(s, dy, ay);
  az = __fma_rn(s, dz, az);
}

// The force walk: a_u = sum_j m_j d / (|d|^2 + eps2)^(3/2) over the chunk
// [j0, min(j0 + chunk, n)) (chunk a whole number of stages), each row's
// sums from 0 in j order. Every thread of the block must call it; it ends
// on a barrier.
template <int ROWS>
__device__ __forceinline__ void walk_accel_f64(const Body (&pi)[ROWS],
                                               const double2* __restrict__ pos_j,
                                               const int64_t j0, const int64_t chunk,
                                               const int64_t n, const double eps2,
                                               double (&ax)[ROWS], double (&ay)[ROWS],
                                               double (&az)[ROWS]) {
  __shared__ double2 sxy[kStepStage];
  __shared__ double2 szw[kStepStage];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    ax[u] = 0.0;
    ay[u] = 0.0;
    az[u] = 0.0;
  }
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kStepStage) {
    stage_f64(pos_j, base, n, sxy, szw);
    __syncthreads();
#pragma unroll(kF64Unroll)
    for (int k = 0; k < kStepStage; ++k) {
      const double2 jxy = sxy[k];
      const double2 jzw = szw[k];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) accel_pair(jxy, jzw, pi[u], eps2, ax[u], ay[u], az[u]);
    }
    __syncthreads();
  }
}

// The chunk's sums of ROWS rows into the partials (splits, NC, m):
// parts[(c * NC + comp) * m + i], rows past m skipped.
template <int ROWS, int NC>
__device__ __forceinline__ void store_parts_f64(double* __restrict__ parts, const int64_t c,
                                                const int64_t i0, const int64_t m,
                                                const double (&sums)[NC][ROWS]) {
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    if (i >= m) continue;
#pragma unroll
    for (int comp = 0; comp < NC; ++comp) parts[(c * NC + comp) * m + i] = sums[comp][u];
  }
}

// The damped Euler update of row i: v = (v + a dt) damping, p = p + v dt,
// pos.w and vel.w carried. Shared by the one-chunk step and its finish
// kernel, so a row's update is the same operations whichever applies it.
__device__ __forceinline__ void euler_update_f64(const Body& p, const double2* __restrict__ vel,
                                                 const int64_t i, const double ax,
                                                 const double ay, const double az,
                                                 const double dt, const double damping,
                                                 double2* __restrict__ new_pos,
                                                 double2* __restrict__ new_vel) {
  const Body v = load_body(vel, i);
  const double vx = __dmul_rn(__fma_rn(ax, dt, v.x), damping);
  const double vy = __dmul_rn(__fma_rn(ay, dt, v.y), damping);
  const double vz = __dmul_rn(__fma_rn(az, dt, v.z), damping);
  new_vel[2 * i] = make_double2(vx, vy);
  new_vel[2 * i + 1] = make_double2(vz, v.w);
  new_pos[2 * i] = make_double2(__fma_rn(vx, dt, p.x), __fma_rn(vy, dt, p.y));
  new_pos[2 * i + 1] = make_double2(__fma_rn(vz, dt, p.z), p.w);
}

// The fused step of ROWS rows a thread against j-chunk blockIdx.y.
// parts == nullptr (one chunk): the update; else the sums into the partials.
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    f64_step_kernel(const double2* __restrict__ pos_i, const double2* __restrict__ vel_i,
                    const double2* __restrict__ pos_j, double2* __restrict__ new_pos,
                    double2* __restrict__ new_vel, const int64_t m, const int64_t n,
                    const int64_t chunk, const double dt, const double eps2,
                    const double damping, double* __restrict__ parts) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ROWS * blockDim.x + threadIdx.x;
  Body pi[ROWS];
  double a[3][ROWS];
  load_rows_f64<ROWS>(pos_i, i0, m, pi);
  walk_accel_f64<ROWS>(pi, pos_j, static_cast<int64_t>(blockIdx.y) * chunk, chunk, n, eps2, a[0],
                       a[1], a[2]);
  if (parts != nullptr) {
    store_parts_f64<ROWS, 3>(parts, blockIdx.y, i0, m, a);
    return;
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    if (i >= m) continue;
    euler_update_f64(pi[u], vel_i, i, a[0][u], a[1][u], a[2][u], dt, damping, new_pos, new_vel);
  }
}

// The split step's update, one thread a row: the row's partials added in
// chunk order from 0, then euler_update_f64.
__global__ void __launch_bounds__(256)
    f64_step_finish_kernel(const double* __restrict__ parts, const int64_t splits,
                           const double2* __restrict__ pos_i,
                           const double2* __restrict__ vel_i, double2* __restrict__ new_pos,
                           double2* __restrict__ new_vel, const int64_t m, const double dt,
                           const double damping) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  double ax = 0.0, ay = 0.0, az = 0.0;
  for (int64_t t = 0; t < splits; ++t) {
    ax = __dadd_rn(ax, parts[(t * 3 + 0) * m + i]);
    ay = __dadd_rn(ay, parts[(t * 3 + 1) * m + i]);
    az = __dadd_rn(az, parts[(t * 3 + 2) * m + i]);
  }
  euler_update_f64(load_body(pos_i, i), vel_i, i, ax, ay, az, dt, damping, new_pos, new_vel);
}

// The force of ROWS rows a thread against j-chunk blockIdx.y: the step's
// walk, so its sums are the ones the step applies. parts == nullptr: the
// sums into acc (M, 3); else into the partials.
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    f64_accel_kernel(const double2* __restrict__ pos_i, const double2* __restrict__ pos_j,
                     double* __restrict__ acc, const int64_t m, const int64_t n,
                     const int64_t chunk, const double eps2, double* __restrict__ parts) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ROWS * blockDim.x + threadIdx.x;
  Body pi[ROWS];
  double a[3][ROWS];
  load_rows_f64<ROWS>(pos_i, i0, m, pi);
  walk_accel_f64<ROWS>(pi, pos_j, static_cast<int64_t>(blockIdx.y) * chunk, chunk, n, eps2, a[0],
                       a[1], a[2]);
  if (parts != nullptr) {
    store_parts_f64<ROWS, 3>(parts, blockIdx.y, i0, m, a);
    return;
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    if (i >= m) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[3 * i + c] = a[c][u];
  }
}

// out[x * 3 + comp] = the sum over t = 0, 1, ... of parts[(t * pstride +
// comp) * n + x], comp < 3: the force's partials (pstride 3), or the
// acceleration's and the jerk's halves of accel + jerk's (pstride 6).
__global__ void __launch_bounds__(256)
    f64_sum_partials_kernel(const double* __restrict__ parts, const int64_t nparts,
                            const int64_t pstride, const int64_t n, double* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3 * n) return;
  const int64_t comp = idx / n;
  const int64_t x = idx - comp * n;
  double s = 0.0;
  for (int64_t t = 0; t < nparts; ++t) s = __dadd_rn(s, parts[(t * pstride + comp) * n + x]);
  out[x * 3 + comp] = s;
}

cudaError_t sum_partials_f64(const double* parts, const int64_t nparts, const int64_t pstride,
                             const int64_t n, double* out, cudaStream_t stream) {
  const auto blocks = static_cast<unsigned int>(cdiv(3 * n, 256));
  f64_sum_partials_kernel<<<blocks, 256, 0, stream>>>(parts, nparts, pstride, n, out);
  return cudaGetLastError();
}

// Accel + jerk of ROWS rows a thread against j-chunk blockIdx.y:
//   r2 = |d|^2 + eps2;  inv = rsqrt(r2);  inv2 = inv^2;  s = m_j inv2 inv;
//   w = 3 inv2 (d . dv);  a += s d;  j += s (dv - w d).
// parts == nullptr: acc and jerk (M, 3); else the partials (S, 6, M).
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    f64_accel_jerk_kernel(const double2* __restrict__ pos_i, const double2* __restrict__ vel_i,
                          const double2* __restrict__ pos_j, const double2* __restrict__ vel_j,
                          const int64_t m, const int64_t n, const int64_t chunk,
                          const double eps2, double* __restrict__ acc,
                          double* __restrict__ jerk, double* __restrict__ parts) {
  __shared__ double2 sxy[kStepStage];
  __shared__ double2 szw[kStepStage];
  __shared__ double2 svxy[kStepStage];
  __shared__ double2 svzw[kStepStage];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ROWS * blockDim.x + threadIdx.x;
  Body pi[ROWS], vi[ROWS];
  double a[6][ROWS];
  load_rows_f64<ROWS>(pos_i, i0, m, pi);
  load_rows_f64<ROWS>(vel_i, i0, m, vi);
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
#pragma unroll
    for (int c = 0; c < 6; ++c) a[c][u] = 0.0;
  }
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kStepStage) {
    stage_f64(pos_j, base, n, sxy, szw);
    stage_f64(vel_j, base, n, svxy, svzw);
    __syncthreads();
#pragma unroll(kF64AjUnroll)
    for (int k = 0; k < kStepStage; ++k) {
      const double2 jxy = sxy[k];
      const double2 jzw = szw[k];
      const double2 jvxy = svxy[k];
      const double2 jvzw = svzw[k];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const double dx = __dsub_rn(jxy.x, pi[u].x);
        const double dy = __dsub_rn(jxy.y, pi[u].y);
        const double dz = __dsub_rn(jzw.x, pi[u].z);
        const double dvx = __dsub_rn(jvxy.x, vi[u].x);
        const double dvy = __dsub_rn(jvxy.y, vi[u].y);
        const double dvz = __dsub_rn(jvzw.x, vi[u].z);
        const double r2 = __fma_rn(dz, dz, __fma_rn(dy, dy, __fma_rn(dx, dx, eps2)));
        const double inv = rsqrt(r2);
        const double inv2 = __dmul_rn(inv, inv);
        const double s = __dmul_rn(jzw.y, __dmul_rn(inv2, inv));  // m_j / r^3
        const double w = __dmul_rn(__dmul_rn(3.0, inv2),
                                   __fma_rn(dz, dvz, __fma_rn(dy, dvy, __dmul_rn(dx, dvx))));
        a[0][u] = __fma_rn(s, dx, a[0][u]);
        a[1][u] = __fma_rn(s, dy, a[1][u]);
        a[2][u] = __fma_rn(s, dz, a[2][u]);
        a[3][u] = __fma_rn(s, __fma_rn(-w, dx, dvx), a[3][u]);
        a[4][u] = __fma_rn(s, __fma_rn(-w, dy, dvy), a[4][u]);
        a[5][u] = __fma_rn(s, __fma_rn(-w, dz, dvz), a[5][u]);
      }
    }
    __syncthreads();
  }
  if (parts != nullptr) {
    store_parts_f64<ROWS, 6>(parts, blockIdx.y, i0, m, a);
    return;
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
    if (i >= m) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[3 * i + c] = a[c][u];
      jerk[3 * i + c] = a[3 + c][u];
    }
  }
}

// The potential of ROWS rows a thread against j-chunk blockIdx.y of the set
// itself: u_r = sum_j m_j rsqrt(|d|^2 + eps2) over the chunk's j-bodies
// below n, the self pair dropped by its index (a select on every pair, so
// the bits do not depend on which stages hold the block's rows), each
// row's sum from 0 in j order. parts == nullptr: per_row[i] = m_i u_r;
// else u_r into the partials parts[blockIdx.y * n + i].
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    f64_potential_kernel(const double2* __restrict__ pos, double* __restrict__ per_row,
                         const int64_t n, const int64_t chunk, const double eps2,
                         double* __restrict__ parts) {
  __shared__ double2 sxy[kStepStage];
  __shared__ double2 szw[kStepStage];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ROWS * blockDim.x + threadIdx.x;
  Body pi[ROWS];
  double u[ROWS];
  load_rows_f64<ROWS>(pos, i0, n, pi);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) u[r] = 0.0;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kStepStage) {
    stage_f64(pos, base, n, sxy, szw);
    __syncthreads();
    const int valid = static_cast<int>(j1 - base < kStepStage ? j1 - base : kStepStage);
    int self[ROWS];  // the row's slot in this stage, -1 where it lies elsewhere
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int64_t k = i0 + static_cast<int64_t>(r) * blockDim.x - base;
      self[r] = (k >= 0 && k < kStepStage) ? static_cast<int>(k) : -1;
    }
#pragma unroll(kF64Unroll)
    for (int k = 0; k < valid; ++k) {
      const double2 jxy = sxy[k];
      const double2 jzw = szw[k];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const double dx = __dsub_rn(jxy.x, pi[r].x);
        const double dy = __dsub_rn(jxy.y, pi[r].y);
        const double dz = __dsub_rn(jzw.x, pi[r].z);
        const double r2 = __fma_rn(dz, dz, __fma_rn(dy, dy, __fma_rn(dx, dx, eps2)));
        const double sum = __fma_rn(jzw.y, rsqrt(r2), u[r]);
        u[r] = (k == self[r]) ? u[r] : sum;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t i = i0 + static_cast<int64_t>(r) * blockDim.x;
    if (i >= n) continue;
    if (parts != nullptr) {
      parts[static_cast<int64_t>(blockIdx.y) * n + i] = u[r];
    } else {
      per_row[i] = __dmul_rn(pi[r].w, u[r]);
    }
  }
}

// The split potential's rows, one thread a row: the row's partials added in
// chunk order from 0, times m_i.
__global__ void __launch_bounds__(256)
    f64_potential_finish_kernel(const double* __restrict__ parts, const int64_t splits,
                                const double2* __restrict__ pos, double* __restrict__ per_row,
                                const int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double u = 0.0;
  for (int64_t c = 0; c < splits; ++c) u = __dadd_rn(u, parts[c * n + i]);
  per_row[i] = __dmul_rn(pos[2 * i + 1].y, u);
}

bool valid_f64(const int64_t bs, const int64_t m, const int64_t n, const int64_t splits,
               const void* parts) {
  return bs >= 32 && bs <= 1024 && bs % 32 == 0 && m >= 0 && n >= 0 && splits >= 1 &&
         splits <= 65535 && (splits == 1 || parts != nullptr);
}

// The grid (i-tiles of f64_rows(block_size) * block_size rows, splits).
dim3 f64_grid(const int64_t m, const int64_t block_size, const int64_t splits) {
  const int64_t rows = f64_rows(block_size) * block_size;
  return dim3(static_cast<unsigned int>(cdiv(m, rows)), static_cast<unsigned int>(splits));
}

int launch_step_f64(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                    void* new_vel, int64_t m, int64_t n, double dt, double eps2, double damping,
                    int64_t block_size, int64_t splits, double* parts, cudaStream_t stream) {
  if (!valid_f64(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const auto pi = static_cast<const double2*>(pos_i);
  const auto vi = static_cast<const double2*>(vel_i);
  const auto pj = static_cast<const double2*>(pos_j);
  const auto np = static_cast<double2*>(new_pos);
  const auto nv = static_cast<double2*>(new_vel);
  const dim3 grid = f64_grid(m, block_size, splits);
  const auto bs = static_cast<unsigned int>(block_size);
  const int64_t chunk = step_chunk(n, splits);
  double* out = splits > 1 ? parts : nullptr;
  if (f64_rows(block_size) == kF64Rows) {
    f64_step_kernel<kF64Rows, 512><<<grid, bs, 0, stream>>>(pi, vi, pj, np, nv, m, n, chunk, dt,
                                                            eps2, damping, out);
  } else {
    f64_step_kernel<1, 1024><<<grid, bs, 0, stream>>>(pi, vi, pj, np, nv, m, n, chunk, dt, eps2,
                                                      damping, out);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  f64_step_finish_kernel<<<static_cast<unsigned int>(cdiv(m, 256)), 256, 0, stream>>>(
      parts, splits, pi, vi, np, nv, m, dt, damping);
  return cudaGetLastError();
}

int launch_accel_f64(const void* pos_i, const void* pos_j, void* acc, int64_t m, int64_t n,
                     double eps2, int64_t block_size, int64_t splits, double* parts,
                     cudaStream_t stream) {
  if (!valid_f64(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const auto pi = static_cast<const double2*>(pos_i);
  const auto pj = static_cast<const double2*>(pos_j);
  const auto a = static_cast<double*>(acc);
  const dim3 grid = f64_grid(m, block_size, splits);
  const auto bs = static_cast<unsigned int>(block_size);
  const int64_t chunk = step_chunk(n, splits);
  double* out = splits > 1 ? parts : nullptr;
  if (f64_rows(block_size) == kF64Rows) {
    f64_accel_kernel<kF64Rows, 512><<<grid, bs, 0, stream>>>(pi, pj, a, m, n, chunk, eps2, out);
  } else {
    f64_accel_kernel<1, 1024><<<grid, bs, 0, stream>>>(pi, pj, a, m, n, chunk, eps2, out);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_partials_f64(parts, splits, 3, m, a, stream);
}

int launch_accel_jerk_f64(const void* pos_i, const void* vel_i, const void* pos_j,
                          const void* vel_j, void* acc, void* jerk, int64_t m, int64_t n,
                          double eps2, int64_t block_size, int64_t splits, double* parts,
                          cudaStream_t stream) {
  if (!valid_f64(block_size, m, n, splits, parts)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const auto pi = static_cast<const double2*>(pos_i);
  const auto vi = static_cast<const double2*>(vel_i);
  const auto pj = static_cast<const double2*>(pos_j);
  const auto vj = static_cast<const double2*>(vel_j);
  const auto a = static_cast<double*>(acc);
  const auto g = static_cast<double*>(jerk);
  const dim3 grid = f64_grid(m, block_size, splits);
  const auto bs = static_cast<unsigned int>(block_size);
  const int64_t chunk = step_chunk(n, splits);
  double* out = splits > 1 ? parts : nullptr;
  if (f64_rows(block_size) == kF64Rows) {
    f64_accel_jerk_kernel<kF64Rows, 512><<<grid, bs, 0, stream>>>(pi, vi, pj, vj, m, n, chunk,
                                                                  eps2, a, g, out);
  } else {
    f64_accel_jerk_kernel<1, 1024><<<grid, bs, 0, stream>>>(pi, vi, pj, vj, m, n, chunk, eps2,
                                                            a, g, out);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  err = sum_partials_f64(parts, splits, 6, m, a, stream);
  if (err != cudaSuccess) return err;
  return sum_partials_f64(parts + 3 * m, splits, 6, m, g, stream);
}

int launch_potential_f64(const void* pos, void* per_row, int64_t n, double eps2,
                         int64_t block_size, int64_t splits, double* parts,
                         cudaStream_t stream) {
  if (!valid_f64(block_size, n, n, splits, parts)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto p = static_cast<const double2*>(pos);
  const auto out = static_cast<double*>(per_row);
  const dim3 grid = f64_grid(n, block_size, splits);
  const auto bs = static_cast<unsigned int>(block_size);
  const int64_t chunk = step_chunk(n, splits);
  double* part = splits > 1 ? parts : nullptr;
  if (f64_rows(block_size) == kF64Rows) {
    f64_potential_kernel<kF64Rows, 512><<<grid, bs, 0, stream>>>(p, out, n, chunk, eps2, part);
  } else {
    f64_potential_kernel<1, 1024><<<grid, bs, 0, stream>>>(p, out, n, chunk, eps2, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  f64_potential_finish_kernel<<<static_cast<unsigned int>(cdiv(n, 256)), 256, 0, stream>>>(
      parts, splits, p, out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the new (m, 4) pos and vel of the i-set after one Euler step under the
// j-set (n, 4), one j-chunk (S = 1)
int nbody_step_f64(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                   void* new_vel, int64_t m, int64_t n, double dt, double eps2, double damping,
                   int64_t block_size, void* stream) {
  return launch_step_f64(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping,
                         block_size, 1, nullptr, static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 3 * m doubles
int nbody_step_split_f64(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                         void* new_vel, int64_t m, int64_t n, double dt, double eps2,
                         double damping, int64_t block_size, int64_t splits, void* scratch,
                         void* stream) {
  return launch_step_f64(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping,
                         block_size, splits, static_cast<double*>(scratch),
                         static_cast<cudaStream_t>(stream));
}

// acc (m, 3) of the i-set under the j-set (n, 4), one j-chunk
int nbody_accel_f64(const void* pos_i, const void* pos_j, void* acc, int64_t m, int64_t n,
                    double eps2, int64_t block_size, void* stream) {
  return launch_accel_f64(pos_i, pos_j, acc, m, n, eps2, block_size, 1, nullptr,
                          static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 3 * m doubles
int nbody_accel_split_f64(const void* pos_i, const void* pos_j, void* acc, int64_t m, int64_t n,
                          double eps2, int64_t block_size, int64_t splits, void* scratch,
                          void* stream) {
  return launch_accel_f64(pos_i, pos_j, acc, m, n, eps2, block_size, splits,
                          static_cast<double*>(scratch), static_cast<cudaStream_t>(stream));
}

// acc and jerk (m, 3) of the i-set under the j-set, one j-chunk
int nbody_accel_jerk_f64(const void* pos_i, const void* vel_i, const void* pos_j,
                         const void* vel_j, void* acc, void* jerk, int64_t m, int64_t n,
                         double eps2, int64_t block_size, void* stream) {
  return launch_accel_jerk_f64(pos_i, vel_i, pos_j, vel_j, acc, jerk, m, n, eps2, block_size, 1,
                               nullptr, static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * 6 * m doubles
int nbody_accel_jerk_split_f64(const void* pos_i, const void* vel_i, const void* pos_j,
                               const void* vel_j, void* acc, void* jerk, int64_t m, int64_t n,
                               double eps2, int64_t block_size, int64_t splits, void* scratch,
                               void* stream) {
  return launch_accel_jerk_f64(pos_i, vel_i, pos_j, vel_j, acc, jerk, m, n, eps2, block_size,
                               splits, static_cast<double*>(scratch),
                               static_cast<cudaStream_t>(stream));
}

// per_row (n,) of the set (n, 4), row i = m_i sum_{j != i} m_j / r_ij, one j-chunk
int nbody_potential_f64(const void* pos, void* per_row, int64_t n, double eps2,
                        int64_t block_size, void* stream) {
  return launch_potential_f64(pos, per_row, n, eps2, block_size, 1, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// the same in `splits` j-chunks: scratch holds splits * n doubles
int nbody_potential_split_f64(const void* pos, void* per_row, int64_t n, double eps2,
                              int64_t block_size, int64_t splits, void* scratch, void* stream) {
  return launch_potential_f64(pos, per_row, n, eps2, block_size, splits,
                              static_cast<double*>(scratch), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
