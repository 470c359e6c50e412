// Each-pair-once (Newton's third law) double-single acceleration + jerk for
// Hopper (sm_90a): the ds Hermite scheme's force evaluation, triangle and
// cross-rectangle kernels of nbody_tpu_torch, with fixed-order ds partial
// sums.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   nbody_ds_aj_sym   <- nbody_tpu/ops/ds_kernel.py::_ds_aj_sym_kernel
//                        (compute_accel_jerk_pallas_ds_sym): the strict upper
//                        triangle j > i of one set, i-side and reaction
//                        merged in ds
//   nbody_ds_aj_cross <- nbody_tpu/ops/ds_kernel.py::_ds_aj_sym_cross_kernel
//                        (_ds_aj_sym_cross): the mask-free rectangle of two sets
// For each pair (i, j), evaluated once, in the arithmetic of ds_common.cuh
// (ds_kernel.py:1629-1691):
//   d = p_j - p_i;  dv = v_j - v_i (xyz only);  inv2, inv3 as the one-sided
//   c3p = 3 (((d . dv) inv2) inv3);  q = inv3 dv - c3p d  (mass-free, odd in d)
//   a_i += (m_j inv3) d;  j_i += m_j q        (the action)
//   a_j -= (m_i inv3) d;  j_j -= m_i q        (the reaction)
// The triangle keeps j > i on the tiles of the diagonal by a select on
// inv3 and c3p (the masked self pair is inf and NaN at eps = 0), which
// also drops the self pair.
//
// Design: ds_symmetric_kernels.cu's, with the jerk beside the force.
//   * Square tiles of T = 128 * ROWS bodies, ROWS in {1, 2}; a block of
//     128 threads takes one (row tile, column tile) pair, each thread ROWS
//     i-bodies: their hi/lo positions, masses and velocities and six ds
//     action sums in registers, 26 floats a row.
//   * The triangle's blocks are the flat worklist of tile pairs c >= r
//     (triangle_tile, sym_common.cuh); the rectangle's a 2-D grid.
//   * The reaction rides around the warp with its j-body: each lane loads
//     one j-body (position and velocity, hi and lo), and for 32 steps meets
//     it with its ROWS i-bodies, then passes the j-body and its six ds
//     reaction sums to the next lane (26 shuffles per ROWS pairs: 8 for the
//     position, 6 for the velocity, 12 for the sums).
//   * The four warps' reaction sums meet in shared memory (4 * 12 * T
//     floats: 24 KB at T = 128, 48 KB at 256, as dynamic shared memory with
//     the opt-in) and are ds-added in warp order.
//     A block writes its ds action partial of the row tile and its ds
//     reaction partial of the column tile (on the diagonal one partial,
//     action ds+ reaction) into a scratch of ceil(N/T) * 12 * N floats, each
//     (tile, component, body) slot once; a second kernel ds-adds each
//     body's slots in tile order (ds_sym_common.cuh). No atomics: the same
//     bits on every run.
//   * ROWS 4 and 8 (tiles 512 and 1024) are not built: at 52 floats a row
//     pair, against the force's 28, ROWS 4 took 168 registers and spilled,
//     and lost to ROWS 1 and 2 at every N measured (PERF.md); ROWS 8 is far
//     past the register file.
//
// What bounds it on an H100: the FP32 pipe. A pair is ~608 FP32-pipe
// instructions for both sides, read from this source (6 ds_sub at 11 for d
// and dv, r2 at 60, ds_rsqrt at 45, inv2 and inv3 at 9 each, d . dv at 49,
// c3p at 25, q at 3 x 29, m_j inv3 and m_i inv3 at 9 each, and 12 ds_mul
// + ds_add or ds_sub at 20 into the four sums), and 26 / ROWS shuffles; the
// JAX package counts 500 flops a pair for the triangle and 1000 for the
// rectangle (ds_kernel.py:1792,2008). The inputs are 64 bytes a body.
//
// Edges: any N, Bi, Bj. A slot past the end loads zeros in all planes, so
// mass 0 on both sides and nothing written for it.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float arrays, planes (N, 4) 16-byte aligned; `scal` is a
// device pointer to a (2, 4) block of ops/ds.py, eps^2 in column 1, read by
// every kernel at its start (ds_common.cuh). The caller
// allocates the scratch and the outputs, makes the arrays' device current,
// and passes its stream; nothing here allocates or synchronises. Each entry
// point returns the first CUDA error of its launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "ds_sym_common.cuh"

namespace {

// acc x, y, z hi, then lo (components 0-5); jerk x, y, z hi, then lo (6-11)
constexpr int kComps = 12;

// tiles of 128 or 256 bodies; 0 for a tile the kernels do not take
int aj_rows_of_tile(int64_t tile) {
  const int rows = rows_of_tile(tile);
  return rows <= 2 ? rows : 0;
}

// One T x T tile pair: rows [row0, row0 + T) of the i-set against columns
// [col0, col0 + T) of the j-set. Leaves each thread's ds action on its rows
// in act[f][u] (f: acc x, y, z, jerk x, y, z) and the warps' ds reaction
// sums in red[warp][comp][T].
template <int ROWS, bool DIAG>
__device__ __forceinline__ void ds_aj_tile_pair(
    const float4* __restrict__ ih, const float4* __restrict__ il,
    const float4* __restrict__ ivh, const float4* __restrict__ ivl, const int64_t ni,
    const int64_t row0, const float4* __restrict__ jh, const float4* __restrict__ jl,
    const float4* __restrict__ jvh, const float4* __restrict__ jvl, const int64_t nj,
    const int64_t col0, const dsf eps2, dsf (&act)[6][ROWS], float* red) {
  constexpr int T = kThreads * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4 pih[ROWS], pil[ROWS], vih[ROWS], vil[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t ig = row0 + threadIdx.x + u * kThreads;
    const bool in = ig < ni;
    pih[u] = in ? ih[ig] : zero4();
    pil[u] = in ? il[ig] : zero4();
    vih[u] = in ? ivh[ig] : zero4();
    vil[u] = in ? ivl[ig] : zero4();
#pragma unroll
    for (int f = 0; f < 6; ++f) act[f][u] = make_ds(0.f, 0.f);
  }
  const int src = (lane + 1) & 31;
  for (int q = 0; q < T / 32; ++q) {
    const int jl0 = q * 32;
    const int64_t jg = col0 + jl0 + lane;
    const bool in = jg < nj;
    float4 qh = in ? jh[jg] : zero4();
    float4 ql = in ? jl[jg] : zero4();
    float4 wh = in ? jvh[jg] : zero4();
    float4 wl = in ? jvl[jg] : zero4();
    dsf re[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) re[f] = make_ds(0.f, 0.f);
    // step k: this lane holds the j-body that lane (lane + k) & 31 loaded
    for (int k = 0; k < 32; ++k) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        dsf dx, dy, dz, inv2, inv3;
        ds_pair2(make_ds(qh.x, ql.x), make_ds(qh.y, ql.y), make_ds(qh.z, ql.z),
                 make_ds(pih[u].x, pil[u].x), make_ds(pih[u].y, pil[u].y),
                 make_ds(pih[u].z, pil[u].z), eps2, dx, dy, dz, inv2, inv3);
        const dsf dvx = ds_sub(make_ds(wh.x, wl.x), make_ds(vih[u].x, vil[u].x));
        const dsf dvy = ds_sub(make_ds(wh.y, wl.y), make_ds(vih[u].y, vil[u].y));
        const dsf dvz = ds_sub(make_ds(wh.z, wl.z), make_ds(vih[u].z, vil[u].z));
        // 3 (d . dv) / r^5, mass-free
        dsf c3p = ds_mul_f32(ds_mul(ds_mul(ds_dot3(dx, dy, dz, dvx, dvy, dvz), inv2), inv3), 3.f);
        if (DIAG) {
          // strict upper triangle by local index (row0 == col0): a select
          const bool keep =
              (jl0 + ((lane + k) & 31)) > static_cast<int>(threadIdx.x + u * kThreads);
          inv3 = keep ? inv3 : make_ds(0.f, 0.f);
          c3p = keep ? c3p : make_ds(0.f, 0.f);
        }
        const dsf qx = ds_sub(ds_mul(inv3, dvx), ds_mul(c3p, dx));
        const dsf qy = ds_sub(ds_mul(inv3, dvy), ds_mul(c3p, dy));
        const dsf qz = ds_sub(ds_mul(inv3, dvz), ds_mul(c3p, dz));
        const dsf mj = make_ds(qh.w, ql.w);
        const dsf mi = make_ds(pih[u].w, pil[u].w);
        const dsf s = ds_mul(mj, inv3);  // m_j / r^3: action
        const dsf t = ds_mul(mi, inv3);  // m_i / r^3: reaction
        act[0][u] = ds_add(act[0][u], ds_mul(s, dx));
        act[1][u] = ds_add(act[1][u], ds_mul(s, dy));
        act[2][u] = ds_add(act[2][u], ds_mul(s, dz));
        act[3][u] = ds_add(act[3][u], ds_mul(mj, qx));
        act[4][u] = ds_add(act[4][u], ds_mul(mj, qy));
        act[5][u] = ds_add(act[5][u], ds_mul(mj, qz));
        re[0] = ds_sub(re[0], ds_mul(t, dx));
        re[1] = ds_sub(re[1], ds_mul(t, dy));
        re[2] = ds_sub(re[2], ds_mul(t, dz));
        re[3] = ds_sub(re[3], ds_mul(mi, qx));
        re[4] = ds_sub(re[4], ds_mul(mi, qy));
        re[5] = ds_sub(re[5], ds_mul(mi, qz));
      }
      qh.x = __shfl_sync(kFull, qh.x, src);
      qh.y = __shfl_sync(kFull, qh.y, src);
      qh.z = __shfl_sync(kFull, qh.z, src);
      qh.w = __shfl_sync(kFull, qh.w, src);
      ql.x = __shfl_sync(kFull, ql.x, src);
      ql.y = __shfl_sync(kFull, ql.y, src);
      ql.z = __shfl_sync(kFull, ql.z, src);
      ql.w = __shfl_sync(kFull, ql.w, src);
      wh.x = __shfl_sync(kFull, wh.x, src);
      wh.y = __shfl_sync(kFull, wh.y, src);
      wh.z = __shfl_sync(kFull, wh.z, src);
      wl.x = __shfl_sync(kFull, wl.x, src);
      wl.y = __shfl_sync(kFull, wl.y, src);
      wl.z = __shfl_sync(kFull, wl.z, src);
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        re[f].hi = __shfl_sync(kFull, re[f].hi, src);
        re[f].lo = __shfl_sync(kFull, re[f].lo, src);
      }
    }
    // after 32 passes the sums for j-body jl0 + lane are back in this lane;
    // field f's hi part is component (f / 3) * 6 + f % 3, its lo part 3 on
    float* w = red + warp * kComps * T + jl0 + lane;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      const int hi = (f / 3) * 6 + f % 3;
      w[hi * T] = re[f].hi;
      w[(hi + 3) * T] = re[f].lo;
    }
  }
}

// Triangle of one set: scratch (R, 12, n), R = ceil(n / T).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    ds_aj_sym_tri_kernel(const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
                         const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
                         const int64_t n, const int64_t num_tiles,
                         const float* __restrict__ scal, float* __restrict__ scratch) {
  constexpr int T = kThreads * ROWS;
  const dsf eps2 = read_scalars(scal).eps2;
  extern __shared__ float red[];  // kWarps * kComps * T
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  dsf act[6][ROWS];
  if (r == c) {
    ds_aj_tile_pair<ROWS, true>(pos_hi, pos_lo, vel_hi, vel_lo, n, row0, pos_hi, pos_lo, vel_hi,
                                vel_lo, n, col0, eps2, act, red);
  } else {
    ds_aj_tile_pair<ROWS, false>(pos_hi, pos_lo, vel_hi, vel_lo, n, row0, pos_hi, pos_lo, vel_hi,
                                 vel_lo, n, col0, eps2, act, red);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      const int hi = (f / 3) * 6 + f % 3;
      const dsf re = ds_warp_sum<T, kComps>(red, hi, x);
      if (r == c) {
        if (row0 + x < n) ds_put<kComps>(scratch, r, hi, n, row0 + x, ds_add(act[f][u], re));
      } else {
        if (row0 + x < n) ds_put<kComps>(scratch, c, hi, n, row0 + x, act[f][u]);
        if (col0 + x < n) ds_put<kComps>(scratch, r, hi, n, col0 + x, re);
      }
    }
  }
}

// Rectangle of two sets: act (Cj, 12, bi), react (Ri, 12, bj).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    ds_aj_sym_cross_kernel(const float4* __restrict__ ih, const float4* __restrict__ il,
                           const float4* __restrict__ ivh, const float4* __restrict__ ivl,
                           const int64_t bi, const float4* __restrict__ jh,
                           const float4* __restrict__ jl, const float4* __restrict__ jvh,
                           const float4* __restrict__ jvl, const int64_t bj,
                           const float* __restrict__ scal, float* __restrict__ act_out,
                           float* __restrict__ react_out) {
  constexpr int T = kThreads * ROWS;
  const dsf eps2 = read_scalars(scal).eps2;
  extern __shared__ float red[];
  const int64_t c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  dsf act[6][ROWS];
  ds_aj_tile_pair<ROWS, false>(ih, il, ivh, ivl, bi, row0, jh, jl, jvh, jvl, bj, col0, eps2, act,
                               red);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      const int hi = (f / 3) * 6 + f % 3;
      if (row0 + x < bi) ds_put<kComps>(act_out, c, hi, bi, row0 + x, act[f][u]);
      if (col0 + x < bj) {
        ds_put<kComps>(react_out, r, hi, bj, col0 + x, ds_warp_sum<T, kComps>(red, hi, x));
      }
    }
  }
}

template <int ROWS>
constexpr size_t red_bytes() {
  return static_cast<size_t>(kWarps) * kComps * kThreads * ROWS * sizeof(float);
}

struct Planes {
  const float4 *ph, *pl, *vh, *vl;
};

template <int ROWS>
cudaError_t launch_tri(const Planes p, int64_t n, const float* scal, float* scratch,
                       cudaStream_t stream) {
  const int64_t tiles = cdiv(n, kThreads * ROWS);
  const int64_t blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  // above 48 KB a block's dynamic shared memory needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(ds_aj_sym_tri_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(red_bytes<ROWS>()));
  if (err != cudaSuccess) return err;
  ds_aj_sym_tri_kernel<ROWS><<<static_cast<unsigned>(blocks), kThreads, red_bytes<ROWS>(),
                               stream>>>(p.ph, p.pl, p.vh, p.vl, n, tiles, scal, scratch);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_cross(const Planes pi, int64_t bi, const Planes pj, int64_t bj,
                         const float* scal, float* act, float* react, cudaStream_t stream) {
  const int64_t ri = cdiv(bi, kThreads * ROWS);
  const int64_t cj = cdiv(bj, kThreads * ROWS);
  if (ri > 65535 || cj > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ds_aj_sym_cross_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(red_bytes<ROWS>()));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(cj), static_cast<unsigned>(ri));
  ds_aj_sym_cross_kernel<ROWS><<<grid, kThreads, red_bytes<ROWS>(), stream>>>(
      pi.ph, pi.pl, pi.vh, pi.vl, bi, pj.ph, pj.pl, pj.vh, pj.vl, bj, scal, act, react);
  return cudaGetLastError();
}

Planes planes_of(const void* ph, const void* pl, const void* vh, const void* vl) {
  return Planes{static_cast<const float4*>(ph), static_cast<const float4*>(pl),
                static_cast<const float4*>(vh), static_cast<const float4*>(vl)};
}

// the acceleration and the jerk of (nparts, 12, n) partials, each ds-summed
// in tile order into (hi, lo) outputs with sx, sc strides
cudaError_t sum_aj(const float* parts, int64_t nparts, int64_t n, void* acc_hi, void* acc_lo,
                   void* jerk_hi, void* jerk_lo, int64_t sx, int64_t sc, int zero_w,
                   cudaStream_t stream) {
  cudaError_t err = ds_sum_partials(parts, nparts, kComps, n, static_cast<float*>(acc_hi),
                                    static_cast<float*>(acc_lo), sx, sc, zero_w, stream);
  if (err != cudaSuccess) return err;
  return ds_sum_partials(parts + 6 * n, nparts, kComps, n, static_cast<float*>(jerk_hi),
                         static_cast<float*>(jerk_lo), sx, sc, zero_w, stream);
}

}  // namespace

extern "C" {

// acc_hi, acc_lo, jerk_hi, jerk_lo (n, 3) of the set (n, 4 planes) on
// itself; scratch holds ceil(n / tile) * 12 * n floats.
int nbody_ds_aj_sym(const void* pos_hi, const void* pos_lo, const void* vel_hi, const void* vel_lo,
                    int64_t n, const float* scal, int64_t tile, void* scratch, void* acc_hi,
                    void* acc_lo, void* jerk_hi, void* jerk_lo, void* stream) {
  const int rows = aj_rows_of_tile(tile);
  if (rows == 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const Planes p = planes_of(pos_hi, pos_lo, vel_hi, vel_lo);
  auto sc = static_cast<float*>(scratch);
  cudaError_t err = rows == 1 ? launch_tri<1>(p, n, scal, sc, s) : launch_tri<2>(p, n, scal, sc, s);
  if (err != cudaSuccess) return err;
  return sum_aj(sc, cdiv(n, tile), n, acc_hi, acc_lo, jerk_hi, jerk_lo, 3, 1, 0, s);
}

// acc_hi, acc_lo, jerk_hi, jerk_lo (bi, 4) with w = 0 and react_acc_hi,
// react_acc_lo, react_jerk_hi, react_jerk_lo (3, bj) of the ds rectangle
// (bi, 4 planes) x (bj, 4 planes); scratch_i holds ceil(bj / tile) * 12 * bi
// floats, scratch_j ceil(bi / tile) * 12 * bj.
int nbody_ds_aj_cross(const void* pos_hi_i, const void* pos_lo_i, const void* vel_hi_i,
                      const void* vel_lo_i, int64_t bi, const void* pos_hi_j,
                      const void* pos_lo_j, const void* vel_hi_j, const void* vel_lo_j,
                      int64_t bj, const float* scal, int64_t tile, void* scratch_i,
                      void* scratch_j, void* acc_hi, void* acc_lo, void* jerk_hi, void* jerk_lo,
                      void* racc_hi, void* racc_lo, void* rjerk_hi, void* rjerk_lo,
                      void* stream) {
  const int rows = aj_rows_of_tile(tile);
  if (rows == 0 || bi < 0 || bj < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto si = static_cast<float*>(scratch_i);
  auto sj = static_cast<float*>(scratch_j);
  if (bi > 0 && bj > 0) {
    const Planes pi = planes_of(pos_hi_i, pos_lo_i, vel_hi_i, vel_lo_i);
    const Planes pj = planes_of(pos_hi_j, pos_lo_j, vel_hi_j, vel_lo_j);
    cudaError_t err = rows == 1 ? launch_cross<1>(pi, bi, pj, bj, scal, si, sj, s)
                                : launch_cross<2>(pi, bi, pj, bj, scal, si, sj, s);
    if (err != cudaSuccess) return err;
  }
  // with an empty other side there are no partials: the sums are 0
  cudaError_t err = sum_aj(si, bj > 0 ? cdiv(bj, tile) : 0, bi, acc_hi, acc_lo, jerk_hi, jerk_lo,
                           4, 1, 1, s);
  if (err != cudaSuccess) return err;
  return sum_aj(sj, bi > 0 ? cdiv(bi, tile) : 0, bj, racc_hi, racc_lo, rjerk_hi, rjerk_lo, 1, bj,
                0, s);
}

}  // extern "C"
