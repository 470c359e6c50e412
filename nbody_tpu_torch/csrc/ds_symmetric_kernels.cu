// Each-pair-once (Newton's third law) double-single Plummer gravity for
// Hopper (sm_90a): the ds triangle and ds cross-rectangle kernels of
// nbody_tpu_torch, their fixed-order ds partial sums, and the ds Euler
// update that follows them.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   nbody_ds_sym_accel <- nbody_tpu/ops/ds_kernel.py::_ds_sym_kernel
//                         (compute_accel_pallas_ds_sym): the strict upper
//                         triangle j > i of one set
//   nbody_ds_sym_cross <- nbody_tpu/ops/ds_kernel.py::_ds_sym_cross_kernel
//                         (_ds_sym_cross): the mask-free rectangle of two sets
// and runs the O(N) glue that the JAX package leaves to XLA:
//   nbody_ds_integrate <- ds_kernel.py::_ds_integrate / _ds_kick_drift, the
//                         damped Euler update in ds (one launch, where eager
//                         PyTorch would spend ~100 elementwise launches)
// For each pair (i, j), evaluated once, in the arithmetic of ds_common.cuh
// (ds_kernel.py:1097-1131):
//   d, inv3 as the one-sided kernel;  a_i += (m_j inv3) d  (the action)
//   a_j -= (m_i inv3) d  (the reaction)
// The triangle keeps j > i on the tiles of the diagonal by a select (the
// masked self pair is inf at eps = 0), which also drops the self pair.
//
// Design: symmetric_kernels.cu's, with every sum in ds.
//   * Square tiles of T = 128 * ROWS bodies; a block of 128 threads takes
//     one (row tile, column tile) pair, each thread ROWS i-bodies, their
//     hi/lo positions and masses and three ds action sums in registers.
//   * The triangle's blocks are the flat worklist of tile pairs c >= r
//     (triangle_tile, sym_common.cuh).
//   * The reaction rides around the warp with its j-body: each lane loads
//     one j-body (hi and lo), and for 32 steps meets it with its ROWS
//     i-bodies, then passes the j-body and its three ds reaction sums to
//     the next lane (14 shuffles per ROWS pairs: 8 for the body, 6 for the
//     sums).
//   * The four warps' reaction sums meet in shared memory (4 * 6 * T
//     floats: 48 KB at T = 512, 96 KB at T = 1024, taken as dynamic shared
//     memory with the opt-in) and are ds-added in warp order. A block
//     writes its ds action partial of the row tile and its ds reaction
//     partial of the column tile (on the diagonal one partial, action ds+
//     reaction) into a scratch of ceil(N/T) * 6 * N floats, each (tile,
//     body) slot once; a second kernel ds-adds each body's slots in tile
//     order. No atomics: the same bits on every run.
//
// What bounds it on an H100: the FP32 pipe. A pair is ~294 FP32-pipe
// instructions for both sides, read from this source (the one-sided pair's
// ~225 and m_i inv3 at 9 plus 3 ds_mul + ds_sub at 20 into the reaction),
// and 14 / ROWS shuffles; the JAX package counts 500 flops a pair for the
// rectangle and 250 * N^2 for the triangle (ds_kernel.py:1254,1468). The
// inputs are 32 bytes a body.
//
// Edges: any N, Bi, Bj. A slot past the end loads zeros in both planes, so
// mass 0 on both sides and nothing written for it.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float arrays, pos planes (N, 4) 16-byte aligned; `scal` is a
// device pointer to the (2, 4) block of ops/ds.py::scal_ds, read by every
// kernel at its start (ds_common.cuh). The caller
// allocates the scratch and the outputs, makes the arrays' device current,
// and passes its stream; nothing here allocates or synchronises. Each entry
// point returns the first CUDA error of its launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "ds_sym_common.cuh"

namespace {

constexpr int kComps = 6;  // ds x, y, z: the hi parts, then the lo parts

// One T x T tile pair: rows [row0, row0 + T) of the i-set against columns
// [col0, col0 + T) of the j-set. Leaves each thread's ds action on its rows
// in (ax, ay, az) and the warps' ds reaction sums in red[warp][comp][T].
template <int ROWS, bool DIAG>
__device__ __forceinline__ void ds_tile_pair(
    const float4* __restrict__ ih, const float4* __restrict__ il, const int64_t ni,
    const int64_t row0, const float4* __restrict__ jh, const float4* __restrict__ jl,
    const int64_t nj, const int64_t col0, const dsf eps2, dsf (&ax)[ROWS], dsf (&ay)[ROWS],
    dsf (&az)[ROWS], float* red) {
  constexpr int T = kThreads * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4 pih[ROWS], pil[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int64_t ig = row0 + threadIdx.x + u * kThreads;
    pih[u] = (ig < ni) ? ih[ig] : zero4();
    pil[u] = (ig < ni) ? il[ig] : zero4();
    ax[u] = ay[u] = az[u] = make_ds(0.f, 0.f);
  }
  const int src = (lane + 1) & 31;
  for (int q = 0; q < T / 32; ++q) {
    const int jl0 = q * 32;
    const int64_t jg = col0 + jl0 + lane;
    float4 qh = (jg < nj) ? jh[jg] : zero4();
    float4 ql = (jg < nj) ? jl[jg] : zero4();
    dsf rx = make_ds(0.f, 0.f), ry = rx, rz = rx;
    // step k: this lane holds the j-body that lane (lane + k) & 31 loaded
    for (int k = 0; k < 32; ++k) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        dsf dx, dy, dz, inv3;
        ds_pair(make_ds(qh.x, ql.x), make_ds(qh.y, ql.y), make_ds(qh.z, ql.z),
                make_ds(pih[u].x, pil[u].x), make_ds(pih[u].y, pil[u].y),
                make_ds(pih[u].z, pil[u].z), eps2, dx, dy, dz, inv3);
        dsf s = ds_mul(make_ds(qh.w, ql.w), inv3);          // m_j / r^3: action
        dsf t = ds_mul(make_ds(pih[u].w, pil[u].w), inv3);  // m_i / r^3: reaction
        if (DIAG) {
          // strict upper triangle by local index (row0 == col0): a select
          const bool keep =
              (jl0 + ((lane + k) & 31)) > static_cast<int>(threadIdx.x + u * kThreads);
          s = keep ? s : make_ds(0.f, 0.f);
          t = keep ? t : make_ds(0.f, 0.f);
        }
        ax[u] = ds_add(ax[u], ds_mul(s, dx));
        ay[u] = ds_add(ay[u], ds_mul(s, dy));
        az[u] = ds_add(az[u], ds_mul(s, dz));
        rx = ds_sub(rx, ds_mul(t, dx));
        ry = ds_sub(ry, ds_mul(t, dy));
        rz = ds_sub(rz, ds_mul(t, dz));
      }
      qh.x = __shfl_sync(kFull, qh.x, src);
      qh.y = __shfl_sync(kFull, qh.y, src);
      qh.z = __shfl_sync(kFull, qh.z, src);
      qh.w = __shfl_sync(kFull, qh.w, src);
      ql.x = __shfl_sync(kFull, ql.x, src);
      ql.y = __shfl_sync(kFull, ql.y, src);
      ql.z = __shfl_sync(kFull, ql.z, src);
      ql.w = __shfl_sync(kFull, ql.w, src);
      rx.hi = __shfl_sync(kFull, rx.hi, src);
      ry.hi = __shfl_sync(kFull, ry.hi, src);
      rz.hi = __shfl_sync(kFull, rz.hi, src);
      rx.lo = __shfl_sync(kFull, rx.lo, src);
      ry.lo = __shfl_sync(kFull, ry.lo, src);
      rz.lo = __shfl_sync(kFull, rz.lo, src);
    }
    // after 32 passes the sums for j-body jl0 + lane are back in this lane
    float* w = red + warp * kComps * T + jl0 + lane;
    w[0 * T] = rx.hi;
    w[1 * T] = ry.hi;
    w[2 * T] = rz.hi;
    w[3 * T] = rx.lo;
    w[4 * T] = ry.lo;
    w[5 * T] = rz.lo;
  }
}

// Triangle of one set: scratch (R, 6, n), R = ceil(n / T).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    ds_sym_tri_kernel(const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
                      const int64_t n, const int64_t num_tiles, const float* __restrict__ scal,
                      float* __restrict__ scratch) {
  constexpr int T = kThreads * ROWS;
  const dsf eps2 = read_scalars(scal).eps2;
  extern __shared__ float red[];  // kWarps * kComps * T
  int64_t r, c;
  triangle_tile(blockIdx.x, num_tiles, r, c);
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  dsf ax[ROWS], ay[ROWS], az[ROWS];
  if (r == c) {
    ds_tile_pair<ROWS, true>(pos_hi, pos_lo, n, row0, pos_hi, pos_lo, n, col0, eps2, ax, ay, az,
                             red);
  } else {
    ds_tile_pair<ROWS, false>(pos_hi, pos_lo, n, row0, pos_hi, pos_lo, n, col0, eps2, ax, ay, az,
                              red);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
    const dsf a[3] = {ax[u], ay[u], az[u]};
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      const dsf re = ds_warp_sum<T, kComps>(red, comp, x);
      if (r == c) {
        if (row0 + x < n) ds_put<kComps>(scratch, r, comp, n, row0 + x, ds_add(a[comp], re));
      } else {
        if (row0 + x < n) ds_put<kComps>(scratch, c, comp, n, row0 + x, a[comp]);
        if (col0 + x < n) ds_put<kComps>(scratch, r, comp, n, col0 + x, re);
      }
    }
  }
}

// Rectangle of two sets: act (Cj, 6, bi), react (Ri, 6, bj).
template <int ROWS>
__global__ void __launch_bounds__(kThreads)
    ds_sym_cross_kernel(const float4* __restrict__ ih, const float4* __restrict__ il,
                        const int64_t bi, const float4* __restrict__ jh,
                        const float4* __restrict__ jl, const int64_t bj,
                        const float* __restrict__ scal, float* __restrict__ act,
                        float* __restrict__ react) {
  constexpr int T = kThreads * ROWS;
  const dsf eps2 = read_scalars(scal).eps2;
  extern __shared__ float red[];
  const int64_t c = blockIdx.x;
  const int64_t r = blockIdx.y;
  const int64_t row0 = r * T;
  const int64_t col0 = c * T;
  dsf ax[ROWS], ay[ROWS], az[ROWS];
  ds_tile_pair<ROWS, false>(ih, il, bi, row0, jh, jl, bj, col0, eps2, ax, ay, az, red);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int x = threadIdx.x + u * kThreads;
    const dsf a[3] = {ax[u], ay[u], az[u]};
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      if (row0 + x < bi) ds_put<kComps>(act, c, comp, bi, row0 + x, a[comp]);
      if (col0 + x < bj) {
        ds_put<kComps>(react, r, comp, bj, col0 + x, ds_warp_sum<T, kComps>(red, comp, x));
      }
    }
  }
}

// The damped Euler update in ds (ds_kernel.py:1271-1301), one thread a body:
// v' = (v + a dt) * damping, p' = p + v' dt, mass and vel.w carried through.
// The acceleration's rows are `stride` floats apart: 3 for the (n, 3)
// fields of the each-pair-once composition, 4 for the (n, 4) rows of the ds
// accel kernel (ds_kernels.cu).
__global__ void __launch_bounds__(256)
    ds_integrate_kernel(const float4* __restrict__ pos_hi, const float4* __restrict__ pos_lo,
                        const float4* __restrict__ vel_hi, const float4* __restrict__ vel_lo,
                        const float* __restrict__ acc_hi, const float* __restrict__ acc_lo,
                        const int64_t stride, float4* __restrict__ new_pos_hi,
                        float4* __restrict__ new_pos_lo, float4* __restrict__ new_vel_hi,
                        float4* __restrict__ new_vel_lo, const int64_t n,
                        const float* __restrict__ scal) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ds_scalars s = read_scalars(scal);
  const float* ah = acc_hi + stride * i;
  const float* al = acc_lo + stride * i;
  ds_kick_drift(pos_hi[i], pos_lo[i], vel_hi[i], vel_lo[i], make_ds(ah[0], al[0]),
                make_ds(ah[1], al[1]), make_ds(ah[2], al[2]), s.dt, s.damping, s.dt, new_pos_hi + i,
                new_pos_lo + i, new_vel_hi + i, new_vel_lo + i);
}

template <int ROWS>
constexpr size_t red_bytes() {
  return static_cast<size_t>(kWarps) * kComps * kThreads * ROWS * sizeof(float);
}

template <int ROWS>
cudaError_t launch_tri(const float4* ph, const float4* pl, int64_t n, const float* scal,
                       float* scratch, cudaStream_t stream) {
  const int64_t tiles = cdiv(n, kThreads * ROWS);
  const int64_t blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  // above 48 KB a block's dynamic shared memory needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(ds_sym_tri_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(red_bytes<ROWS>()));
  if (err != cudaSuccess) return err;
  ds_sym_tri_kernel<ROWS><<<static_cast<unsigned>(blocks), kThreads, red_bytes<ROWS>(), stream>>>(
      ph, pl, n, tiles, scal, scratch);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_cross(const float4* ih, const float4* il, int64_t bi, const float4* jh,
                         const float4* jl, int64_t bj, const float* scal, float* act,
                         float* react, cudaStream_t stream) {
  const int64_t ri = cdiv(bi, kThreads * ROWS);
  const int64_t cj = cdiv(bj, kThreads * ROWS);
  if (ri > 65535 || cj > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ds_sym_cross_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(red_bytes<ROWS>()));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(cj), static_cast<unsigned>(ri));
  ds_sym_cross_kernel<ROWS><<<grid, kThreads, red_bytes<ROWS>(), stream>>>(ih, il, bi, jh, jl, bj,
                                                                          scal, act, react);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// acc_hi, acc_lo (n, 3) of the set (n, 4) on itself; scratch holds
// ceil(n / tile) * 6 * n floats.
int nbody_ds_sym_accel(const void* pos_hi, const void* pos_lo, int64_t n, const float* scal,
                       int64_t tile, void* scratch, void* acc_hi, void* acc_lo, void* stream) {
  const int rows = rows_of_tile(tile);
  if (rows == 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ph = static_cast<const float4*>(pos_hi);
  const auto pl = static_cast<const float4*>(pos_lo);
  auto sc = static_cast<float*>(scratch);
  cudaError_t err = rows == 1   ? launch_tri<1>(ph, pl, n, scal, sc, s)
                    : rows == 2 ? launch_tri<2>(ph, pl, n, scal, sc, s)
                    : rows == 4 ? launch_tri<4>(ph, pl, n, scal, sc, s)
                                : launch_tri<8>(ph, pl, n, scal, sc, s);
  if (err != cudaSuccess) return err;
  return ds_sum_partials(sc, cdiv(n, tile), kComps, n, static_cast<float*>(acc_hi),
                         static_cast<float*>(acc_lo), 3, 1, 0, s);
}

// acc_hi, acc_lo (bi, 4) with w = 0 and react_hi, react_lo (3, bj) of the
// ds rectangle (bi, 4) x (bj, 4); scratch_i holds ceil(bj / tile) * 6 * bi
// floats, scratch_j ceil(bi / tile) * 6 * bj.
int nbody_ds_sym_cross(const void* pos_hi_i, const void* pos_lo_i, int64_t bi,
                       const void* pos_hi_j, const void* pos_lo_j, int64_t bj, const float* scal,
                       int64_t tile, void* scratch_i, void* scratch_j, void* acc_hi, void* acc_lo,
                       void* react_hi, void* react_lo, void* stream) {
  const int rows = rows_of_tile(tile);
  if (rows == 0 || bi < 0 || bj < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto si = static_cast<float*>(scratch_i);
  auto sj = static_cast<float*>(scratch_j);
  if (bi > 0 && bj > 0) {
    const auto ih = static_cast<const float4*>(pos_hi_i);
    const auto il = static_cast<const float4*>(pos_lo_i);
    const auto jh = static_cast<const float4*>(pos_hi_j);
    const auto jl = static_cast<const float4*>(pos_lo_j);
    cudaError_t err = rows == 1   ? launch_cross<1>(ih, il, bi, jh, jl, bj, scal, si, sj, s)
                      : rows == 2 ? launch_cross<2>(ih, il, bi, jh, jl, bj, scal, si, sj, s)
                      : rows == 4 ? launch_cross<4>(ih, il, bi, jh, jl, bj, scal, si, sj, s)
                                  : launch_cross<8>(ih, il, bi, jh, jl, bj, scal, si, sj, s);
    if (err != cudaSuccess) return err;
  }
  // with an empty other side there are no partials: the sums are 0
  cudaError_t err = ds_sum_partials(si, bj > 0 ? cdiv(bj, tile) : 0, kComps, bi,
                                    static_cast<float*>(acc_hi), static_cast<float*>(acc_lo), 4, 1,
                                    1, s);
  if (err != cudaSuccess) return err;
  return ds_sum_partials(sj, bi > 0 ? cdiv(bi, tile) : 0, kComps, bj,
                         static_cast<float*>(react_hi), static_cast<float*>(react_lo), 1, bj, 0,
                         s);
}

// the four new planes of the set (n, 4) after the ds Euler update with the
// ds acceleration acc_hi, acc_lo: n rows of 3 floats, `stride` (3 or 4)
// floats apart
int nbody_ds_integrate(const void* pos_hi, const void* pos_lo, const void* vel_hi,
                       const void* vel_lo, const void* acc_hi, const void* acc_lo, int64_t stride,
                       void* new_pos_hi, void* new_pos_lo, void* new_vel_hi, void* new_vel_lo,
                       int64_t n, const float* scal, void* stream) {
  if (n < 0 || (stride != 3 && stride != 4)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  ds_integrate_kernel<<<static_cast<unsigned>(cdiv(n, 256)), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_hi), static_cast<const float4*>(pos_lo),
      static_cast<const float4*>(vel_hi), static_cast<const float4*>(vel_lo),
      static_cast<const float*>(acc_hi), static_cast<const float*>(acc_lo), stride,
      static_cast<float4*>(new_pos_hi), static_cast<float4*>(new_pos_lo),
      static_cast<float4*>(new_vel_hi), static_cast<float4*>(new_vel_lo), n, scal);
  return cudaGetLastError();
}

}  // extern "C"
