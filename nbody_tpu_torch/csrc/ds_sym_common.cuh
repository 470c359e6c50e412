// Shared pieces of the double-single kernels that sum in partials: the
// warps' ds reaction sum of the each-pair-once kernels
// (ds_symmetric_kernels.cu, ds_symmetric_aj_kernels.cu), and the ds partial
// slots and their fixed-order ds sum, which the one-sided kernels' j-chunks
// (ds_kernels.cu, ds_aj_kernels.cu) use too.
//
// A ds field of three components is stored as six float components, the
// hi parts of x, y, z at components hi, hi + 1, hi + 2 and their lo parts
// three further on; NCOMP is the number of float components a body has in
// one partial (6 for the force, 12 for accel + jerk).
// Everything is in an unnamed namespace, so each source that includes this
// header has its own copy and the objects link without clashes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "ds_common.cuh"
#include "sym_common.cuh"

namespace {

// the warps' ds sums of local column x, red[warp][NCOMP][T], the hi part
// at component hi and the lo part at hi + 3, ds-added in warp order
template <int T, int NCOMP>
__device__ __forceinline__ dsf ds_warp_sum(const float* red, const int hi, const int x) {
  dsf s = make_ds(red[hi * T + x], red[(hi + 3) * T + x]);
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    s = ds_add(s, make_ds(red[(w * NCOMP + hi) * T + x], red[(w * NCOMP + hi + 3) * T + x]));
  }
  return s;
}

// parts[(t * NCOMP + hi) * n + x] and parts[(t * NCOMP + hi + 3) * n + x]
// = the (hi, lo) slot of a ds value
template <int NCOMP>
__device__ __forceinline__ void ds_put(float* parts, const int64_t t, const int hi,
                                       const int64_t n, const int64_t x, const dsf v) {
  parts[(t * NCOMP + hi) * n + x] = v.hi;
  parts[(t * NCOMP + hi + 3) * n + x] = v.lo;
}

// the (hi, lo) slot of component comp < 3 of partial t
__device__ __forceinline__ dsf ds_slot(const float* __restrict__ parts, const int64_t t,
                                       const int64_t pstride, const int64_t n, const int64_t comp,
                                       const int64_t x) {
  return make_ds(parts[(t * pstride + comp) * n + x], parts[(t * pstride + 3 + comp) * n + x]);
}

// the ds sum over t = 0, 1, ... of the slots parts[(t * pstride + comp) *
// n + x] (hi) and parts[(t * pstride + 3 + comp) * n + x] (lo), comp < 3,
// in tile (or chunk) order, from the first slot; no parts: 0. Unrolled, so
// that several slots' loads are in flight before their adds.
__device__ __forceinline__ dsf ds_slot_sum(const float* __restrict__ parts, const int64_t nparts,
                                           const int64_t pstride, const int64_t n,
                                           const int64_t comp, const int64_t x) {
  dsf s = make_ds(0.f, 0.f);
  if (nparts > 0) s = ds_slot(parts, 0, pstride, n, comp, x);
#pragma unroll 4
  for (int64_t t = 1; t < nparts; ++t) s = ds_add(s, ds_slot(parts, t, pstride, n, comp, x));
  return s;
}

// ds_slot_sum of components 0, 1 and 2 in one pass: each component's sum
// in its own order, so the same bits, with three chains and six loads a
// slot in flight
__device__ __forceinline__ void ds_slot_sum3(const float* __restrict__ parts,
                                             const int64_t nparts, const int64_t pstride,
                                             const int64_t n, const int64_t x, dsf& sx, dsf& sy,
                                             dsf& sz) {
  sx = make_ds(0.f, 0.f);
  sy = sx;
  sz = sx;
  if (nparts > 0) {
    sx = ds_slot(parts, 0, pstride, n, 0, x);
    sy = ds_slot(parts, 0, pstride, n, 1, x);
    sz = ds_slot(parts, 0, pstride, n, 2, x);
  }
#pragma unroll 4
  for (int64_t t = 1; t < nparts; ++t) {
    sx = ds_add(sx, ds_slot(parts, t, pstride, n, 0, x));
    sy = ds_add(sy, ds_slot(parts, t, pstride, n, 1, x));
    sz = ds_add(sz, ds_slot(parts, t, pstride, n, 2, x));
  }
}

// out_hi/out_lo[x * sx + comp * sc] = ds_slot_sum(..., comp, x), comp < 3;
// with zero_w, the w lane (x * sx + 3 * sc) is 0 as well
__global__ void __launch_bounds__(256)
    ds_sum_partials_kernel(const float* __restrict__ parts, const int64_t nparts,
                           const int64_t pstride, const int64_t n, float* __restrict__ out_hi,
                           float* __restrict__ out_lo, const int64_t sx, const int64_t sc,
                           const int zero_w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3 * n) return;
  const int64_t comp = idx / n;
  const int64_t x = idx - comp * n;
  const dsf s = ds_slot_sum(parts, nparts, pstride, n, comp, x);
  out_hi[x * sx + comp * sc] = s.hi;
  out_lo[x * sx + comp * sc] = s.lo;
  if (zero_w && comp == 0) {
    out_hi[x * sx + 3 * sc] = 0.f;
    out_lo[x * sx + 3 * sc] = 0.f;
  }
}

cudaError_t ds_sum_partials(const float* parts, int64_t nparts, int64_t pstride, int64_t n,
                            float* out_hi, float* out_lo, int64_t sx, int64_t sc, int zero_w,
                            cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>(cdiv(3 * n, 256));
  ds_sum_partials_kernel<<<blocks, 256, 0, stream>>>(parts, nparts, pstride, n, out_hi, out_lo,
                                                      sx, sc, zero_w);
  return cudaGetLastError();
}

}  // namespace
