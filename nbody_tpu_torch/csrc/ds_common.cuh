// Double-single ("ds") arithmetic on the device: every value is an
// unevaluated sum hi + lo of two floats (a ~49-bit significand), carried
// through error-free transformations. Shared by every ds source
// (ds_kernels.cu, ds_symmetric_kernels.cu, ds_aj_kernels.cu,
// ds_symmetric_aj_kernels.cu); the counterpart of ops/ds.py and of
// nbody_tpu/ops/ds_kernel.py:75-153.
//
// Why intrinsics. The error terms below are exact only if every sum and
// product is rounded to float where the algorithm says so. nvcc builds with
// -fmad=true, which contracts a*b + c into one FMA and silently loses those
// roundings (nbody_tpu/ops/ds_kernel.py:50-58 measured ds_mul going from
// 1.3e-14 to 5.8e-8 relative error that way). __fadd_rn, __fsub_rn and
// __fmul_rn are never contracted, so every operation here is one of them,
// and the kernels stay correct whatever -fmad says.
//
// The product's error term is one hardware FMA, fma(a, b, -a*b), exact for
// floats that do not underflow. It replaces Dekker's split (the 2^12 + 1
// splitter and four partial products, 17 flops, ds_kernel.py:89-100), which
// the JAX package needs because jnp exposes no FMA; both give the same
// exact error, so the results agree bit for bit with ops/ds.py.
//
// Everything is in an unnamed namespace, so each source that includes this
// header has its own copy and the objects link without clashes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

struct dsf {
  float hi;
  float lo;
};

__host__ __device__ __forceinline__ dsf make_ds(const float hi, const float lo) {
  dsf r;
  r.hi = hi;
  r.lo = lo;
  return r;
}

// Knuth: s + err == a + b exactly (ds_kernel.py:75-79)
__device__ __forceinline__ dsf two_sum(const float a, const float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return make_ds(s, err);
}

// s + err == a + b exactly when |a| >= |b| (ds_kernel.py:82-86)
__device__ __forceinline__ dsf quick_two_sum(const float a, const float b) {
  const float s = __fadd_rn(a, b);
  return make_ds(s, __fsub_rn(b, __fsub_rn(s, a)));
}

// p + err == a * b exactly, the error from one FMA (see the header note)
__device__ __forceinline__ dsf two_prod(const float a, const float b) {
  const float p = __fmul_rn(a, b);
  return make_ds(p, __fmaf_rn(a, b, -p));
}

__device__ __forceinline__ dsf ds_add(const dsf x, const dsf y) {
  const dsf s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, __fadd_rn(__fadd_rn(s.lo, x.lo), y.lo));
}

__device__ __forceinline__ dsf ds_neg(const dsf x) { return make_ds(-x.hi, -x.lo); }

__device__ __forceinline__ dsf ds_sub(const dsf x, const dsf y) { return ds_add(x, ds_neg(y)); }

__device__ __forceinline__ dsf ds_mul(const dsf x, const dsf y) {
  const dsf p = two_prod(x.hi, y.hi);
  return quick_two_sum(p.hi, __fadd_rn(__fadd_rn(p.lo, __fmul_rn(x.hi, y.lo)),
                                       __fmul_rn(x.lo, y.hi)));
}

__device__ __forceinline__ dsf ds_mul_f32(const dsf x, const float c) {
  const dsf p = two_prod(x.hi, c);
  return quick_two_sum(p.hi, __fadd_rn(p.lo, __fmul_rn(x.lo, c)));
}

// 1/sqrt(x): the hardware rsqrtf seed (~23 bits) and one Newton step in ds,
// y1 = y0 (3 - x y0^2) / 2 (ds_kernel.py:134-153)
__device__ __forceinline__ dsf ds_rsqrt(const dsf x) {
  const dsf y = make_ds(rsqrtf(x.hi), 0.f);
  const dsf t = ds_mul(x, ds_mul(y, y));
  const dsf corr = ds_sub(make_ds(3.f, 0.f), t);
  return ds_mul_f32(ds_mul(y, corr), 0.5f);
}

// the pair geometry in the op order of ds_kernel.py:206-212 and :795-805:
// d = p_j - p_i, r2 = (dx^2 + dy^2) + (dz^2 + eps2), inv2 = inv * inv,
// inv3 = inv2 * inv
__device__ __forceinline__ void ds_pair2(const dsf xj, const dsf yj, const dsf zj, const dsf xi,
                                         const dsf yi, const dsf zi, const dsf eps2, dsf& dx,
                                         dsf& dy, dsf& dz, dsf& inv2, dsf& inv3) {
  dx = ds_sub(xj, xi);
  dy = ds_sub(yj, yi);
  dz = ds_sub(zj, zi);
  const dsf r2 = ds_add(ds_add(ds_mul(dx, dx), ds_mul(dy, dy)), ds_add(ds_mul(dz, dz), eps2));
  const dsf inv = ds_rsqrt(r2);
  inv2 = ds_mul(inv, inv);
  inv3 = ds_mul(inv2, inv);
}

// the force's geometry: ds_pair2 without inv2
__device__ __forceinline__ void ds_pair(const dsf xj, const dsf yj, const dsf zj, const dsf xi,
                                        const dsf yi, const dsf zi, const dsf eps2, dsf& dx,
                                        dsf& dy, dsf& dz, dsf& inv3) {
  dsf inv2;
  ds_pair2(xj, yj, zj, xi, yi, zi, eps2, dx, dy, dz, inv2, inv3);
}

// (ax bx + ay by) + az bz, the op order of ds_kernel.py:807-808
__device__ __forceinline__ dsf ds_dot3(const dsf ax, const dsf ay, const dsf az, const dsf bx,
                                       const dsf by, const dsf bz) {
  return ds_add(ds_add(ds_mul(ax, bx), ds_mul(ay, by)), ds_mul(az, bz));
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// v' = (v + a dt) * damping, p' = p + v' dt_pos per coordinate, in ds; the
// mass and vel.w carried through from both planes
__device__ __forceinline__ void ds_kick_drift(const float4 ph, const float4 pl, const float4 vh,
                                              const float4 vl, const dsf ax, const dsf ay,
                                              const dsf az, const dsf dt, const dsf damping,
                                              const dsf dt_pos, float4* out_ph, float4* out_pl,
                                              float4* out_vh, float4* out_vl) {
  const dsf vx = ds_mul(ds_add(make_ds(vh.x, vl.x), ds_mul(ax, dt)), damping);
  const dsf vy = ds_mul(ds_add(make_ds(vh.y, vl.y), ds_mul(ay, dt)), damping);
  const dsf vz = ds_mul(ds_add(make_ds(vh.z, vl.z), ds_mul(az, dt)), damping);
  const dsf px = ds_add(make_ds(ph.x, pl.x), ds_mul(vx, dt_pos));
  const dsf py = ds_add(make_ds(ph.y, pl.y), ds_mul(vy, dt_pos));
  const dsf pz = ds_add(make_ds(ph.z, pl.z), ds_mul(vz, dt_pos));
  *out_vh = make_float4(vx.hi, vy.hi, vz.hi, vh.w);
  *out_vl = make_float4(vx.lo, vy.lo, vz.lo, vl.w);
  *out_ph = make_float4(px.hi, py.hi, pz.hi, ph.w);
  *out_pl = make_float4(px.lo, py.lo, pz.lo, pl.w);
}

// The scalar block, (2, 4) floats in device memory: row 0 the hi and row 1
// the lo parts of [dt, eps^2, damping, dt/2] (ops/ds.py::scal_ds /
// scal_ds_leapfrog, or ds_scal_with_dt's block built on the device). Every
// kernel reads it at its start, so a dt chosen on the device (an adaptive
// step) needs no host round trip; the values, and so the bits, are those a
// host block passed by value gave.
struct ds_scalars {
  dsf dt, eps2, damping, dt_half;
};

__device__ __forceinline__ ds_scalars read_scalars(const float* __restrict__ scal) {
  ds_scalars s;
  s.dt = make_ds(scal[0], scal[4]);
  s.eps2 = make_ds(scal[1], scal[5]);
  s.damping = make_ds(scal[2], scal[6]);
  s.dt_half = make_ds(scal[3], scal[7]);
  return s;
}

// The Hermite block, (2, 8) floats in device memory: the hi and lo parts of
// [dt, eps^2, damping, dt/2, dt^2/2, dt^3/6, dt^2/12, 0]
// (ops/ds.py::scal_ds_hermite, or ds_scal_with_dt's)
struct ds_hermite_scalars {
  dsf dt, eps2, damping, dt_half, dt2_2, dt3_6, dt2_12;
};

__device__ __forceinline__ ds_hermite_scalars read_hermite_scalars(
    const float* __restrict__ scal) {
  ds_hermite_scalars s;
  s.dt = make_ds(scal[0], scal[8]);
  s.eps2 = make_ds(scal[1], scal[9]);
  s.damping = make_ds(scal[2], scal[10]);
  s.dt_half = make_ds(scal[3], scal[11]);
  s.dt2_2 = make_ds(scal[4], scal[12]);
  s.dt3_6 = make_ds(scal[5], scal[13]);
  s.dt2_12 = make_ds(scal[6], scal[14]);
  return s;
}

}  // namespace
