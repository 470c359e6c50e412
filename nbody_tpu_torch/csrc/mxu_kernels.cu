// The fused Euler step with the force reduction on the tensor cores, for
// Hopper (sm_90a): the "mxu" and "mxu_bf16" variants of nbody_tpu_torch.
//
// Replaces one Pallas TPU kernel of the JAX package, in its two dtypes:
//   nbody_mxu_step_f32  <- nbody_tpu/ops/pallas_kernel.py::_mxu_step_kernel
//   nbody_mxu_step_bf16    (def :171, pallas_call :421; nbody_step_pallas_vs
//                           with variant="mxu" / "mxu_bf16")
// and the `_split` forms of both, which run the same walk in j-chunks.
// Its algebra (pallas_kernel.py:125-199), which is not the one-sided force
// in other words: for the i-set (M bodies) under the j-set (N bodies),
//   s_ij = rsqrt(|p_j - p_i|^2 + eps^2)^3       float32, no mass, no d
//   P_j  = [x_j m_j, y_j m_j, z_j m_j, m_j]
//   acc4 = s @ P                                the matrix product
//   a_i  = acc4[:3] - p_i acc4[3];  v = (v + a dt) damping;  p = p + v dt
// The self pair is not masked: s_ii = 1/eps^3 enters both acc4 terms and
// cancels only as far as the rounding of the product lets it (for bf16 by
// about s_ii |p_i| 2^-9: the JAX package's function, ported as it is).
// "mxu" is f32-grade: the JAX kernel's Precision.HIGHEST, which emulates an
// f32 product with several bf16 passes, becomes a 3xTF32 split here (below).
// One TF32 pass would keep ~3 decimal digits, which is not f32 grade.
// "mxu_bf16" rounds s and P to bf16 (cvt.rn.bf16x2.f32, round to nearest
// even, as the JAX astype does) and sums in f32: the JAX semantics exactly.
//
// Design, for Hopper's issue rate rather than the TPU's grid. One templated
// walk; only the fragment conversion and the mma differ between the two
// instantiations (Tf32x3: m16n8k8 TF32, two mmas a k-step; Bf16: m16n8k16
// bf16, one), so the f32-grade one, held tightly to its plain version,
// vouches for the index maps that both share.
//   * The i-tile: a block of kMxuWarps warps owns kMxuRows rows, a warp
//     kMxuTiles m16 tiles, so one shared-memory read of a j-position and one
//     B fragment serve 2 * kMxuTiles rows of a thread; a tile's k-steps are
//     unrolled 4 times. On an H100 (scripts/torch_mxu_bench.py, in turns):
//     2 m16 tiles a warp (56 / 63 registers) ran 3 % behind 4 (96) in TF32
//     and level in bf16; unrolled twice, 3.4 % behind; a second accumulator
//     for the small pass, level.
//   * s: each thread computes the s values of its own A-fragment elements
//     (rows g + 8h of each tile, lane g = lane / 4, and the columns its lane
//     t = lane % 4 holds), so no s is computed twice, as the other fp32 walks
//     compute a pair: 3 FADD for d, r2 = fma(dz, dz, fma(dy, dy, fma(dx, dx,
//     eps2))), one MUFU.RSQ (rsqrt_ftz, sym_common.cuh: rsqrtf's bits for
//     every normal r2 without its subnormal fix-up) and two FMUL for inv^3,
//     every operation written out so that both instantiations get the same
//     s. The plain version's s (torch.rsqrt, unfused) differs by a few ulp,
//     which the mxu error model covers (ops/reference.py, MXU_ERROR_COEF).
//   * The 3xTF32 split without cvt.rna.tf32 (about 4 SASS instructions
//     each): big = (bits(x) + 0x1000) & ~0x1fff, round to nearest with ties
//     away from zero, the bits of cvt.rna.tf32.f32 for every finite x, in an
//     IADD and a LOP; small = x - big, exact in f32, passed as it is. The
//     tensor core reads a .tf32 operand's top 19 bits and ignores the low
//     13, which is why CUTLASS's tfloat32_t clears those "dont-care bits" in
//     its conversion to float (cutlass/tfloat32.h) and its
//     round_half_ulp_truncate converter only adds 0x1000: so small enters
//     the product truncated, within 2^-21 |x|, or closer if the hardware
//     reads more; the low bits can only bring it nearer x - big. A pair's A
//     split is 3 instructions.
//   * B once, at staging: P's TF32 big and small parts (both rounded) or its
//     bf16 values go into shared memory when a j-body is staged, already in
//     the fragment layout (one LDS.64 a lane a k-step), not split or packed
//     again by every warp at every step.
//   * Two mmas a k-step for 3xTF32, not three: B holds P_big in columns 0..3
//     and P_small in 4..7 (the n = 8 the mma computes anyway), so
//     mma(A_big, B) then mma(A_small, B) give sum s P_big in columns 0..3
//     and sum s P_small in 4..7, small * small included; the chunk's sums
//     add column c and c + 4. bf16 keeps B's columns 4..7 zero: one mma.
//   * The j-side staged kMxuStage bodies a barrier (kMxuStage / kMxuTileJ
//     tiles). Each kMxuTileJ-body tile's product starts from a zero
//     fragment and is added to the running sums with one round-to-nearest
//     add: the tensor core's own accumulation spans 16 (TF32) or 8 (bf16)
//     mma steps, and the N/128 tile sums round as the plain version's do,
//     the span the error model's random-walk term assumes.
//   * A fixed-order j-split: the grid is (i-tiles, S), chunk c of the
//     j-range [c * L, min((c + 1) * L, N)), L a whole number of stages, S a
//     pure function of (M, N) (ops/cuda_kernel.py::mxu_splits). With S = 1 a
//     block applies the update; with S > 1 it writes its four sums into the
//     partials (S, 4, M) and mxu_finish_kernel adds each row's partials in
//     chunk order from 0, then applies the same update (mxu_update). The
//     bits depend on (M, N) alone; no atomics, a repeat call gives the same.
// Fragment layouts are those of the PTX ISA's mma section (and of CuTe's
// SM80_16x8x8_F32TF32TF32F32_TN / SM80_16x8x16_F32BF16BF16F32_TN); Op::col
// below is the column (A) and row (B) map. The C fragment of a lane holds
// rows g, g+8 at columns 2t, 2t+1: t = 0 x, y; t = 1 z, m; t = 2, 3 the
// small parts of the same (TF32). After the walk a row's four sums come
// together in two xor-shuffles; lane t = 0 takes row g and t = 1 row g + 8.
//
// Edges: any M and N. s is set to 0 for a j-slot past N by a select, never
// by a zero mass (inf or NaN times a zero B would give NaN in the mma); a
// tile wholly past N is skipped; rows past M are computed from a zero
// position and not stored.
//
// What bounds it on an H100: issue and the SFU, not the tensor cores. A
// pair is 20 flops by the JAX package's count (pallas_kernel.py:399-400),
// 1.282 ms at N=65536 at 67 TFLOP/s; the mma work is 16 flops a (padded)
// pair and pass, two TF32 passes 0.28 ms, one bf16 pass 0.07 ms at 65536.
// Per pair the walk issues the difference, distance and cube (3 FADD, 3
// FFMA, 2 FMUL), for TF32 the A split (IADD3, LOP3, FADD) and half an HMMA,
// for bf16 half a pack and an eighth of an HMMA: 12.9 / 9.9 SASS
// instructions a pair, 1.66 / 1.27 ms of issue at 65536 and 1.98 GHz; one
// MUFU.RSQ a pair goes to the SFU, 16 a clock an SM: 1.03 ms, the floor
// of both instantiations. Times: PERF.md, Findings.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float32 (M,4) / (N,4) arrays, 16-byte aligned; the `_split`
// entry points take S and a device scratch of S * 4 * M floats. The kernels
// run on the given stream of the current device, allocate nothing and do
// not synchronise. Each entry point returns cudaGetLastError() after its
// launches.

#include <cstdint>

#include <cuda_runtime.h>

#include "sym_common.cuh"

namespace {

constexpr int kMxuWarps = 4;
constexpr int kMxuThreads = 32 * kMxuWarps;
constexpr int kMxuTiles = 4;  // m16 tiles a warp
constexpr int kMxuRows = kMxuWarps * 16 * kMxuTiles;  // the i-tile: ops/cuda_kernel.py MXU_TILE_I
constexpr int kMxuTileJ = 128;  // j-bodies a tile sum from a zero fragment
constexpr int kMxuStage = 512;  // j-bodies staged a barrier: ops/cuda_kernel.py MXU_STAGE
constexpr uint32_t kTf32Mask = 0xffffe000u;

__device__ __forceinline__ float pair_s(const float px, const float py, const float pz,
                                        const float4 pj, const float eps2) {
  const float dx = __fsub_rn(pj.x, px);
  const float dy = __fsub_rn(pj.y, py);
  const float dz = __fsub_rn(pj.z, pz);
  const float r2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)));
  const float inv = rsqrt_ftz(r2);
  return __fmul_rn(__fmul_rn(inv, inv), inv);
}

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// bits for every finite x, as an integer add and a mask
__device__ __forceinline__ uint32_t tf32_big(const float x) {
  return (__float_as_uint(x) + 0x1000u) & kTf32Mask;
}

// bf16x2 of (lo, hi): lo in the lower half, the element of the lower index
__device__ __forceinline__ uint32_t pack_bf16(const float lo, const float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// bf16 of x, to nearest even, in the low 16 bits
__device__ __forceinline__ uint32_t bf16_bits(const float x) {
  return pack_bf16(x, 0.f) & 0xffffu;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The staged B of a k-step is one uint2 a lane, sB[step * 32 + lane]: lane
// (g, t) holds B at column g and its two k-rows (below). As 32-bit words,
// body kk of the step at column g is word step * 64 + (4 g + t) * 2 + slot.
//
// s[h][q] is A at row g + 8h and column col(t, q).

// m16n8k8 TF32, 3xTF32. A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8,
// t+4); B: b0 (k = t), b1 (k = t+4). Columns 0..3 of B are P's TF32 big
// parts, 4..7 its small parts.
struct Tf32x3 {
  static constexpr int K = 8;
  static constexpr int NC = 2;
  static constexpr bool kSmallCols = true;
  __device__ __forceinline__ static int col(const int t, const int q) { return t + 4 * q; }
  __device__ __forceinline__ static void stage_b(uint32_t* sw, const int k, const float (&P)[4]) {
    const int step = k / K, kk = k % K;
    uint32_t* w = sw + step * 64 + (kk & 3) * 2 + (kk >> 2);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t big = tf32_big(P[c]);
      w[c * 8] = big;
      w[(c + 4) * 8] = tf32_big(__fsub_rn(P[c], __uint_as_float(big)));
    }
  }
  __device__ __forceinline__ static void mma(float (&d)[4], const float (&s)[2][NC],
                                             const uint2 b) {
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[e & 1][e >> 1];  // a0 s[0][0], a1 s[1][0], a2 s[0][1], a3 s[1][1]
      big[e] = tf32_big(x);
      small[e] = __float_as_uint(__fsub_rn(x, __uint_as_float(big[e])));
    }
    mma_tf32(d, big, b);
    mma_tf32(d, small, b);
  }
};

// m16n8k16 bf16. A: reg0 (g, 2t | 2t+1), reg1 (g+8, 2t | 2t+1),
// reg2 (g, 2t+8 | 2t+9), reg3 (g+8, 2t+8 | 2t+9); B: reg0 (k = 2t | 2t+1),
// reg1 (k = 2t+8 | 2t+9). Columns 4..7 of B are zero.
struct Bf16 {
  static constexpr int K = 16;
  static constexpr int NC = 4;
  static constexpr bool kSmallCols = false;
  __device__ __forceinline__ static int col(const int t, const int q) {
    return 2 * t + (q & 1) + 8 * (q >> 1);
  }
  __device__ __forceinline__ static void stage_b(uint32_t* sw, const int k, const float (&P)[4]) {
    const int step = k / K, kk = k % K;
    // body kk: register kk / 8 of lane t = (kk % 8) / 2, half kk % 2
    auto* h = reinterpret_cast<uint16_t*>(sw + step * 64 + ((kk & 7) >> 1) * 2 + (kk >> 3)) +
              (kk & 1);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      h[c * 16] = static_cast<uint16_t>(c < 4 ? bf16_bits(P[c & 3]) : 0u);
    }
  }
  __device__ __forceinline__ static void mma(float (&d)[4], const float (&s)[2][NC],
                                             const uint2 b) {
    const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[1][0], s[1][1]),
                           pack_bf16(s[0][2], s[0][3]), pack_bf16(s[1][2], s[1][3])};
    mma_bf16(d, a, b);
  }
};

// The products of one staged tile, [tb, tb + kMxuTileJ) of the stage, for
// the warp's kMxuTiles m16 tiles, each from a zero fragment into d;
// kRagged sets s to 0 at the columns at or past `valid` (stage-relative).
template <class Op, bool kRagged>
__device__ __forceinline__ void tile_product(const float (&px)[kMxuTiles][2],
                                             const float (&py)[kMxuTiles][2],
                                             const float (&pz)[kMxuTiles][2],
                                             const float4* spos, const uint2* sB, const int tb,
                                             const int valid, const int lane, const int t,
                                             const float eps2, float (&d)[kMxuTiles][4]) {
#pragma unroll
  for (int r = 0; r < kMxuTiles; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) d[r][c] = 0.f;
  }
#pragma unroll 4
  for (int k0 = tb; k0 < tb + kMxuTileJ; k0 += Op::K) {
    const uint2 b = sB[(k0 / Op::K) * 32 + lane];
    float4 pj[Op::NC];
#pragma unroll
    for (int q = 0; q < Op::NC; ++q) pj[q] = spos[k0 + Op::col(t, q)];
#pragma unroll
    for (int r = 0; r < kMxuTiles; ++r) {
      float s[2][Op::NC];
#pragma unroll
      for (int q = 0; q < Op::NC; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sv = pair_s(px[r][h], py[r][h], pz[r][h], pj[q], eps2);
          s[h][q] = (!kRagged || k0 + Op::col(t, q) < valid) ? sv : 0.f;
        }
      }
      Op::mma(d[r], s, b);
    }
  }
}

// The damped Euler update of row i from its four sums (sx, sy, sz) = sum s
// m p_j and sm = sum s m: a = s_xyz - p sm, v = (v + a dt) damping,
// p = p + v dt, pos.w and vel.w carried; shared by the one-chunk walk and
// the finish kernel, so a row's update is the same operations whichever
// applies it.
__device__ __forceinline__ void mxu_update(const float4 p, const float4 v, const float sx,
                                           const float sy, const float sz, const float sm,
                                           const float dt, const float damping,
                                           float4* __restrict__ new_pos,
                                           float4* __restrict__ new_vel, const int64_t i) {
  const float ax = __fsub_rn(sx, __fmul_rn(p.x, sm));
  const float ay = __fsub_rn(sy, __fmul_rn(p.y, sm));
  const float az = __fsub_rn(sz, __fmul_rn(p.z, sm));
  const float vx = __fmul_rn(__fadd_rn(v.x, __fmul_rn(ax, dt)), damping);
  const float vy = __fmul_rn(__fadd_rn(v.y, __fmul_rn(ay, dt)), damping);
  const float vz = __fmul_rn(__fadd_rn(v.z, __fmul_rn(az, dt)), damping);
  new_vel[i] = make_float4(vx, vy, vz, v.w);
  new_pos[i] = make_float4(__fadd_rn(p.x, __fmul_rn(vx, dt)), __fadd_rn(p.y, __fmul_rn(vy, dt)),
                           __fadd_rn(p.z, __fmul_rn(vz, dt)), p.w);
}

// The walk of one j-chunk (blockIdx.y: [blockIdx.y * chunk, min(... +
// chunk, n)), chunk a whole number of stages) for the block's kMxuRows
// rows. parts == nullptr (one chunk): the update; else the rows' four sums
// into the partials parts[(blockIdx.y * 4 + comp) * m + i].
template <class Op>
__global__ void __launch_bounds__(kMxuThreads)
    mxu_step_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                    const float4* __restrict__ pos_j, float4* __restrict__ new_pos,
                    float4* __restrict__ new_vel, const int64_t m, const int64_t n,
                    const int64_t chunk, const float dt, const float eps2, const float damping,
                    float* __restrict__ parts) {
  __shared__ float4 spos[kMxuStage];
  __shared__ uint2 sB[kMxuStage / Op::K * 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kMxuRows + (tid >> 5) * (16 * kMxuTiles);
  float px[kMxuTiles][2], py[kMxuTiles][2], pz[kMxuTiles][2];
  float acc[kMxuTiles][4];
#pragma unroll
  for (int r = 0; r < kMxuTiles; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t i = row0 + 16 * r + g + 8 * h;
      const float4 p = (i < m) ? pos_i[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      px[r][h] = p.x;
      py[r][h] = p.y;
      pz[r][h] = p.z;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t j1 = j0 + chunk < n ? j0 + chunk : n;
  for (int64_t base = j0; base < j1; base += kMxuStage) {
    for (int k = tid; k < kMxuStage; k += kMxuThreads) {
      const int64_t j = base + k;
      const float4 p = (j < n) ? pos_j[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      spos[k] = p;
      const float P[4] = {__fmul_rn(p.x, p.w), __fmul_rn(p.y, p.w), __fmul_rn(p.z, p.w), p.w};
      Op::stage_b(reinterpret_cast<uint32_t*>(sB), k, P);
    }
    __syncthreads();
    const int valid = static_cast<int>(n - base < kMxuStage ? n - base : kMxuStage);
    for (int tb = 0; tb < valid; tb += kMxuTileJ) {
      float d[kMxuTiles][4];
      if (valid - tb >= kMxuTileJ) {
        tile_product<Op, false>(px, py, pz, spos, sB, tb, valid, lane, t, eps2, d);
      } else {
        tile_product<Op, true>(px, py, pz, spos, sB, tb, valid, lane, t, eps2, d);
      }
#pragma unroll
      for (int r = 0; r < kMxuTiles; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __fadd_rn(acc[r][c], d[r][c]);
      }
    }
    __syncthreads();
  }

  // a row's sums [x m, y m, z m, m]: for TF32 column c's big part (lane
  // t = 0, 1) plus its small part (t = 2, 3, the xor-2 neighbour); then
  // lane t = 0 holds x, y and its xor-1 neighbour (t = 1) z, m, of rows g
  // (acc[r][0..1]) and g+8 (acc[r][2..3])
#pragma unroll
  for (int r = 0; r < kMxuTiles; ++r) {
    float v[4], o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = acc[r][c];
      if (Op::kSmallCols) v[c] = __fadd_rn(v[c], __shfl_xor_sync(kFull, v[c], 2));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = __shfl_xor_sync(kFull, v[c], 1);
    const int64_t i = row0 + 16 * r + g + 8 * t;
    if (t >= 2 || i >= m) continue;
    const float sx = (t == 0) ? v[0] : o[2];
    const float sy = (t == 0) ? v[1] : o[3];
    const float sz = (t == 0) ? o[0] : v[2];
    const float sm = (t == 0) ? o[1] : v[3];
    if (parts != nullptr) {
      float* out = parts + static_cast<int64_t>(blockIdx.y) * 4 * m + i;
      out[0] = sx;
      out[m] = sy;
      out[2 * m] = sz;
      out[3 * m] = sm;
    } else {
      mxu_update(pos_i[i], vel_i[i], sx, sy, sz, sm, dt, damping, new_pos, new_vel, i);
    }
  }
}

// The split step's update, one thread a row: the row's `splits` partial
// sums (splits, 4, m) added in chunk order from 0, then mxu_update
__global__ void __launch_bounds__(256)
    mxu_finish_kernel(const float* __restrict__ parts, const int64_t splits,
                      const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                      float4* __restrict__ new_pos, float4* __restrict__ new_vel, const int64_t m,
                      const float dt, const float damping) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t c = 0; c < splits; ++c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = __fadd_rn(s[k], parts[(c * 4 + k) * m + i]);
  }
  mxu_update(pos_i[i], vel_i[i], s[0], s[1], s[2], s[3], dt, damping, new_pos, new_vel, i);
}

template <class Op>
int launch(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
           void* new_vel, int64_t m, int64_t n, float dt, float eps2, float damping,
           int64_t splits, float* parts, void* stream) {
  if (m < 0 || n < 0 || splits < 1 || splits > 65535 || (splits > 1 && parts == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto pi = static_cast<const float4*>(pos_i);
  const auto vi = static_cast<const float4*>(vel_i);
  const auto np = static_cast<float4*>(new_pos);
  const auto nv = static_cast<float4*>(new_vel);
  // chunk c is [c * chunk, ...): ceil(ceil(n / stage) / splits) stages
  const int64_t chunk = cdiv(cdiv(n, kMxuStage), splits) * kMxuStage;
  const dim3 grid(static_cast<unsigned int>(cdiv(m, kMxuRows)), static_cast<unsigned int>(splits));
  mxu_step_kernel<Op><<<grid, kMxuThreads, 0, st>>>(pi, vi, static_cast<const float4*>(pos_j),
                                                    np, nv, m, n, chunk, dt, eps2, damping,
                                                    splits > 1 ? parts : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  mxu_finish_kernel<<<static_cast<unsigned int>(cdiv(m, 256)), 256, 0, st>>>(
      parts, splits, pi, vi, np, nv, m, dt, damping);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nbody_mxu_step_f32(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                       void* new_vel, int64_t m, int64_t n, float dt, float eps2,
                       float damping, void* stream) {
  return launch<Tf32x3>(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping, 1,
                        nullptr, stream);
}

int nbody_mxu_step_split_f32(const void* pos_i, const void* vel_i, const void* pos_j,
                             void* new_pos, void* new_vel, int64_t m, int64_t n, float dt,
                             float eps2, float damping, int64_t splits, void* parts,
                             void* stream) {
  if (parts == nullptr) return cudaErrorInvalidValue;
  return launch<Tf32x3>(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping, splits,
                        static_cast<float*>(parts), stream);
}

int nbody_mxu_step_bf16(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                        void* new_vel, int64_t m, int64_t n, float dt, float eps2,
                        float damping, void* stream) {
  return launch<Bf16>(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping, 1,
                      nullptr, stream);
}

int nbody_mxu_step_split_bf16(const void* pos_i, const void* vel_i, const void* pos_j,
                              void* new_pos, void* new_vel, int64_t m, int64_t n, float dt,
                              float eps2, float damping, int64_t splits, void* parts,
                              void* stream) {
  if (parts == nullptr) return cudaErrorInvalidValue;
  return launch<Bf16>(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping, splits,
                      static_cast<float*>(parts), stream);
}

}  // extern "C"
