// The fused Euler step with the force reduction on the tensor cores, for
// Hopper (sm_90a): the "mxu" and "mxu_bf16" variants of nbody_tpu_torch.
//
// Replaces one Pallas TPU kernel of the JAX package, in its two dtypes:
//   nbody_mxu_step_f32  <- nbody_tpu/ops/pallas_kernel.py::_mxu_step_kernel
//   nbody_mxu_step_bf16    (def :171, pallas_call :421; nbody_step_pallas_vs
//                           with variant="mxu" / "mxu_bf16")
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
// f32 product with several bf16 passes, becomes the 3xTF32 split here,
// x = big + small with big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big),
// and three products small*big + big*small + big*big (small*small, ~2^-22
// relative, is dropped). One TF32 pass would keep ~3 decimal digits, which
// is not f32 grade. "mxu_bf16" rounds s and P to bf16 (cvt.rn.bf16x2.f32,
// round to nearest even, as the JAX astype does) and sums in f32: the JAX
// semantics exactly.
//
// Design. One templated kernel body; only the fragment conversion and the
// mma instruction differ between the two instantiations (Tf32x3: m16n8k8
// TF32, three mmas; Bf16: m16n8k16 bf16, one mma), so the f32-grade one,
// held tightly to its plain version, vouches for the index maps that both
// share. A block of 4 warps owns 64 i-rows, a warp one m16 tile of 16 rows.
// The block stages j-bodies through shared memory in tiles of 128: their
// positions as float4, and P as four floats a body. A warp walks a tile in
// chunks of the mma depth K (8 or 16 j-bodies):
//   A (16 x K, s):  each thread computes the s values of its own A-fragment
//                   elements (rows g and g+8, lane g = lane/4, and the
//                   columns its lane t = lane%4 holds), 4 (TF32) or 8 (bf16)
//                   pairs a chunk, so no s is computed twice, with
//                   rsqrtf and __fmul_rn / __fadd_rn / __fsub_rn: the plain
//                   version's operations in its order, never contracted.
//   B (K x 8, P):   columns 0..3 are P's four components, 4..7 zero (n = 8
//                   is the smallest mma width; half of it is unused).
//   C (16 x 8):     the f32 sums. Each tile's product starts from a zero
//                   fragment and is added to the running sums with one
//                   round-to-nearest add: the tensor core's own accumulation
//                   then spans 16 (TF32) or 8 (bf16) mma steps, and the
//                   N/128 tile sums round as the plain version's do.
// Fragment layouts are those of the PTX ISA's mma section (and of CuTe's
// SM80_16x8x8_F32TF32TF32F32_TN / SM80_16x8x16_F32BF16BF16F32_TN); Op::col
// below is the column (A) and row (B) map. The finalize takes a row's four
// sums from the two lanes that hold them (t = 0: columns 0, 1; t = 1:
// columns 2, 3) with one xor-shuffle; lane t = 0 updates row g and t = 1
// row g+8.
//
// Edges: any M and N. s is set to 0 for a j-slot past N (a select, not a
// zero mass: inf or NaN times a zero B would give NaN in the mma); rows past
// M are computed from a zero position and not stored.
//
// What bounds it on an H100: computing s. The tensor-core work is small:
// 16 flops a (padded) pair and pass, 0.07 ms at N=65536 at the bf16 rate,
// three TF32 passes 0.42 ms. Per pair the FP32 pipe issues the
// difference, distance and cube (3 FADD, 3 FMUL + 3 FADD, 2 FMUL), the
// ragged-edge select and, for TF32, the split of the thread's A values (cvt,
// FADD, cvt); the B split or pack is shared by the 16 rows of the warp; one
// rsqrtf a pair goes to the SFU, 16 a clock an SM: 1.03 ms at N=65536 on 132
// SMs at 1.98 GHz, the same as the one-sided step's. The count chip_smoke.py
// uses (MXU_PAIR_INSTR) is read from this source. The tensor cores take only
// the reduction, which was 3 of the one-sided kernel's ~12 FMA-pipe
// instructions a pair, so on Hopper this variant cannot be much faster than
// the one-sided step, and the no-contraction rule and the TF32 split make
// the f32 one slower. wgmma, TMA and several i-tiles a warp are later work.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float32 (M,4) / (N,4) arrays, 16-byte aligned. The kernel runs
// on the given stream of the current device, allocates nothing and does not
// synchronise. Each entry point returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;  // one m16 tile
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileJ = 128;  // j-bodies staged a shared-memory tile

__device__ __forceinline__ float pair_s(const float4 pi, const float4 pj, const float eps2) {
  const float dx = __fsub_rn(pj.x, pi.x);
  const float dy = __fsub_rn(pj.y, pi.y);
  const float dz = __fsub_rn(pj.z, pi.z);
  const float r2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), eps2);
  const float inv = rsqrtf(r2);
  return __fmul_rn(__fmul_rn(inv, inv), inv);
}

__device__ __forceinline__ uint32_t to_tf32(const float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(const float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

// bf16x2 of (lo, hi): lo in the lower half, the element of the lower index
__device__ __forceinline__ uint32_t pack_bf16(const float lo, const float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s[h][q] is A at row g + 8h and column col(t, q); b[q] is B at row col(t, q)
// and column g (P's component g, 0 for g >= 4). The C fragment d is
// d[0] = (g, 2t), d[1] = (g, 2t+1), d[2] = (g+8, 2t), d[3] = (g+8, 2t+1).

// m16n8k8 TF32, 3xTF32. A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// B: b0 (k = t), b1 (k = t+4).
struct Tf32x3 {
  static constexpr int K = 8;
  static constexpr int NC = 2;
  __device__ __forceinline__ static int col(const int t, const int q) { return t + 4 * q; }
  __device__ __forceinline__ static void mma(float (&d)[4], const float (&s)[2][NC],
                                             const float (&b)[NC]) {
    uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
    split_tf32(s[0][0], a_big[0], a_small[0]);
    split_tf32(s[1][0], a_big[1], a_small[1]);
    split_tf32(s[0][1], a_big[2], a_small[2]);
    split_tf32(s[1][1], a_big[3], a_small[3]);
    split_tf32(b[0], b_big[0], b_small[0]);
    split_tf32(b[1], b_big[1], b_small[1]);
    mma_tf32(d, a_small, b_big);
    mma_tf32(d, a_big, b_small);
    mma_tf32(d, a_big, b_big);
  }
};

// m16n8k16 bf16. A: reg0 (g, 2t | 2t+1), reg1 (g+8, 2t | 2t+1),
// reg2 (g, 2t+8 | 2t+9), reg3 (g+8, 2t+8 | 2t+9); B: reg0 (k = 2t | 2t+1),
// reg1 (k = 2t+8 | 2t+9).
struct Bf16 {
  static constexpr int K = 16;
  static constexpr int NC = 4;
  __device__ __forceinline__ static int col(const int t, const int q) {
    return 2 * t + (q & 1) + 8 * (q >> 1);
  }
  __device__ __forceinline__ static void mma(float (&d)[4], const float (&s)[2][NC],
                                             const float (&b)[NC]) {
    const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[1][0], s[1][1]),
                           pack_bf16(s[0][2], s[0][3]), pack_bf16(s[1][2], s[1][3])};
    const uint32_t bb[2] = {pack_bf16(b[0], b[1]), pack_bf16(b[2], b[3])};
    mma_bf16(d, a, bb);
  }
};

// The product of one staged tile for this warp's 16 rows, from a zero
// fragment; kRagged masks the columns at or past `valid`.
template <class Op, bool kRagged>
__device__ __forceinline__ void tile_product(const float4 (&pi)[2], const float4* tpos,
                                             const float* tP, const int valid, const int g,
                                             const int t, const float eps2, float (&d)[4]) {
#pragma unroll 4
  for (int k0 = 0; k0 < kTileJ; k0 += Op::K) {
    float s[2][Op::NC], b[Op::NC];
#pragma unroll
    for (int q = 0; q < Op::NC; ++q) {
      const int k = k0 + Op::col(t, q);
      const float4 pj = tpos[k];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sv = pair_s(pi[h], pj, eps2);
        s[h][q] = (!kRagged || k < valid) ? sv : 0.f;
      }
      const float pk = tP[4 * k + (g & 3)];  // in bounds for every lane
      b[q] = (g < 4) ? pk : 0.f;
    }
    Op::mma(d, s, b);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
    mxu_step_kernel(const float4* __restrict__ pos_i, const float4* __restrict__ vel_i,
                    const float4* __restrict__ pos_j, float4* __restrict__ new_pos,
                    float4* __restrict__ new_vel, const int64_t m, const int64_t n,
                    const float dt, const float eps2, const float damping) {
  __shared__ float4 tpos[kTileJ];
  __shared__ float tP[4 * kTileJ];  // [x m, y m, z m, m] of each staged body
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5) * kRowsPerWarp;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t i = row0 + g + 8 * h;
    pi[h] = (i < m) ? pos_i[i] : zero;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t base = 0; base < n; base += kTileJ) {
    for (int k = threadIdx.x; k < kTileJ; k += kThreads) {
      const int64_t j = base + k;
      const float4 p = (j < n) ? pos_j[j] : zero;
      tpos[k] = p;
      tP[4 * k + 0] = __fmul_rn(p.x, p.w);
      tP[4 * k + 1] = __fmul_rn(p.y, p.w);
      tP[4 * k + 2] = __fmul_rn(p.z, p.w);
      tP[4 * k + 3] = p.w;
    }
    __syncthreads();
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    const int64_t left = n - base;
    if (left >= kTileJ) {
      tile_product<Op, false>(pi, tpos, tP, kTileJ, g, t, eps2, d);
    } else {
      tile_product<Op, true>(pi, tpos, tP, static_cast<int>(left), g, t, eps2, d);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], d[c]);
    __syncthreads();
  }

  // a row's sums [x m, y m, z m, m]: lane t = 0 holds columns 0, 1 and its
  // xor-1 neighbour (t = 1) columns 2, 3, of rows g (acc[0..1]) and g+8
  // (acc[2..3])
  float o[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c] = __shfl_xor_sync(0xffffffffu, acc[c], 1);
  if (t >= 2) return;  // columns 4..7: zero
  const int64_t i = row0 + g + 8 * t;
  if (i >= m) return;
  const float sx = (t == 0) ? acc[0] : o[2];
  const float sy = (t == 0) ? acc[1] : o[3];
  const float sz = (t == 0) ? o[0] : acc[2];
  const float sm = (t == 0) ? o[1] : acc[3];
  const float4 p = (t == 0) ? pi[0] : pi[1];
  const float4 v = vel_i[i];
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

template <class Op>
int launch(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
           void* new_vel, int64_t m, int64_t n, float dt, float eps2, float damping,
           void* stream) {
  if (m < 0 || n < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const unsigned int blocks = static_cast<unsigned int>((m + kRowsPerBlock - 1) / kRowsPerBlock);
  mxu_step_kernel<Op><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_i), static_cast<const float4*>(vel_i),
      static_cast<const float4*>(pos_j), static_cast<float4*>(new_pos),
      static_cast<float4*>(new_vel), m, n, dt, eps2, damping);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nbody_mxu_step_f32(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                       void* new_vel, int64_t m, int64_t n, float dt, float eps2,
                       float damping, void* stream) {
  return launch<Tf32x3>(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping,
                        stream);
}

int nbody_mxu_step_bf16(const void* pos_i, const void* vel_i, const void* pos_j, void* new_pos,
                        void* new_vel, int64_t m, int64_t n, float dt, float eps2,
                        float damping, void* stream) {
  return launch<Bf16>(pos_i, vel_i, pos_j, new_pos, new_vel, m, n, dt, eps2, damping, stream);
}

}  // extern "C"
