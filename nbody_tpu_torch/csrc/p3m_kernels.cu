// The P3M short-range pair sum for Hopper (sm_90a), of nbody_tpu_torch.
//
// Replaces one Pallas TPU kernel of the JAX package:
//   nbody_p3m_sr_f32 <- nbody_tpu/ops/p3m_kernel.py::_sr_pair_kernel
//                       (def :250, pallas_call :352 in _short_range_pallas_impl,
//                       via p3m_short_range_pallas)
// It computes the short-range force of every kept body over the kept bodies
// of its 27 neighbour cells, on the cell-aligned padded layout that
// ops/p3m.py::pair_tables builds (the reference's _build_pair_tables): each
// cell's kept bodies start at a block boundary, blocks of BLK rows, inert
// rows (1e30, 1e30, 1e30, 0) in between. For each pair, as
// p3m_kernel.py:272-287:
//   d = p_j - p_i;  r2 = |d|^2;  inv = rsqrtf(r2 + eps2);
//   s = (r2 < rcut2) ? (inv^3 - s_lr(r2)) * m_j : 0;  a_i += s * d
// with s_lr(r2) = poly(r2 / (2 sigma^2)) / (sqrt2 sigma)^3, the degree-10
// polynomial _SLR_POLY (p3m_kernel.py:65), evaluated by Horner's rule. The
// mask is a select, never a product with a 0/1 mask: between a real body
// and an inert row r2 overflows to inf, s_lr(inf) is inf, and 0 * inf
// would be NaN. Two inert rows meet at r2 = 0 and add 0 through m_j = 0.
//
// Every term is rounded as the plain version (ops/reference.py::
// p3m_short_range) rounds it: __fmul_rn / __fadd_rn, no FMA contraction,
// the same rsqrtf, and 1/(sqrt2 sigma)^3 as a multiplied constant. Two
// float32 evaluations of one term differ far more than float32 rounding
// suggests: s = s_full - s_lr cancels (at r = rcut both are ~1/rcut^3 and
// s a few percent of it), and Horner's rule at y = 8 sums terms up to ~45
// for f(8) = 0.044, so a term carries ~1e-5 of the sum of |terms| whichever
// way it is rounded. Rounded alike, the terms are bit-equal and only the
// order of the sums differs; contracted (scripts/torch_p3m_bench.py builds
// this source so and prints its error beside the kernel's), the terms
// differ from the plain version's by about that much, and the kernel
// misses rtol 1e-4 / atol 2e-4 against it. The r2 of the mask is rounded
// alike too: a pair at the cutoff still carries a force, and one ulp of r2
// moves it across.
//
// Sums. The plain version sums a row's terms as a tree (torch's sum); a
// long sequential float32 sum is far less exact, and a row of a dense cell
// at N=1M sums ~2e5 terms whose |terms| add to ~1e4 for a force component
// near 1. One running sum per j-block missed rtol 1e-4 / atol 2e-4 there
// (6.7x the bound on the first timed state of chip_smoke.py's N=1M run, on
// an H100 80GB HBM3 at 700 W). So a thread sums its terms in a fixed
// hierarchy: runs of SUM_RUN = 8 terms, SUM_RUN runs to a group, the groups
// of a j-block in order, all in float32 (a chain of at most 8 + 8 + 8
// additions, as deep as a tree over 2^24 terms), and the j-block sums into
// a float64 total, one DADD a j-block. That costs a few registers, no time
// in the pair loop, and keeps the same bits for the same state.
//
// Design. The TPU kernel walks a flat, scalar-prefetched list of
// (i-block, j-block) tile pairs, because a Pallas grid needs static block
// indices; the list has a static length, so it needs a pair budget and
// drops pairs beyond it. Here a thread block takes one (cell, i-subtile)
// entry of a list whose static bound is ncell + ceil(N / BLK)
// (p3m_kernel.py:202), and loops over the 27 neighbour cells in the
// stencil's order (dz fastest) and over each neighbour's j-blocks itself,
// so no budget exists and nothing is dropped. One thread owns one i-row
// and sums its force in registers; each j-block (BLK x 16 bytes) is staged
// in shared memory with one coalesced 16-byte load a thread and read as a
// broadcast. Entries past the live count (e_cell < 0) exit at once. No
// atomics: every i-row is written by one thread, in a fixed order, so the
// same state gives the same bits. Output rows of inert i-rows are written
// too and ignored by the caller.
//
// What bounds it on an H100: arithmetic. A pair (i, j) of padded rows is
// 40 FP32-pipe instructions in this source: 9 to test it (3 FADD for d,
// 3 FMUL + 2 FADD for r2, the compare) and, within rcut, 28 for the term
// (the FADD of eps2, 2 FMUL for inv^3, 1 FMUL for y, 10 FMUL + 10 FADD of
// Horner, FMUL + FADD for inv^3 - g * inv_sq2s3, FMUL by m_j) and 3 FFMA
// for the sums, with one rsqrtf on the SFU; the j-body is one
// shared-memory broadcast. nvcc compiles the select into a branch (one
// BSSY / BSYNC a pair in the SASS), so a warp whose 32 pairs all lie past
// rcut skips the term: the kernel visits tiles x BLK^2 row pairs (tiles =
// sum over cells of i-blocks x the neighbours' j-blocks, the reference's
// p3m_pair_count, padding rows included) and computes the term for those
// within rcut. Its bound (chip_smoke.py, p3m.pair_work) counts what the
// function needs, with FMA: 7 instructions a candidate pair of kept bodies
// in neighbouring cells (3 FADD, FMUL + 2 FFMA for r2, the compare) and 19
// more a pair within rcut (Horner's rule 10 FFMA); the unfused rounding
// above costs 2 + 12 more, reported beside the bound. The bytes are O(N). Load
// balance across skewed cells, several i-rows a thread, wgmma and TMA are
// later work.
//
// Precision: fp32, rsqrtf the hardware approximation (at most 2 ulp), as in
// nbody_kernels.cu. Built with -O3 and without --use_fast_math; nvcc
// would contract a*b+c into FMAs; the terms use the _rn intrinsics, which
// it never contracts, and only the sums are FFMAs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// _SLR_POLY, lowest order first (nbody_tpu/ops/p3m_kernel.py:65)
constexpr float SLR0 = 0.7522514718300537f;
constexpr float SLR1 = -0.4513297496782609f;
constexpr float SLR2 = 0.1611063215380149f;
constexpr float SLR3 = -0.04162870626770713f;
constexpr float SLR4 = 0.008389008230325833f;
constexpr float SLR5 = -0.0013517520799301759f;
constexpr float SLR6 = 0.0001720653915474035f;
constexpr float SLR7 = -1.6553017193590822e-05f;
constexpr float SLR8 = 1.1152261980593794e-06f;
constexpr float SLR9 = -4.625102305643162e-08f;
constexpr float SLR10 = 8.792217886009483e-10f;

// Terms a thread sums in a row before it adds them to its group's sum, and
// runs to a group (see the header).
constexpr int SUM_RUN = 8;

// One pair's s, its force s * d, every term rounded as the plain version
// rounds it: no FMA contraction (see the header).
__device__ __forceinline__ float pair_scalar(float ddx, float ddy, float ddz, float mj,
                                             float eps2, float rcut2, float inv_2s2,
                                             float inv_sq2s3) {
  const float r2 =
      __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)), __fmul_rn(ddz, ddz));
  const float inv = rsqrtf(__fadd_rn(r2, eps2));
  const float s_full = __fmul_rn(__fmul_rn(inv, inv), inv);
  const float y = __fmul_rn(r2, inv_2s2);
  float g = SLR10;
  g = __fadd_rn(__fmul_rn(g, y), SLR9);
  g = __fadd_rn(__fmul_rn(g, y), SLR8);
  g = __fadd_rn(__fmul_rn(g, y), SLR7);
  g = __fadd_rn(__fmul_rn(g, y), SLR6);
  g = __fadd_rn(__fmul_rn(g, y), SLR5);
  g = __fadd_rn(__fmul_rn(g, y), SLR4);
  g = __fadd_rn(__fmul_rn(g, y), SLR3);
  g = __fadd_rn(__fmul_rn(g, y), SLR2);
  g = __fadd_rn(__fmul_rn(g, y), SLR1);
  g = __fadd_rn(__fmul_rn(g, y), SLR0);
  return (r2 < rcut2) ? __fmul_rn(__fsub_rn(s_full, __fmul_rn(g, inv_sq2s3)), mj) : 0.f;
}

// meta: eps^2, rcut^2, 1 / (2 sigma^2), 1 / (sqrt2 sigma)^3, on the device
// (computed there from the fitted box, so the launch needs no host sync).
template <int BLK>
__global__ void __launch_bounds__(BLK)
    p3m_sr_kernel(const float4* __restrict__ padded, float4* __restrict__ acc_pad,
                  const int* __restrict__ ablk, const int* __restrict__ tpc,
                  const int* __restrict__ e_cell, const int* __restrict__ e_t,
                  const float* __restrict__ meta, int gc) {
  static_assert(BLK % (SUM_RUN * SUM_RUN) == 0, "a j-block holds whole groups");
  __shared__ float4 sj[BLK];
  const int c = e_cell[blockIdx.x];
  if (c < 0) return;  // the whole block: no barrier is left waiting
  const float eps2 = meta[0];
  const float rcut2 = meta[1];
  const float inv_2s2 = meta[2];
  const float inv_sq2s3 = meta[3];
  const int64_t row = (static_cast<int64_t>(ablk[c]) + e_t[blockIdx.x]) * BLK + threadIdx.x;
  const float4 pi = padded[row];
  const int cx = c / (gc * gc);
  const int cy = (c / gc) % gc;
  const int cz = c % gc;

  double ax = 0.0, ay = 0.0, az = 0.0;  // the sum over the j-blocks done
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = cx + dx;
    if (nx < 0 || nx >= gc) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= gc) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        const int nz = cz + dz;
        if (nz < 0 || nz >= gc) continue;
        // uniform across the block (it depends on c only), so the barriers
        // below are reached by every thread
        const int nc = (nx * gc + ny) * gc + nz;
        const int nb = tpc[nc];
        const int64_t base = static_cast<int64_t>(ablk[nc]) * BLK;
        for (int u = 0; u < nb; ++u) {
          sj[threadIdx.x] = padded[base + static_cast<int64_t>(u) * BLK + threadIdx.x];
          __syncthreads();
          // this j-block's sum, in a fixed hierarchy (see the header)
          float bx = 0.f, by = 0.f, bz = 0.f;
          for (int j0 = 0; j0 < BLK; j0 += SUM_RUN * SUM_RUN) {
            float gx = 0.f, gy = 0.f, gz = 0.f;  // a group of SUM_RUN runs
            for (int j1 = j0; j1 < j0 + SUM_RUN * SUM_RUN; j1 += SUM_RUN) {
              float rx = 0.f, ry = 0.f, rz = 0.f;  // a run of SUM_RUN terms
#pragma unroll
              for (int j = j1; j < j1 + SUM_RUN; ++j) {
                const float4 pj = sj[j];
                const float ddx = pj.x - pi.x;
                const float ddy = pj.y - pi.y;
                const float ddz = pj.z - pi.z;
                const float s = pair_scalar(ddx, ddy, ddz, pj.w, eps2, rcut2, inv_2s2, inv_sq2s3);
                rx += s * ddx;
                ry += s * ddy;
                rz += s * ddz;
              }
              gx += rx;
              gy += ry;
              gz += rz;
            }
            bx += gx;
            by += gy;
            bz += gz;
          }
          ax += bx;
          ay += by;
          az += bz;
          __syncthreads();
        }
      }
    }
  }
  acc_pad[row] = make_float4(static_cast<float>(ax), static_cast<float>(ay),
                             static_cast<float>(az), 0.f);
}

template <int BLK>
cudaError_t launch(const float4* padded, float4* acc_pad, const int* ablk, const int* tpc,
                   const int* e_cell, const int* e_t, const float* meta, int64_t entries,
                   int gc, cudaStream_t s) {
  p3m_sr_kernel<BLK><<<static_cast<unsigned int>(entries), BLK, 0, s>>>(
      padded, acc_pad, ablk, tpc, e_cell, e_t, meta, gc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// acc_pad (rows, 4) of the padded layout padded (rows, 4): one thread block
// per entry of e_cell / e_t (entries of them), blk threads, blk in
// {128, 256, 512}; ablk / tpc are the (gc^3,) first block and block count
// of each cell, meta the (4,) float scalars above. Rows that no live entry
// covers are left as they were.
int nbody_p3m_sr_f32(const void* padded, void* acc_pad, const void* ablk, const void* tpc,
                     const void* e_cell, const void* e_t, const void* meta, int64_t entries,
                     int64_t gc, int64_t blk, void* stream) {
  if (entries < 0 || gc < 1 || entries > 0x7fffffff) return cudaErrorInvalidValue;
  if (entries == 0) return cudaSuccess;
  const auto p = static_cast<const float4*>(padded);
  auto out = static_cast<float4*>(acc_pad);
  const auto a = static_cast<const int*>(ablk);
  const auto t = static_cast<const int*>(tpc);
  const auto ec = static_cast<const int*>(e_cell);
  const auto et = static_cast<const int*>(e_t);
  const auto m = static_cast<const float*>(meta);
  const auto s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(gc);
  switch (blk) {
    case 128: return launch<128>(p, out, a, t, ec, et, m, entries, g, s);
    case 256: return launch<256>(p, out, a, t, ec, et, m, entries, g, s);
    case 512: return launch<512>(p, out, a, t, ec, et, m, entries, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
