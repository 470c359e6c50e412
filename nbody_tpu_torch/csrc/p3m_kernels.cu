// The P3M short-range pair sum for Hopper (sm_90a), of nbody_tpu_torch.
//
// Replaces one Pallas TPU kernel of the JAX package:
//   nbody_p3m_sr_f32 <- nbody_tpu/ops/p3m_kernel.py::_sr_pair_kernel
//                       (def :250, pallas_call :352 in _short_range_pallas_impl,
//                       via p3m_short_range_pallas)
//   nbody_p3m_sr_range_f32 <- the same kernel over one device's range of the
//                       worklist on a mesh (chunk_lo / nchunk_local,
//                       p3m_kernel.py:313-317, 384-386, called from
//                       nbody_tpu/ops/p3m.py:528-545)
// It computes the short-range force of every kept body over the kept bodies
// of its 27 neighbour rcut-cells (the stencil of p3m._neighbor_stencil, dz
// fastest). For each pair, as p3m_kernel.py:272-287:
//   d = p_j - p_i;  r2 = |d|^2;  inv = rsqrtf(r2 + eps2);
//   s = (r2 < rcut2) ? (inv^3 - s_lr(r2)) * m_j : 0;  a_i += s * d
// with s_lr(r2) = poly(r2 / (2 sigma^2)) / (sqrt2 sigma)^3, the degree-10
// polynomial _SLR_POLY (p3m_kernel.py:65), evaluated by Horner's rule. The
// mask is a branch on r2 < rcut2, never a product with a 0/1 mask: between a
// real body and an inert row r2 overflows to inf, where s_lr is inf too.
//
// Every term is rounded as the plain version (ops/reference.py::
// p3m_short_range) rounds it: __fmul_rn / __fadd_rn, no FMA contraction,
// the same rsqrtf, and 1/(sqrt2 sigma)^3 as a multiplied constant. s =
// s_full - s_lr cancels near rcut (both ~1/rcut^3, s a few percent of it)
// and Horner's rule at y = 8 sums terms up to ~45 for f(8) = 0.044, so a
// term carries ~1e-5 of the sum of |terms| whichever way it is rounded;
// rounded alike, the terms are bit-equal and only the order of the sums
// differs. Contracted (scripts/torch_p3m_bench.py builds this source so and
// prints its error beside the kernel's) the kernel misses rtol 1e-4 / atol
// 2e-4 against the plain version. The r2 of the mask is rounded alike too:
// a pair at the cutoff still carries a force, and one ulp of r2 moves it
// across.
//
// Layout (ops/p3m.py::pair_tables). Which bodies a cell keeps is the
// reference's choice (stable (cell, massless last) order, the first
// `capacity`); the kept bodies of a cell are then ordered by the Morton code
// of their sub-cell on a 16^3 lattice inside the cell, so consecutive rows
// are close in space. A cell's rows are padded to whole clusters of CL = 32
// rows (one per lane of a warp), inert rows (1e30, 1e30, 1e30, 0) between;
// each cluster has the bounding box of its real rows (zero-mass bodies
// included, inert rows not). The j-clusters of an i-cluster are those of its
// 27 neighbour cells in stencil order, numbered 0 .. J-1; a work item is an
// i-cluster and a chunk [k0, k1) of that numbering, at most `chunk`
// j-clusters long, sized on the device so that the items number at most
// 4 * ceil(N / 32) + the cluster bound.
//
// Design. One warp computes one work item: lane l owns row l of the
// i-cluster. It tests 32 j-clusters at a time, one a lane, against the
// i-cluster's box (box distance^2 >= rcut2: skipped), then, for each
// j-cluster left, loads its 32 rows (one coalesced 16-byte load a lane),
// tests each row against the i-box the same way, stages the rows in shared
// memory and runs the pair code only for the rows left (a warp-uniform
// ballot mask). Warps take items from an atomic counter, so a collapsed
// cell's long j-range, cut into chunks, spreads over the card; the counter
// decides only which warp computes an item, never the order of a sum. Each
// item writes its float64 partial sums to its own slot; a second kernel adds
// an i-cluster's items in item order (a fixed order) and writes the float32
// force of each padded row. No atomics in any sum: the same state gives the
// same bits. Output rows of inert i-rows are written and ignored.
//
// Pruning is exact, with no margin: a skipped pair would have added +0.
// For p_i in [lo_i, hi_i] and p_j in [lo_j, hi_j] on an axis, the exact
// p_j - p_i is at least lo_j - hi_i; rounding to nearest is monotone, so
// |fl(p_j - p_i)| >= fl(lo_j - hi_i) (and >= fl(lo_i - hi_j) likewise), and
// fl of a product and of a sum of non-negative terms are monotone in each
// argument. So the box distance^2, computed from those rounded gaps with the
// same operations in the same order as the pair's r2 ((x^2 + y^2) + z^2,
// each rounded, no FMA), is at most the pair's rounded r2: box distance^2
// >= rcut2 implies r2 >= rcut2, the branch the plain version takes to 0.
// The row test is the same argument with lo_j = hi_j = p_j. Inert rows
// never enter a box; against a real box their gap squares to inf, so a
// padding j-row is never in a row mask.
//
// Sums. The plain version sums a row's terms as a tree (torch's sum); one
// float32 running sum over ~2e5 terms, the row of a dense cell at N=1M,
// missed rtol 1e-4 / atol 2e-4 by 6.7x (an H100 80GB HBM3 at 700 W). So a
// lane sums a j-cluster's terms in runs of SUM_RUN = 8 rows in float32, the
// 4 runs into the j-cluster's float32 sum (a chain of at most 8 + 4 = 12
// additions), and the j-clusters into a float64 sum; the items of an
// i-cluster add in float64, rounded to float32 once.
//
// What bounds it on an H100: arithmetic. A j-row that passes the row test
// costs each lane 9 FP32-pipe instructions to test its pair (3 FADD for d,
// 3 FMUL + 2 FADD for r2, the compare) and, where any lane of the warp is
// within rcut (the branch is taken by the warp), 28 for the term (the FADD
// of eps2, 2 FMUL for inv^3, 1 FMUL for y, 10 FMUL + 10 FADD of Horner,
// FMUL + FADD for inv^3 - g * inv_sq2s3, FMUL by m_j) and 3 FFMA for the
// sums, with one rsqrtf on the SFU and one shared-memory broadcast. The
// function's bound (chip_smoke.py, p3m.pair_work) counts the near pairs
// alone, with FMA: 7 + 19 instructions a pair within rcut. The box and row
// tests cost ~12 instructions a lane per 32 j-clusters and per j-cluster
// left; p3m.pair_work counts the row pairs the tests leave ("tested") and
// those whose warp takes the term ("termed"). The bytes are O(N) from
// device memory; the j-rows are re-read from L2 (the padded rows of a 2^20
// state are ~17 MB of its 50 MB).
//
// A rank's range (nbody_p3m_sr_range_f32; p3m.item_range): on a mesh every
// rank holds the tables of the whole state and computes the i-clusters
// [c0, c1) only, whose work items are [item_lo, item_hi). The counter
// starts at item_lo and the warps stop at item_hi; the totals kernel writes
// the rows of clusters [c0, c1) and zeros elsewhere. A cluster's items all
// lie in one range and are totalled in item order, so a range's rows are
// the whole launch's bit for bit. The range lives on the device (the cuts
// are computed there), so the launch needs no host synchronisation.
//
// blk (128, 256, 512; p3m.p3m_kernel_blk) sets the threads of a block, so
// blk / 32 warps, each with its own 32 rows of shared memory; the grid is
// as many blocks as the card holds at once (occupancy x SMs), at most one a
// blk / 32 items.
//
// Precision: fp32, rsqrtf the hardware approximation (at most 2 ulp), as in
// nbody_kernels.cu. Built with -O3 and without --use_fast_math; nvcc
// would contract a*b+c into FMAs; the terms and the tests use the _rn
// intrinsics, which it never contracts, and only the sums are FFMAs.

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

// rows a cluster: the lanes of a warp (p3m.CLUSTER)
constexpr int CL = 32;
// rows a float32 run of a j-cluster's sum (see the header)
constexpr int SUM_RUN = 8;
constexpr unsigned FULL = 0xffffffffu;

// |d|^2 rounded as the plain version rounds a pair's r2: (x^2 + y^2) + z^2
__device__ __forceinline__ float r2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The rounded gap between [alo, ahi] and [blo, bhi] on one axis: at most
// |fl(b - a)| for any a, b in them (see the header), 0 where they overlap.
__device__ __forceinline__ float gap(float alo, float ahi, float blo, float bhi) {
  return fmaxf(fmaxf(__fsub_rn(blo, ahi), __fsub_rn(alo, bhi)), 0.f);
}

// box distance^2 of the i-box (ilo, ihi) to [blo, bhi]
__device__ __forceinline__ float box_d2(float4 ilo, float4 ihi, float4 blo, float4 bhi) {
  return r2_rn(gap(ilo.x, ihi.x, blo.x, bhi.x), gap(ilo.y, ihi.y, blo.y, bhi.y),
               gap(ilo.z, ihi.z, blo.z, bhi.z));
}

// One pair's s for r2 < rcut2, every term rounded as the plain version
// rounds it: no FMA contraction (see the header).
__device__ __forceinline__ float pair_scalar(float r2, float mj, float eps2, float inv_2s2,
                                             float inv_sq2s3) {
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
  return __fmul_rn(__fsub_rn(s_full, __fmul_rn(g, inv_sq2s3)), mj);
}

// The terms of i-row pi against the rows of one j-cluster staged in sj that
// `rows` (a warp-uniform mask) leaves, added to (ax, ay, az) in the
// hierarchy of the header.
__device__ __forceinline__ void cluster_terms(const float4* sj, unsigned rows, float4 pi,
                                              float eps2, float rcut2, float inv_2s2,
                                              float inv_sq2s3, double& ax, double& ay,
                                              double& az) {
  float cx = 0.f, cy = 0.f, cz = 0.f;  // the j-cluster's sum
  for (int j0 = 0; j0 < CL; j0 += SUM_RUN) {
    const unsigned run = (rows >> j0) & ((1u << SUM_RUN) - 1u);
    if (run == 0u) continue;
    float rx = 0.f, ry = 0.f, rz = 0.f;  // a run of SUM_RUN rows
#pragma unroll
    for (int j = 0; j < SUM_RUN; ++j) {
      if (!((run >> j) & 1u)) continue;
      const float4 pj = sj[j0 + j];
      const float ddx = pj.x - pi.x;
      const float ddy = pj.y - pi.y;
      const float ddz = pj.z - pi.z;
      const float r2 = r2_rn(ddx, ddy, ddz);
      if (r2 < rcut2) {
        const float s = pair_scalar(r2, pj.w, eps2, inv_2s2, inv_sq2s3);
        rx += s * ddx;
        ry += s * ddy;
        rz += s * ddz;
      }
    }
    cx += rx;
    cy += ry;
    cz += rz;
  }
  ax += cx;
  ay += cy;
  az += cz;
}

// meta: eps^2, rcut^2, 1 / (2 sigma^2), 1 / (sqrt2 sigma)^3, on the device
// (computed there from the fitted box, so the launch needs no host sync).
// box: two float4 a cluster, (lo, 0) and (hi, 0). Item w: i-cluster it_cl[w]
// (-1 past the live items, which come first), j-clusters [it_k0, it_k1) of
// its stencil numbering; its partial sums go to partial[w] as (3, CL)
// doubles. `range` (4 ints on the device: item_lo, item_hi, c0, c1) or null
// for every item; next_item starts at item_lo.
template <int BLK>
__global__ void __launch_bounds__(BLK)
    p3m_sr_kernel(const float4* __restrict__ padded, const float4* __restrict__ box,
                  const int* __restrict__ cfirst, const int* __restrict__ ncl,
                  const int* __restrict__ cl_cell, const int* __restrict__ it_cl,
                  const int* __restrict__ it_k0, const int* __restrict__ it_k1,
                  const float* __restrict__ meta, const int* __restrict__ range,
                  double* __restrict__ partial, int* __restrict__ next_item, int items,
                  int gc) {
  static_assert(BLK % CL == 0, "whole warps");
  __shared__ float4 sj_all[BLK];
  const int lane = threadIdx.x & (CL - 1);
  float4* const sj = sj_all + (threadIdx.x - lane);  // this warp's 32 rows
  const float eps2 = meta[0];
  const float rcut2 = meta[1];
  const float inv_2s2 = meta[2];
  const float inv_sq2s3 = meta[3];
  const int item_hi = range != nullptr ? range[1] : items;

  for (;;) {
    int w = 0;
    if (lane == 0) w = atomicAdd(next_item, 1);
    w = __shfl_sync(FULL, w, 0);
    if (w >= item_hi) return;
    const int ic = it_cl[w];
    if (ic < 0) return;  // the live items are a prefix: none is left
    const int k0 = it_k0[w];
    const int k1 = it_k1[w];
    const int c = cl_cell[ic];
    const float4 pi = padded[static_cast<int64_t>(ic) * CL + lane];
    const float4 ilo = box[2 * static_cast<int64_t>(ic)];
    const float4 ihi = box[2 * static_cast<int64_t>(ic) + 1];
    const int cx = c / (gc * gc);
    const int cy = (c / gc) % gc;
    const int cz = c % gc;

    double ax = 0.0, ay = 0.0, az = 0.0;
    int k = 0;  // the stencil number of the neighbour cell's first j-cluster
    for (int s = 0; s < 27 && k < k1; ++s) {
      const int nx = cx + s / 9 - 1;
      const int ny = cy + (s / 3) % 3 - 1;
      const int nz = cz + s % 3 - 1;
      if (nx < 0 || nx >= gc || ny < 0 || ny >= gc || nz < 0 || nz >= gc) continue;
      const int nc = (nx * gc + ny) * gc + nz;
      const int nn = ncl[nc];
      const int u0 = max(k0 - k, 0);
      const int u1 = min(k1 - k, nn);
      const int nf = cfirst[nc];
      k += nn;
      for (int b = u0; b < u1; b += CL) {
        // 32 box tests at once, one j-cluster a lane
        bool keep = false;
        if (b + lane < u1) {
          const int64_t jc = nf + b + lane;
          keep = box_d2(ilo, ihi, box[2 * jc], box[2 * jc + 1]) < rcut2;
        }
        unsigned left = __ballot_sync(FULL, keep);
        while (left) {
          const int t = __ffs(left) - 1;
          left &= left - 1u;
          const int64_t jc = nf + b + t;
          const float4 pj = padded[jc * CL + lane];
          const unsigned rows = __ballot_sync(FULL, box_d2(ilo, ihi, pj, pj) < rcut2);
          if (rows == 0u) continue;
          sj[lane] = pj;
          __syncwarp();
          cluster_terms(sj, rows, pi, eps2, rcut2, inv_2s2, inv_sq2s3, ax, ay, az);
          __syncwarp();  // the rows are read before the next j-cluster overwrites them
        }
      }
    }
    double* out = partial + static_cast<int64_t>(w) * 3 * CL;
    out[lane] = ax;
    out[CL + lane] = ay;
    out[2 * CL + lane] = az;
  }
}

// acc_pad[r] = the float32 sum of cluster r / CL's items in item order; 0
// for a cluster outside `range`'s [c0, c1) (range null: every cluster).
__global__ void p3m_sr_total_kernel(const double* __restrict__ partial,
                                    const int* __restrict__ cl_item0,
                                    const int* __restrict__ cl_nitem,
                                    const int* __restrict__ range,
                                    float4* __restrict__ acc_pad, int64_t rows) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int64_t cl = r / CL;
  const int lane = static_cast<int>(r % CL);
  const int64_t t0 = cl_item0[cl];
  const bool mine = range == nullptr || (cl >= range[2] && cl < range[3]);
  const int nt = mine ? cl_nitem[cl] : 0;
  double x = 0.0, y = 0.0, z = 0.0;
  for (int t = 0; t < nt; ++t) {
    const double* p = partial + (t0 + t) * 3 * CL;
    x += p[lane];
    y += p[CL + lane];
    z += p[2 * CL + lane];
  }
  acc_pad[r] = make_float4(static_cast<float>(x), static_cast<float>(y),
                           static_cast<float>(z), 0.f);
}

struct Args {
  const float4* padded;
  const float4* box;
  const int* cfirst;
  const int* ncl;
  const int* cl_cell;
  const int* it_cl;
  const int* it_k0;
  const int* it_k1;
  const int* cl_item0;
  const int* cl_nitem;
  const float* meta;
  const int* range;
  double* partial;
  int* next_item;
  float4* acc_pad;
};

template <int BLK>
cudaError_t launch(const Args& a, int64_t items, int64_t rows, int gc, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p3m_sr_kernel<BLK>, BLK, 0);
  if (err != cudaSuccess) return err;
  constexpr int warps = BLK / CL;
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int64_t want = (items + warps - 1) / warps;
  const int64_t grid = want < resident ? want : resident;
  if (grid > 0) {
    p3m_sr_kernel<BLK><<<static_cast<unsigned int>(grid), BLK, 0, s>>>(
        a.padded, a.box, a.cfirst, a.ncl, a.cl_cell, a.it_cl, a.it_k0, a.it_k1, a.meta,
        a.range, a.partial, a.next_item, static_cast<int>(items), gc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int TOTAL_THREADS = 256;
  p3m_sr_total_kernel<<<static_cast<unsigned int>((rows + TOTAL_THREADS - 1) / TOTAL_THREADS),
                        TOTAL_THREADS, 0, s>>>(a.partial, a.cl_item0, a.cl_nitem, a.range,
                                               a.acc_pad, rows);
  return cudaGetLastError();
}

int run(const void* padded, const void* box, const void* cfirst, const void* ncl,
        const void* cl_cell, const void* it_cl, const void* it_k0, const void* it_k1,
        const void* cl_item0, const void* cl_nitem, const void* meta, const void* range,
        void* partial, void* next_item, void* acc_pad, int64_t items, int64_t rows, int64_t gc,
        int64_t blk, void* stream) {
  if (items < 0 || items > 0x7fffffff || rows < 0 || rows % CL || gc < 1)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Args a{static_cast<const float4*>(padded), static_cast<const float4*>(box),
               static_cast<const int*>(cfirst),    static_cast<const int*>(ncl),
               static_cast<const int*>(cl_cell),   static_cast<const int*>(it_cl),
               static_cast<const int*>(it_k0),     static_cast<const int*>(it_k1),
               static_cast<const int*>(cl_item0),  static_cast<const int*>(cl_nitem),
               static_cast<const float*>(meta),    static_cast<const int*>(range),
               static_cast<double*>(partial),      static_cast<int*>(next_item),
               static_cast<float4*>(acc_pad)};
  const auto s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(gc);
  switch (blk) {
    case 128: return launch<128>(a, items, rows, g, s);
    case 256: return launch<256>(a, items, rows, g, s);
    case 512: return launch<512>(a, items, rows, g, s);
    default: return cudaErrorInvalidValue;
  }
}
}  // namespace

extern "C" {
// acc_pad (rows, 4) of the padded layout padded (rows, 4), rows = CL x the
// clusters of the tables; box (rows / CL, 8); cfirst / ncl the (gc^3,) first
// cluster and cluster count of each cell; cl_cell, cl_item0, cl_nitem
// (rows / CL,); it_cl / it_k0 / it_k1 (items,); meta the (4,) float scalars
// above; partial (items, 3, 32) float64 scratch; next_item one int, zero on
// entry. Two launches on `stream`: the pair kernel (blk threads a block,
// blk in {128, 256, 512}) and the per-row totals.
int nbody_p3m_sr_f32(const void* padded, const void* box, const void* cfirst, const void* ncl,
                     const void* cl_cell, const void* it_cl, const void* it_k0,
                     const void* it_k1, const void* cl_item0, const void* cl_nitem,
                     const void* meta, void* partial, void* next_item, void* acc_pad,
                     int64_t items, int64_t rows, int64_t gc, int64_t blk, void* stream) {
  return run(padded, box, cfirst, ncl, cl_cell, it_cl, it_k0, it_k1, cl_item0, cl_nitem, meta,
             nullptr, partial, next_item, acc_pad, items, rows, gc, blk, stream);
}

// The same over a rank's range: `range` the (4,) device ints item_lo,
// item_hi, c0, c1, and next_item equal to item_lo on entry; the rows of
// clusters outside [c0, c1) are written 0.
int nbody_p3m_sr_range_f32(const void* padded, const void* box, const void* cfirst,
                           const void* ncl, const void* cl_cell, const void* it_cl,
                           const void* it_k0, const void* it_k1, const void* cl_item0,
                           const void* cl_nitem, const void* meta, const void* range,
                           void* partial, void* next_item, void* acc_pad, int64_t items,
                           int64_t rows, int64_t gc, int64_t blk, void* stream) {
  return run(padded, box, cfirst, ncl, cl_cell, it_cl, it_k0, it_k1, cl_item0, cl_nitem, meta,
             range, partial, next_item, acc_pad, items, rows, gc, blk, stream);
}
}  // extern "C"
