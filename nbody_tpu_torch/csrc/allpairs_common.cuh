// The one-sided j-loop of the fp32 all-pairs kernels, shared by
// nbody_kernels.cu (step, force, rollout) and ring_kernels.cu (the fused
// ring's per-hop force): one thread per i-body, the j-bodies staged through
// shared memory in tiles of blockDim.x float4s. A kernel that runs this loop
// on the same j-bodies at the same block size adds the same terms in the
// same order, so its sums equal the force kernel's bit for bit.
// Everything is in an unnamed namespace, so each source that includes this
// header has its own copy and the objects link without clashes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// The j-side loader of an (N,4) array.
struct AosJ {
  const float4* __restrict__ p;
  __device__ __forceinline__ float4 operator()(const int64_t j) const { return p[j]; }
};

// a_i += sum_j m_j (p_j - p_i) / (|p_j - p_i|^2 + eps2)^(3/2) over j < n,
// in tiles of blockDim.x j-bodies staged in `tile` (blockDim.x float4s of
// shared memory). Every thread of the block must call it, those past the
// i-range too: they stage their share of each tile.
template <class JLoad>
__device__ __forceinline__ void accumulate_all_j(const float4 pi, const JLoad load_j,
                                                 const int64_t n, const float eps2,
                                                 float4* tile, float& ax, float& ay,
                                                 float& az) {
  const int bs = blockDim.x;
  for (int64_t base = 0; base < n; base += bs) {
    const int64_t j = base + threadIdx.x;
    tile[threadIdx.x] = (j < n) ? load_j(j) : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int k = 0; k < bs; ++k) {
      const float4 pj = tile[k];
      const float dx = pj.x - pi.x;
      const float dy = pj.y - pi.y;
      const float dz = pj.z - pi.z;
      const float r2 = dx * dx + dy * dy + dz * dz + eps2;
      const float inv = rsqrtf(r2);
      const float s = pj.w * (inv * inv * inv);
      ax += s * dx;
      ay += s * dy;
      az += s * dz;
    }
    __syncthreads();
  }
}

}  // namespace
