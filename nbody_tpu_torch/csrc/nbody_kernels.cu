// All-pairs Plummer gravity for Hopper (sm_90a): the fused Euler step and
// the force-only kernel of nbody_tpu_torch.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   nbody_step_f32  <- nbody_tpu/ops/pallas_kernel.py::_step_kernel
//                      (nbody_step_pallas_vs / nbody_step_pallas)
//   nbody_accel_f32 <- nbody_tpu/ops/pallas_kernel.py::_accel_kernel
//                      (compute_accel_pallas)
// Both compute, for the i-set (M bodies) under the j-set (N bodies),
//   d = p_j - p_i;  r2 = |d|^2 + eps2;  inv = rsqrtf(r2);  s = m_j * inv^3;
//   a_i += s * d
// exactly as pallas_kernel.py:79-87. The self pair adds 0 only because d = 0,
// so softening = 0 gives NaN for it, as in the JAX package and the reference.
// The step kernel then applies v = (v + a*dt)*damping, p = p + v*dt and
// copies pos.w (mass) and vel.w through (pallas_kernel.py:106-122).
//
// Design: the reference CUDA sample's own, not the Pallas grid. One thread
// per i-body keeps its position and its three accumulators in registers;
// each block of block_size threads stages the j-bodies through shared memory
// as float4 tiles of block_size bodies, one coalesced 16-byte load per
// thread, and every thread of the block reads each staged body as a
// shared-memory broadcast. The Pallas kernel's (TILE_I, 128) lane
// accumulators, their lane reduction and its VMEM scratch have no
// counterpart: a thread owns a whole row of the pair matrix.
//
// What bounds it on an H100: arithmetic. A pair is ~20 flops by the
// reference's count, about 12 fp32 FMA-pipe instructions plus one rsqrtf on
// the SFU (MUFU), which issues at an eighth of the FMA rate. Memory is no
// limit: a block reads 16 bytes per j-body from L2 for block_size pairs
// per thread, and a shared-memory broadcast per pair. The design keeps all
// per-pair state in registers so the FMA and SFU pipes are all it waits
// on. Several i-bodies per thread, unrolling and a tensor-core reduction
// are later work.
//
// Precision: fp32 only. rsqrtf is the hardware approximation (at most
// 2 ulp), which is what the reference CUDA kernel uses; the QA bound
// (|dpos| <= 5e-4 after one dt=1e-3 step against the CPU oracle) and the
// kernel-vs-plain bound (1e-4 * max|a| + 1e-4 on the acceleration) cover
// it. Built with -O3 and without --use_fast_math, so plain divisions and
// square roots stay IEEE; nvcc does contract a*b+c into FMAs.
//
// Edges: any M and N. A j-slot past N loads mass 0 (the zero-mass padding
// of pallas_kernel.py:29-30), and a thread past M writes nothing.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays: pos/vel (M,4) or (N,4) AoS, 16-byte aligned
// (float4 loads), acc (M,3). The caller makes the arrays' device current; the
// kernel runs on the given stream of that device, allocates nothing and does
// not synchronise. Each entry point returns cudaGetLastError() after the
// launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void accumulate_all_j(const float4 pi,
                                                 const float4* __restrict__ pos_j,
                                                 const int64_t n, const float eps2,
                                                 float4* tile, float& ax, float& ay,
                                                 float& az) {
  const int bs = blockDim.x;
  for (int64_t base = 0; base < n; base += bs) {
    const int64_t j = base + threadIdx.x;
    tile[threadIdx.x] = (j < n) ? pos_j[j] : make_float4(0.f, 0.f, 0.f, 0.f);
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

__global__ void step_kernel(const float4* __restrict__ pos_i,
                            const float4* __restrict__ vel_i,
                            const float4* __restrict__ pos_j,
                            float4* __restrict__ new_pos,
                            float4* __restrict__ new_vel, const int64_t m,
                            const int64_t n, const float dt, const float eps2,
                            const float damping) {
  extern __shared__ float4 tile[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // threads past M still stage j-tiles for the rest of the block
  const float4 pi = (i < m) ? pos_i[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float ax = 0.f, ay = 0.f, az = 0.f;
  accumulate_all_j(pi, pos_j, n, eps2, tile, ax, ay, az);
  if (i >= m) return;
  const float4 vi = vel_i[i];
  const float vx = (vi.x + ax * dt) * damping;
  const float vy = (vi.y + ay * dt) * damping;
  const float vz = (vi.z + az * dt) * damping;
  new_vel[i] = make_float4(vx, vy, vz, vi.w);
  new_pos[i] = make_float4(pi.x + vx * dt, pi.y + vy * dt, pi.z + vz * dt, pi.w);
}

__global__ void accel_kernel(const float4* __restrict__ pos_i,
                             const float4* __restrict__ pos_j,
                             float* __restrict__ acc, const int64_t m,
                             const int64_t n, const float eps2) {
  extern __shared__ float4 tile[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4 pi = (i < m) ? pos_i[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float ax = 0.f, ay = 0.f, az = 0.f;
  accumulate_all_j(pi, pos_j, n, eps2, tile, ax, ay, az);
  if (i >= m) return;
  acc[3 * i + 0] = ax;
  acc[3 * i + 1] = ay;
  acc[3 * i + 2] = az;
}

bool valid_block_size(int64_t bs) { return bs >= 32 && bs <= 1024 && bs % 32 == 0; }

unsigned int num_blocks(int64_t m, int64_t bs) {
  return static_cast<unsigned int>((m + bs - 1) / bs);
}

}  // namespace

extern "C" {

int nbody_step_f32(const void* pos_i, const void* vel_i, const void* pos_j,
                   void* new_pos, void* new_vel, int64_t m, int64_t n, float dt,
                   float eps2, float damping, int64_t block_size, void* stream) {
  if (!valid_block_size(block_size) || m < 0 || n < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(block_size) * sizeof(float4);
  step_kernel<<<num_blocks(m, block_size), static_cast<unsigned int>(block_size), smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_i), static_cast<const float4*>(vel_i),
      static_cast<const float4*>(pos_j), static_cast<float4*>(new_pos),
      static_cast<float4*>(new_vel), m, n, dt, eps2, damping);
  return cudaGetLastError();
}

int nbody_accel_f32(const void* pos_i, const void* pos_j, void* acc, int64_t m,
                    int64_t n, float eps2, int64_t block_size, void* stream) {
  if (!valid_block_size(block_size) || m < 0 || n < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(block_size) * sizeof(float4);
  accel_kernel<<<num_blocks(m, block_size), static_cast<unsigned int>(block_size), smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pos_i), static_cast<const float4*>(pos_j),
      static_cast<float*>(acc), m, n, eps2);
  return cudaGetLastError();
}

const char* nbody_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
