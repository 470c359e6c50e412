// The fused ring force of the body-sharded step, strategy="ring_fused", for
// Hopper (sm_90a): one launch runs all D hops of the ring, carrying the
// j-shards from rank to rank inside the kernel.
//
// Replaces the Pallas TPU kernel of the JAX package
//   nbody_ring_accel_f32 <- nbody_tpu/ops/ring_kernel.py::_kernel
//                           (def :44, pallas_call :219 in ring_accel_fused)
// It computes what that kernel computes: the (M,3) acceleration of this
// rank's M bodies under all D*M bodies of the ring, with the (M,4) j-shards
// travelling around it. Rank r sends to r+1 and receives from r-1, so at hop
// h it holds the shard of rank (r-h) mod D (the order of the port's unfused
// ring, parallel/sharded.py::_ring). Hop 0 is the rank's own shard.
//
// Sums: hop h's partial force is the force kernel's (nbody_kernels.cu,
// accel_kernel) at (M, M): S = step_splits(M, M) j-chunks of the visiting
// shard (ops/cuda_kernel.py; FusedRing passes it), each summed from 0 in j
// order by the step kernel's walk (walk_chunk, allpairs_common.cuh), then
// the chunks added in chunk order from 0 (the chunk's own sum when S = 1).
// The rank's total is hop 0, then total = total + hop h in hop order,
// rounded as one float32 add (__fadd_rn, never contracted). That is what
// the unfused ring computes with one nbody_accel_f32 launch a hop and
// torch.add, so the two give the same bits at any block size. No atomics
// touch a sum.
//
// The work of a hop is items (i-tile, chunk), ceil(M / (ROWS * blockDim.x))
// tiles times S chunks, many more than the i-tiles alone at the shard sizes
// of a ring; the G blocks of a rank walk items b, b + G, ... and write each
// item's chunk sums into the rank's partials (D, S, 3, M), hop h at its own
// offset (memory the caller allocates, which only the rank's own blocks
// touch). After the cooperative launch, ring_finish_kernel, an ordinary
// launch on the same stream, adds each row's partials in chunk and hop
// order into the (M,3) output. So no block waits on another block of its
// rank, and the flags carry only the ring's copies and credits.
//
// Peers: the kernel addresses the neighbours' buffers only through a table
// of pointers, one entry per rank of the launch. In a real ring a launch
// holds one rank, and its left and right entries are the neighbours' regions
// mapped by CUDA IPC (cudaIpcOpenMemHandle, node-local). In an emulated ring
// one launch holds D virtual ranks on one card: blockIdx.x splits into D
// groups of G blocks, each group a rank, each rank's region in that card's
// memory. The same code runs both; the flags between ranks carry every
// ordering, and no block waits on a grid-wide sync.
//
// A rank's region (one cudaMalloc, so that its IPC handle is its base):
//   slots   [2][M] float4   the double-buffered visiting j-shard
//   arrived [2][G] u64      written by the left neighbour's block b when its
//                           slice b of a slot has landed here
//   freed   [2][G] u64      written by the right neighbour's block b when it
//                           has finished reading its own slot (the credit)
//   error   u64             the first timeout of the launch, 0 if none
// Hop h >= 1 reads slot h % 2. Block b of a rank, at hop h:
//   1. h >= 1: waits until every arrived[h%2][*] holds this hop's use of the
//      slot (acquire, system scope);
//   2. h < D-1: waits until every freed[(h+1)%2][*] (its right neighbour's
//      credits) shows that the slot it is about to write was read to its
//      end, copies its slice of hop h's shard into the right neighbour's
//      slot (h+1)%2 with plain stores through the peer pointer, fences at
//      system scope, and signals arrived (release, system scope);
//   3. computes hop h's items b, b+G, ... into the partials;
//   4. h >= 1: gives its left neighbour the credit for slot h%2 (release).
// After the last hop a block waits for its right neighbour's credits of that
// hop, the last writes a peer makes into the region in a call: when a
// rank's call returns, no peer writes into its region until the next call,
// so it may free its buffers without a barrier.
// Flags are never reset: every value is the count of uses of a slot since
// the buffers were made, from the host's call number (the epoch), so a
// flag left by the call before can never satisfy this call's wait. Slot
// data is read with ld.global.cg (L2, not the SM's L1), so no line cached
// from an earlier use of the slot is read again.
//
// Hazards and what the design does about them:
//   co-residency: a block that spins on a flag set by a block that is not
//     resident deadlocks, so the grid is launched cooperatively
//     (cudaLaunchCooperativeKernel), which refuses a grid larger than the
//     card holds at once; the wrapper sizes G from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor and raises before that;
//   unbounded spins: every wait gives up after timeout_ns of %globaltimer,
//     writes the error word (kind, rank, hop) and ends its block; a block
//     that sees the word set ends too. The wrapper reads the word after the
//     launch and raises;
//   D = 1: no hop waits, copies or signals;
//   ragged shards: a thread past M stages its share of each j-stage and
//     writes nothing, a j-slot past M loads mass 0 (walk_chunk).
//
// What bounds it on an H100: the force kernel's issue, 20 flops a pair by
// the reference's count (the walk's 12 FP32-pipe instructions and one
// MUFU.RSQ) over (D*M) * M pairs a rank; a hop moves M*16 bytes to the
// right neighbour (NVLink between cards, device memory in an emulated
// ring), which overlaps the hop's compute of the other blocks, and writes
// S*12 bytes a row into the partials, which the finish reads once. The
// waits cost a warp's poll of G flags a hop.
//
// Interface: plain C, loaded with ctypes. The caller makes the card
// current. nbody_ring_accel_f32 launches the ring kernel and its finish on
// the given stream and does not synchronise; nbody_ring_read_error
// synchronises the stream and reads a region's error word. Each entry point
// returns a cudaError_t.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "allpairs_common.cuh"

namespace {

constexpr int kMaxLaunchRanks = 16;
constexpr int kTableFields = 7;  // pos, acc, parts, self, right, left, rank

struct RankPtrs {
  const float4* pos;  // (M,4) the rank's shard
  float* acc;         // (M,3) its force, out
  float* parts;       // (D, S, 3, M) its hops' chunk sums, scratch
  char* self;         // its region
  char* right;        // the right neighbour's region
  char* left;         // the left neighbour's region
  int64_t rank;       // its ring rank (for the error word)
};

struct LaunchTable {
  RankPtrs r[kMaxLaunchRanks];
};

struct Region {
  float4* slots;
  uint64_t* arrived;
  uint64_t* freed;
  unsigned long long* error;
};

__host__ __device__ int64_t slots_bytes(const int64_t m) {
  return (2 * m * static_cast<int64_t>(sizeof(float4)) + 255) / 256 * 256;
}

__host__ __device__ int64_t region_bytes(const int64_t m, const int64_t g) {
  return slots_bytes(m) + (4 * g + 1) * static_cast<int64_t>(sizeof(uint64_t));
}

__host__ __device__ Region region(char* base, const int64_t m, const int64_t g) {
  uint64_t* flags = reinterpret_cast<uint64_t*>(base + slots_bytes(m));
  return Region{reinterpret_cast<float4*>(base), flags, flags + 2 * g,
                reinterpret_cast<unsigned long long*>(flags + 4 * g)};
}

// Uses of slot h % 2 up to and including hop h of call `epoch` (from 1):
// each call uses slot 1 at its odd hops and slot 0 at its even hops >= 2.
__device__ __forceinline__ uint64_t use_of_hop(const uint64_t epoch, const int64_t d,
                                               const int64_t h) {
  const uint64_t per_call = (h & 1) ? d / 2 : (d - 1) / 2;
  return (epoch - 1) * per_call + static_cast<uint64_t>((h + 1) / 2);
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint64_t ld_acquire_sys(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t ld_relaxed_sys(const unsigned long long* p) {
  uint64_t v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(uint64_t* p, const uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

constexpr unsigned long long kWaitArrival = 1, kWaitCredit = 2;

__device__ __forceinline__ unsigned long long error_word(const unsigned long long kind,
                                                         const int64_t rank, const int64_t h) {
  return (kind << 48) | (static_cast<unsigned long long>(rank & 0xffffff) << 24) |
         static_cast<unsigned long long>(h & 0xffffff);
}

// True once every flags[0..g) >= target; false when this wait timed out
// (it then writes `code` into the error word, unless one is there) or when
// the error word is already set. The first warp polls, a flag a lane at a
// time; every thread of the block must call it. Not inlined: inlined at its
// three call sites, it left the kernel's force loop 8-11 % slower on an H100
// at N = 65536 (scripts/torch_ring_bench.py, in turns), at 32 registers
// against 40 as a call.
__device__ __noinline__ bool wait_all(const uint64_t* flags, const int64_t g, const uint64_t target,
                         unsigned long long* error, const int64_t timeout_ns,
                         const unsigned long long code) {
  int ok = 1;
  if (threadIdx.x < 32) {
    const uint64_t t0 = globaltimer();
    for (int64_t k = threadIdx.x; k < g && ok; k += 32) {
      while (ld_acquire_sys(flags + k) < target) {
        if (ld_relaxed_sys(error) != 0) {
          ok = 0;
          break;
        }
        if (static_cast<int64_t>(globaltimer() - t0) > timeout_ns) {
          atomicCAS(error, 0ull, code);
          ok = 0;
          break;
        }
        __nanosleep(64);
      }
    }
  }
  return __syncthreads_and(ok) != 0;
}

// The j-side loader of a slot or a shard: through L2 only (ld.global.cg).
struct CgJ {
  const float4* p;
  __device__ __forceinline__ float4 operator()(const int64_t j) const { return __ldcg(p + j); }
};

// One work item of a hop: rows [i0 - threadIdx.x, + ROWS * blockDim.x) of
// the shard `pos` against chunk c of the visiting shard `src`, as the force
// kernel's block (tile, c) computes it, into the hop's partials. Not
// inlined: inlined into the ring kernel, whose ring state stays live across
// it, ptxas scheduled the walk one row's dependency chain at a time (the
// same 13.56 SASS instructions a pair), and the kernel took 2.64 ms of
// device time at D = 1, N = 65536 against the force kernel's 2.24 on an
// H100; as a call it takes the force kernel's time (2.25 against 2.25;
// scripts/torch_accel_dispatch.py, in turns), at 122 registers.
template <int ROWS>
__device__ __noinline__ void ring_item(const float4* __restrict__ pos,
                                       const float4* __restrict__ src,
                                       float* __restrict__ parts, const int64_t i0,
                                       const int64_t c, const int64_t chunk, const int64_t m,
                                       const float eps2) {
  float4 pi[ROWS];
  float ax[ROWS], ay[ROWS], az[ROWS];
  load_rows<ROWS, 1>(pos, i0, m, pi);
  walk_chunk<ROWS>(pi, CgJ{src}, c * chunk, chunk, m, eps2, ax, ay, az);
  store_chunk<ROWS>(parts, c, i0, m, ax, ay, az);
}

// The table is a __grid_constant__ parameter: a block indexes it by its rank
// without a copy into local memory. ROWS and MAX_THREADS as the force
// kernel's (rows_a_thread picks the instantiation).
template <int ROWS, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    ring_accel_kernel(const __grid_constant__ LaunchTable tab, const int64_t d, const int64_t m,
                      const int64_t g, const int64_t splits, const float eps2,
                      const uint64_t epoch, const int64_t timeout_ns) {
  const RankPtrs rp = tab.r[blockIdx.x / g];
  const int64_t b = blockIdx.x % g;
  const Region me = region(rp.self, m, g);
  const Region right = region(rp.right, m, g);
  const Region left = region(rp.left, m, g);
  // one error word a launch: the first rank's (the only one in a real ring)
  unsigned long long* error = region(tab.r[0].self, m, g).error;
  const int bs = blockDim.x;
  const int64_t tiles = (m + ROWS * bs - 1) / (ROWS * bs);
  const int64_t chunk = step_chunk(m, splits);
  // item it is (tile it % tiles, chunk it / tiles); a block's items step by
  // g, so it steps its (tile, chunk) by (g % tiles, g / tiles), no division
  // in the loop
  const int64_t dc = g / tiles, dt = g - dc * tiles;
  const int64_t c0 = b / tiles, t0 = b - c0 * tiles;
  for (int64_t h = 0; h < d; ++h) {
    const int64_t s = h & 1;
    const uint64_t use = use_of_hop(epoch, d, h);
    const float4* src = (h == 0) ? rp.pos : me.slots + s * m;
    if (h > 0 && !wait_all(me.arrived + s * g, g, use, error, timeout_ns,
                           error_word(kWaitArrival, rp.rank, h)))
      return;
    if (h + 1 < d) {
      const int64_t s1 = (h + 1) & 1;
      const uint64_t use1 = use_of_hop(epoch, d, h + 1);
      // the right neighbour has read the slot's previous use to its end
      if (!wait_all(me.freed + s1 * g, g, use1 - 1, error, timeout_ns,
                    error_word(kWaitCredit, rp.rank, h)))
        return;
      float4* dst = right.slots + s1 * m;
      for (int64_t j = b * bs + threadIdx.x; j < m; j += g * bs) dst[j] = __ldcg(src + j);
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) st_release_sys(right.arrived + s1 * g + b, use1);
    }
    // item (tile t, chunk c), as the force kernel's block (t, c)
    float* const parts = rp.parts + h * splits * 3 * m;
    for (int64_t c = c0, t = t0; c < splits;) {
      ring_item<ROWS>(rp.pos, src, parts, t * ROWS * bs + threadIdx.x, c, chunk, m, eps2);
      c += dc;
      t += dt;
      if (t >= tiles) {
        t -= tiles;
        ++c;
      }
    }
    if (h > 0) {
      // this block's reads of slot s (its slice forwarded, its items'
      // walks) are done: the left neighbour may write the slot again
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) st_release_sys(left.freed + s * g + b, use);
    }
  }
  // the right neighbour's last credits of the call: after them no peer
  // writes into this rank's region until the next call, so a rank whose
  // call has returned may free its buffers
  if (d > 1) {
    const int64_t last = d - 1;
    wait_all(me.freed + (last & 1) * g, g, use_of_hop(epoch, d, last), error, timeout_ns,
             error_word(kWaitCredit, rp.rank, last));
  }
}

// The (M,3) force of each rank of the launch (blockIdx.y) from its
// partials (D, S, 3, M), one thread a row and component: hop h is its
// chunks' sums added in chunk order from 0, as sum_partials adds the force
// kernel's (the one chunk's own sum when S = 1, as the force kernel writes
// it); the total is hop 0, then __fadd_rn(total, hop h) in hop order, as
// torch.add adds the unfused ring's launches.
__global__ void __launch_bounds__(256)
    ring_finish_kernel(const __grid_constant__ LaunchTable tab, const int64_t d, const int64_t m,
                       const int64_t splits) {
  const RankPtrs rp = tab.r[blockIdx.y];
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3 * m) return;
  const int64_t comp = idx / m;
  const int64_t x = idx - comp * m;
  float total = 0.f;
  for (int64_t h = 0; h < d; ++h) {
    const float* p = rp.parts + (h * splits * 3 + comp) * m + x;
    float hop = p[0];
    if (splits > 1) {
      hop = 0.f;
      for (int64_t c = 0; c < splits; ++c) hop += p[c * 3 * m];
    }
    total = (h == 0) ? hop : __fadd_rn(total, hop);
  }
  rp.acc[3 * x + comp] = total;
}

bool valid_block_size(int64_t bs) { return bs >= 32 && bs <= 1024 && bs % 32 == 0; }

// the ring kernel's instantiation at block_size threads
const void* ring_kernel_at(const int64_t block_size) {
  return rows_a_thread(block_size) == kStepRows
             ? reinterpret_cast<const void*>(ring_accel_kernel<kStepRows, 512>)
             : reinterpret_cast<const void*>(ring_accel_kernel<1, 1024>);
}

}  // namespace

extern "C" {

// A rank's region, zeroed (every flag 0, no error), from cudaMalloc so that
// cudaIpcGetMemHandle exports exactly it.
int nbody_ring_alloc(int64_t m, int64_t groups, void** base) {
  if (m < 1 || groups < 1) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(region_bytes(m, groups));
  cudaError_t err = cudaMalloc(base, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemset(*base, 0, bytes);
  if (err != cudaSuccess) {
    cudaFree(*base);
    *base = nullptr;
    return err;
  }
  return cudaDeviceSynchronize();
}

int nbody_ring_free(void* base) { return cudaFree(base); }

// The 64-byte CUDA IPC handle of a region, into `handle`.
int nbody_ring_ipc_handle(void* base, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, base);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return err;
}

// Map a peer's region (its 64-byte handle) into this process.
int nbody_ring_ipc_open(const void* handle, void** base) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
}

int nbody_ring_ipc_close(void* base) { return cudaIpcCloseMemHandle(base); }

int nbody_ring_ipc_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// Blocks of the ring kernel at `block_size` threads that the current card
// holds at once (its SMs times the blocks an SM holds, with the walk's
// static stage and no dynamic shared memory): the most a cooperative launch
// may have.
int nbody_ring_coresident_blocks(int64_t block_size, int64_t* out) {
  if (!valid_block_size(block_size)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_kernel_at(block_size), static_cast<int>(block_size), 0);
  if (err == cudaSuccess) *out = static_cast<int64_t>(per_sm) * sms;
  return err;
}

// One fused ring launch over `launch_ranks` ranks of a ring of `ring_size`,
// then its finish: `table` is launch_ranks rows of seven int64 (pos, acc,
// parts, self, right, left, rank; parts holds ring_size * splits * 3 * m
// floats), `groups` blocks a rank, `splits` the j-chunks of a hop, `epoch`
// this call's number (from 1, the same on every rank of the ring),
// `timeout_ns` the bound of every wait.
int nbody_ring_accel_f32(const int64_t* table, int64_t launch_ranks, int64_t ring_size,
                         int64_t m, int64_t groups, int64_t splits, float eps2,
                         int64_t block_size, uint64_t epoch, int64_t timeout_ns, void* stream) {
  if (!valid_block_size(block_size) || launch_ranks < 1 || launch_ranks > kMaxLaunchRanks ||
      ring_size < launch_ranks || m < 1 || groups < 1 || splits < 1 || epoch < 1 ||
      timeout_ns < 1)
    return cudaErrorInvalidValue;
  LaunchTable tab;
  std::memset(&tab, 0, sizeof(tab));
  for (int64_t v = 0; v < launch_ranks; ++v) {
    const int64_t* row = table + kTableFields * v;
    tab.r[v] = RankPtrs{reinterpret_cast<const float4*>(row[0]), reinterpret_cast<float*>(row[1]),
                        reinterpret_cast<float*>(row[2]), reinterpret_cast<char*>(row[3]),
                        reinterpret_cast<char*>(row[4]), reinterpret_cast<char*>(row[5]), row[6]};
  }
  int64_t d = ring_size, mm = m, g = groups, s = splits, t = timeout_ns;
  float e2 = eps2;
  uint64_t ep = epoch;
  void* args[] = {&tab, &d, &mm, &g, &s, &e2, &ep, &t};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaLaunchCooperativeKernel(
      ring_kernel_at(block_size), dim3(static_cast<unsigned int>(launch_ranks * groups)),
      dim3(static_cast<unsigned int>(block_size)), args, 0, st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch never ran
    return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(cdiv(3 * m, 256)),
                  static_cast<unsigned int>(launch_ranks));
  ring_finish_kernel<<<grid, 256, 0, st>>>(tab, ring_size, m, splits);
  return cudaGetLastError();
}

// Wait for the stream, then read the error word of a region into *out.
int nbody_ring_read_error(void* base, int64_t m, int64_t groups, void* stream,
                          uint64_t* out) {
  const Region r = region(static_cast<char*>(base), m, groups);
  cudaError_t err = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess)
    err = cudaMemcpy(out, r.error, sizeof(uint64_t), cudaMemcpyDeviceToHost);
  return err;
}

}  // extern "C"
